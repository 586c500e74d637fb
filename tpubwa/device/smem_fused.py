"""Single-dispatch bwt_smem1a machine (bwt.c:bwt_smem1a:~400; scalar
spec tpubwa/ref/smem.py:smem1a).

The phase-split machines (smem_split.py) cut occ gathers ~4x but pay a
dispatch + host sync per phase, and round 1 needs 4-6 dispatches per
chunk (fwd, 2-4 span-bucketed bwd groups, plus job-construction D2H
of the call metadata).

This module runs ONE program per seeding round:

  phase A (fwd)   identical to smem_split.smem_fwd_machine — records
                  per-call stack snapshots + metadata, all on device.
  phase B (bwd)   one lane per READ; each lane walks its calls
                  sequentially (call c's snapshot is flip-loaded from
                  phase A's buffer with an in-loop gather), running
                  the exact backward pass of the split bwd machine.
                  Total rounds = max over reads of the summed
                  backward spans (~2x a span bucket's rounds, in
                  exchange for 3-5 fewer dispatches).
  pack            emissions compact via a global cumsum before D2H
                  (the MAXR-slot buffer is ~90% zeros).

Overflow lanes (stack > P, calls > MAXC, emissions > MAXR, pack
spill, round caps) are flagged in aux; the caller retries them on a
deeper-capacity instance of the same machine and only then falls back
to the host scalar reference — bit-identity is preserved, not
approximated (tests/test_device_smem.py pins the full protocol).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .occ import DeviceIndex, bwt_extend, set_intv
from .smem_split import _sel_base, _pad_pow2, SEED_STATS

I32 = jnp.int32

RESTART, FWD, DONE = 0, 1, 3


def _mxu_append(out, out_n, rows, store, B: int, CAP: int):
    """Append ``rows[store]`` (rank-compacted, first-store-first) at
    ``out[out_n:]`` WITHOUT an XLA scatter.

    The compaction is a one-hot f32 matmul + one dynamic_update_slice
    in place of a scatter.  Row values are split into exact 16-bit
    halves so the f32 matmul (24-bit mantissa, exactly one nonzero
    addend per output element) is exact for any non-negative
    int32/int64 row.

    PRECISION IS LOAD-BEARING: the dot MUST run at Precision.HIGHEST.
    A reduced-precision pass (bf16, or TF32 with its 10-bit mantissa
    on a GPU's tensor cores) truncates the 16-bit halves and silently
    corrupts the appended rows; CPU tests cannot see it because CPU
    matmuls are exact f32.  With the one-hot side exactly
    representable (0/1) and exactly one nonzero addend per output
    element, a full-f32 product reproduces b_hi + b_lo = b with no
    rounding.

    B is the per-round append budget (the matmul's static column
    count); rows ranked past B or past CAP are NOT appended — they
    come back in ``dropped`` and the caller flags them for the deep
    retry path (both prefixes, so dropped rows never interleave with
    appended ones).  ``out`` must carry B headroom rows past CAP: the
    update-slice writes a full B-row block at out_n <= CAP and the
    tail beyond the real appends is garbage that later appends or the
    final [:out_n] consumer slice masks off."""
    C = rows.shape[1]
    dt = rows.dtype
    erank = jnp.cumsum(store.astype(I32)) - 1
    can = store & (erank < B) & (out_n + erank < CAP)
    oh = (store[:, None] & (erank[:, None]
                            == jnp.arange(B, dtype=I32)[None, :])
          ).astype(jnp.float32)
    nh = 4 if dt == jnp.int64 else 2
    halves = jnp.concatenate(
        [((rows >> (16 * h)) & 0xFFFF).astype(jnp.float32)
         for h in range(nh)], axis=1)
    comp = jnp.dot(oh.T, halves, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    ci = comp.astype(dt)
    rec = ci[:, :C]
    for h in range(1, nh):
        rec = rec | (ci[:, h * C:(h + 1) * C] << (16 * h))
    out = jax.lax.dynamic_update_slice(
        out, rec, (out_n, jnp.zeros((), out_n.dtype)))
    out_n = out_n + jnp.sum(can, dtype=I32)
    return out, out_n, store & ~can


def _fwd_phase(didx: DeviceIndex, q, lens, read, x0j, min_intv,
               one_shot, P: int, MAXC: int, max_rounds_f: int):
    """Forward passes of bwt_smem1a for N lanes (phase A).  Returns
    the final forward state dict (snap/meta/call/ovf flags/rounds)."""
    dt = didx.idt
    N = read.shape[0]
    L = q.shape[1]
    jidx = jnp.arange(P, dtype=I32)[None, :]
    cidx = jnp.arange(MAXC, dtype=I32)[None, :]
    len_i = lens[read].astype(I32)

    def q_at(pos):
        p = jnp.clip(pos, 0, L - 1)
        return q[read, p].astype(I32)

    stA = dict(
        phase=jnp.zeros(N, I32),
        x=x0j,
        i=jnp.zeros(N, I32),
        ik=jnp.zeros((N, 3), dt),
        ik_qe=jnp.zeros(N, I32),
        m=jnp.zeros(N, I32),
        call=jnp.zeros(N, I32),
        snap=jnp.zeros((N, MAXC, P, 4), dt),
        meta=jnp.zeros((N, MAXC, 2), I32),
        ovf_s=jnp.zeros(N, bool),
        ovf_c=jnp.zeros(N, bool),
        rounds=jnp.zeros((), I32),
    )

    def condA(s):
        return jnp.any(s["phase"] != DONE) & (s["rounds"] < max_rounds_f)

    def bodyA(s):
        phase, x, i = s["phase"], s["x"], s["i"]
        ik, ik_qe, m, call = s["ik"], s["ik_qe"], s["m"], s["call"]
        snap, meta = s["snap"], s["meta"]
        ovf_s, ovf_c = s["ovf_s"], s["ovf_c"]

        rs = phase == RESTART
        done_read = rs & (x >= len_i)
        cx = q_at(x)
        amb0 = rs & ~done_read & (cx > 3)
        start = rs & ~done_read & (cx <= 3)
        phase = jnp.where(done_read | (amb0 & one_shot), DONE, phase)
        x = jnp.where(amb0 & ~one_shot, x + 1, x)
        ik = jnp.where(start[:, None],
                       set_intv(didx, jnp.clip(cx, 0, 3)), ik)
        ik_qe = jnp.where(start, x + 1, ik_qe)
        i = jnp.where(start, x + 1, i)
        m = jnp.where(start, 0, m)
        phase = jnp.where(start, FWD, phase)

        fw = phase == FWD
        at_end = fw & (i >= len_i)
        ci = q_at(i)
        amb = fw & ~at_end & (ci > 3)
        okf = bwt_extend(didx, ik, is_back=False)
        nik = _sel_base(okf, 3 - ci)
        schange = fw & ~at_end & ~amb & (nik[:, 2] != ik[:, 2])
        failf = schange & (nik[:, 2] < min_intv)
        push = at_end | amb | schange
        can_push = push & (m < P) & (call < MAXC)
        ovf_s = ovf_s | (push & (m >= P))
        row = jnp.concatenate([ik, ik_qe[:, None].astype(dt)], axis=1)
        wmask = (can_push[:, None, None]
                 & (cidx == call[:, None])[:, :, None]
                 & (jidx == m[:, None])[:, None, :])
        snap = jnp.where(wmask[:, :, :, None], row[:, None, None, :],
                         snap)
        m = m + push.astype(I32)
        adv = fw & ~at_end & ~amb & ~failf
        ik = jnp.where(adv[:, None], nik, ik)
        ik_qe = jnp.where(adv, i + 1, ik_qe)
        i = jnp.where(adv, i + 1, i)

        trans = at_end | amb | failf
        rec = trans & (call < MAXC)
        mmask = rec[:, None] & (cidx == call[:, None])
        mrow = jnp.stack([x, m], axis=1)
        meta = jnp.where(mmask[:, :, None], mrow[:, None, :], meta)
        ovf_c = ovf_c | (trans & (call >= MAXC))
        call = call + trans.astype(I32)
        phase = jnp.where(trans & one_shot, DONE, phase)
        x = jnp.where(trans & ~one_shot, ik_qe, x)
        phase = jnp.where(trans & ~one_shot, RESTART, phase)
        phase = jnp.where(ovf_s | ovf_c, DONE, phase)

        return dict(phase=phase, x=x, i=i, ik=ik, ik_qe=ik_qe, m=m,
                    call=call, snap=snap, meta=meta, ovf_s=ovf_s,
                    ovf_c=ovf_c, rounds=s["rounds"] + 1)

    outA = jax.lax.while_loop(condA, bodyA, stA)
    hungA = (outA["phase"] != DONE) & ~outA["ovf_s"] & ~outA["ovf_c"]
    outA["ovf_c"] = outA["ovf_c"] | hungA
    return outA


def _bwd_phase(didx: DeviceIndex, q, lens, read, nc, meta_x, meta_m,
               snapA, min_intv, P: int, MAXC: int, MAXR: int,
               min_seed_len: int, max_rounds_b: int):
    """Backward passes (phase B), calls sequential per lane.  Returns
    the final backward state dict (mem/mem_n/eovf/rounds)."""
    dt = didx.idt
    N = read.shape[0]
    L = q.shape[1]
    jidx = jnp.arange(P, dtype=I32)[None, :]
    cidx = jnp.arange(MAXC, dtype=I32)[None, :]

    def q_at(pos):
        p = jnp.clip(pos, 0, L - 1)
        return q[read, p].astype(I32)

    # flip snapshots push-order -> ascending-size once, up front (the
    # per-round load is then a flat row gather)
    flip_idx = jnp.clip(meta_m[:, :, None] - 1 - jidx[None], 0, P - 1)
    oh = flip_idx[..., None] == jidx[None, :, None, :]  # [N,MAXC,P,P]
    flip = jnp.sum(jnp.where(oh[..., None], snapA[:, :, None, :, :],
                             0), axis=3, dtype=snapA.dtype)
    flip = jnp.where((jidx[None] < meta_m[:, :, None])[..., None],
                     flip, 0)
    flip_flat = flip.reshape(N * MAXC, P, 4)
    lane = jnp.arange(N, dtype=I32)

    stB = dict(
        c=jnp.zeros(N, I32),
        need=jnp.ones(N, bool),
        i=jnp.zeros(N, I32),
        st=jnp.zeros((N, P, 4), dt),
        m=jnp.zeros(N, I32),
        cem=jnp.zeros(N, bool),
        lqb=jnp.zeros(N, I32),
        mem=jnp.zeros((N, MAXR, 5), dt),
        mem_n=jnp.zeros(N, I32),
        eovf=jnp.zeros(N, bool),
        rounds=jnp.zeros((), I32),
    )

    def condB(s):
        return (jnp.any((s["c"] < nc) & ~s["eovf"])
                & (s["rounds"] < max_rounds_b))

    def bodyB(s):
        c, need, i, st, m = s["c"], s["need"], s["i"], s["st"], s["m"]
        cem, lqb = s["cem"], s["lqb"]
        mem, mem_n, eovf = s["mem"], s["mem_n"], s["eovf"]
        act = (c < nc) & ~eovf      # overflowed lanes are discarded
        cc = jnp.clip(c, 0, MAXC - 1)
        csel = cidx == cc[:, None]                       # [N, MAXC]
        x_c = jnp.sum(jnp.where(csel, meta_x, 0), axis=1, dtype=I32)
        m_c = jnp.sum(jnp.where(csel, meta_m, 0), axis=1, dtype=I32)
        ld = flip_flat[lane * MAXC + cc]                 # [N, P, 4]
        ld_now = act & need
        st = jnp.where(ld_now[:, None, None], ld, st)
        m = jnp.where(ld_now, m_c, m)
        i = jnp.where(ld_now, x_c - 1, i)
        cem = jnp.where(ld_now, False, cem)
        lqb = jnp.where(ld_now, 0, lqb)
        need = need & ~ld_now

        bw = act & (m > 0)
        neg = (i < 0) | (q_at(i) > 3)
        cb = jnp.clip(q_at(i), 0, 3)
        okb = bwt_extend(didx, st[:, :, :3], is_back=True)
        okc = _sel_base(okb, jnp.broadcast_to(cb[:, None], (N, P)))
        szs = okc[:, :, 2]
        validj = jidx < m[:, None]
        ext = validj & ~neg[:, None] & (szs >= min_intv[:, None])
        ext0 = ext[:, 0]
        emitc = bw & (m > 0) & ~ext0
        cond2 = ~cem | (i + 1 < lqb)
        do_emit = emitc & cond2
        p0 = st[:, 0]
        len_ok = (p0[:, 3].astype(I32) - (i + 1)) >= min_seed_len
        store = do_emit & len_ok
        can_store = store & (mem_n < MAXR)
        eovf = eovf | (store & (mem_n >= MAXR))
        erow = jnp.concatenate(
            [p0[:, :3], (i + 1)[:, None].astype(dt), p0[:, 3:4]],
            axis=1)
        mslot = can_store[:, None] & (jnp.arange(MAXR, dtype=I32)[None]
                                      == mem_n[:, None])
        mem = jnp.where(mslot[:, :, None], erow[:, None, :], mem)
        mem_n = mem_n + can_store.astype(I32)
        cem = jnp.where(do_emit, True, cem)
        lqb = jnp.where(do_emit, i + 1, lqb)
        prev_ext = jnp.concatenate(
            [jnp.zeros((N, 1), bool), ext[:, :-1]], axis=1)
        prev_sz = jnp.concatenate(
            [jnp.full((N, 1), -1, dt), szs[:, :-1]], axis=1)
        kept = ext & (~prev_ext | (szs != prev_sz))
        new_m = jnp.sum(kept, axis=1).astype(I32)
        dest = jnp.cumsum(kept.astype(I32), axis=1) - 1
        newrow = jnp.concatenate([okc, st[:, :, 3:4]], axis=2)
        oh2 = kept[:, None, :] & (dest[:, None, :] == jidx[:, :, None])
        compacted = jnp.sum(
            jnp.where(oh2[:, :, :, None], newrow[:, None, :, :], 0),
            axis=2, dtype=newrow.dtype)
        st = jnp.where(bw[:, None, None], compacted, st)
        m = jnp.where(bw, new_m, m)
        deadb = act & (m == 0)
        c = c + deadb.astype(I32)
        need = need | deadb
        i = jnp.where(bw & (m > 0), i - 1, i)
        return dict(c=c, need=need, i=i, st=st, m=m, cem=cem, lqb=lqb,
                    mem=mem, mem_n=mem_n, eovf=eovf,
                    rounds=s["rounds"] + 1)

    outB = jax.lax.while_loop(condB, bodyB, stB)
    hungB = (outB["c"] < nc) & ~outB["eovf"]
    outB["eovf"] = outB["eovf"] | hungB
    return outB


def _fwd_phase_queue1(didx: DeviceIndex, q, lens, read, x0j, min_intv,
                      n_jobs, P: int, ML: int, max_rounds_f: int):
    """Forward passes for ONE-SHOT jobs (single call each — the
    round-2 reseed protocol) with a global job queue: job k is
    independent of job j, so ML machine lanes pull jobs 0..n_jobs-1
    in order and run each to its first break.  Versus running one
    lockstep lane per job slot this drops per-round cost from NJ
    lanes (mostly dead — ~1.3 live jobs per read over 2N slots) to
    ML and rounds from max-span to ~total-work/ML.

    In-loop writes are scatter-free (round-2 perf fix): each lane
    accumulates its CURRENT job's stack in a local [ML, P, 4] buffer
    via where one-hots, and on job completion the fused record
    (src, x, m, stack) appends to a global buffer with `_mxu_append`.
    ONE scatter per dispatch (not per round) then permutes the
    append-ordered records into the per-job snap/meta/nc tables.
    Completions past the per-round append budget exert BACKPRESSURE:
    the lane freezes (no state update at all) and re-executes the
    identical round next time, so nothing is lost or reordered.
    The rare stack-overflow flag scatter runs under lax.cond.

    Returns the `_fwd_phase` contract shapes for MAXC=1: dict with
    snap [NJ, 1, P, 4], meta [NJ, 1, 2], call [NJ] (0/1), ovf_s,
    ovf_c [NJ], rounds."""
    dt = didx.idt
    NJ = read.shape[0]
    L = q.shape[1]
    FB = min(ML, 1024)      # per-round completion budget (matmul cols)
    W = 3 + P * 4           # fused record: src, x, m, stack[P, 4]

    st0 = dict(
        qhead=jnp.zeros((), I32),
        src=jnp.full(ML, -1, I32),
        rd=jnp.zeros(ML, I32),
        mi=jnp.ones(ML, dt),
        x=jnp.zeros(ML, I32),
        i=jnp.zeros(ML, I32),
        ik=jnp.zeros((ML, 3), dt),
        ik_qe=jnp.zeros(ML, I32),
        m=jnp.zeros(ML, I32),
        stl=jnp.zeros((ML, P, 4), dt),
        app=jnp.zeros((NJ + FB, W), dt),
        app_n=jnp.zeros((), I32),
        ovf=jnp.zeros(NJ, bool),
        rounds=jnp.zeros((), I32),
    )
    jidx1 = jnp.arange(P, dtype=I32)[None, :]

    def cond(s):
        return (((s["qhead"] < n_jobs) | jnp.any(s["src"] >= 0))
                & (s["rounds"] < max_rounds_f))

    def body(s):
        src, rd, mi = s["src"], s["rd"], s["mi"]
        x, i, ik, ik_qe, m = s["x"], s["i"], s["ik"], s["ik_qe"], s["m"]
        stl, app, app_n, ovf = s["stl"], s["app"], s["app_n"], s["ovf"]
        # ---- pull + restart (same round)
        empty = src < 0
        rank = jnp.cumsum(empty.astype(I32)) - 1
        qi = s["qhead"] + rank
        pull = empty & (qi < n_jobs)
        src = jnp.where(pull, qi, src)
        qhead = s["qhead"] + jnp.sum(pull, dtype=I32)
        src_c = jnp.clip(src, 0, NJ - 1)
        rd = jnp.where(pull, read[src_c], rd)
        mi = jnp.where(pull, min_intv[src_c], mi)
        len_i = lens[rd].astype(I32)
        xn = x0j[src_c]
        x = jnp.where(pull, xn, x)
        pc = jnp.clip(x, 0, L - 1)
        cx = q[rd, pc].astype(I32)
        # one-shot: x >= len or ambiguous base -> no call at all
        dead0 = pull & ((x >= len_i) | (cx > 3))
        start = pull & ~dead0
        ik = jnp.where(start[:, None],
                       set_intv(didx, jnp.clip(cx, 0, 3)), ik)
        ik_qe = jnp.where(start, x + 1, ik_qe)
        i = jnp.where(start, x + 1, i)
        m = jnp.where(start, 0, m)
        stl = jnp.where(start[:, None, None], 0, stl)
        src = jnp.where(dead0, -1, src)

        # ---- forward step (bodyA of _fwd_phase, single-call form):
        # predicates first, then the fused append, then all state
        # writes gated on ~frozen (budget backpressure)
        fw = src >= 0
        at_end = fw & (i >= len_i)
        pi = jnp.clip(i, 0, L - 1)
        ci = q[rd, pi].astype(I32)
        amb = fw & ~at_end & (ci > 3)
        okf = bwt_extend(didx, ik, is_back=False)
        nik = _sel_base(okf, 3 - ci)
        schange = fw & ~at_end & ~amb & (nik[:, 2] != ik[:, 2])
        failf = schange & (nik[:, 2] < mi)
        push = at_end | amb | schange
        can_push = push & (m < P)
        ovf_now = push & (m >= P)
        row = jnp.concatenate([ik, ik_qe[:, None].astype(dt)], axis=1)
        wm = can_push[:, None] & (jidx1 == m[:, None])
        stl_new = jnp.where(wm[:, :, None], row[:, None, :], stl)
        m_new = m + push.astype(I32)
        trans = at_end | amb | failf
        recW = jnp.concatenate(
            [src_c[:, None].astype(dt), x[:, None].astype(dt),
             m_new[:, None].astype(dt), stl_new.reshape(ML, P * 4)],
            axis=1)
        app, app_n, fdrop = _mxu_append(app, app_n, recW, trans,
                                        FB, NJ)
        frozen = fdrop          # trans lanes past the budget: freeze,
        # identical round re-executes next time (appends <= 1/job, so
        # the NJ-row buffer itself can never overflow)
        live = jnp.logical_not(frozen)
        stl = jnp.where((live & push)[:, None, None], stl_new, stl)
        m = jnp.where(live & push, m_new, m)
        ovf_eff = ovf_now & live
        ovf = jax.lax.cond(
            jnp.any(ovf_eff),
            lambda o: o.at[jnp.where(ovf_eff, src_c, NJ)].set(
                True, mode="drop"),
            lambda o: o, ovf)
        adv = fw & ~at_end & ~amb & ~failf
        ik = jnp.where(adv[:, None], nik, ik)
        ik_qe = jnp.where(adv, i + 1, ik_qe)
        i = jnp.where(adv, i + 1, i)
        src = jnp.where((trans | ovf_now) & live, -1, src)
        return dict(qhead=qhead, src=src, rd=rd, mi=mi, x=x, i=i,
                    ik=ik, ik_qe=ik_qe, m=m, stl=stl, app=app,
                    app_n=app_n, ovf=ovf, rounds=s["rounds"] + 1)

    out = jax.lax.while_loop(cond, body, st0)
    # ---- ONE permutation scatter: append-ordered records -> per-job
    # snap/meta/nc tables (the old code paid 3 scatters per ROUND)
    app, app_n = out["app"], out["app_n"]
    apos = jnp.arange(NJ + FB, dtype=I32)
    avalid = apos < app_n
    asrc = jnp.where(avalid, jnp.clip(app[:, 0].astype(I32), 0,
                                      NJ - 1), NJ)
    fused = jnp.zeros((NJ + 1, W), dt).at[asrc].set(
        app, mode="drop")[:NJ]
    nc = jnp.zeros(NJ + 1, I32).at[asrc].set(1, mode="drop")[:NJ]
    snap = fused[:, 3:].reshape(NJ * P, 4)
    meta = fused[:, 1:3].astype(I32)
    # round-cap hit: flag in-flight lanes' jobs and unserved entries
    ovf = out["ovf"]
    hung = out["src"] >= 0
    ovf = jax.lax.cond(
        jnp.any(hung),
        lambda o: o.at[jnp.where(hung, jnp.clip(out["src"], 0, NJ - 1),
                                 NJ)].set(True, mode="drop"),
        lambda o: o, ovf)
    pos = jnp.arange(NJ, dtype=I32)
    unserved = (pos >= out["qhead"]) & (pos < n_jobs)
    ovf = ovf | unserved
    return dict(snap=snap.reshape(NJ, 1, P, 4),
                meta=meta.reshape(NJ, 1, 2),
                call=nc, ovf_s=ovf,
                ovf_c=jnp.zeros(NJ, bool), rounds=out["rounds"])


def _bwd_phase_queue(didx: DeviceIndex, q, lens, read, nc, meta_x,
                     meta_m, snapA, min_intv, P: int, MAXC: int,
                     CAP: int, ML: int, min_seed_len: int,
                     max_rounds_b: int, qb_budget: int = 0):
    """Backward passes (phase B) with a GLOBAL CALL QUEUE.

    The per-read sequential walk of `_bwd_phase` bounds rounds by the
    straggler read (max over lanes of its summed backward spans); the
    calls themselves are independent (cem/lqb reset on every call
    load), so here every (lane, call) pair of the whole chunk goes
    into one flat queue and each of the ML machine lanes pulls the
    next unclaimed call whenever its current one finishes — rounds
    drop to ~ total-backward-work / ML + the longest single call.

    Emissions append to a global [CAP + QB, 6] buffer (x0, x1, size,
    qb, qe, src_fwd_lane) via a per-round one-hot f32 matmul + one
    dynamic_update_slice (`_mxu_append`, in place of an XLA
    scatter).  Order is round-major/lane-minor, which both
    the device round-2 job builder and the host decode consume
    identically (the final per-read multiset is what the contract
    requires — collect_intv_device lexsorts; SA segments align by
    buffer row).  The pull-side stack reload gather and the rare
    overflow-flag scatter run under lax.cond so rounds without pulls
    or drops skip them entirely.

    Returns dict(out [CAP + QB, 6] (valid rows [:out_n]), out_n,
    ovf [N] per-FWD-LANE flags (emission drop | hung | unserved
    queue entries), rounds)."""
    dt = didx.idt
    N = read.shape[0]
    L = q.shape[1]
    NQ = N * MAXC
    jidx = jnp.arange(P, dtype=I32)[None, :]

    # ---- flat queue: entry k (in (lane, call) order) -> src index
    # lane * MAXC + c into the phase-A snapshot/meta buffers
    ncc = jnp.minimum(nc, MAXC)
    offs = jnp.cumsum(ncc) - ncc
    TC = jnp.sum(ncc, dtype=I32)
    cidx = jnp.arange(MAXC, dtype=I32)[None, :]
    valid = cidx < ncc[:, None]
    tgt = jnp.where(valid, offs[:, None] + cidx, NQ)
    srcv = (jnp.arange(N, dtype=I32)[:, None] * MAXC
            + jnp.broadcast_to(cidx, (N, MAXC)))
    q_src = jnp.zeros(NQ + 1, I32).at[tgt.reshape(-1)].set(
        srcv.reshape(-1), mode="drop")[:NQ]
    snap_flat = snapA.reshape(N * MAXC * P, 4)
    mx_flat = meta_x.reshape(-1)
    mm_flat = meta_m.reshape(-1)

    # per-round append budget (matmul columns).  The one-hot is
    # [ML, QB] f32 built EVERY round; at QB=2048 that is 16 MB of
    # VPU writes + a 2048-column HIGHEST-precision matmul per round
    # for typically ~100 stores.  Rows ranked past QB are dropped to
    # the (cheap, native) tail — a smaller budget trades rare extra
    # tail jobs for every round's append cost.  qb_budget <= 0 keeps
    # the legacy min(ML, 2048).
    QB = min(ML, qb_budget if qb_budget > 0 else 2048)

    st0 = dict(
        qhead=jnp.zeros((), I32),
        src=jnp.full(ML, -1, I32),
        rd=jnp.zeros(ML, I32),
        mi=jnp.ones(ML, dt),
        i=jnp.zeros(ML, I32),
        st=jnp.zeros((ML, P, 4), dt),
        m=jnp.zeros(ML, I32),
        cem=jnp.zeros(ML, bool),
        lqb=jnp.zeros(ML, I32),
        out=jnp.zeros((CAP + QB, 6), dt),
        out_n=jnp.zeros((), I32),
        ovf=jnp.zeros(N, bool),
        rounds=jnp.zeros((), I32),
    )

    def cond(s):
        return (((s["qhead"] < TC) | jnp.any(s["src"] >= 0))
                & (s["rounds"] < max_rounds_b))

    def body(s):
        i = s["i"]
        st, m, cem, lqb = s["st"], s["m"], s["cem"], s["lqb"]
        out, out_n, ovf = s["out"], s["out_n"], s["ovf"]
        # ---- pull: empty lanes claim the next queue entries.  The
        # whole reload (incl. the [ML, P]-row snapshot gather) runs
        # under lax.cond: most rounds pull nothing, and the gather
        # alone costs ~0.5-1 ms at ML=8192
        empty = s["src"] < 0

        def do_pull(c):
            src, rd, mi, i, st, m, cem, lqb = c
            rank = jnp.cumsum(empty.astype(I32)) - 1
            qi = s["qhead"] + rank
            pull = empty & (qi < TC)
            srcn = q_src[jnp.clip(qi, 0, NQ - 1)]
            src = jnp.where(pull, srcn, src)
            qhead = s["qhead"] + jnp.sum(pull, dtype=I32)
            src_c = jnp.clip(src, 0, NQ - 1)
            m_c = mm_flat[src_c]
            x_c = mx_flat[src_c]
            # stack load, flipped push-order -> ascending-size
            fidx = src_c[:, None] * P + jnp.clip(
                m_c[:, None] - 1 - jidx, 0, P - 1)
            ld = jnp.where((jidx < m_c[:, None])[..., None],
                           snap_flat[fidx], 0)
            st = jnp.where(pull[:, None, None], ld, st)
            m = jnp.where(pull, m_c, m)
            i = jnp.where(pull, x_c - 1, i)
            cem = jnp.where(pull, False, cem)
            lqb = jnp.where(pull, 0, lqb)
            rd = jnp.where(pull, read[src_c // MAXC], rd)
            mi = jnp.where(pull, min_intv[src_c // MAXC], mi)
            return (src, rd, mi, i, st, m, cem, lqb), qhead

        (src, rd, mi, i, st, m, cem, lqb), qhead = jax.lax.cond(
            jnp.any(empty) & (s["qhead"] < TC),
            do_pull,
            lambda c: (c, s["qhead"]),
            (s["src"], s["rd"], s["mi"], i, st, m, cem, lqb))
        src_c = jnp.clip(src, 0, NQ - 1)
        src_lane = src_c // MAXC

        act = src >= 0
        bw = act & (m > 0)
        p = jnp.clip(i, 0, L - 1)
        ci = q[rd, p].astype(I32)
        neg = (i < 0) | (ci > 3)
        cb = jnp.clip(ci, 0, 3)
        okb = bwt_extend(didx, st[:, :, :3], is_back=True)
        okc = _sel_base(okb, jnp.broadcast_to(cb[:, None], (ML, P)))
        szs = okc[:, :, 2]
        validj = jidx < m[:, None]
        ext = validj & ~neg[:, None] & (szs >= mi[:, None])
        ext0 = ext[:, 0]
        emitc = bw & ~ext0
        cond2 = ~cem | (i + 1 < lqb)
        do_emit = emitc & cond2
        p0 = st[:, 0]
        len_ok = (p0[:, 3].astype(I32) - (i + 1)) >= min_seed_len
        store = do_emit & len_ok
        row6 = jnp.concatenate(
            [p0[:, :3], (i + 1)[:, None].astype(dt), p0[:, 3:4],
             src_lane[:, None].astype(dt)], axis=1)
        out, out_n, drop = _mxu_append(out, out_n, row6, store, QB,
                                       CAP)
        # drops (buffer/budget overflow) are rare: flag under cond so
        # the ~360 us serialized scatter is skipped on normal rounds
        ovf = jax.lax.cond(
            jnp.any(drop),
            lambda o: o.at[jnp.where(drop, src_lane, N)].set(
                True, mode="drop"),
            lambda o: o, ovf)
        cem = jnp.where(do_emit, True, cem)
        lqb = jnp.where(do_emit, i + 1, lqb)
        prev_ext = jnp.concatenate(
            [jnp.zeros((ML, 1), bool), ext[:, :-1]], axis=1)
        prev_sz = jnp.concatenate(
            [jnp.full((ML, 1), -1, dt), szs[:, :-1]], axis=1)
        kept = ext & (~prev_ext | (szs != prev_sz))
        new_m = jnp.sum(kept, axis=1).astype(I32)
        dest = jnp.cumsum(kept.astype(I32), axis=1) - 1
        newrow = jnp.concatenate([okc, st[:, :, 3:4]], axis=2)
        oh2 = kept[:, None, :] & (dest[:, None, :] == jidx[:, :, None])
        compacted = jnp.sum(
            jnp.where(oh2[:, :, :, None], newrow[:, None, :, :], 0),
            axis=2, dtype=newrow.dtype)
        st = jnp.where(bw[:, None, None], compacted, st)
        m = jnp.where(bw, new_m, m)
        fin = act & (m == 0)
        src = jnp.where(fin, -1, src)
        i = jnp.where(bw & (m > 0), i - 1, i)
        return dict(qhead=qhead, src=src, rd=rd, mi=mi, i=i, st=st,
                    m=m, cem=cem, lqb=lqb, out=out, out_n=out_n,
                    ovf=ovf, rounds=s["rounds"] + 1)

    outB = jax.lax.while_loop(cond, body, st0)
    # round-cap hit: flag in-flight lanes' reads and unserved entries
    ovf = outB["ovf"]
    hung = outB["src"] >= 0
    ovf = ovf.at[jnp.where(
        hung, jnp.clip(outB["src"], 0, NQ - 1) // MAXC, N)].set(
        True, mode="drop")
    pos = jnp.arange(NQ, dtype=I32)
    unserved = (pos >= outB["qhead"]) & (pos < TC)
    ovf = ovf.at[jnp.where(unserved, q_src // MAXC, N)].set(
        True, mode="drop")
    return dict(out=outB["out"], out_n=outB["out_n"], ovf=ovf,
                rounds=outB["rounds"])


def _pack_rows(mem, mem_n, overflow, CAPF, dt):
    """Device-side compaction: the mem buffer is ~90% zeros; ship only
    the packed prefix.  Returns (packed [CAPF*N, 5], eff [N] — the
    per-lane counts EXCLUDING overflow lanes but INCLUDING pack-spill
    lanes, whose partial rows the host decode discards)."""
    N = mem_n.shape[0]
    MAXR = mem.shape[1]
    cap = CAPF * N
    eff = jnp.where(overflow, 0, mem_n)
    ends = jnp.cumsum(eff)
    base = ends - eff
    jm = jnp.arange(MAXR, dtype=I32)[None, :]
    tgt = base[:, None] + jm
    valid = (jm < eff[:, None]) & (tgt < cap)
    tgt = jnp.where(valid, tgt, cap)
    packed = jnp.zeros((cap + 1, 5), dt).at[tgt.reshape(-1)].set(
        mem.reshape(-1, 5), mode="drop")
    return packed[:cap], eff, ends


@partial(jax.jit, static_argnames=("P", "MAXC", "MAXR", "CAPF",
                                   "min_seed_len", "max_rounds_f",
                                   "max_rounds_b"))
def smem_call_machine(didx: DeviceIndex, q: jnp.ndarray,
                      lens: jnp.ndarray, jobs: jnp.ndarray,
                      P: int, MAXC: int, MAXR: int, CAPF: int,
                      min_seed_len: int, max_rounds_f: int = 2048,
                      max_rounds_b: int = 1024):
    """Full smem1a (fwd + bwd) for N independent lanes, one dispatch.

    jobs idt [N, 8] — columns 0..3 = (read, x0, min_intv, one_shot).
    Returns flat idt: packed rows [CAPF * N, 5] (x0, x1, size, qb, qe;
    lane-major, call-ascending, emission order within call), aux [N] =
    mem_n | stack-ovf << 27 | call-ovf << 28 | emit-ovf << 29 |
    any-ovf << 30, rounds_f, rounds_b."""
    dt = didx.idt
    read = jobs[:, 0].astype(I32)
    x0j = jobs[:, 1].astype(I32)
    min_intv = jobs[:, 2].astype(dt)
    one_shot = jobs[:, 3] != 0
    outA = _fwd_phase(didx, q, lens, read, x0j, min_intv, one_shot,
                      P, MAXC, max_rounds_f)
    ovf_s, ovf_c = outA["ovf_s"], outA["ovf_c"]
    nc = jnp.where(ovf_s | ovf_c, 0, outA["call"])  # ovf: skip bwd
    outB = _bwd_phase(didx, q, lens, read, nc, outA["meta"][:, :, 0],
                      outA["meta"][:, :, 1], outA["snap"], min_intv,
                      P, MAXC, MAXR, min_seed_len, max_rounds_b)
    eovf = outB["eovf"]
    overflow = ovf_s | ovf_c | eovf
    aux = (outB["mem_n"] | (ovf_s.astype(I32) << 27)
           | (ovf_c.astype(I32) << 28) | (eovf.astype(I32) << 29)
           | (overflow.astype(I32) << 30))
    packed, _, _ = _pack_rows(outB["mem"], outB["mem_n"], overflow,
                              CAPF, dt)
    return jnp.concatenate(
        [packed.reshape(-1), aux.astype(dt),
         outA["rounds"].astype(dt)[None], outB["rounds"].astype(dt)[None]])


@partial(jax.jit, static_argnames=("P", "MAXC", "MAXR", "CAPF", "J2",
                                   "MAXR2", "CAPF2", "min_seed_len",
                                   "split_len", "split_width",
                                   "max_rounds_f", "max_rounds_b"))
def smem_chunk_machine(didx: DeviceIndex, q: jnp.ndarray,
                       lens: jnp.ndarray, jobs: jnp.ndarray,
                       P: int, MAXC: int, MAXR: int, CAPF: int,
                       J2: int, MAXR2: int, CAPF2: int,
                       min_seed_len: int, split_len: int,
                       split_width: int, max_rounds_f: int = 2048,
                       max_rounds_b: int = 1024):
    """Seeding rounds 1 AND 2 in ONE dispatch (bwamem.c:
    mem_collect_intv first+second pass).  Round-2 reseed jobs are
    constructed ON DEVICE from round-1 emissions — the host round trip
    between the two machines (H2D jobs + D2H rows + a sync, with the
    device idle) disappears.

    jobs idt [N, 8] — columns 0..3 = (read, x0, min_intv, one_shot);
    round-1 lanes are whole-read protocols (one_shot = 0).

    Round-2 job k (k < j2n) = the k-th round-1 emission row, in
    (lane, slot) order, with qe - qb >= split_len and size <=
    split_width — over NON-overflow, NON-pack-spill lanes only, so the
    host can recompute the identical job list from the decoded rows
    (needed for the overflow retry path).  Jobs beyond J2 are dropped
    and flagged (j2n returned unclamped).

    Returns flat idt:
      packed1 [CAPF * N, 5] | aux1 [N] |
      packed2 [CAPF2 * J2, 5] | aux2 [J2] |
      j2n | rounds_f1 | rounds_b1 | rounds_f2 | rounds_b2
    aux encoding as smem_call_machine."""
    dt = didx.idt
    N = jobs.shape[0]
    read = jobs[:, 0].astype(I32)
    x0j = jobs[:, 1].astype(I32)
    min_intv = jobs[:, 2].astype(dt)
    one_shot = jobs[:, 3] != 0
    # ---- round 1
    outA = _fwd_phase(didx, q, lens, read, x0j, min_intv, one_shot,
                      P, MAXC, max_rounds_f)
    ovf_s, ovf_c = outA["ovf_s"], outA["ovf_c"]
    nc = jnp.where(ovf_s | ovf_c, 0, outA["call"])
    outB = _bwd_phase(didx, q, lens, read, nc, outA["meta"][:, :, 0],
                      outA["meta"][:, :, 1], outA["snap"], min_intv,
                      P, MAXC, MAXR, min_seed_len, max_rounds_b)
    eovf = outB["eovf"]
    overflow1 = ovf_s | ovf_c | eovf
    aux1 = (outB["mem_n"] | (ovf_s.astype(I32) << 27)
            | (ovf_c.astype(I32) << 28) | (eovf.astype(I32) << 29)
            | (overflow1.astype(I32) << 30))
    packed1, eff1, ends1 = _pack_rows(outB["mem"], outB["mem_n"],
                                      overflow1, CAPF, dt)
    # ---- round-2 job construction (device-side; host mirrors it)
    cap1 = CAPF * N
    spill1 = ends1 > cap1
    # one-shot lanes ARE round-2 jobs; mem_collect_intv never reseeds
    # a second-pass SMEM (their rows still ship, they just spawn no
    # phase-D work) — this makes the machine correct for mixed
    # full-protocol + one-shot retry batches
    effC = jnp.where(spill1 | one_shot, 0, eff1)
    jm = jnp.arange(MAXR, dtype=I32)[None, :]
    mem = outB["mem"]
    qual = ((jm < effC[:, None])
            & ((mem[:, :, 4] - mem[:, :, 3]).astype(I32) >= split_len)
            & (mem[:, :, 2] <= jnp.asarray(split_width, dt)))
    qflat = qual.reshape(-1)
    pos = jnp.cumsum(qflat.astype(I32)) - 1
    j2n = pos[-1] + 1
    dest = jnp.where(qflat & (pos < J2), pos, J2)
    lane_of = jnp.repeat(jnp.arange(N, dtype=I32), MAXR)
    jr2 = jnp.zeros(J2 + 1, I32).at[dest].set(lane_of, mode="drop")
    jx2 = (jnp.full(J2 + 1, 1 << 30, I32).at[dest].set(
        ((mem[:, :, 3] + mem[:, :, 4]).astype(I32) >> 1).reshape(-1),
        mode="drop"))
    jmi2 = (jnp.ones(J2 + 1, dt).at[dest].set(
        (mem[:, :, 2] + 1).reshape(-1), mode="drop"))
    read2 = read[jr2[:J2]]
    x2 = jx2[:J2]          # un-filled lanes: x = 1<<30 -> DONE
    mi2 = jmi2[:J2]
    osh2 = jnp.ones(J2, bool)
    # ---- round 2 (one-shot calls, MAXC = 1)
    outA2 = _fwd_phase(didx, q, lens, read2, x2, mi2, osh2, P, 1,
                       max_rounds_f)
    ovf_s2, ovf_c2 = outA2["ovf_s"], outA2["ovf_c"]
    nc2 = jnp.where(ovf_s2 | ovf_c2, 0, outA2["call"])
    outB2 = _bwd_phase(didx, q, lens, read2, nc2,
                       outA2["meta"][:, :, 0], outA2["meta"][:, :, 1],
                       outA2["snap"], mi2, P, 1, MAXR2, min_seed_len,
                       max_rounds_b)
    eovf2 = outB2["eovf"]
    overflow2 = ovf_s2 | ovf_c2 | eovf2
    aux2 = (outB2["mem_n"] | (ovf_s2.astype(I32) << 27)
            | (ovf_c2.astype(I32) << 28) | (eovf2.astype(I32) << 29)
            | (overflow2.astype(I32) << 30))
    packed2, _, _ = _pack_rows(outB2["mem"], outB2["mem_n"],
                               overflow2, CAPF2, dt)
    return jnp.concatenate(
        [packed1.reshape(-1), aux1.astype(dt),
         packed2.reshape(-1), aux2.astype(dt),
         j2n.astype(dt)[None],
         outA["rounds"].astype(dt)[None],
         outB["rounds"].astype(dt)[None],
         outA2["rounds"].astype(dt)[None],
         outB2["rounds"].astype(dt)[None]])


def _sa_from_rows(didx: DeviceIndex, rows, valid, max_occ: int,
                  SCAP: int):
    """SA positions for emission rows, on device (the bwa subsampling
    protocol of device/pipeline.py:_sa_positions: step = occ/max_occ,
    up to max_occ samples per interval).  rows [R, 6]; sample k of the
    flat output belongs to the row found by searchsorted on the
    cumulative counts.  Rows whose segment would cross SCAP form a
    SUFFIX (the cumsum is monotone), get no device positions, and the
    host computes them via the classic path — it mirrors the same
    integer arithmetic to find the cut.  Returns positions [SCAP]."""
    from .occ import sa_lookup
    R = rows.shape[0]
    size = jnp.where(valid, rows[:, 2].astype(I32), 0)
    x0 = rows[:, 0].astype(didx.idt)
    step = jnp.where(size > max_occ, size // max_occ, 1)
    cnt = jnp.minimum((size + step - 1) // step, max_occ)
    cnt = jnp.where(valid, cnt, 0)
    ends = jnp.cumsum(cnt)
    ok = ends <= SCAP
    cnt_eff = jnp.where(ok, cnt, 0)
    ends2 = jnp.cumsum(cnt_eff)
    starts2 = ends2 - cnt_eff
    total = ends2[-1]
    kk = jnp.arange(SCAP, dtype=I32)
    row_of = jnp.clip(jnp.searchsorted(ends2, kk, side="right"),
                      0, R - 1).astype(I32)
    ranks = (x0[row_of]
             + (kk - starts2[row_of]).astype(didx.idt)
             * step[row_of].astype(didx.idt))
    ranks = jnp.where(kk < total, ranks, 0)
    return sa_lookup(didx, ranks)


@partial(jax.jit, static_argnames=("P", "MAXC", "CAPF", "J2",
                                   "CAPF2", "MLX", "P2", "SCAPF",
                                   "max_occ",
                                   "min_seed_len", "split_len",
                                   "split_width", "max_rounds_f",
                                   "max_rounds_b", "qb_budget"))
def smem_chunk_machine_q(didx: DeviceIndex, q: jnp.ndarray,
                         lens: jnp.ndarray, jobs: jnp.ndarray,
                         P: int, MAXC: int, CAPF: int,
                         J2: int, CAPF2: int, MLX: int,
                         min_seed_len: int, split_len: int,
                         split_width: int, max_rounds_f: int = 2048,
                         max_rounds_b: int = 1024, P2: int = 0,
                         SCAPF: int = 0, max_occ: int = 500,
                         qb_budget: int = 0):
    """Two-round seeding machine with QUEUE-scheduled backward phases
    (see `_bwd_phase_queue`; forward phases and on-device round-2 job
    construction as `smem_chunk_machine`).  Round-2 jobs are built
    from the round-1 emission buffer IN BUFFER ORDER over rows of
    non-overflow, non-one-shot lanes — the host decode mirrors the
    identical filter to recover the job -> (read, x, mi) mapping.

    SCAPF > 0 fuses the SA stage: subsampled SA positions for all
    emission rows ([out1; out2] buffer order, `_sa_from_rows`) ride
    the same dispatch — the seeding->SA host round trip (H2D ranks +
    dispatch + sync) disappears.

    Returns flat idt:
      out1 [CAPF * N, 6] | ovf1 [N] | out2 [CAPF2 * J2, 6] | ovf2 [J2]
      | sa_pos [SCAPF * N if SCAPF else 0]
      | out_n1 | out_n2 | j2n | rounds_f1 | rounds_b1 | rounds_f2
      | rounds_b2
    rows are (x0, x1, size, qb, qe, lane); j2n unclamped (> J2 means
    the device ran out of round-2 lanes)."""
    dt = didx.idt
    N = jobs.shape[0]
    CAP1 = CAPF * N
    CAP2 = CAPF2 * J2
    ML = MLX * N
    read = jobs[:, 0].astype(I32)
    x0j = jobs[:, 1].astype(I32)
    min_intv = jobs[:, 2].astype(dt)
    one_shot = jobs[:, 3] != 0
    # ---- round 1
    outA = _fwd_phase(didx, q, lens, read, x0j, min_intv, one_shot,
                      P, MAXC, max_rounds_f)
    fovf1 = outA["ovf_s"] | outA["ovf_c"]
    nc = jnp.where(fovf1, 0, outA["call"])
    outB = _bwd_phase_queue(didx, q, lens, read, nc,
                            outA["meta"][:, :, 0],
                            outA["meta"][:, :, 1], outA["snap"],
                            min_intv, P, MAXC, CAP1, ML,
                            min_seed_len, max_rounds_b, qb_budget)
    ovf1 = fovf1 | outB["ovf"]
    # slice off the _mxu_append headroom; rows past out_n1 are garbage
    # (masked by every consumer below via pos < out_n1)
    out1, out_n1 = outB["out"][:CAP1], outB["out_n"]
    # ---- round-2 job construction (buffer order; host mirrors)
    pos = jnp.arange(CAP1, dtype=I32)
    lane_col = jnp.clip(out1[:, 5].astype(I32), 0, N - 1)
    qual = ((pos < out_n1) & ~ovf1[lane_col] & ~one_shot[lane_col]
            & ((out1[:, 4] - out1[:, 3]).astype(I32) >= split_len)
            & (out1[:, 2] <= jnp.asarray(split_width, dt)))
    qpos = jnp.cumsum(qual.astype(I32)) - 1
    j2n = jnp.sum(qual, dtype=I32)
    dest = jnp.where(qual & (qpos < J2), qpos, J2)
    jr2 = jnp.zeros(J2 + 1, I32).at[dest].set(read[lane_col],
                                              mode="drop")
    jx2 = jnp.full(J2 + 1, 1 << 30, I32).at[dest].set(
        ((out1[:, 3] + out1[:, 4]).astype(I32) >> 1), mode="drop")
    jmi2 = jnp.ones(J2 + 1, dt).at[dest].set(out1[:, 2] + 1,
                                             mode="drop")
    read2 = jr2[:J2]
    x2 = jx2[:J2]
    mi2 = jmi2[:J2]
    # ---- round 2 (one-shot calls, MAXC = 1; queue-scheduled fwd on
    # ML lanes — 2/3 of the J2 lockstep slots would be dead lanes
    # still paying gathers every round).  P2 < P shrinks the round-2
    # stack: reseeds start at min_intv = occ+1, so few size changes
    # survive — overflow lanes retry on the deep machine as usual.
    Pr2 = P2 if P2 > 0 else P
    outA2 = _fwd_phase_queue1(didx, q, lens, read2, x2, mi2,
                              jnp.minimum(j2n, J2), Pr2, ML,
                              max_rounds_f)
    fovf2 = outA2["ovf_s"] | outA2["ovf_c"]
    nc2 = jnp.where(fovf2, 0, outA2["call"])
    # ML = N machine lanes (not J2 = 2N): round-2 has ~1.3 calls per
    # read, so J2 lanes would mostly idle while paying the per-round
    # gather cost
    outB2 = _bwd_phase_queue(didx, q, lens, read2, nc2,
                             outA2["meta"][:, :, 0],
                             outA2["meta"][:, :, 1], outA2["snap"],
                             mi2, Pr2, 1, CAP2, ML, min_seed_len,
                             max_rounds_b, qb_budget)
    ovf2 = fovf2 | outB2["ovf"]
    out2 = outB2["out"][:CAP2]
    parts = [out1.reshape(-1), ovf1.astype(dt),
             out2.reshape(-1), ovf2.astype(dt)]
    if SCAPF > 0:
        rows_all = jnp.concatenate([out1, out2], axis=0)
        val = jnp.concatenate(
            [pos < out_n1,
             jnp.arange(CAP2, dtype=I32) < outB2["out_n"]])
        parts.append(_sa_from_rows(didx, rows_all, val, max_occ,
                                   SCAPF * N).astype(dt))
    parts += [out_n1.astype(dt)[None], outB2["out_n"].astype(dt)[None],
              j2n.astype(dt)[None],
              outA["rounds"].astype(dt)[None],
              outB["rounds"].astype(dt)[None],
              outA2["rounds"].astype(dt)[None],
              outB2["rounds"].astype(dt)[None]]
    return jnp.concatenate(parts)


MACH = 16384  # max lanes per machine dispatch (groups of smaller
              # machines serialize on their syncs)


def dispatch_call_machine(didx, qd, ld, read, x0, min_intv, one_shot,
                          P, MAXC, MAXR, CAPF, min_seed_len,
                          put=jnp.asarray, max_rounds_b=1024):
    """Pad lanes to pow2 and dispatch (async).  Returns the in-flight
    device buffer + mpad for decode_call_machine."""
    n = len(read)
    mpad = _pad_pow2(n)
    npdt = didx.np_idt
    jobs = np.zeros((mpad, 8), npdt)
    jobs[:, 1] = 1 << 30                 # pad lanes: x >= len -> DONE
    jobs[:, 2] = 1
    jobs[:, 3] = 1
    jobs[:n, 0] = read
    jobs[:n, 1] = x0
    jobs[:n, 2] = min_intv
    jobs[:n, 3] = one_shot
    buf = smem_call_machine(didx, qd, ld, put(jobs), P, MAXC, MAXR,
                            CAPF, int(min_seed_len),
                            max_rounds_b=int(max_rounds_b))
    return buf, mpad, n


def decode_call_machine(handle, CAPF):
    """Sync + decode a dispatch_call_machine buffer.  Returns (rows
    [total, 5] np — valid emissions lane-major; eff [n] per-lane
    counts (0 for overflow/spilled lanes); ovf [n] lanes for the
    retry path)."""
    import time as _time
    dbuf, mpad, n = handle
    t0 = _time.perf_counter()
    buf = np.asarray(dbuf)
    sync_s = _time.perf_counter() - t0
    cap = CAPF * mpad
    rows = buf[:cap * 5].reshape(cap, 5)
    aux = buf[cap * 5:][:mpad].astype(np.int64)
    mem_n = (aux & 0xFFFF).astype(np.int32)
    ovf = (aux >> 30) != 0
    eff = np.where(ovf, 0, mem_n)
    ends = np.cumsum(eff)
    spill = ends > cap
    ovf = ovf | spill
    eff = np.where(spill, 0, eff)
    base = ends - eff
    from .smem_split import _row_offsets
    sel = np.repeat(base[:n], eff[:n]) + _row_offsets(eff[:n])
    # extended row: (kind, lanes, live, rounds, ovf, spill,
    # rounds_f, rounds_b, sync_s) — profile_scale.py reads the tail
    SEED_STATS.append(("call", mpad, n, int(buf[-2]) + int(buf[-1]),
                       int(np.count_nonzero(ovf[:n])),
                       int(np.count_nonzero(spill[:n])),
                       int(buf[-2]), int(buf[-1]), sync_s))
    return rows[sel], eff[:n], ovf[:n]


def dispatch_batch(didx, qd, ld, read, x0, min_intv, one_shot,
                   P, MAXC, MAXR, CAPF, min_seed_len,
                   put=jnp.asarray, max_rounds_b=1024):
    """Dispatch a batch of smem1a lanes async: lanes group into
    <= MACH-lane machines, ALL dispatched before any sync (each
    serialized dispatch+sync idles the device).  Returns a
    list of in-flight handles for decode_batch."""
    n = len(read)
    handles = []
    for s in range(0, n, MACH):
        sl = slice(s, s + MACH)
        handles.append(dispatch_call_machine(
            didx, qd, ld, read[sl], x0[sl], min_intv[sl], one_shot[sl],
            P, MAXC, MAXR, CAPF, min_seed_len, put=put,
            max_rounds_b=max_rounds_b))
    return handles


def decode_batch(handles, CAPF):
    """Sync + decode dispatch_batch handles in order."""
    if len(handles) == 1:
        return decode_call_machine(handles[0], CAPF)
    rows_l, eff_l, ovf_l = [], [], []
    for h in handles:
        rows, eff, ovf = decode_call_machine(h, CAPF)
        rows_l.append(rows)
        eff_l.append(eff)
        ovf_l.append(ovf)
    return (np.concatenate(rows_l), np.concatenate(eff_l),
            np.concatenate(ovf_l))


def run_call_machine(didx, qd, ld, read, x0, min_intv, one_shot,
                     P, MAXC, MAXR, CAPF, min_seed_len,
                     put=jnp.asarray, max_rounds_b=1024):
    """dispatch_batch + decode_batch (the synchronous composition).
    Returns (rows [total, 5], eff [n], ovf [n]) in lane order."""
    return decode_batch(dispatch_batch(
        didx, qd, ld, read, x0, min_intv, one_shot, P, MAXC, MAXR,
        CAPF, min_seed_len, put=put, max_rounds_b=max_rounds_b), CAPF)


def _decode_rows(buf, off, mpad, n, CAPF):
    """Decode one packed (rows, aux) section from a flat machine
    buffer.  Returns (rows [total, 5], eff [n], ovf [n], next_off)."""
    cap = CAPF * mpad
    rows = buf[off:off + cap * 5].reshape(cap, 5)
    aux = buf[off + cap * 5:off + cap * 5 + mpad].astype(np.int64)
    mem_n = (aux & 0xFFFF).astype(np.int32)
    ovf = (aux >> 30) != 0
    eff = np.where(ovf, 0, mem_n)
    ends = np.cumsum(eff)
    spill = ends > cap
    ovf = ovf | spill
    eff = np.where(spill, 0, eff)
    base = ends - eff
    from .smem_split import _row_offsets
    sel = np.repeat(base[:n], eff[:n]) + _row_offsets(eff[:n])
    return rows[sel], eff[:n], ovf[:n], off + cap * 5 + mpad


def dispatch_chunk_machine(didx, qd, ld, read, x0, min_intv, one_shot,
                           P, MAXC, MAXR, CAPF, MAXR2, CAPF2,
                           min_seed_len, split_len, split_width,
                           put=jnp.asarray, max_rounds_b=1024):
    """Pad lanes to pow2 and dispatch the two-round chunk machine
    (async).  J2 = 2 * mpad round-2 lanes (observed ~1.3 jobs/read;
    overflow past J2 falls back to the separate-machine path)."""
    n = len(read)
    mpad = _pad_pow2(n)
    J2 = 2 * mpad
    npdt = didx.np_idt
    jobs = np.zeros((mpad, 8), npdt)
    jobs[:, 1] = 1 << 30
    jobs[:, 2] = 1
    jobs[:, 3] = 1
    jobs[:n, 0] = read
    jobs[:n, 1] = x0
    jobs[:n, 2] = min_intv
    jobs[:n, 3] = one_shot
    buf = smem_chunk_machine(didx, qd, ld, put(jobs), P, MAXC, MAXR,
                             CAPF, J2, MAXR2, CAPF2,
                             int(min_seed_len), int(split_len),
                             int(split_width),
                             max_rounds_b=int(max_rounds_b))
    return buf, mpad, n, J2


def decode_chunk_machine(handle, CAPF, CAPF2):
    """Sync + decode a dispatch_chunk_machine buffer.  Returns
    (rows1, eff1 [n], ovf1 [n], rows2, eff2 [j2n], ovf2 [j2n], j2n,
    j2_dropped) — j2_dropped means the device ran out of round-2 lanes
    and the caller must redo round 2 via the separate-machine path."""
    import time as _time
    dbuf, mpad, n, J2 = handle
    t0 = _time.perf_counter()
    buf = np.asarray(dbuf)
    sync_s = _time.perf_counter() - t0
    rows1, eff1, ovf1, off = _decode_rows(buf, 0, mpad, n, CAPF)
    rows2, eff2, ovf2, off = _decode_rows(buf, off, J2, J2, CAPF2)
    j2n_dev = int(buf[off])
    j2n = min(j2n_dev, J2)
    SEED_STATS.append(("mega", mpad + J2, n, int(buf[off + 1])
                       + int(buf[off + 2]) + int(buf[off + 3])
                       + int(buf[off + 4]),
                       int(np.count_nonzero(ovf1)),
                       int(np.count_nonzero(ovf2[:j2n])),
                       int(buf[off + 1]) + int(buf[off + 3]),
                       int(buf[off + 2]) + int(buf[off + 4]), sync_s))
    return (rows1, eff1, ovf1, rows2[:int(np.sum(eff2[:j2n]))],
            eff2[:j2n], ovf2[:j2n], j2n, j2n_dev > J2)


def _r2_jobs_from(opt, split_len, npdt, rows, rids,
                  osh_rows=None):
    """Round-2 reseed jobs (bwamem.c:mem_collect_intv second pass):
    long low-occ SMEMs re-seed from their midpoint, one-shot, with
    min_intv = occ + 1.  THE host mirror of the device-side job
    builders — every rounds12_* driver must use this single
    definition or the host/device job-list parity breaks silently
    (the count check cannot catch same-count divergence)."""
    jsel = ((rows[:, 4] - rows[:, 3] >= split_len)
            & (rows[:, 2] <= opt.split_width))
    if osh_rows is not None:
        jsel &= ~osh_rows
    rid = rids[jsel].astype(np.int32)
    jx = ((rows[jsel, 3] + rows[jsel, 4]) >> 1).astype(np.int32)
    jmi = (rows[jsel, 2] + 1).astype(npdt)
    return rid, jx, jmi


def _scalar_full(opt, fmi, reads, lens_np, split_len, npdt, jobs,
                 rows_out, rids_out, didx=None):
    """Terminal scalar fallback: one-shot jobs reseed directly; full-
    protocol jobs run round 1 plus ALL of their round-2 reseeds.
    Native C++ fast path (host/native_smem.py, ~30x) with the Python
    scalar reference as fallback — identical emission order."""
    from ..host.native_smem import smem_jobs_native
    nat = (smem_jobs_native(opt, fmi, reads, lens_np, split_len, jobs)
           if fmi is not None else None)
    if nat is not None:
        rows_out.append(nat[:, :5])
        rids_out.append(nat[:, 5])
        return
    from .smem import _scalar_reseed, _scalar_round1
    for (ri, x, mi, osh) in jobs:
        if osh:
            rows = _scalar_reseed(opt, fmi, reads[ri],
                                  int(lens_np[ri]), x, mi, didx=didx)
            rows_out.append(rows)
            rids_out.append(np.full(len(rows), ri, np.int64))
            continue
        rows = _scalar_round1(opt, fmi, reads[ri], int(lens_np[ri]),
                              didx=didx)
        rows_out.append(rows)
        rids_out.append(np.full(len(rows), ri, np.int64))
        rrid = np.full(len(rows), ri, np.int64)
        rid_, jx_, jmi_ = _r2_jobs_from(opt, split_len, npdt, rows,
                                        rrid)
        for k in range(len(rid_)):
            rr = _scalar_reseed(opt, fmi, reads[int(rid_[k])],
                                int(lens_np[int(rid_[k])]),
                                int(jx_[k]), int(jmi_[k]), didx=didx)
            rows_out.append(rr)
            rids_out.append(np.full(len(rr), int(rid_[k]), np.int64))


def dispatch_chunk_machine_q(didx, qd, ld, read, x0, min_intv,
                             one_shot, P, MAXC, CAPF, CAPF2,
                             min_seed_len, split_len, split_width,
                             put=jnp.asarray, max_rounds_b=1024,
                             MLX=1, P2=0, SCAPF=0, max_occ=500,
                             tp=None):
    """Pad lanes to pow2 and dispatch the queue-scheduled two-round
    chunk machine (async).  SCAPF > 0 fuses the SA stage into the
    same dispatch (see smem_chunk_machine_q).  tp: a dist.index_tp.
    TpIndex — the IDENTICAL machine then runs over the sharded index
    under shard_map (psum-routed occ/mark/SA reads); same buffer
    contract, so decode_chunk_machine_q is unchanged."""
    n = len(read)
    mpad = _pad_pow2(n)
    J2 = 2 * mpad
    npdt = didx.np_idt
    jobs = np.zeros((mpad, 8), npdt)
    jobs[:, 1] = 1 << 30
    jobs[:, 2] = 1
    jobs[:, 3] = 1
    jobs[:n, 0] = read
    jobs[:n, 1] = x0
    jobs[:n, 2] = min_intv
    jobs[:n, 3] = one_shot
    if tp is not None:
        from ..dist.index_tp import seed_machine_tp
        buf = seed_machine_tp(tp, qd, ld, jobs, P, MAXC, CAPF, CAPF2,
                              int(min_seed_len), int(split_len),
                              int(split_width),
                              max_rounds_b=int(max_rounds_b),
                              MLX=int(MLX), P2=int(P2),
                              SCAPF=int(SCAPF), max_occ=int(max_occ))
        return buf, mpad, n, J2, CAPF, CAPF2, SCAPF, max_occ
    import os as _os
    qb = int(_os.environ.get("TPUBWA_QB_BUDGET", 0))
    buf = smem_chunk_machine_q(didx, qd, ld, put(jobs), P, MAXC,
                               CAPF, J2, CAPF2, int(MLX),
                               int(min_seed_len), int(split_len),
                               int(split_width),
                               max_rounds_b=int(max_rounds_b),
                               P2=int(P2), SCAPF=int(SCAPF),
                               max_occ=int(max_occ), qb_budget=qb)
    return buf, mpad, n, J2, CAPF, CAPF2, SCAPF, max_occ


def _sa_segments(rows_cat, sa_pos, SCAP, max_occ):
    """Host mirror of `_sa_from_rows`: per raw row (r1 then r2
    order), its sample count and device-position segment.  Returns
    (cnt [R] — -1 for the spilled SUFFIX whose positions the host
    must compute, starts [R])."""
    size = rows_cat[:, 2]
    if max_occ <= 0:            # -c 0: every seed over-occ, no samples
        return (np.zeros(len(rows_cat), np.int64),
                np.zeros(len(rows_cat), np.int64))
    step = np.where(size > max_occ, size // max_occ, 1)
    cnt = np.minimum((size + step - 1) // step, max_occ)
    ends = np.cumsum(cnt)
    ok = ends <= SCAP
    return np.where(ok, cnt, -1).astype(np.int64), ends - cnt


def decode_chunk_machine_q(handle):
    """Sync + decode a dispatch_chunk_machine_q buffer.

    Returns (rows1 [k1, 5] int64, lane1 [k1] — per-row source lane
    (< n, buffer order, overflow lanes' rows already dropped);
    ovf1 [n]; rows2 [k2, 5], lane2 [k2] — round-2 job indices;
    ovf2 [J2]; j2n_dev — device's unclamped round-2 job count;
    sa — None, or (cnt1 [k1], pos1, cnt2 [k2], pos2): per kept row
    the device SA positions, cnt -1 where the host must compute)."""
    import time as _time
    dbuf, mpad, n, J2, CAPF, CAPF2, SCAPF, max_occ = handle
    t0 = _time.perf_counter()
    buf = np.asarray(dbuf)
    sync_s = _time.perf_counter() - t0
    cap1, cap2 = CAPF * mpad, CAPF2 * J2
    scap = SCAPF * mpad
    off = 0
    out1 = buf[off:off + cap1 * 6].reshape(cap1, 6)
    off += cap1 * 6
    ovf1 = buf[off:off + mpad] != 0
    off += mpad
    out2 = buf[off:off + cap2 * 6].reshape(cap2, 6)
    off += cap2 * 6
    ovf2 = buf[off:off + J2] != 0
    off += J2
    sa_pos = buf[off:off + scap].astype(np.int64)
    off += scap
    (out_n1, out_n2, j2n_dev, rf1, rb1, rf2, rb2) = (
        int(v) for v in buf[off:off + 7])
    r1 = out1[:out_n1]
    lane1 = r1[:, 5].astype(np.int64)
    keep1 = ~ovf1[lane1]
    r2 = out2[:out_n2]
    lane2 = r2[:, 5].astype(np.int64)
    keep2 = ~ovf2[lane2]
    sa = None
    if SCAPF > 0:
        rows_cat = np.vstack([r1[:, :5], r2[:, :5]]).astype(np.int64)
        cnt, starts = _sa_segments(rows_cat, sa_pos, scap, max_occ)
        from .smem_split import _row_offsets
        cntc = np.maximum(cnt, 0)
        sel = np.repeat(starts, cntc) + _row_offsets(cntc)
        pos_cat = sa_pos[sel]
        pos_off = np.zeros(len(cnt) + 1, np.int64)
        np.cumsum(cntc, out=pos_off[1:])
        k1 = out_n1

        def split(lo, hi, keep):
            c = cnt[lo:hi][keep]
            po = pos_off[lo:hi][keep]
            s2 = np.repeat(po, np.maximum(c, 0)) + _row_offsets(
                np.maximum(c, 0))
            return c, pos_cat[s2]
        cnt1, pos1 = split(0, k1, keep1)
        cnt2, pos2 = split(k1, k1 + out_n2, keep2)
        sa = (cnt1, pos1, cnt2, pos2)
    SEED_STATS.append(("megaq", mpad + J2, n, rf1 + rb1 + rf2 + rb2,
                       int(np.count_nonzero(ovf1[:n])),
                       int(np.count_nonzero(ovf2)),
                       rf1 + rf2, rb1 + rb2, sync_s))
    return (r1[keep1, :5].astype(np.int64), lane1[keep1], ovf1[:n],
            r2[keep2, :5].astype(np.int64), lane2[keep2], ovf2,
            j2n_dev, sa)


def rounds12_megaq(opt, didx, qd, ld, lens_np, reads, split_len, fmi,
                   put=jnp.asarray, tp=None):
    """Rounds 1-2 of mem_collect_intv on the queue-scheduled mega
    machine: ONE dispatch per <= MACH reads plus one deep tail machine
    for overflow lanes.  Returns (rows, rids, sa_cnt, sa_pos): the
    rounds12_fused contract plus fused SA positions — sa_cnt[i] is
    row i's bwa-protocol sample count with its positions in sa_pos
    (row order), or -1 where the host must compute them (retry/scalar
    rows, SA-buffer spill suffix).  sa_cnt/sa_pos are None when the
    fusion is disabled (TPUBWA_NO_SA_FUSE)."""
    B = len(lens_np)
    npdt = didx.np_idt
    from .smem_split import _stack_P
    P = _stack_P(didx)
    # MAXC 12 (not 8): ~0.5% of 100bp reads at realistic error rates
    # need 9 calls, and ONE over-cap lane per chunk forces a serial
    # deep-tail dispatch (~100 ms).  In the queue machine MAXC costs
    # only snapshot memory + phase-A write masks, not backward rounds.
    MAXC = 12 if np.asarray(reads).shape[1] <= 192 else 16
    P2, MAXC2 = 32, 32
    import os as _os
    RB_CAP = int(_os.environ.get("TPUBWA_RB_CAP", 1024))
    MLX = int(_os.environ.get("TPUBWA_QB_MLX", 1))
    QB_P2 = int(_os.environ.get("TPUBWA_QB_P2", 0))
    SCAPF = 0 if _os.environ.get("TPUBWA_NO_SA_FUSE") else \
        int(_os.environ.get("TPUBWA_SA_CAPF", 16))
    fuse = SCAPF > 0

    rows_out, rids_out, tail_jobs = [], [], []
    sac_out, sap_out = [], []
    NOPOS = np.zeros(0, np.int64)

    def emit(rows, rids, sa_seg=None):
        rows_out.append(rows)
        rids_out.append(rids)
        if fuse:
            if sa_seg is None:
                sac_out.append(np.full(len(rows), -1, np.int64))
                sap_out.append(NOPOS)
            else:
                sac_out.append(sa_seg[0])
                sap_out.append(sa_seg[1])

    handles = []
    for s in range(0, B, MACH):
        e = min(s + MACH, B)
        handles.append((s, dispatch_chunk_machine_q(
            didx, qd, ld, np.arange(s, e, dtype=np.int32),
            np.zeros(e - s, np.int32), np.ones(e - s, npdt),
            np.zeros(e - s, bool), P, MAXC, 5, 1,
            opt.min_seed_len, split_len, opt.split_width, put=put,
            max_rounds_b=RB_CAP, MLX=MLX, P2=QB_P2, SCAPF=SCAPF,
            max_occ=opt.max_occ, tp=tp)))
    for s, h in handles:
        (rows1, lane1, ovf1, rows2, lane2, ovf2,
         j2n_dev, sa) = decode_chunk_machine_q(h)
        rids1 = lane1 + s
        emit(rows1, rids1, (sa[0], sa[1]) if sa else None)
        tail_jobs += [(int(ri) + s, 0, 1, False)
                      for ri in np.flatnonzero(ovf1)]
        rid2, jx2, jmi2 = _r2_jobs_from(opt, split_len, npdt, rows1,
                                        rids1)
        J2 = h[3]
        if len(rid2) != j2n_dev:
            import logging
            logging.getLogger("tpubwa").info(
                "megaq r2 fallback: host mirror %d jobs, device %d",
                len(rid2), j2n_dev)
            tail_jobs += [(int(rid2[k]), int(jx2[k]), int(jmi2[k]),
                           True) for k in range(len(rid2))]
        else:
            # jobs >= J2 never ran on device (dropped); retry those
            # plus the flagged ones
            n_ok = min(j2n_dev, J2)
            emit(rows2, rid2[lane2].astype(np.int64),
                 (sa[2], sa[3]) if sa else None)
            redo = set(np.flatnonzero(ovf2[:n_ok]).tolist())
            redo.update(range(n_ok, j2n_dev))
            tail_jobs += [(int(rid2[k]), int(jx2[k]), int(jmi2[k]),
                           True) for k in sorted(redo)]
    # ---- ONE deep tail machine for everything flagged
    if tail_jobs:
        def scalar_full_jobs(jobs):
            n_before = len(rows_out)
            _scalar_full(opt, fmi, reads, lens_np, split_len, npdt,
                         jobs, rows_out, rids_out, didx=didx)
            if fuse:
                for b in rows_out[n_before:]:
                    sac_out.append(np.full(len(b), -1, np.int64))
                    sap_out.append(NOPOS)
        # a tiny tail (the common case: 1-3 overflow lanes per 8k-read
        # chunk) is cheaper on the host scalar path than a deep-machine
        # dispatch (~145 rounds + a sync for 2 live lanes);
        # bit-identity holds either way (the scalar
        # path IS the oracle).  With the native C++ scalar (~0.04 ms/
        # read vs ~60 ms Python at 64 Mb) the host path wins up to
        # hundreds of jobs, so the deep machine becomes the exception.
        from ..host.native_smem import _lib as _smem_lib
        # realistic corpora overflow ~1.2k lanes per 8k-read chunk —
        # at ~0.04 ms/read native that is ~50 ms on the host vs a
        # deep-machine dispatch of ~145 queue rounds, so the deep
        # machine is only for the no-native case
        tail_default = 4096 if _smem_lib() is not None else 8
        TAIL_HOST = int(_os.environ.get("TPUBWA_TAIL_HOST",
                                        tail_default))
        if tp is not None and fmi is not None:
            # TP mode: the deep-tail machine would need the REPLICATED
            # index (which a >1-HBM deployment does not have on any
            # single chip) — the host scalar path (which owns the host
            # FMIndex anyway) redoes every tail instead
            TAIL_HOST = len(tail_jobs)
        if len(tail_jobs) <= TAIL_HOST and fmi is not None:
            scalar_full_jobs(tail_jobs)
            tail_jobs = []
    if tail_jobs:
        jr = np.array([j[0] for j in tail_jobs], np.int32)
        jx0 = np.array([j[1] for j in tail_jobs], np.int32)
        jmi = np.array([j[2] for j in tail_jobs], npdt)
        josh = np.array([j[3] for j in tail_jobs], bool)
        h = dispatch_chunk_machine_q(
            didx, qd, ld, jr, jx0, jmi, josh, P2, MAXC2, 8, 2,
            opt.min_seed_len, split_len, opt.split_width, put=put,
            SCAPF=SCAPF, max_occ=opt.max_occ)
        (rows1, lane1, ovf1, rows2, lane2, ovf2,
         j2n_dev, sa) = decode_chunk_machine_q(h)
        rids1 = jr[lane1].astype(np.int64)
        emit(rows1, rids1, (sa[0], sa[1]) if sa else None)

        scalar_full = scalar_full_jobs
        scalar_full([tail_jobs[k] for k in np.flatnonzero(ovf1)])
        rrid, rjx, rjmi = _r2_jobs_from(opt, split_len, npdt, rows1,
                                        rids1, josh[lane1])
        J2t = h[3]
        if len(rrid) != j2n_dev:
            import logging
            logging.getLogger("tpubwa").info(
                "tail r2 fallback: host mirror %d jobs, device %d",
                len(rrid), j2n_dev)
            final_jobs = [(int(rrid[k]), int(rjx[k]), int(rjmi[k]),
                           True) for k in range(len(rrid))]
            if final_jobs:
                jf = np.array([j[0] for j in final_jobs], np.int32)
                xf = np.array([j[1] for j in final_jobs], np.int32)
                mf = np.array([j[2] for j in final_jobs], npdt)
                of = np.ones(len(final_jobs), bool)
                rows, eff, ovf = run_call_machine(
                    didx, qd, ld, jf, xf, mf, of, P2, MAXC2, 48, 8,
                    opt.min_seed_len, put=put)
                emit(rows.astype(np.int64),
                     np.repeat(jf.astype(np.int64), eff))
                scalar_full([final_jobs[k]
                             for k in np.flatnonzero(ovf)])
        else:
            n_ok = min(j2n_dev, J2t)
            emit(rows2, rrid[lane2].astype(np.int64),
                 (sa[2], sa[3]) if sa else None)
            redo = set(np.flatnonzero(ovf2[:n_ok]).tolist())
            redo.update(range(n_ok, j2n_dev))
            scalar_full([(int(rrid[k]), int(rjx[k]), int(rjmi[k]),
                          True) for k in sorted(redo)])
    rows = np.concatenate(rows_out)
    rids = np.concatenate(rids_out)
    if fuse:
        return rows, rids, np.concatenate(sac_out), \
            np.concatenate(sap_out)
    return rows, rids, None, None


def rounds12_mega(opt, didx, qd, ld, lens_np, reads, split_len, fmi,
                  put=jnp.asarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rounds 1-2 of mem_collect_intv with ONE dispatch per <= MACH
    reads (plus a deep retry machine for the rare overflow lanes).
    Same contract as rounds12_fused."""
    B = len(lens_np)
    npdt = didx.np_idt
    from .smem_split import _stack_P
    P = _stack_P(didx)
    MAXC = 8 if np.asarray(reads).shape[1] <= 192 else 16
    P2, MAXC2, MAXR2 = 32, 32, 48
    import os as _os
    RB_CAP = int(_os.environ.get("TPUBWA_RB_CAP", 1024))

    def r2_jobs_from(rows, rids):
        return _r2_jobs_from(opt, split_len, npdt, rows, rids)

    handles = []
    for s in range(0, B, MACH):
        e = min(s + MACH, B)
        handles.append((s, dispatch_chunk_machine(
            didx, qd, ld, np.arange(s, e, dtype=np.int32),
            np.zeros(e - s, np.int32), np.ones(e - s, npdt),
            np.zeros(e - s, bool), P, MAXC, 24, 5, 12, 1,
            opt.min_seed_len, split_len, opt.split_width, put=put,
            max_rounds_b=RB_CAP)))
    rows_out, rids_out, tail_jobs = [], [], []
    for s, h in handles:
        (rows1, eff1, ovf1, rows2, eff2, ovf2, j2n,
         j2_dropped) = decode_chunk_machine(h, 5, 1)
        rows1 = rows1.astype(np.int64)
        rids1 = np.repeat(np.arange(len(eff1), dtype=np.int64) + s,
                          eff1)
        rows_out.append(rows1)
        rids_out.append(rids1)
        # full-protocol retries for round-1 overflow lanes
        tail_jobs += [(int(ri) + s, 0, 1, False)
                      for ri in np.flatnonzero(ovf1)]
        # mirror the device's round-2 job list (same rows, same
        # (lane, slot) order) to resolve job lanes -> (read, x, mi)
        rid2, jx2, jmi2 = r2_jobs_from(rows1, rids1)
        if j2_dropped or len(rid2) != j2n:
            import logging
            logging.getLogger("tpubwa").info(
                "mega r2 fallback: host mirror %d jobs, device %d%s",
                len(rid2), j2n, " (J2 overflow)" if j2_dropped else "")
            # device ran out of J2 lanes (or the mirror disagrees —
            # defensive): redo ALL round-2 jobs on the separate path
            rows2 = np.zeros((0, 5), np.int64)
            tail_jobs += [(int(rid2[k]), int(jx2[k]), int(jmi2[k]),
                           True) for k in range(len(rid2))]
        else:
            rows_out.append(rows2.astype(np.int64))
            rids_out.append(np.repeat(rid2.astype(np.int64), eff2))
            tail_jobs += [(int(rid2[k]), int(jx2[k]), int(jmi2[k]),
                           True) for k in np.flatnonzero(ovf2)]
    # ONE deep chunk machine for everything flagged: full-protocol
    # retries run rounds 1+2 (their reseeds built on device, like the
    # main machine); one-shot retries just re-run with deep caps
    if tail_jobs:
        jr = np.array([j[0] for j in tail_jobs], np.int32)
        jx0 = np.array([j[1] for j in tail_jobs], np.int32)
        jmi = np.array([j[2] for j in tail_jobs], npdt)
        josh = np.array([j[3] for j in tail_jobs], bool)
        h = dispatch_chunk_machine(
            didx, qd, ld, jr, jx0, jmi, josh, P2, MAXC2, MAXR2, 8,
            MAXR2, 2, opt.min_seed_len, split_len, opt.split_width,
            put=put)
        (rows1, eff1, ovf1, rows2, eff2, ovf2, j2n,
         j2_dropped) = decode_chunk_machine(h, 8, 2)
        rows1 = rows1.astype(np.int64)
        rids1 = np.repeat(jr.astype(np.int64), eff1)
        rows_out.append(rows1)
        rids_out.append(rids1)
        # deep-machine overflow: fully scalar (round 1 + its reseeds)
        def scalar_full(jobs):
            _scalar_full(opt, fmi, reads, lens_np, split_len, npdt,
                         jobs, rows_out, rids_out, didx=didx)
        scalar_full([tail_jobs[k] for k in np.flatnonzero(ovf1)])
        # mirror the device's reseed job list: rows of NON-one-shot,
        # non-overflow tail lanes, in lane-major slot order
        osh_rows = np.repeat(josh, eff1)
        rrid, rjx, rjmi = r2_jobs_from(rows1[~osh_rows],
                                       rids1[~osh_rows])
        if j2_dropped or len(rrid) != j2n:
            import logging
            logging.getLogger("tpubwa").info(
                "tail r2 fallback: host mirror %d jobs, device %d",
                len(rrid), j2n)
            final_jobs = [(int(rrid[k]), int(rjx[k]), int(rjmi[k]),
                           True) for k in range(len(rrid))]
            if final_jobs:
                jf = np.array([j[0] for j in final_jobs], np.int32)
                xf = np.array([j[1] for j in final_jobs], np.int32)
                mf = np.array([j[2] for j in final_jobs], npdt)
                of = np.ones(len(final_jobs), bool)
                rows, eff, ovf = run_call_machine(
                    didx, qd, ld, jf, xf, mf, of, P2, MAXC2, MAXR2, 8,
                    opt.min_seed_len, put=put)
                rows_out.append(rows.astype(np.int64))
                rids_out.append(np.repeat(jf.astype(np.int64), eff))
                scalar_full([final_jobs[k]
                             for k in np.flatnonzero(ovf)])
        else:
            rows_out.append(rows2.astype(np.int64))
            rids_out.append(np.repeat(rrid.astype(np.int64), eff2))
            scalar_full([(int(rrid[k]), int(rjx[k]), int(rjmi[k]),
                          True) for k in np.flatnonzero(ovf2)])
    return np.concatenate(rows_out), np.concatenate(rids_out)


def rounds12_fused(opt, didx, qd, ld, lens_np, reads, split_len, fmi,
                   put=jnp.asarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rounds 1-2 of mem_collect_intv, one dispatch per round (plus a
    deeper-capacity retry pass for overflow lanes).  Same contract as
    smem_split.rounds12_split: flat (rows [n,5] int64, read_ids [n]),
    unsorted."""
    B = len(lens_np)
    npdt = didx.np_idt
    from .smem_split import _stack_P
    P = _stack_P(didx)
    MAXC = 8 if np.asarray(reads).shape[1] <= 192 else 16
    P2, MAXC2, MAXR2 = 32, 32, 48
    # straggler cap on the backward phase: ONE lane with a long summed
    # backward span makes all 16384 lanes idle through its tail rounds
    # (each phase-B round costs 2*P*N occ gathers).  Over-cap lanes are
    # flagged hung -> eovf and redo on the deep second-chance machine,
    # so bit-identity is preserved.  1024 = effectively uncapped.
    import os as _os
    RB_CAP = int(_os.environ.get("TPUBWA_RB_CAP", 1024))

    def run_scalar(jobs, rows_out, rids_out):
        from .smem import _scalar_reseed, _scalar_round1
        for (ri, x, mi, osh) in jobs:
            if osh:
                rows = _scalar_reseed(opt, fmi, reads[ri],
                                      int(lens_np[ri]), x, mi,
                                      didx=didx)
            else:
                rows = _scalar_round1(opt, fmi, reads[ri],
                                      int(lens_np[ri]), didx=didx)
            rows_out.append(rows)
            rids_out.append(np.full(len(rows), ri, np.int64))

    def job_arrays(jobs):
        jr = np.array([j[0] for j in jobs], np.int32)
        jx0 = np.array([j[1] for j in jobs], np.int32)
        jmi = np.array([j[2] for j in jobs], npdt)
        josh = np.array([j[3] for j in jobs], bool)
        return jr, jx0, jmi, josh

    def second_chance(jobs, rows_out, rids_out):
        if not jobs:
            return
        jr, jx0, jmi, josh = job_arrays(jobs)
        rows, eff, ovf = run_call_machine(
            didx, qd, ld, jr, jx0, jmi, josh, P2, MAXC2, MAXR2, 8,
            opt.min_seed_len, put=put)
        rows_out.append(rows.astype(np.int64))
        rids_out.append(np.repeat(jr.astype(np.int64), eff))
        run_scalar([jobs[k] for k in np.flatnonzero(ovf)],
                   rows_out, rids_out)

    def r2_jobs_from(rows, rids):
        return _r2_jobs_from(opt, split_len, npdt, rows, rids)

    # ---- round 1
    rows1, eff1, ovf1 = run_call_machine(
        didx, qd, ld, np.arange(B, dtype=np.int32),
        np.zeros(B, np.int32), np.ones(B, npdt), np.zeros(B, bool),
        P, MAXC, 24, 5, opt.min_seed_len, put=put,
        max_rounds_b=RB_CAP)
    rows1 = rows1.astype(np.int64)
    rids1 = np.repeat(np.arange(B, dtype=np.int64), eff1)
    sc_jobs = [(int(ri), 0, 1, False) for ri in np.flatnonzero(ovf1)]

    # overlap: the deep retry machine for r1-overflow lanes and the r2
    # machine for the good lanes are independent — dispatch BOTH before
    # either sync (the device would otherwise idle during the host
    # decode)
    sc_handles = None
    if sc_jobs:
        jr, jx0, jmi, josh = job_arrays(sc_jobs)
        sc_handles = dispatch_batch(
            didx, qd, ld, jr, jx0, jmi, josh, P2, MAXC2, MAXR2, 8,
            opt.min_seed_len, put=put)
    rid2, jx2, jmi2 = r2_jobs_from(rows1, rids1)
    r2_handles = None
    if len(rid2):
        r2_handles = dispatch_batch(
            didx, qd, ld, rid2, jx2, jmi2,
            np.ones(len(rid2), bool), P, 1, 12, 3,
            opt.min_seed_len, put=put, max_rounds_b=RB_CAP)

    rows_out = [rows1]
    rids_out = [rids1]
    tail_jobs = []   # one-shot jobs for the trailing deep machine
    if sc_handles is not None:
        jr = job_arrays(sc_jobs)[0]
        sc_rows, sc_eff, sc_ovf = decode_batch(sc_handles, 8)
        sc_blocks = [sc_rows.astype(np.int64)]
        sc_rid_blocks = [np.repeat(jr.astype(np.int64), sc_eff)]
        run_scalar([sc_jobs[k] for k in np.flatnonzero(sc_ovf)],
                   sc_blocks, sc_rid_blocks)
        sc_all = np.concatenate(sc_blocks)
        sc_rids_all = np.concatenate(sc_rid_blocks)
        rows_out.append(sc_all)
        rids_out.append(sc_rids_all)
        # retried reads' round-2 jobs ride the trailing machine
        rrid, rjx, rjmi = r2_jobs_from(sc_all, sc_rids_all)
        tail_jobs += [(int(rrid[k]), int(rjx[k]), int(rjmi[k]), True)
                      for k in range(len(rrid))]
    if r2_handles is not None:
        rows2, eff2, ovf2 = decode_batch(r2_handles, 3)
        rows_out.append(rows2.astype(np.int64))
        rids_out.append(np.repeat(rid2.astype(np.int64), eff2))
        tail_jobs += [(int(rid2[k]), int(jx2[k]), int(jmi2[k]), True)
                      for k in np.flatnonzero(ovf2)]
    second_chance(tail_jobs, rows_out, rids_out)
    return np.concatenate(rows_out), np.concatenate(rids_out)
