"""Phase-split bwt_smem1a machines (bwt.c:bwt_smem1a:~400; scalar spec
tpubwa/ref/smem.py:smem1a).

The combined cursor machine (smem_cursor.py) pays 2*(P+1) occ-row
gathers per lane per round — the P-slot backward stack is gathered
even during forward rounds, which are ~80% of all rounds (measured:
100 fwd steps vs 22 bwd rounds per 100 bp read).  At the gather-issue
floor this is the dominant seeding cost.  This module splits the
protocol into two lockstep machines:

  FWD machine   one forward bwt_extend per lane per round (2 gathers);
                pushes go straight into a per-(lane, call) snapshot
                buffer that STAYS ON DEVICE; at a call boundary the
                lane records (x, stack size) and restarts at the known
                return position ret = qe of the last push — the
                backward pass never changes ret, so calls never wait.

  BWD machine   one lane per recorded call; loads its stack snapshot
                (flipped to ascending-size order), then runs the exact
                backward pass of the combined machine: P-wide batched
                bwt_extend, prefix-failure emission from slot 0,
                size-dedup + compaction of survivors.

The driver buckets backward jobs by "dies in round 1" (x == 0 or an
ambiguous base at x-1 — no backward extension possible), so ~half the
lanes run a single round instead of idling for the longest lane.
Total gathers drop ~4-5x vs the combined machine.

Overflow lanes (stack > P, calls > MAXC, emissions > MAXM, round cap)
fall back to the scalar reference — bit-identity is preserved, not
approximated (pinned by tests/test_device_smem.py which runs the full
3-round protocol through this path).
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .occ import DeviceIndex, bwt_extend, set_intv

I32 = jnp.int32

RESTART, FWD, DONE = 0, 1, 3


def _sel_base(ok, c):
    """ok [..., 4, 3] select base c [...] -> [..., 3] (one-hot reduce;
    take_along_axis would be a separate gather kernel)."""
    oh = (jnp.arange(4, dtype=I32) == jnp.clip(c, 0, 3)[..., None])
    return jnp.sum(jnp.where(oh[..., None], ok, 0), axis=-2,
                   dtype=ok.dtype)


@partial(jax.jit, static_argnames=("P", "MAXC", "max_rounds",
                                   "unroll"))
def smem_fwd_machine(didx: DeviceIndex, q: jnp.ndarray,
                     lens: jnp.ndarray, jobs: jnp.ndarray,
                     P: int, MAXC: int,
                     max_rounds: int = 2048, unroll: int = 1):
    """Forward passes of bwt_smem1a for N independent lanes.

    q uint8 [B, L]; lens i32 [B]; jobs idt [N, 8] — columns 0..3 are
    (read, x0, min_intv, one_shot), the rest spare (one packed operand
    = ONE host-to-device transfer instead of four).
    one_shot != 0: exactly one smem1a call; else auto-restart at ret
    until the read is consumed.

    Returns (snap [N, MAXC, P, 4] idt — pushed intervals (x0, x1,
    size, qe) in PUSH order (descending size), kept on device for the
    BWD machine; host_buf i32 flat = meta [N, MAXC, 2] (call x, call
    stack size) then aux [N] = n_calls | stack-ovf << 28 | call-ovf
    << 29, then the round counter)."""
    dt = didx.idt
    read = jobs[:, 0].astype(I32)
    x0 = jobs[:, 1].astype(I32)
    min_intv = jobs[:, 2].astype(dt)
    one_shot = jobs[:, 3] != 0
    N = read.shape[0]
    L = q.shape[1]
    jidx = jnp.arange(P, dtype=I32)[None, :]
    cidx = jnp.arange(MAXC, dtype=I32)[None, :]
    len_i = lens[read].astype(I32)

    def q_at(pos):
        p = jnp.clip(pos, 0, L - 1)
        return q[read, p].astype(I32)

    state = dict(
        phase=jnp.zeros(N, I32),
        x=x0.astype(I32),
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

    def cond(s):
        live = jnp.any(s["phase"] != DONE)
        return live & (s["rounds"] < max_rounds)

    def body(s):
        phase, x, i = s["phase"], s["x"], s["i"]
        ik, ik_qe, m, call = s["ik"], s["ik_qe"], s["m"], s["call"]
        snap, meta = s["snap"], s["meta"]
        ovf_s, ovf_c = s["ovf_s"], s["ovf_c"]

        # ---------------- RESTART ----------------
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

        # ---------------- FWD ----------------
        fw = phase == FWD
        at_end = fw & (i >= len_i)
        ci = q_at(i)
        amb = fw & ~at_end & (ci > 3)
        okf = bwt_extend(didx, ik, is_back=False)       # [N, 4, 3]
        nik = _sel_base(okf, 3 - ci)
        schange = fw & ~at_end & ~amb & (nik[:, 2] != ik[:, 2])
        failf = schange & (nik[:, 2] < min_intv)
        push = at_end | amb | schange
        can_push = push & (m < P) & (call < MAXC)
        ovf_s = ovf_s | (push & (m >= P))
        row = jnp.concatenate([ik, ik_qe[:, None].astype(dt)], axis=1)
        wmask = (can_push[:, None, None]
                 & (cidx == call[:, None])[:, :, None]
                 & (jidx == m[:, None])[:, None, :])    # [N, MAXC, P]
        snap = jnp.where(wmask[:, :, :, None], row[:, None, None, :],
                         snap)
        m = m + push.astype(I32)
        adv = fw & ~at_end & ~amb & ~failf
        ik = jnp.where(adv[:, None], nik, ik)
        ik_qe = jnp.where(adv, i + 1, ik_qe)
        i = jnp.where(adv, i + 1, i)

        trans = at_end | amb | failf
        rec = trans & (call < MAXC)
        mmask = rec[:, None] & (cidx == call[:, None])   # [N, MAXC]
        mrow = jnp.stack([x, m], axis=1)                 # [N, 2]
        meta = jnp.where(mmask[:, :, None], mrow[:, None, :], meta)
        ovf_c = ovf_c | (trans & (call >= MAXC))
        call = call + trans.astype(I32)
        # restart at ret = qe of the last push == current ik_qe
        phase = jnp.where(trans & one_shot, DONE, phase)
        x = jnp.where(trans & ~one_shot, ik_qe, x)
        phase = jnp.where(trans & ~one_shot, RESTART, phase)
        phase = jnp.where(ovf_s | ovf_c, DONE, phase)

        return dict(phase=phase, x=x, i=i, ik=ik, ik_qe=ik_qe, m=m,
                    call=call, snap=snap, meta=meta, ovf_s=ovf_s,
                    ovf_c=ovf_c, rounds=s["rounds"] + 1)

    def body_k(s):
        # K protocol steps per while_loop round (finished lanes no-op
        # under composition); callers keep K = 1
        for _ in range(unroll):
            s = body(s)
        return s

    out = jax.lax.while_loop(cond, body_k, state)
    hung = (out["phase"] != DONE) & ~out["ovf_s"] & ~out["ovf_c"]
    overflow = out["ovf_s"] | out["ovf_c"] | hung
    aux = (out["call"] | (out["ovf_s"].astype(I32) << 28)
           | ((out["ovf_c"] | hung).astype(I32) << 29)
           | (overflow.astype(I32) << 30))
    host_buf = jnp.concatenate(
        [out["meta"].reshape(-1), aux,
         out["rounds"][None] * unroll])  # flat on the wire
    return out["snap"], host_buf


@partial(jax.jit, static_argnames=("P", "MAXM", "min_seed_len",
                                   "max_rounds", "unroll", "CAPF"))
def smem_bwd_machine(didx: DeviceIndex, q: jnp.ndarray,
                     lens: jnp.ndarray, snap: jnp.ndarray,
                     jobs: jnp.ndarray, P: int, MAXM: int,
                     min_seed_len: int, max_rounds: int = 512,
                     unroll: int = 1, CAPF: int = 3):
    """Backward pass for M recorded calls.

    snap idt [N, MAXC, P, 4] (device-resident FWD output); jobs idt
    [M, 8] — columns 0..4 are (src, read, x, m_in, min_intv) where src
    is the flat (lane * MAXC + call) snapshot row index (one packed
    operand = one H2D transfer).

    Returns flat idt: packed emission rows [CAPF * M, 5] (x0, x1,
    size, qb, qe — lane-major, compacted by an exclusive cumsum of
    per-lane counts so the D2H buffer is ~mean-occupancy-sized instead
    of MAXM-sized), then aux [M] = mem_n | overflow << 30, then the
    round counter.  Lanes whose rows spill past CAPF * M are NOT
    flagged here — the host recomputes the same cumsum from aux and
    routes spilled lanes to the scalar redo path (run_bwd/_decode_bwd)."""
    dt = didx.idt
    src = jobs[:, 0].astype(I32)
    read = jobs[:, 1].astype(I32)
    x = jobs[:, 2].astype(I32)
    m_in = jobs[:, 3].astype(I32)
    min_intv = jobs[:, 4].astype(dt)
    M = src.shape[0]
    L = q.shape[1]
    jidx = jnp.arange(P, dtype=I32)[None, :]

    # load stacks, flipping push order -> ascending-size slot order
    # (slot j = push index m-1-j), one one-hot contraction at load
    stk_push = snap.reshape(-1, P, 4)[src]              # [M, P, 4]
    flip_idx = jnp.clip(m_in[:, None] - 1 - jidx, 0, P - 1)  # [M, P]
    oh = flip_idx[:, :, None] == jidx[:, None, :]            # [M,P,P]
    st0 = jnp.sum(jnp.where(oh[:, :, :, None],
                            stk_push[:, None, :, :], 0), axis=2,
                  dtype=stk_push.dtype)
    st0 = jnp.where((jidx < m_in[:, None])[:, :, None], st0, 0)

    def q_at(pos):
        p = jnp.clip(pos, 0, L - 1)
        return q[read, p].astype(I32)

    state = dict(
        i=x.astype(I32) - 1,
        st=st0,
        m=m_in.astype(I32),
        call_emitted=jnp.zeros(M, bool),
        last_qb=jnp.zeros(M, I32),
        mem=jnp.zeros((M, MAXM, 5), dt),
        mem_n=jnp.zeros(M, I32),
        overflow=jnp.zeros(M, bool),
        done=m_in.astype(I32) <= 0,
        rounds=jnp.zeros((), I32),
    )

    def cond(s):
        return jnp.any(~s["done"]) & (s["rounds"] < max_rounds)

    def body(s):
        i, st, m = s["i"], s["st"], s["m"]
        mem, mem_n, overflow = s["mem"], s["mem_n"], s["overflow"]
        bw = ~s["done"]
        neg = (i < 0) | (q_at(i) > 3)
        cb = jnp.clip(q_at(i), 0, 3)
        okb = bwt_extend(didx, st[:, :, :3], is_back=True)  # [M,P,4,3]
        okc = _sel_base(okb, jnp.broadcast_to(cb[:, None], (M, P)))
        szs = okc[:, :, 2]
        validj = jidx < m[:, None]
        ext = validj & ~neg[:, None] & (szs >= min_intv[:, None])
        ext0 = ext[:, 0]
        # emission: slot 0 failing (sizes ascend along j, failures are
        # a prefix and only slot 0 can emit)
        emitc = bw & (m > 0) & ~ext0
        cond2 = ~s["call_emitted"] | (i + 1 < s["last_qb"])
        do_emit = emitc & cond2
        p0 = st[:, 0]
        len_ok = (p0[:, 3].astype(I32) - (i + 1)) >= min_seed_len
        store = do_emit & len_ok
        can_store = store & (mem_n < MAXM)
        overflow = overflow | (store & (mem_n >= MAXM))
        erow = jnp.concatenate(
            [p0[:, :3], (i + 1)[:, None].astype(dt), p0[:, 3:4]],
            axis=1)
        mslot = can_store[:, None] & (jnp.arange(MAXM, dtype=I32)[None]
                                      == mem_n[:, None])
        mem = jnp.where(mslot[:, :, None], erow[:, None, :], mem)
        mem_n = mem_n + can_store.astype(I32)
        call_emitted = jnp.where(do_emit, True, s["call_emitted"])
        last_qb = jnp.where(do_emit, i + 1, s["last_qb"])
        # survivors: dedup by size (keep first of each equal-size run)
        prev_ext = jnp.concatenate(
            [jnp.zeros((M, 1), bool), ext[:, :-1]], axis=1)
        prev_sz = jnp.concatenate(
            [jnp.full((M, 1), -1, dt), szs[:, :-1]], axis=1)
        kept = ext & (~prev_ext | (szs != prev_sz))
        new_m = jnp.sum(kept, axis=1).astype(I32)
        dest = jnp.cumsum(kept.astype(I32), axis=1) - 1
        newrow = jnp.concatenate([okc, st[:, :, 3:4]], axis=2)
        oh2 = kept[:, None, :] & (dest[:, None, :]
                                  == jidx[:, :, None])
        compacted = jnp.sum(
            jnp.where(oh2[:, :, :, None], newrow[:, None, :, :], 0),
            axis=2, dtype=newrow.dtype)
        st = jnp.where(bw[:, None, None], compacted, st)
        m = jnp.where(bw, new_m, m)
        deadb = bw & (new_m == 0)
        done = s["done"] | deadb | overflow
        i = jnp.where(bw & ~deadb, i - 1, i)
        return dict(i=i, st=st, m=m, call_emitted=call_emitted,
                    last_qb=last_qb, mem=mem, mem_n=mem_n,
                    overflow=overflow, done=done,
                    rounds=s["rounds"] + 1)

    def body_k(s):
        # see smem_fwd_machine: unroll kept at 1 (rounds are work-bound)
        for _ in range(unroll):
            s = body(s)
        return s

    out = jax.lax.while_loop(cond, body_k, state)
    overflow = out["overflow"] | ~out["done"]
    aux = out["mem_n"] | (overflow.astype(I32) << 30)
    # device-side compaction: the mem buffer is ~95% zeros (mean ~1-2
    # emissions per call vs MAXM slots); ship only the packed prefix
    cap = CAPF * M
    eff = jnp.where(overflow, 0, out["mem_n"])
    ends = jnp.cumsum(eff)
    base = ends - eff
    jm = jnp.arange(MAXM, dtype=I32)[None, :]
    tgt = base[:, None] + jm                       # [M, MAXM]
    valid = (jm < eff[:, None]) & (tgt < cap)
    tgt = jnp.where(valid, tgt, cap)               # cap = dump row
    packed = jnp.zeros((cap + 1, 5), dt).at[tgt.reshape(-1)].set(
        out["mem"].reshape(-1, 5), mode="drop")
    return jnp.concatenate([packed[:cap].reshape(-1),
                            aux.astype(dt),
                            (out["rounds"] * unroll).astype(dt)[None]])


def _pad_pow2(n: int, lo: int = 256) -> int:
    m = lo
    while m < n:
        m <<= 1
    return m


# telemetry per machine dispatch: fwd rows are (kind, lanes, live,
# rounds, stack_ovf, call_ovf); bwd rows are (kind, lanes, live,
# rounds, redo, spill).  Cleared/read by scripts/profile_scale.py —
# negligible cost (the counters ride the existing host buffer)
SEED_STATS: List[Tuple[str, int, int, int, int, int]] = []


def run_fwd(didx, qd, ld, read, x0, min_intv, one_shot, P, MAXC,
            put=jnp.asarray):
    """Pad lanes to pow2, run the FWD machine, return (device snap,
    meta [n, MAXC, 2] i32, n_calls [n], overflow [n])."""
    n = len(read)
    mpad = _pad_pow2(n)
    npdt = didx.np_idt
    jobs = np.zeros((mpad, 8), npdt)
    jobs[:, 1] = 1 << 30                # pad lanes: x >= len
    jobs[:, 2] = 1
    jobs[:, 3] = 1
    jobs[:n, 0] = read
    jobs[:n, 1] = x0
    jobs[:n, 2] = min_intv
    jobs[:n, 3] = one_shot
    snap, host_buf = smem_fwd_machine(didx, qd, ld, put(jobs), P, MAXC)
    buf = np.asarray(host_buf)
    meta = buf[:mpad * MAXC * 2].reshape(mpad, MAXC, 2)[:n]
    aux = buf[mpad * MAXC * 2:][:n]
    SEED_STATS.append(("fwd", mpad, n, int(buf[-1]),
                       int(np.count_nonzero((aux >> 28) & 1)),
                       int(np.count_nonzero((aux >> 29) & 1))))
    return snap, meta, (aux & 0xFFFF).astype(np.int32), (aux >> 30) != 0


CAPF = 3  # packed-output rows per lane (mean occupancy ~1-2; spilled
          # lanes fall back to the scalar redo path)


def run_bwd(didx, qd, ld, snap, jobs, P, MAXM, min_seed_len,
            put=jnp.asarray):
    """jobs: (src, read, x, m, min_intv) arrays [M].  Returns the
    packed device buffer + mpad (decode with _decode_bwd)."""
    n = len(jobs[0])
    npdt = didx.np_idt
    mpad = _pad_pow2(n)
    packed = np.zeros((mpad, 8), npdt)   # pad lanes: m == 0 -> done
    packed[:n, 0] = jobs[0]
    packed[:n, 1] = jobs[1]
    packed[:n, 2] = jobs[2]
    packed[:n, 3] = jobs[3]
    packed[:, 4] = 1
    packed[:n, 4] = jobs[4]
    buf = smem_bwd_machine(didx, qd, ld, snap, put(packed), P, MAXM,
                           int(min_seed_len), CAPF=CAPF)
    return buf, mpad


def _decode_bwd(buf, mpad, n, MAXM):
    """Returns (rows [total, 5] — valid emissions in (lane, slot)
    order for non-overflow, non-spilled lanes; eff [n] per-lane row
    counts (0 for redo lanes); ovf [n] lanes for the scalar redo
    path)."""
    cap = CAPF * mpad
    arr = np.asarray(buf)
    rows = arr[:cap * 5].reshape(cap, 5)
    aux = arr[cap * 5:][:mpad].astype(np.int64)
    mem_n = (aux & 0xFFFF).astype(np.int32)
    ovf = (aux >> 30) != 0
    # mirror the device cumsum over ALL mpad lanes; lanes whose rows
    # spilled past cap join the redo set
    eff = np.where(ovf, 0, mem_n)
    ends = np.cumsum(eff)
    spill = ends > cap
    ovf = ovf | spill
    eff = np.where(spill, 0, eff)
    SEED_STATS.append(("bwd", mpad, n, int(arr[-1]),
                       int(np.count_nonzero(ovf[:n])),
                       int(np.count_nonzero(spill[:n]))))
    base = ends - eff
    sel = np.repeat(base[:n], eff[:n]) + _row_offsets(eff[:n])
    return rows[sel], eff[:n], ovf[:n]


def _row_offsets(counts):
    """[0..c0-1, 0..c1-1, ...] for per-lane counts."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def _stack_P(didx) -> int:
    # stack depth ~ #distinct interval sizes along one extension path
    # (grows with log4(genome)).  TPUBWA_STACK_P overrides: the bwd
    # queue's per-round gather volume is ML x P, so a SMALLER P cuts
    # the dominant seeding cost while deep lanes overflow to the
    # native tail (bit-identity preserved by the ovf protocol)
    import os
    env = os.environ.get("TPUBWA_STACK_P")
    if env:
        return max(8, int(env))
    return 16 if didx.seq_len < (1 << 28) else 24


def rounds12_split(opt, didx, qd, ld, lens_np, reads, split_len, fmi,
                   MAXC: int = 0, MAXM: int = 12, put=jnp.asarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Rounds 1-2 of mem_collect_intv via the split machines.
    Same contract as smem._rounds12_cursor: flat (rows [n,5] int64,
    read_ids [n]), unsorted."""
    B = len(lens_np)
    npdt = didx.np_idt
    P = _stack_P(didx)
    reads_np = np.asarray(reads)
    if MAXC == 0:
        # smem1a calls per read grow with read length (~1 per 30-40 bp
        # advanced); overflowing lanes redo on the host scalar path
        MAXC = 8 if reads_np.shape[1] <= 192 else 16

    def bwd_all(snap, jsrc, jread, jx, jm, jmi, P_=None, MAXM_=None,
                single_group=False):
        """Dispatch span buckets (trivial = dies in backward round 1;
        the rest split by x, which bounds the span — the lockstep loop
        runs max-span rounds, so mixing x=5 and x=90 lanes makes the
        short ones idle), sync once each; returns flat rows + rids +
        scalar-redo jobs."""
        Pq = P if P_ is None else P_
        Mq = MAXM if MAXM_ is None else MAXM_
        prev_ok = (jx > 0)
        prevc = reads_np[jread, np.maximum(jx - 1, 0)]
        nontriv = prev_ok & (prevc <= 3)
        rows_out, rids_out, redo = [], [], []
        bufs = []
        import os as _os
        MACH = int(_os.environ.get("TPUBWA_BWD_MACH", 8192))
        if single_group:
            groups = [np.arange(len(jsrc))]
        else:
            groups = [np.flatnonzero(~nontriv)]
            nt = np.flatnonzero(nontriv)
            if len(nt) > MACH:
                # sort by x (the span bound) so each sub-machine's
                # rounds track ITS jobs' spans instead of the global max
                nt = nt[np.argsort(-jx[nt], kind="stable")]
                groups += [nt[s:s + MACH]
                           for s in range(0, len(nt), MACH)]
            else:
                groups.append(nt)
        for idx in groups:
            if not len(idx):
                bufs.append(None)
                continue
            buf, mpad = run_bwd(
                didx, qd, ld, snap,
                (jsrc[idx], jread[idx], jx[idx], jm[idx], jmi[idx]),
                Pq, Mq, opt.min_seed_len, put=put)
            bufs.append((buf, mpad, idx))
        for ent in bufs:
            if ent is None:
                continue
            buf, mpad, idx = ent
            rows, eff, ovf = _decode_bwd(buf, mpad, len(idx), Mq)
            rows_out.append(rows.astype(np.int64))
            rids_out.append(
                np.repeat(jread[idx].astype(np.int64), eff))
            for k in np.flatnonzero(ovf):
                redo.append((int(jread[idx[k]]), int(jx[idx[k]]),
                             int(jmi[idx[k]])))
        return rows_out, rids_out, redo

    # deeper-capacity retry machines for the rare overflow lanes: a
    # host _scalar_round1 costs ~40 ms/read at 64 Mb (1.2-1.5 s per
    # chunk for ~30 lanes, measured) vs ~100 ms for one tiny machine
    # pass; only lanes that ALSO overflow P=32/MAXC=32 go scalar
    P2, MAXC2, MAXM2 = 32, 32, 32

    def second_chance(jobs):
        """jobs: list of (ri, x, mi, one_shot).  Returns (rows_blocks,
        rids_blocks, leftover jobs in the same form)."""
        if not jobs:
            return [], [], []
        jr = np.array([j[0] for j in jobs], np.int32)
        jx0 = np.array([j[1] for j in jobs], np.int32)
        jmi0 = np.array([j[2] for j in jobs], npdt)
        josh = np.array([j[3] for j in jobs], bool)
        snap2, meta2, nc2, ovf2 = run_fwd(
            didx, qd, ld, jr, jx0, jmi0, josh, P2, MAXC2, put=put)
        good = ~ovf2
        csel = (np.arange(MAXC2)[None, :] < nc2[:, None]) & good[:, None]
        cm = csel.reshape(-1)
        lidx = np.repeat(np.arange(len(jr), dtype=np.int32), MAXC2)[cm]
        calls = np.tile(np.arange(MAXC2, dtype=np.int32), len(jr))[cm]
        jsrc = lidx * MAXC2 + calls
        jx = meta2.reshape(-1, 2)[cm, 0].astype(np.int32)
        jm = meta2.reshape(-1, 2)[cm, 1].astype(np.int32)
        rows_b, rids_b, redo = bwd_all(
            snap2, jsrc, jr[lidx], jx, jm, jmi0[lidx], P_=P2,
            MAXM_=MAXM2, single_group=True)
        left = [(int(jr[k]), int(jx0[k]), int(jmi0[k]), bool(josh[k]))
                for k in np.flatnonzero(ovf2)]
        # bwd redo entries are per-call one-shots regardless of origin
        left += [(ri, x, mi, True) for (ri, x, mi) in redo]
        return rows_b, rids_b, left

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

    # ---- round 1: forward machine over all reads
    snap, meta, ncalls, ovfA = run_fwd(
        didx, qd, ld, np.arange(B, dtype=np.int32),
        np.zeros(B, np.int32), np.ones(B, npdt),
        np.zeros(B, bool), P, MAXC, put=put)
    good = ~ovfA
    csel = (np.arange(MAXC)[None, :] < ncalls[:, None]) & good[:, None]
    cm = csel.reshape(-1)
    lanes = np.repeat(np.arange(B, dtype=np.int32), MAXC)[cm]
    calls = np.tile(np.arange(MAXC, dtype=np.int32), B)[cm]
    jsrc = lanes * MAXC + calls
    jx = meta.reshape(-1, 2)[cm, 0].astype(np.int32)
    jm = meta.reshape(-1, 2)[cm, 1].astype(np.int32)
    jmi = np.ones(len(jsrc), npdt)
    rows_out, rids_out, redo = bwd_all(snap, jsrc, lanes, jx, jm, jmi)
    sc_jobs = [(int(ri), 0, 1, False) for ri in np.flatnonzero(ovfA)]
    sc_jobs += [(ri, x, mi, True) for (ri, x, mi) in redo]
    ro, io, left = second_chance(sc_jobs)
    rows_out += ro
    rids_out += io
    run_scalar(left, rows_out, rids_out)
    r1_rows = np.concatenate(rows_out) if rows_out \
        else np.zeros((0, 5), np.int64)
    r1_rids = np.concatenate(rids_out) if rids_out \
        else np.zeros(0, np.int64)

    # ---- round 2: re-seed long low-occ SMEMs (one-shot calls)
    jsel = ((r1_rows[:, 4] - r1_rows[:, 3] >= split_len)
            & (r1_rows[:, 2] <= opt.split_width))
    job_rid = r1_rids[jsel].astype(np.int32)
    if not len(job_rid):
        return r1_rows, r1_rids
    job_x = ((r1_rows[jsel, 3] + r1_rows[jsel, 4]) >> 1) \
        .astype(np.int32)
    job_mi = (r1_rows[jsel, 2] + 1).astype(npdt)
    # NOTE: splitting THIS fwd machine into 8192-lane groups was
    # measured slower (the groups serialize on their syncs); only the
    # bwd machines benefit from the 8192 cap (bwd_all)
    snap2, meta2, ncalls2, ovfA2 = run_fwd(
        didx, qd, ld, job_rid, job_x, job_mi,
        np.ones(len(job_rid), bool), P, MAXC, put=put)
    good2 = ~ovfA2 & (ncalls2 > 0)
    idx2 = np.flatnonzero(good2)
    rows_out, rids_out = [r1_rows], [r1_rids]
    redo2 = [(int(job_rid[k]), int(job_x[k]), int(job_mi[k]))
             for k in np.flatnonzero(ovfA2)]
    if len(idx2):
        lanes2 = idx2.astype(np.int32)
        jsrc2 = lanes2 * MAXC  # one_shot: call 0 only
        jx2 = meta2[idx2, 0, 0].astype(np.int32)
        jm2 = meta2[idx2, 0, 1].astype(np.int32)
        ro, io, rd = bwd_all(snap2, jsrc2, job_rid[idx2], jx2, jm2,
                             job_mi[idx2])
        rows_out += ro
        rids_out += io
        redo2 += rd
    ro, io, left = second_chance([(ri, x, mi, True)
                                  for (ri, x, mi) in redo2])
    rows_out += ro
    rids_out += io
    run_scalar(left, rows_out, rids_out)
    return np.concatenate(rows_out), np.concatenate(rids_out)
