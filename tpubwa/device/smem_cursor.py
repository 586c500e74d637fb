"""Lockstep bwt_smem1a cursor machine (bwt.c:bwt_smem1a:~400; scalar
spec: tpubwa/ref/smem.py:smem1a — SURVEY.md §2 row 5 "per-read cursor
loop").

The all-starts reach formulation (smem.py:smems_round1) runs one BWT
search per (read, position): simple, but ~10x more bwt_extend work
than bwa's protocol, whose backward pass covers ALL left endpoints with
one stack of <= ~12 nested intervals.  This module runs that exact
protocol for N independent jobs in lockstep:

  lane state machine: RESTART -> FWD -> BWD -> (RESTART | DONE)
    RESTART  advance x over ambiguous bases; seed ik = set_intv(q[x])
    FWD      one forward bwt_extend per round; push ik to the stack on
             interval-size change; break on min_intv/amb/end
    BWD      one round PER QUERY POSITION i: all P stack slots extend
             backward in one batched bwt_extend; the failing prefix
             emits (slot sizes ascend along the stack, so failures are
             always a prefix and only slot 0 can emit); survivors are
             size-deduped and compacted — exactly the scalar j-loop,
             vectorized

  round-1 lanes (one per read) auto-restart at the returned x until the
  read is consumed; re-seed lanes (one per round-2 job) run a single
  smem1a(x, min_intv) call (one_shot).

Only the max_intv == 0 form is implemented (rounds 1-2 always use it;
round 3 is bwt_seed_strategy1, a separate machine in smem.py).

Emissions are length-filtered on device (callers keep qe-qb >=
min_seed_len in both rounds) and capped at MAXM per lane; stack depth
is capped at P.  Lanes that overflow either cap are flagged and redone
on the host with the scalar reference — bit-identity is preserved, not
approximated (pinned by tests/test_smem_cursor.py).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .occ import DeviceIndex, bwt_extend, set_intv

I32 = jnp.int32

RESTART, FWD, BWD, DONE = 0, 1, 2, 3


@partial(jax.jit, static_argnames=("P", "MAXM", "min_seed_len",
                                   "max_rounds"))
def smem_cursor_machine(didx: DeviceIndex, q: jnp.ndarray,
                        lens: jnp.ndarray, read: jnp.ndarray,
                        x0: jnp.ndarray, min_intv: jnp.ndarray,
                        one_shot: jnp.ndarray, P: int, MAXM: int,
                        min_seed_len: int, max_rounds: int = 0):
    """q uint8 [B, L]; lens i32 [B]; per-lane read/x0 i32 [N],
    min_intv idt [N], one_shot bool [N].

    Returns (mem flat idt [N*MAXM*5] rows (x0, x1, size, qb, qe),
    mem_n i32 [N], overflow bool [N])."""
    dt = didx.idt
    N = read.shape[0]
    L = q.shape[1]
    lanes = jnp.arange(N, dtype=I32)
    jidx = jnp.arange(P, dtype=I32)[None, :]          # [1, P]
    len_i = lens[read].astype(I32)

    def q_at(pos):
        p = jnp.clip(pos, 0, L - 1)
        return q[read, p].astype(I32)

    def gather_slot(st, idx):
        """st [N, P, 4], idx [N] -> [N, 4] via one-hot reduce (fuses;
        take_along_axis would be a separate gather kernel)."""
        oh = jidx == jnp.clip(idx, 0, P - 1)[:, None]     # [N, P]
        return jnp.sum(jnp.where(oh[:, :, None], st, 0), axis=1,
                       dtype=st.dtype)

    def sel_base(ok, c):
        """ok [..., 4, 3] select base c [...] -> [..., 3]."""
        oh = (jnp.arange(4, dtype=I32) ==
              jnp.clip(c, 0, 3)[..., None])               # [..., 4]
        return jnp.sum(jnp.where(oh[..., None], ok, 0), axis=-2,
                       dtype=ok.dtype)

    state = dict(
        phase=jnp.zeros(N, I32),
        x=x0.astype(I32),
        i=jnp.zeros(N, I32),
        ik=jnp.zeros((N, 3), dt),
        ik_qe=jnp.zeros(N, I32),
        st=jnp.zeros((N, P, 4), dt),
        m=jnp.zeros(N, I32),
        ret=jnp.zeros(N, I32),
        call_emitted=jnp.zeros(N, bool),
        last_qb=jnp.zeros(N, I32),
        mem=jnp.zeros((N, MAXM, 5), dt),
        mem_n=jnp.zeros(N, I32),
        overflow=jnp.zeros(N, bool),
        rounds=jnp.zeros((), I32),
    )

    def cond(s):
        live = jnp.any(s["phase"] != DONE)
        if max_rounds:
            # straggler cap: lanes still live at the cap are flagged
            # and redone on the host — the whole batch otherwise waits
            # on its slowest lane
            return live & (s["rounds"] < max_rounds)
        return live

    def body(s):
        phase, x, i = s["phase"], s["x"], s["i"]
        ik, ik_qe, st, m = s["ik"], s["ik_qe"], s["st"], s["m"]
        mem, mem_n = s["mem"], s["mem_n"]
        overflow = s["overflow"]

        # ---------------- RESTART ----------------
        rs = phase == RESTART
        done_read = rs & (x >= len_i)
        cx = q_at(x)
        amb0 = rs & ~done_read & (cx > 3)
        start = rs & ~done_read & (cx <= 3)
        # ambiguous start of a one-shot call: scalar returns x+1, no mems
        phase = jnp.where(done_read | (amb0 & one_shot), DONE, phase)
        x = jnp.where(amb0 & ~one_shot, x + 1, x)
        ik = jnp.where(start[:, None],
                       set_intv(didx, jnp.clip(cx, 0, 3)), ik)
        ik_qe = jnp.where(start, x + 1, ik_qe)
        i = jnp.where(start, x + 1, i)
        m = jnp.where(start, 0, m)
        call_emitted = jnp.where(start, False, s["call_emitted"])
        phase = jnp.where(start, FWD, phase)

        # ---------------- FWD ----------------
        fw = phase == FWD
        at_end = fw & (i >= len_i)
        ci = q_at(i)
        amb = fw & ~at_end & (ci > 3)
        okf = bwt_extend(didx, ik, is_back=False)      # [N, 4, 3]
        nik = sel_base(okf, 3 - ci)
        schange = fw & ~at_end & ~amb & (nik[:, 2] != ik[:, 2])
        failf = schange & (nik[:, 2] < min_intv)
        push = at_end | amb | schange
        can_push = push & (m < P)
        overflow = overflow | (push & (m >= P))
        row = jnp.concatenate([ik, ik_qe[:, None].astype(dt)], axis=1)
        slot = can_push[:, None] & (jidx == m[:, None])   # [N, P]
        st = jnp.where(slot[:, :, None], row[:, None, :], st)
        m = m + push.astype(I32)
        adv = fw & ~at_end & ~amb & ~failf
        ik = jnp.where((adv & schange)[:, None], nik,
                       jnp.where(adv[:, None] & ~schange[:, None], nik,
                                 ik))
        # (non-schange forward step also moves to ok[c]: sizes equal but
        # the interval coordinates advance)
        ik_qe = jnp.where(adv, i + 1, ik_qe)
        i = jnp.where(adv, i + 1, i)
        trans = at_end | amb | failf
        mt = jnp.where(trans, m, 1)
        last = gather_slot(st, mt - 1)
        ret = jnp.where(trans, last[:, 3].astype(I32), s["ret"])
        # flip stack to prev order (longest match = smallest size
        # first) — one-hot matmul-style flip, no gather kernel
        flip_idx = jnp.clip(m[:, None] - 1 - jidx, 0, P - 1)  # [N, P]
        oh = flip_idx[:, :, None] == jidx[:, None, :]          # [N,P,P]
        st_flip = jnp.sum(
            jnp.where(oh[:, :, :, None], st[:, None, :, :], 0), axis=2,
            dtype=st.dtype)
        st = jnp.where(trans[:, None, None], st_flip, st)
        i = jnp.where(trans, x - 1, i)
        phase = jnp.where(trans, BWD, phase)

        # ---------------- BWD ----------------
        bw = phase == BWD
        neg = (i < 0) | (q_at(i) > 3)
        cb = jnp.clip(q_at(i), 0, 3)
        okb = bwt_extend(didx, st[:, :, :3], is_back=True)  # [N,P,4,3]
        okc = sel_base(okb, jnp.broadcast_to(cb[:, None], (N, P)))
        szs = okc[:, :, 2]
        validj = jidx < m[:, None]
        ext = validj & ~neg[:, None] & (szs >= min_intv[:, None])
        ext0 = ext[:, 0]
        # emission: slot 0 failing (sizes ascend along j, failures are a
        # prefix; later failing slots never pass the i+1 < last_qb test)
        emitc = bw & (m > 0) & ~ext0
        cond2 = ~s["call_emitted"] | (i + 1 < s["last_qb"])
        do_emit = emitc & cond2
        p0 = gather_slot(st, jnp.zeros(N, I32))
        len_ok = (p0[:, 3].astype(I32) - (i + 1)) >= min_seed_len
        store = do_emit & len_ok
        can_store = store & (mem_n < MAXM)
        overflow = overflow | (store & (mem_n >= MAXM))
        erow = jnp.concatenate(
            [p0[:, :3], (i + 1)[:, None].astype(dt), p0[:, 3:4]], axis=1)
        mslot = can_store[:, None] & (jnp.arange(MAXM, dtype=I32)[None]
                                      == mem_n[:, None])
        mem = jnp.where(mslot[:, :, None], erow[:, None, :], mem)
        mem_n = mem_n + can_store.astype(I32)
        call_emitted = jnp.where(do_emit, True, call_emitted)
        last_qb = jnp.where(do_emit, i + 1, s["last_qb"])
        # survivors: dedup by size (keep first of each equal-size run)
        prev_ext = jnp.concatenate(
            [jnp.zeros((N, 1), bool), ext[:, :-1]], axis=1)
        prev_sz = jnp.concatenate(
            [jnp.full((N, 1), -1, dt), szs[:, :-1]], axis=1)
        kept = ext & (~prev_ext | (szs != prev_sz))
        new_m = jnp.sum(kept, axis=1).astype(I32)
        # compact kept slots to the front, preserving order: dest[j] =
        # #kept before j; one-hot reduce instead of argsort+gather
        dest = jnp.cumsum(kept.astype(I32), axis=1) - 1       # [N, P]
        newrow = jnp.concatenate([okc, st[:, :, 3:4]], axis=2)
        oh = kept[:, None, :] & (dest[:, None, :]
                                 == jidx[:, :, None])          # [N,P(d),P(j)]
        compacted = jnp.sum(
            jnp.where(oh[:, :, :, None], newrow[:, None, :, :], 0),
            axis=2, dtype=newrow.dtype)
        st = jnp.where(bw[:, None, None], compacted, st)
        m = jnp.where(bw, new_m, m)
        deadb = bw & (new_m == 0)
        i = jnp.where(bw & ~deadb, i - 1, i)
        phase = jnp.where(deadb & one_shot, DONE, phase)
        back_restart = deadb & ~one_shot
        x = jnp.where(back_restart, ret, x)
        phase = jnp.where(back_restart, RESTART, phase)
        # overflowed lanes halt immediately (host redoes them)
        phase = jnp.where(overflow, DONE, phase)

        return dict(phase=phase, x=x, i=i, ik=ik, ik_qe=ik_qe, st=st,
                    m=m, ret=ret, call_emitted=call_emitted,
                    last_qb=last_qb, mem=mem, mem_n=mem_n,
                    overflow=overflow, rounds=s["rounds"] + 1)

    out = jax.lax.while_loop(cond, body, state)
    overflow = out["overflow"] | (out["phase"] != DONE)
    # pack mem_n + overflow into one aux buffer: every extra D2H
    # transfer costs a ~40 ms link round trip
    aux = out["mem_n"] | (overflow.astype(I32) << 30)
    return out["mem"].reshape(-1), aux


def _pad_pow2(n: int, lo: int = 256) -> int:
    m = lo
    while m < n:
        m <<= 1
    return m


def run_smem_jobs(didx: DeviceIndex, qd, ld, jobs, min_seed_len: int,
                  P: int = 0, MAXM: int = 12, max_rounds: int = 512
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jobs: (read, x0, min_intv, one_shot) int arrays.  Pads the lane
    count to pow2 buckets; returns (mem [n, MAXM, 5], mem_n [n],
    overflow [n]) trimmed to the real lane count."""
    n = len(jobs[0])
    # the aux packing below is mem_n | (overflow << 30); decoding masks
    # with 0xFFFF, so the emission cap must stay below 2^16
    assert MAXM < (1 << 16), "MAXM breaks the packed-aux invariant"
    if P == 0:
        # stack depth ~ #distinct interval sizes along one extension
        # path, which grows with log4(genome); overflow lanes fall back
        # to the (much slower) scalar host path, so size generously
        P = 16 if didx.seq_len < (1 << 28) else 24
    npdt = didx.np_idt
    mpad = _pad_pow2(n)
    read = np.zeros(mpad, np.int32)
    x0 = np.full(mpad, (1 << 30), np.int32)   # pad lanes: x >= len
    mi = np.ones(mpad, npdt)
    osh = np.ones(mpad, bool)
    read[:n], x0[:n] = jobs[0], jobs[1]
    mi[:n] = jobs[2]
    osh[:n] = jobs[3]
    mem, aux = smem_cursor_machine(
        didx, qd, ld, jnp.asarray(read), jnp.asarray(x0),
        jnp.asarray(mi), jnp.asarray(osh), P, MAXM, int(min_seed_len),
        max_rounds=max_rounds)
    mem = np.asarray(mem).reshape(mpad, MAXM, 5)[:n]
    aux = np.asarray(aux)[:n]
    return mem, aux & 0xFFFF, (aux >> 30) != 0
