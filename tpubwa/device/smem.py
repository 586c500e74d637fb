"""Batched SMEM seeding on device (SURVEY.md §2 row 5).

Lockstep reformulation of bwt_smem1a's forward/backward protocol:
instead of per-read nested variable-length loops, we use the closed
characterisation of the SMEM set — with e(b) = the right-maximal reach
of an exact match starting at query position b,

    SMEMs = { [b, e(b)) : e(b) > b  and  (b == 0 or e(b-1) < e(b)) }

(e is monotone non-decreasing, so left-maximality of [b, e(b)) is
exactly e(b-1) < e(b)).  All starting positions of all reads extend in
LOCKSTEP — one batched bwt_extend (two fused occ-row gathers + masked
popcounts) per round over a flat job array.  No divergent control
flow; the while_loop runs entirely on device.

Round-2 re-seeding uses the same search constrained to cover the
midpoint x with interval size >= min_intv (bwt_smem1a(x, min_intv)
semantics); round-3 runs the forward-only bwt_seed_strategy1 scan as a
per-read lockstep state machine.

Equivalence to the scalar 3-round protocol (ref/smem.py) is pinned by
property tests (tests/test_device_smem.py).
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .occ import DeviceIndex, bwt_extend, set_intv

I64 = jnp.int64
I32 = jnp.int32


def _pad_pow2(n: int, lo: int = 256) -> int:
    m = lo
    while m < n:
        m <<= 1
    return m


@jax.jit
def _rightmost_reach_all(didx: DeviceIndex, q: jnp.ndarray,
                         lens: jnp.ndarray):
    """Round-1 form: one job per (read, start) — the job index arrays
    are pure arange/tile patterns, so they are built ON DEVICE instead
    of shipping B*L int32 triples from the host)."""
    B, L = q.shape
    read_idx = jnp.repeat(jnp.arange(B, dtype=I32), L)
    starts = jnp.tile(jnp.arange(L, dtype=I32), B)
    min_intv = jnp.ones(B * L, didx.idt)
    return _rightmost_reach(didx, q, lens, read_idx, starts, min_intv)


@jax.jit
def _rightmost_reach(didx: DeviceIndex, q: jnp.ndarray, lens: jnp.ndarray,
                     read_idx: jnp.ndarray, starts: jnp.ndarray,
                     min_intv: jnp.ndarray):
    """Lockstep right-maximal extension.

    q: int32 [B, L] read codes (4 = N/pad); lens: int32 [B]
    read_idx/starts/min_intv: per-job arrays [N] (a job = one search
    from q[read_idx, starts:] keeping interval size >= min_intv).

    Returns (ik [N,3] int64 final interval, e [N] int64 final end);
    jobs that fail immediately get e == start.
    """
    dt = didx.idt
    L = q.shape[1]
    b = starts.astype(dt)
    jl = lens[read_idx].astype(dt)

    def base_at(pos):
        p = jnp.clip(pos, 0, L - 1).astype(I32)
        return q[read_idx, p].astype(dt)  # q may be uint8 on the wire

    c0 = base_at(b)
    valid0 = (c0 <= 3) & (b < jl)
    ik0 = set_intv(didx, jnp.where(valid0, c0, 0))
    ok0 = valid0 & (ik0[:, 2] >= min_intv)
    e0 = jnp.where(ok0, b + 1, b)

    def cond(state):
        ik, e, active, t = state
        return jnp.any(active)

    def body(state):
        ik, e, active, t = state
        pos = b + t
        c = base_at(pos)
        can = active & (pos < jl) & (c <= 3)
        ok = bwt_extend(didx, ik, is_back=False)      # [N, 4, 3]
        comp = jnp.clip(3 - c, 0, 3)
        nik = jnp.take_along_axis(
            ok, jnp.broadcast_to(comp[:, None, None],
                                 (ik.shape[0], 1, 3)), axis=1)[:, 0]
        good = can & (nik[:, 2] >= min_intv)
        ik = jnp.where(good[:, None], nik, ik)
        e = jnp.where(good, b + t + 1, e)
        return ik, e, good, t + 1

    ik, e, _, _ = jax.lax.while_loop(
        cond, body, (ik0, e0, ok0, jnp.asarray(1, ik0.dtype)))
    return ik.reshape(-1), e


def _run_reach(didx, reads, lens, read_idx, starts, min_intv):
    """Pad job arrays to pow2 buckets (bounds jit retraces), run, trim."""
    n = len(read_idx)
    m = _pad_pow2(n)
    pad = m - n
    npdt = didx.np_idt
    ri = np.concatenate([read_idx, np.zeros(pad, np.int32)])
    st = np.concatenate([starts, np.zeros(pad, np.int32)])
    mi = np.concatenate([min_intv, np.full(pad, np.iinfo(npdt).max,
                                           npdt)]).astype(npdt)
    ik, e = _rightmost_reach(didx, jnp.asarray(reads),
                             jnp.asarray(lens), jnp.asarray(ri),
                             jnp.asarray(st), jnp.asarray(mi))
    ik = np.asarray(ik).reshape(m, 3)
    return ik[:n], np.asarray(e)[:n]


def smems_round1(didx: DeviceIndex, reads, lens,
                 min_seed_len: int, lens_np=None) -> List[np.ndarray]:
    """All SMEMs of every read (round 1).  Returns per-read
    [n, 5] int64 (x0, x1, size, qb, qe).  reads/lens may be device
    arrays; lens_np is the host copy for the per-read post loop (a
    device-array scalar read costs a device round trip)."""
    B, L = reads.shape
    if lens_np is None:
        lens_np = np.asarray(lens)
    ik, e = _rightmost_reach_all(didx, jnp.asarray(reads),
                                 jnp.asarray(lens))
    ik = np.asarray(ik).reshape(B, L, 3)
    e = np.asarray(e).reshape(B, L)  # flat on the wire
    out = []
    for i in range(B):
        li = int(lens_np[i])
        ei = e[i, :li]
        starts_i = np.arange(li)
        is_smem = ei > starts_i
        if li > 1:
            is_smem[1:] &= ei[:-1] < ei[1:]
        is_smem &= (ei - starts_i) >= min_seed_len
        idx = np.flatnonzero(is_smem)
        out.append(np.concatenate(
            [ik[i, idx], starts_i[idx, None], ei[idx, None]],
            axis=1).astype(np.int64))
    return out


def smems_reseed(didx: DeviceIndex, reads: np.ndarray, lens: np.ndarray,
                 jobs: List[Tuple[int, int, int]], min_seed_len: int):
    """Round-2 re-seeding: jobs = [(read_idx, x, min_intv)] -> list of
    (read_idx, rows[n,5]) — maximal matches covering x with interval
    size >= min_intv (bwt_smem1a(x, min_intv) semantics)."""
    if not jobs:
        return []
    read_idx, starts, min_intv, meta = [], [], [], []
    for (ri, x, mi) in jobs:
        nb = x + 1                      # candidate starts b = 0..x
        read_idx.append(np.full(nb, ri, np.int32))
        starts.append(np.arange(nb, dtype=np.int32))
        min_intv.append(np.full(nb, mi, didx.np_idt))
        meta.append((ri, x, nb))
    ik, e = _run_reach(didx, reads, lens, np.concatenate(read_idx),
                       np.concatenate(starts), np.concatenate(min_intv))
    out = []
    off = 0
    for (ri, x, nb) in meta:
        ei = e[off:off + nb]
        iki = ik[off:off + nb]
        off += nb
        starts_i = np.arange(nb)
        valid = ei >= x + 1             # must cover x
        is_smem = valid & (ei > starts_i)
        if nb > 1:
            is_smem[1:] &= (~valid[:-1]) | (ei[:-1] < ei[1:])
        is_smem &= (ei - starts_i) >= min_seed_len
        idx = np.flatnonzero(is_smem)
        out.append((ri, np.concatenate(
            [iki[idx], starts_i[idx, None], ei[idx, None]],
            axis=1).astype(np.int64)))
    return out


@partial(jax.jit, static_argnames=("min_len", "max_intv", "scapf",
                                   "max_occ"))
def _seed_strategy_scan(didx: DeviceIndex, q: jnp.ndarray,
                        lens: jnp.ndarray, min_len: int, max_intv: int,
                        scapf: int = 0, max_occ: int = 500):
    """Round 3: lockstep bwt_seed_strategy1 (bwt.c:~490) over all reads.
    Returns a flat buffer: hits [B, MAXH, 5] | n_hits [B] and, when
    scapf > 0, the fused SA positions of the hit rows [scapf * B]
    (same protocol + suffix-spill rule as smem_fused._sa_from_rows;
    the host mirrors with smem_fused._sa_segments)."""
    dt = didx.idt
    B, L = q.shape
    MAXH = L // max(int(min_len), 1) + 1
    lj = lens.astype(dt)
    min_len_j = jnp.asarray(min_len, dt)
    max_intv_j = jnp.asarray(max_intv, dt)

    def cond(state):
        x, i, ik, mode, hits, nh = state
        return jnp.any(x < lj)

    def body(state):
        x, i, ik, mode, hits, nh = state
        active = x < lj
        # restart lane (mode 0): inspect q[x]
        cx = q[jnp.arange(B), jnp.clip(x, 0, L - 1).astype(I32)].astype(dt)
        restart = active & (mode == 0)
        amb0 = restart & (cx > 3)
        start_ok = restart & (cx <= 3)
        ik = jnp.where(start_ok[:, None],
                       set_intv(didx, jnp.where(cx <= 3, cx, 0)), ik)
        i = jnp.where(start_ok, x + 1, i)
        mode = jnp.where(start_ok, 1, mode)
        x = jnp.where(amb0, x + 1, x)
        # scan lane (mode 1): inspect q[i]
        scanning = active & (mode == 1)
        at_end = scanning & (i >= lj)
        ci = q[jnp.arange(B), jnp.clip(i, 0, L - 1).astype(I32)].astype(dt)
        amb = scanning & ~at_end & (ci > 3)
        step = scanning & ~at_end & (ci <= 3)
        ok = bwt_extend(didx, ik, is_back=False)
        comp = jnp.clip(3 - ci, 0, 3)
        nik = jnp.take_along_axis(
            ok, jnp.broadcast_to(comp[:, None, None], (B, 1, 3)),
            axis=1)[:, 0]
        # upstream: restart whenever size < max_intv AND len >= min_len,
        # but only PUSH the hit when its interval is non-empty
        qualify = step & (nik[:, 2] < max_intv_j) & (i - x >= min_len_j)
        emit = qualify & (nik[:, 2] > 0)
        row = jnp.concatenate([nik, x[:, None], (i + 1)[:, None]], axis=1)
        slot_mask = (jnp.arange(MAXH, dtype=dt)[None, :]
                     == jnp.clip(nh, 0, MAXH - 1)[:, None])
        upd = emit[:, None] & slot_mask                  # [B, MAXH]
        hits = jnp.where(upd[:, :, None], row[:, None, :], hits)
        nh = nh + emit.astype(dt)
        # transitions (amb terminates the scan and restarts at i+1)
        x = jnp.where(qualify | amb, i + 1, x)
        x = jnp.where(at_end, lj, x)
        mode = jnp.where(qualify | amb | at_end, 0, mode)
        ik = jnp.where((step & ~qualify)[:, None], nik, ik)
        i = jnp.where(step, i + 1, i)
        return x, i, ik, mode, hits, nh

    state = (jnp.zeros(B, dt), jnp.zeros(B, dt), jnp.zeros((B, 3), dt),
             jnp.zeros(B, dt), jnp.zeros((B, MAXH, 5), dt),
             jnp.zeros(B, dt))
    x, i, ik, mode, hits, nh = jax.lax.while_loop(cond, body, state)
    # one flat buffer (hits then nh): each extra D2H costs ~40 ms RTT
    parts = [hits.reshape(-1), nh.astype(hits.dtype)]
    if scapf > 0:
        from .smem_fused import _sa_from_rows
        valid = (jnp.arange(MAXH, dtype=dt)[None, :]
                 < nh[:, None]).reshape(-1)
        parts.append(_sa_from_rows(didx, hits.reshape(-1, 5), valid,
                                   max_occ, scapf * B).astype(dt))
    return jnp.concatenate(parts)


def _rounds12_cursor(opt, didx, qd, ld, lens_np, reads, split_len, fmi):
    """Rounds 1-2 via the cursor machine.  Returns flat (rows [n, 5]
    int64, read_ids [n]) for both rounds combined, unsorted — the
    caller's global merge lexsorts once for the whole chunk.  All post
    logic is vectorized; only overflow lanes (rare) loop in Python."""
    from .smem_cursor import run_smem_jobs
    B = len(lens_np)
    npdt = didx.np_idt
    mem, mem_n, ovf = run_smem_jobs(
        didx, qd, ld,
        (np.arange(B, dtype=np.int32), np.zeros(B, np.int32),
         np.ones(B, npdt), np.zeros(B, bool)), opt.min_seed_len)
    MAXM = mem.shape[1]
    valid = (np.arange(MAXM)[None, :] < mem_n[:, None]) & ~ovf[:, None]
    vm = valid.reshape(-1)
    flat = mem.reshape(-1, 5)[vm].astype(np.int64)
    frid = np.repeat(np.arange(B), MAXM)[vm]
    blocks = [flat]
    rids = [frid]
    for ri in np.flatnonzero(ovf):
        rows = _scalar_round1(opt, fmi, reads[ri], int(lens_np[ri]),
                              didx=didx)
        blocks.append(rows)
        rids.append(np.full(len(rows), ri, np.int64))
    r1_rows = np.concatenate(blocks) if len(blocks) > 1 else flat
    r1_rids = np.concatenate(rids) if len(rids) > 1 else frid
    # round-2 job selection, vectorized (the job SET is order-free:
    # results are re-sorted globally by the caller)
    jsel = ((r1_rows[:, 4] - r1_rows[:, 3] >= split_len)
            & (r1_rows[:, 2] <= opt.split_width))
    job_rid = r1_rids[jsel].astype(np.int32)
    job_x = ((r1_rows[jsel, 3] + r1_rows[jsel, 4]) >> 1).astype(np.int32)
    job_mi = (r1_rows[jsel, 2] + 1).astype(npdt)
    if not len(job_rid):
        return r1_rows, r1_rids
    mem2, mem2_n, ovf2 = run_smem_jobs(
        didx, qd, ld,
        (job_rid, job_x, job_mi, np.ones(len(job_rid), bool)),
        opt.min_seed_len)
    valid2 = (np.arange(MAXM)[None, :] < mem2_n[:, None]) \
        & ~ovf2[:, None]
    vm2 = valid2.reshape(-1)
    flat2 = mem2.reshape(-1, 5)[vm2].astype(np.int64)
    frid2 = np.repeat(job_rid.astype(np.int64), MAXM)[vm2]
    blocks = [r1_rows, flat2]
    rids = [r1_rids, frid2]
    for k in np.flatnonzero(ovf2):
        rows = _scalar_reseed(opt, fmi, reads[int(job_rid[k])],
                              int(lens_np[int(job_rid[k])]),
                              int(job_x[k]), int(job_mi[k]), didx=didx)
        blocks.append(rows)
        rids.append(np.full(len(rows), int(job_rid[k]), np.int64))
    return np.concatenate(blocks), np.concatenate(rids)


def _scalar_round1(opt, fmi, read_row, l_seq, didx=None):
    """Host fallback for a cursor-machine overflow lane (round 1).
    Without a host FMIndex the lane degrades to the device reach path
    (slow but correct) instead of crashing (ADVICE round-1 item 1)."""
    from ..ref.smem import smem1a
    if fmi is None:
        if didx is None:
            raise RuntimeError(
                "cursor overflow needs a host FMIndex or a DeviceIndex")
        arr = np.ascontiguousarray(
            np.asarray(read_row)[None, :], dtype=np.uint8)
        lens = np.asarray([l_seq], np.int32)
        rows = smems_round1(didx, arr, lens, opt.min_seed_len,
                            lens_np=lens)[0]
        order = np.lexsort((rows[:, 4], rows[:, 3]))
        return rows[order]
    q = np.asarray(read_row[:l_seq])
    mems, tmp = [], []
    x = 0
    while x < l_seq:
        if q[x] < 4:
            x = smem1a(fmi, q, x, 1, 0, tmp)
            for p in tmp:
                if p.qe - p.qb >= opt.min_seed_len:
                    mems.append((p.x0, p.x1, p.size, p.qb, p.qe))
        else:
            x += 1
    rows = np.asarray(mems, np.int64).reshape(-1, 5)
    order = np.lexsort((rows[:, 4], rows[:, 3]))
    return rows[order]


def _scalar_reseed(opt, fmi, read_row, l_seq, x, min_intv, didx=None):
    """Host fallback for an overflowed round-2 lane.  Degrades to the
    device reach path when no host FMIndex is available."""
    from ..ref.smem import smem1a
    if fmi is None:
        if didx is None:
            raise RuntimeError(
                "cursor overflow needs a host FMIndex or a DeviceIndex")
        arr = np.ascontiguousarray(
            np.asarray(read_row)[None, :], dtype=np.uint8)
        lens = np.asarray([l_seq], np.int32)
        out = smems_reseed(didx, arr, lens,
                           [(0, int(x), int(min_intv))],
                           opt.min_seed_len)
        return out[0][1]
    q = np.asarray(read_row[:l_seq])
    tmp = []
    smem1a(fmi, q, x, min_intv, 0, tmp)
    return np.asarray(
        [(p.x0, p.x1, p.size, p.qb, p.qe) for p in tmp
         if p.qe - p.qb >= opt.min_seed_len],
        np.int64).reshape(-1, 5)


def _permute_segments(cnt, pos, order):
    """Reorder per-row position segments by a row permutation.
    cnt [R] (-1 = no device segment), pos = concatenated segments in
    pre-permutation row order.  Returns (cnt[order], pos reordered)."""
    from .smem_split import _row_offsets
    cntc = np.maximum(cnt, 0)
    off = np.zeros(len(cnt) + 1, np.int64)
    np.cumsum(cntc, out=off[1:])
    c2 = cnt[order]
    c2c = np.maximum(c2, 0)
    sel = np.repeat(off[:-1][order], c2c) + _row_offsets(c2c)
    return c2, pos[sel]


def _package_rows(flat, frid, sa, B, reads, put_repl,
                  return_flat, return_qd, return_sa):
    """The collect_intv_device return contract, shared by the host and
    hybrid early-exit paths (rows already in (rid, qb, qe) order)."""
    if return_flat:
        qd = None
        if return_qd:
            if put_repl is None:
                put_repl = jnp.asarray
            qd = put_repl(np.ascontiguousarray(reads, dtype=np.uint8))
        if return_sa:
            return (flat, frid, qd, sa) if return_qd else \
                (flat, frid, sa)
        return (flat, frid, qd) if return_qd else (flat, frid)
    counts = np.bincount(frid, minlength=B)
    return np.split(flat, np.cumsum(counts)[:-1])


_HYBRID_STATE: dict = {}


def collect_intv_device(opt, didx: DeviceIndex, reads: np.ndarray,
                        lens: np.ndarray, fmi=None,
                        use_cursor: bool = True,
                        mode: str = None,
                        put_sharded=None,
                        put_repl=None,
                        return_flat: bool = False,
                        return_qd: bool = False,
                        return_sa: bool = False,
                        tp=None, stats: dict = None) -> List[np.ndarray]:
    """Full 3-round mem_collect_intv for a batch, device-accelerated.
    Returns per-read [n, 5] int64 (x0, x1, size, qb, qe) sorted by
    (qb, qe) — the contract of ref.smem.collect_intv.

    use_cursor: run rounds 1-2 on the lockstep bwt_smem1a cursor
    machine (smem_cursor.py, ~10x less BWT work than the all-starts
    reach); lanes that overflow its stack/emission caps fall back to
    the scalar reference (needs ``fmi``).  Without an ``fmi`` the
    overflow fallback is unavailable, so the call degrades to the
    all-starts reach path instead of crashing on repetitive input.

    mode: 'host' (native C++ scalar seeding on the host core, zero
    seeding dispatches — host/native_smem.py; the device keeps
    extension/SA), 'hybrid' (TPUBWA_HYBRID_DEV_FRAC of the chunk on
    the megaq machine overlapped with native host seeding of the
    rest), 'megaq' (two-round single-dispatch machine with
    QUEUE-scheduled backward phases —
    smem_fused.py:smem_chunk_machine_q),
    'mega' (default; rounds 1+2 in ONE dispatch with on-device
    round-2 job construction — smem_fused.py:smem_chunk_machine),
    'fused' (one dispatch per seeding round), 'split' (phase-split
    fwd/bwd machines — smem_split.py), 'cursor' (combined machine),
    'reach' (all-starts formulation).  TPUBWA_SEED_MODE overrides.

    stats: optional dict; ``stats["dev_reads"]`` is incremented by the
    number of reads handed to a device seeding machine (its overflow
    lanes are redone on the host)."""
    import os
    if mode is None:
        # megaq default: 2.9x fewer backward rounds, no per-chunk deep
        # tail, SA fused into the dispatch (scripts/exp_rounds_cpu.py)
        mode = os.environ.get("TPUBWA_SEED_MODE",
                              "megaq" if use_cursor else "reach")
    if fmi is None and mode in ("host", "hybrid"):
        # host-side native seeding needs the host FMIndex; the machine
        # modes work without one (overflow lanes degrade to the device
        # reach path instead of raising)
        mode = "megaq"
    use_cursor = mode != "reach"
    B, L = reads.shape
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    if mode == "host":
        # host seeding mode: the native C++ scalar runs the full
        # 3-round protocol on the host core while the device keeps
        # extension; zero seeding dispatches.  SA is left to the
        # caller (sa=None -> classic SA stage).
        from ..host.native_smem import smem_collect_batch_native
        rows6 = smem_collect_batch_native(opt, fmi, reads, lens)
        if rows6 is not None:
            flat = rows6[:, :5]
            frid = rows6[:, 5]
            # rid-major with per-read (qb, qe) sort == the global
            # lexsort contract; SA left to the caller (sa=None ->
            # native/classic SA stage)
            return _package_rows(flat, frid, None, B, reads, put_repl,
                                 return_flat, return_qd, return_sa)
        mode = "megaq"  # native unavailable: device path
    if mode == "hybrid":
        # split the chunk: the device machine seeds the first
        # TPUBWA_HYBRID_DEV_FRAC of reads (dispatched from a worker
        # thread so its device syncs overlap) while THIS thread seeds
        # the rest in native C++ (ctypes releases the GIL) — both
        # resources busy, wall = max(device share, host share).  The
        # balancer below moves the share toward equal walls.
        frac = float(os.environ.get("TPUBWA_HYBRID_DEV_FRAC", 0.25))
        auto = os.environ.get("TPUBWA_HYBRID_AUTO", "1") != "0"
        # device-share floor: below this many reads a machine dispatch
        # costs more than it saves, so hybrid degrades to host mode.
        # Tests lower it to exercise the device/host merge seam with
        # small chunks (production chunks are 8192 reads, k=2048).
        k_floor = max(1, int(os.environ.get("TPUBWA_HYBRID_K_FLOOR",
                                            "64")))
        st = getattr(didx, "_hybrid_state", None)
        if st is None:
            st = {"f": frac}
            try:
                object.__setattr__(didx, "_hybrid_state", st)
            except Exception:   # frozen/slots: bounded id-keyed dict
                st = _HYBRID_STATE.setdefault(id(didx), st)
        if auto:
            frac = st["f"]
            if st.get("chunks", 0) < st.get("host_until", -1):
                # sticky degrade window set by the balancer below:
                # the device share measured far slower than native on
                # this corpus, so the WHOLE chunk goes to host mode;
                # after the window the split is re-probed (cheap: the
                # probe share is near the floor bucket)
                st["chunks"] = st.get("chunks", 0) + 1
                return collect_intv_device(
                    opt, didx, reads, lens, fmi=fmi, mode="host",
                    put_sharded=put_sharded, put_repl=put_repl,
                    return_flat=return_flat, return_qd=return_qd,
                    return_sa=return_sa, stats=stats)
        k = int(B * frac)
        # quantize the ADAPTIVE device share to a pow2 bucket: the
        # megaq machine's lane count is shape-relevant, so a
        # continuously adapting k makes every chunk a NEW XLA compile.
        # Buckets bound the distinct machine shapes to ~3 per run; the
        # balancer then moves between buckets only when the equal-wall
        # split crosses a boundary.  A pinned split (AUTO=0) keeps the
        # exact k — it is constant across chunks, so it compiles once.
        if auto and k >= k_floor:
            b = k_floor
            while b * 2 <= k:
                b <<= 1
            # round to nearer of b / 2b (in log space: 1.5x midpoint)
            k = b * 2 if k > b + (b >> 1) and b * 2 <= B else b
        from ..host.native_smem import (sa_positions_native,
                                        smem_collect_batch_native)
        if k < k_floor or smem_collect_batch_native(
                opt, fmi, reads[:0], lens[:0]) is None:
            mode = "host" if k < k_floor else "megaq"
            return collect_intv_device(
                opt, didx, reads, lens, fmi=fmi, mode=mode,
                put_sharded=put_sharded, put_repl=put_repl,
                return_flat=return_flat, return_qd=return_qd,
                return_sa=return_sa, stats=stats)
        from concurrent.futures import ThreadPoolExecutor
        import time as _time
        dev_wall = [0.0]

        def _dev_share():
            # timed INSIDE the worker: fut.result() is only observed
            # after the host share finishes, which would make the
            # measured device wall >= the host wall and the balancer
            # monotone-shrinking
            t = _time.perf_counter()
            r = collect_intv_device(
                opt, didx, reads[:k], lens[:k], fmi=fmi, mode="megaq",
                put_sharded=put_sharded, put_repl=put_repl,
                return_flat=True, return_sa=return_sa, stats=stats)
            dev_wall[0] = _time.perf_counter() - t
            return r
        with ThreadPoolExecutor(1) as ex:
            t0 = _time.perf_counter()
            fut = ex.submit(_dev_share)
            host6 = smem_collect_batch_native(opt, fmi, reads[k:],
                                              lens[k:])
            host_sa = None
            if return_sa and host6 is not None and len(host6):
                host_sa = sa_positions_native(
                    fmi, host6[:, :5], int(opt.max_occ),
                    threads=getattr(opt, "n_threads", 1))
            t_host = _time.perf_counter() - t0
            dev = fut.result()
            t_dev = dev_wall[0]
        if auto and t_host > 1e-4 and t_dev > 1e-4:
            seen = st.setdefault("seen", set())
            if k not in seen:
                # first chunk AT THIS BUCKET pays the machine compiles;
                # folding that wall into rate_d makes the balancer
                # shrink the share, which lands on a NEW bucket, which
                # compiles again — a death spiral of ever-smaller
                # buckets, each paying its own compile.
                seen.add(k)
            else:
                # equal-wall split: f* / rate_d == (1 - f*) / rate_h
                rate_d = k / t_dev             # reads/s device share
                rate_h = (B - k) / t_host      # reads/s host share
                f_star = rate_d / (rate_d + rate_h)
                f_new = 0.5 * st["f"] + 0.5 * f_star   # damped
                # degrade, don't clamp: on repeat-heavy corpora the
                # machine share can run far slower than native
                # (overflow lanes + fixed dispatch cost), so a fixed
                # floor would force every chunk's wall to the slow
                # side.  Below half the old floor the
                # balancer hands the WHOLE chunk to host mode; sticky,
                # revisited every 16 chunks in case the read mix shifts
                st["f"] = float(min(max(f_new, 0.02), 0.85))
                if f_star < 0.08:
                    st["host_until"] = st.get("chunks", 0) + 16
        if auto:
            st["chunks"] = st.get("chunks", 0) + 1
        if return_sa:
            dflat, dfrid, dsa = dev
        else:
            dflat, dfrid = dev
        flat = np.concatenate([dflat, host6[:, :5]])
        frid = np.concatenate([dfrid, host6[:, 5] + k])
        sa = None
        if return_sa:
            hcnt = np.full(len(host6), -1, np.int64)
            hpos = np.zeros(0, np.int64)
            if host_sa is not None:
                hpos, hcnt = host_sa[0], host_sa[1]
            if dsa is not None:
                sa = (np.concatenate([dsa[0], hcnt]),
                      np.concatenate([dsa[1], hpos]))
            else:
                sa = (np.concatenate(
                    [np.full(len(dflat), -1, np.int64), hcnt]),
                    hpos)
        return _package_rows(flat, frid, sa, B, reads, put_repl,
                             return_flat, return_qd, return_sa)
    # one H2D of the chunk's codes (uint8), reused by all three rounds
    lens_np = np.asarray(lens, np.int32)
    if stats is not None:        # pad rows have length 0
        stats["dev_reads"] = (stats.get("dev_reads", 0)
                              + int(np.count_nonzero(lens_np)))
    if put_repl is None:
        put_repl = jnp.asarray
    if put_sharded is None:
        put_sharded = jnp.asarray
    # qd/ld replicated: the bwd machine's job lanes gather rows across
    # the whole chunk, so the read array cannot be sharded
    qd = put_repl(np.ascontiguousarray(reads, dtype=np.uint8))
    ld = put_repl(lens_np)
    # round 3 is independent of rounds 1-2: dispatch it FIRST so its
    # result is already on host by the time we sync on it
    scan_fut = None
    import os as _os
    scan_scapf = 0
    if mode == "megaq" and not _os.environ.get("TPUBWA_NO_SA_FUSE"):
        # round-3 rows would otherwise be the only per-chunk rows
        # still needing a host-built SA dispatch (smem_fused fuses
        # rounds 1-2's) — fuse theirs into the scan program too
        scan_scapf = int(_os.environ.get("TPUBWA_SA_CAPF", 16))
    if opt.max_mem_intv > 0:
        scan_fut = _seed_strategy_scan(didx, qd, ld,
                                       int(opt.min_seed_len),
                                       int(opt.max_mem_intv),
                                       scapf=scan_scapf,
                                       max_occ=int(opt.max_occ))
    blocks = []
    rids = []
    sa_cnt12 = sa_pos12 = None
    if use_cursor:
        if mode == "megaq":
            from .smem_fused import rounds12_megaq
            (rows12, rids12, sa_cnt12,
             sa_pos12) = rounds12_megaq(opt, didx, qd, ld, lens_np,
                                        reads, split_len, fmi,
                                        put=put_sharded, tp=tp)
        elif mode == "mega":
            from .smem_fused import rounds12_mega
            rows12, rids12 = rounds12_mega(opt, didx, qd, ld, lens_np,
                                           reads, split_len, fmi,
                                           put=put_sharded)
        elif mode == "fused":
            from .smem_fused import rounds12_fused
            rows12, rids12 = rounds12_fused(opt, didx, qd, ld, lens_np,
                                            reads, split_len, fmi,
                                            put=put_sharded)
        elif mode == "split":
            from .smem_split import rounds12_split
            rows12, rids12 = rounds12_split(opt, didx, qd, ld, lens_np,
                                            reads, split_len, fmi,
                                            put=put_sharded)
        else:
            rows12, rids12 = _rounds12_cursor(opt, didx, qd, ld,
                                              lens_np, reads,
                                              split_len, fmi)
        blocks.append(rows12)
        rids.append(rids12)
    else:
        r1 = smems_round1(didx, qd, ld, opt.min_seed_len,
                          lens_np=lens_np)
        jobs = []
        for ri in range(B):
            for row in r1[ri]:
                x0, x1, size, qb, qe = (int(v) for v in row)
                if qe - qb < split_len or size > opt.split_width:
                    continue
                jobs.append((ri, (qb + qe) >> 1, size + 1))
        r2 = smems_reseed(didx, qd, ld, jobs, opt.min_seed_len)
        for ri in range(B):
            if len(r1[ri]):
                blocks.append(np.asarray(r1[ri], np.int64))
                rids.append(np.full(len(r1[ri]), ri, np.int64))
        for ri, rows in r2:
            if len(rows):
                blocks.append(np.asarray(rows, np.int64))
                rids.append(np.full(len(rows), ri, np.int64))
    # global merge: concatenate (rid, row) blocks from all three
    # rounds, ONE lexsort by (rid, qb, qe), split per read
    scan_sa = None
    if scan_fut is not None:
        buf = np.asarray(scan_fut)
        scap3 = scan_scapf * B
        sa_tail = buf[len(buf) - scap3:] if scap3 else None
        if scap3:
            buf = buf[:len(buf) - scap3]
        hits = buf[:-B].reshape(B, -1, 5)
        nh = buf[-B:]
        MAXH = hits.shape[1]
        hv = np.arange(MAXH)[None, :] < nh[:, None]
        if hv.any():
            rows3 = hits.reshape(-1, 5)[hv.reshape(-1)].astype(np.int64)
            blocks.append(rows3)
            rids.append(np.repeat(np.arange(B), MAXH)[hv.reshape(-1)]
                        .astype(np.int64))
            if scap3:
                # host mirror of the device segments (valid rows in
                # flatten order == rows3 order)
                from .smem_fused import _sa_segments
                from .smem_split import _row_offsets
                cnt3, starts3 = _sa_segments(rows3, sa_tail, scap3,
                                             int(opt.max_occ))
                c3 = np.maximum(cnt3, 0)
                sel = np.repeat(starts3, c3) + _row_offsets(c3)
                scan_sa = (cnt3, sa_tail.astype(np.int64)[sel])
    if not blocks:
        empty = np.zeros((0, 5), np.int64), np.zeros(0, np.int64)
        if return_flat:
            if return_sa:
                sa = (np.zeros(0, np.int64), np.zeros(0, np.int64)) \
                    if sa_cnt12 is not None else None
                return ((*empty, qd, sa) if return_qd
                        else (*empty, sa))
            return (*empty, qd) if return_qd else empty
        return [np.zeros((0, 5), np.int64) for _ in range(B)]
    flat = np.concatenate(blocks)
    frid = np.concatenate(rids)
    order = np.lexsort((flat[:, 4], flat[:, 3], frid))
    flat = flat[order]
    frid = frid[order]
    if return_flat:
        # pipeline fast path: the native chain/plan ABI and the SA
        # stage consume flat rows + read ids directly — no per-read
        # view lists on the single host core (return_qd: hand back the
        # device-resident read array so extension reuses the upload)
        if return_sa:
            sa = None
            if sa_cnt12 is not None:
                # scalar-path rows carry cnt -1: the SA stage computes
                # those host-side; rounds 1-2 and (when fused) round-3
                # rows bring device positions
                cnt_all = np.full(len(flat), -1, np.int64)
                cnt_all[:len(sa_cnt12)] = sa_cnt12
                pos_all = sa_pos12
                if scan_sa is not None:
                    cnt_all[len(cnt_all) - len(scan_sa[0]):] = \
                        scan_sa[0]
                    pos_all = np.concatenate([sa_pos12, scan_sa[1]])
                sa = (*_permute_segments(cnt_all, pos_all, order),)
            return ((flat, frid, qd, sa) if return_qd
                    else (flat, frid, sa))
        return (flat, frid, qd) if return_qd else (flat, frid)
    counts = np.bincount(frid, minlength=B)
    return np.split(flat, np.cumsum(counts)[:-1])
