"""Batched seed extension on device (ksw.c:ksw_extend2 semantics,
SURVEY.md §2 rows 9-10,17).

A job = one (query-slice, ref-slice, h0, w, pen) extension task; the
dispatch layer collects thousands across a read batch (the QuickAssist
batching idea) and this module runs them all in one device program.

``extend_batch`` is the reference path for any scoring matrix: jobs
vectorized across the batch axis, target rows iterated with
lax.fori_loop over the full target width, the F-gap scan computed as a
prefix max (closed form, see ref/ksw.py), adaptive band trimming and
Z-drop reproduced exactly with per-job scalar state.

``extend_rows`` is the production row loop for bwa_fill_scmat-shaped
matrices (match=a, mismatch=-b, N=-1): the same recurrence with the
score profile computed arithmetically instead of a 5x5 gather, and a
lax.while_loop that stops once every job is dead or the batch's
longest target is consumed.

Bit-exactness contract (tests/test_device_extend.py,
tests/test_extend_plain.py): (score, qle, tle, gtle, gscore, max_off)
identical to ref.ksw.ksw_extend for every job, including tie-breaking
and early-exit timing.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
NEG = -(1 << 29)
LANES = 512          # widest lane bucket -> qlen <= LANES - 1 (510 bp reads)


def width_for(max_qlen: int) -> int:
    """DP lane-width bucket (pow2; 128 covers 100 bp reads)."""
    for w in (128, 256, LANES):
        if max_qlen < w:
            return w
    return LANES


def _mat_ab(mat):
    """Extract (a, b) from a bwa_fill_scmat-structured matrix; None if
    the matrix doesn't have that structure."""
    mat = np.asarray(mat)
    a = int(mat[0, 0])
    b = -int(mat[0, 1])
    ok = True
    for i in range(4):
        for j in range(4):
            ok &= int(mat[i, j]) == (a if i == j else -b)
    ok &= np.all(mat[4, :] == -1) and np.all(mat[:, 4] == -1)
    return (a, b) if ok else None


@partial(jax.jit, static_argnames=("a", "b", "o_del", "e_del", "o_ins",
                                   "e_ins", "zdrop"))
def extend_rows(q, t, qlen, tlen, h0, w, end_bonus, a, b, o_del, e_del,
                o_ins, e_ins, zdrop):
    """Run N ksw_extend jobs in lockstep under a scmat scoring matrix.

    q: int32 [N, W] query codes (qlen <= W - 1); t: int32 [N, T]
    target codes; qlen/tlen/h0/w/end_bonus: int32 [N] (h0 > 0).
    Returns int32 [N, 6]: score, qle, tle, gtle, gscore, max_off.

    The DP state is the shifted eh arrays of ksw_extend as [N, W]
    rows, one query cell per lane; per-job scalars are [N, 1] columns.
    """
    N, W = q.shape
    T = t.shape[1]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    lane = jnp.arange(W, dtype=I32)[None, :]
    qlen, tlen, h0, w_in, ebon = (x.astype(I32)[:, None] for x in
                                  (qlen, tlen, h0, w, end_bonus))
    qpad = jnp.where(lane < qlen, q, 4)
    tT = t.T                       # row i of the target is contiguous
    # band cap (w = min(w, max_ins, max_del); mat max = a)
    max_ins = jnp.maximum((qlen * a + ebon - o_ins) // e_ins + 1, 1)
    max_del = jnp.maximum((qlen * a + ebon - o_del) // e_del + 1, 1)
    ww = jnp.minimum(jnp.minimum(w_in, max_ins), max_del)

    # first row of the shifted eh arrays: eh_h[j] = H(-1, j-1)
    ramp = h0 - oe_ins - (lane - 1) * e_ins
    eh_h = jnp.where(lane == 0, h0, jnp.maximum(ramp, 0))
    eh_h = jnp.where(lane <= qlen, eh_h, 0)
    eh_e = jnp.zeros((N, W), I32)
    n_rows = jnp.minimum(jnp.max(tlen), T)

    def shift1(x):
        # x[j-1] at lane j; lane 0 is masked by every caller
        return jnp.roll(x, 1, axis=1)

    def cond(c):
        i, dead = c[0], c[-1]
        return (i < n_rows) & ~jnp.all(dead)

    def body(c):
        (i, eh_h, eh_e, beg, end, best, max_i, max_j, max_ie, gscore,
         max_off, dead) = c
        act = ~dead & (i < tlen)                              # [N, 1]
        beg_i = jnp.maximum(beg, i - ww)
        end_i = jnp.minimum(jnp.minimum(end, i + ww + 1), qlen)
        closed = beg_i >= end_i
        h1_first = jnp.where(
            beg_i == 0, jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0), 0)
        tb = jax.lax.dynamic_index_in_dim(
            tT, jnp.clip(i, 0, T - 1), axis=0, keepdims=False)[:, None]
        # score profile: match=a, mismatch=-b, N(either side)=-1
        prof = jnp.where((tb > 3) | (qpad > 3), -1,
                         jnp.where(tb == qpad, a, -b))
        in_band = (lane >= beg_i) & (lane < end_i)
        M = jnp.where(eh_h != 0, eh_h + prof, 0)
        M = jnp.where(in_band, M, NEG)
        E = jnp.where(in_band, eh_e, NEG)
        he = jnp.maximum(M, E)
        # F prefix-max scan (F[beg]=0; see ref/ksw.py derivation)
        t_ins = jnp.where(in_band, jnp.maximum(M - oe_ins, 0), NEG)
        pm = jax.lax.cummax(t_ins + lane * e_ins, axis=1)
        F = jnp.where(lane >= 1, shift1(pm) - (lane - 1) * e_ins, NEG)
        F = jnp.where(lane == beg_i, 0, F)
        H = jnp.maximum(he, F)
        H = jnp.where(in_band, jnp.maximum(H, 0), 0)
        t_del = jnp.maximum(M - oe_del, 0)
        Enew = jnp.maximum(eh_e - e_del, t_del)
        # write-backs (only for active, open-band jobs)
        upd = act & ~closed
        wm_h = (lane > beg_i) & (lane <= end_i)
        eh_h = jnp.where(upd & wm_h, shift1(H), eh_h)
        eh_h = jnp.where(upd & (lane == beg_i), h1_first, eh_h)
        eh_e = jnp.where(upd & in_band, Enew, eh_e)
        eh_e = jnp.where(upd & (lane == end_i), 0, eh_e)
        # closed-band lane: upstream writes eh[end]=h1, eh_e[end]=0,
        # takes the gscore update, then breaks on m==0
        cl = act & closed
        eh_h = jnp.where(cl & (lane == end_i), h1_first, eh_h)
        eh_e = jnp.where(cl & (lane == end_i), 0, eh_e)
        # row max and its argmax in one reduction: max over H*W+lane;
        # ties take the larger lane, upstream's `mj = m > h1 ? mj : j`
        # last-wins rule.  Needs H*W < 2^31: scores are bounded by
        # h0 + qlen*a <= ~2*511*a, far below 2^22 for any sane a.
        pk = jnp.max(jnp.where(in_band, H * W + lane, NEG), axis=1,
                     keepdims=True)
        m = jnp.maximum(pk >> (W.bit_length() - 1), 0)
        mj = pk & (W - 1)          # garbage when empty; gated on m > 0
        h_open = jnp.take_along_axis(H, jnp.clip(end_i - 1, 0, W - 1),
                                     axis=1)
        h_last = jnp.where(closed, h1_first, h_open)
        at_qend = act & (end_i == qlen) & (h_last >= gscore)
        max_ie = jnp.where(at_qend, i, max_ie)
        gscore = jnp.where(at_qend, h_last, gscore)
        dead = dead | (act & (closed | (m == 0)))
        alive = act & ~closed & (m != 0)
        better = alive & (m > best)
        max_off = jnp.where(better, jnp.maximum(max_off, jnp.abs(mj - i)),
                            max_off)
        if zdrop > 0:
            di = i - max_i
            dj = mj - max_j
            dd = jnp.where(di > dj, (di - dj) * e_del, (dj - di) * e_ins)
            dead = dead | (alive & ~better & (best - m - dd > zdrop))
        best = jnp.where(better, m, best)
        max_i = jnp.where(better, i, max_i)
        max_j = jnp.where(better, mj, max_j)
        # adaptive band trim on the updated arrays.  Upstream scans
        # [beg_n, end_i] for the last nonzero, but lanes in
        # [beg_i, beg_n) are zero by beg_n's definition, so scanning
        # [beg_i, end_i] finds the same lane and both reductions run
        # on the same mask.
        nz = (eh_h != 0) | (eh_e != 0)
        first_nz = jnp.min(jnp.where(in_band & nz, lane, W + 2), axis=1,
                           keepdims=True)
        last_nz = jnp.max(jnp.where((in_band | (lane == end_i)) & nz,
                                    lane, NEG), axis=1, keepdims=True)
        beg_n = jnp.minimum(first_nz, end_i)
        j_dn = jnp.where(last_nz == NEG, beg_n - 1, last_nz)
        end_n = jnp.minimum(j_dn + 2, qlen)
        beg = jnp.where(alive, beg_n, beg)
        end = jnp.where(alive, end_n, end)
        return (i + 1, eh_h, eh_e, beg, end, best, max_i, max_j, max_ie,
                gscore, max_off, dead)

    zero = jnp.zeros((N, 1), I32)
    # empty jobs (tlen <= 0: pad rows, absent sides, jobs masked out of
    # a retry pass) start dead so they cannot hold the loop open; act
    # gates every write-back, so this is bit-exact
    init = (jnp.zeros((), I32), eh_h, eh_e, zero, qlen, h0, zero - 1,
            zero - 1, zero - 1, zero - 1, zero, tlen <= 0)
    (_, _, _, _, _, best, max_i, max_j, max_ie, gscore, max_off,
     _) = jax.lax.while_loop(cond, body, init)
    return jnp.concatenate([best, max_j + 1, max_i + 1, max_ie + 1,
                            gscore, max_off], axis=1)


@partial(jax.jit, static_argnames=("o_del", "e_del", "o_ins", "e_ins",
                                   "zdrop", "qmax", "tmax"))
def extend_batch(q: jnp.ndarray, t: jnp.ndarray, qlen: jnp.ndarray,
                 tlen: jnp.ndarray, h0: jnp.ndarray, w: jnp.ndarray,
                 end_bonus: jnp.ndarray, mat: jnp.ndarray,
                 o_del: int, e_del: int, o_ins: int, e_ins: int,
                 zdrop: int, qmax: int, tmax: int):
    """Run N ksw_extend jobs in lockstep.

    q: int32 [N, qmax] query codes; t: int32 [N, tmax] target codes
    qlen/tlen/h0/w/end_bonus: int32 [N]; mat: int32 [5, 5]

    Returns (score, qle, tle, gtle, gscore, max_off): each int32 [N].
    """
    N = q.shape[0]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    jidx = jnp.arange(qmax + 1, dtype=I32)[None, :]     # [1, qmax+1]
    lane = jidx[:, :qmax]                               # [1, qmax]

    # ---- first row of eh (shifted): eh_h[j] = H(-1, j-1)
    ramp = h0[:, None] - oe_ins - (jidx - 1) * e_ins
    eh_h0 = jnp.where(jidx == 0, h0[:, None],
                      jnp.maximum(ramp, 0)).astype(I32)
    # upstream stops the ramp at the first value <= e_ins; since the
    # ramp is strictly decreasing, values after the stop are exactly
    # the clamped-to-0 ones — identical arrays.
    eh_h0 = jnp.where(jidx <= qlen[:, None], eh_h0, 0)
    eh_e0 = jnp.zeros((N, qmax + 1), I32)

    # ---- band cap from end_bonus (w = min(w, max_ins, max_del))
    mmax = jnp.maximum(jnp.max(mat), 0).astype(I32)
    max_ins = ((qlen * mmax + end_bonus - o_ins) // e_ins + 1).astype(I32)
    max_del = ((qlen * mmax + end_bonus - o_del) // e_del + 1).astype(I32)
    ww = jnp.minimum(w, jnp.maximum(max_ins, 1))
    ww = jnp.minimum(ww, jnp.maximum(max_del, 1))

    # flat scoring profile: score of (target_base, query_lane)
    qpad = jnp.where(lane < qlen[:, None], q[:, :qmax], 4)

    def row(i, state):
        (eh_h, eh_e, beg, end, best, max_i, max_j, max_ie, gscore,
         max_off, dead) = state
        i32 = jnp.asarray(i, I32)
        act = (~dead) & (i32 < tlen)
        beg_i = jnp.maximum(beg, i32 - ww)
        end_i = jnp.minimum(jnp.minimum(end, i32 + ww + 1), qlen)
        closed = beg_i >= end_i
        h1_first = jnp.where(beg_i == 0,
                             jnp.maximum(h0 - (o_del + e_del * (i32 + 1)),
                                         0), 0).astype(I32)
        tb = t[jnp.arange(N), jnp.clip(i32, 0, tmax - 1)]
        prof = mat[tb[:, None], qpad]                   # [N, qmax]
        in_band = (lane >= beg_i[:, None]) & (lane < end_i[:, None])
        Hdiag = eh_h[:, :qmax]
        M = jnp.where(Hdiag != 0, Hdiag + prof, 0)
        M = jnp.where(in_band, M, NEG)
        E = jnp.where(in_band, eh_e[:, :qmax], NEG)
        he = jnp.maximum(M, E)
        # F prefix-max scan (F[beg]=0; see ref/ksw.py derivation)
        t_ins = jnp.maximum(M - oe_ins, 0)
        t_ins = jnp.where(in_band, t_ins, NEG)
        scan_in = t_ins + lane * e_ins
        pm = jax.lax.cummax(scan_in, axis=1)
        F = jnp.concatenate(
            [jnp.full((N, 1), NEG, I32), pm[:, :-1]], axis=1) \
            - lane * e_ins + e_ins
        F = jnp.where(lane == beg_i[:, None], 0, F)
        H = jnp.maximum(he, F)
        H = jnp.where(in_band, H, 0)
        act_band = act & ~closed
        m = jnp.max(jnp.where(in_band, H, NEG), axis=1)
        m = jnp.maximum(m, 0)  # H >= 0 in band; empty handled by closed
        mj = jnp.max(jnp.where(in_band & (H == m[:, None]), lane, -1),
                     axis=1)
        # E for next row
        t_del = jnp.maximum(M - oe_del, 0)
        Enew = jnp.maximum(eh_e[:, :qmax] - e_del, t_del)
        # ---- writebacks (only for active, open-band jobs)
        upd = act_band[:, None]
        # eh_h[beg] = h1_first; eh_h[j] = H[j-1] for j in (beg, end]
        Hshift = jnp.concatenate([jnp.zeros((N, 1), I32), H], axis=1)
        wmask_h = (jidx > beg_i[:, None]) & (jidx <= end_i[:, None])
        eh_h = jnp.where(upd & wmask_h, Hshift, eh_h)
        eh_h = jnp.where(upd & (jidx == beg_i[:, None]),
                         h1_first[:, None], eh_h)
        wmask_e = (jidx >= beg_i[:, None]) & (jidx < end_i[:, None])
        Epad = jnp.concatenate([Enew, jnp.zeros((N, 1), I32)], axis=1)
        eh_e = jnp.where(upd & wmask_e, Epad, eh_e)
        eh_e = jnp.where(upd & (jidx == end_i[:, None]), 0, eh_e)
        # closed-band lane: upstream writes eh[end]=h1, eh_e[end]=0,
        # takes the gscore update, then breaks on m==0
        cl = (act & closed)[:, None]
        eh_h = jnp.where(cl & (jidx == end_i[:, None]),
                         h1_first[:, None], eh_h)
        eh_e = jnp.where(cl & (jidx == end_i[:, None]), 0, eh_e)
        h_last = jnp.where(closed, h1_first,
                           Hshift[jnp.arange(N),
                                  jnp.clip(end_i, 0, qmax)])
        # gscore (ties -> later i)
        at_qend = act & (end_i == qlen) & (h_last >= gscore)
        max_ie = jnp.where(at_qend, i32, max_ie)
        gscore = jnp.where(at_qend, h_last, gscore)
        # m == 0 or closed band -> dead
        dead = dead | (act & (closed | (m == 0)))
        alive = act & ~closed & (m != 0)
        # best update (strictly greater) else zdrop check
        better = alive & (m > best)
        off = jnp.abs(mj - i32)
        max_off = jnp.where(better, jnp.maximum(max_off, off), max_off)
        best_new = jnp.where(better, m, best)
        max_i = jnp.where(better, i32, max_i)
        max_j = jnp.where(better, mj, max_j)
        if zdrop > 0:
            di = i32 - max_i
            dj = mj - max_j
            zd = jnp.where(
                di > dj,
                best - m - (di - dj) * e_del > zdrop,
                best - m - (dj - di) * e_ins > zdrop)
            dead = dead | (alive & ~better & zd)
        best = best_new
        # adaptive band trim on the UPDATED shifted arrays
        nz = (eh_h != 0) | (eh_e != 0)
        in_scan = (jidx >= beg_i[:, None]) & (jidx < end_i[:, None])
        first_nz = jnp.min(jnp.where(in_scan & nz, jidx, qmax + 2),
                           axis=1)
        beg_n = jnp.minimum(first_nz, end_i)
        in_scan2 = (jidx >= beg_n[:, None]) & (jidx <= end_i[:, None])
        last_nz = jnp.max(jnp.where(in_scan2 & nz, jidx, NEG), axis=1)
        j_dn = jnp.where(last_nz == NEG, beg_n - 1, last_nz)
        end_n = jnp.minimum(j_dn + 2, qlen)
        beg = jnp.where(alive, beg_n, beg)
        end = jnp.where(alive, end_n, end)
        return (eh_h, eh_e, beg, end, best, max_i, max_j, max_ie,
                gscore, max_off, dead)

    zeros = jnp.zeros(N, I32)
    state = (eh_h0, eh_e0, zeros, qlen.astype(I32), h0.astype(I32),
             zeros - 1, zeros - 1, zeros - 1, zeros - 1, zeros,
             jnp.zeros(N, bool))
    state = jax.lax.fori_loop(0, tmax, row, state)
    (eh_h, eh_e, beg, end, best, max_i, max_j, max_ie, gscore,
     max_off, dead) = state
    return (best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off)


def extend_batch_np(jobs, mat, o_del, e_del, o_ins, e_ins, zdrop,
                    qmax, tmax):
    """Convenience wrapper: list of dict jobs -> numpy result tuple.
    Pads the job count to pow2 buckets so wave sizes don't retrace."""
    n_real = len(jobs)
    N = 64
    while N < n_real:
        N <<= 1
    q = np.full((N, qmax), 4, np.int32)
    t = np.full((N, tmax), 4, np.int32)
    qlen = np.zeros(N, np.int32)
    tlen = np.zeros(N, np.int32)
    h0 = np.ones(N, np.int32)
    w = np.zeros(N, np.int32)
    eb = np.zeros(N, np.int32)
    for i, j in enumerate(jobs):
        ql, tl = len(j["q"]), len(j["t"])
        q[i, :ql] = j["q"]
        t[i, :tl] = j["t"]
        qlen[i] = ql
        tlen[i] = tl
        h0[i] = j["h0"]
        w[i] = j["w"]
        eb[i] = j["end_bonus"]
    out = extend_batch(jnp.asarray(q), jnp.asarray(t),
                       jnp.asarray(qlen), jnp.asarray(tlen),
                       jnp.asarray(h0), jnp.asarray(w), jnp.asarray(eb),
                       jnp.asarray(mat, dtype=I32), o_del, e_del, o_ins,
                       e_ins, zdrop, qmax, tmax)
    return tuple(np.asarray(x)[:n_real] for x in out)


def extend_rows_np(jobs, mat, o_del, e_del, o_ins, e_ins, zdrop, qmax,
                   tmax):
    """Dispatch-layer adapter: list of dict jobs -> 6 result arrays
    through ``extend_rows``.  Jobs are sorted by target length so the
    row loop's all-dead exit comes early; matrices without scmat
    structure and queries wider than LANES - 1 take ``extend_batch``."""
    ab = _mat_ab(mat)
    if ab is None or qmax > LANES - 1:
        return extend_batch_np(jobs, mat, o_del, e_del, o_ins, e_ins,
                               zdrop, qmax, tmax)
    n = len(jobs)
    order = sorted(range(n), key=lambda i: -len(jobs[i]["t"]))
    W = width_for(max((len(j["q"]) for j in jobs), default=0))
    N = 64
    while N < n:
        N <<= 1
    q = np.full((N, W), 4, np.int32)
    t = np.full((N, tmax), 4, np.int32)
    p = np.zeros((5, N), np.int32)
    p[2] = 1  # h0 > 0 for padding jobs
    for slot, i in enumerate(order):
        j = jobs[i]
        ql, tl = len(j["q"]), len(j["t"])
        q[slot, :ql] = j["q"]
        t[slot, :tl] = j["t"]
        p[:, slot] = (ql, tl, j["h0"], j["w"], j["end_bonus"])
    res = np.asarray(extend_rows(jnp.asarray(q), jnp.asarray(t),
                                 *(jnp.asarray(x) for x in p), ab[0],
                                 ab[1], o_del, e_del, o_ins, e_ins, zdrop))
    out = np.zeros((6, n), np.int32)
    out[:, order] = res[:n].T
    return tuple(out)
