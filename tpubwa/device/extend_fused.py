"""Fused per-seed extension: left + right + band-doubling retries in
ONE device program (bwamem.c:mem_chain2aln:~700's per-seed body,
SURVEY.md §2 row 9, §3.4 phases A-C collapsed).

The wave dispatcher pays one host<->device round trip per wave, not
one per (side, band-trial): this module runs the whole upstream
per-seed protocol in one device program:

    trial0 left  -> retry? (max_off >= 3/4 w && score changed)
    trial1 left  (masked to retrying jobs)
    sc0 = selected left score (or h0 when there is no left part)
    trial0 right (h0 = sc0) -> retry?
    trial1 right (masked)

and returns one packed [N, 16] row per job:
    0..5   selected left  (score, qle, tle, gtle, gscore, max_off)
    6..11  selected right (score, qle, tle, gtle, gscore, max_off)
    12 aw0 (final left band)   13 aw1 (final right band)
    14 sc0 (score after left)  15 final score

Bit-identity with the scalar trial loops of ref.ksw-driven
mem_chain2aln is pinned by tests/test_extend_fused.py.
"""

from __future__ import annotations

import functools
import os
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from .extend import LANES, _mat_ab, extend_rows, width_for

I32 = jnp.int32
MIN_JOBS = 64        # smallest padded job count (bounds compiled shapes)

# result-row layout
L_SCORE, L_QLE, L_TLE, L_GTLE, L_GSCORE, L_MAXOFF = range(6)
R_SCORE, R_QLE, R_TLE, R_GTLE, R_GSCORE, R_MAXOFF = range(6, 12)
AW0, AW1, SC0, SCORE = 12, 13, 14, 15


def _retry(res, qlen, w, prev):
    """Upstream band loop: retry iff score != prev AND
    max_off >= (w>>1)+(w>>2) (and the side exists at all)."""
    return ((qlen > 0) & (res[:, 0] != prev)
            & (res[:, 5] >= (w >> 1) + (w >> 2)))


def _fused_passes(qL, tL, qR, tR, qlenL, tlenL, qlenR, tlenR, h0, w0,
                  pen5, pen3, a, b, o_del, e_del, o_ins, e_ins, zdrop):

    def run(q, t, qlen, tlen, hh, ww, eb):
        # the row loop assumes h0 > 0 (pad and masked rows carry 0)
        return extend_rows(q, t, qlen, tlen, jnp.maximum(hh, 1), ww, eb,
                           a, b, o_del, e_del, o_ins, e_ins, zdrop)

    # ---- left, trial 0 (prev = -1: score never equals it)
    rL0 = run(qL, tL, qlenL, tlenL, h0, w0, pen5)
    retL = _retry(rL0, qlenL, w0, -1)
    # ---- left, trial 1 (non-retrying jobs masked to empty: the row
    # loop exits at once when nothing retries)
    m = retL.astype(I32)
    rL1 = run(qL, tL, qlenL * m, tlenL * m, h0, w0 * 2, pen5)
    rL = jnp.where(retL[:, None], rL1, rL0)
    aw0 = jnp.where(retL, w0 * 2, w0)
    sc0 = jnp.where(qlenL > 0, rL[:, 0], h0)
    # ---- right, trial 0 (h0 = sc0, prev = sc0)
    rR0 = run(qR, tR, qlenR, tlenR, sc0, w0, pen3)
    retR = _retry(rR0, qlenR, w0, sc0)
    m = retR.astype(I32)
    rR1 = run(qR, tR, qlenR * m, tlenR * m, sc0, w0 * 2, pen3)
    rR = jnp.where(retR[:, None], rR1, rR0)
    aw1 = jnp.where(retR, w0 * 2, w0)
    score = jnp.where(qlenR > 0, rR[:, 0], sc0)
    return jnp.concatenate(
        [rL[:, :6], rR[:, :6], aw0[:, None], aw1[:, None], sc0[:, None],
         score[:, None]], axis=1).reshape(-1)


@functools.partial(
    jax.jit,
    static_argnames=("a", "b", "o_del", "e_del", "o_ins", "e_ins",
                     "zdrop"))
def extend_seed(qL, tL, qR, tR, meta, a, b, o_del, e_del, o_ins, e_ins,
                zdrop):
    """meta int32 [N, 8]: qlenL, tlenL, qlenR, tlenR, h0, w, pen5, pen3.
    Returns flat int32 [N * 16] (layout above)."""
    # sequences arrive int8 (a quarter of the upload); compute in int32
    return _fused_passes(
        qL.astype(I32), tL.astype(I32), qR.astype(I32), tR.astype(I32),
        meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3], meta[:, 4],
        meta[:, 5], meta[:, 6], meta[:, 7], a, b, o_del, e_del, o_ins,
        e_ins, zdrop)


def _ref_codes(didx, pos):
    """Reference codes at doubled coordinates, from the resident pac
    (bns get_seq fold: pos >= l_pac reads the reverse-complement
    image).  Caller masks out-of-window lanes."""
    lp = didx.l_pac
    pos = jnp.clip(pos, 0, 2 * lp - 1)
    rev = pos >= lp
    p = jnp.where(rev, 2 * lp - 1 - pos, pos).astype(didx.idt)
    w = didx.pac_words[p >> 4]
    sh = ((15 - (p & 15)) << 1).astype(jnp.uint32)
    c = ((w >> sh) & jnp.uint32(3)).astype(I32)
    return jnp.where(rev, 3 - c, c)


def _unpack16(words):
    """[N, K] uint32 pac words -> [N, 16K] int32 codes in ascending
    position order (position p&15 == 0 holds the word's high bits)."""
    sh = (2 * (15 - jnp.arange(16, dtype=jnp.uint32)))[None, None, :]
    c = ((words[:, :, None] >> sh) & jnp.uint32(3)).astype(I32)
    return c.reshape(words.shape[0], -1)


def _fine16(strip, a, Wd):
    """strip [N, S] (S >= Wd + 15), a [N] in 0..15 ->
    out[n, j] = strip[n, a[n] + j]: a 16-way select over STATIC slices
    (a data-dependent gather here is the cost this replaces)."""
    out = strip[:, 0:Wd]
    for s in range(1, 16):
        out = jnp.where(a[:, None] == s, strip[:, s:s + Wd], out)
    return out


def _ref_window(didx, p0, step_desc, tlen, tmax):
    """Reference tile [N, tmax]: codes at doubled positions p0, p0+d,
    p0+2d, ... (d = -1 when step_desc else +1), masked to 4 beyond
    tlen.  The extension window never crosses the fwd/rev boundary
    (host/regions.py clips rmax around l_pac), so the folded image of
    the window is one CONTIGUOUS pac range: gather ceil(tmax/16)+1
    WORDS per job instead of one word per base, unpack, and shift by
    the sub-word offset with a 16-way static-slice select."""
    lp = didx.l_pac
    p0 = jnp.clip(p0, 0, 2 * lp - 1)
    rev = p0 >= lp
    q0 = jnp.where(rev, 2 * lp - 1 - p0, p0)
    # folded direction: the rev fold mirrors the step
    asc = rev if step_desc else ~rev
    # strip must cover tmax lanes at every sub-word shift 0..15:
    # 16K >= tmax + 15 for ANY tmax, not just multiples of 16
    # (ADVICE r4: tmax//16+1 under-allocates when tmax % 16 > 1)
    K = (tmax + 30) // 16
    wq = (q0 >> 4).astype(I32)
    wb = jnp.where(asc, wq, wq - (K - 1))
    nw = didx.pac_words.shape[0]
    widx = jnp.clip(wb[:, None] + jnp.arange(K, dtype=I32)[None, :],
                    0, nw - 1)
    strip = _unpack16(didx.pac_words[widx])        # [N, 16K] ascending
    strip = jnp.where(asc[:, None], strip, strip[:, ::-1])
    aa = (q0 & 15).astype(I32)
    tile = _fine16(strip, jnp.where(asc, aa, 15 - aa), tmax)
    tile = jnp.where(rev[:, None], 3 - tile, tile)
    jT = jnp.arange(tmax, dtype=I32)[None, :]
    return jnp.where(jT < tlen[:, None], tile, 4)


def _query_window(qrow, off, step_desc, qlen, W):
    """Query tile [N, W] from per-job read rows [N, L]: codes at row
    offsets off, off+d, ... masked to 4 beyond qlen.  Same select-shift
    scheme as _ref_window with a coarse 16-aligned level first (off is
    an arbitrary in-read position, not a sub-word offset).  The
    descending case reverses the ROW first so off stays in 0..L-1."""
    N, L = qrow.shape
    if step_desc:
        # out[j] = row[off - j] == reversed-row[(L-1-off) + j]
        qrow = qrow[:, ::-1]
        off = (L - 1) - off
    C = (L + 15) // 16
    pad = 16 * (C - 1) + W + 16 - L
    strip = jnp.concatenate(
        [qrow.astype(I32), jnp.full((N, pad), 4, I32)], axis=1)
    c = off >> 4
    a = off & 15
    s1 = strip[:, 0:W + 16]
    for k in range(1, C):
        s1 = jnp.where(c[:, None] == k, strip[:, 16 * k:16 * k + W + 16],
                       s1)
    tile = _fine16(s1, a, W)
    jW = jnp.arange(W, dtype=I32)[None, :]
    return jnp.where(jW < qlen[:, None], tile, 4)


def _extend_seed_desc_impl(didx, qreads, desc, a, b, o_del, e_del,
                           o_ins, e_ins, zdrop, W, tmax, gather="word"):
    read = desc[:, 0].astype(I32)
    qbeg = desc[:, 1].astype(I32)
    slen = desc[:, 2].astype(I32)
    lq = desc[:, 3].astype(I32)
    rbeg, rmax0, rmax1 = desc[:, 4], desc[:, 5], desc[:, 6]
    w0 = desc[:, 7].astype(I32)
    h0 = desc[:, 8].astype(I32)
    pen5 = desc[:, 9].astype(I32)
    pen3 = desc[:, 10].astype(I32)
    qe = qbeg + slen
    qlenL = qbeg
    qlenR = lq - qe
    tlenL = jnp.where(qlenL > 0, (rbeg - rmax0).astype(I32), 0)
    tlenR = jnp.where(qlenR > 0,
                      (rmax1 - rbeg).astype(I32) - slen, 0)
    L = qreads.shape[1]
    if gather == "element":
        # pre-round-4 per-base gather path, kept for A/B
        jW = jnp.arange(W, dtype=I32)[None, :]
        qL = jnp.where(jW < qlenL[:, None],
                       qreads[read[:, None],
                              jnp.clip(qbeg[:, None] - 1 - jW, 0, L - 1)]
                       .astype(I32), 4)
        qR = jnp.where(jW < qlenR[:, None],
                       qreads[read[:, None],
                              jnp.clip(qe[:, None] + jW, 0, L - 1)]
                       .astype(I32), 4)
        jT = jnp.arange(tmax, dtype=desc.dtype)[None, :]
        tL = jnp.where(jT < tlenL[:, None],
                       _ref_codes(didx, rbeg[:, None] - 1 - jT), 4)
        tR = jnp.where(jT < tlenR[:, None],
                       _ref_codes(didx, (rbeg + slen)[:, None] + jT), 4)
    else:
        qrow = jnp.take(qreads, read, axis=0)      # [N, L] row gather
        qL = _query_window(qrow, jnp.clip(qbeg - 1, 0, L - 1), True,
                           qlenL, W)
        qR = _query_window(qrow, jnp.clip(qe, 0, L - 1), False,
                           qlenR, W)
        tL = _ref_window(didx, rbeg - 1, True, tlenL, tmax)
        tR = _ref_window(didx, rbeg + slen, False, tlenR, tmax)
    # the whole wave is one batch: on an H100 this beat a lax.scan
    # over 2048- and 1024-job chunks on every wave (PERF.md)
    return _fused_passes(qL, tL, qR, tR, qlenL, tlenL, qlenR, tlenR, h0,
                         w0, pen5, pen3, a, b, o_del, e_del, o_ins, e_ins,
                         zdrop)


@functools.partial(
    jax.jit,
    static_argnames=("a", "b", "o_del", "e_del", "o_ins", "e_ins",
                     "zdrop", "W", "tmax", "out16", "gather"))
def extend_seed_desc(didx, qreads, desc, a, b, o_del, e_del, o_ins,
                     e_ins, zdrop, W, tmax, out16=False, gather="word"):
    """Descriptor-mode fused extension: tiles are built ON DEVICE.

    qreads: uint8 [B, L] resident chunk reads; desc idt [N, 11]:
    (read_row, qbeg, slen, l_query, rbeg, rmax0, rmax1, w, h0, pen5,
    pen3).  Returns flat int32 [N * 16] (int16 when out16: every row
    value is bounded by ~2*qmax*a + pens, so the caller enables it for
    sane scoring and halves the result's device-to-host bytes).  gather ('word'|'element') is a
    STATIC arg so an env flip after first compile cannot be silently
    ignored (ADVICE r4: it used to be read at trace time)."""
    out = _extend_seed_desc_impl(didx, qreads, desc, a, b, o_del,
                                 e_del, o_ins, e_ins, zdrop, W, tmax,
                                 gather)
    return out.astype(jnp.int16) if out16 else out


@functools.partial(
    jax.jit,
    static_argnames=("a", "b", "o_del", "e_del", "o_ins", "e_ins",
                     "zdrop", "W", "tmax", "mesh", "out16", "gather"))
def extend_seed_desc_sharded(didx, qreads, desc, a, b, o_del, e_del,
                             o_ins, e_ins, zdrop, W, tmax, mesh,
                             out16=False, gather="word"):
    """Data-parallel descriptor extension: the whole desc body (tile
    gathers + fused passes) runs under shard_map with the job axis
    sharded over 'dp' and the index/reads replicated (SURVEY.md §2.2),
    so each device runs its own row loop to its own jobs' exit."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    import jax.tree_util as jtu

    def local(didx_, qreads_, desc_):
        out = _extend_seed_desc_impl(didx_, qreads_, desc_, a, b,
                                     o_del, e_del, o_ins, e_ins,
                                     zdrop, W, tmax, gather)
        return out.astype(jnp.int16) if out16 else out

    didx_spec = jtu.tree_map(lambda _: P(), didx)
    return shard_map(local, mesh=mesh,
                     in_specs=(didx_spec, P(), P("dp")),
                     out_specs=P("dp"), check_vma=False)(
                         didx, qreads, desc)


def extend_seed_desc_np(didx, qd, jobs, mat, o_del, e_del, o_ins,
                        e_ins, zdrop, tmax, mesh=None) -> np.ndarray:
    """Adapter: descriptor job tuples ('D', read, qbeg, slen, lq, rbeg,
    rmax0, rmax1, w, h0, pen5, pen3) -> np.int32 [n, 16].  Ships ~44
    bytes per job; tiles come from the resident read array + pac."""
    ab = _mat_ab(mat)
    assert ab is not None  # caller guards (scmat matrices only)
    n = len(jobs)
    if isinstance(jobs, np.ndarray):
        # raw descriptor rows (native planner path): already [n, 11]
        da = np.ascontiguousarray(jobs, didx.np_idt)
    else:
        da = np.zeros((max(n, 1), 11), didx.np_idt)
        for i, j in enumerate(jobs):
            da[i] = j[1:]
    tlL = np.where(da[:n, 1] > 0, da[:n, 4] - da[:n, 5], 0)
    tlR = np.where(da[:n, 3] - da[:n, 1] - da[:n, 2] > 0,
                   da[:n, 6] - da[:n, 4] - da[:n, 2], 0)
    W = width_for(int(max(da[:n, 1].max(initial=0),
                          (da[:n, 3] - da[:n, 1] - da[:n, 2])
                          .max(initial=0))))
    # pow2 job counts bound the compiled-shape set; pad rows start
    # dead, so they cost the row loop nothing
    N = MIN_JOBS
    while N < n:
        N <<= 1
    tm = 128
    while tm < max(int(tlL.max(initial=0)), int(tlR.max(initial=0))):
        tm <<= 1
    tm = min(tm, tmax)
    desc = np.zeros((N, 11), didx.np_idt)
    desc[:, 8] = 1   # h0 > 0 for pad rows
    desc[:, 7] = 1   # w > 0
    desc[:n] = da[:n]
    # int16 result wire: all row values are bounded by
    # ~2*qmax*a + clips (score/qle/tle/gtle/gscore/max_off/aw/sc0);
    # halves the D2H bytes whenever the bound fits (default a=1 does).
    # tle/gtle are bounded by tm and qle/max_off/aw by ~W, so those
    # must fit too (ADVICE r4: oversized tmax would silently wrap)
    out16 = ((2 * 1024 * ab[0] + 512) < 32767 and tm < 32767
             and 2 * W < 32767
             and 2 * int(da[:n, 7].max(initial=1)) < 32767)
    # tile-gather mode is resolved HERE (not at trace time) and passed
    # as a static jit arg, so A/B flips after first compile take effect
    gather = os.environ.get("TPUBWA_TILE_GATHER", "word")
    if gather not in ("word", "element"):
        gather = "word"
    # one dispatch per wave
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        res = extend_seed_desc_sharded(
            didx, qd, jax.device_put(desc, NamedSharding(mesh, P("dp"))),
            ab[0], ab[1], o_del, e_del, o_ins, e_ins, zdrop, W, tm, mesh,
            out16, gather)
    else:
        res = extend_seed_desc(
            didx, qd, jnp.asarray(desc), ab[0], ab[1], o_del, e_del,
            o_ins, e_ins, zdrop, W, tm, out16, gather)
    return np.asarray(res).reshape(-1, 16)[:n].astype(np.int32)


def scalar_fused(job, mat, o_del, e_del, o_ins, e_ins, zdrop,
                 max_band_try=2):
    """Scalar oracle / oversize fallback: the upstream trial loops with
    ref.ksw.ksw_extend.  job = (qlenL, qL, tlenL, tL, qlenR, qR, tlenR,
    tR, w, h0, pen5, pen3).  Returns np.int32 [16]."""
    from ..ref.ksw import ksw_extend
    (qlenL, qL, tlenL, tL, qlenR, qR, tlenR, tR, w0, h0,
     pen5, pen3) = job
    out = np.zeros(16, np.int64)
    score = -1
    aw0 = aw1 = w0
    if qlenL > 0:
        for trial in range(max_band_try):
            prev = score
            aw0 = w0 << trial
            r = ksw_extend(qlenL, qL, tlenL, tL, mat, o_del, e_del,
                           o_ins, e_ins, aw0, pen5, zdrop, h0)
            score = r.score
            out[:6] = (r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off)
            if score == prev or r.max_off < (aw0 >> 1) + (aw0 >> 2):
                break
    sc0 = score if qlenL > 0 else h0
    score = sc0
    if qlenR > 0:
        for trial in range(max_band_try):
            prev = score
            aw1 = w0 << trial
            r = ksw_extend(qlenR, qR, tlenR, tR, mat, o_del, e_del,
                           o_ins, e_ins, aw1, pen3, zdrop, sc0)
            score = r.score
            out[6:12] = (r.score, r.qle, r.tle, r.gtle, r.gscore,
                         r.max_off)
            if score == prev or r.max_off < (aw1 >> 1) + (aw1 >> 2):
                break
    out[AW0], out[AW1], out[SC0], out[SCORE] = aw0, aw1, sc0, score
    return out


def extend_seed_batch_np(jobs: List, mat, o_del, e_del, o_ins, e_ins,
                         zdrop, qmax, tmax) -> np.ndarray:
    """Adapter: list of fused job tuples -> np.int32 [n, 16].
    Pads to pow2 job buckets.  Falls back to the scalar loops for
    non-scmat matrices."""
    ab = _mat_ab(mat)
    if ab is None or qmax > LANES - 1:
        return np.stack([
            scalar_fused(j, mat, o_del, e_del, o_ins, e_ins, zdrop)
            for j in jobs]).astype(np.int32)
    n = len(jobs)
    W = width_for(max((max(int(j[0]), int(j[4])) for j in jobs),
                      default=0))
    N = MIN_JOBS
    while N < n:
        N <<= 1
    tm = 128
    while tm < max((max(int(j[2]), int(j[6])) for j in jobs),
                   default=0):
        tm <<= 1
    tmax = min(tmax, tm)
    qLa = np.full((N, W), 4, np.int8)
    tLa = np.full((N, tmax), 4, np.int8)
    qRa = np.full((N, W), 4, np.int8)
    tRa = np.full((N, tmax), 4, np.int8)
    meta = np.zeros((N, 8), np.int32)
    meta[:, 4] = 1   # h0 > 0 for pad rows
    meta[:, 5] = 1   # w > 0
    for slot, job in enumerate(jobs):
        (qlenL, qL, tlenL, tL, qlenR, qR, tlenR, tR, w0, h0,
         pen5, pen3) = job
        qLa[slot, :qlenL] = qL[:qlenL]
        tLa[slot, :tlenL] = tL[:tlenL]
        qRa[slot, :qlenR] = qR[:qlenR]
        tRa[slot, :tlenR] = tR[:tlenR]
        meta[slot] = (qlenL, tlenL, qlenR, tlenR, h0, w0, pen5, pen3)
    res = extend_seed(
        *(jnp.asarray(x) for x in (qLa, tLa, qRa, tRa, meta)), ab[0],
        ab[1], o_del, e_del, o_ins, e_ins, zdrop)
    return np.asarray(res).reshape(-1, 16)[:n]
