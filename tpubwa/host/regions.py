"""Extension driver and region post-processing
(bwamem.c:mem_chain2aln/~700, mem_sort_dedup_patch/~560,
mem_patch_reg/~545, mem_mark_primary_se/~960, mem_approx_mapq_se/~1040;
SURVEY.md §2 rows 9,13).

``chain2aln`` is the scalar extension driver (the reference's CPU
fallback shape); the device dispatch layer (tpubwa.device.dispatch)
produces identical regions by batching the same left/right extension
jobs across reads — the gather->kernel->scatter architecture the
QuickAssist fork used (SURVEY.md §3.4).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from ..index.build import BntSeq
from ..opts import MEM_F_PRIMARY5, MemOpt
from ..ref.ksw import ksw_extend, ksw_global
from .chain import Chain

MAX_BAND_TRY = 2
PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90
MEM_MAPQ_COEF = 30.0


@dataclass
class AlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = -1
    truesc: int = -1
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0


def hash_64(key: int) -> int:
    """Thomas Wang's 64-bit mix (bwamem.h:hash_64), mod 2^64."""
    M = (1 << 64) - 1
    key = (key + (~(key << 32) & M)) & M
    key ^= key >> 22
    key = (key + (~(key << 13) & M)) & M
    key ^= key >> 8
    key = (key + (key << 3)) & M
    key ^= key >> 15
    key = (key + (~(key << 27) & M)) & M
    key ^= key >> 31
    return key


def chain2aln(opt: MemOpt, bnt: BntSeq, l_query: int, query: np.ndarray,
              c: Chain, av: List[AlnReg], mat: np.ndarray) -> None:
    """Extend each worthy seed of chain c left+right; append regions.
    Scalar driver: runs the shared extension plan with the scalar
    kernel (the CPU-fallback role, SURVEY.md §2 row 17)."""
    gen = extension_plan(opt, bnt, l_query, query, c, av)
    try:
        job = next(gen)
        while True:
            r = ksw_extend(job[0], job[1], job[2], job[3], mat,
                           opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                           job[4], job[5], opt.zdrop, job[6])
            job = gen.send(r)
    except StopIteration:
        return


def extension_plan(opt: MemOpt, bnt: BntSeq, l_query: int,
                   query: np.ndarray, c: Chain, av: List[AlnReg],
                   fused: bool = False, read_row: int = -1):
    """Generator form of mem_chain2aln: yields extension jobs
    (qlen, q, tlen, t, w, end_bonus, h0) and receives KswExt results;
    mutates av in place.  Both the scalar driver above and the batched
    device wave dispatcher (device/dispatch.py) drive this generator,
    so the skip-test / band-doubling / local-vs-global logic exists
    exactly once.

    fused=True: yields ONE job per seed — (qlenL, qL, tlenL, tL, qlenR,
    qR, tlenR, tR, w, h0, pen5, pen3) — and receives a packed int row
    (device/extend_fused.py layout); the band-doubling trial loops run
    inside the device program instead of as separate waves (one
    host<->device round trip per seed instead of 2-4).

    read_row >= 0 (with fused): DESCRIPTOR mode — the query/reference
    tiles are materialized ON DEVICE from the resident read array and
    pac, so jobs ship as ~11 ints instead of ~1 KB of codes.  Yields
    ('D', read_row, qbeg, slen, l_query, rbeg, rmax0, rmax1, w, h0,
    pen5, pen3); same result row comes back."""
    if not c.seeds:
        return
    l_pac = bnt.l_pac
    # max possible span of this chain's alignment
    rmax0, rmax1 = l_pac << 1, 0
    maxlen = 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + opt.max_gap(t.qbeg))
        e = (t.rbeg + t.len + (l_query - t.qbeg - t.len)
             + opt.max_gap(l_query - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
        maxlen = max(maxlen, t.len)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:  # don't cross the fwd-rev boundary
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    desc_mode = fused and read_row >= 0
    if desc_mode:  # device extracts the window from the resident pac
        rid, rmax0, rmax1 = bnt.fetch_bounds(rmax0, c.seeds[0].rbeg,
                                             rmax1)
        rseq = None
    else:
        rseq, rid, rmax0, rmax1 = bnt.fetch_seq(rmax0, c.seeds[0].rbeg,
                                                rmax1)
    assert c.rid == rid

    # seeds by score ascending; iterate from the largest (ties: upstream
    # ks_introsort_64 on score<<32|index is ascending and total)
    srt = sorted(range(len(c.seeds)),
                 key=lambda i: (c.seeds[i].score, i))
    alive = [True] * len(c.seeds)

    for k in range(len(c.seeds) - 1, -1, -1):
        s = c.seeds[srt[k]]
        # skip test: seed contained in an existing region?
        hit = -1
        for i, p in enumerate(av):
            if (s.rbeg < p.rb or s.rbeg + s.len > p.re or s.qbeg < p.qb
                    or s.qbeg + s.len > p.qe):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd = s.qbeg - p.qb
            rd = s.rbeg - p.rb
            max_gap = opt.max_gap(min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit = i
                break
            qd = p.qe - (s.qbeg + s.len)
            rd = p.re - (s.rbeg + s.len)
            max_gap = opt.max_gap(min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit = i
                break
        if hit >= 0:
            # contained: only extend if a long-enough overlapping seed in
            # this chain disagrees on the diagonal
            found = False
            for i2 in range(k + 1, len(c.seeds)):
                if not alive[srt[i2]]:
                    continue
                t = c.seeds[srt[i2]]
                if t.len < s.len * 0.95:
                    continue
                if (s.qbeg <= t.qbeg and s.qbeg + s.len - t.qbeg >= s.len >> 2
                        and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                    found = True
                    break
                if (t.qbeg <= s.qbeg and t.qbeg + t.len - s.qbeg >= s.len >> 2
                        and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                    found = True
                    break
            if not found:
                alive[srt[k]] = False  # srt[i]=0 upstream
                continue

        a = AlnReg(rid=c.rid, w=opt.w, score=-1, truesc=-1,
                   frac_rep=c.frac_rep)
        aw0 = aw1 = opt.w
        if fused:
            # one fused device job per seed; trial loops run on device
            qe = s.qbeg + s.len
            re_off = s.rbeg + s.len - rmax0
            assert re_off >= 0
            qlen_r = l_query - qe
            if desc_mode:
                res = yield ('D', read_row, s.qbeg, s.len, l_query,
                             s.rbeg, rmax0, rmax1, opt.w,
                             s.len * opt.a, opt.pen_clip5,
                             opt.pen_clip3)
            else:
                qs = query[:s.qbeg][::-1].copy() if s.qbeg \
                    else query[:0]
                tlen_l = s.rbeg - rmax0 if s.qbeg else 0
                rs = rseq[:tlen_l][::-1].copy() if s.qbeg else rseq[:0]
                tlen_r = rmax1 - rmax0 - re_off if qlen_r else 0
                res = yield (s.qbeg, qs, tlen_l, rs, qlen_r, query[qe:],
                             tlen_r, rseq[re_off:], opt.w,
                             s.len * opt.a, opt.pen_clip5,
                             opt.pen_clip3)
            if s.qbeg:
                a.score = int(res[0])
                qle, tle, gtle, gscore = (int(res[1]), int(res[2]),
                                          int(res[3]), int(res[4]))
                aw0 = int(res[12])
                if gscore <= 0 or gscore <= a.score - opt.pen_clip5:
                    a.qb = s.qbeg - qle
                    a.rb = s.rbeg - tle
                    a.truesc = a.score
                else:
                    a.qb = 0
                    a.rb = s.rbeg - gtle
                    a.truesc = gscore
            else:
                a.score = a.truesc = s.len * opt.a
                a.qb = 0
                a.rb = s.rbeg
            if qlen_r:
                sc0 = a.score
                a.score = int(res[6])
                qle, tle, gtle, gscore = (int(res[7]), int(res[8]),
                                          int(res[9]), int(res[10]))
                aw1 = int(res[13])
                if gscore <= 0 or gscore <= a.score - opt.pen_clip3:
                    a.qe = qe + qle
                    a.re = rmax0 + re_off + tle
                    a.truesc += a.score - sc0
                else:
                    a.qe = l_query
                    a.re = rmax0 + re_off + gtle
                    a.truesc += gscore - sc0
            else:
                a.qe = l_query
                a.re = s.rbeg + s.len
            a.seedcov = 0
            for t in c.seeds:
                if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                        and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                    a.seedcov += t.len
            a.w = max(aw0, aw1)
            a.seedlen0 = s.len
            av.append(a)
            continue
        if s.qbeg:  # left extension (reversed sequences)
            qs = query[:s.qbeg][::-1].copy()
            tlen_l = s.rbeg - rmax0
            rs = rseq[:tlen_l][::-1].copy()
            qle = tle = gtle = 0
            gscore = -1
            for trial in range(MAX_BAND_TRY):
                prev = a.score
                aw0 = opt.w << trial
                r = yield (s.qbeg, qs, tlen_l, rs, aw0, opt.pen_clip5,
                           s.len * opt.a)
                a.score = r.score
                qle, tle, gtle, gscore = r.qle, r.tle, r.gtle, r.gscore
                if a.score == prev or r.max_off < (aw0 >> 1) + (aw0 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip5:
                a.qb = s.qbeg - qle
                a.rb = s.rbeg - tle
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s.rbeg - gtle
                a.truesc = gscore
        else:
            a.score = a.truesc = s.len * opt.a
            a.qb = 0
            a.rb = s.rbeg

        if s.qbeg + s.len != l_query:  # right extension
            sc0 = a.score
            qe = s.qbeg + s.len
            re_off = s.rbeg + s.len - rmax0
            assert re_off >= 0
            qle = tle = gtle = 0
            gscore = -1
            for trial in range(MAX_BAND_TRY):
                prev = a.score
                aw1 = opt.w << trial
                r = yield (l_query - qe, query[qe:],
                           rmax1 - rmax0 - re_off, rseq[re_off:], aw1,
                           opt.pen_clip3, sc0)
                a.score = r.score
                qle, tle, gtle, gscore = r.qle, r.tle, r.gtle, r.gscore
                if a.score == prev or r.max_off < (aw1 >> 1) + (aw1 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip3:
                a.qe = qe + qle
                a.re = rmax0 + re_off + tle
                a.truesc += a.score - sc0
            else:
                a.qe = l_query
                a.re = rmax0 + re_off + gtle
                a.truesc += gscore - sc0
        else:
            a.qe = l_query
            a.re = s.rbeg + s.len

        a.seedcov = 0
        for t in c.seeds:
            if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                a.seedcov += t.len
        a.w = max(aw0, aw1)
        a.seedlen0 = s.len
        av.append(a)


# ----------------------- dedup / patch ---------------------------------

def patch_reg(opt: MemOpt, bnt: BntSeq, query: np.ndarray, a: AlnReg,
              b: AlnReg, mat: np.ndarray):
    """mem_patch_reg: try joining colinear regions a (left of b) into one;
    returns (score, w) — score 0 means no merge."""
    assert a.rid == b.rid and a.rb <= b.rb
    l_pac = bnt.l_pac
    if a.rb < l_pac and b.rb >= l_pac:
        return 0, 0
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, 0  # not colinear
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:  # no overlap
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return 0, 0
    w += max(a.w, b.w)
    w = min(w, opt.w << 2)
    rb, re = a.rb, b.re
    rseq, rid, rb, re = bnt.fetch_seq(rb, (rb + re) >> 1, re)
    if re - rb != b.re - a.rb:
        return 0, 0
    score, _ = ksw_global(b.qe - a.qb, query[a.qb:b.qe], re - rb, rseq,
                          mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                          w, want_cigar=False)
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb))
              * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
              * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


def sort_dedup_patch(opt: MemOpt, bnt: BntSeq, query: np.ndarray,
                     regs: List[AlnReg], mat: np.ndarray) -> List[AlnReg]:
    """mem_sort_dedup_patch: drop redundant regions, merge colinear."""
    n = len(regs)
    if n <= 1:
        return regs
    regs.sort(key=lambda x: x.re)  # mem_ars2: by end position
    for p in regs:
        p.n_comp = 1
    for i in range(1, n):
        p = regs[i]
        if (p.rid != regs[i - 1].rid
                or p.rb >= regs[i - 1].re + opt.max_chain_gap):
            continue
        j = i - 1
        while (j >= 0 and p.rid == regs[j].rid
               and p.rb < regs[j].re + opt.max_chain_gap):
            q = regs[j]
            j -= 1
            if q.qe == q.qb:
                continue  # excluded
            or_ = q.re - p.rb
            oq = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            mr = min(q.re - q.rb, p.re - p.rb)
            mq = min(q.qe - q.qb, p.qe - p.qb)
            if or_ > opt.mask_level_redun * mr and \
                    oq > opt.mask_level_redun * mq:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                else:
                    q.qe = q.qb
            elif q.rb < p.rb:
                score, w = patch_reg(opt, bnt, query, q, p, mat)
                if score > 0:
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qe = q.qb
    regs = [r for r in regs if r.qe > r.qb]
    # mem_ars: score desc, rb, qb (pinned total order for determinism)
    regs.sort(key=lambda x: (-x.score, x.rb, x.qb))
    for i in range(1, len(regs)):
        if (regs[i].score == regs[i - 1].score
                and regs[i].rb == regs[i - 1].rb
                and regs[i].qb == regs[i - 1].qb):
            regs[i].qe = regs[i].qb
    return [r for r in regs if r.qe > r.qb]


# ----------------------- primary marking / MAPQ -------------------------

def _mark_primary_core(opt: MemOpt, regs: List[AlnReg], n: int) -> None:
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, n):
        placed = False
        for j in z:
            b_max = max(regs[j].qb, regs[i].qb)
            e_min = min(regs[j].qe, regs[i].qe)
            if e_min > b_max:
                min_l = min(regs[i].qe - regs[i].qb,
                            regs[j].qe - regs[j].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if regs[j].sub == 0:
                        regs[j].sub = regs[i].score
                    if (regs[j].score - regs[i].score <= tmp
                            and (regs[j].is_alt or not regs[i].is_alt)):
                        regs[i].secondary = j
                        placed = True
                        break
        if not placed:
            z.append(i)


def mark_primary(opt: MemOpt, regs: List[AlnReg], read_id: int) -> int:
    """mem_mark_primary_se; read_id seeds the deterministic tie-break
    hash. Returns n_pri."""
    n = len(regs)
    if n == 0:
        return 0
    n_pri = 0
    for i, r in enumerate(regs):
        r.sub = r.alt_sc = 0
        r.secondary = r.secondary_all = -1
        r.hash = hash_64(read_id + i)
        if not r.is_alt:
            n_pri += 1
    # mem_ars_hash: score desc, is_alt asc, hash asc
    regs.sort(key=lambda x: (-x.score, x.is_alt, x.hash))
    _mark_primary_core(opt, regs, n)
    for i, p in enumerate(regs):
        p.secondary_all = i
        if (not p.is_alt and p.secondary >= 0
                and regs[p.secondary].is_alt):
            p.alt_sc = regs[p.secondary].score
    if 0 <= n_pri < n:
        if n_pri > 0:
            # mem_ars_hash2: is_alt asc, then score desc, hash
            order = sorted(range(n),
                           key=lambda i: (regs[i].is_alt, -regs[i].score,
                                          regs[i].hash))
            regs[:] = [regs[i] for i in order]
        z = [0] * n
        for i in range(n):
            z[regs[i].secondary_all] = i
        for i in range(n):
            if regs[i].secondary >= 0:
                regs[i].secondary_all = z[regs[i].secondary]
                if regs[i].is_alt:
                    regs[i].secondary = 0x7FFFFFFF
            else:
                regs[i].secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                regs[i].sub = 0
                regs[i].secondary = -1
            _mark_primary_core(opt, regs, n_pri)
    else:
        for r in regs:
            r.secondary_all = r.secondary
    if opt.flag & MEM_F_PRIMARY5:
        _reorder_primary5(opt.T, regs)
    return n_pri


def _reorder_primary5(T: int, regs: List[AlnReg]) -> None:
    """mem_reorder_primary5 (-5): move the leftmost-on-query primary
    alignment with score >= T to slot 0 so split reads report their
    5'-most piece as the representative record."""
    n_pri = sum(1 for p in regs
                if p.secondary < 0 and not p.is_alt and p.score >= T)
    if n_pri <= 1:
        return
    left_st, left_k = 1 << 62, -1
    for k, p in enumerate(regs):
        if p.secondary >= 0 or p.is_alt or p.score < T:
            continue
        if p.qb < left_st:
            left_st, left_k = p.qb, k
    if left_k <= 0:
        return
    regs[0], regs[left_k] = regs[left_k], regs[0]
    for p in regs[1:]:
        if p.secondary == 0:
            p.secondary = left_k
        elif p.secondary == left_k:
            p.secondary = 0
        if p.secondary_all == 0:
            p.secondary_all = left_k
        elif p.secondary_all == left_k:
            p.secondary_all = 0


def approx_mapq(opt: MemOpt, a: AlnReg) -> int:
    """mem_approx_mapq_se — formula copied verbatim (SURVEY.md §3.1)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(sub, a.csub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(MEM_MAPQ_COEF * (1.0 - sub / a.score)
                   * math.log(a.seedcov) + 0.499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq
