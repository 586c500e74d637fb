"""Descriptor-mode extension tile building vs the element-gather path
and the scalar oracle.

Round 4 replaced the per-base tile gathers (57% of the extend-desc
wall on the realistic corpus) with word gathers + select-shift window
extraction (device/extend_fused.py:_ref_window/_query_window).  These
tests pin the rewrite bit-exactly against the old element path and
scalar_fused, across the fwd/rev fold boundary, empty sides, N codes,
and the int16 result wire."""
import os

import numpy as np
import pytest

import tpubwa.device  # noqa: F401  (x64)
from tpubwa.device.extend_fused import (_extend_seed_desc_impl,
                                        extend_seed_desc_np,
                                        scalar_fused)
from tpubwa.device.occ import DeviceIndex
from tpubwa.index import FMIndex
from tpubwa.opts import MemOpt


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 37).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 2000).astype(np.uint8), np.tile(unit, 6),
        rng.integers(0, 4, 2000).astype(np.uint8)])
    p = tmp_path_factory.mktemp("desc") / "g.fa"
    p.write_text(">g\n" + "".join("ACGT"[c] for c in codes) + "\n")
    fmi = FMIndex.from_fasta(str(p))
    return fmi, DeviceIndex.from_fmindex(fmi), codes


def _mk_descs(rng, lp, B, L, n):
    """Random descriptors whose windows never cross l_pac (the
    extension_plan contract, host/regions.py:123) and include the
    edges: qbeg=0, qe=lq, rbeg at 0 / l_pac-1 / l_pac / 2*l_pac-1."""
    rows = []
    for k in range(n):
        lq = int(rng.integers(60, L + 1))
        qbeg = 0 if k % 7 == 0 else int(rng.integers(0, lq - 19))
        slen = int(rng.integers(19, min(40, lq - qbeg) + 1))
        if k % 5 == 0:
            slen = lq - qbeg          # qe == lq: no right side
        side_rev = k % 2
        lo, hi = (lp, 2 * lp) if side_rev else (0, lp)
        rbeg = int(rng.integers(lo, hi - slen))
        if k % 11 == 0:
            rbeg = lo                 # window start at the boundary
        if k % 11 == 1:
            rbeg = hi - slen          # window end at the boundary
        tl = int(rng.integers(0, 200)) if qbeg else 0
        tr = (int(rng.integers(0, 200))
              if lq - qbeg - slen else 0)
        rmax0 = max(lo, rbeg - tl)
        rmax1 = min(hi, rbeg + slen + tr)
        rows.append((int(rng.integers(0, B)), qbeg, slen, lq, rbeg,
                     rmax0, rmax1, 100, slen, 5, 5))
    return np.asarray(rows, np.int64)


def _materialize(bnt, reads, d):
    """WaveExtender._materialize for one descriptor row: the scalar
    job tuple the fused oracle consumes."""
    ri, qbeg, slen, lq, rbeg, rmax0, rmax1 = (int(x) for x in d[:7])
    query = reads[ri][:lq]
    qe = qbeg + slen
    qlen_r = lq - qe
    empty = query[:0]
    if qbeg:
        qs = query[:qbeg][::-1].copy()
        tlen_l = rbeg - rmax0
        ts = bnt.get_seq(rmax0, rbeg)[::-1].copy()
    else:
        qs, tlen_l, ts = empty, 0, empty
    if qlen_r:
        tlen_r = rmax1 - rbeg - slen
        tr = bnt.get_seq(rbeg + slen, rmax1)
    else:
        tlen_r, tr = 0, empty
    return (qbeg, qs, tlen_l, ts, qlen_r, query[qe:], tlen_r, tr,
            int(d[7]), int(d[8]), int(d[9]), int(d[10]))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tmax", [256, 250])
def test_word_path_equals_element_path(setup, seed, tmax):
    """The word-gather tile builder must produce the exact rows of the
    per-base gather path.  gather is now an explicit static argument
    (ADVICE r4: the env var used to be read at trace time); tmax=250
    exercises the non-multiple-of-16 strip bound fix."""
    import jax.numpy as jnp
    fmi, didx, codes = setup
    rng = np.random.default_rng(seed)
    opt = MemOpt()
    B, L = 16, 100
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads[0, 40] = 4   # N in a query
    da = _mk_descs(rng, fmi.bnt.l_pac, B, L, 64)
    desc = jnp.asarray(da.astype(didx.np_idt))
    qd = jnp.asarray(reads)
    args = (didx, qd, desc, opt.a, opt.b, opt.o_del, opt.e_del,
            opt.o_ins, opt.e_ins, opt.zdrop, 128, tmax)
    want = np.asarray(_extend_seed_desc_impl(*args, gather="element"))
    got = np.asarray(_extend_seed_desc_impl(*args, gather="word"))
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_desc_np_matches_scalar(setup, seed):
    """extend_seed_desc_np (word tiles, vectorized reorder, int16
    wire) vs scalar_fused on materialized jobs — the consumed lanes
    (same contract as test_extend_fused.test_fused_matches_scalar)."""
    fmi, didx, codes = setup
    rng = np.random.default_rng(10 + seed)
    opt = MemOpt()
    mat = opt.scoring_matrix()
    B, L = 16, 100
    # half the reads echo genome windows so high-score paths trigger
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    text = fmi.bnt.doubled()
    for i in range(0, B, 2):
        s = int(rng.integers(0, len(text) - L))
        reads[i] = text[s:s + L]
    da = _mk_descs(rng, fmi.bnt.l_pac, B, L, 48)
    got = extend_seed_desc_np(didx, np.asarray(reads), da, mat,
                              opt.o_del, opt.e_del, opt.o_ins,
                              opt.e_ins, opt.zdrop, 512)
    for i in range(len(da)):
        job = _materialize(fmi.bnt, reads, da[i])
        want = scalar_fused(job, mat, opt.o_del, opt.e_del, opt.o_ins,
                            opt.e_ins, opt.zdrop)
        if job[0] > 0:
            assert got[i, :6].tolist() == want[:6].tolist(), i
            assert got[i, 12] == want[12], i
        if job[4] > 0:
            assert got[i, 6:12].tolist() == want[6:12].tolist(), i
            assert got[i, 13] == want[13], i
        assert got[i, 14] == want[14], i
        assert got[i, 15] == want[15], i
