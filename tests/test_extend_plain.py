"""The plain-JAX extension row loop (device/extend.py:extend_rows) vs
the scalar oracle: the dict-job adapter, the fused per-seed passes at
the widest buckets, and the shard_map wrapper."""
import numpy as np
import pytest

import tpubwa.device  # noqa: F401
from tpubwa.device.extend import _mat_ab, extend_rows, extend_rows_np
from tpubwa.device.extend_fused import extend_seed_batch_np, scalar_fused
from tpubwa.opts import MemOpt
from tpubwa.ref.ksw import ksw_extend
from test_device_extend import _mk_jobs


def test_mat_ab():
    opt = MemOpt()
    assert _mat_ab(opt.scoring_matrix()) == (1, 4)
    assert _mat_ab(MemOpt(a=2, b=9).scoring_matrix()) == (2, 9)
    m = opt.scoring_matrix().astype(np.int32)
    m[1, 2] = 7
    assert _mat_ab(m) is None


def _want(j, mat, opt, zdrop):
    r = ksw_extend(len(j["q"]), j["q"], len(j["t"]), j["t"], mat,
                   opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, j["w"],
                   j["end_bonus"], zdrop, j["h0"])
    return (r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off)


@pytest.mark.parametrize("zdrop", [0, 100])
def test_plain_matches_oracle(zdrop):
    rng = np.random.default_rng(99 + zdrop)
    opt = MemOpt()
    mat = opt.scoring_matrix().astype(np.int32)
    jobs = _mk_jobs(rng, 80, opt)
    got = extend_rows_np(jobs, mat, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins, zdrop, qmax=128, tmax=256)
    for i, j in enumerate(jobs):
        g = tuple(int(x[i]) for x in got)
        assert g == _want(j, mat, opt, zdrop), i


def test_plain_nonstandard_matrix_falls_back():
    rng = np.random.default_rng(3)
    opt = MemOpt()
    mat = opt.scoring_matrix().astype(np.int32)
    mat[0, 1] = -2  # break scmat structure -> extend_batch fallback
    jobs = _mk_jobs(rng, 10, opt)
    got = extend_rows_np(jobs, mat, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins, 100, qmax=128, tmax=256)
    for i, j in enumerate(jobs):
        assert int(got[0][i]) == _want(j, mat, opt, 100)[0]


def _long_job(rng, l_query, max_t):
    """A seed in a long query with long, partly echoed targets on both
    sides (W=256 lanes, targets past 512 -> the 1024 bucket)."""
    qbeg = int(rng.integers(0, l_query - 40))
    slen = int(rng.integers(19, 40))
    qe = qbeg + slen
    q = rng.integers(0, 4, l_query).astype(np.uint8)
    tlen_l = int(rng.integers(qbeg, max_t)) if qbeg else 0
    tlen_r = int(rng.integers(l_query - qe, max_t)) if l_query - qe else 0
    tl = rng.integers(0, 4, max(tlen_l, 1)).astype(np.uint8)
    tr = rng.integers(0, 4, max(tlen_r, 1)).astype(np.uint8)
    if rng.random() < 0.7:
        n = min(tlen_l, qbeg)
        tl[:n] = q[:qbeg][::-1][:n]
        n = min(tlen_r, l_query - qe)
        tr[:n] = q[qe:][:n]
        for t in (tl, tr):
            mut = rng.random(len(t)) < 0.05
            t[mut] = (t[mut] + 1) % 4
    return (qbeg, q[:qbeg][::-1].copy(), tlen_l, tl[:tlen_l],
            l_query - qe, q[qe:].copy(), tlen_r, tr[:tlen_r],
            int(rng.choice([10, 100])), slen, 5, 5)


@pytest.mark.parametrize("zdrop", [0, 100])
def test_fused_wide_buckets_match_scalar(zdrop):
    """The fused passes at W=256 lanes and a 1024-wide target bucket,
    with a job count (70) that is not a multiple of the 64-job pad
    bucket, equal scalar_fused on every consumed lane."""
    opt = MemOpt()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(7 + zdrop)
    jobs = [_long_job(rng, 250, 1000) for _ in range(70)]
    assert max(max(j[0], j[4]) for j in jobs) >= 128
    assert max(max(j[2], j[6]) for j in jobs) > 512
    got = extend_seed_batch_np(jobs, mat, opt.o_del, opt.e_del,
                               opt.o_ins, opt.e_ins, zdrop, 511, 1024)
    assert got.shape == (70, 16)
    for i, j in enumerate(jobs):
        want = scalar_fused(j, mat, opt.o_del, opt.e_del, opt.o_ins,
                            opt.e_ins, zdrop)
        if j[0] > 0:
            assert got[i, :6].tolist() == want[:6].tolist(), i
            assert got[i, 12] == want[12], i
        if j[4] > 0:
            assert got[i, 6:12].tolist() == want[6:12].tolist(), i
            assert got[i, 13] == want[13], i
        assert got[i, 14:].tolist() == want[14:].tolist(), i


def test_shard_map_extend_equals_one_device():
    """DataParallel.shard_map_extend over 4 devices: each runs the row
    loop to its own jobs' exit; results equal the unsharded call."""
    import jax
    import jax.numpy as jnp
    from tpubwa.dist.sharding import DataParallel
    opt = MemOpt()
    rng = np.random.default_rng(11)
    jobs = _mk_jobs(rng, 64, opt)
    q = np.full((64, 128), 4, np.int32)
    t = np.full((64, 256), 4, np.int32)
    cols = np.zeros((5, 64), np.int32)
    for i, j in enumerate(jobs):
        q[i, :len(j["q"])] = j["q"]
        t[i, :len(j["t"])] = j["t"]
        cols[:, i] = (len(j["q"]), len(j["t"]), j["h0"], j["w"],
                      j["end_bonus"])
    args = [jnp.asarray(x) for x in (q, t, *cols)]
    pen = (opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
           opt.zdrop)
    dp = DataParallel.over(jax.devices()[:4])
    got = dp.shard_map_extend(*pen)(*(dp.sharded(x) for x in args))
    want = extend_rows(*args, *pen)
    assert np.asarray(got).tolist() == np.asarray(want).tolist()
