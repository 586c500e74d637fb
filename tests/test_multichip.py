"""REAL pipeline on a multi-chip mesh == single-device run (VERDICT
round-1 item 3): DeviceAligner in data-parallel mesh mode (index
replicated, job arrays sharded over 'dp', extension row loop under
shard_map) must produce region-identical and SAM-identical output on
an 8-virtual-device CPU mesh."""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import tpubwa.device  # noqa: F401
from tpubwa.cli import main_index
from tpubwa.device.pipeline import make_device_aligner
from tpubwa.host.pipeline import process_seqs
from tpubwa.index import FMIndex
from tpubwa.io.fastq import Read
from tpubwa.opts import MEM_F_PE, MemOpt
from simread import simulate_pairs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    assert len(jax.devices()) == 8, "conftest must provide 8 devices"
    rng = np.random.default_rng(91)
    d = tmp_path_factory.mktemp("mchip")
    unit = rng.integers(0, 4, 40).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 15000).astype(np.uint8), np.tile(unit, 3),
        rng.integers(0, 4, 8000).astype(np.uint8)])
    bases = "".join("ACGT"[c] for c in codes)
    fa = d / "ref.fa"
    fa.write_text(">m1\n" + "\n".join(
        bases[i:i + 70] for i in range(0, len(bases), 70)) + "\n")
    assert main_index([str(fa)]) == 0
    fmi = FMIndex.load(str(fa))
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    return codes, fmi, mesh


def _pe_reads(codes, n_pairs, rng):
    sim = simulate_pairs(codes, n_pairs, 100, rng)
    reads = []
    code = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    for name, s1, s2, *_ in sim:
        reads.append(Read(name=name, seq=np.array(
            [code[c] for c in s1], np.uint8), qual="I" * len(s1)))
        reads.append(Read(name=name, seq=np.array(
            [code[c] for c in s2], np.uint8), qual="I" * len(s2)))
    return reads


def _regs_key(regs):
    return [(r.rb, r.re, r.qb, r.qe, r.rid, r.score, r.truesc, r.sub,
             r.csub, r.w, r.seedcov, round(r.frac_rep, 9))
            for r in regs]


def test_mesh_pipeline_equals_single_device(setup):
    codes, fmi, mesh = setup
    rng = np.random.default_rng(3)
    opt = MemOpt(flag=MEM_F_PE)
    reads = _pe_reads(codes, 40, rng)
    single = make_device_aligner(opt, fmi, platform="cpu")
    multi = make_device_aligner(opt, fmi, mesh=mesh)
    regs_s = single.align_batch(reads)
    regs_m = multi.align_batch(reads)
    assert [_regs_key(r) for r in regs_m] == \
        [_regs_key(r) for r in regs_s]
    # full SAM (pairing, rescue, MAPQ, tags) through the shared emit
    sam_s = process_seqs(opt, fmi, reads, 0, align_fn=single)
    sam_m = process_seqs(opt, fmi, reads, 0, align_fn=multi)
    assert sam_m == sam_s
    assert len(sam_m) >= len(reads)


def test_mesh_pipeline_mixed_and_repetitive(setup):
    """Repetitive + N-laden + unmappable reads through the mesh path
    (exercises overflow fallbacks and empty-region lanes)."""
    codes, fmi, mesh = setup
    rng = np.random.default_rng(5)
    opt = MemOpt()
    text = np.concatenate([codes, 3 - codes[::-1]])
    reads = []
    for t in range(12):
        start = int(rng.integers(0, len(codes) - 110))
        q = codes[start:start + 100].copy()
        for _ in range(int(rng.integers(0, 5))):
            q[int(rng.integers(0, 100))] = int(rng.integers(0, 5))
        reads.append(Read(name=f"x{t}", seq=q, qual=None))
    unit = codes[15000:15040]
    reads.append(Read(name="rep", seq=np.tile(unit, 3)[:100].copy(),
                      qual=None))
    reads.append(Read(name="junk",
                      seq=rng.integers(0, 4, 100).astype(np.uint8),
                      qual=None))
    q = codes[700:800].copy()
    q[50] = 4
    reads.append(Read(name="withN", seq=q, qual=None))
    single = make_device_aligner(opt, fmi, platform="cpu")
    multi = make_device_aligner(opt, fmi, mesh=mesh)
    regs_s = single.align_batch(reads)
    regs_m = multi.align_batch(reads)
    assert [_regs_key(r) for r in regs_m] == \
        [_regs_key(r) for r in regs_s]
