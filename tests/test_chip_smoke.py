"""chip_smoke.py: its phases rehearsed at a tiny size on the CPU, its
refusal to run without a GPU, and (marked ``chip``) the same
equalities at the real size on a GPU."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Config(genome_bp=300_000, ext_jobs=24, seed_reads=128,
                         e2e_pairs=96, cmp_pairs=32)


@pytest.fixture(scope="module")
def tiny_ref():
    import tpubwa.device  # noqa: F401  (x64)
    from tpubwa.device.occ import DeviceIndex
    fmi = chip_smoke.make_reference(TINY)
    return fmi, DeviceIndex.from_fmindex(fmi)


def test_smoke_extend_phase_on_cpu(tiny_ref):
    assert chip_smoke.phase_extend(*tiny_ref, TINY.ext_jobs) == 0


def test_smoke_seed_phase_on_cpu(tiny_ref):
    assert chip_smoke.phase_seed(*tiny_ref, TINY.seed_reads) == 0


def test_smoke_ext_wave_shapes():
    """The extend phase's waves hit both lane buckets and the 1024
    target bucket, on both strands, with windows inside one strand."""
    from tpubwa.device.extend import width_for
    fmi = chip_smoke.make_reference(TINY)
    lp = fmi.bnt.l_pac
    rng = np.random.default_rng(1)
    for read_len, max_t, W, tm in ((100, 250, 128, 256),
                                   (250, 1000, 256, 1024)):
        reads, d = chip_smoke.ext_wave(fmi.bnt, rng, 32, read_len, max_t)
        side = np.maximum(d[:, 1], d[:, 3] - d[:, 1] - d[:, 2])
        assert width_for(int(side.max())) == W
        tgt = np.maximum(d[:, 4] - d[:, 5], d[:, 6] - d[:, 4] - d[:, 2])
        assert tm // 2 < tgt.max() <= tm
        rev = d[:, 4] >= lp
        assert rev.any() and (~rev).any()
        assert np.all((d[:, 5] >= lp) == rev)
        assert np.all((d[:, 6] <= lp) | rev)


def test_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_rejects_unknown_option(capsys):
    assert chip_smoke.main(["--eight"]) == 2
    assert '"ok"' not in capsys.readouterr().out


# ---- on a GPU, at the real size ------------------------------------

@pytest.fixture(scope="module")
def gpu_ref(gpu):
    import tpubwa.device  # noqa: F401  (x64)
    from tpubwa.device.occ import DeviceIndex
    from tpubwa.utils import enable_compilation_cache
    enable_compilation_cache(gpu.platform)
    fmi = chip_smoke.make_reference(chip_smoke.Config())
    return fmi, DeviceIndex.from_fmindex(fmi, device=gpu)


@pytest.mark.chip
def test_chip_extend_equality(gpu_ref):
    assert chip_smoke.phase_extend(*gpu_ref,
                                   chip_smoke.Config.ext_jobs) == 0


@pytest.mark.chip
def test_chip_megaq_equality(gpu_ref):
    assert chip_smoke.phase_seed(*gpu_ref,
                                 chip_smoke.Config.seed_reads) == 0


@pytest.mark.chip
def test_chip_e2e_sam_equality(gpu_ref, tmp_path):
    cfg = chip_smoke.Config()
    assert chip_smoke.phase_e2e(gpu_ref[0], str(tmp_path),
                                cfg.e2e_pairs, cfg.cmp_pairs) == 0
