"""Test config: the CPU backend with 8 virtual devices, so sharding
logic is exercised without accelerators (SURVEY.md §4 item 4), unless
JAX_PLATFORMS is set.  Tests marked ``chip`` need a GPU: they decide in
a fixture whether one is present and skip otherwise.  On a GPU machine:
JAX_PLATFORMS=cuda python -m pytest tests -m chip"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU; skips without one (run with "
        "JAX_PLATFORMS=cuda python -m pytest tests -m chip)")


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (JAX found "
                    f"{jax.devices()[0].platform})")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xB3A)


def make_genome(rng, length, n_runs=0, n_chroms=1):
    """Random FASTA text with optional N runs, as (str, list[str] seqs)."""
    lines = []
    seqs = []
    per = length // n_chroms
    for c in range(n_chroms):
        codes = rng.integers(0, 4, per)
        bases = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
        for _ in range(n_runs):
            s = int(rng.integers(0, max(1, per - 10)))
            ln = int(rng.integers(1, 8))
            bases[s:s + ln] = ord("N")
        seq = bases.tobytes().decode()
        seqs.append(seq)
        lines.append(f">chr{c + 1} test")
        for i in range(0, len(seq), 70):
            lines.append(seq[i:i + 70])
    return "\n".join(lines) + "\n", seqs


@pytest.fixture()
def small_fasta(tmp_path, rng):
    text, seqs = make_genome(rng, 2000, n_runs=3, n_chroms=2)
    p = tmp_path / "ref.fa"
    p.write_text(text)
    return str(p), seqs
