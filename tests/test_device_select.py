"""Device selection, device-failure propagation and the compile cache
location: no path switches platform or falls back to the scalar path
after a device failure."""
import io
import os

import numpy as np
import pytest

import jax

from tpubwa import utils
from tpubwa.cli import main_index, main_mem
from tpubwa.device.pipeline import _pick_device


def test_pick_device_gpu_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU device"):
        _pick_device("gpu")


def test_pick_device_auto_is_jax_default_device():
    before = jax.config.jax_platforms
    assert _pick_device("auto") == jax.local_devices()[0]
    assert jax.config.jax_platforms == before


def test_pick_device_rejects_unknown_platform():
    with pytest.raises(ValueError):
        _pick_device("metal")


@pytest.fixture(scope="module")
def tiny_index(tmp_path_factory):
    rng = np.random.default_rng(4)
    d = tmp_path_factory.mktemp("sel")
    codes = rng.integers(0, 4, 5000)
    fa = d / "ref.fa"
    fa.write_text(">s1\n" + "".join("ACGT"[c] for c in codes) + "\n")
    assert main_index([str(fa)]) == 0
    fq = d / "r.fq"
    seq = "".join("ACGT"[c] for c in codes[100:200])
    fq.write_text(f"@r1\n{seq}\n+\n{'I' * 100}\n")
    return str(fa), str(fq)


def test_mem_device_gpu_raises_without_gpu(tiny_index):
    prefix, fq = tiny_index
    with pytest.raises(RuntimeError, match="no GPU device"):
        main_mem(["--device", "gpu", prefix, fq], out=io.StringIO())


def test_mem_propagates_aligner_construction_error(tiny_index,
                                                   monkeypatch):
    """A failing device aligner is an error: main_mem must not go on
    along the scalar path (it used to, under --device auto)."""
    import tpubwa.device.pipeline as dp

    def boom(*a, **kw):
        raise RuntimeError("device init failed")
    monkeypatch.setattr(dp, "make_device_aligner", boom)
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="device init failed"):
        main_mem(["--device", "auto", *tiny_index], out=out)
    assert not any(ln.startswith("r1\t")
                   for ln in out.getvalue().splitlines())


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert utils.compilation_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert utils.compilation_cache_dir() == os.path.join(repo,
                                                         ".jax_cache")


@pytest.mark.parametrize("env_dir", [True, False])
def test_enable_compilation_cache_sets_dir_only_without_env(
        monkeypatch, tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code;
    without it, the fixed in-checkout directory is.  The CPU is never
    cached."""
    set_calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_calls.append((k, v)))
    monkeypatch.delenv("TPUBWA_NO_COMPILE_CACHE", raising=False)
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(utils, "compilation_cache_dir",
                            lambda: str(tmp_path / "c"))
    utils.enable_compilation_cache("cpu")
    assert set_calls == []
    utils.enable_compilation_cache("gpu")
    dirs = [v for k, v in set_calls if k == "jax_compilation_cache_dir"]
    assert dirs == ([] if env_dir else [str(tmp_path / "c")])
    assert ("jax_persistent_cache_min_entry_size_bytes", -1) in set_calls
