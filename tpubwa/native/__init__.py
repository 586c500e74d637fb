"""Native (C++) runtime components, loaded via ctypes.

The reference keeps its performance-critical runtime in C (is.c SAIS,
kseq.h FASTQ, ksw.c fallback); this package provides the
equivalents, compiled on demand with g++ into a cache directory
inside the checkout (no pip/pybind dependency).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_CACHE = Path(os.environ.get("TPUBWA_NATIVE_CACHE",
                             _DIR.parent.parent / ".native_cache"))


def _build(src_name: str, tag: str, deps=()) -> Path:
    src = _DIR / src_name
    code = src.read_bytes()
    for d in deps:  # #included sources must invalidate the cache too
        code += (_DIR / d).read_bytes()
    h = hashlib.sha256(code).hexdigest()[:16]
    _CACHE.mkdir(parents=True, exist_ok=True)
    so = _CACHE / f"{tag}-{h}.so"
    if not so.exists():
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++20", str(src), "-o", str(so) + ".tmp"]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(str(so) + ".tmp", so)
    return so


_sais_lib = None


def _load_sais():
    global _sais_lib
    if _sais_lib is None:
        lib = ctypes.CDLL(str(_build("sais.cpp", "sais")))
        lib.tpubwa_sais_u8.restype = ctypes.c_int
        lib.tpubwa_sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        _sais_lib = lib
    return _sais_lib


def sais_int(codes: np.ndarray) -> np.ndarray:
    """Suffix array of codes (values 0..3) + implicit sentinel;
    returns int64[n+1] with sa[0] == n.  C SA-IS fast path for
    tpubwa.index.sa.suffix_array."""
    lib = _load_sais()
    n = len(codes)
    text = np.empty(n + 1, dtype=np.uint8)
    text[:n] = codes + 1  # shift so the appended sentinel 0 is unique
    text[n] = 0
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.tpubwa_sais_u8(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n + 1),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(int(text.max()) + 1))
    if rc != 0:
        raise RuntimeError(f"sais failed: {rc}")
    return sa


_ksw_lib = None


def load_ksw():
    """ctypes handle to the native SW kernels (ksw.cpp); raises on
    build failure — callers treat any exception as 'use NumPy'."""
    global _ksw_lib
    if _ksw_lib is None:
        lib = ctypes.CDLL(str(_build("ksw.cpp", "ksw")))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i32 = ctypes.c_int32
        lib.tpubwa_ksw_global.restype = ctypes.c_int
        lib.tpubwa_ksw_global.argtypes = [
            i32, u8p, i32, u8p, i32, i32p, i32, i32, i32, i32, i32,
            i32, i32p, i32p, i32, i32p]
        lib.tpubwa_ksw_extend.restype = None
        lib.tpubwa_ksw_extend.argtypes = [
            i32, u8p, i32, u8p, i32, i32p, i32, i32, i32, i32, i32,
            i32, i32, i32, i32p]
        lib.tpubwa_ksw_align.restype = None
        lib.tpubwa_ksw_align.argtypes = [
            i32, u8p, i32, u8p, i32, i32p, i32, i32, i32, i32, i32,
            i32, i32p]
        _ksw_lib = lib
    return _ksw_lib


_fastq_lib = None


def load_fastq():
    """ctypes handle to the native FASTQ/FASTA batch reader
    (fastq.cpp); raises on build failure — callers treat any exception
    as 'use the Python parser'."""
    global _fastq_lib
    if _fastq_lib is None:
        src = _DIR / "fastq.cpp"
        code = src.read_bytes()
        h = hashlib.sha256(code).hexdigest()[:16]
        _CACHE.mkdir(parents=True, exist_ok=True)
        so = _CACHE / f"fastq-{h}.so"
        if not so.exists():
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-std=c++20", str(src), "-lz", "-o", str(so) + ".tmp"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(str(so) + ".tmp", so)
        lib = ctypes.CDLL(str(so))
        lib.tpubwa_fq_open.restype = ctypes.c_void_p
        lib.tpubwa_fq_open.argtypes = [ctypes.c_char_p]
        lib.tpubwa_fq_close.argtypes = [ctypes.c_void_p]
        i64 = ctypes.c_int64
        i64p = ctypes.POINTER(i64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        cp = ctypes.c_char_p
        lib.tpubwa_fq_read_batch.restype = i64
        lib.tpubwa_fq_read_batch.argtypes = [
            ctypes.c_void_p, i64, i64,
            u8p, i64, i64p, cp, i64, i64p, cp, i64, i64p,
            cp, i64, i64p, u8p]
        lib.tpubwa_fq_seek.restype = i64
        lib.tpubwa_fq_seek.argtypes = [ctypes.c_void_p, i64]
        _fastq_lib = lib
    return _fastq_lib


_bwacore_lib = None


def load_bwacore():
    """ctypes handle to the native emit phase (bwacore.cpp)."""
    global _bwacore_lib
    if _bwacore_lib is None:
        lib = ctypes.CDLL(str(_build("bwacore.cpp", "bwacore",
                                     deps=("ksw.cpp",))))
        lib.tpubwa_emit_batch.restype = ctypes.c_int64
        lib.tpubwa_chain_batch.restype = ctypes.c_int
        lib.tpubwa_plan_init.restype = ctypes.c_void_p
        lib.tpubwa_plan_next_wave.restype = ctypes.c_int64
        lib.tpubwa_plan_next_wave.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64]
        lib.tpubwa_plan_feed.restype = None
        lib.tpubwa_plan_feed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.tpubwa_plan_spec_jobs.restype = ctypes.c_int64
        lib.tpubwa_plan_spec_jobs.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64]
        lib.tpubwa_plan_feed_spec.restype = None
        lib.tpubwa_plan_feed_spec.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.tpubwa_plan_regions.restype = ctypes.c_int64
        lib.tpubwa_plan_free.restype = None
        lib.tpubwa_plan_free.argtypes = [ctypes.c_void_p]
        _bwacore_lib = lib
    return _bwacore_lib


_smem_lib = None


def load_smem():
    """ctypes handle to the native scalar SMEM module (smem.cpp) —
    the production host fallback for overflow tails and oversize
    reads (ref/smem.py stays the independent Python oracle)."""
    global _smem_lib
    if _smem_lib is None:
        lib = ctypes.CDLL(str(_build("smem.cpp", "smem")))
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(i64)
        lib.tpubwa_smem_init.restype = ctypes.c_void_p
        lib.tpubwa_smem_init.argtypes = [u32p, u32p, i64p, i64, i64]
        lib.tpubwa_smem_free.restype = None
        lib.tpubwa_smem_free.argtypes = [ctypes.c_void_p]
        lib.tpubwa_smem_collect.restype = i64
        lib.tpubwa_smem_collect.argtypes = [
            ctypes.c_void_p, u8p, i64, i64, i64, i64, i64, i64p, i64]
        lib.tpubwa_smem_collect_batch.restype = i64
        lib.tpubwa_smem_collect_batch.argtypes = [
            ctypes.c_void_p, u8p, i64, i32p, i64, i64, i64, i64, i64,
            i64, i64p, i64]
        lib.tpubwa_smem_jobs.restype = i64
        lib.tpubwa_smem_jobs.argtypes = [
            ctypes.c_void_p, u8p, i64, i32p, i64p, i64, i64, i64, i64,
            i64p, i64]
        lib.tpubwa_sa_init.restype = None
        lib.tpubwa_sa_init.argtypes = [ctypes.c_void_p, u32p, i64p,
                                       i64]
        lib.tpubwa_sa_positions.restype = i64
        lib.tpubwa_sa_positions.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64, i64, i64, i64p, i64,
            i64p]
        _smem_lib = lib
    return _smem_lib
