#!/usr/bin/env python
"""Smoke run of tpubwa's main alignment path on one GPU, in one process.

Builds a 64 Mbp repeat-realistic reference (tpubwa/sim.py, fixed seed)
and its FM-index in the run, then checks on the card:

  device  platform, device kind and count; the card's name and power
          limit from nvidia-smi; XLA_FLAGS and the host core count
  extend  descriptor-mode fused extension (extend_seed_desc_np) equal
          to scalar_fused on >= 1,500 jobs cut from the genome: 128 and
          256 lanes, targets up to 1024, zdrop 0 and 100, band-doubling
          retries included; every value is an integer, tolerance 0
  seed    the megaq seeding machine equal to the native host seeder on
          8,192 reads: interval rows and fused SA positions
  e2e     `tpubwa mem --device gpu` on 16,384 simulated 2x100 bp pairs
          in two batches, in the default seed mode and with
          TPUBWA_SEED_MODE=megaq: SAM equal between the two, and equal
          record for record to `--device scalar` on the first 2,048
          pairs
  memory  compiled memory analysis of the extension and megaq programs
          and the card's peak bytes in use

The times it prints are those of a smoke run, not a benchmark.

Usage:
  python chip_smoke.py           one GPU, every phase above
  python chip_smoke.py --four    four GPUs: DeviceAligner over a ('dp',)
                                 and a ('dp','tp') mesh, each SAM-equal
                                 to the one-card run; no other phase

Exits nonzero, printing no result, when JAX finds no GPU or any phase
fails.  The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


@dataclass(frozen=True)
class Config:
    genome_bp: int = 64_000_000
    genome_seed: int = 3
    ext_jobs: int = 400          # per wave; 4 waves (2 widths x 2 zdrops)
    seed_reads: int = 8192
    e2e_pairs: int = 16384       # two batches
    cmp_pairs: int = 2048        # compared with --device scalar
    four_pairs: int = 2048       # --four, ('dp',) mesh
    four_tp_pairs: int = 256     # --four, ('dp','tp') mesh


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_device(jax) -> dict:
    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    for line in smi.splitlines():
        log(f"[device] nvidia-smi: {line}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"host_cores={len(os.sched_getaffinity(0))}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def make_reference(cfg: Config):
    from tpubwa.index import FMIndex
    from tpubwa.sim import make_bench_bnt
    t0 = time.perf_counter()
    bnt = make_bench_bnt(cfg.genome_bp, np.random.default_rng(
        cfg.genome_seed), realistic=True)
    fmi = FMIndex.build(bnt)
    log(f"[setup] {cfg.genome_bp} bp repeat-realistic reference and "
        f"index built in {time.perf_counter() - t0:.1f} s")
    return fmi


def ext_wave(bnt, rng, n: int, read_len: int, max_t: int):
    """n descriptor jobs, one read each, cut from the genome on both
    strands.  Reads carry SNPs and, for about half, a small indel, so
    extensions drift off the diagonal and some retry with a doubled
    band.  Returns (reads uint8 [n, read_len], desc int64 [n, 11])."""
    from tpubwa.sim import _mutate_read
    lp = bnt.l_pac
    reads = np.zeros((n, read_len), np.uint8)
    rows = []
    while len(rows) < n:
        lo, hi = (lp, 2 * lp) if len(rows) % 2 else (0, lp)
        p = int(rng.integers(lo + max_t + 8, hi - read_len - max_t - 8))
        win = bnt.get_seq(p, p + read_len + 8)
        r = _mutate_read(win[:read_len].copy(), rng, 0.02,
                         0.5 / read_len, read_len, win, 0)
        eq = np.concatenate([[0], (r == win[:read_len]).astype(np.int8),
                             [0]])
        d = np.diff(eq)
        starts, ends = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
        k = int(np.argmax(ends - starts))
        if ends[k] - starts[k] < 19:
            continue
        qbeg = int(starts[k])
        slen = int(min(ends[k] - starts[k], rng.integers(19, 41)))
        qr = read_len - qbeg - slen
        rbeg = p + qbeg
        tl = int(rng.integers(qbeg, max_t + 1)) if qbeg else 0
        tr = int(rng.integers(qr, max_t + 1)) if qr else 0
        w = int(rng.choice([5, 10, 25, 100]))
        reads[len(rows)] = r
        rows.append((len(rows), qbeg, slen, read_len, rbeg, rbeg - tl,
                     rbeg + slen + tr, w, slen, 5, 5))
    return reads, np.asarray(rows, np.int64)


def _materialize(bnt, reads, d):
    """The scalar job tuple of one descriptor row (as
    device.dispatch.WaveExtender._materialize builds it)."""
    ri, qbeg, slen, lq, rbeg, rmax0, rmax1 = (int(x) for x in d[:7])
    query = reads[ri][:lq]
    qe = qbeg + slen
    empty = query[:0]
    if qbeg:
        ql, tll, tl = query[:qbeg][::-1].copy(), rbeg - rmax0, \
            bnt.get_seq(rmax0, rbeg)[::-1].copy()
    else:
        ql, tll, tl = empty, 0, empty
    if lq - qe:
        tlr, tr = rmax1 - rbeg - slen, bnt.get_seq(rbeg + slen, rmax1)
    else:
        tlr, tr = 0, empty
    return (qbeg, ql, tll, tl, lq - qe, query[qe:], tlr, tr,
            int(d[7]), int(d[8]), int(d[9]), int(d[10]))


def _consumed_mismatch(got, want, job) -> bool:
    """Compare the lanes the host consumes (left tuple when there is a
    left part, right tuple when there is a right part, chained
    scores always)."""
    bad = False
    if job[0] > 0:
        bad |= got[:6].tolist() != want[:6].tolist() or got[12] != want[12]
    if job[4] > 0:
        bad |= (got[6:12].tolist() != want[6:12].tolist()
                or got[13] != want[13])
    return bad or got[14] != want[14] or got[15] != want[15]


def phase_extend(fmi, didx, n_per_wave: int, seed: int = 0xE7) -> int:
    """Four waves: (read length, target cap) giving 128 and 256 lanes
    and 256- and 1024-wide targets, each at zdrop 0 and 100.  Returns
    the number of mismatching jobs."""
    from tpubwa.device.extend_fused import (extend_seed_desc_np,
                                            scalar_fused)
    from tpubwa.opts import MemOpt
    opt = MemOpt()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(seed)
    bad = n_jobs = n_retry = 0
    for read_len, max_t in ((100, 250), (250, 1000)):
        reads, desc = ext_wave(fmi.bnt, rng, n_per_wave, read_len, max_t)
        for zdrop in (0, 100):
            args = (didx, reads, desc, mat, opt.o_del, opt.e_del,
                    opt.o_ins, opt.e_ins, zdrop, 1024)
            extend_seed_desc_np(*args)                  # compile
            t0 = time.perf_counter()
            got = extend_seed_desc_np(*args)
            dt = time.perf_counter() - t0
            wbad = 0
            for i, d in enumerate(desc):
                job = _materialize(fmi.bnt, reads, d)
                want = scalar_fused(job, mat, opt.o_del, opt.e_del,
                                    opt.o_ins, opt.e_ins, zdrop)
                if _consumed_mismatch(got[i], want, job):
                    wbad += 1
                    if wbad <= 3:
                        log(f"[extend] MISMATCH job {d.tolist()}: got "
                            f"{got[i].tolist()} want {want.tolist()}")
            retry = int(np.count_nonzero((got[:, 12] != desc[:, 7])
                                         | (got[:, 13] != desc[:, 7])))
            log(f"[extend] read_len={read_len} max_target={max_t} "
                f"zdrop={zdrop}: {len(desc)} jobs, {wbad} mismatches, "
                f"{retry} band-doubling retries, smoke wave "
                f"{dt * 1e3:.1f} ms")
            bad += wbad
            n_jobs += len(desc)
            n_retry += retry
    log(f"[extend] {n_jobs} jobs, {bad} mismatches, {n_retry} retries")
    if not n_retry:
        log("[extend] FAILED: no band-doubling retry was exercised")
        bad += 1
    return bad


def _pack(reads):
    L = 32
    while L < max(r.l_seq for r in reads):
        L <<= 1
    arr = np.full((len(reads), L), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        arr[i, :r.l_seq] = r.seq
        lens[i] = r.l_seq
    return arr, lens


def phase_seed(fmi, didx, n_reads: int, seed: int = 0x5EED) -> int:
    """megaq machine vs the native host seeder: interval rows, read
    ids, and the SA positions the machine fused.  Returns the number
    of mismatches."""
    from tpubwa.device.smem import collect_intv_device
    from tpubwa.device.smem_split import SEED_STATS
    from tpubwa.host.native_smem import _lib, sa_positions_native
    from tpubwa.opts import MemOpt
    from tpubwa.sim import simulate_pe
    if _lib() is None:
        log("[seed] FAILED: the native host seeder did not build")
        return 1
    opt = MemOpt()
    reads = simulate_pe(fmi.bnt, n_reads // 2, 100,
                        np.random.default_rng(seed))
    arr, lens = _pack(reads)

    def run(mode):
        return collect_intv_device(opt, didx, arr, lens, fmi=fmi,
                                   mode=mode, return_flat=True,
                                   return_sa=True)
    run("megaq")                                        # compile
    SEED_STATS.clear()
    t0 = time.perf_counter()
    flat_d, frid_d, (cnt_d, pos_d) = run("megaq")
    dt = time.perf_counter() - t0
    rounds = sum(s[3] for s in SEED_STATS if s[0] == "megaq")
    flat_h, frid_h, _ = run("host")
    bad = 0
    if not (np.array_equal(flat_d, flat_h)
            and np.array_equal(frid_d, frid_h)):
        log(f"[seed] MISMATCH interval rows: {len(flat_d)} device vs "
            f"{len(flat_h)} host")
        return 1
    pos_h, cnt_h = sa_positions_native(fmi, flat_h, opt.max_occ)
    have = cnt_d >= 0
    if not np.array_equal(cnt_d[have], cnt_h[have]):
        bad += int(np.count_nonzero(cnt_d[have] != cnt_h[have]))
    else:
        off_h = np.concatenate([[0], np.cumsum(cnt_h)])[:-1][have]
        from tpubwa.device.smem_split import _row_offsets
        sel = np.repeat(off_h, cnt_h[have]) + _row_offsets(cnt_h[have])
        bad += int(np.count_nonzero(pos_h[sel] != pos_d))
    log(f"[seed] {len(reads)} reads: {len(flat_d)} interval rows, "
        f"{int(have.sum())} with fused SA positions, {bad} mismatches; "
        f"megaq smoke wall {dt * 1e3:.1f} ms over {rounds} machine "
        f"rounds")
    return bad


def _write_fastq(path, reads):
    with open(path, "w") as fh:
        for r in reads:
            fh.write(f"@{r.name}\n"
                     f"{''.join('ACGTN'[c] for c in r.seq)}\n+\n"
                     f"{r.qual}\n")


def _mem(argv, env=None):
    """One `tpubwa mem` run in this process.  Returns (SAM lines without
    @PG, the metrics 'done' event, wall seconds)."""
    from tpubwa.cli import main_mem
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with tempfile.NamedTemporaryFile("r", suffix=".jsonl") as mf:
            out = io.StringIO()
            t0 = time.perf_counter()
            if main_mem(["--metrics", mf.name] + argv, out=out) != 0:
                raise RuntimeError(f"tpubwa mem {argv} failed")
            wall = time.perf_counter() - t0
            done = [json.loads(x) for x in mf.read().splitlines()
                    if '"done"' in x][-1]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sam = [x for x in out.getvalue().splitlines()
           if not x.startswith("@PG")]
    return sam, done, wall


def _first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"line {i}: {x[:120]!r} vs {y[:120]!r}"
    return f"lengths {len(a)} vs {len(b)}"


def phase_e2e(fmi, workdir: str, n_pairs: int, n_cmp: int,
              device: str = "gpu", seed: int = 0xE2E) -> int:
    """`tpubwa mem` end to end: default seed mode and megaq on the same
    two batches, then the first n_cmp pairs against --device scalar.
    Returns the number of failed comparisons."""
    from tpubwa.sim import simulate_pe
    prefix = os.path.join(workdir, "ref")
    fmi.save(prefix)
    reads = simulate_pe(fmi.bnt, n_pairs, 100,
                        np.random.default_rng(seed))
    fq = [os.path.join(workdir, f"r{i}.fq") for i in (1, 2)]
    _write_fastq(fq[0], reads[0::2])
    _write_fastq(fq[1], reads[1::2])
    cq = [os.path.join(workdir, f"c{i}.fq") for i in (1, 2)]
    _write_fastq(cq[0], reads[0:2 * n_cmp:2])
    _write_fastq(cq[1], reads[1:2 * n_cmp:2])
    # -K in bases: half the input per batch -> two batches
    two = ["-K", str(n_pairs * 100), "--device", device, prefix] + fq
    bad = 0
    sams = {}
    for label, env in (("default", None),
                       ("megaq", {"TPUBWA_SEED_MODE": "megaq"})):
        sam, done, wall = _mem(two, env)
        sams[label] = sam
        log(f"[e2e] {label}: {2 * n_pairs} reads in {wall:.1f} s "
            f"({2 * n_pairs / wall:.0f} reads/s, smoke run incl. "
            f"compiles, not a benchmark); seeded on the device: "
            f"{done.get('dev_seeded_reads')} reads; extension "
            f"{done.get('ext_waves')} waves / {done.get('ext_jobs')} "
            f"jobs; {done.get('device')}")
    if sams["default"] != sams["megaq"]:
        log(f"[e2e] MISMATCH default vs megaq SAM: "
            f"{_first_diff(sams['default'], sams['megaq'])}")
        bad += 1
    dev, _, _ = _mem(["--device", device, prefix] + cq)
    ref, _, wall = _mem(["--device", "scalar", prefix] + cq)
    n_rec = sum(1 for x in ref if not x.startswith("@"))
    if dev != ref:
        log(f"[e2e] MISMATCH device vs scalar SAM: "
            f"{_first_diff(dev, ref)}")
        bad += 1
    log(f"[e2e] first {n_cmp} pairs: {n_rec} SAM records, device "
        f"{'==' if dev == ref else '!='} scalar (scalar {wall:.1f} s)")
    return bad


def phase_memory(jax, fmi, didx) -> None:
    """memory_analysis() of the extension and megaq programs at the
    e2e shapes, and the card's peak bytes in use so far."""
    import jax.numpy as jnp
    from tpubwa.device.extend_fused import extend_seed_desc
    from tpubwa.device.smem_fused import smem_chunk_machine_q
    from tpubwa.device.smem_split import _stack_P
    from tpubwa.opts import MemOpt
    opt = MemOpt()
    N, B, L = 8192, 8192, 128
    qd = jnp.zeros((B, L), jnp.uint8)
    desc = jnp.zeros((N, 11), didx.idt)
    ext = extend_seed_desc.lower(
        didx, qd, desc, opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins,
        opt.e_ins, opt.zdrop, 128, 256, True).compile()
    jobs = jnp.zeros((B, 8), didx.idt)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    mq = smem_chunk_machine_q.lower(
        didx, qd, jnp.zeros(B, jnp.int32), jobs, _stack_P(didx), 12, 5,
        2 * B, 1, 1, opt.min_seed_len, split_len, opt.split_width,
        max_rounds_b=1024, P2=0, SCAPF=16, max_occ=opt.max_occ,
        qb_budget=0).compile()
    for name, c in (("extension (8192 jobs, W=128, tmax=256)", ext),
                    ("megaq (8192 reads)", mq)):
        m = c.memory_analysis()
        log(f"[memory] {name}: args {m.argument_size_in_bytes} B, "
            f"out {m.output_size_in_bytes} B, temp "
            f"{m.temp_size_in_bytes} B, code "
            f"{m.generated_code_size_in_bytes} B")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[memory] peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
        f"bytes_limit={stats.get('bytes_limit')}")


def phase_four(jax, fmi, cfg: Config, device: str = "gpu") -> int:
    """DeviceAligner over a ('dp',) and a ('dp','tp')=(1,4) mesh of the
    local GPUs, each SAM-equal to the one-card run on the same reads."""
    from jax.sharding import Mesh
    from tpubwa.device.pipeline import make_device_aligner
    from tpubwa.host.pipeline import process_seqs
    from tpubwa.opts import MEM_F_PE, MemOpt
    from tpubwa.sim import simulate_pe
    devs = jax.local_devices()
    opt = MemOpt(flag=MEM_F_PE)
    reads = simulate_pe(fmi.bnt, cfg.four_pairs, 100,
                        np.random.default_rng(0xF0))
    one = make_device_aligner(opt, fmi, platform=device)
    bad = 0
    for axes, shape, n in ((("dp",), (len(devs),), cfg.four_pairs),
                           (("dp", "tp"), (1, len(devs)),
                            cfg.four_tp_pairs)):
        mesh = Mesh(np.array(devs).reshape(shape), axes)
        part = reads[:2 * n]
        ref = process_seqs(opt, fmi, part, 0, align_fn=one)
        t0 = time.perf_counter()
        got = process_seqs(opt, fmi, part, 0,
                           align_fn=make_device_aligner(opt, fmi,
                                                        mesh=mesh))
        ok = got == ref
        bad += not ok
        log(f"[four] mesh {dict(zip(axes, shape))}: {len(got)} SAM "
            f"records from {len(part)} reads, "
            f"{'equal to' if ok else 'DIFFERENT from'} the one-card "
            f"run ({time.perf_counter() - t0:.1f} s incl. compiles)")
        if not ok:
            log(f"[four] first difference: {_first_diff(got, ref)}")
    return bad


# ---------------------------------------------------------------------

def run(cfg: Config, four: bool = False, device: str = "gpu") -> dict:
    """Every phase in this process; raises SystemExit(1) if any failed.
    Returns the device summary for the last line."""
    import jax
    import tpubwa.device  # noqa: F401  (x64)
    from tpubwa.device.occ import DeviceIndex
    from tpubwa.utils import enable_compilation_cache
    summary = phase_device(jax)
    enable_compilation_cache(summary["platform"])
    fmi = make_reference(cfg)
    failed = []

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            n_bad = fn(*a)
        except Exception:
            traceback.print_exc()
            n_bad = -1
        log(f"[{name}] {'PASSED' if not n_bad else 'FAILED'} in "
            f"{time.perf_counter() - t0:.1f} s")
        if n_bad:
            failed.append(name)

    if four:
        phase("four", phase_four, jax, fmi, cfg, device)
    else:
        dev = (jax.local_devices(backend=device)[0])
        didx = DeviceIndex.from_fmindex(fmi, device=dev)
        phase("extend", phase_extend, fmi, didx, cfg.ext_jobs)
        phase("seed", phase_seed, fmi, didx, cfg.seed_reads)
        with tempfile.TemporaryDirectory() as wd:
            phase("e2e", phase_e2e, fmi, wd, cfg.e2e_pairs,
                  cfg.cmp_pairs, device)
        phase("memory", lambda: phase_memory(jax, fmi, didx))
    if failed:
        log(f"[smoke] FAILED phases: {', '.join(failed)}")
        raise SystemExit(1)
    return summary


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    if set(argv) - {"--four"}:
        sys.stderr.write(__doc__)
        return 2
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.stderr.write(f"chip_smoke: needs a GPU; JAX found "
                         f"{platform!r}\n")
        return 1
    n = len(jax.devices())
    if four and n < 4:
        sys.stderr.write(f"chip_smoke --four: needs 4 GPUs, found {n}\n")
        return 1
    summary = run(Config(), four=four)
    print(json.dumps({"ok": True, "device": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
