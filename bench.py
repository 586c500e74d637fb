#!/usr/bin/env python
"""tpubwa benchmark — end-to-end alignment throughput on one GPU.

Headline: end-to-end paired-end alignment throughput at GRCh38 SCALE
(3.1 Gbp repeat-realistic synthetic genome; BASELINE.json's metric is
"reads/sec/chip, 100bp PE, GRCh38").  Secondary rows quantify scale
and corpus effects (round-2 verdict items 2 & 4):

  grch38-realistic   3.1 Gbp, repeat-realistic corpus  <- HEADLINE
  64mb-realistic     chr20 scale, repeat-realistic
  64mb-uniform       chr20 scale, uniform-random (the round-1/2 row,
                     kept for trend; the realistic/uniform ratio IS
                     the measured flattery factor)

Indexes are cached under .bench_cache/ in the checkout (the 3.1 Gbp build is
~80 min, once per machine).  If the GRCh38 cache is absent and there
is no time to build it, the 64mb-realistic row becomes the headline
(the metric string says which).

Each row is median-of-3 timed runs in ONE process (index load and
XLA compile warmup excluded from timing; attempts recorded).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline":
   N/160000, "selection": "median-of-3", "attempts": [...],
   "rows": {...}, "gcups": N}
vs_baseline divides by the stock bwa-mem 32-core Xeon estimate from
SURVEY.md §6 (~1.6e5 reads/s); the BASELINE target is >= 1.5x => 240k.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_READS_PER_S = 160_000.0  # 32-core Xeon stock bwa-mem (SURVEY §6)
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
INNER_BUDGET_S = int(os.environ.get("TPUBWA_BENCH_BUDGET", "1500"))


def kernel_gcups(log, reps=16):
    """Plain-JAX extension row loop throughput (dense 100x200 jobs),
    mean over `reps` calls, each ended by block_until_ready."""
    import jax.numpy as jnp
    from tpubwa.device.extend import extend_rows
    rng = np.random.default_rng(0)
    N, QL, TL, TMAX = 512, 100, 200, 256
    tpl = rng.integers(0, 4, TL + N).astype(np.int32)
    q = np.full((N, 128), 4, np.int32)
    t = np.full((N, TMAX), 4, np.int32)
    for i in range(N):
        t[i, :TL] = tpl[i:i + TL]
        q[i, :QL] = tpl[i:i + QL]
    args = [jnp.asarray(x) for x in (
        q, t, np.full(N, QL, np.int32), np.full(N, TL, np.int32),
        np.full(N, 60, np.int32), np.full(N, 100, np.int32),
        np.full(N, 5, np.int32))]

    def run():
        return extend_rows(*args, 1, 4, 6, 1, 6, 1, 100)

    run().block_until_ready()               # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        run().block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    gcups = N * QL * TL / dt / 1e9
    log(f"[bench] extension row loop: {dt * 1e3:.2f} ms / {N} jobs "
        f"=> {gcups:.1f} GCUPS")
    return gcups


def measure_row(log, genome_mb, realistic, n_pairs_batch, n_batches=3,
                repeats=3, on_attempt=None):
    """One bench row: load cached index, warm the device programs on
    the measured shapes, then time `repeats` full pipeline passes.
    Returns (median_reads_per_s, attempts list) or None if the index
    cache is absent (the 3.1 Gbp build cannot fit a bench run)."""
    from tpubwa.host.pipeline import process_batches, process_seqs
    from tpubwa.opts import MEM_F_PE, MemOpt
    from tpubwa.sim import bench_index, simulate_pe
    prefix = os.path.join(
        CACHE, f"idx{genome_mb}m{'r' if realistic else ''}")
    if genome_mb > 256 and not (
            os.path.exists(prefix + ".tpubwa.npz")
            or os.path.exists(os.path.join(prefix + ".tpubwa.shm",
                                           "meta.json"))):
        log(f"[bench] no cached index {prefix}; skipping this row")
        return None
    fmi = bench_index(genome_mb, realistic=realistic, log=log)
    if genome_mb > 256:
        # the big-genome cache is mmap'd: after the 64 Mb rows evict
        # it from page cache, the native seeder's random access pays
        # major faults for most of reps 0-1 (dry run: 22.9/29.3/9.1 s
        # walls for identical reads).  One strided touch (one read
        # per 4 KB page) re-warms it at sequential-disk speed BEFORE
        # the timers start.
        t0 = time.time()
        for a in (fmi.bwt_words, fmi.occ_ckpt, fmi.sa_sample,
                  fmi.bnt.codes, fmi.sa_mark_rows, fmi.sa_marked):
            if a is not None:
                flat = a.reshape(-1)
                step = max(1, 4096 // flat.dtype.itemsize)
                np.asarray(flat[::step]).sum()
        log(f"[bench] index page-cache warmed in "
            f"{time.time() - t0:.1f}s")
    opt = MemOpt(flag=MEM_F_PE)
    rng = np.random.default_rng(1)
    from tpubwa.device.pipeline import make_device_aligner
    aligner = None
    for attempt in range(3):
        try:
            aligner = make_device_aligner(opt, fmi, platform="gpu")
            break
        except Exception as e:  # pragma: no cover
            log(f"[bench] device not ready ({e}); retrying")
            time.sleep(20)
    if aligner is None:
        log("[bench] device unavailable; failing fast")
        sys.exit(3)
    bnt = fmi.bnt
    # warmup: same chunk shapes as the measurement so every device
    # program compiles before the timed runs (the extension wave's
    # padded job count is shape-relevant)
    warm = simulate_pe(bnt, n_pairs_batch, 100, rng)
    t0 = time.time()
    # warmup through process_batches in TWO half batches so the
    # adaptive align-ahead gets its serial probe HERE — the flip is
    # process-sticky, so measured reps all run with the steady-state
    # schedule instead of rep 0 re-paying the probe (round-5: rep 0
    # measured 3,253 vs 4,064 steady on the realistic row)
    half = len(warm) // 2
    for _ in process_batches(opt, fmi,
                             iter([warm[:half], warm[half:]]), 0,
                             align_fn=aligner):
        pass
    log(f"[bench] warmup batch (compiles): {time.time() - t0:.1f}s")
    def link_rtt():
        """Median-of-3 tiny dispatch+sync round trip, in ms — run
        before each rep so attempt swings can be attributed to
        dispatch latency vs host/corpus effects."""
        import jax
        import jax.numpy as jnp
        x = jnp.zeros(8, jnp.int32)
        f = jax.jit(lambda v: v + 1)
        np.asarray(f(x))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(f(x))
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[1]

    from tpubwa.host.native_emit import emit_stats
    attempts = []
    for rep in range(repeats):
        batches = [simulate_pe(bnt, n_pairs_batch, 100, rng)
                   for _ in range(n_batches)]
        n_reads = sum(len(b) for b in batches)
        rtt = link_rtt()
        emit_stats(reset=True)
        w0 = aligner.extender.n_waves
        t0 = time.perf_counter()
        n_lines = 0
        for batch, lines in process_batches(opt, fmi, iter(batches), 0,
                                            align_fn=aligner):
            n_lines += len(lines)
        dt = time.perf_counter() - t0
        attempts.append(n_reads / dt)
        es = emit_stats() or {}
        emit_cpu = (es.get("matesw_ns", 0) + es.get("gen_alt_ns", 0)
                    + es.get("reg2aln_ns", 0) + es.get("aln2sam_ns", 0)
                    + es.get("mem_pair_ns", 0)
                    + es.get("mark_primary_ns", 0)) / 1e9
        log(f"[bench] row {genome_mb}Mb{'r' if realistic else ''} "
            f"rep {rep}: {n_reads} PE reads in {dt:.2f}s "
            f"({attempts[-1]:.0f} reads/s), {n_lines} records | "
            f"link_rtt {rtt:.1f}ms, emit-cpu {emit_cpu:.2f}s, "
            f"waves {aligner.extender.n_waves - w0}")
        if on_attempt is not None:
            # crash insurance: a wall-kill mid-row must not lose the
            # attempts already measured (round-4 lesson: the GRCh38
            # row is the budget-critical one)
            on_attempt(list(attempts))
    del aligner
    import gc
    gc.collect()   # release the row's device memory before the next
    # row's index upload
    return robust_median(attempts), attempts


def robust_median(attempts):
    """Median of the attempts within 2.5x of the best.

    Collapsed attempts are dropped
    before the median so one bad draw cannot halve the reported
    number — but only while the surviving attempts are at least HALF
    of the total: when most attempts collapsed, the plain median
    stands (a single fast draw must not represent a mostly-slow
    run).  All raw attempts are recorded alongside either way."""
    best = max(attempts)
    keep = sorted(a for a in attempts if a * 2.5 >= best)
    if len(keep) * 2 < len(attempts):
        keep = sorted(attempts)
    n = len(keep)
    return keep[n // 2] if n % 2 else \
        0.5 * (keep[n // 2 - 1] + keep[n // 2])


def run_all(log):
    t_start = time.time()
    out = {"rows": {}}
    try:
        out["gcups"] = kernel_gcups(log)
    except Exception as e:  # pragma: no cover
        log(f"[bench] GCUPS microbench failed ({e}); continuing")
        out["gcups"] = 0.0
    def attempt_cb(name):
        def cb(attempts):
            out["rows"][name] = (robust_median(attempts), attempts)
            _emit_partial(out)
        return cb

    # FAST row first: a wall-kill or a wedged GRCh38 attempt can then
    # never zero the headline (round-3 lesson: the 3.1 Gbp row ran
    # first, its index load blew the inner timeout, zero rows emitted).
    r = measure_row(log, 64, True, n_pairs_batch=8192,
                    on_attempt=attempt_cb("64mb-realistic"))
    if r:
        out["rows"]["64mb-realistic"] = r
        _emit_partial(out)
    # GRCh38-scale headline SECOND (round-5): with the shm cache
    # built at round start the whole row measures ~570 s (index mmap
    # ~0 s + ~8 GB HBM upload + warmup ~7 min + 3 reps x ~10 s), so
    # it fits the budget right after the fast insurance row; the
    # uniform trend row is the one to sacrifice under pressure.
    # Per-attempt persistence keeps partial results on a wall-kill.
    left = INNER_BUDGET_S - (time.time() - t_start)
    if left > 450:
        # 4 attempts: the first rep after the 64 Mb rows consistently
        # ramps (device-state drift; dry runs: 690 then 1210/1546 for
        # identical reads), and a median-of-4 discounts it
        r = measure_row(log, 3100, True, n_pairs_batch=4096,
                        n_batches=2, repeats=4,
                        on_attempt=attempt_cb("grch38-realistic"))
        if r:
            out["rows"]["grch38-realistic"] = r
            _emit_partial(out)
    else:  # pragma: no cover
        log(f"[bench] skipping GRCh38 row ({left:.0f}s left)")
    left = INNER_BUDGET_S - (time.time() - t_start)
    if left > 300:
        r = measure_row(log, 64, False, n_pairs_batch=8192,
                        on_attempt=attempt_cb("64mb-uniform"))
        if r:
            out["rows"]["64mb-uniform"] = r
            _emit_partial(out)
    else:  # pragma: no cover
        log(f"[bench] skipping uniform row ({left:.0f}s left)")
    log(f"[bench] elapsed {time.time() - t_start:.0f}s")
    return out


def _emit_partial(out):
    """Crash insurance: persist rows as they complete."""
    try:
        # atomic: the outer process's signal handler may read this file
        # at any moment (driver kill); a half-written JSON would defeat
        # the crash insurance exactly when it matters (ADVICE r3).
        tmp = os.path.join(CACHE, "bench_partial.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(out, fh)
        os.replace(tmp, os.path.join(CACHE, "bench_partial.json"))
    except OSError:
        pass


def _emit(out):
    rows = out["rows"]
    if "grch38-realistic" in rows:
        head, scale = rows["grch38-realistic"], \
            "GRCh38-scale 3.1Gbp repeat-realistic synthetic genome"
    elif "64mb-realistic" in rows:
        why = ("GRCh38 row did not finish in budget"
               if os.path.exists(os.path.join(
                   CACHE, "idx3100mr.tpubwa.shm", "meta.json"))
               else "GRCh38 index cache absent")
        head, scale = rows["64mb-realistic"], \
            f"chr20-scale 64Mb repeat-realistic synthetic genome ({why})"
    elif "64mb-uniform" in rows:
        head, scale = rows["64mb-uniform"], \
            "chr20-scale 64Mb uniform synthetic genome"
    else:
        head, scale = (0.0, []), "no successful row"
    med, attempts = head
    print(json.dumps({
        "metric": f"reads/sec/chip (100bp PE, {scale})",
        "value": round(med, 1),
        "unit": "reads/s",
        "vs_baseline": round(med / BASELINE_READS_PER_S, 4),
        "selection": f"median-of-{len(attempts)} "
                     "(attempts collapsed >2.5x below best dropped: "
                     "bimodal device state, see bench.robust_median)",
        "attempts": [round(a, 1) for a in attempts],
        "rows": {k: {"median": round(m, 1),
                     "attempts": [round(a, 1) for a in at]}
                 for k, (m, at) in rows.items()},
        "gcups": round(out.get("gcups", 0.0), 1),
    }), flush=True)


def main():
    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    if "--inner" in sys.argv:
        out = run_all(log)
        _emit(out)
        return
    # The measurement runs in a subprocess that stays the only JAX
    # process on the card; on a crash, an inner timeout, or a
    # SIGTERM/SIGINT to this process, recover the rows that completed
    # (bench_partial.json) so a partial run still reports a headline.
    import signal
    import subprocess
    try:
        os.remove(os.path.join(CACHE, "bench_partial.json"))
    except OSError:
        pass

    inner = [None]

    def _recover_and_exit(signum, frame):  # pragma: no cover
        log(f"[bench] signal {signum}: emitting completed rows")
        if inner[0] is not None:
            try:
                inner[0].kill()
            except OSError:
                pass
        try:
            with open(os.path.join(CACHE, "bench_partial.json")) as fh:
                saved = json.load(fh)
            saved["rows"] = {k: tuple(v)
                             for k, v in saved["rows"].items()}
            _emit(saved)
        except (OSError, ValueError):
            _emit({"rows": {}, "gcups": 0.0})
        os._exit(0)

    signal.signal(signal.SIGTERM, _recover_and_exit)
    signal.signal(signal.SIGINT, _recover_and_exit)
    try:
        inner[0] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--inner"],
            stdout=subprocess.PIPE, text=True)
        stdout, _ = inner[0].communicate(timeout=INNER_BUDGET_S + 120)
        out_lines = stdout.strip().splitlines()
        if inner[0].returncode == 0 and out_lines and \
                out_lines[-1].startswith("{"):
            print(out_lines[-1], flush=True)
            return
        log(f"[bench] inner run failed (rc={inner[0].returncode})")
    except subprocess.TimeoutExpired:
        inner[0].kill()
        log("[bench] inner run timed out")
    try:
        with open(os.path.join(CACHE, "bench_partial.json")) as fh:
            saved = json.load(fh)
        saved["rows"] = {k: tuple(v) for k, v in saved["rows"].items()}
        _emit(saved)
    except (OSError, ValueError):
        _emit({"rows": {}, "gcups": 0.0})


if __name__ == "__main__":
    main()
