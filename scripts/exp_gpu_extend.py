#!/usr/bin/env python
"""Extension and seeding-machine timings on one GPU (for PERF.md).

On the 64 Mbp repeat-realistic reference (chip_smoke.py's), aligns one
batch of 8,192 simulated 2x100 bp pairs through DeviceAligner and
records every descriptor wave the planner sends to the card.  Then:

  1. replays the waves, timing each to its result on the host;
  2. traces one replay with jax.profiler and reduces the trace: device time per XLA module and per kernel, and
     the number of launches of the row loop's kernels (one per loop
     iteration);
  3. traces one megaq seeding call on 8,192 reads: device time over
     the machine's while_loop rounds.

Usage: python scripts/exp_gpu_extend.py --out DIR
Prints a JSON summary as its last line and writes it with the traces
under --out.
"""
import argparse
import glob
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np

from chip_smoke import Config


def reduce_trace(trace_dir, top=25):
    """Per device plane: total busy time, and per event name its count
    and summed duration (the trace's own kernel and module names)."""
    import jax
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            agg = defaultdict(lambda: [0, 0.0])
            iv = []
            for ev in line.events:
                a = agg[ev.name]
                a[0] += 1
                a[1] += ev.duration_ns
                iv.append((ev.start_ns, ev.start_ns + ev.duration_ns))
            iv.sort()
            busy, end = 0.0, -1.0
            span = (iv[-1][1] - iv[0][0]) if iv else 0.0
            for s, e in iv:
                if e > end:
                    busy += e - max(s, end)
                    end = e
            rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
            out[f"{plane.name}|{line.name}"] = {
                "events": len(iv), "busy_ms": busy / 1e6,
                "span_ms": span / 1e6,
                "top": [(n, c, d / 1e6) for n, (c, d) in rows]}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--genome-bp", type=int, default=Config.genome_bp)
    ap.add_argument("--pairs", type=int, default=8192)
    ap.add_argument("--platform", default="gpu")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    import jax
    import tpubwa.device  # noqa: F401  (x64)
    import tpubwa.device.extend_fused as ef
    from chip_smoke import make_reference, phase_device, _pack
    from tpubwa.device.pipeline import make_device_aligner
    from tpubwa.device.smem import collect_intv_device
    from tpubwa.device.smem_split import SEED_STATS
    from tpubwa.host.pipeline import process_seqs
    from tpubwa.opts import MEM_F_PE, MemOpt
    from tpubwa.sim import simulate_pe
    summary = {"device": phase_device(jax)} if args.platform == "gpu" \
        else {}
    fmi = make_reference(Config(genome_bp=args.genome_bp))
    opt = MemOpt(flag=MEM_F_PE)
    reads = simulate_pe(fmi.bnt, args.pairs, 100,
                        np.random.default_rng(0xA1))
    aligner = make_device_aligner(opt, fmi, platform=args.platform)
    waves = []
    real = ef.extend_seed_desc_np

    def capture(didx, qd, jobs, *a, **kw):
        waves.append((qd, np.array(jobs)))
        return real(didx, qd, jobs, *a, **kw)

    ef.extend_seed_desc_np = capture
    t0 = time.perf_counter()
    process_seqs(opt, fmi, reads, 0, align_fn=aligner)
    ef.extend_seed_desc_np = real
    summary["align_batch_s_incl_compiles"] = time.perf_counter() - t0
    summary["waves"] = [len(d) for _, d in waves]
    mat = opt.scoring_matrix()
    didx = aligner.didx

    def replay():
        ts = []
        for qd, d in waves:
            t = time.perf_counter()
            ef.extend_seed_desc_np(didx, qd, d, mat, opt.o_del, opt.e_del,
                                   opt.o_ins, opt.e_ins, opt.zdrop, 1024)
            ts.append(time.perf_counter() - t)
        return ts

    replay()                                        # compile
    ts = [replay() for _ in range(args.reps)]
    summary["replay_wall_ms"] = {
        "per_rep_total": [sum(t) * 1e3 for t in ts],
        "median_per_wave": [float(np.median([t[i] for t in ts])) * 1e3
                            for i in range(len(waves))]}
    tdir = os.path.join(args.out, "trace_extend")
    with jax.profiler.trace(tdir):
        replay()
    summary["trace_extend"] = reduce_trace(tdir)

    sreads = simulate_pe(fmi.bnt, args.pairs // 2, 100,
                         np.random.default_rng(0x5EED))
    arr, lens = _pack(sreads)
    sopt = MemOpt()

    def seed():
        return collect_intv_device(sopt, didx, arr, lens, fmi=fmi,
                                   mode="megaq", return_flat=True,
                                   return_sa=True)
    seed()
    SEED_STATS.clear()
    tdir = os.path.join(args.out, "trace_megaq")
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        seed()
    summary["megaq_wall_ms_traced"] = (time.perf_counter() - t0) * 1e3
    summary["megaq_stats"] = [list(map(float, s[1:])) for s in SEED_STATS
                              if s[0] == "megaq"]
    summary["trace_megaq"] = reduce_trace(tdir)
    summary["peak_bytes_in_use"] = (jax.devices()[0].memory_stats()
                                    or {}).get("peak_bytes_in_use")
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
