#!/usr/bin/env python
"""Stage-level profiling at genome scale (chr20-scale, 64 Mbp, by
default).  Builds/caches a synthetic index, aligns PE
batches on the device pipeline, and prints a per-stage wall breakdown.

Usage: python scripts/profile_scale.py [--mb 64] [--pairs 16000]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache")


def cached_index(genome_mb: int, seed: int = 3):
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.index.build import BntSeq, SeqAnn
    os.makedirs(CACHE, exist_ok=True)
    prefix = os.path.join(CACHE, f"idx{genome_mb}m")
    if os.path.exists(prefix + ".tpubwa.npz"):
        t0 = time.time()
        fmi = FMIndex.load(prefix)
        print(f"[prof] index loaded from cache: {fmi.seq_len} doubled, "
              f"{time.time() - t0:.1f}s", file=sys.stderr)
        return fmi
    n = genome_mb * 1_000_000
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    bnt = BntSeq(l_pac=n, anns=[SeqAnn(name="chrS", anno="", offset=0,
                                       length=n, n_ambs=0)],
                 ambs=[], seed=11, codes=codes)
    t0 = time.time()
    fmi = FMIndex.build(bnt)
    print(f"[prof] index built: {n} bp in {time.time() - t0:.1f}s",
          file=sys.stderr)
    fmi.save(prefix)
    return fmi


def simulate(fmi, n_pairs, read_len, rng):
    from tpubwa.io.fastq import Read
    from tpubwa.index.build import unpack_pac
    codes = fmi.bnt.codes
    reads = []
    L = len(codes)
    isizes = np.maximum(rng.normal(350, 30, n_pairs).astype(int),
                        read_len * 2 + 10)
    poss = rng.integers(0, L - 500, n_pairs)
    for i in range(n_pairs):
        isize, pos = int(isizes[i]), int(poss[i])
        r1 = codes[pos:pos + read_len].copy()
        r2 = (3 - codes[pos + isize - read_len:pos + isize])[::-1].copy()
        for r in (r1, r2):
            mut = rng.random(read_len) < 0.01
            r[mut] = (r[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        reads.append(Read(name=f"p{i}", seq=r1, qual=None))
        reads.append(Read(name=f"p{i}", seq=r2, qual=None))
    return reads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--pairs", type=int, default=16000)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--platform", default="auto")
    ap.add_argument("--realistic", action="store_true",
                    help="use the repeat-realistic bench corpus "
                         "(same index+reads as bench.py's headline row)")
    args = ap.parse_args()

    from tpubwa.opts import MEM_F_PE, MemOpt
    from tpubwa.host.pipeline import process_batches, process_seqs
    from tpubwa.device.pipeline import make_device_aligner

    if args.realistic:
        from tpubwa.sim import bench_index
        fmi = cached_index_realistic = bench_index(
            args.mb, realistic=True,
            log=lambda m: print(m, file=sys.stderr))
    else:
        fmi = cached_index(args.mb)
    opt = MemOpt(flag=MEM_F_PE)
    rng = np.random.default_rng(1)
    aligner = make_device_aligner(opt, fmi, platform=args.platform)

    # ---- instrument DeviceAligner stages
    import tpubwa.device.pipeline as dp
    stages = {}

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            stages[label] = stages.get(label, 0.0) + time.perf_counter() - t0
            return r
        setattr(obj, name, timed)

    wrap(aligner, "_seed_chunk", "seed+sa")
    wrap(aligner, "_chunk_regs", "chain+extend+post")
    wrap(aligner, "_sa_positions", "  sa-walk(sync)")
    wrap(aligner, "_pack", "  pack")
    import tpubwa.host.native_smem as ns
    wrap(ns, "smem_collect_batch_native", "  seed-native")
    import tpubwa.device.smem as _sm2
    wrap(_sm2, "_package_rows", "  package-rows")
    import tpubwa.device.smem_cursor as sc
    import tpubwa.device.smem as sm
    wrap(sc, "run_smem_jobs", "  cursor-machine(sync)")
    wrap(sm, "_seed_strategy_scan", "  r3-dispatch")
    import tpubwa.device.smem_split as ss
    wrap(ss, "rounds12_split", "  rounds12-split")
    wrap(ss, "run_fwd", "    fwd-machine(sync)")
    wrap(ss, "run_bwd", "    bwd-dispatch")
    wrap(ss, "_decode_bwd", "    bwd-decode(sync)")
    wrap(sm, "_scalar_round1", "    scalar-redo-r1")
    wrap(sm, "_scalar_reseed", "    scalar-redo-r2")
    import tpubwa.device.smem_fused as sf
    wrap(sf, "rounds12_fused", "  rounds12-fused")
    wrap(sf, "run_call_machine", "    call-machine(sync)")
    wrap(sf, "rounds12_mega", "  rounds12-mega")
    wrap(sf, "decode_chunk_machine", "    mega-decode(sync)")
    wrap(sf, "rounds12_megaq", "  rounds12-megaq")
    wrap(sf, "decode_chunk_machine_q", "    megaq-decode(sync)")
    import tpubwa.host.native_emit as ne
    wrap(ne, "chain_batch_native", "  chain-native")
    import tpubwa.device.extend_fused as ef
    wrap(ef, "extend_seed_desc_np", "  extend-desc(sync)")
    import tpubwa.host.pipeline as hp
    wrap(hp, "emit_phase", "emit (pair+sam)")
    import tpubwa.host.native_emit as ne2
    wrap(ne2, "emit_batch_native", "  emit-native")

    if args.realistic:
        from tpubwa.sim import simulate_pe

        def simulate_batch(n):
            return simulate_pe(fmi.bnt, n, 100, rng)
    else:
        def simulate_batch(n):
            return simulate(fmi, n, 100, rng)

    warm = simulate_batch(max(args.pairs // args.batches, 64))
    t0 = time.time()
    process_seqs(opt, fmi, warm, 0, align_fn=aligner)
    print(f"[prof] warmup (compiles): {time.time() - t0:.1f}s",
          file=sys.stderr)
    stages.clear()
    ss.SEED_STATS.clear()
    ne.emit_stats(reset=True)   # drop warmup-batch counters

    batches = [simulate_batch(args.pairs // args.batches)
               for _ in range(args.batches)]
    n_reads = sum(len(b) for b in batches)
    t0 = time.perf_counter()
    n_lines = 0
    for batch, lines in process_batches(opt, fmi, iter(batches), 0,
                                        align_fn=aligner):
        n_lines += len(lines)
    dt = time.perf_counter() - t0
    print(f"[prof] {n_reads} reads in {dt:.2f}s = "
          f"{n_reads / dt:.0f} reads/s ({args.mb} Mb genome); "
          f"{n_lines} records", file=sys.stderr)
    tot = sum(stages.values())
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"[prof]   {k:24s} {v:7.2f}s", file=sys.stderr)
    print(f"[prof]   (instrumented total     {tot:7.2f}s; "
          f"overlap hides some)", file=sys.stderr)
    ext = aligner.extender
    print(f"[prof]   waves={ext.n_waves} jobs={ext.n_jobs} "
          f"fallback={ext.n_fallback}", file=sys.stderr)
    es = ne.emit_stats()
    if es:
        print("[prof]   emit-native attribution:", file=sys.stderr)
        for stem in ("matesw", "gen_alt", "reg2aln", "aln2sam"):
            c = es.get(f"{stem}_calls", 0)
            w = es.get(f"{stem}_ns", 0) / 1e9
            print(f"[prof]     {stem:13s} {c:9d} calls {w:7.2f}s",
                  file=sys.stderr)
        print(f"[prof]     {'ksw_align':13s} "
              f"{es['ksw_align_calls']:9d} calls (inside matesw)",
              file=sys.stderr)
        print(f"[prof]     mem_pair {es['mem_pair_ns'] / 1e9:.2f}s  "
              f"mark_primary {es['mark_primary_ns'] / 1e9:.2f}s",
              file=sys.stderr)
    for kind in ("fwd", "bwd", "call", "mega", "megaq"):
        ms = [s for s in ss.SEED_STATS if s[0] == kind]
        if not ms:
            continue
        lanes = sum(m[1] for m in ms)
        live = sum(m[2] for m in ms)
        rnds = sum(m[3] for m in ms)
        a = sum(m[4] for m in ms)
        b = sum(m[5] for m in ms)
        cause = ("stack-ovf", "call-ovf") if kind == "fwd" \
            else ("redo", "spill") if kind == "bwd" \
            else ("r1-ovf", "r2-ovf") if kind == "megaq" \
            else ("ovf", "spill")
        print(f"[prof]   {kind}-machines: {len(ms)} dispatches, "
              f"{lanes} lanes ({live} live), {rnds} total rounds "
              f"(mean {rnds / len(ms):.0f}), "
              f"{cause[0]}={a} {cause[1]}={b}", file=sys.stderr)
        if kind in ("call", "mega", "megaq") and len(ms[0]) > 8:
            rf = sum(m[6] for m in ms)
            rb = sum(m[7] for m in ms)
            sw = sum(m[8] for m in ms)
            for m in ms:
                print(f"[prof]     lanes={m[1]} live={m[2]} "
                      f"rf={m[6]} rb={m[7]} sync={m[8]*1e3:.0f}ms",
                      file=sys.stderr)
            print(f"[prof]   call totals: rf={rf} rb={rb} "
                  f"sync={sw:.2f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
