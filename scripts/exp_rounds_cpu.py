#!/usr/bin/env python
"""Hardware-independent seeding-machine comparison: ROUND counts of
mega vs megaq on the same corpus (CPU).  Rounds x per-round gather
cost is the machines' cost model (fwd round = 2 gathers/lane, bwd
round = 2P gathers/lane; see PERF.md).

Measured 2026-08-17 (8 Mb genome + repeat region, 2048 reads, 1-5%
error):
  mega : rf=220 rb=201  (main 118/107 + a deep-tail machine 102/94
         forced by 7 over-MAXC lanes)            gather-cost 25M
  megaq: rf=128 rb=69   (ONE machine, no tail)   gather-cost 15M
i.e. 2.9x fewer backward rounds (straggler elimination), one fewer
dispatch+sync, ~1.67x less modeled gather work — before counting the
fused-SA dispatch savings.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpubwa.index import FMIndex
    from tpubwa.index.build import BntSeq, SeqAnn
    from tpubwa.opts import MemOpt
    from tpubwa.device.occ import DeviceIndex
    from tpubwa.device.smem import collect_intv_device
    import tpubwa.device.smem_split as ss

    rng = np.random.default_rng(5)
    n = 8_000_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[100000:115000] = np.tile(codes[100000:100300], 50)
    bnt = BntSeq(l_pac=n, anns=[SeqAnn(name="c", anno="", offset=0,
                                       length=n, n_ambs=0)],
                 ambs=[], seed=11, codes=codes)
    fmi = FMIndex.build(bnt)
    didx = DeviceIndex.from_fmindex(fmi)
    text = bnt.doubled()
    opt = MemOpt()
    B, L = 2048, 100
    reads = np.zeros((B, L), np.uint8)
    lens = np.full(B, L, np.int32)
    for i in range(B):
        pos = int(rng.integers(0, n - L - 5))
        q = text[pos:pos + L].copy()
        mut = rng.random(L) < (0.01 if i % 5 else 0.05)
        q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        reads[i] = q

    P = 16
    for mode in ("mega", "megaq"):
        ss.SEED_STATS.clear()
        collect_intv_device(opt, didx, reads, lens, fmi=fmi, mode=mode)
        ms = [m for m in ss.SEED_STATS if m[0] in ("mega", "megaq")]
        rf = sum(m[6] for m in ms)
        rb = sum(m[7] for m in ms)
        cost = sum(m[6] * 2 * m[1] + m[7] * 2 * P * m[1] for m in ms)
        print(f"{mode:6s}: machines={len(ms)} rf={rf} rb={rb} "
              f"modeled-gathers={cost / 1e6:.0f}M", file=sys.stderr)


if __name__ == "__main__":
    main()
