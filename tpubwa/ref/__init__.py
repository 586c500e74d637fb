"""Scalar reference implementations (the oracle).

Host-side, NumPy-vectorized-per-row implementations of the alignment
kernels with semantics matching upstream bwa's ksw.c / bwt.c exactly
(tie-breaking, adaptive band trimming, Z-drop timing).  The production
device path (tpubwa.device) is fuzzed against these in tests; the host
pipeline uses them directly as the CPU fallback — the same role the
reference's CPU ksw_extend2 fallback plays under its FPGA offload
(SURVEY.md §2 row 17).
"""

from .ksw import KswExt, ksw_extend, ksw_global, ksw_align, cigar_to_str
from .smem import (BwtIntv, bwt_extend, collect_intv, sa_positions,
                   seed_strategy1, set_intv, smem1a)

__all__ = ["KswExt", "ksw_extend", "ksw_global", "ksw_align", "cigar_to_str",
           "BwtIntv", "bwt_extend", "collect_intv", "sa_positions",
           "seed_strategy1", "set_intv", "smem1a"]
