"""Alignment options — the contract for record-identity with bwa-mem.

Mirrors the semantics of upstream bwa-mem's ``mem_opt_t`` /
``mem_opt_init()`` (reference: bwamem.c:~80-120, bwamem.h:~40-100;
see SURVEY.md §2 row 4).  Every default below is the stock bwa-mem
0.7.x default; changing any of them changes output records.

This is a fresh implementation: options live in a frozen
dataclass and flow explicitly through every stage (no globals), so the
whole pipeline is trivially re-entrant and jit-friendly (scalars are
baked into traces as static config).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

# mem_opt_t flag bits (bwamem.h:~30)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800
MEM_F_KEEP_SUPP_MAPQ = 0x1000

# mem_alnreg_t secondary / SAM flag helpers
SAM_FLAG_PAIRED = 0x1
SAM_FLAG_PROPER = 0x2
SAM_FLAG_UNMAP = 0x4
SAM_FLAG_MUNMAP = 0x8
SAM_FLAG_REVERSE = 0x10
SAM_FLAG_MREVERSE = 0x20
SAM_FLAG_READ1 = 0x40
SAM_FLAG_READ2 = 0x80
SAM_FLAG_SECONDARY = 0x100
SAM_FLAG_SUPPLEMENTARY = 0x800


@dataclass(frozen=True)
class MemOpt:
    """bwa-mem scoring / heuristic options (defaults == mem_opt_init())."""

    # scoring
    a: int = 1                 # match score
    b: int = 4                 # mismatch penalty
    o_del: int = 6             # gap open (deletion)
    e_del: int = 1             # gap extend (deletion)
    o_ins: int = 6             # gap open (insertion)
    e_ins: int = 1             # gap extend (insertion)
    pen_unpaired: int = 17     # phred-scaled penalty for unpaired pairing
    pen_clip5: int = 5         # 5' clipping penalty
    pen_clip3: int = 5         # 3' clipping penalty
    w: int = 100               # band width
    zdrop: int = 100           # Z-dropoff

    # seeding / chaining
    T: int = 30                # output score threshold
    min_seed_len: int = 19
    split_factor: float = 1.5  # re-seed if SMEM longer than min_seed_len*this
    split_width: int = 10      # re-seed if occ <= this
    max_occ: int = 500         # skip seeds with occurrences > this
    max_chain_gap: int = 10000
    max_chain_extend: int = 1 << 30
    min_chain_weight: int = 0
    drop_ratio: float = 0.50   # drop chain if weight < this * best overlapping
    mask_level: float = 0.50
    mask_level_redun: float = 0.95
    max_mem_intv: int = 20     # 3rd-round seeding occurrence ceiling
    mapQ_coef_len: float = 50.0
    mapQ_coef_fac: float = 0.0  # filled in __post_init__: log(mapQ_coef_len)
    max_ins: int = 10000
    max_matesw: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    XA_drop_ratio: float = 0.80

    # driver
    n_threads: int = 1
    chunk_size: int = 10_000_000
    flag: int = 0
    mapQ_unpaired_default: int = 0  # unused placeholder for layout parity

    def __post_init__(self):
        if self.mapQ_coef_fac == 0.0 and self.mapQ_coef_len > 0:
            object.__setattr__(self, "mapQ_coef_fac",
                               float(np.log(self.mapQ_coef_len)))

    # ------------------------------------------------------------------
    def scoring_matrix(self) -> np.ndarray:
        """5x5 int8 matrix, semantics of bwa_fill_scmat (bwa.c:~40):
        match=+a, mismatch=-b, any comparison with N (code 4) = -1."""
        m = np.full((5, 5), -self.b, dtype=np.int8)
        np.fill_diagonal(m, self.a)
        m[4, :] = -1
        m[:, 4] = -1
        return m

    def max_gap(self, qlen: int) -> int:
        """cal_max_gap (bwamem.c:~650): widest gap still above threshold."""
        l_del = int((qlen * self.a - self.o_del) / self.e_del + 1.0)
        l_ins = int((qlen * self.a - self.o_ins) / self.e_ins + 1.0)
        l = max(l_del, l_ins)
        l = max(l, 1)
        return min(l, self.w << 1)

    def replace(self, **kw) -> "MemOpt":
        return dataclasses.replace(self, **kw)


def preset(name: str) -> dict:
    """-x presets (fastmap.c:~150-210): returns option overrides."""
    if name == "intractg":
        return dict(o_del=16, o_ins=16, b=9, pen_clip5=5, pen_clip3=5)
    if name in ("pacbio", "pbref"):
        return dict(o_del=1, e_del=1, o_ins=1, e_ins=1, b=1,
                    split_factor=10.0, pen_clip5=0, pen_clip3=0,
                    min_seed_len=17, w=40, zdrop=20)
    if name == "ont2d":
        return dict(o_del=1, e_del=1, o_ins=1, e_ins=1, b=1,
                    split_factor=10.0, pen_clip5=0, pen_clip3=0,
                    min_seed_len=14, w=20, zdrop=20)
    raise ValueError(f"unknown preset: {name}")
