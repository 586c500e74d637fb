"""FM-index runtime: occ / SA-sample queries + on-disk format.

Data layout is designed for device-memory residency and batched gathers
(SURVEY.md §2 rows 14,16), NOT a copy of bwa's interleaved file layout:

  * ``bwt_words``  uint32[ceil(n/16)] — stored BWT (the $-removed BWT of
    fwd+revcomp reference), 16 bases/word, base k at bit shift
    ((15 - (k & 15)) << 1) so a word reads left-to-right.
  * ``occ_ckpt``   uint32[n_blocks+1, 4] — #occurrences of each base in
    stored BWT[0 : blk*128) (checkpoint every OCC_INTERVAL=128 bases,
    8 words). A flat array of checkpoints gathers better on the device
    than bwa's count-interleaved stream.
  * ``sa_sample``  int64[floor(n/32)+1] — SA value at every conceptual
    rank divisible by 32; entry 0 is -1 (bwa's convention, so that the
    LF-walk arithmetic ``sa = steps + sample`` works when the walk ends
    at rank 0).

Conceptual-row semantics are identical to upstream bwt.c: rows 0..n of
the (n+1)-row conceptual BWT that includes the sentinel at row
``primary``; occ(k, c) counts c in conceptual rows [0..k].
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .build import (Amb, BntSeq, SeqAnn, fasta2bnt, pack_pac, read_ann_amb,
                    read_pac, unpack_pac, write_amb, write_ann, write_pac)
from .sa import bwt_from_sa, suffix_array

OCC_INTERVAL = 128
WORDS_PER_BLOCK = OCC_INTERVAL // 16
SA_INTV = 32


def build_sa_marks(sa: np.ndarray, D: int):
    """Text-position-sampled SA structure.

    bwa's .sa is RANK-sampled (value at every 32nd rank), which makes
    the LF-walk length geometric (mean 32, unbounded tail) — a
    lockstep device walk then runs ~32*ln(n_lanes) rounds for the
    slowest lane.  Marking every D-th TEXT position instead bounds
    every walk by D-1 steps exactly (any D consecutive text positions
    contain a multiple of D).

    Returns (mark_rows uint32[n_blocks, 8] — per 128 conceptual ranks:
    [#marked before block, 4 bit-words (rank r at word (r&127)>>5 bit
    31-(r&31)), 3 pad], marked_vals int64[#marked] — SA values of
    marked ranks in rank order; rank 0 (sentinel) is always marked
    with bwa's -1 convention)."""
    n1 = len(sa)  # n + 1 conceptual ranks
    marked = (sa % D) == 0
    marked[0] = True
    vals = sa[marked].astype(np.int64)
    # rank 0 keeps the -1 sentinel convention of sa_sample[0]
    vals[0] = -1
    nb = (n1 + 127) // 128
    bits = np.zeros(nb * 4, np.uint32)
    r = np.flatnonzero(marked)
    w = (r >> 5)
    b = np.uint32(31) - (r & 31).astype(np.uint32)
    np.bitwise_or.at(bits, w, np.uint32(1) << b)
    rows = np.zeros((nb, 8), np.uint32)
    rows[:, 1:5] = bits.reshape(nb, 4)
    cnt = np.zeros(nb, np.int64)
    pb = np.zeros(nb * 128, bool)
    pb[:n1] = marked
    np.cumsum(pb.reshape(nb, 128).sum(axis=1), out=cnt)
    rows[1:, 0] = cnt[:-1].astype(np.uint32)
    return rows, vals


def pick_sa_mark_D(n: int) -> int:
    """Sampling stride: walks bounded by D-1; denser for small
    genomes, sparser at human scale to bound memory (marked values
    are n/D entries)."""
    return 8 if n < (1 << 31) else 32


def pack_bwt_words(stored: np.ndarray) -> np.ndarray:
    """Pack 0..3 codes 16-per-uint32, first base in the top bits.
    Slab-wise: uint32 temporaries are 4x the text and spike the peak
    at human scale."""
    n = len(stored)
    n_words = (n + 15) // 16
    out = np.empty(n_words, np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    CH = (1 << 27)  # codes per slab (multiple of 16)
    for s in range(0, n, CH):
        blk = stored[s:s + CH]
        pad = (-len(blk)) % 16
        if pad:
            blk = np.concatenate([blk, np.zeros(pad, np.uint8)])
        c = blk.astype(np.uint32).reshape(-1, 16)
        out[s // 16:s // 16 + c.shape[0]] = \
            (c << shifts[None, :]).sum(axis=1, dtype=np.uint32)
    return out


def unpack_bwt_words(words: np.ndarray, n: int) -> np.ndarray:
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    b = (words[:, None] >> shifts[None, :]) & 3
    return b.reshape(-1)[:n].astype(np.uint8)


def build_occ_ckpt(stored: np.ndarray) -> np.ndarray:
    """uint32[n_blocks+1, 4]: counts of each base before each 128-block."""
    n = len(stored)
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    per_block = np.zeros((n_blocks, 4), dtype=np.int64)
    CH_BLOCKS = (1 << 27) // OCC_INTERVAL
    for b0 in range(0, n_blocks, CH_BLOCKS):
        b1 = min(b0 + CH_BLOCKS, n_blocks)
        blk = stored[b0 * OCC_INTERVAL:b1 * OCC_INTERVAL]
        pad = (b1 - b0) * OCC_INTERVAL - len(blk)
        if pad:
            blk = np.concatenate([blk, np.full(pad, 255, np.uint8)])
        blocks = blk.reshape(b1 - b0, OCC_INTERVAL)
        for c in range(4):
            per_block[b0:b1, c] = (blocks == c).sum(axis=1)
    ckpt = np.zeros((n_blocks + 1, 4), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=ckpt[1:])
    assert ckpt.max() < 2 ** 32
    return ckpt.astype(np.uint32)


@dataclass
class FMIndex:
    seq_len: int          # n = 2 * l_pac
    primary: int          # conceptual row of the sentinel
    L2: np.ndarray        # int64[5]: 0, #A, #A+#C, ..., n (cumulative)
    bwt_words: np.ndarray  # uint32[ceil(n/16)]
    occ_ckpt: np.ndarray  # uint32[n_blocks+1, 4]
    sa_sample: np.ndarray  # int64[n//32 + 1]
    bnt: BntSeq
    # text-position-sampled SA (device fast path; absent for indexes
    # loaded from stock bwa files — the rank-walk still works there)
    sa_mark_D: int = 0
    sa_mark_rows: np.ndarray = None   # uint32[nb, 8]
    sa_marked: np.ndarray = None      # int64[#marked]

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, bnt: BntSeq) -> "FMIndex":
        text = bnt.doubled()
        n = len(text)
        sa = suffix_array(text)
        stored, primary = bwt_from_sa(text, sa)
        counts = np.bincount(text, minlength=4)[:4]
        L2 = np.zeros(5, dtype=np.int64)
        L2[1:] = np.cumsum(counts)
        samples = sa[::SA_INTV].astype(np.int64).copy()
        samples[0] = -1  # bwa convention (rank 0 = sentinel row)
        D = pick_sa_mark_D(n)
        mark_rows, marked_vals = build_sa_marks(sa, D)
        del sa  # 8n bytes — free before the packing passes
        return cls(seq_len=n, primary=primary, L2=L2,
                   bwt_words=pack_bwt_words(stored),
                   occ_ckpt=build_occ_ckpt(stored),
                   sa_sample=samples, bnt=bnt,
                   sa_mark_D=D, sa_mark_rows=mark_rows,
                   sa_marked=marked_vals)

    @classmethod
    def from_fasta(cls, path: str, seed: int = 11) -> "FMIndex":
        return cls.build(fasta2bnt(path, seed))

    # ---------------- occ queries (scalar host reference) --------------
    def bwt_code(self, k: int) -> int:
        """stored BWT[k] (k is a STORED index in [0, n))."""
        w = int(self.bwt_words[k >> 4])
        return (w >> ((15 - (k & 15)) << 1)) & 3

    def _occ_stored(self, k: int, c: int) -> int:
        """#c in stored BWT[0..k] inclusive; k in [-1, n-1]."""
        if k < 0:
            return 0
        blk = k >> 7
        cnt = int(self.occ_ckpt[blk, c])
        start = blk << 7
        w0 = blk * WORDS_PER_BLOCK
        nb = k - start + 1  # bases to scan in this block
        nw = (nb + 15) >> 4
        words = self.bwt_words[w0:w0 + nw].astype(np.uint32)
        # match trick: x = w ^ pattern; base==c iff its 2 bits are 00
        pat = np.uint32(c * 0x55555555)
        x = words ^ pat
        y = (~x) & (~x >> np.uint32(1)) & np.uint32(0x55555555)
        rem = nb & 15
        if rem:
            # partial last word: keep only the top 2*rem bits
            mask = np.uint32(0xFFFFFFFF) << np.uint32(32 - 2 * rem)
            y[-1] &= mask
        return cnt + int(np.bitwise_count(y).sum())

    def occ(self, k: int, c: int) -> int:
        """#c in conceptual BWT rows [0..k]; k in [-1, seq_len]."""
        if k == self.seq_len:
            return int(self.L2[c + 1] - self.L2[c])
        if k < 0:
            return 0
        if k >= self.primary:  # sentinel row is not stored
            k -= 1
        return self._occ_stored(k, c)

    def occ4(self, k: int) -> np.ndarray:
        return np.array([self.occ(k, c) for c in range(4)], dtype=np.int64)

    def two_occ4(self, k: int, l: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.occ4(k), self.occ4(l)

    # ---------------- inverse Psi / SA lookup ---------------------------
    def inv_psi(self, k: int) -> int:
        """LF mapping on conceptual rows (bwt.h:bwt_invPsi)."""
        if k == self.primary:
            return 0
        x = k - (1 if k > self.primary else 0)
        c = self.bwt_code(x)
        return int(self.L2[c]) + self.occ(k, c)

    def sa(self, k: int) -> int:
        """SA value of conceptual rank k (bwt.c:bwt_sa)."""
        steps = 0
        while k % SA_INTV:
            steps += 1
            k = self.inv_psi(k)
        return steps + int(self.sa_sample[k // SA_INTV])

    # ---------------- persistence --------------------------------------
    def save(self, prefix: str) -> None:
        meta = {
            "format": "tpubwa-index-v1",
            "seq_len": self.seq_len, "primary": self.primary,
            "l_pac": self.bnt.l_pac, "seed": self.bnt.seed,
            "anns": [vars(a) for a in self.bnt.anns],
            "ambs": [vars(h) for h in self.bnt.ambs],
        }
        extra = {}
        if self.sa_mark_D:
            meta["sa_mark_D"] = self.sa_mark_D
            extra = dict(sa_mark_rows=self.sa_mark_rows,
                         sa_marked=self.sa_marked)
        np.savez(prefix + ".tpubwa.npz",
                 L2=self.L2, bwt_words=self.bwt_words,
                 occ_ckpt=self.occ_ckpt, sa_sample=self.sa_sample,
                 pac=pack_pac(self.bnt.codes),
                 meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                 **extra)

    @classmethod
    def load(cls, prefix: str) -> "FMIndex":
        z = np.load(prefix + ".tpubwa.npz")
        meta = json.loads(z["meta"].tobytes().decode())
        assert meta["format"] == "tpubwa-index-v1"
        bnt = BntSeq(
            l_pac=meta["l_pac"],
            anns=[SeqAnn(**a) for a in meta["anns"]],
            ambs=[Amb(**h) for h in meta["ambs"]],
            seed=meta["seed"],
            codes=unpack_pac(z["pac"], meta["l_pac"]),
        )
        return cls(seq_len=meta["seq_len"], primary=meta["primary"],
                   L2=z["L2"], bwt_words=z["bwt_words"],
                   occ_ckpt=z["occ_ckpt"], sa_sample=z["sa_sample"],
                   bnt=bnt, sa_mark_D=meta.get("sa_mark_D", 0),
                   sa_mark_rows=(z["sa_mark_rows"]
                                 if "sa_mark_rows" in z.files else None),
                   sa_marked=(z["sa_marked"]
                              if "sa_marked" in z.files else None))

    # ---------------- shared-memory style cache (bwashm.c analogue) ----
    def save_shm(self, prefix: str) -> None:
        """bwa shm analogue (bwashm.c, SURVEY.md §2 row 20): materialize
        every array as a raw .npy in <prefix>.tpubwa.shm/ so loads mmap
        straight out of the page cache — N processes on a host share
        one resident copy, and per-process start-up is O(1)."""
        import os
        d = prefix + ".tpubwa.shm"
        os.makedirs(d, exist_ok=True)
        meta = {
            "format": "tpubwa-index-v1",
            "seq_len": self.seq_len, "primary": self.primary,
            "l_pac": self.bnt.l_pac, "seed": self.bnt.seed,
            "anns": [vars(a) for a in self.bnt.anns],
            "ambs": [vars(h) for h in self.bnt.ambs],
        }
        if self.sa_mark_D:
            meta["sa_mark_D"] = self.sa_mark_D
        with open(os.path.join(d, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        arrays = [("L2", self.L2), ("bwt_words", self.bwt_words),
                  ("occ_ckpt", self.occ_ckpt),
                  ("sa_sample", self.sa_sample),
                  ("codes", self.bnt.codes)]
        if self.sa_mark_D:
            arrays += [("sa_mark_rows", self.sa_mark_rows),
                       ("sa_marked", self.sa_marked)]
        for name, arr in arrays:
            np.save(os.path.join(d, name + ".npy"),
                    np.ascontiguousarray(arr))

    @classmethod
    def load_shm(cls, prefix: str) -> "FMIndex":
        import os
        d = prefix + ".tpubwa.shm"
        with open(os.path.join(d, "meta.json")) as fh:
            meta = json.load(fh)
        assert meta["format"] == "tpubwa-index-v1"
        ld = lambda n: np.load(os.path.join(d, n + ".npy"),
                               mmap_mode="r")
        bnt = BntSeq(
            l_pac=meta["l_pac"],
            anns=[SeqAnn(**a) for a in meta["anns"]],
            ambs=[Amb(**h) for h in meta["ambs"]],
            seed=meta["seed"],
            codes=ld("codes"),
        )
        D = meta.get("sa_mark_D", 0)
        return cls(seq_len=meta["seq_len"], primary=meta["primary"],
                   L2=np.asarray(ld("L2")), bwt_words=ld("bwt_words"),
                   occ_ckpt=ld("occ_ckpt"), sa_sample=ld("sa_sample"),
                   bnt=bnt, sa_mark_D=D,
                   sa_mark_rows=ld("sa_mark_rows") if D else None,
                   sa_marked=ld("sa_marked") if D else None)

    # ---------------- bwa on-disk interop (bwtindex.c layout) ----------
    def save_bwa(self, prefix: str) -> None:
        """Write bwa-compatible .pac/.ann/.amb/.bwt/.sa files."""
        write_pac(prefix + ".pac", self.bnt.codes)
        write_ann(prefix + ".ann", self.bnt)
        write_amb(prefix + ".amb", self.bnt)
        n = self.seq_len
        stored = unpack_bwt_words(self.bwt_words, n)
        # .bwt: primary, L2[1..4], occ-interleaved packed bwt
        # (per 128-base block: 4x uint64 counts then 8x uint32 bases)
        n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
        out = []
        hdr = np.empty(5, dtype=np.uint64)
        hdr[0] = self.primary
        hdr[1:] = self.L2[1:].astype(np.uint64)
        out.append(hdr.tobytes())
        words = self.bwt_words
        pad_w = n_blocks * WORDS_PER_BLOCK - len(words)
        words = np.concatenate([words, np.zeros(pad_w, np.uint32)])
        inter = np.zeros(n_blocks * 16, dtype=np.uint32)
        blk = np.arange(n_blocks)
        cnts = self.occ_ckpt[:-1].astype(np.uint64)  # counts before block
        cnt_words = cnts.view(np.uint32).reshape(n_blocks, 8)
        inter = inter.reshape(n_blocks, 16)
        inter[:, :8] = cnt_words
        inter[:, 8:] = words.reshape(n_blocks, 8)
        out.append(inter.tobytes())
        with open(prefix + ".bwt", "wb") as fh:
            fh.write(b"".join(out))
        # .sa: primary, L2[1..4], sa_intv, seq_len, samples[1:]
        with open(prefix + ".sa", "wb") as fh:
            fh.write(hdr.tobytes())
            fh.write(np.uint64(SA_INTV).tobytes())
            fh.write(np.uint64(n).tobytes())
            fh.write(self.sa_sample[1:].astype(np.uint64).tobytes())

    @classmethod
    def load_bwa(cls, prefix: str) -> "FMIndex":
        """Read a stock-bwa index (.pac/.ann/.amb/.bwt/.sa)."""
        l_pac, anns, ambs, seed = read_ann_amb(prefix + ".ann", prefix + ".amb")
        codes = read_pac(prefix + ".pac", l_pac)
        bnt = BntSeq(l_pac=l_pac, anns=anns, ambs=ambs, seed=seed, codes=codes)
        raw = np.fromfile(prefix + ".bwt", dtype=np.uint8)
        hdr = raw[:40].view(np.uint64)
        primary = int(hdr[0])
        L2 = np.zeros(5, dtype=np.int64)
        L2[1:] = hdr[1:].astype(np.int64)
        n = int(L2[4])
        inter = raw[40:].view(np.uint32)
        n_blocks = len(inter) // 16
        inter = inter[: n_blocks * 16].reshape(n_blocks, 16)
        bwt_words = inter[:, 8:].reshape(-1)
        nw = (n + 15) // 16
        bwt_words = bwt_words[:nw].copy()
        stored = unpack_bwt_words(bwt_words, n)
        sa_raw = np.fromfile(prefix + ".sa", dtype=np.uint64)
        sa_intv = int(sa_raw[5])
        assert sa_intv == SA_INTV, "only sa_intv=32 supported"
        n_sa = n // SA_INTV + 1
        samples = np.empty(n_sa, dtype=np.int64)
        samples[0] = -1
        samples[1:] = sa_raw[7:7 + n_sa - 1].astype(np.int64)
        return cls(seq_len=n, primary=primary, L2=L2, bwt_words=bwt_words,
                   occ_ckpt=build_occ_ckpt(stored), sa_sample=samples,
                   bnt=bnt)
