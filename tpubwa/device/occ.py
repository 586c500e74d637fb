"""Batched FM-index primitives on device (bwt.c:bwt_occ4/bwt_2occ4/
bwt_extend/bwt_sa rewritten as vectorized JAX gathers; SURVEY.md §2
rows 5-6,14).

HBM layout: one fused row per 128-base block — 4 uint32 checkpoint
counts followed by 8 uint32 packed-base words (``occ_blocks``,
[n_blocks, 12]).  One occ4 query = ONE 48-byte row gather + masked
popcounts, the device analogue of bwa's count-interleaved OCC_INTERVAL
layout.  All rank/position arithmetic is int64 (human-scale 2*l_pac
overflows int32).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
import jax
import jax.numpy as jnp
import numpy as np

from ..index.fmindex import FMIndex, OCC_INTERVAL, SA_INTV, WORDS_PER_BLOCK

I64 = jnp.int64
I32 = jnp.int32
U32 = jnp.uint32


def _fits_i32(seq_len: int) -> bool:
    """Ranks/positions live in [-1, seq_len+1]; int32 covers genomes
    under 2^31-2 doubled bases (E. coli..chr-scale).  Human-scale
    indexes (GRCh38 doubled = 6.2e9) take the int64 path; int32 is the
    cheaper path wherever it fits."""
    return seq_len + 2 < (1 << 31)


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceIndex:
    """FM-index arrays resident on device + static scalars."""
    occ_blocks: jnp.ndarray   # uint32 [n_blocks, 12]: 4 counts + 8 words
    sa_sample: jnp.ndarray    # int64 [n//32 + 1]
    L2: jnp.ndarray           # int64 [5]
    primary: int              # static
    seq_len: int              # static
    pac_words: jnp.ndarray    # uint32 [ceil(l_pac/16)] packed fwd ref
    l_pac: int                # static
    # text-position-sampled SA (bounded LF walk); mark_D == 0 when the
    # index has no marks (stock-bwa load) -> geometric rank walk
    mark_rows: jnp.ndarray = None   # uint32 [nb, 8]
    sa_marked: jnp.ndarray = None   # idt [#marked]
    mark_D: int = 0                 # static

    @property
    def idt(self):
        """Device dtype for ranks/positions (int32 when they fit)."""
        return I32 if _fits_i32(self.seq_len) else I64

    @property
    def np_idt(self):
        return np.int32 if _fits_i32(self.seq_len) else np.int64

    # -- index row accessors -------------------------------------------
    # The ONLY surface through which the seeding machines and the SA
    # walk touch the big index arrays.  dist/index_tp.py's
    # TpMachineIndex overrides these four with psum-routed reads over
    # a sharded mesh axis, which lets every machine in device/smem*.py
    # run UNCHANGED over an index that does not fit one chip's HBM
    # (SURVEY.md §2.2 TP row).
    def occ_row(self, blk):
        """Fused occ row(s) [.., 12] for block index blk."""
        return self.occ_blocks[blk]

    def mark_row_at(self, blk):
        """Text-position-mark row(s) [.., 8] for block index blk."""
        return self.mark_rows[blk]

    def sa_marked_at(self, idx):
        """Marked-SA value(s) at idx."""
        return self.sa_marked[idx]

    def sa_sample_at(self, idx):
        """Rank-sampled SA value(s) at idx (stock-bwa indexes)."""
        return self.sa_sample[idx]

    def tree_flatten(self):
        return ((self.occ_blocks, self.sa_sample, self.L2,
                 self.pac_words, self.mark_rows, self.sa_marked),
                (self.primary, self.seq_len, self.l_pac, self.mark_D))

    @classmethod
    def tree_unflatten(cls, aux, children):
        (occ_blocks, sa_sample, L2, pac_words, mark_rows,
         sa_marked) = children
        primary, seq_len, l_pac, mark_D = aux
        return cls(occ_blocks=occ_blocks, sa_sample=sa_sample, L2=L2,
                   primary=primary, seq_len=seq_len,
                   pac_words=pac_words, l_pac=l_pac,
                   mark_rows=mark_rows, sa_marked=sa_marked,
                   mark_D=mark_D)

    @classmethod
    def from_fmindex(cls, fmi: FMIndex, device=None) -> "DeviceIndex":
        n = fmi.seq_len
        n_blocks = fmi.occ_ckpt.shape[0] - 1
        words = fmi.bwt_words
        pad = n_blocks * WORDS_PER_BLOCK - len(words)
        words = np.concatenate([words, np.zeros(pad, np.uint32)])
        blocks = np.concatenate(
            [fmi.occ_ckpt[:-1], words.reshape(n_blocks, WORDS_PER_BLOCK)],
            axis=1).astype(np.uint32)
        # pack the forward reference 16 codes/word (same order as bwt)
        from ..index.fmindex import pack_bwt_words
        pw = pack_bwt_words(fmi.bnt.codes)
        put = partial(jax.device_put, device=device)
        npdt = np.int32 if _fits_i32(int(fmi.seq_len)) else np.int64
        D = int(getattr(fmi, "sa_mark_D", 0) or 0)
        if D:
            mark_rows = put(np.ascontiguousarray(fmi.sa_mark_rows))
            sa_marked = put(np.asarray(fmi.sa_marked).astype(npdt))
        else:
            mark_rows = put(np.zeros((1, 8), np.uint32))
            sa_marked = put(np.zeros(1, npdt))
        return cls(occ_blocks=put(blocks),
                   sa_sample=put(fmi.sa_sample.astype(npdt)),
                   L2=put(fmi.L2.astype(npdt)),
                   primary=int(fmi.primary), seq_len=int(fmi.seq_len),
                   pac_words=put(pw), l_pac=int(fmi.bnt.l_pac),
                   mark_rows=mark_rows, sa_marked=sa_marked, mark_D=D)


_PATTERNS = np.array([0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF],
                     dtype=np.uint32)


def _block_counts(words: jnp.ndarray, nb: jnp.ndarray) -> jnp.ndarray:
    """#occurrences of each base among the first nb bases of a block.

    words: uint32 [..., 8]; nb: int [...] in [0, 128].
    Returns int64 [..., 4].
    """
    pat = jnp.asarray(_PATTERNS)
    x = words[..., None, :] ^ pat[:, None]          # [..., 4, 8]
    y = (~x) & ((~x) >> U32(1)) & U32(0x55555555)
    cov = jnp.clip(nb[..., None] - jnp.arange(8, dtype=nb.dtype) * 16,
                   0, 16)                            # [..., 8]
    shift = (2 * (16 - jnp.clip(cov, 1, 16))).astype(U32)
    mask = jnp.where(cov > 0,
                     (U32(0xFFFFFFFF) << shift) & U32(0xFFFFFFFF),
                     U32(0))
    cnt = jax.lax.population_count(y & mask[..., None, :])
    return jnp.sum(cnt, axis=-1).astype(nb.dtype)    # [..., 4]


def occ4(didx: DeviceIndex, k: jnp.ndarray) -> jnp.ndarray:
    """occ(k, c) for all 4 bases; k int64 [...] conceptual rows in
    [-1, seq_len].  Returns int64 [..., 4]."""
    k = k.astype(didx.idt)
    is_end = k == didx.seq_len
    kk = jnp.where(k >= didx.primary, k - 1, k)
    kk = jnp.clip(kk, 0, didx.seq_len - 1)
    blk = kk >> 7
    row = didx.occ_row(blk)                         # [..., 12]
    base = row[..., :4].astype(didx.idt)
    words = row[..., 4:]
    nb = (kk - (blk << 7) + 1).astype(didx.idt)
    cnt = base + _block_counts(words, nb)
    cnt = jnp.where((k < 0)[..., None], 0, cnt)
    end_val = (didx.L2[1:5] - didx.L2[0:4])[None]
    return jnp.where(is_end[..., None], end_val, cnt)


def occ1(didx: DeviceIndex, k: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """occ(k, c) for one base per query (used by the SA walk)."""
    return jnp.take_along_axis(occ4(didx, k),
                               c[..., None].astype(didx.idt),
                               axis=-1)[..., 0]


def bwt_code(didx: DeviceIndex, x: jnp.ndarray) -> jnp.ndarray:
    """stored BWT[x] (x stored index, int64 [...])."""
    x = x.astype(didx.idt)
    blk = x >> 7
    within = x - (blk << 7)
    row = didx.occ_row(blk)
    lanes = jnp.arange(12, dtype=I32)
    w = jnp.sum(jnp.where(lanes == (4 + (within >> 4))[..., None],
                          row, U32(0)), axis=-1, dtype=U32)
    sh = ((15 - (within & 15)) << 1).astype(U32)
    return ((w >> sh) & U32(3)).astype(didx.idt)


def set_intv(didx: DeviceIndex, c: jnp.ndarray):
    """bwt_set_intv batched: [..., 3] (x0, x1, size) for single bases."""
    c = c.astype(didx.idt)
    x0 = didx.L2[c] + 1
    x1 = didx.L2[3 - c] + 1
    sz = didx.L2[c + 1] - didx.L2[c]
    return jnp.stack([x0, x1, sz], axis=-1)


def bwt_extend(didx: DeviceIndex, ik: jnp.ndarray, is_back: bool):
    """Batched bidirectional extension (bwt.c:bwt_extend:~240).

    ik: int64 [..., 3] = (x0, x1, size).  Returns ok int64 [..., 4, 3]
    indexed by the base in the extension direction."""
    piv = ik[..., 0] if is_back else ik[..., 1]
    oth = ik[..., 1] if is_back else ik[..., 0]
    sz = ik[..., 2]
    tk = occ4(didx, piv - 1)                        # [..., 4]
    tl = occ4(didx, piv - 1 + sz)
    sizes = tl - tk
    new_piv = didx.L2[:4][None] + 1 + tk
    sent = ((piv <= didx.primary)
            & (piv + sz - 1 >= didx.primary)).astype(didx.idt)
    acc3 = oth + sent
    acc2 = acc3 + sizes[..., 3]
    acc1 = acc2 + sizes[..., 2]
    acc0 = acc1 + sizes[..., 1]
    accs = jnp.stack([acc0, acc1, acc2, acc3], axis=-1)
    if is_back:
        return jnp.stack([new_piv, accs, sizes], axis=-1)
    return jnp.stack([accs, new_piv, sizes], axis=-1)


def inv_psi(didx: DeviceIndex, k: jnp.ndarray) -> jnp.ndarray:
    """LF mapping on conceptual rows, batched.

    Fused form: x = k - (k > primary) equals occ4's adjusted index
    kk = k - (k >= primary) everywhere except k == primary (masked to 0
    anyway), so ONE occ-block row gather serves both the BWT code read
    and the single-base occ count — the naive bwt_code + occ1 pair
    costs two gathers plus a 4-base popcount pipeline per walk step."""
    dt = didx.idt
    x = (k - (k > didx.primary)).astype(dt)
    blk = x >> 7
    row = didx.occ_row(blk)                          # [..., 12]
    within = (x - (blk << 7)).astype(I32)
    # BWT code: select word lane 4 + within//16 (one-hot, fuses)
    widx = 4 + (within >> 4)
    lanes = jnp.arange(12, dtype=I32)
    w = jnp.sum(jnp.where(lanes == widx[..., None], row, U32(0)),
                axis=-1, dtype=U32)
    sh = ((15 - (within & 15)) << 1).astype(U32)
    c = ((w >> sh) & U32(3)).astype(dt)
    # occ(x, c) inclusive: checkpoint count + single-base popcount
    base = jnp.sum(jnp.where(lanes == c[..., None], row, U32(0)),
                   axis=-1, dtype=U32).astype(dt)
    words = row[..., 4:]
    pat = jnp.sum(jnp.where(
        jnp.arange(4, dtype=I32) == jnp.clip(c, 0, 3)[..., None],
        jnp.asarray(_PATTERNS), U32(0)), axis=-1, dtype=U32)
    y = words ^ pat[..., None]
    y = (~y) & ((~y) >> U32(1)) & U32(0x55555555)
    nb = within + 1
    cov = jnp.clip(nb[..., None] - jnp.arange(8, dtype=I32) * 16, 0, 16)
    shift = (2 * (16 - jnp.clip(cov, 1, 16))).astype(U32)
    mask = jnp.where(cov > 0,
                     (U32(0xFFFFFFFF) << shift) & U32(0xFFFFFFFF),
                     U32(0))
    cnt = jnp.sum(jax.lax.population_count(y & mask), axis=-1,
                  dtype=dt)
    lf = didx.L2[c] + base + cnt
    return jnp.where(k == didx.primary, 0, lf)


def _mark_row(didx: DeviceIndex, k: jnp.ndarray):
    """Gather the 8-lane mark row for conceptual rank k and return
    (row, word, bitpos): word holds k's bit at position bitpos."""
    row = didx.mark_row_at(k >> 7)                   # [..., 8]
    within = (k - ((k >> 7) << 7)).astype(I32)
    wi = 1 + (within >> 5)
    lanes = jnp.arange(8, dtype=I32)
    w = jnp.sum(jnp.where(lanes == wi[..., None], row, U32(0)),
                axis=-1, dtype=U32)
    bp = (U32(31) - (within & 31).astype(U32))
    return row, w, bp, within


def _mark_bit(didx: DeviceIndex, k: jnp.ndarray) -> jnp.ndarray:
    _, w, bp, _ = _mark_row(didx, k)
    return ((w >> bp) & U32(1)).astype(I32)


def _mark_index(didx: DeviceIndex, k: jnp.ndarray) -> jnp.ndarray:
    """# of marked ranks before k (k itself marked) = index into
    sa_marked."""
    row, w, bp, within = _mark_row(didx, k)
    words = row[..., 1:5]
    wi = (within >> 5)
    lanes4 = jnp.arange(4, dtype=I32)
    full = jnp.sum(jnp.where(lanes4 < wi[..., None],
                             jax.lax.population_count(words), U32(0)),
                   axis=-1, dtype=U32)
    # bits above bp in k's own word = marked ranks earlier in the word
    above = jnp.where(bp >= U32(31), U32(0),
                      (w >> (bp + U32(1))))
    part = jax.lax.population_count(above)
    base = row[..., 0]
    return (base + full + part).astype(didx.idt)


@partial(jax.jit, static_argnames=())
def sa_lookup(didx: DeviceIndex, ranks: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt_sa.

    With text-position marks (mark_D > 0): every walk terminates
    within mark_D-1 LF steps (any D consecutive text positions hit a
    multiple of D), so the lockstep loop is a FIXED fori_loop —
    rank-sampled walks are geometric (mean 32, tail unbounded) and the
    slowest of 1e4+ lanes used to force ~300 rounds."""
    ranks = ranks.astype(didx.idt)
    if didx.mark_D:
        def body(j, st):
            k, steps, done = st
            done = done | (_mark_bit(didx, k) == 1)
            nk = inv_psi(didx, k)
            k = jnp.where(done, k, nk)
            steps = steps + (1 - done.astype(didx.idt))
            return k, steps, done
        k, steps, _ = jax.lax.fori_loop(
            0, didx.mark_D - 1, body,
            (ranks, jnp.zeros_like(ranks),
             jnp.zeros(ranks.shape, bool)))
        return steps + didx.sa_marked_at(_mark_index(didx, k))

    def cond(state):
        k, steps = state
        return jnp.any(k % SA_INTV != 0)

    def body(state):
        k, steps = state
        active = (k % SA_INTV) != 0
        nk = inv_psi(didx, k)
        k = jnp.where(active, nk, k)
        steps = steps + active.astype(didx.idt)
        return k, steps

    k, steps = jax.lax.while_loop(
        cond, body, (ranks, jnp.zeros_like(ranks)))
    return steps + didx.sa_sample_at(k // SA_INTV)


def get_ref_batch(didx: DeviceIndex, starts: jnp.ndarray,
                  length: int) -> jnp.ndarray:
    """Fetch `length` forward-reference codes from each start (doubled
    coordinates are NOT handled here; callers fold strands)."""
    dt = didx.idt
    pos = starts[:, None].astype(dt) + jnp.arange(length, dtype=dt)[None]
    pos = jnp.clip(pos, 0, didx.l_pac - 1)
    w = didx.pac_words[pos >> 4]
    sh = ((15 - (pos & 15)) << 1).astype(U32)
    return ((w >> sh) & U32(3)).astype(jnp.int32)
