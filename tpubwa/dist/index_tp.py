"""Index-sharded (tensor-parallel) FM-index lookups
(SURVEY.md §2.2 TP row, §5.7: "shard occ/SA arrays by k-range, route
lookup batches over the interconnect").

GRCh38's index (~6 GB) fits one card's memory, so data-parallel
replication is the production default.  For
references that do NOT fit (pan-genomes, large clades), this module
shards the big index arrays row-wise over a mesh axis: every chip
holds a contiguous k-range slab, lookups are replicated, each chip
answers the rows it owns (others contribute zeros), and one psum over
the axis routes the answers — ownership routing with a single
collective, no host involvement.  Per-chip index memory is 1/n.

occ4 / bwt_extend / the marked SA walk are provided in sharded form;
equality with the single-device primitives on a virtual mesh is
pinned by tests/test_index_tp.py.  The seeding machines can be built
over these primitives when a too-big-for-HBM reference materializes —
the occ API is the only index surface they touch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..device.occ import DeviceIndex, _PATTERNS, _block_counts

U32 = jnp.uint32
I32 = jnp.int32


def _pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    n = a.shape[0]
    m = ((n + mult - 1) // mult) * mult
    if m == n:
        return a
    pad = np.zeros((m - n,) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


class TpIndex:
    """FM-index with the row-heavy arrays sharded over mesh axis
    'tp'.  Scalars and small arrays (L2) stay replicated."""

    def __init__(self, fmi, mesh: Mesh, axis: str = "tp"):
        didx = DeviceIndex.from_fmindex(fmi)
        n = mesh.shape[axis]   # shards along the tp axis only (the
        # mesh may carry other axes, e.g. dp for the job dimension)
        self.mesh = mesh
        self.axis = axis
        self.idt = didx.idt
        self.np_idt = didx.np_idt
        self.primary = didx.primary
        self.seq_len = didx.seq_len
        self.l_pac = didx.l_pac
        self.mark_D = didx.mark_D
        shard = NamedSharding(mesh, P(axis))
        repl = NamedSharding(mesh, P())
        occ = _pad_rows(np.asarray(didx.occ_blocks), n)
        self.occ_rows_total = occ.shape[0]
        self.occ_blocks = jax.device_put(occ, shard)
        self.L2 = jax.device_put(np.asarray(didx.L2), repl)
        if self.mark_D:
            mr = _pad_rows(np.asarray(didx.mark_rows), n)
            self.mark_rows_total = mr.shape[0]
            self.mark_rows = jax.device_put(mr, shard)
            sm = _pad_rows(np.asarray(didx.sa_marked), n)
            self.sa_marked_total = sm.shape[0]
            self.sa_marked = jax.device_put(sm, shard)

    # -- sharded primitives (run under shard_map over 'tp') -----------

    def occ4(self, k: jnp.ndarray) -> jnp.ndarray:
        """occ(k, c) for all 4 bases, k replicated [...]; answers
        routed by slab ownership + psum."""
        axis = self.axis
        primary, seq_len, idt = self.primary, self.seq_len, self.idt
        L2 = self.L2
        total = self.occ_rows_total

        def local(occ_local, L2_, kk):
            nsh = jax.lax.psum(1, axis)
            rows_per = total // nsh
            base = jax.lax.axis_index(axis) * rows_per
            k_ = kk.astype(idt)
            is_end = k_ == seq_len
            kc = jnp.where(k_ >= primary, k_ - 1, k_)
            kc = jnp.clip(kc, 0, seq_len - 1)
            blk = kc >> 7
            li = blk - base
            mine = (li >= 0) & (li < rows_per)
            row = occ_local[jnp.clip(li, 0, rows_per - 1)]
            row = jnp.where(mine[..., None], row, U32(0))
            row = jax.lax.psum(row, axis)          # routed answer
            bs = row[..., :4].astype(idt)
            words = row[..., 4:]
            nb = (kc - (blk << 7) + 1).astype(idt)
            cnt = bs + _block_counts(words, nb)
            cnt = jnp.where((k_ < 0)[..., None], 0, cnt)
            end_val = (L2_[1:5] - L2_[0:4])[None]
            return jnp.where(is_end[..., None], end_val, cnt)

        f = shard_map(local, mesh=self.mesh,
                      in_specs=(P(self.axis), P(), P()),
                      out_specs=P(), check_vma=False)
        return f(self.occ_blocks, self.L2, k)

    def bwt_extend(self, ik: jnp.ndarray, is_back: bool) -> jnp.ndarray:
        """Batched bidirectional extension over the sharded index
        (mirrors device/occ.py:bwt_extend)."""
        piv = ik[..., 0] if is_back else ik[..., 1]
        oth = ik[..., 1] if is_back else ik[..., 0]
        sz = ik[..., 2]
        tk = self.occ4(piv - 1)
        tl = self.occ4(piv - 1 + sz)
        sizes = tl - tk
        new_piv = self.L2[:4][None] + 1 + tk
        sent = ((piv <= self.primary)
                & (piv + sz - 1 >= self.primary)).astype(self.idt)
        acc3 = oth + sent
        acc2 = acc3 + sizes[..., 3]
        acc1 = acc2 + sizes[..., 2]
        acc0 = acc1 + sizes[..., 1]
        accs = jnp.stack([acc0, acc1, acc2, acc3], axis=-1)
        if is_back:
            return jnp.stack([new_piv, accs, sizes], axis=-1)
        return jnp.stack([accs, new_piv, sizes], axis=-1)

    def sa_lookup(self, ranks: jnp.ndarray) -> jnp.ndarray:
        """Marked (bounded) SA walk over the sharded index: every LF
        step does one routed occ-row read and one routed mark-row
        read; the final value gathers from the sharded sa_marked."""
        assert self.mark_D, "TP SA walk needs the marked index"
        axis = self.axis
        idt = self.idt
        primary, seq_len = self.primary, self.seq_len
        occ_total = self.occ_rows_total
        mark_total = self.mark_rows_total
        sam_total = self.sa_marked_total
        D = self.mark_D

        def local(occ_local, mark_local, sam_local, L2_, rr):
            nsh = jax.lax.psum(1, axis)
            occ_per = occ_total // nsh
            mark_per = mark_total // nsh
            sam_per = sam_total // nsh
            me = jax.lax.axis_index(axis)

            def routed_row(table, per, idx):
                li = idx - me * per
                mine = (li >= 0) & (li < per)
                row = table[jnp.clip(li, 0, per - 1)]
                row = jnp.where(mine[..., None], row,
                                jnp.zeros_like(row))
                return jax.lax.psum(row, axis)

            def mark_bit_idx(k):
                row = routed_row(mark_local, mark_per, k >> 7)
                within = (k - ((k >> 7) << 7)).astype(I32)
                wi = 1 + (within >> 5)
                lanes = jnp.arange(8, dtype=I32)
                w = jnp.sum(jnp.where(lanes == wi[..., None], row,
                                      U32(0)), axis=-1, dtype=U32)
                bp = (U32(31) - (within & 31).astype(U32))
                bit = ((w >> bp) & U32(1)).astype(I32)
                words = row[..., 1:5]
                wi4 = within >> 5
                lanes4 = jnp.arange(4, dtype=I32)
                full = jnp.sum(
                    jnp.where(lanes4 < wi4[..., None],
                              jax.lax.population_count(words), U32(0)),
                    axis=-1, dtype=U32)
                above = jnp.where(bp >= U32(31), U32(0),
                                  (w >> (bp + U32(1))))
                part = jax.lax.population_count(above)
                idx = (row[..., 0] + full + part).astype(idt)
                return bit, idx

            def inv_psi_r(k):
                x = (k - (k > primary)).astype(idt)
                blk = x >> 7
                row = routed_row(occ_local, occ_per, blk)
                within = (x - (blk << 7)).astype(I32)
                widx = 4 + (within >> 4)
                lanes = jnp.arange(12, dtype=I32)
                w = jnp.sum(jnp.where(lanes == widx[..., None], row,
                                      U32(0)), axis=-1, dtype=U32)
                sh = ((15 - (within & 15)) << 1).astype(U32)
                c = ((w >> sh) & U32(3)).astype(idt)
                base = jnp.sum(jnp.where(lanes == c[..., None], row,
                                         U32(0)), axis=-1,
                               dtype=U32).astype(idt)
                words = row[..., 4:]
                pat = jnp.sum(jnp.where(
                    jnp.arange(4, dtype=I32)
                    == jnp.clip(c, 0, 3)[..., None],
                    jnp.asarray(_PATTERNS), U32(0)), axis=-1,
                    dtype=U32)
                y = words ^ pat[..., None]
                y = (~y) & ((~y) >> U32(1)) & U32(0x55555555)
                nb = within + 1
                cov = jnp.clip(nb[..., None]
                               - jnp.arange(8, dtype=I32) * 16, 0, 16)
                shift = (2 * (16 - jnp.clip(cov, 1, 16))).astype(U32)
                mask = jnp.where(
                    cov > 0,
                    (U32(0xFFFFFFFF) << shift) & U32(0xFFFFFFFF),
                    U32(0))
                cnt = jnp.sum(jax.lax.population_count(y & mask),
                              axis=-1, dtype=idt)
                lf = L2_[c] + base + cnt
                return jnp.where(k == primary, 0, lf)

            k = rr.astype(idt)
            steps = jnp.zeros_like(k)
            done = jnp.zeros(k.shape, bool)
            for _ in range(D - 1):
                bit, _ = mark_bit_idx(k)
                done = done | (bit == 1)
                nk = inv_psi_r(k)
                k = jnp.where(done, k, nk)
                steps = steps + (1 - done.astype(idt))
            _, idx = mark_bit_idx(k)
            li = idx - me * sam_per
            mine = (li >= 0) & (li < sam_per)
            val = sam_local[jnp.clip(li, 0, sam_per - 1)]
            val = jnp.where(mine, val, 0)
            val = jax.lax.psum(val, axis)
            return steps + val

        f = shard_map(local, mesh=self.mesh,
                      in_specs=(P(self.axis), P(self.axis),
                                P(self.axis), P(), P()),
                      out_specs=P(), check_vma=False)
        return f(self.occ_blocks, self.mark_rows, self.sa_marked,
                 self.L2, ranks)


# ---------------------------------------------------------------------
# TP-sharded seeding: the UNCHANGED megaq machine over a sharded index
# ---------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class TpMachineIndex:
    """DeviceIndex duck-type whose big-array reads are psum-routed.

    Lives INSIDE a shard_map body: each shard holds a contiguous slab
    of occ_blocks/mark_rows/sa_marked (1/n of the index memory) plus
    the replicated small arrays; `occ_row`/`mark_row_at`/
    `sa_marked_at` answer the rows the shard owns and psum over the
    mesh axis routes the full answer to every shard.  All machine
    state is replicated, so every shard runs the IDENTICAL machine
    trajectory — the collective per occ read is the entire
    communication cost (SURVEY.md §2.2 TP row: "shard occ/SA by
    k-range, route lookups over ICI").

    pac stays replicated: at 2 bits/base it is ~8x smaller than
    occ+SA, and extension tiles read it with data-local gathers.
    """

    def __init__(self, occ_local, mark_local, sam_local, L2, pac_words,
                 sa_sample, primary, seq_len, l_pac, mark_D, axis,
                 occ_total, mark_total, sam_total):
        self.occ_local = occ_local
        self.mark_local = mark_local
        self.sam_local = sam_local
        self.L2 = L2
        self.pac_words = pac_words
        self.sa_sample = sa_sample
        self.primary = primary
        self.seq_len = seq_len
        self.l_pac = l_pac
        self.mark_D = mark_D
        self.axis = axis
        self.occ_total = occ_total
        self.mark_total = mark_total
        self.sam_total = sam_total

    # pytree protocol (the machine is jitted with didx as an argument)
    def tree_flatten(self):
        return ((self.occ_local, self.mark_local, self.sam_local,
                 self.L2, self.pac_words, self.sa_sample),
                (self.primary, self.seq_len, self.l_pac, self.mark_D,
                 self.axis, self.occ_total, self.mark_total,
                 self.sam_total))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def idt(self):
        from ..device.occ import _fits_i32
        return jnp.int32 if _fits_i32(self.seq_len) else jnp.int64

    @property
    def np_idt(self):
        from ..device.occ import _fits_i32
        return np.int32 if _fits_i32(self.seq_len) else np.int64

    def _routed(self, table, total, idx, is_row):
        nsh = jax.lax.psum(1, self.axis)
        per = total // nsh
        li = idx - jax.lax.axis_index(self.axis) * per
        mine = (li >= 0) & (li < per)
        v = table[jnp.clip(li, 0, per - 1)]
        if is_row:
            mine = mine[..., None]
        v = jnp.where(mine, v, jnp.zeros_like(v))
        return jax.lax.psum(v, self.axis)

    def occ_row(self, blk):
        return self._routed(self.occ_local, self.occ_total, blk, True)

    def mark_row_at(self, blk):
        return self._routed(self.mark_local, self.mark_total, blk,
                            True)

    def sa_marked_at(self, idx):
        return self._routed(self.sam_local, self.sam_total, idx, False)

    def sa_sample_at(self, idx):
        # rank-sampled SA is only used by mark-less (stock-bwa-load)
        # indexes; TP seeding requires the marked walk
        raise NotImplementedError("TP seeding needs a marked index")


def seed_machine_tp(tpidx: TpIndex, qd, ld, jobs_np, P_, MAXC, CAPF,
                    CAPF2, min_seed_len, split_len, split_width,
                    max_rounds_b=1024, MLX=1, P2=0, SCAPF=0,
                    max_occ=500):
    """Run the queue-scheduled megaq chunk machine
    (device/smem_fused.py:smem_chunk_machine_q, UNCHANGED) over the
    TP-sharded index: ONE shard_map, index slabs P('tp'), machine
    state replicated, outputs replicated.  Same flat-buffer contract
    as dispatch_chunk_machine_q, so decode_chunk_machine_q consumes
    the result unchanged."""
    from ..device.smem_fused import smem_chunk_machine_q
    mesh, axis = tpidx.mesh, tpidx.axis
    n = len(jobs_np)
    J2 = 2 * n
    statics = dict(P=P_, MAXC=MAXC, CAPF=CAPF, J2=J2, CAPF2=CAPF2,
                   MLX=int(MLX), min_seed_len=int(min_seed_len),
                   split_len=int(split_len),
                   split_width=int(split_width),
                   max_rounds_b=int(max_rounds_b), P2=int(P2),
                   SCAPF=int(SCAPF), max_occ=int(max_occ))
    aux = (tpidx.primary, tpidx.seq_len, tpidx.l_pac, tpidx.mark_D,
           axis, tpidx.occ_rows_total, tpidx.mark_rows_total,
           tpidx.sa_marked_total)

    def local(occ_l, mark_l, sam_l, L2, q, lens, jobs):
        # the seeding machine touches the index ONLY through occ/mark/
        # SA rows (pac is an extension-stage array) — dummies for the
        # unused pac_words/sa_sample leaves
        ldx = TpMachineIndex(occ_l, mark_l, sam_l, L2,
                             jnp.zeros(1, jnp.uint32),
                             jnp.zeros(1, L2.dtype), *aux)
        return smem_chunk_machine_q(ldx, q, lens, jobs, **statics)

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(axis), P(axis), P(axis), P(), P(),
                            P(), P()),
                  out_specs=P(), check_vma=False)
    repl = NamedSharding(mesh, P())
    return f(tpidx.occ_blocks, tpidx.mark_rows, tpidx.sa_marked,
             tpidx.L2, jax.device_put(np.asarray(qd), repl),
             jax.device_put(np.asarray(ld), repl),
             jax.device_put(jobs_np, repl))
