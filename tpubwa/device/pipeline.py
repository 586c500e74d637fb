"""Device-accelerated per-batch aligner (SURVEY.md §2 rows 3,5,6,9,17).

Stage plan per batch (mirrors §3.4's phase structure):
  A. batched SMEM seeding on device  (smem.collect_intv_device)
  B. batched SA lookups on device    (occ.sa_lookup)
  C. host chaining/filtering          (host/chain.py — tiny per read)
  D. extension WAVES on device       (dispatch.WaveExtender)
  E. host dedup/patch/region post    (host/regions.py)

Produces regions identical to the scalar host path (pinned by
tests/test_device_pipeline.py), so everything downstream — primary
marking, MAPQ, pairing, SAM — is shared code.
"""

from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..host.chain import chain_flt, flt_chained_seeds, mem_chain
from ..host.regions import AlnReg, extension_plan, sort_dedup_patch
from ..index.fmindex import FMIndex
from ..io.fastq import Read
from ..opts import MemOpt
from .dispatch import WaveExtender
from .occ import DeviceIndex, sa_lookup
from .smem import collect_intv_device, _pad_pow2

log = logging.getLogger("tpubwa")


def _pick_device(platform: str):
    """Resolve the compute device for --device gpu|cpu|auto.

    'gpu' is the first local GPU and raises without one; 'auto' is
    whatever backend JAX initialised.  No platform falls back to
    another.  Local devices only: under jax.distributed, jax.devices()
    lists every process's devices and computing on a remote one fails
    at the first device-to-host fetch."""
    if platform == "cpu":
        try:
            jax.config.update("jax_platforms", "cpu")
        except RuntimeError:
            pass  # backends already initialized; use jax.devices("cpu")
        return jax.local_devices(backend="cpu")[0]
    if platform == "gpu":
        try:
            return jax.local_devices(backend="gpu")[0]
        except RuntimeError as e:
            raise RuntimeError(f"no GPU device available: {e}") from e
    if platform != "auto":
        raise ValueError(f"unknown device platform {platform!r}")
    dev = jax.local_devices()[0]
    log.info("[device] auto: %s (%s)", dev.platform, dev.device_kind)
    return dev


class DeviceAligner:
    """Batched seeding/SA/extension; host chaining + region post."""

    def __init__(self, opt: MemOpt, fmi: FMIndex, platform: str = "auto",
                 mesh=None):
        self.opt = opt
        self.fmi = fmi
        self.mat = opt.scoring_matrix()
        self.mesh = mesh
        if mesh is not None:
            # data-parallel over the mesh: FM-index replicated, every
            # job-axis array sharded over 'dp' (SURVEY.md §2.2); the
            # seeding programs partition via GSPMD, the extension row
            # loop runs under shard_map
            from jax.sharding import NamedSharding, PartitionSpec as P
            self._repl = NamedSharding(mesh, P())
            self._shrd = NamedSharding(mesh, P("dp"))
            self.device = None
            self.didx = DeviceIndex.from_fmindex(fmi)
            from ..dist.sharding import DataParallel
            dp = DataParallel(mesh=mesh)
            self.didx = dp.replicate_index(self.didx)
            # a 'tp' mesh axis requests index-sharded seeding: the
            # megaq machine runs over psum-routed occ/mark/SA slabs
            # (dist/index_tp.py:seed_machine_tp) so the seeding index
            # needs only 1/|tp| of each device's memory (SURVEY §2.2 TP
            # row)
            self.tpidx = None
            if "tp" in mesh.axis_names:
                from ..dist.index_tp import TpIndex
                self.tpidx = TpIndex(fmi, mesh, axis="tp")

            def put_sharded(x):
                return jax.device_put(np.ascontiguousarray(x),
                                      self._shrd)

            def put_repl(x):
                return jax.device_put(np.ascontiguousarray(x),
                                      self._repl)
            self.put_sharded = put_sharded
            self.put_repl = put_repl
        else:
            self.device = _pick_device(platform)
            self.didx = DeviceIndex.from_fmindex(fmi, device=self.device)
            self.put_sharded = jnp.asarray
            self.put_repl = jnp.asarray
        # the cache only needs to be set before the first compile, and
        # the resolved device names the platform it is for
        from ..utils import enable_compilation_cache
        dev0 = self.device or mesh.devices.flat[0]
        enable_compilation_cache(dev0.platform)
        self.extender = WaveExtender(opt, self.mat, fused=True, mesh=mesh)
        from .extend import _mat_ab
        self.mat_scmat = _mat_ab(self.mat) is not None
        # longer reads fall back to the scalar path; 510 = the row
        # loop's LANES-1 bound, covering 2x250 bp chemistry on device
        self.read_len_cap = 510
        # Fixed seeding-chunk size: every device program in the seeding
        # stage sees operand shapes (chunk_reads, Lp) with chunk_reads
        # CONSTANT, so XLA compiles each program exactly once per
        # read-length bucket instead of once per batch size (compiles
        # are ~10 s each — they dominated wall time before this).
        import os as _os
        from ..host.native_smem import _lib as _smem_lib_probe
        if mesh is not None:
            # one host core cannot feed N chips: machine seeding
            default_mode = "megaq"
        elif _smem_lib_probe() is None:
            default_mode = "megaq"   # no native seeder built
        elif self.device is not None and self.device.platform == "gpu":
            # accelerator: host-native seeding plus a megaq machine
            # share of the chunk, so the card works during the seed
            # phase
            default_mode = "hybrid"
        else:
            # CPU "device" (tests, no-chip boxes): the machine share
            # would run on the same core it tries to offload from
            default_mode = "host"
        self.seed_mode = _os.environ.get("TPUBWA_SEED_MODE") \
            or default_mode
        seed_mode = self.seed_mode
        # host seeding has NO device seeding programs, so a bigger
        # chunk costs no new compiles and halves the per-read share
        # of extension dispatches + link syncs; the machine modes keep
        # 8192 (16k machines measured super-linear).  Host mode without
        # the native lib degrades to the machine path per chunk, so the
        # 16k default also requires the lib.
        from ..host.native_smem import _lib as _smem_lib
        default_chunk = 16384 if (seed_mode == "host"
                                  and _smem_lib() is not None) else 8192
        self.chunk_reads = int(_os.environ.get("TPUBWA_CHUNK_READS",
                                               default_chunk))
        # reads seeded by a device machine (the rest: host-native)
        self.seed_stats = {"dev_reads": 0}

    # -------------------------------------------------------------
    def _pack(self, reads: Sequence[Read], pad_to: int):
        L = max((r.l_seq for r in reads), default=1)
        Lp = 1
        while Lp < L:
            Lp <<= 1
        Lp = max(Lp, 32)
        arr = np.full((max(len(reads), pad_to), Lp), 4, np.uint8)
        lens = np.zeros(max(len(reads), pad_to), np.int32)
        lens[:len(reads)] = [r.l_seq for r in reads]
        if len(reads) and (lens[:len(reads)] == lens[0]).all():
            # uniform read length (the overwhelmingly common case):
            # one C-level stack instead of a per-read assignment loop
            arr[:len(reads), :lens[0]] = np.stack(
                [r.seq for r in reads])
        else:
            for i, r in enumerate(reads):
                arr[i, :r.l_seq] = r.seq
        return arr, lens

    def _sa_positions(self, intv):
        """Subsample ranks per bwa protocol (mem_chain head: step =
        occ/max_occ, up to max_occ samples), one batched device
        lookup.  Fully vectorized over the FLAT interval rows; returns
        flat (pos, cnt) — positions for all intervals of the chunk in
        (read, interval-row) order plus the per-interval sample
        counts."""
        flat, _counts = intv
        if not len(flat):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if self.opt.max_occ <= 0:    # -c 0: every seed over-occ
            return (np.zeros(0, np.int64),
                    np.zeros(len(flat), np.int64))
        # native host walk first (bounded by the text-position marks,
        # ~1 us/position): beats a device dispatch + link sync for
        # every caller — the host seeding mode, megaq's -1 spill rows,
        # and the classic path alike
        from ..host.native_smem import sa_positions_native
        nat = sa_positions_native(self.fmi, flat, self.opt.max_occ,
                                  threads=self.opt.n_threads)
        if nat is not None:
            return nat
        x0 = flat[:, 0]
        size = flat[:, 2]
        step = np.where(size > self.opt.max_occ,
                        size // self.opt.max_occ, 1)
        cnt = np.minimum((size + step - 1) // step, self.opt.max_occ)
        ends = np.cumsum(cnt)
        n = int(ends[-1])
        if n == 0:
            return np.zeros(0, np.int64), cnt
        base = np.repeat(ends - cnt, cnt)
        k = np.arange(n, dtype=np.int64) - base
        ranks = np.repeat(x0, cnt) + k * np.repeat(step, cnt)
        m = _pad_pow2(n)
        arr = np.zeros(m, self.didx.np_idt)
        arr[:n] = ranks
        pos = np.asarray(sa_lookup(self.didx, self.put_sharded(arr)))
        return pos[:n].astype(np.int64), cnt

    def _sa_merge(self, flat, sa_cnt, sa_pos):
        """Assemble the chunk's SA positions from the machine-fused
        segments (`_sa_from_rows`), computing only the -1 rows
        (retry/scalar/spill/round-3 rows) via the classic batched
        lookup.  Same contract as `_sa_positions`."""
        if not len(flat):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if self.opt.max_occ <= 0:    # -c 0: no samples anywhere
            return np.zeros(0, np.int64), np.zeros(len(flat), np.int64)
        size = flat[:, 2]
        step = np.where(size > self.opt.max_occ,
                        size // self.opt.max_occ, 1)
        cnt = np.minimum((size + step - 1) // step, self.opt.max_occ)
        have = sa_cnt >= 0
        if have.any() and not np.array_equal(sa_cnt[have], cnt[have]):
            # defensive: device arithmetic must mirror exactly
            import logging
            logging.getLogger("tpubwa").warning(
                "fused SA count mismatch; recomputing on host")
            return self._sa_positions((flat, None))
        ends = np.cumsum(cnt)
        pos_out = np.zeros(int(ends[-1]), np.int64)
        from .smem_split import _row_offsets
        if have.any():
            dst = (np.repeat(ends[have] - cnt[have], cnt[have])
                   + _row_offsets(cnt[have]))
            pos_out[dst] = sa_pos
        need = ~have
        if need.any():
            pos_h, _ = self._sa_positions((flat[need], None))
            dst = (np.repeat(ends[need] - cnt[need], cnt[need])
                   + _row_offsets(cnt[need]))
            pos_out[dst] = pos_h
        return pos_out, cnt

    # -------------------------------------------------------------
    def _seed_chunk(self, chunk: Sequence[Read]):
        """Device seeding + SA lookups for one chunk (runs on the
        prefetch thread so it overlaps host chaining/extension of the
        previous chunk)."""
        # pow2 bucket with a small floor: tiny batches (tests,
        # stragglers) compile small programs; full chunks always
        # pad to exactly `chunk_reads`, so the steady-state shape is
        # unique
        pad = 32
        while pad < len(chunk):
            pad <<= 1
        arr, lens = self._pack(chunk, pad)
        # seed-mode default resolved at __init__ (hybrid on a real
        # accelerator, host on CPU boxes, megaq under a mesh);
        # TPUBWA_SEED_MODE overrides either way
        mode = self.seed_mode
        flat, frid, qd, sa = collect_intv_device(
            self.opt, self.didx, arr, lens, fmi=self.fmi, mode=mode,
            put_sharded=self.put_sharded, put_repl=self.put_repl,
            return_flat=True, return_qd=True, return_sa=True,
            tp=getattr(self, "tpidx", None), stats=self.seed_stats)
        counts = np.bincount(frid, minlength=arr.shape[0])[:len(chunk)]
        intv = (flat, counts)
        positions = (self._sa_merge(flat, *sa) if sa is not None
                     else self._sa_positions(intv))
        # qd: the device-resident packed chunk reads — _chunk_regs
        # reuses it for descriptor-mode extension instead of packing
        # and uploading the same ~1 MB again
        return intv, positions, qd

    def _chunk_regs(self, chunk, intv_rows, positions, qd=None):
        """Host chaining + device extension waves + region post for one
        chunk; returns per-read region lists."""
        opt, fmi, mat = self.opt, self.fmi, self.mat
        # descriptor-mode extension: tiles built on device from the
        # resident chunk reads + pac (jobs ship as ~11 ints)
        use_desc = self.mat_scmat
        if use_desc:
            if qd is None:
                pad = 32
                while pad < len(chunk):
                    pad <<= 1
                arr, _ = self._pack(chunk, pad)
                qd = self.put_repl(arr)
            self.extender.set_chunk_ctx(self.didx, qd, chunk, fmi.bnt)
            # native planner: chaining + per-seed planning + region
            # post all in C++ — Python only shuttles descriptor waves
            # to the device (host/native_emit.py:plan_batch_native)
            from ..host.native_emit import plan_batch_native
            from .extend_fused import extend_seed_desc_np

            def extend_fn(desc):
                return extend_seed_desc_np(
                    self.didx, qd, desc, self.mat, opt.o_del,
                    opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
                    self.extender.tmax, mesh=self.mesh)

            planned = plan_batch_native(
                opt, fmi, chunk, intv_rows, positions, extend_fn,
                qmax=self.extender.qmax, tmax=self.extender.tmax,
                flat=True)
            if planned is not None:
                # FlatRegs: the planner's arrays flow straight into
                # pestat/native-emit without AlnReg materialization
                regs_flat, n_waves, n_jobs = planned
                self.extender.n_waves += n_waves
                self.extender.n_jobs += n_jobs
                return regs_flat
        # chain stage: native C++ when available (byte-equal; see
        # tests/test_native_emit.py::test_chain_batch_equality)
        from ..host.native_emit import chain_batch_native
        chains_per_read = chain_batch_native(opt, fmi, chunk, intv_rows,
                                             positions)
        nested = per_read_intv = None
        if chains_per_read is None:
            per_read_intv = _nest_intv(intv_rows)
            nested = _nest_positions(per_read_intv, positions)
        all_regs: List[List[AlnReg]] = []
        plans_by_read = []
        for ri, read in enumerate(chunk):
            if chains_per_read is not None:
                chains = chains_per_read[ri]
            else:
                chains = mem_chain(opt, fmi, read.seq,
                                   intvs=per_read_intv[ri],
                                   positions=nested[ri])
                chains = chain_flt(opt, chains)
                flt_chained_seeds(opt, fmi.bnt, read.l_seq, read.seq,
                                  chains, mat)
            regs: List[AlnReg] = []
            all_regs.append(regs)
            # chains of one read share `regs` and must extend in order
            # (the skip test consults earlier regions); different reads
            # extend in parallel waves
            plans_by_read.append([
                extension_plan(opt, fmi.bnt, read.l_seq, read.seq, c,
                               regs, fused=True,
                               read_row=ri if use_desc else -1)
                for c in chains])
        self.extender.run(_serialize_per_read(plans_by_read))
        out = []
        for read, regs in zip(chunk, all_regs):
            regs = sort_dedup_patch(opt, fmi.bnt, read.seq, regs, mat)
            for r in regs:
                if r.rid >= 0 and fmi.bnt.anns[r.rid].is_alt:
                    r.is_alt = 1
            out.append(regs)
        return out

    def align_batch(self, reads: Sequence[Read]) -> List[List[AlnReg]]:
        opt, fmi, mat = self.opt, self.fmi, self.mat
        if not reads:
            return []
        if max(r.l_seq for r in reads) > self.read_len_cap:
            # route ONLY the oversize reads to the scalar path — one
            # long read must not de-accelerate the whole batch
            from ..host.pipeline import align1_core
            long_idx = [i for i, r in enumerate(reads)
                        if r.l_seq > self.read_len_cap]
            if len(long_idx) == len(reads):
                return [align1_core(opt, fmi, r, mat) for r in reads]
            long_set = set(long_idx)
            short = [r for i, r in enumerate(reads) if i not in long_set]
            short_regs = iter(self.align_batch(short))
            return [align1_core(opt, fmi, r, mat) if i in long_set
                    else next(short_regs)
                    for i, r in enumerate(reads)]
        ch = self.chunk_reads
        chunks = [reads[s:s + ch] for s in range(0, len(reads), ch)]
        from ..utils import serial_pipeline
        serial = serial_pipeline()
        if len(chunks) == 1 or serial:
            # serial chunk loop: on a single-core host the seeding
            # prefetch thread only steals timeslices from main-thread
            # native plan/emit (both GIL-free C++).  Multi-core hosts
            # keep the overlap; TPUBWA_NO_PREFETCH=1/0 forces either
            # way.
            parts = [self._chunk_regs(c, *self._seed_chunk(c))
                     for c in chunks]
            if len(parts) == 1:
                return parts[0]
            return _concat_parts(parts)
        # double-buffer: seed chunk i+1 on a worker thread while the
        # main thread chains/extends/posts chunk i (device transfers
        # release the GIL, so host work genuinely overlaps)
        from concurrent.futures import ThreadPoolExecutor
        parts = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._seed_chunk, chunks[0])
            for i, chunk in enumerate(chunks):
                rows, positions, qd = fut.result()
                if i + 1 < len(chunks):
                    fut = ex.submit(self._seed_chunk, chunks[i + 1])
                parts.append(self._chunk_regs(chunk, rows, positions,
                                              qd))
        return _concat_parts(parts)

    def __call__(self, reads: Sequence[Read]) -> List[List[AlnReg]]:
        return self.align_batch(reads)


def _concat_parts(parts):
    from ..host.native_emit import FlatRegs
    if all(isinstance(p, FlatRegs) for p in parts):
        return FlatRegs.concat(parts)
    out: List[List[AlnReg]] = []
    for p in parts:
        out.extend(list(p) if isinstance(p, FlatRegs) else p)
    return out


def _nest_intv(intv):
    """Flat (rows, per-read counts) -> per-read row arrays (the
    scalar mem_chain contract; fallback path only)."""
    flat, counts = intv
    return np.split(flat, np.cumsum(counts)[:-1])


def _nest_positions(per_read_intv, positions):
    """Flat (pos, cnt) -> per-read lists of per-interval position
    arrays (the scalar mem_chain contract; fallback path only)."""
    pos, cnt = positions
    ends = np.cumsum(cnt)
    out = []
    ii = 0
    for rows in per_read_intv:
        per = []
        for _ in range(len(rows)):
            per.append(pos[int(ends[ii] - cnt[ii]):int(ends[ii])])
            ii += 1
        out.append(per)
    return out


def _serialize_per_read(plans_by_read):
    def chain_gens(gens):
        for g in gens:
            try:
                job = next(g)
                while True:
                    result = yield job
                    job = g.send(result)
            except StopIteration:
                continue
    return [chain_gens(gens) for gens in plans_by_read if gens]


def make_device_aligner(opt: MemOpt, fmi: FMIndex,
                        platform: str = "auto",
                        mesh=None) -> DeviceAligner:
    return DeviceAligner(opt, fmi, platform=platform, mesh=mesh)
