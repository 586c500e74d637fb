"""Data-parallel scaling (SURVEY.md §2.2, §5.8).

The reference is a single-node pthreads program (kthread.c); this
framework scales the same embarrassingly-parallel read axis over a
jax.sharding.Mesh instead:

* multi-HOST: deterministic FASTQ byte-range shards per host (computed,
  not communicated), per-shard SAM files merged by shard index — no
  data-plane collective is needed for correctness (§5.8);
* multi-CHIP: the per-batch device programs (SMEM reach, SA walk,
  extension waves) are batched elementwise-over-jobs with a REPLICATED
  FM-index, so sharding the job axis over a 'dp' mesh axis partitions
  every gather locally; the extension row loop runs under shard_map,
  so each device stops at its own jobs' exit.

``DataParallel`` owns the mesh and the sharded entry points; the
single-chip path is the mesh=None special case.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


# ---------------------------------------------------------------------
# Host-level sharding: deterministic FASTQ byte ranges
# ---------------------------------------------------------------------

def byte_range_shards(path: str, n_shards: int) -> List[Tuple[int, int]]:
    """Split a PLAIN (non-gz) FASTQ into n byte ranges snapped to record
    boundaries: each shard starts at the first '@' header line at or
    after its nominal offset.  Deterministic for any reader count."""
    size = os.path.getsize(path)
    nominal = [size * i // n_shards for i in range(n_shards)] + [size]
    starts = []
    with open(path, "rb") as fh:
        for off in nominal[:-1]:
            starts.append(_snap_to_record(fh, off, size))
    # degenerate shards (snapped past the next) become empty
    out = []
    for i in range(n_shards):
        lo = starts[i]
        hi = starts[i + 1] if i + 1 < n_shards else size
        out.append((lo, max(hi, lo)))
    return out


def _snap_to_record(fh, off: int, size: int) -> int:
    """First FASTQ record start at or after off.  A line starting with
    '@' is a header iff two lines later comes '+' (quality lines can
    also start with '@')."""
    if off == 0:
        return 0
    fh.seek(off)
    fh.readline()  # discard partial line
    while True:
        pos = fh.tell()
        line = fh.readline()
        if not line:
            return size
        if line.startswith(b"@"):
            fh.readline()            # seq
            plus = fh.readline()
            if plus.startswith(b"+"):
                return pos
            fh.seek(pos)
            fh.readline()
        # else keep scanning


def fastq_shard_reader(path: str, lo: int, hi: int):
    """Iterate reads of byte range [lo, hi) of a plain FASTQ.  A record
    whose header starts at < hi is fully consumed even if it crosses hi
    (ranges from byte_range_shards are record-aligned)."""
    from ..io.fastq import Read, encode_seq
    with open(path, "rb") as fh:
        fh.seek(lo)
        while fh.tell() < hi:
            hdr = fh.readline()
            if not hdr:
                break
            if not hdr.startswith(b"@"):
                raise ValueError(f"shard not record-aligned at {lo}")
            seq = fh.readline().rstrip()
            fh.readline()
            qual = fh.readline().rstrip()
            h = hdr[1:].rstrip().split(None, 1)
            yield Read(name=h[0].decode(), seq=encode_seq(seq),
                       qual=qual.decode() if qual else None,
                       comment=h[1].decode() if len(h) > 1 else "")


def plan_shards(path: str, process_index: int, process_count: int,
                shards_per_process: int = 1) -> List[Tuple[int, int, int]]:
    """(shard_id, lo, hi) list owned by this process — computed
    independently and identically on every host (no communication)."""
    total = process_count * shards_per_process
    ranges = byte_range_shards(path, total)
    return [(i, *ranges[i]) for i in range(total)
            if i % process_count == process_index]


def merge_shard_files(shard_paths: Sequence[str], out_path: str,
                      header: str = "") -> None:
    """Deterministic SAM merge: concatenate per-shard bodies in shard
    order (shard_paths must be pre-sorted by shard_id)."""
    with open(out_path, "w") as out:
        if header:
            out.write(header)
        for p in shard_paths:
            with open(p) as fh:
                for line in fh:
                    if not line.startswith("@"):
                        out.write(line)


# ---------------------------------------------------------------------
# Chip-level sharding: 'dp' mesh over the read/job axis
# ---------------------------------------------------------------------

@dataclass
class DataParallel:
    """Mesh wrapper: replicates FM-index arrays, shards job arrays."""
    mesh: Mesh

    @classmethod
    def over(cls, devices=None, axis: str = "dp") -> "DataParallel":
        devices = devices if devices is not None else jax.devices()
        mesh = Mesh(np.array(devices), (axis,))
        return cls(mesh=mesh)

    @property
    def n(self) -> int:
        return self.mesh.devices.size

    def replicated(self, x):
        return jax.device_put(x, NamedSharding(self.mesh, P()))

    def sharded(self, x):
        """Shard axis 0 (pad to a multiple of mesh size first)."""
        return jax.device_put(x, NamedSharding(self.mesh, P("dp")))

    def pad(self, n: int) -> int:
        m = self.n
        return ((n + m - 1) // m) * m

    def replicate_index(self, didx):
        """DeviceIndex with every array replicated over the mesh.
        Built generically from the pytree so new index arrays can't be
        silently dropped."""
        children, aux = didx.tree_flatten()
        return type(didx).tree_unflatten(
            aux, tuple(self.replicated(c) for c in children))

    def shard_map_extend(self, a: int, b: int, o_del: int, e_del: int,
                         o_ins: int, e_ins: int, zdrop: int):
        """device.extend.extend_rows under shard_map over 'dp': takes
        (q, t, qlen, tlen, h0, w, end_bonus) sharded on the job axis."""
        from jax import shard_map
        from ..device.extend import extend_rows

        def local(q, t, qlen, tlen, h0, w, eb):
            return extend_rows(q, t, qlen, tlen, h0, w, eb, a, b, o_del,
                               e_del, o_ins, e_ins, zdrop)
        return jax.jit(shard_map(
            local, mesh=self.mesh, in_specs=(P("dp"),) * 7,
            out_specs=P("dp"), check_vma=False))
