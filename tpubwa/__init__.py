"""tpubwa — a BWA-MEM short-read aligner on a JAX accelerator.

A from-scratch reimplementation of the capabilities of
peterpengwei/bwa-mem-quickassist (BWA-MEM with batched accelerator
offload of the banded Smith-Waterman seed extension), built on JAX:
FM-index seeding as batched vectorized occ-table gathers, seed
extension as a batched wavefront row loop on the device,
host-orchestrated chaining / MAPQ / SAM stages, data-parallel scaling
over a jax.sharding.Mesh.  See SURVEY.md for the component map.
"""

__version__ = "0.1.0"

from .opts import MemOpt

__all__ = ["MemOpt", "__version__"]
