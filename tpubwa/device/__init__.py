"""Device (GPU) compute path.

The two hot stages of BWA-MEM run on device (SURVEY.md §2 rows 5,9,17):

* seeding: batched, vectorized FM-index occ-table gathers (occ.py,
  smem.py) — thousands of backward-search cursors advance in lockstep,
  one fused gather+popcount round per step;
* seed extension: the banded Smith-Waterman wavefront row loop
  (extend.py, extend_fused.py) fed by the gather->batch->kernel->
  scatter dispatch layer (dispatch.py) — the device equivalent of the
  reference's QuickAssist offload (SURVEY.md §3.4).

int64 is required for ranks/positions on human-scale genomes
(2*l_pac for GRCh38 exceeds int32/uint32), so this package enables
jax x64 mode; all dtypes are explicit.
"""

import jax

jax.config.update("jax_enable_x64", True)
