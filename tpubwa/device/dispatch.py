"""Extension-wave dispatch: gather -> batch -> kernel -> scatter
(SURVEY.md §2 row 17, §3.4 — the device analogue of the reference's
QuickAssist offload layer).

Every read's mem_chain2aln logic runs as a host-side generator
(host/regions.py:extension_plan); this module advances ALL generators
in lockstep waves.  Each wave collects one pending extension job per
plan, pads them into fixed-shape arrays, runs ONE device program
(device/extend.py), and scatters the 6-tuple
results back.  Band-doubling retries and the left->right h0 dependency
naturally become successive waves — the same 2-3 dispatch rounds per
batch the FPGA fork used.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..opts import MemOpt
from ..ref.ksw import KswExt, ksw_extend

# job tuple layout from extension_plan:
# (qlen, q, tlen, t, w, end_bonus, h0)


class WaveExtender:
    """Drives extension_plan generators to completion in batched waves."""

    def __init__(self, opt: MemOpt, mat: np.ndarray, qmax: int = 511,
                 tmax: int = 1024, batch_fn: Optional[Callable] = None,
                 fused: bool = False, mesh=None):
        # qmax default = LANES-1 of the widest row-loop bucket: at 256
        # the adapters would reject every longer job to the scalar
        # fallback
        self.opt = opt
        self.mesh = mesh
        self.mat = np.asarray(mat, np.int32)
        self.qmax = qmax
        self.tmax = tmax
        self.n_waves = 0
        self.n_jobs = 0
        self.n_fallback = 0
        self.fused = fused
        if batch_fn is not None:
            self.batch_fn = batch_fn
        elif fused:
            self.batch_fn = self._make_fused_fn()
        else:
            self.batch_fn = self._make_batch_fn()

    def _make_fused_fn(self):
        from .extend_fused import extend_seed_batch_np

        def run(jobs):
            return extend_seed_batch_np(
                jobs, self.mat, self.opt.o_del, self.opt.e_del,
                self.opt.o_ins, self.opt.e_ins, self.opt.zdrop,
                self.qmax, self.tmax)
        return run

    def _make_batch_fn(self):
        from .extend import extend_rows_np

        def run(jobs):
            return extend_rows_np(jobs, self.mat, self.opt.o_del,
                                  self.opt.e_del, self.opt.o_ins,
                                  self.opt.e_ins, self.opt.zdrop,
                                  self.qmax, self.tmax)
        return run

    def _scalar(self, job) -> KswExt:
        qlen, q, tlen, t, w, eb, h0 = job
        self.n_fallback += 1
        return ksw_extend(qlen, q, tlen, t, self.mat, self.opt.o_del,
                          self.opt.e_del, self.opt.o_ins, self.opt.e_ins,
                          w, eb, self.opt.zdrop, h0)

    def _scalar_fused(self, job) -> np.ndarray:
        from .extend_fused import scalar_fused
        self.n_fallback += 1
        if job[0] == 'D':
            job = self._materialize(job)
        return scalar_fused(job, self.mat, self.opt.o_del, self.opt.e_del,
                            self.opt.o_ins, self.opt.e_ins,
                            self.opt.zdrop)

    # ---- descriptor mode (tiles built on device from resident data)
    def set_chunk_ctx(self, didx, qd, reads, bnt) -> None:
        self.ctx = (didx, qd, reads, bnt)

    def _materialize(self, job):
        """Rebuild the sequence-tile job for a descriptor (oversize /
        scalar fallback) — same slices the non-desc planner yields."""
        _, ri, qbeg, slen, lq, rbeg, rmax0, rmax1, w0, h0, p5, p3 = job
        _, _, reads, bnt = self.ctx
        query = reads[ri].seq
        qe = qbeg + slen
        qlen_r = lq - qe
        empty = query[:0]
        if qbeg:
            qs = query[:qbeg][::-1].copy()
            tlen_l = rbeg - rmax0
            ts = bnt.get_seq(rmax0, rbeg)[::-1].copy()
        else:
            qs, tlen_l, ts = empty, 0, empty
        if qlen_r:
            tlen_r = rmax1 - rbeg - slen
            tr = bnt.get_seq(rbeg + slen, rmax1)
        else:
            tlen_r, tr = 0, empty
        return (qbeg, qs, tlen_l, ts, qlen_r, query[qe:], tlen_r, tr,
                w0, h0, p5, p3)

    def _oversize(self, job) -> bool:
        if job[0] == 'D':
            _, ri, qbeg, slen, lq, rbeg, rmax0, rmax1 = job[:8]
            qlen_r = lq - qbeg - slen
            tlen_l = rbeg - rmax0 if qbeg else 0
            tlen_r = rmax1 - rbeg - slen if qlen_r else 0
            return (qbeg > self.qmax or qlen_r > self.qmax
                    or tlen_l > self.tmax or tlen_r > self.tmax)
        return (job[0] > self.qmax or job[2] > self.tmax
                or job[4] > self.qmax or job[6] > self.tmax)

    def run_fused(self, plans: List) -> None:
        """plans: generators from extension_plan(fused=True); one job
        per seed, one device call per wave."""
        live = []
        for g in plans:
            try:
                live.append([g, next(g)])
            except StopIteration:
                pass
        while live:
            for ent in live:
                job = ent[1]
                while job is not None and self._oversize(job):
                    try:
                        job = ent[0].send(self._scalar_fused(job))
                    except StopIteration:
                        job = None
                ent[1] = job
            live = [e for e in live if e[1] is not None]
            if not live:
                break
            self.n_waves += 1
            self.n_jobs += len(live)
            jobs = [e[1] for e in live]
            if jobs[0][0] == 'D':
                from .extend_fused import extend_seed_desc_np
                didx, qd = self.ctx[0], self.ctx[1]
                rows = extend_seed_desc_np(
                    didx, qd, jobs, self.mat, self.opt.o_del,
                    self.opt.e_del, self.opt.o_ins, self.opt.e_ins,
                    self.opt.zdrop, self.tmax, mesh=self.mesh)
            else:
                rows = self.batch_fn(jobs)
            nxt = []
            for i, ent in enumerate(live):
                try:
                    ent[1] = ent[0].send(rows[i])
                    nxt.append(ent)
                except StopIteration:
                    pass
            live = nxt

    def run(self, plans: List) -> None:
        """plans: generators from extension_plan (mutate their av)."""
        if self.fused:
            return self.run_fused(plans)
        # prime every generator to its first job
        live = []
        for g in plans:
            try:
                job = next(g)
                live.append([g, job])
            except StopIteration:
                pass
        while live:
            # oversized jobs take the scalar fallback inline
            wave = []
            for ent in live:
                job = ent[1]
                while job is not None and (job[0] > self.qmax
                                           or job[2] > self.tmax):
                    try:
                        job = ent[0].send(self._scalar(job))
                    except StopIteration:
                        job = None
                ent[1] = job
            live = [e for e in live if e[1] is not None]
            if not live:
                break
            jobs = [dict(q=e[1][1][:e[1][0]], t=e[1][3][:e[1][2]],
                         w=e[1][4], end_bonus=e[1][5], h0=e[1][6])
                    for e in live]
            self.n_waves += 1
            self.n_jobs += len(jobs)
            # fixed-size blocks: bounds device memory AND keeps the set
            # of compiled job-count shapes small ({64..512} pow2)
            cap = 512
            if len(jobs) <= cap:
                score, qle, tle, gtle, gscore, max_off = \
                    self.batch_fn(jobs)
            else:
                parts = [self.batch_fn(jobs[s:s + cap])
                         for s in range(0, len(jobs), cap)]
                score, qle, tle, gtle, gscore, max_off = (
                    np.concatenate([p[k] for p in parts])
                    for k in range(6))
            nxt = []
            for i, ent in enumerate(live):
                r = KswExt(score=int(score[i]), qle=int(qle[i]),
                           tle=int(tle[i]), gtle=int(gtle[i]),
                           gscore=int(gscore[i]),
                           max_off=int(max_off[i]))
                try:
                    ent[1] = ent[0].send(r)
                    nxt.append(ent)
                except StopIteration:
                    pass
            live = nxt
