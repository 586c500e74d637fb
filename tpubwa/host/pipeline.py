"""Per-batch alignment orchestration (bwamem.c:mem_align1_core/~1080,
mem_process_seqs/~1150, worker1/worker2/~1100; SURVEY.md §2 row 3).

``align1_core`` produces regions for one read; ``process_seqs`` maps a
batch of reads to SAM lines.  The seeding/extension callables default to
the scalar oracle; the device pipeline substitutes batched device stages
producing identical regions (the QuickAssist gather->dispatch->scatter
shape, SURVEY.md §3.4)."""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..index.fmindex import FMIndex
from ..io.fastq import Read
from ..opts import MEM_F_PE, MemOpt
from .chain import chain_flt, flt_chained_seeds, mem_chain
from .regions import AlnReg, chain2aln, mark_primary, sort_dedup_patch
from .sam import reg2sam

log = logging.getLogger("tpubwa")


def align1_core(opt: MemOpt, fmi: FMIndex, read: Read,
                mat: np.ndarray) -> List[AlnReg]:
    """Seed -> chain -> filter -> extend -> dedup for one read."""
    q = read.seq
    chains = mem_chain(opt, fmi, q)
    chains = chain_flt(opt, chains)
    flt_chained_seeds(opt, fmi.bnt, read.l_seq, q, chains, mat)
    regs: List[AlnReg] = []
    for c in chains:
        chain2aln(opt, fmi.bnt, read.l_seq, q, c, regs, mat)
    regs = sort_dedup_patch(opt, fmi.bnt, q, regs, mat)
    for r in regs:
        if r.rid >= 0 and fmi.bnt.anns[r.rid].is_alt:
            r.is_alt = 1
    return regs


def sam_header(fmi: FMIndex, rg_line: Optional[str], pg_cl: str,
               version: str, hdr_lines=None) -> str:
    lines = []
    for a in fmi.bnt.anns:
        # ALT contigs carry the AH:* tag (bwa.c:bwa_print_sam_hdr)
        ah = "\tAH:*" if getattr(a, "is_alt", 0) else ""
        lines.append(f"@SQ\tSN:{a.name}\tLN:{a.length}{ah}")
    if rg_line:
        lines.append(rg_line.replace("\\t", "\t"))
    for h in hdr_lines or []:  # -H (bwa_print_sam_hdr hdr_lines)
        lines.append(h.replace("\\t", "\t"))
    lines.append(f"@PG\tID:tpubwa\tPN:tpubwa\tVN:{version}\tCL:{pg_cl}")
    return "\n".join(lines) + "\n"


def align_phase(opt: MemOpt, fmi: FMIndex, reads: Sequence[Read],
                mat: np.ndarray,
                align_fn: Optional[Callable] = None):
    """worker1: batch -> per-read region lists."""
    align = align_fn or (lambda batch: [align1_core(opt, fmi, r, mat)
                                        for r in batch])
    return align(list(reads))


def emit_phase(opt: MemOpt, fmi: FMIndex, reads: Sequence[Read],
               all_regs, n_processed: int, mat: np.ndarray,
               rg_id: str = "", pes0=None) -> List[str]:
    """worker2: regions -> SAM lines (pairing, MAPQ, text).

    Runs the native (C++) port when available — byte-identical output
    (tests/test_native_emit.py), ~50x less interpreter time on the
    single host core; TPUBWA_NO_NATIVE_EMIT=1 forces the Python path."""
    pes = None
    if opt.flag & MEM_F_PE:
        from .pair import pestat
        pes = pes0 if pes0 is not None else \
            pestat(opt, fmi.bnt.l_pac, all_regs)
    from .native_emit import emit_batch_native
    if reads:
        native = emit_batch_native(opt, fmi, reads, all_regs,
                                   n_processed, rg_id, pes)
        if native is not None:
            return native
    out: List[str] = []
    if opt.flag & MEM_F_PE:
        from .pair import sam_pe
        for i in range(0, len(reads), 2):
            pair_id = (n_processed >> 1) + (i >> 1)
            out.extend(sam_pe(opt, fmi, pes, pair_id,
                              (reads[i], reads[i + 1]),
                              (all_regs[i], all_regs[i + 1]), mat, rg_id))
    else:
        for i, (read, regs) in enumerate(zip(reads, all_regs)):
            mark_primary(opt, regs, n_processed + i)
            out.extend(reg2sam(opt, fmi.bnt, read.name, read.seq,
                               read.qual, read.l_seq, regs, 0, None, mat,
                               rg_id, read.comment))
    return out


def process_seqs(opt: MemOpt, fmi: FMIndex, reads: Sequence[Read],
                 n_processed: int, mat: Optional[np.ndarray] = None,
                 rg_id: str = "",
                 align_fn: Optional[Callable] = None,
                 pes0=None) -> List[str]:
    """mem_process_seqs: batch -> SAM lines (order == input order).
    Handles SE and PE (MEM_F_PE) modes.  ``pes0``: fixed insert-size
    distribution (-I), bypassing per-batch inference (§3.2: chunk
    granularity otherwise affects PE output, as in stock bwa)."""
    if mat is None:
        mat = opt.scoring_matrix()
    t0 = time.perf_counter()
    all_regs = align_phase(opt, fmi, reads, mat, align_fn)
    out = emit_phase(opt, fmi, reads, all_regs, n_processed, mat,
                     rg_id, pes0)
    dt = time.perf_counter() - t0
    log.info("[M::process_seqs] Processed %d reads in %.3f CPU sec",
             len(reads), dt)
    return out


# process-wide sticky align-ahead decision (see process_batches):
# a measured "overlap wins here" carries across calls so later bench
# reps / CLI batches don't re-pay the serial probe
_OVERLAP_STICKY = [False]


def process_batches(opt: MemOpt, fmi: FMIndex, batch_iter,
                    n_processed0: int = 0,
                    mat: Optional[np.ndarray] = None, rg_id: str = "",
                    align_fn: Optional[Callable] = None, pes0=None):
    """kt_pipeline analogue (kthread.c:~100, SURVEY.md §2 row 19):
    align batch i+1 on a worker thread while batch i is paired and
    emitted on the main thread.  Yields (reads, sam_lines) per batch in
    input order — output is deterministic regardless of overlap.

    batch_iter yields read batches (the caller controls chunking, so
    pestat granularity matches stock bwa's chunk semantics).

    Single-core overlap policy (round-4): the batch-level align-ahead
    thread was measured HARMFUL on uniform corpora (emit ~0.8 s vs
    align ~3.2 s: the thread only steals timeslices from native emit)
    but is the single biggest lever on repeat-realistic corpora, where
    emit is ~8.6 s of GIL-free C++ and the align phase spends ~8 s
    BLOCKED on device syncs that emit can hide under.  Policy: start
    serial, measure both walls, and flip overlap on (sticky) once
    emit_wall >= 0.3 * align_wall.  TPUBWA_BATCH_OVERLAP=1/0 forces;
    multi-core hosts keep the overlap unconditionally.

    The flip is sticky PROCESS-WIDE (round-5): bench/profile reps
    call process_batches once per rep with ~3 batches, and a per-call
    flip left every rep's first two batches serial — the measured
    wall was fully serial (3,272 reads/s with the stage sums adding
    exactly to the wall).  One measured flip now carries to every
    later call; output is identical either way, only scheduling
    changes."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    import time as _time
    if mat is None:
        mat = opt.scoring_matrix()
    from ..utils import serial_pipeline
    force = os.environ.get("TPUBWA_BATCH_OVERLAP")
    if force is not None and force.strip():
        overlap = force.strip().lower() not in ("0", "false", "no",
                                                "off")
        adaptive = False
    elif os.environ.get("TPUBWA_NO_PREFETCH", "").strip():
        # explicit prefetch force (either way): follow it verbatim,
        # no adaptivity — the prefetch-mode equality tests rely on
        # deterministic scheduling
        overlap = not serial_pipeline()
        adaptive = False
    else:
        overlap = (not serial_pipeline()) or _OVERLAP_STICKY[0]
        adaptive = not overlap
    n_processed = n_processed0
    with ThreadPoolExecutor(max_workers=1) as ex:
        def stage1():
            batch = next(batch_iter, None)
            if batch is None:
                return None
            return batch, align_phase(opt, fmi, batch, mat, align_fn)

        fut = ex.submit(stage1) if overlap else None
        while True:
            t0 = _time.perf_counter()
            res = fut.result() if fut is not None else stage1()
            t_align = _time.perf_counter() - t0
            if res is None:
                break
            fut = ex.submit(stage1) if overlap else None
            batch, all_regs = res
            t0 = _time.perf_counter()
            lines = emit_phase(opt, fmi, batch, all_regs, n_processed,
                               mat, rg_id, pes0)
            t_emit = _time.perf_counter() - t0
            if adaptive and not overlap and t_emit >= 0.3 * t_align:
                # emit is heavy enough to hide the next batch's device
                # waits under; flip the lookahead on (sticky for the
                # whole process, not just this call)
                overlap = True
                _OVERLAP_STICKY[0] = True
                log.info("[M::process_batches] overlap on "
                         "(emit %.2fs vs align %.2fs)", t_emit, t_align)
            n_processed += len(batch)
            yield batch, lines
