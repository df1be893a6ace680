"""Ragged-serving benchmark: bucketed vs whole-batch decode of a
length-skewed workload.

No reference analog — the reference decodes sequences serially
(`bench_Viterbi.h:53-56`), so raggedness costs it nothing and it measures
nothing about it. A batched decoder pays the global max length for every
lane unless it buckets; this benchmark quantifies that on a real
length profile (default: covid-19, 38-7,096 symbols, replicated to fill
the lane budget).

Columns (`.dat` TSV, one row per model):
- ``whole_e2e`` / ``bucket_e2e``: `decode_batch` wall ms including
  host↔device transfers.
- ``whole_compute`` / ``bucket_compute``: pre-staged decode ms — batches
  staged on device, all calls enqueued, one drain (distinct inputs per
  rep, so no rep can replay a cached result).
"""

from __future__ import annotations

import time

import numpy as np

from spec_viterbi.bench.harness import get_median, print_benchmarks_to_file_as_dat
from spec_viterbi.io import read_emit_seq, read_hmm
from spec_viterbi.ops.fused_pallas import FusedStructuredDecoder, fused_eligible
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.utils.batching import bucket_plan

HEADERS = (
    "States",
    "whole_e2e",
    "bucket_e2e",
    "whole_compute",
    "bucket_compute",
    "path_whole_e2e",
    "path_bucket_e2e",
)


def _workload(lens, emit_num, seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, emit_num, size=t).astype(np.int32) for t in lens]


def benchmark_ragged(
    chmm_path: str,
    ess_path: str,
    copies: int = 32,
    times_to_run: int = 3,
    interpret: bool = False,
):
    """Returns ``(states_num, [whole_e2e, bucket_e2e, whole_comp,
    bucket_comp, path_whole_e2e, path_bucket_e2e])`` medians in ms
    (HEADERS order; path columns are NaN when the whole-batch
    backpointer tensor exceeds the HBM budget)."""
    hmm = read_hmm(chmm_path)
    sop = StructuredOperator.from_hmm(hmm)
    if not fused_eligible(sop):
        raise ValueError("ragged bench needs a fused-eligible model")
    fd = FusedStructuredDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        interpret=interpret,
    )
    lens = [len(s) for s in read_emit_seq(ess_path)] * copies

    # Variant reps are INTERLEAVED (whole, bucket, whole, bucket, …) so a
    # drift in host or device speed biases neither variant. Seeds stay
    # disjoint BETWEEN variants, so the two never issue the identical
    # computation.
    e2e_times: dict[bool, list[float]] = {False: [], True: []}
    for bucketed in (False, True):
        voff = 5000 if bucketed else 0
        fd.decode_batch(_workload(lens, hmm.emit_num, 999 + voff), bucketed=bucketed)
    for rep in range(times_to_run):
        for bucketed in (False, True):
            voff = 5000 if bucketed else 0
            seqs = _workload(lens, hmm.emit_num, rep + voff)
            t0 = time.perf_counter()
            fd.decode_batch(seqs, bucketed=bucketed)
            e2e_times[bucketed].append((time.perf_counter() - t0) * 1e3)
    results = [get_median(sorted(e2e_times[False])), get_median(sorted(e2e_times[True]))]

    # pre-staged compute: distinct staged workloads per rep AND variant,
    # one probe per timed rep, variants interleaved as above
    staged: dict[bool, list] = {}
    for bucketed in (False, True):
        voff = 5000 if bucketed else 0
        reps = []
        for rep in range(times_to_run):
            seqs = _workload(lens, hmm.emit_num, 100 + rep + voff)
            if bucketed:
                plan = bucket_plan([len(s) for s in seqs]) or [
                    (list(range(len(seqs))), None)
                ]
                reps.append(
                    [
                        fd.prepare([seqs[i] for i in idx], t_pad=t)
                        for idx, t in plan
                    ]
                )
            else:
                reps.append([fd.prepare(seqs)])
        # warm every compiled shape with THROWAWAY handles, so timed rep 0
        # is not a repeat of the warm-up computation
        wseqs = _workload(lens, hmm.emit_num, 777 + voff)
        if bucketed:
            plan = bucket_plan([len(s) for s in wseqs]) or [
                (list(range(len(wseqs))), None)
            ]
            warm = [fd.prepare([wseqs[i] for i in idx], t_pad=t) for idx, t in plan]
        else:
            warm = [fd.prepare(wseqs)]
        last = None
        for st, ln in warm:
            last = fd._jit_run(st, ln)
        np.asarray(last[:1, :1])
        staged[bucketed] = reps
    comp_times: dict[bool, list[float]] = {False: [], True: []}
    for rep in range(times_to_run):
        for bucketed in (False, True):
            hs = staged[bucketed][rep]
            t0 = time.perf_counter()
            last = None
            for st, ln in hs:
                last = fd._jit_run(st, ln)
            np.asarray(last[:1, :1])
            comp_times[bucketed].append((time.perf_counter() - t0) * 1e3)
    results += [
        get_median(sorted(comp_times[False])),
        get_median(sorted(comp_times[True])),
    ]

    # exact-path decode (scores + int16 backpointers + device backtrace):
    # whole-batch pays the global max length per lane AND per backpointer
    # byte — on big models the whole-batch bp tensor can exceed the HBM
    # budget even lane-chunked; a NaN column records that policy honestly
    # (same convention as the spec bench memory policy).
    path_times: dict[bool, list[float]] = {False: [], True: []}
    for bucketed in (False, True):
        voff = 7000 if bucketed else 2000
        try:
            fd.decode_path_batch(
                _workload(lens, hmm.emit_num, 998 + voff), bucketed=bucketed
            )
        except Exception as exc:
            # ONLY the documented memory-policy failures become the NaN
            # column: the library's own budget rejection (ValueError) or a
            # device RESOURCE_EXHAUSTED — the whole-batch variant has no
            # pre-flight guard and hits real HBM OOM on big models. Any
            # other failure is a decode_path_batch regression and must
            # propagate.
            oom = "RESOURCE_EXHAUSTED" in str(exc) or "out of memory" in str(
                exc
            ).lower()
            if not (isinstance(exc, ValueError) and "budget" in str(exc)) and not oom:
                raise
            path_times[bucketed] = None
    for rep in range(times_to_run):
        for bucketed in (False, True):
            if path_times[bucketed] is None:
                continue
            voff = 7000 if bucketed else 2000
            seqs = _workload(lens, hmm.emit_num, rep + voff)
            t0 = time.perf_counter()
            fd.decode_path_batch(seqs, bucketed=bucketed)
            path_times[bucketed].append((time.perf_counter() - t0) * 1e3)
    results += [
        get_median(sorted(path_times[b])) if path_times[b] else float("nan")
        for b in (False, True)
    ]
    return hmm.states_num, results


def benchmark_ragged_to_dat_file(
    chmm_paths: list[str],
    ess_path: str,
    out_file: str,
    copies: int = 32,
    times_to_run: int = 3,
) -> None:
    bench: dict[int, list[float]] = {}
    for path in chmm_paths:
        states, row = benchmark_ragged(
            path, ess_path, copies=copies, times_to_run=times_to_run
        )
        bench[states] = row
        print(f"{path}: {['%.1f' % t for t in row]}", flush=True)
        # per-model flush: killed sweeps keep their completed rows
        print_benchmarks_to_file_as_dat(out_file, HEADERS, bench)
    print_benchmarks_to_file_as_dat(out_file, HEADERS, bench)
