"""Dataset-level benchmark drivers — parity with ``benchmark/bench_Viterbi.h``
and ``benchmark/bench_Viterbi_spec.h``.

Shape preserved from the reference:

- iterate every ``*.chmm`` in a models directory (``bench_Viterbi.h:37-48``),
- timed unit = decode **all** sequences of the dataset once
  (``bench_Viterbi.h:51-57``) — here as one batched device program (the DP
  upgrade) with the sequence batch pre-staged on device, so the timed
  region is decode compute;
- median of N runs into a map keyed by state count (``:58-60``),
- spec benchmarks time ``spec_with`` (prep) and ``run_Viterbi_spec``
  (decode) separately, emitting paired ``<impl>_spec_<L>_prep`` /
  ``<impl>_spec_<L>`` columns (``bench_Viterbi_spec.h:33-47,67-84``).

The reference's "backend" axis (GraphBLAS/CUSP/cuASR) maps to this
framework's execution modes (dense / structured; on a GPU the structured
mode rides the whole-sequence kernel).
"""

from __future__ import annotations

import contextlib
import glob
import os
import signal

import numpy as np

from spec_viterbi.bench import harness
from spec_viterbi.io import read_emit_seq, read_hmm
from spec_viterbi.models.decoder import ViterbiDecoder
from spec_viterbi.models.specializer import SpecializedViterbi

DEFAULT_MODES = ("dense", "structured")

# The default .dat column configuration.
ARTIFACT_MODES = DEFAULT_MODES
ARTIFACT_LEVELS = (1, 2)
ARTIFACT_STRUCT_LEVELS = (1, 2, 3)


def nonspec_headers(modes: tuple[str, ...] = DEFAULT_MODES) -> list[str]:
    """Column contract of a non-spec ``.dat`` (``bench_Viterbi.h:31``)."""
    return ["States", *modes]


def spec_headers(
    levels: tuple[int, ...] = ARTIFACT_LEVELS,
    struct_levels: tuple[int, ...] = ARTIFACT_STRUCT_LEVELS,
) -> list[str]:
    """Column contract of a spec ``.dat``: paired prep/decode columns per
    impl × level (``bench_Viterbi_spec.h:29-47``)."""
    headers = ["States"]
    for name, impl_levels in (("spec", levels), ("spec_struct", struct_levels)):
        for level in impl_levels:
            headers += [f"{name}_{level}_prep", f"{name}_{level}"]
    return headers

# A hung cell (compile or run) must cost one NaN cell, not the whole sweep.
CELL_DEADLINE_S = int(os.environ.get("SVT_BENCH_CELL_DEADLINE_S", "900"))


@contextlib.contextmanager
def _cell_deadline(seconds: int = CELL_DEADLINE_S):
    """SIGALRM deadline for one benchmark cell (main thread only)."""
    if seconds <= 0:
        yield
        return

    def _raise(signum, frame):
        raise TimeoutError(f"benchmark cell exceeded {seconds}s")

    prev = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def _iter_models(chmm_dir: str, max_states: int | None = None):
    for path in sorted(glob.glob(os.path.join(chmm_dir, "*.chmm"))):
        hmm = read_hmm(path)
        if max_states is not None and hmm.states_num > max_states:
            continue
        yield path, hmm


def benchmark_viterbi_impls_to_dat_file(
    chmm_dir: str,
    ess_path: str,
    out_path: str,
    modes: tuple[str, ...] = DEFAULT_MODES,
    times_to_run: int = harness.TIMES_TO_RUN,
    max_states: int | None = None,
    verbose: bool = True,
) -> dict[int, list[float]]:
    """Non-spec benchmark: one column per execution mode
    (``bench_Viterbi.h:17-69``)."""
    seqs = read_emit_seq(ess_path)
    max_sym = max((int(s.max()) for s in seqs if len(s)), default=-1)
    bench: dict[int, list[float]] = {}
    for path, hmm in _iter_models(chmm_dir, max_states):
        if hmm.emit_num <= max_sym:
            # mismatched model/dataset alphabets now raise at decode; the
            # sweep-all-models driver skips such pairs explicitly instead
            print(
                f"[bench] skipping {os.path.basename(path)}: alphabet "
                f"{hmm.emit_num} does not cover dataset symbols (max {max_sym})"
            )
            continue
        if hmm.states_num in bench:
            # .dat rows are keyed by state count (benchmark_helper.h:68-89);
            # a second same-size model would corrupt the table — skip it.
            print(
                f"[bench] skipping {os.path.basename(path)}: a model with "
                f"{hmm.states_num} states was already benchmarked"
            )
            continue
        if verbose:
            print(f"[bench] {os.path.basename(path)} ({hmm.states_num} states)")
        row: list[float] = []
        for mode in modes:
            try:
                with _cell_deadline():
                    dec = ViterbiDecoder(hmm, mode=mode)
                    handle = dec.prepare_batch(seqs)

                    def run():
                        harness.block_output(dec.run_batch(handle))

                    run()  # warmup/compile outside the timed runs
                    row.append(
                        harness.get_median(
                            harness.get_sorted_run_times(run, times_to_run)
                        )
                    )
            except Exception as exc:
                print(f"[bench] {os.path.basename(path)} {mode}: FAILED ({exc})")
                row.append(float("nan"))
        bench[hmm.states_num] = row
        if verbose:
            print(f"[bench]   -> {row}")
        # per-model flush: killed sweeps keep their completed rows
        harness.print_benchmarks_to_file_as_dat(
            out_path, nonspec_headers(modes), bench
        )
    harness.print_benchmarks_to_file_as_dat(out_path, nonspec_headers(modes), bench)
    return bench


def _spec_decode_runner(spec, seqs):
    """Pre-staged, pipelined decode-all-sequences runner.

    The timed unit mirrors the reference (decode every sequence of the
    dataset once, ``bench_Viterbi_spec.h:74-84``) but the measured region
    is pure device compute: sequences are staged on device up front, the
    per-sequence/per-batch programs are enqueued back-to-back, and ONE
    blocking drain ends the run (a per-sequence host transfer would make
    the columns measure round trips).
    """
    import jax.numpy as jnp

    fused = getattr(spec, "_fused", None)
    if fused is not None:
        handle = fused.prepare(seqs)
        return lambda: harness.block_output(fused.run_prepared(handle))
    delegate = getattr(spec, "_delegate", None)
    if delegate is not None:
        handle = delegate.prepare_batch(seqs)
        return lambda: harness.block_output(delegate.run_batch(handle))
    if hasattr(spec, "_decode_batch_uniform"):
        # composed structured spec: one program per uniform-length bucket
        by_len: dict[int, list] = {}
        for s in seqs:
            by_len.setdefault(len(s), []).append(np.asarray(s, np.int32))
        batches = [
            jnp.asarray(np.stack(group, axis=1))
            for _, group in sorted(by_len.items())
        ]

        def run():
            outs = [spec._decode_batch_uniform(b) for b in batches]
            harness.block_output(outs[-1])

        return run
    # dense spec: identity-pad every sequence to the dataset max so the
    # whole dataset shares ONE compiled shape (identity symbol = index E,
    # specializer._build_level1), enqueue all, drain once
    tmax = max(len(s) for s in seqs)
    e = spec.emit_num
    staged = [
        jnp.asarray(
            np.concatenate(
                [np.asarray(s, np.int32), np.full(tmax - len(s), e, np.int32)]
            )
        )
        for s in seqs
    ]

    def run():
        outs = [spec._decode(s) for s in staged]
        harness.block_output(outs[-1])

    return run


def benchmark_viterbi_spec_impls_to_dat_file(
    chmm_dir: str,
    ess_path: str,
    out_path: str,
    levels: tuple[int, ...] = (1, 2),
    times_to_run: int = harness.TIMES_TO_RUN,
    max_states: int | None = None,
    max_spec_bytes: int = 8 << 30,
    prep_times_to_run: int | None = None,
    verbose: bool = True,
    struct_levels: tuple[int, ...] | None = None,
) -> dict[int, list[float]]:
    """Spec benchmark with paired prep/decode columns
    (``bench_Viterbi_spec.h:16-93``).

    ``max_spec_bytes`` enforces the reference's memory policy deliberately
    (GPU backends stop at level 1 for the 20-symbol corpus,
    ``bench_Viterbi_spec.h:37-47``): level L needs ``(E+1)^L·N²·4`` bytes
    of tuple operators; models over budget get NaN columns at that level.

    ``struct_levels`` extends the STRUCTURED specializer past the dense
    levels (defaults to ``levels``) — the per-impl level asymmetry mirrors
    the reference's own (GraphBLAS L1-2, GPU backends L1, chosen by
    memory; the structured store grows O(E^L·N) instead of O(E^L·N²), so
    it can bench level 3 where the reference cannot run it at all —
    ``test_helper.h:23`` tests L3 but never benches it).
    """
    from spec_viterbi.models.spec_structured import StructuredSpecializedViterbi

    seqs = read_emit_seq(ess_path)
    impls = (
        ("spec", SpecializedViterbi, levels),
        ("spec_struct", StructuredSpecializedViterbi, struct_levels or levels),
    )
    headers = spec_headers(levels, struct_levels or levels)

    max_sym = max((int(s.max()) for s in seqs if len(s)), default=-1)
    bench: dict[int, list[float]] = {}
    for path, hmm in _iter_models(chmm_dir, max_states):
        if hmm.emit_num <= max_sym:
            print(
                f"[bench-spec] skipping {os.path.basename(path)}: alphabet "
                f"{hmm.emit_num} does not cover dataset symbols (max {max_sym})"
            )
            continue
        if hmm.states_num in bench:
            print(
                f"[bench-spec] skipping {os.path.basename(path)}: a model "
                f"with {hmm.states_num} states was already benchmarked"
            )
            continue
        if verbose:
            print(f"[bench-spec] {os.path.basename(path)} ({hmm.states_num} states)")
        row: list[float] = []
        for name, cls, impl_levels in impls:
            for level in impl_levels:
                # the dense specializer hits the reference's memory wall;
                # the structured one stores O(N) vectors per component
                need = cls.spec_memory_bytes(hmm.states_num, hmm.emit_num, level)
                if need > max_spec_bytes:
                    row += [float("nan"), float("nan")]
                    continue
                spec = cls(level=level)

                def prep():
                    spec.spec_with(hmm)
                    # drain: the dense specializer's add_level runs async
                    # on device — without a block the column would measure
                    # dispatch, not the operator build
                    if getattr(spec, "tuple_ops", None) is not None:
                        harness.block_output(spec.tuple_ops)

                try:
                    with _cell_deadline():
                        prep()  # compile
                        prep_t = harness.get_median(
                            harness.get_sorted_run_times(
                                prep, prep_times_to_run or times_to_run
                            )
                        )

                        run = _spec_decode_runner(spec, seqs)
                        run()  # compile
                        run_t = harness.get_median(
                            harness.get_sorted_run_times(run, times_to_run)
                        )
                    row += [prep_t, run_t]
                except Exception as exc:
                    print(
                        f"[bench-spec] {os.path.basename(path)} {name} "
                        f"L{level}: FAILED ({exc})"
                    )
                    row += [float("nan"), float("nan")]
        bench[hmm.states_num] = row
        if verbose:
            print(f"[bench-spec]   -> {row}")
        # flush after EVERY model: a killed sweep (stage timeout) keeps
        # its completed rows — the file is complete-so-far at
        # all times, and the final write is identical to the last flush
        harness.print_benchmarks_to_file_as_dat(out_path, headers, bench)
    harness.print_benchmarks_to_file_as_dat(out_path, headers, bench)
    return bench
