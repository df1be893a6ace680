"""Command-line interface.

The reference's only executable is a zero-flag benchmark loop over a
hardcoded dataset list (``main.cpp:4-23``); a real flag system is a
deliberate upgrade (SURVEY.md §5 config note). Subcommands:

- ``bench``    — the ``main()`` equivalent: non-spec + spec benchmarks over
  datasets × models, `.dat` TSV outputs (``Viterbi_bench_<ds>.dat`` /
  ``Viterbi_spec_bench_<ds>.dat``).
- ``decode``   — decode an .ess against a .chmm, print score vectors (and
  optionally Viterbi paths — this framework's backtrace extension).
- ``sum-dat``  — column sums of a `.dat` file (``benchmark/sum_dat.py``).
- ``info``     — model stats + structured-decomposition report.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

DEFAULT_DATASETS = (  # main.cpp:5-7
    "emit_3_3500_20",
    "emit_3_7000_20",
    "covid-19",
    "emit_50_3500_20",
)


def _cmd_bench(args) -> int:
    import contextlib

    from spec_viterbi.bench import bench_viterbi

    ctx = contextlib.nullcontext()
    if args.trace:
        from spec_viterbi.utils import trace

        ctx = trace(args.trace)  # jax.profiler xplane for per-kernel timing
    os.makedirs(args.out_dir, exist_ok=True)
    with ctx:
        _run_bench_datasets(args, bench_viterbi)
    return 0


def _run_bench_datasets(args, bench_viterbi) -> None:
    for ds in args.datasets:
        ess = ds if ds.endswith(".ess") else os.path.join(args.ess_dir, f"{ds}.ess")
        name = os.path.splitext(os.path.basename(ess))[0]
        if not args.skip_nonspec:
            out = os.path.join(args.out_dir, f"Viterbi_bench_{name}.dat")
            bench_viterbi.benchmark_viterbi_impls_to_dat_file(
                args.chmm_dir,
                ess,
                out,
                modes=tuple(args.modes),
                times_to_run=args.times,
                max_states=args.max_states,
            )
            print(f"wrote {out}")
        if not args.skip_spec:
            out = os.path.join(args.out_dir, f"Viterbi_spec_bench_{name}.dat")
            bench_viterbi.benchmark_viterbi_spec_impls_to_dat_file(
                args.chmm_dir,
                ess,
                out,
                levels=tuple(args.levels),
                struct_levels=tuple(args.struct_levels)
                if args.struct_levels
                else None,
                times_to_run=args.times,
                max_states=args.max_states,
                max_spec_bytes=args.max_spec_gb << 30,
            )
            print(f"wrote {out}")


def _cmd_decode(args) -> int:
    from spec_viterbi.io import read_emit_seq, read_hmm
    from spec_viterbi.models.decoder import ViterbiDecoder

    hmm = read_hmm(args.chmm)
    seqs = read_emit_seq(args.ess)
    if args.spec_level:
        # specialized decode (run_Viterbi_spec analog) via the structured
        # specializer; --op-cache persists the operator stacks across runs
        from spec_viterbi.models.spec_structured import (
            StructuredSpecializedViterbi,
        )

        cache = None
        if args.op_cache:
            from spec_viterbi.utils import OperatorCache

            cache = OperatorCache()
        spec = StructuredSpecializedViterbi(level=args.spec_level, cache=cache)
        spec.spec_with(hmm)
        for i, v in enumerate(spec.run_spec_batch(seqs)):
            head = " ".join(f"{x:.4f}" for x in v[:8])
            print(f"seq {i}: [{head}{' ...' if len(v) > 8 else ''}] min={np.min(v):.4f}")
        return 0
    if args.stream_chunk:
        return _decode_streaming(hmm, seqs, args)
    if args.time_parallel:
        # single-sequence latency path: lanes = time blocks
        from spec_viterbi.ops.structured import StructuredOperator
        from spec_viterbi.ops.time_parallel import (
            TimeParallelDecoder,
            time_parallel_supported,
        )

        sop = StructuredOperator.from_hmm(hmm)
        if not time_parallel_supported(sop, k=args.time_parallel):
            print(
                "--time-parallel: composed band too wide for this "
                "operator/k (ops/time_parallel.py)",
                file=sys.stderr,
            )
            return 2
        tp = TimeParallelDecoder(
            sop,
            hmm.emission_matrix(pad_to=sop.n),
            hmm.start_vector(pad_to=sop.n),
            k=args.time_parallel,
            compose=args.compose,
        )
        for i, s in enumerate(seqs):
            if args.path:
                scores, path = tp.decode_path(s)
                print(f"seq {i}: best={np.min(scores):.4f} path={path.tolist()}")
            else:
                v = tp.decode(s)
                head = " ".join(f"{x:.4f}" for x in v[:8])
                print(
                    f"seq {i}: [{head}{' ...' if len(v) > 8 else ''}] "
                    f"min={np.min(v):.4f}"
                )
        return 0
    if args.mode == "auto":
        # default: the scheduler picks the execution regime (batched /
        # time-parallel / …) from the workload shape; explicit flags
        # (--mode, --spec-level, --stream-chunk, --time-parallel) override
        from spec_viterbi.scheduler import decode_auto

        results = decode_auto(hmm, seqs, paths=args.path, verbose=True)
        if args.path:
            for i, (scores, path) in enumerate(results):
                print(f"seq {i}: best={np.min(scores):.4f} path={path.tolist()}")
        else:
            for i, v in enumerate(results):
                head = " ".join(f"{x:.4f}" for x in v[:8])
                print(
                    f"seq {i}: [{head}{' ...' if len(v) > 8 else ''}] "
                    f"min={np.min(v):.4f}"
                )
        return 0
    dec = ViterbiDecoder(hmm, mode=args.mode)
    if args.path:
        for i, (scores, path) in enumerate(dec.decode_path_batch(seqs)):
            print(f"seq {i}: best={np.min(scores):.4f} path={path.tolist()}")
    else:
        for i, v in enumerate(dec.decode_batch(seqs)):
            head = " ".join(f"{x:.4f}" for x in v[:8])
            print(f"seq {i}: [{head}{' ...' if len(v) > 8 else ''}] min={np.min(v):.4f}")
    return 0


def _decode_streaming(hmm, seqs, args) -> int:
    """Decode via the constant-memory streaming API in --stream-chunk
    symbol blocks (scores, or exact paths via checkpoint/rematerialize).

    Streaming lanes are uniform-length, so sequences group by exact
    length; raggedness across groups costs separate streams, not padding."""
    from spec_viterbi.models.decoder import ViterbiDecoder

    if args.mode not in ("auto", "structured"):
        print(
            f"--stream-chunk runs the structured streaming engine; "
            f"--mode {args.mode} is incompatible",
            file=sys.stderr,
        )
        return 2
    w = args.stream_chunk
    if w < 1:
        print(f"--stream-chunk must be >= 1, got {w}", file=sys.stderr)
        return 2
    try:
        fd = ViterbiDecoder(hmm, mode="structured").streaming()
    except ValueError as exc:
        print(f"--stream-chunk unavailable: {exc}", file=sys.stderr)
        return 2
    scores_out: list = [None] * len(seqs)
    paths_out: list = [None] * len(seqs)
    by_len: dict[int, list[int]] = {}
    for i, s in enumerate(seqs):
        by_len.setdefault(len(s), []).append(i)
    # bound each stream's lane width so large same-length groups cannot
    # trip the per-call backpointer budget (paths) or HBM (scores)
    lane_cap = 128 if args.path else 512
    groups = [
        idxs[k : k + lane_cap]
        for _, idxs in sorted(by_len.items())
        for k in range(0, len(idxs), lane_cap)
    ]
    try:
        for idxs in groups:
            t = len(seqs[idxs[0]])
            block = np.stack([seqs[i] for i in idxs], axis=1).astype(np.int32)
            if args.path:
                st = fd.stream_begin_path(block[0])
                for pos in range(1, t, w):
                    st = fd.stream_feed_path(st, block[pos : pos + w])
                scores, paths = fd.stream_path_finalize(st)
                for j, i in enumerate(idxs):
                    scores_out[i] = scores[j, : hmm.states_num]
                    paths_out[i] = paths[j]
            else:
                st = fd.stream_begin(block[0])
                for pos in range(1, t, w):
                    st = fd.stream_feed(st, block[pos : pos + w])
                scores = fd.stream_scores(st)
                for j, i in enumerate(idxs):
                    scores_out[i] = scores[j, : hmm.states_num]
    except ValueError as exc:  # e.g. chunk exceeds the backpointer budget
        print(f"streaming decode failed: {exc}", file=sys.stderr)
        return 2
    for i, v in enumerate(scores_out):
        if args.path:
            print(f"seq {i}: best={np.min(v):.4f} path={paths_out[i].tolist()}")
        else:
            head = " ".join(f"{x:.4f}" for x in v[:8])
            print(f"seq {i}: [{head}{' ...' if len(v) > 8 else ''}] min={np.min(v):.4f}")
    return 0


def _cmd_bench_ragged(args) -> int:
    from spec_viterbi.bench.bench_ragged import benchmark_ragged_to_dat_file

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    benchmark_ragged_to_dat_file(
        args.chmm, args.ess, args.out, copies=args.copies, times_to_run=args.times
    )
    print(f"wrote {args.out}")
    return 0


def _cmd_bench_scaling(args) -> int:
    """DP scaling sweep: throughput and efficiency vs data-axis size.

    Runs on whatever devices exist — GPUs for real numbers, or the
    virtual CPU mesh to validate the sharded program. The goal is ≥80%
    efficiency from 1 device to N."""
    import json
    import time

    import jax
    import jax.numpy as jnp

    from spec_viterbi.io import read_emit_seq, read_hmm
    from spec_viterbi.ops.structured import StructuredOperator
    from spec_viterbi.parallel import make_mesh
    from spec_viterbi.parallel.structured_tp import make_structured_dp_decode

    hmm = read_hmm(args.chmm)
    seqs = read_emit_seq(args.ess)
    sop = StructuredOperator.from_hmm(hmm)
    n = sop.n
    em_t = jnp.asarray(hmm.emission_matrix(pad_to=n).T)
    pi = jnp.asarray(hmm.start_vector(pad_to=n))

    n_dev = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    base = None
    for d in sizes:
        mesh = make_mesh(data=d)
        fn = make_structured_dp_decode(sop, mesh)
        from spec_viterbi.utils.batching import pad_batch

        batch, lengths = pad_batch(seqs, d * 8, min_t=2)
        bt = jnp.asarray(batch.T.copy())
        ln = jnp.asarray(lengths)
        np.asarray(fn(em_t, pi, bt, ln))  # compile + warmup
        times = []
        for _ in range(args.times):
            t0 = time.perf_counter()
            np.asarray(fn(em_t, pi, bt, ln)[:1, :1])
            times.append(time.perf_counter() - t0)
        t = sorted(times)[len(times) // 2]
        thr = sum(len(s) for s in seqs) / t
        if base is None:
            base = thr
        eff = thr / (base * d)
        print(
            json.dumps(
                {
                    "devices": d,
                    "throughput_sym_s": round(thr, 1),
                    "efficiency_vs_1": round(eff, 3),
                }
            )
        )
    return 0


def _cmd_sum_dat(args) -> int:
    from spec_viterbi.bench.harness import sum_dat_columns

    for col, total in sum_dat_columns(args.dat).items():
        print(f"{col}\t{total}")
    return 0


def _cmd_gen_chmm(args) -> int:
    from spec_viterbi.io import write_chmm
    from spec_viterbi.io.generators import generate_random_hmm

    hmm = generate_random_hmm(
        args.states,
        trans_per_state=args.trans_per_state,
        emit_range=args.emit_range,
        num_non_zero_start_probs=args.start_probs,
        seed=args.seed,
    )
    write_chmm(hmm, args.out)
    print(f"wrote {args.out} ({hmm.states_num} states, {hmm.trans_num} transitions)")
    return 0


def _cmd_gen_ess(args) -> int:
    from spec_viterbi.io import write_ess
    from spec_viterbi.io.generators import generate_random_sequences

    seqs = generate_random_sequences(
        args.count, args.length, emit_range=args.emit_range, seed=args.seed
    )
    write_ess(seqs, args.out)
    print(f"wrote {args.out} ({args.count} × {args.length})")
    return 0


def _cmd_fasta_to_ess(args) -> int:
    from spec_viterbi.io.fasta import fasta_to_ess

    fasta_to_ess(args.fasta, args.out)
    print(f"wrote {args.out}")
    return 0


def _cmd_hmmer_to_chmm(args) -> int:
    from spec_viterbi.io.hmmer import hmmer_to_chmm

    hmmer_to_chmm(args.hmm, args.out)
    print(f"wrote {args.out}")
    return 0


def _cmd_gen_corpus(args) -> int:
    from spec_viterbi.io.corpus import write_corpus

    write_corpus(args.out, profile_lengths=tuple(args.lengths))
    print(f"wrote the seeded corpus under {args.out}")
    return 0


def _cmd_info(args) -> int:
    from spec_viterbi.io import read_hmm
    from spec_viterbi.ops.structured import StructuredOperator

    hmm = read_hmm(args.chmm)
    sop = StructuredOperator.from_hmm(hmm)
    density = hmm.trans_num / max(1, hmm.states_num**2)
    print(f"states:        {hmm.states_num} (padded {hmm.padded_states})")
    print(f"symbols:       {hmm.emit_num}")
    print(f"transitions:   {hmm.trans_num} ({100 * density:.3f}% dense)")
    print(f"start states:  {hmm.non_zero_start_probs}")
    print(f"fingerprint:   {hmm.fingerprint()}")
    print("structured decomposition:")
    print(f"  diagonals:   {list(sop.diag_offsets)}")
    print(f"  dense rows:  {list(sop.row_idx)}")
    print(f"  dense cols:  {list(sop.col_idx)}")
    print(f"  residual:    {sop.residual_nnz} entries")
    print(f"  cost ratio:  {sop.cost_ratio():.5f} of dense")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spec_viterbi", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bench", help="run the benchmark suite")
    b.add_argument("--chmm-dir", default="corpus/chmm_files",
                   help="models to bench (gen-corpus writes the seeded set)")
    b.add_argument("--ess-dir", default="corpus/ess_files")
    b.add_argument("--datasets", nargs="+", default=list(DEFAULT_DATASETS))
    b.add_argument("--out-dir", default="bench_results")
    b.add_argument("--times", type=int, default=10, help="runs per median")
    b.add_argument("--modes", nargs="+", default=["dense", "structured"])
    b.add_argument("--levels", nargs="+", type=int, default=[1, 2])
    b.add_argument(
        "--struct-levels",
        nargs="+",
        type=int,
        default=[1, 2, 3],
        help="levels for the structured specializer (O(E^L*N) store "
        "benches level 3 where the dense form cannot)",
    )
    b.add_argument("--max-states", type=int, default=None)
    b.add_argument("--max-spec-gb", type=int, default=8)
    b.add_argument("--skip-spec", action="store_true")
    b.add_argument("--skip-nonspec", action="store_true")
    b.add_argument("--trace", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the run to DIR")
    b.set_defaults(fn=_cmd_bench)

    d = sub.add_parser("decode", help="decode an .ess against a .chmm")
    d.add_argument("chmm")
    d.add_argument("ess")
    d.add_argument("--mode", default="auto")
    d.add_argument("--path", action="store_true", help="print Viterbi paths")
    d.add_argument("--spec-level", type=int, default=0,
                   help="decode via level-L structured specialization")
    d.add_argument("--op-cache", action="store_true",
                   help="persist/load specialized operators (~/.cache)")
    d.add_argument("--stream-chunk", type=int, default=0,
                   help="decode via the streaming API in chunks of N "
                        "symbols (constant device memory over any length)")
    d.add_argument("--time-parallel", type=int, default=0, metavar="K",
                   help="decode each sequence time-parallel with K-step "
                        "blocks mapped onto lanes (single-sequence "
                        "latency path; banded+low-rank operators)")
    d.add_argument("--compose", default="scan", choices=("scan", "tree"),
                   help="time-parallel block-compose schedule (tree: "
                        "log2(K) HBM passes, needs power-of-two K)")
    d.set_defaults(fn=_cmd_decode)

    rb = sub.add_parser(
        "bench-ragged",
        help="bucketed vs whole-batch decode of a length-skewed workload",
    )
    rb.add_argument(
        "--chmm",
        nargs="+",
        default=[
            "corpus/chmm_files/100.chmm",
            "corpus/chmm_files/1200.chmm",
            "corpus/chmm_files/2405.chmm",
        ],
        help="one .dat row per model (small/medium/large by default)",
    )
    rb.add_argument("--ess", default="corpus/ess_files/covid-19.ess")
    rb.add_argument("--copies", type=int, default=32,
                    help="replicate the dataset's length profile this many times")
    rb.add_argument("--times", type=int, default=3)
    rb.add_argument("--out", default="bench_results/Viterbi_ragged_bench.dat")
    rb.set_defaults(fn=_cmd_bench_ragged)

    sc = sub.add_parser("bench-scaling", help="DP scaling sweep over mesh sizes")
    sc.add_argument("chmm")
    sc.add_argument("ess")
    sc.add_argument("--times", type=int, default=5)
    sc.set_defaults(fn=_cmd_bench_scaling)

    s = sub.add_parser("sum-dat", help="column sums of a .dat file")
    s.add_argument("dat")
    s.set_defaults(fn=_cmd_sum_dat)

    i = sub.add_parser("info", help="model + decomposition report")
    i.add_argument("chmm")
    i.set_defaults(fn=_cmd_info)

    # data tooling (parity with chmm_gen.py / ess_gen.py / fasta_to_ess.py,
    # but with flags instead of edit-the-source constants)
    gc = sub.add_parser("gen-chmm", help="generate a random .chmm model")
    gc.add_argument("out")
    gc.add_argument("--states", type=int, required=True)
    gc.add_argument("--trans-per-state", type=int, default=3)
    gc.add_argument("--emit-range", type=int, default=20)
    gc.add_argument("--start-probs", type=int, default=2)
    gc.add_argument("--seed", type=int, default=0)
    gc.set_defaults(fn=_cmd_gen_chmm)

    ge = sub.add_parser("gen-ess", help="generate a random .ess dataset")
    ge.add_argument("out")
    ge.add_argument("--count", type=int, required=True)
    ge.add_argument("--length", type=int, required=True)
    ge.add_argument("--emit-range", type=int, default=20)
    ge.add_argument("--seed", type=int, default=0)
    ge.set_defaults(fn=_cmd_gen_ess)

    fe = sub.add_parser("fasta-to-ess", help="convert FASTA to .ess")
    fe.add_argument("fasta")
    fe.add_argument("out")
    fe.set_defaults(fn=_cmd_fasta_to_ess)

    hc = sub.add_parser("hmmer-to-chmm", help="convert a HMMER3 profile to .chmm")
    hc.add_argument("hmm")
    hc.add_argument("out")
    hc.set_defaults(fn=_cmd_hmmer_to_chmm)

    gp = sub.add_parser(
        "gen-corpus",
        help="write the seeded stand-in corpus (profile models, .ess sets, "
        "covid-length FASTA, tiny fixtures)",
    )
    gp.add_argument("out", nargs="?", default="corpus")
    gp.add_argument("--lengths", nargs="+", type=int,
                    default=[100, 500, 1200, 2405],
                    help="profile match-state counts (model = L + 2 states)")
    gp.set_defaults(fn=_cmd_gen_corpus)
    return p


# subcommands that compile device programs share the persistent cache
_COMPILING = frozenset({"bench", "decode", "bench-ragged", "bench-scaling"})


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in _COMPILING:
        from spec_viterbi.utils.compile_cache import enable_persistent_cache

        enable_persistent_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
