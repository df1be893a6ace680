#!/usr/bin/env python3
"""Smoke test of the structured Viterbi decode on an NVIDIA GPU.

    python chip_smoke.py              # one GPU: the nine phases below
    python chip_smoke.py --four-gpus  # four GPUs: the data-parallel path only

Drives the main path once through the entry points a user calls, at the
full width of the corpus's largest model: a 2,407-state profile HMM
(``generate_profile_hmm(2405)``, written to ``.chmm`` and read back) over
512 lanes × 3,500 uniform symbols. The kernels run as compiled for the
card, never in the Pallas interpreter, and each is compared with the plain
XLA structured scan and the NumPy oracle:

1. device      — JAX must run on a GPU, else exit nonzero
2. model       — generate, write and read back the model and sequences
3. scores      — ``decode_batch`` 512 × 3,500: kernel bit-equal to the XLA
                 scan on every lane, within ±1.0 of the oracle on 2 lanes
4. ragged      — a heavy-tailed batch through length bucketing
5. paths       — ``decode_path_batch`` 128 × 3,500: array-equal to the XLA
                 path scan and the oracle
6. streaming   — scores and exact paths fed in chunks vs one-shot decode
7. spec        — ``StructuredSpecializedViterbi(level=2)`` vs non-spec
8. cli         — the ``decode`` subcommand (``decode_auto``) on the files
9. timing      — µs/step and symbols/s, kernel vs XLA scan, scores and paths

Each phase prints one line with its compile (first-call) time and its
steady-state time. Any failure exits nonzero before the last line, which
is one JSON object naming the device as JAX reports it. Everything runs in
this one process, so only one process holds each card. Generated files go
to ``.smoke_data/`` in the checkout (git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PROFILE_LENGTH = 2405  # match states: a 2,407-state model
LANES = 512
PATH_LANES = 128
T_LEN = 3500
RUNS = 5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def timed(fn, runs: int = 1):
    """(first-call seconds, median steady seconds, result); blocks on the
    result so device work is inside the timing."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, sorted(times)[len(times) // 2], out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_device(want: int):
    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX runs on {jax.default_backend()}", file=sys.stderr)
        sys.exit(2)
    devs = jax.devices()
    if len(devs) < want:
        print(f"need {want} GPUs, JAX sees {len(devs)}", file=sys.stderr)
        sys.exit(2)
    print(card_line(), flush=True)
    log("1 device", f"{len(devs)} × {devs[0].device_kind} ({devs[0].platform})")
    return devs


def phase_model(data_dir: str, n_seqs: int):
    import numpy as np

    import spec_viterbi as svt
    from spec_viterbi.io import write_chmm, write_ess
    from spec_viterbi.io.generators import (
        generate_profile_hmm,
        generate_random_sequences,
    )

    t0 = time.perf_counter()
    os.makedirs(data_dir, exist_ok=True)
    chmm = os.path.join(data_dir, f"{PROFILE_LENGTH}.chmm")
    ess = os.path.join(data_dir, f"uniform_{n_seqs}_{T_LEN}_20.ess")
    gen = generate_profile_hmm(PROFILE_LENGTH, seed=PROFILE_LENGTH)
    write_chmm(gen, chmm)
    write_ess(generate_random_sequences(n_seqs, T_LEN, seed=1), ess)
    hmm = svt.read_hmm(chmm)
    seqs = svt.read_emit_seq(ess)
    check(hmm.states_num == PROFILE_LENGTH + 2, "states after read-back")
    check(np.array_equal(np.isinf(hmm.transition_matrix()), np.isinf(gen.transition_matrix())),
          "transition sparsity after read-back")
    check(len(seqs) == n_seqs and all(len(s) == T_LEN for s in seqs), "sequences after read-back")
    log("2 model", f"{hmm.states_num} states, {hmm.trans_num} transitions, "
        f"{n_seqs} × {T_LEN} symbols written and read back in {time.perf_counter() - t0:.2f} s")
    return hmm, seqs, chmm, ess


def phase_scores(hmm, seqs, oracle):
    import numpy as np

    import spec_viterbi as svt

    dec = svt.ViterbiDecoder(hmm)  # mode="auto"
    check(dec.mode == "structured" and dec._fused is not None, "auto mode must pick the kernel on a GPU")
    check(not dec._fused.interpret, "kernel must be compiled, not interpreted")
    xla = svt.ViterbiDecoder(hmm, use_pallas=False)
    c_k, s_k, got = timed(lambda: np.stack(dec.decode_batch(seqs)))
    c_x, s_x, want = timed(lambda: np.stack(xla.decode_batch(seqs)))
    check(np.array_equal(got, want), "kernel scores not bit-equal to the XLA scan")
    for i, (o_scores, _) in oracle.items():
        check(svt.almost_equal_vec(got[i], o_scores), f"lane {i} vs oracle")
    log("3 scores", f"{len(seqs)} × {T_LEN}: bit-equal to XLA on all lanes, oracle ±1.0 on "
        f"lanes {sorted(oracle)}; kernel first {c_k:.2f} s steady {s_k * 1e3:.2f} ms, "
        f"XLA first {c_x:.2f} s steady {s_x * 1e3:.2f} ms")
    return dec, xla, got


def phase_ragged(hmm, dec, xla):
    import numpy as np

    import spec_viterbi as svt
    from spec_viterbi.utils.batching import bucket_plan

    rng = np.random.default_rng(7)
    lens = np.clip(rng.lognormal(5.5, 1.0, size=256).astype(int), 38, 7096)
    lens[:2] = (7096, 38)  # the covid-19 extremes
    seqs = [rng.integers(0, 20, size=int(t)).astype(np.int32) for t in lens]
    plan = bucket_plan([len(s) for s in seqs], lane_block=1)
    check(plan is not None and len(plan) > 1, "heavy-tailed batch must bucket")
    c_k, s_k, got = timed(lambda: dec.decode_batch(seqs))
    want = xla.decode_batch(seqs)
    for g, w in zip(got, want):
        check(np.array_equal(g, w), "ragged kernel scores not bit-equal to XLA")
    short = int(np.argmin(lens))
    check(svt.almost_equal_vec(got[short], svt.viterbi_scores_oracle(hmm, seqs[short])),
          "ragged lane vs oracle")
    log("4 ragged", f"{len(seqs)} lanes, lengths {lens.min()}..{lens.max()} (sum {lens.sum()}), "
        f"{len(plan)} buckets: bit-equal to XLA, oracle ±1.0 on a {lens[short]}-symbol lane; "
        f"first {c_k:.2f} s steady {s_k * 1e3:.2f} ms")


def phase_paths(hmm, dec, xla, seqs, oracle):
    import numpy as np

    c_k, s_k, got = timed(lambda: dec.decode_path_batch(seqs))
    c_x, s_x, want = timed(lambda: xla.decode_path_batch(seqs))
    for (gs, gp), (ws, wp) in zip(got, want):
        check(np.array_equal(gs, ws), "path-mode scores not bit-equal to XLA")
        check(np.array_equal(gp, wp), "kernel paths differ from the XLA path scan")
    for i, (_, o_path) in oracle.items():
        check(np.array_equal(got[i][1], o_path), f"lane {i} path vs oracle")
    log("5 paths", f"{len(seqs)} × {T_LEN}: paths equal to XLA on all lanes and to the oracle "
        f"on lanes {sorted(oracle)}; kernel first {c_k:.2f} s steady {s_k * 1e3:.2f} ms, "
        f"XLA first {c_x:.2f} s steady {s_x * 1e3:.2f} ms")
    return got


def phase_streaming(dec, seqs, scores, paths):
    import numpy as np

    eng = dec.streaming()
    check(eng is dec._fused and not eng.interpret, "streaming must use the kernel engine, compiled, not interpreted")
    block = np.stack(seqs, axis=1)  # [T, B]
    cuts = (1, 700, 1901, T_LEN)

    def feed_scores():
        st = eng.stream_begin(block[0])
        for a, b in zip(cuts, cuts[1:]):
            st = eng.stream_feed(st, block[a:b])
        return eng.stream_scores(st)

    def feed_paths():
        st = eng.stream_begin_path(block[0])
        for a, b in zip(cuts, cuts[1:]):
            st = eng.stream_feed_path(st, block[a:b])
        return eng.stream_path_finalize(st)

    c_s, s_s, got = timed(feed_scores)
    check(np.array_equal(got, scores), "streamed scores not bit-equal to one-shot decode")
    c_p, s_p, (p_scores, p_paths) = timed(feed_paths)
    for i, (ws, wp) in enumerate(paths):
        check(np.array_equal(p_paths[i], wp), "streamed path differs from one-shot path")
        check(np.array_equal(p_scores[i], ws), "streamed path scores differ")
    log("6 streaming", f"{len(seqs)} lanes in chunks {cuts}: scores and paths equal to one-shot; "
        f"scores first {c_s:.2f} s steady {s_s * 1e3:.2f} ms, paths first {c_p:.2f} s "
        f"steady {s_p * 1e3:.2f} ms")


def phase_spec(hmm, seqs, scores):
    import numpy as np

    import spec_viterbi as svt

    t0 = time.perf_counter()
    spec = svt.StructuredSpecializedViterbi(level=2)
    spec.spec_with(hmm)
    prep = time.perf_counter() - t0
    check(spec._fused is not None, "level-2 spec must run the factored kernel on a GPU")
    c, s, got = timed(lambda: np.stack(spec.run_spec_batch(seqs)))
    check(np.array_equal(got, scores), "factored spec not bit-equal to non-spec")
    composed = svt.StructuredSpecializedViterbi(level=2, use_pallas=False)
    composed.spec_with(hmm)
    for i in (0, 1):
        check(svt.almost_equal_vec(composed.run_spec(seqs[i]), scores[i]), "composed level-2 vs non-spec")
    log("7 spec", f"level 2, {len(seqs)} lanes: factored kernel bit-equal to non-spec, composed "
        f"operators ±1.0 on 2 lanes; spec_with {prep:.2f} s, first {c:.2f} s steady {s * 1e3:.2f} ms")


def phase_cli(chmm, data_dir, seqs, scores):
    import numpy as np

    from spec_viterbi import cli
    from spec_viterbi.io import write_ess

    ess = os.path.join(data_dir, "cli_8.ess")
    write_ess(seqs[:8], ess)
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["decode", chmm, ess])
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli decode exited {rc}")
    mins = [float(m) for m in re.findall(r"min=([0-9.]+)", out.getvalue())]
    check(len(mins) == 8, "cli decode printed 8 results")
    check(np.allclose(mins, scores[:8].min(axis=1), atol=1e-3), "cli mins vs decode_batch")
    route = err.getvalue().strip().splitlines()[-1]
    log("8 cli", f"decode on {os.path.basename(chmm)} × 8 sequences: mins match decode_batch; "
        f"{route}; wall {wall:.2f} s")


def phase_timing(hmm, seqs, path_seqs):
    import jax

    import spec_viterbi as svt

    dec = svt.ViterbiDecoder(hmm)
    xla = svt.ViterbiDecoder(hmm, use_pallas=False)
    fd = dec._fused
    rows = []
    k_h = fd.prepare(seqs)
    x_h = xla.prepare_batch(seqs)
    kp_h = fd.prepare(path_seqs)
    xp_h = xla.prepare_batch(path_seqs)
    em_t = xla.dev.emissions.T
    cases = (
        ("scores", "kernel", len(seqs), lambda: fd._jit_run(*k_h)),
        ("scores", "xla", len(seqs), lambda: xla.run_batch(x_h)),
        ("paths", "kernel", len(path_seqs), lambda: fd._jit_run_path(*kp_h)),
        ("paths", "xla", len(path_seqs),
         lambda: xla._s_decode_path_batch(em_t, xla.dev.pi, *xp_h)),
    )
    for what, engine, lanes, fn in cases:
        first, steady, _ = timed(fn, runs=RUNS)
        rows.append((what, engine, lanes, first, steady))
        log("9 timing", f"{what} {engine}: {lanes} × {T_LEN}, first {first:.3f} s, median of "
            f"{RUNS} {steady * 1e3:.3f} ms = {steady * 1e6 / (T_LEN - 1):.3f} µs/step, "
            f"{lanes * T_LEN / steady:.4g} symbols/s")
    for what in ("scores", "paths"):
        k = next(r for r in rows if r[:2] == (what, "kernel"))
        x = next(r for r in rows if r[:2] == (what, "xla"))
        log("9 timing", f"{what}: kernel is {x[4] / k[4]:.2f}× the XLA scan's speed")


def run_one(data_dir: str) -> None:
    import spec_viterbi as svt

    hmm, seqs, chmm, _ = phase_model(data_dir, LANES)
    t0 = time.perf_counter()
    oracle = {i: svt.viterbi_path_oracle(hmm, seqs[i]) for i in (0, 1)}
    log("oracle", f"NumPy path oracle on lanes 0 and 1 ({T_LEN} symbols): {time.perf_counter() - t0:.1f} s")
    dec, xla, scores = phase_scores(hmm, seqs, oracle)
    phase_ragged(hmm, dec, xla)
    paths = phase_paths(hmm, dec, xla, seqs[:PATH_LANES], oracle)
    phase_streaming(dec, seqs[:PATH_LANES], scores[:PATH_LANES], paths)
    phase_spec(hmm, seqs[:64], scores[:64])
    phase_cli(chmm, data_dir, seqs, scores)
    phase_timing(hmm, seqs, seqs[:PATH_LANES])


def run_four(data_dir: str) -> None:
    """The scheduler's ``dp`` route over four cards, scores and paths,
    against the one-card kernel and the oracle."""
    import jax
    import numpy as np

    import spec_viterbi as svt
    from spec_viterbi.ops.fused_pallas import FusedStructuredDecoder
    from spec_viterbi.ops.structured import StructuredOperator
    from spec_viterbi.parallel import make_mesh
    from spec_viterbi.parallel.mesh import fetch_global
    from spec_viterbi.parallel.sharded import _fused_dp_stage, make_fused_dp

    hmm, seqs, _, _ = phase_model(data_dir, 4 * LANES)
    mesh = make_mesh(data=4)
    route = svt.plan_route(hmm, svt.Workload.from_seqs(seqs), mesh)
    check(route.kind == "dp", f"four cards must route dp, got {route.kind}")
    oracle = {i: svt.viterbi_path_oracle(hmm, seqs[i]) for i in (0, 3 * LANES)}

    c, s, got = timed(lambda: np.stack(svt.decode_auto(hmm, seqs, mesh=mesh)))
    one = np.stack(svt.ViterbiDecoder(hmm).decode_batch(seqs))
    check(np.array_equal(got, one), "4-card scores not bit-equal to one card")
    for i, (o_scores, _) in oracle.items():
        check(svt.almost_equal_vec(got[i], o_scores), f"lane {i} vs oracle")
    log("dp scores", f"{len(seqs)} × {T_LEN} over 4 cards: bit-equal to one card, oracle ±1.0 on "
        f"lanes {sorted(oracle)}; first {c:.2f} s steady {s * 1e3:.2f} ms")

    c, s, got_p = timed(lambda: svt.decode_auto(hmm, seqs, mesh=mesh, paths=True))
    one_p = svt.ViterbiDecoder(hmm).decode_path_batch(seqs)
    for (gs, gp), (ws, wp) in zip(got_p, one_p):
        check(np.array_equal(gs, ws) and np.array_equal(gp, wp), "4-card paths differ from one card")
    for i, (_, o_path) in oracle.items():
        check(np.array_equal(got_p[i][1], o_path), f"lane {i} path vs oracle")
    log("dp paths", f"{len(seqs)} × {T_LEN} over 4 cards: equal to one card and the oracle; "
        f"first {c:.2f} s steady {s * 1e3:.2f} ms")

    # where a steady decode_auto call spends its time: host staging, the
    # sharded kernels, and the fetch of the results
    t0 = time.perf_counter()
    sop = StructuredOperator.from_hmm(hmm)
    fd = FusedStructuredDecoder(sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n))
    build = time.perf_counter() - t0
    scores_fn, path_fn = make_fused_dp(fd, mesh)
    _, stage, (seqs_t, lengths) = timed(lambda: _fused_dp_stage(fd, seqs, mesh), runs=RUNS)
    c_s, s_s, out = timed(lambda: scores_fn(seqs_t, lengths), runs=RUNS)
    c_p, s_p, _ = timed(lambda: path_fn(seqs_t, lengths), runs=RUNS)
    # a fresh output each run: a fetched array keeps its host copy
    _, k_fetch, _ = timed(lambda: fetch_global(scores_fn(seqs_t, lengths)), runs=RUNS)
    log("dp split", f"decoder build {build * 1e3:.2f} ms; staging {stage * 1e3:.2f} ms; sharded "
        f"scores kernel first {c_s:.2f} s steady {s_s * 1e3:.3f} ms; sharded paths first "
        f"{c_p:.2f} s steady {s_p * 1e3:.3f} ms; scores kernel + fetch to the host "
        f"{k_fetch * 1e3:.3f} ms (medians of {RUNS})")
    placed = [(str(sh.device), sh.index[1].start, sh.index[1].stop) for sh in out.addressable_shards]
    check(len({p[0] for p in placed}) == 4, "output shards must sit on four different cards")
    log("dp shards", "; ".join(f"lanes {a}:{b} on {d}" for d, a, b in placed))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the data-parallel path over four cards")
    args = ap.parse_args()
    want = 4 if args.four_gpus else 1
    devs = phase_device(want)

    sys.path.insert(0, ROOT)
    from spec_viterbi.utils.compile_cache import enable_persistent_cache

    log("cache", f"persistent compile cache at {enable_persistent_cache()}")
    data_dir = os.path.join(ROOT, ".smoke_data")
    t0 = time.perf_counter()
    (run_four if args.four_gpus else run_one)(data_dir)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    dev = devs[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(devs)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
