"""Headline benchmark: decoded symbols/s on the 2,407-state profile HMM.

Decodes 3,500-symbol uniform sequences against the seeded 2,407-state
profile model (``generate_profile_hmm(2405)``, the corpus's largest
shape), median of BENCH_RUNS timed runs after a warmup (the reference's
median-of-N methodology, ``benchmark/benchmark_helper.h:14,45-66``).

Serving formulation (structured mode): N_BATCHES full 512-lane batches of
distinct sequences, pre-staged on device and enqueued back to back with
one ``block_until_ready``. The dense mode decodes 50 sequences as one
batched program. ``vs_baseline`` is the ratio of the two, a
workload-level serving comparison (``baseline_mode`` in the JSON records
this), null if the dense mode fails.

Each mode runs in its own subprocess with a hard wall-clock kill, and the
parent never imports JAX, so only one process holds the device at a
time. A child that finds no GPU fails rather than timing the CPU. The
parent prints the JSON line with whatever modes completed; only
all-modes-failed exits nonzero. Fault injection for the unit test:
``SVT_BENCH_FAULT=hang=<mode>;stub=<mode>`` replaces a child's work with
an uninterruptible-style sleep / a canned result, exercising the kill +
salvage logic without a device (``tests/test_bench_harness.py``).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

BENCH_RUNS = 5

PROFILE_LENGTH = 2405  # match states: a 2,407-state model
T_LEN = 3500
LANES = 512
N_BATCHES = 4
DENSE_SEQS = 50

# Per-mode wall-clock budgets (seconds), compiles included. Overridable via
# env for the fault-injection test.
def _budget(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


RESULT_TAG = "SVT_BENCH_RESULT "  # child stdout line prefix (log-noise-proof)


def _fault_modes(kind: str) -> set[str]:
    """Parse SVT_BENCH_FAULT='hang=structured;stub=dense' → modes for kind."""
    out = set()
    for part in os.environ.get("SVT_BENCH_FAULT", "").split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            if k.strip() == kind:
                out.update(m.strip() for m in v.split(",") if m.strip())
    return out


# ---------------------------------------------------------------------------
# child side: one mode, one process
# ---------------------------------------------------------------------------


def _median_time(fn, runs: int = BENCH_RUNS) -> float:
    fn()  # warmup (compile)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _setup(n_seqs: int, seed: int):
    """(model, sequences) from seeds; fails without a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {jax.default_backend()}")
    from spec_viterbi.io.generators import (
        generate_profile_hmm,
        generate_random_sequences,
    )
    from spec_viterbi.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    hmm = generate_profile_hmm(PROFILE_LENGTH, seed=PROFILE_LENGTH)
    return hmm, generate_random_sequences(n_seqs, T_LEN, seed=seed)


def _child_structured() -> dict:
    import jax

    import spec_viterbi as svt

    hmm, seqs = _setup(N_BATCHES * LANES, seed=1)
    dec = svt.ViterbiDecoder(hmm, mode="structured")
    handles = [
        dec.prepare_batch(seqs[k * LANES : (k + 1) * LANES]) for k in range(N_BATCHES)
    ]

    def run_structured():
        jax.block_until_ready([dec.run_batch(h) for h in handles])

    sec = _median_time(run_structured)
    return {
        "structured": N_BATCHES * LANES * T_LEN / sec,
        # wall µs per 512-lane step (N_BATCHES×T_LEN steps total)
        "us_per_step": sec * 1e6 / (N_BATCHES * T_LEN),
    }


def _child_dense() -> dict:
    import jax

    import spec_viterbi as svt

    hmm, seqs = _setup(DENSE_SEQS, seed=2)
    dec_d = svt.ViterbiDecoder(hmm, mode="dense")
    handle = dec_d.prepare_batch(seqs)

    def run_dense():
        jax.block_until_ready(dec_d.run_batch(handle))

    return {"dense": DENSE_SEQS * T_LEN / _median_time(run_dense)}


def _run_child(mode: str) -> int:
    if mode in _fault_modes("hang"):  # pragma: no branch - test-only path
        while True:  # simulate a native call SIGALRM can't preempt
            time.sleep(3600)
    if mode in _fault_modes("fail"):  # deterministic child failure
        sys.exit(3)
    if mode in _fault_modes("stub"):
        results = (
            {"structured": 46.5e6, "us_per_step": 11.0}
            if mode == "structured"
            else {"dense": 152e3}
        )
    else:
        results = {"structured": _child_structured, "dense": _child_dense}[mode]()
    print(RESULT_TAG + json.dumps(results), flush=True)
    return 0


# ---------------------------------------------------------------------------
# parent side: orchestrate children with hard wall-clock kills
# ---------------------------------------------------------------------------


def _run_mode(mode: str, timeout_s: int) -> tuple[str, dict | None]:
    """One mode in its own process group; SIGKILL the group on timeout
    (the child's exact pgid — never a pattern kill). Returns
    ``(status, result)`` with status in {"ok", "timeout", "failed"} — the
    caller retries ONLY timeouts (a nonzero child exit is deterministic;
    re-running an identical failure wastes the retry budget)."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", mode],
        stdout=subprocess.PIPE,
        stderr=sys.stderr,
        text=True,
        start_new_session=True,  # own pgid so the kill reaps helper procs too
    )
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:  # pragma: no cover - raced exit
            pass
        proc.wait()
        print(f"[bench] {mode} mode killed after {timeout_s}s", file=sys.stderr)
        return "timeout", None
    if proc.returncode != 0:
        print(
            f"[bench] {mode} mode exited rc={proc.returncode}", file=sys.stderr
        )
        return "failed", None
    for line in out.splitlines():
        if line.startswith(RESULT_TAG):
            return "ok", json.loads(line[len(RESULT_TAG):])
    print(f"[bench] {mode} mode printed no result line", file=sys.stderr)
    return "failed", None


def main() -> int:
    results: dict = {}

    # Structured (kernel) serving throughput. A timed-out attempt is
    # retried once with a shorter budget (the persistent compile cache
    # keeps what it finished); deterministic (non-timeout) failures are
    # NOT retried.
    status, got = _run_mode(
        "structured", _budget("SVT_BENCH_TIMEOUT_STRUCTURED", 420)
    )
    if status == "timeout":
        _, got = _run_mode("structured", _budget("SVT_BENCH_TIMEOUT_RETRY", 300))
    if got:
        results.update(got)

    # Dense XLA baseline — runs REGARDLESS of what structured did.
    _, got = _run_mode("dense", _budget("SVT_BENCH_TIMEOUT_DENSE", 240))
    if got:
        results.update(got)

    if "structured" not in results and "dense" not in results:
        print("[bench] all modes failed", file=sys.stderr)
        return 1
    value = max(results.get("structured", 0.0), results.get("dense", 0.0))
    vs = value / results["dense"] if results.get("dense") else None
    us_per_step = results.get("us_per_step")
    print(
        json.dumps(
            {
                "metric": "decoded_obs_symbols_per_s_per_device_2407",
                "value": value,
                "unit": "symbols/s",
                "vs_baseline": vs,
                "baseline_mode": "dense-XLA 50-seq batch (workload-level "
                "serving comparison, not a same-shape kernel ratio)",
                "us_per_step": us_per_step,
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        sys.exit(_run_child(sys.argv[2]))
    sys.exit(main())
