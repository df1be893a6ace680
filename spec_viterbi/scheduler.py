"""Unified execution-route scheduler: the DP/TP/SP tradeoff as code.

The framework has several execution regimes — single-device batched
decode (whole-sequence kernel / structured XLA / dense XLA), data-parallel
decode over a mesh, state-sharded (halo) TP, time-parallel
single-sequence decode, and two streaming engines. SURVEY.md §5 calls for
the DP-vs-SP/TP tradeoff to be "a tunable scheduling decision"; this
module makes it one.

``plan_route(hmm, workload, mesh) → Route`` encodes the table:

- **DP is the throughput tool.** Lanes are independent, so data
  parallelism needs zero per-step collectives. Any materialized
  multi-sequence workload on a multi-device mesh routes to it; on one
  device, to the batched decoder (which internally picks
  kernel/structured/dense — that sub-choice stays in
  :class:`~spec_viterbi.models.decoder.ViterbiDecoder`).
- **TP is the capacity/latency tool.** Chosen only when the model's
  device-resident arrays exceed the per-device memory, or when the
  caller optimizes latency on a model big enough that a shard's step
  could be faster than the whole (N ≥ ``TP_LATENCY_STATES``). Banded and
  coupled operators alike take the halo-exchange TP
  (:mod:`~spec_viterbi.parallel.structured_tp`).
- **Time parallelism is opt-in only**
  (:class:`~spec_viterbi.ops.time_parallel.TimeParallelDecoder`): a long
  single sequence routes to the batched decoder unless the caller asks
  (``Workload.prefer_time_parallel`` / ``cli decode --time-parallel``).
- **Streaming engine by eligibility**: the kernel engine for
  fused-eligible operators on a GPU, the XLA engine for everything else
  — the same protocol either way.

The reference has no scheduling at all (single backend object per run,
``main.cpp:4-23``); this is the extension that makes the multi-regime
framework usable without knowing the regime names.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spec_viterbi.hmm import HMM
from spec_viterbi.ops.structured import StructuredOperator

# Decision thresholds.
TP_LATENCY_STATES = 10_000  # below this, a shard's step isn't faster
TIME_PARALLEL_MIN_T = 512  # shorter sequences: dispatch dominates
TIME_PARALLEL_K_DEFAULT = 8


@dataclasses.dataclass(frozen=True)
class Workload:
    """Shape of the work to schedule (not the data itself)."""

    n_seqs: int
    max_len: int
    total_symbols: int = 0
    paths: bool = False  # exact Viterbi paths required?
    streaming: bool = False  # unbounded/incremental input?
    optimize: str = "throughput"  # or "latency"
    # per-device memory budget; None reads the device's own (and a device
    # that reports none is never capacity-bound)
    hbm_bytes: int | None = None
    # explicit opt-in: the planner routes to time parallelism only when
    # the caller asks for it
    prefer_time_parallel: bool = False

    @classmethod
    def from_seqs(cls, seqs, **kw) -> "Workload":
        lens = [len(s) for s in seqs]
        return cls(
            n_seqs=len(lens),
            max_len=max(lens, default=0),
            total_symbols=sum(lens),
            **kw,
        )


@dataclasses.dataclass(frozen=True)
class Route:
    """A scheduling decision: which regime runs this workload and why."""

    kind: str  # batch | dp | tp_halo | time_parallel | stream_fused | stream_xla
    reason: str
    params: dict = dataclasses.field(default_factory=dict)


def model_resident_bytes(sop: StructuredOperator, emit_num: int) -> int:
    """Device-resident bytes of the structured model (operator components
    + emissions + start vector, f32). The dense [N, N] operators never
    materialize in structured mode, so this is the capacity that must fit
    per device (or per shard under TP)."""
    n = sop.n
    comps = len(sop.diag_offsets) + len(sop.row_idx) + len(sop.col_idx)
    return 4 * (n * (comps + emit_num + 1) + sop.residual_nnz)


def _mesh_shape(mesh) -> tuple[int, int]:
    """(data shards, state shards) of a mesh; (1, 1) when mesh is None."""
    if mesh is None:
        return 1, 1
    from spec_viterbi.parallel.mesh import DATA_AXIS, STATE_AXIS

    shape = dict(mesh.shape)
    return shape.get(DATA_AXIS, 1), shape.get(STATE_AXIS, 1)


def plan_route(
    hmm: HMM,
    workload: Workload,
    mesh=None,
    sop: StructuredOperator | None = None,
) -> Route:
    """The decision table as code. Pure: inspects shapes and operator
    structure only, runs nothing."""
    from spec_viterbi.ops.fused_pallas import fused_eligible, gpu_kernel_available
    from spec_viterbi.ops.time_parallel import time_parallel_supported
    from spec_viterbi.parallel.structured_tp import structured_tp_supported
    from spec_viterbi.utils.device import device_memory_bytes

    if sop is None:
        sop = StructuredOperator.from_hmm(hmm)
    data_shards, state_shards = _mesh_shape(mesh)

    if workload.streaming:
        if fused_eligible(sop) and gpu_kernel_available():
            return Route(
                "stream_fused",
                "fused-eligible operator on a GPU: kernel streaming engine",
            )
        return Route(
            "stream_xla",
            "XLA structured streaming engine (any operator, any backend)",
        )

    # TP: capacity first (the model MUST shard), then latency.
    resident = model_resident_bytes(sop, hmm.emit_num)
    budget = workload.hbm_bytes
    if budget is None:
        budget = device_memory_bytes()
    capacity_bound = budget is not None and resident > budget
    latency_bound = (
        workload.optimize == "latency" and sop.n >= TP_LATENCY_STATES
    )
    if state_shards > 1 and (capacity_bound or latency_bound):
        why = (
            f"model arrays ({resident >> 20} MiB) exceed the per-device "
            f"budget ({budget >> 20} MiB)"
            if capacity_bound
            else f"latency-bound at N={sop.n} ≥ {TP_LATENCY_STATES}"
        )
        if structured_tp_supported(sop, state_shards):
            return Route(
                "tp_halo",
                f"{why}; state-sharded halo TP (one small halo exchange "
                "per step)",
                {"shards": state_shards, "capacity_bound": capacity_bound},
            )
        # fall through: unshardable operator — DP is still correct
        # (capacity-bound models may simply OOM; surface that in reason)
        return Route(
            "batch" if data_shards <= 1 else "dp",
            f"{why} but the operator does not fit the halo TP "
            f"(n={sop.n} % shards={state_shards}); falling back",
        )

    # Time parallelism: one long sequence leaves the other lanes idle;
    # the route is exact, but the scheduler only picks it on request.
    k = TIME_PARALLEL_K_DEFAULT
    tp_dropped = ""
    if workload.prefer_time_parallel:
        if workload.n_seqs != 1:
            tp_dropped = (
                f"; time-parallel request dropped: {workload.n_seqs} "
                "sequences (lanes are better spent on real batch lanes)"
            )
        elif workload.max_len < TIME_PARALLEL_MIN_T:
            tp_dropped = (
                f"; time-parallel request dropped: T={workload.max_len} < "
                f"{TIME_PARALLEL_MIN_T} (dispatch would dominate)"
            )
        elif not time_parallel_supported(sop, k):
            tp_dropped = (
                "; time-parallel request dropped: operator outside the "
                f"banded+low-rank closure at k={k}"
            )
        else:
            return Route(
                "time_parallel",
                f"single {workload.max_len}-symbol sequence, time "
                f"parallelism requested: lanes-as-time-blocks compose+fold "
                f"(k={k}), as requested",
                {"k": k},
            )

    if data_shards > 1:
        return Route(
            "dp",
            f"throughput workload ({workload.n_seqs} seqs): data "
            f"parallelism over {data_shards} devices, zero per-step "
            "collectives" + tp_dropped,
            {"shards": data_shards},
        )
    return Route(
        "batch",
        f"single-device batched decode ({workload.n_seqs} seqs); the "
        "decoder picks kernel/structured/dense internally" + tp_dropped,
    )


# ---------------------------------------------------------------------------
# Route execution: dispatch to the owning machinery
# ---------------------------------------------------------------------------


def _kept(hmm: HMM, kind: str, build):
    """The decoder a route runs, kept on ``hmm`` for as long as its
    content (fingerprint) holds: a repeated call reuses the decoder's
    compiled functions instead of tracing and compiling them anew, and
    dropping the HMM frees them."""
    kept = hmm.__dict__.setdefault("_route_decoders", {})
    key = (kind, hmm.fingerprint())
    if key not in kept:
        for old in [k for k in kept if k[0] == kind]:
            del kept[old]
        kept[key] = build()
    return kept[key]


def execute_route(
    hmm: HMM,
    seqs: list[np.ndarray],
    route: Route,
    mesh=None,
    interpret: bool = False,
):
    """Run ``seqs`` through ``route``. Returns ``[scores]`` per sequence,
    or ``[(scores, path)]`` when the route was planned with
    ``workload.paths``/carries ``paths`` in params.

    The ``dp`` route runs the whole-sequence kernel per device on a GPU
    and the XLA structured scan elsewhere; ``interpret=True`` runs the
    kernel in the Pallas interpreter instead (CPU tests)."""
    from spec_viterbi.models.decoder import ViterbiDecoder
    from spec_viterbi.ops.fused_pallas import gpu_kernel_available

    paths = bool(route.params.get("paths"))

    if route.kind in ("stream_fused", "stream_xla"):
        raise ValueError(
            "streaming routes are driven incrementally — get the engine "
            "via stream_engine(hmm, route) and use stream_begin/feed"
        )

    if route.kind == "time_parallel":
        from spec_viterbi.ops.time_parallel import TimeParallelDecoder

        sop = StructuredOperator.from_hmm(hmm)
        tp = TimeParallelDecoder(
            sop,
            hmm.emission_matrix(pad_to=sop.n),
            hmm.start_vector(pad_to=sop.n),
            k=route.params.get("k", TIME_PARALLEL_K_DEFAULT),
        )
        if paths:
            return [tp.decode_path(s) for s in seqs]
        return [tp.decode(s) for s in seqs]

    if route.kind == "tp_halo":
        from spec_viterbi.parallel.structured_tp import (
            decode_batch_structured_tp,
        )

        if paths:
            # halo TP has no sharded-backpointer path. When the route was
            # chosen for LATENCY the model fits one device, so rematerialize
            # paths on the unsharded decoder (exact, same oracle); when it
            # was chosen for CAPACITY an unsharded fallback would OOM by
            # the very premise that picked TP — refuse loudly.
            if route.params.get("capacity_bound"):
                raise ValueError(
                    "exact paths are not available under capacity-bound "
                    "halo TP (no state-sharded backpointers for coupled "
                    "operators); decode scores, or stream per time chunk"
                )
            dec = ViterbiDecoder(hmm, use_pallas=False)
            return [dec.decode_path(s) for s in seqs]
        return decode_batch_structured_tp(hmm, seqs, mesh)

    if route.kind == "dp":
        from spec_viterbi.ops.fused_pallas import (
            FusedStructuredDecoder,
            fused_eligible,
        )
        from spec_viterbi.parallel.sharded import (
            decode_batch_dp_fused,
            decode_path_batch_dp_fused,
        )

        sop = StructuredOperator.from_hmm(hmm)
        if fused_eligible(sop) and (interpret or gpu_kernel_available()):
            fd = _kept(
                hmm,
                f"dp kernel, interpret={interpret}",
                lambda: FusedStructuredDecoder(
                    sop,
                    hmm.emission_matrix(pad_to=sop.n),
                    hmm.start_vector(pad_to=sop.n),
                    interpret=interpret,
                ),
            )
            if paths:
                return decode_path_batch_dp_fused(fd, seqs, mesh)
            return decode_batch_dp_fused(fd, seqs, mesh)
        if paths:  # batched XLA path scan on one device (exact)
            return ViterbiDecoder(hmm, use_pallas=False).decode_path_batch(seqs)
        from spec_viterbi.parallel.structured_tp import (
            decode_batch_structured_dp,
        )

        return decode_batch_structured_dp(hmm, seqs, mesh)

    # "batch": the single-device decoder owns the kernel/structured/dense
    # sub-choice (and its own bucketing/backpointer budgets)
    dec = _kept(
        hmm,
        f"batch, interpret={interpret}",
        lambda: ViterbiDecoder(hmm, interpret=interpret),
    )
    return dec.decode_path_batch(seqs) if paths else dec.decode_batch(seqs)


def stream_engine(hmm: HMM, route: Route | None = None):
    """The streaming engine a stream_* route names (or plans itself)."""
    from spec_viterbi.models.decoder import ViterbiDecoder

    if route is not None and route.kind not in ("stream_fused", "stream_xla"):
        raise ValueError(f"not a streaming route: {route.kind}")
    # ViterbiDecoder.streaming() applies the same eligibility split the
    # planner encodes; route only documents the decision
    return ViterbiDecoder(hmm).streaming()


def decode_auto(
    hmm: HMM,
    seqs: list[np.ndarray],
    mesh=None,
    paths: bool = False,
    optimize: str = "throughput",
    verbose: bool = False,
    interpret: bool = False,
    **workload_kw,
):
    """Plan + execute in one call: ``[(scores, path)]`` or ``[scores]``.

    The one-stop entry for callers that don't want to know route names
    (the scheduler's "Done" criterion). Extra keyword arguments are
    forwarded to :meth:`Workload.from_seqs`, so every planner knob —
    including the ``prefer_time_parallel`` opt-in and ``hbm_bytes`` — is
    reachable from here."""
    if not seqs:
        return []
    workload = Workload.from_seqs(
        seqs, paths=paths, optimize=optimize, **workload_kw
    )
    route = plan_route(hmm, workload, mesh)
    route = Route(route.kind, route.reason, {**route.params, "paths": paths})
    if verbose:
        import sys

        print(f"[scheduler] {route.kind}: {route.reason}", file=sys.stderr)
    return execute_route(hmm, seqs, route, mesh, interpret=interpret)
