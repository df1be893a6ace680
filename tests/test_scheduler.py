"""Scheduler: the DP/TP/SP decision table as code (SURVEY.md §5 "a
tunable scheduling decision").

Planning is pure (shape + operator structure), so the route table is
unit-tested on synthetic workload shapes; execution is cross-checked
against the oracle on the virtual CPU mesh for every dispatchable route.
"""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_hmm
from spec_viterbi.models.oracle import viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi.scheduler import (
    Route,
    Workload,
    decode_auto,
    execute_route,
    model_resident_bytes,
    plan_route,
    stream_engine,
)
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def pfam():
    return read_hmm(os.path.join(CHMM_DIR, "100.chmm"))


@pytest.fixture(scope="module")
def banded():
    from conftest import banded_hmm

    return banded_hmm(n=256, offsets=(1,), emit=4, seed=5)


def _wl(n_seqs=50, max_len=3500, **kw):
    return Workload(n_seqs=n_seqs, max_len=max_len, **kw)


# ---- planning (pure, synthetic shapes) --------------------------------


def test_throughput_workload_routes_dp_or_batch(pfam):
    assert plan_route(pfam, _wl()).kind == "batch"  # no mesh
    mesh = make_mesh(data=4)
    assert plan_route(pfam, _wl(), mesh).kind == "dp"


def test_single_long_sequence_defaults_to_batch(pfam):
    # a long single sequence stays on the batched path by default…
    r = plan_route(pfam, _wl(n_seqs=1, max_len=3500))
    assert r.kind == "batch"
    # …and time parallelism is an explicit opt-in.
    r = plan_route(pfam, _wl(n_seqs=1, max_len=3500, prefer_time_parallel=True))
    assert r.kind == "time_parallel"
    assert r.params["k"] >= 2
    # short single sequences stay batched even when requested (dispatch
    # dominates below TIME_PARALLEL_MIN_T)
    assert (
        plan_route(pfam, _wl(n_seqs=1, max_len=64, prefer_time_parallel=True)).kind
        == "batch"
    )


def test_capacity_bound_model_routes_tp(pfam, banded):
    mesh = make_mesh(state=4)
    # force the capacity bound with a tiny budget: coupled and banded
    # operators alike take the per-step halo TP
    r = plan_route(pfam, _wl(hbm_bytes=1024), mesh)
    assert r.kind == "tp_halo"
    assert "exceed" in r.reason
    r = plan_route(banded, _wl(hbm_bytes=1024), mesh)
    assert r.kind == "tp_halo"
    assert r.params == {"shards": 4, "capacity_bound": True}
    # a device that reports no memory size is never capacity-bound
    assert plan_route(pfam, _wl(), mesh).kind != "tp_halo"


def test_latency_bound_needs_big_n(pfam):
    mesh = make_mesh(state=4)
    # 102 states: a shard's step is NOT faster — stays off TP
    assert plan_route(pfam, _wl(optimize="latency"), mesh).kind != "tp_halo"


def test_latency_bound_big_model_routes_tp():
    from conftest import banded_hmm

    big = banded_hmm(n=10240, offsets=(1,), emit=4, seed=1)
    mesh = make_mesh(state=4)
    r = plan_route(big, _wl(n_seqs=8, optimize="latency"), mesh)
    assert r.kind == "tp_halo"
    assert "latency-bound" in r.reason


def test_streaming_routes_by_eligibility(pfam):
    from spec_viterbi.ops.fused_pallas import fused_eligible, gpu_kernel_available

    # the whole Pfam corpus is fused-eligible; the kernel engine is the
    # route only where the kernel is compiled (a GPU)
    assert fused_eligible(StructuredOperator.from_hmm(pfam))
    r = plan_route(pfam, _wl(streaming=True))
    assert r.kind == ("stream_fused" if gpu_kernel_available() else "stream_xla")
    eng = stream_engine(pfam, r)
    assert hasattr(eng, "stream_begin")
    with pytest.raises(ValueError, match="not a streaming route"):
        stream_engine(pfam, Route("batch", ""))


def test_streaming_fallback_engine():
    """A residual-heavy operator exceeds fused eligibility and must get
    the universal XLA engine."""
    from spec_viterbi.io.generators import generate_random_hmm

    hmm = generate_random_hmm(states_num=48, trans_per_state=24, emit_range=4, seed=9)
    sop = StructuredOperator.from_hmm(hmm)
    from spec_viterbi.ops.fused_pallas import fused_eligible

    if fused_eligible(sop):
        pytest.skip("generator produced a fused-eligible operator")
    r = plan_route(hmm, _wl(streaming=True))
    assert r.kind == "stream_xla"
    from spec_viterbi.models.streaming_xla import XLAStreamDecoder

    assert isinstance(stream_engine(hmm, r), XLAStreamDecoder)


def test_resident_bytes_sanity(pfam):
    sop = StructuredOperator.from_hmm(pfam)
    b = model_resident_bytes(sop, pfam.emit_num)
    # ~128 padded states × (components + 20 emissions + 1) × 4B: O(10–100 KB)
    assert 10_000 < b < 1_000_000


# ---- execution (CPU mesh, oracle-checked) -----------------------------


def test_execute_batch_and_auto(pfam):
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, pfam.emit_num, size=t).astype(np.int32) for t in (40, 25)]
    got = decode_auto(pfam, seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(pfam, s))
    got = decode_auto(pfam, seqs, paths=True)
    for (sc, p), s in zip(got, seqs):
        _, op = viterbi_path_oracle(pfam, s)
        assert np.array_equal(p, op)


def test_execute_time_parallel_route(pfam):
    rng = np.random.default_rng(1)
    seq = rng.integers(0, pfam.emit_num, size=600).astype(np.int32)
    wl = Workload.from_seqs([seq], prefer_time_parallel=True)
    route = plan_route(pfam, wl)
    assert route.kind == "time_parallel"
    (got,) = execute_route(pfam, [seq], route)
    assert almost_equal_vec(got, viterbi_scores_oracle(pfam, seq))
    route_p = Route(route.kind, route.reason, {**route.params, "paths": True})
    ((sc, p),) = execute_route(pfam, [seq], route_p)
    _, op = viterbi_path_oracle(pfam, seq)
    assert np.array_equal(p, op)


@pytest.mark.parametrize("interpret", [False, True])
def test_execute_dp_route(pfam, interpret):
    """The dp route: the XLA structured DP on the CPU, the kernel per
    device when asked for in interpret mode — scores and paths."""
    mesh = make_mesh(data=2)
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, pfam.emit_num, size=30).astype(np.int32) for _ in range(4)]
    route = plan_route(pfam, Workload.from_seqs(seqs), mesh)
    assert route.kind == "dp"
    got = execute_route(pfam, seqs, route, mesh, interpret=interpret)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(pfam, s))
    route_p = Route(route.kind, route.reason, {**route.params, "paths": True})
    for (sc, p), s in zip(execute_route(pfam, seqs, route_p, mesh, interpret=interpret), seqs):
        assert np.array_equal(p, viterbi_path_oracle(pfam, s)[1])


def test_route_decoders_kept_per_model_content(pfam):
    """A repeated route call reuses its decoder, and so its compiled
    functions; an HMM whose content changed gets a new one, and the old
    one is dropped."""
    import dataclasses

    from spec_viterbi.scheduler import _kept

    hmm = dataclasses.replace(pfam)  # own instance, same content
    built = []

    def build():
        built.append(object())
        return built[-1]

    first = _kept(hmm, "dp", build)
    assert _kept(hmm, "dp", build) is first and len(built) == 1
    assert _kept(hmm, "batch", build) is not first and len(built) == 2
    hmm.emissions = hmm.emissions + 1.0
    assert _kept(hmm, "dp", build) is not first and len(built) == 3
    assert sorted(k[0] for k in hmm._route_decoders) == ["batch", "dp"]


def test_execute_tp_routes(pfam, banded):
    mesh = make_mesh(state=4)
    rng = np.random.default_rng(3)
    for hmm, kind in ((pfam, "tp_halo"), (banded, "tp_halo")):
        seqs = [
            rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
            for t in (20, 33)
        ]
        route = plan_route(hmm, Workload.from_seqs(seqs, hbm_bytes=1024), mesh)
        assert route.kind == kind
        got = execute_route(hmm, seqs, route, mesh)
        for g, s in zip(got, seqs):
            assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s)), kind


def test_stream_route_refuses_materialized_execute(pfam):
    with pytest.raises(ValueError, match="stream"):
        execute_route(pfam, [], Route("stream_fused", ""))


def test_capacity_bound_halo_paths_refused(pfam):
    """Exact paths under CAPACITY-bound halo TP must refuse loudly — an
    unsharded path fallback would OOM by the premise that chose TP."""
    mesh = make_mesh(state=4)
    route = plan_route(pfam, _wl(hbm_bytes=1024), mesh)
    assert route.kind == "tp_halo" and route.params["capacity_bound"]
    route_p = Route(route.kind, route.reason, {**route.params, "paths": True})
    with pytest.raises(ValueError, match="capacity-bound"):
        execute_route(pfam, [np.zeros(4, np.int32)], route_p, mesh)


def test_dropped_time_parallel_request_is_explained(pfam):
    """An explicit prefer_time_parallel=True that fails a guard must say so in the fallback route's reason instead of silently
    vanishing."""
    r = plan_route(pfam, _wl(n_seqs=3, max_len=3500, prefer_time_parallel=True))
    assert r.kind == "batch"
    assert "time-parallel request dropped" in r.reason
    assert "3 sequences" in r.reason
    r = plan_route(pfam, _wl(n_seqs=1, max_len=64, prefer_time_parallel=True))
    assert r.kind == "batch"
    assert "time-parallel request dropped" in r.reason and "T=64" in r.reason
    # an unrequested plan carries no dropped-request noise
    assert "dropped" not in plan_route(pfam, _wl(n_seqs=3)).reason


def test_decode_auto_forwards_workload_kw(pfam, capsys):
    """The planner opt-ins (prefer_time_parallel et al.) must be reachable
    from the one-stop decode_auto entry."""
    rng = np.random.default_rng(7)
    seq = rng.integers(0, pfam.emit_num, size=600).astype(np.int32)
    got = decode_auto(pfam, [seq], prefer_time_parallel=True, verbose=True)
    assert "time_parallel" in capsys.readouterr().err
    assert almost_equal_vec(got[0], viterbi_scores_oracle(pfam, seq))
