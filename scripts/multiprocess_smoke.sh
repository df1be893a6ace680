#!/usr/bin/env bash
# Two-process jax.distributed smoke test on CPU devices: a real multi-host
# process group (coordinator + worker), global meshes spanning both
# processes, and EVERY parallel/ entry point the scheduler can route to
# oracle-checked in both processes:
#   - decode_batch_structured_dp (public API, global staging + allgather)
#   - decode_batch_structured_tp (state-sharded halo TP)
#   - decode_batch_dp_fused / decode_path_batch_dp_fused (the
#     whole-sequence kernel shard_mapped across the process boundary, in
#     the Pallas interpreter — the kernel is compiled only for GPUs; the
#     distribution logic is what's under test)
#   - StreamDP: ragged scores streaming + exact-path finalize
#   - plan_route/execute_route on the process-spanning mesh (the "dp"
#     route end-to-end)
# The closest a single machine gets to the N-host story (SURVEY.md §2.9).
set -euo pipefail
cd "$(dirname "$0")/.."

PORT=${PORT:-12355}

run_proc() {
    JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=4" \
    SVT_COORD="127.0.0.1:$PORT" SVT_NPROC=2 SVT_PID=$1 \
    python - <<'EOF'
import os
import numpy as np
import jax

from spec_viterbi.parallel import init_distributed, make_mesh, process_info

assert init_distributed(
    coordinator_address=os.environ["SVT_COORD"],
    num_processes=int(os.environ["SVT_NPROC"]),
    process_id=int(os.environ["SVT_PID"]),
)
info = process_info()
assert info["process_count"] == 2 and info["global_devices"] == 8, info
pid = info["process_id"]

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io.generators import generate_profile_hmm
from spec_viterbi.models.oracle import viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi.ops.fused_pallas import FusedStructuredDecoder
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.parallel.sharded import (
    StreamDP,
    decode_batch_dp_fused,
    decode_path_batch_dp_fused,
)
from spec_viterbi.parallel.structured_tp import (
    decode_batch_structured_dp,
    decode_batch_structured_tp,
)

hmm = generate_profile_hmm(100, seed=100)  # the seeded corpus's 100.chmm
rng = np.random.default_rng(0)
seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (20, 33, 7)]
want = [viterbi_scores_oracle(hmm, s) for s in seqs]
ns = hmm.states_num

# a 100-state cyclic chain (1 diag + 1 residual wrap — fused-eligible)
# whose Viterbi path provably walks distinct states: the corpus profile
# HMMs decode to all-state-0 paths on arbitrary streams, which would let
# a lane-permutation bug through the path checks
from spec_viterbi.hmm import HMM


def cyclic_hmm(n=100, e=4):
    rows = np.arange(n, dtype=np.int64)
    em = np.full((e, n), 5.0, np.float32)
    for i in range(n):
        em[i % e, i] = 0.5
    return HMM(
        states_num=n, emit_num=e,
        trans_rows=rows, trans_cols=(rows + 1) % n,
        trans_probs=np.ones(n, np.float32), emissions=em,
        start_probabilities_cols=np.array([0], np.int64),
        start_probabilities=np.array([0.0], np.float32),
    )


chmm = cyclic_hmm()
cns = chmm.states_num

# ---- structured DP via the PUBLIC entry point (global staging) ----
mesh_dp = make_mesh(data=8)  # spans both processes
got = decode_batch_structured_dp(hmm, seqs, mesh_dp)
for g, w, s in zip(got, want, seqs):
    assert almost_equal_vec(g, w), f"structured DP @ {len(s)}"
print(f"p{pid}: structured DP OK", flush=True)

# ---- structured TP (state-sharded halo exchange across processes) ----
mesh_tp = make_mesh(state=8)
got = decode_batch_structured_tp(hmm, seqs, mesh_tp)
for g, w, s in zip(got, want, seqs):
    assert almost_equal_vec(g, w), f"structured TP @ {len(s)}"
print(f"p{pid}: structured TP OK", flush=True)

# ---- the kernel, DP-sharded across the process boundary ----
sop = StructuredOperator.from_hmm(hmm)
fd = FusedStructuredDecoder(
    sop,
    hmm.emission_matrix(pad_to=sop.n),
    hmm.start_vector(pad_to=sop.n),
    interpret=True,
)
got = decode_batch_dp_fused(fd, seqs, mesh_dp)
for g, w, s in zip(got, want, seqs):
    assert almost_equal_vec(g[:ns], w), f"fused DP @ {len(s)}"
print(f"p{pid}: fused DP scores OK", flush=True)

# exact paths on the cyclic model: each lane walks the chain from a
# different phase, so cross-process lane mixups cannot cancel out
csop = StructuredOperator.from_hmm(chmm)
cfd = FusedStructuredDecoder(
    csop,
    chmm.emission_matrix(pad_to=csop.n),
    chmm.start_vector(pad_to=csop.n),
    interpret=True,
)
cseqs = [
    np.array([(i % 4) for i in range(t)], np.int32) for t in (40, 17, 9)
]
cwant = [viterbi_path_oracle(chmm, s) for s in cseqs]
assert len(set(cwant[0][1].tolist())) == 40  # genuinely nontrivial
got_p = decode_path_batch_dp_fused(cfd, cseqs, mesh_dp)
for (g, path), (wsc, wpath), s in zip(got_p, cwant, cseqs):
    assert almost_equal_vec(g[:cns], wsc), f"fused DP path-scores @ {len(s)}"
    assert np.array_equal(path, wpath), f"fused DP path @ {len(s)}"
print(f"p{pid}: fused DP exact paths OK", flush=True)

# ---- StreamDP: ragged streaming scores + exact-path finalize ----
sdp = StreamDP(cfd, mesh_dp)
lanes = [
    np.array([(i % 4) for i in range(t)], np.int32) for t in (25, 14)
]
first = np.array([lanes[0][0], lanes[1][0]], np.int32)
chunk = np.zeros((24, 2), np.int32)
valid = np.array([24, 13], np.int32)  # lane 1 finishes mid-chunk (ragged)
for i, ln in enumerate(lanes):
    chunk[: len(ln) - 1, i] = ln[1:]

st = sdp.begin(first)
st = sdp.feed(st, chunk, valid=valid)
sc = sdp.scores(st)
for i, ln in enumerate(lanes):
    assert almost_equal_vec(
        sc[i][:cns], viterbi_scores_oracle(chmm, ln)
    ), f"StreamDP scores lane {i}"
print(f"p{pid}: StreamDP ragged scores OK", flush=True)

ps = sdp.begin_path(first)
ps = sdp.feed_path(ps, chunk[:12], valid=np.minimum(valid, 12))
ps = sdp.feed_path(ps, chunk[12:], valid=np.maximum(valid - 12, 0))
fsc, fpaths = sdp.path_finalize(ps)
for i, ln in enumerate(lanes):
    wsc, wpath = viterbi_path_oracle(chmm, ln)
    assert almost_equal_vec(fsc[i][:cns], wsc)
    assert np.array_equal(fpaths[i][: len(ln)], wpath), f"StreamDP path lane {i}"
print(f"p{pid}: StreamDP exact paths OK", flush=True)

# ---- scheduler end-to-end on the process-spanning mesh ----
from spec_viterbi.scheduler import Route, execute_route

route = Route("dp", "smoke", {"shards": 8})
got = execute_route(hmm, seqs, route, mesh_dp, interpret=True)
for g, w, s in zip(got, want, seqs):
    assert almost_equal_vec(np.asarray(g)[:ns], w), f"route dp @ {len(s)}"
route_p = Route("dp", "smoke", {"shards": 8, "paths": True})
got = execute_route(chmm, cseqs, route_p, mesh_dp, interpret=True)
for (g, path), (wsc, wpath) in zip(got, cwant):
    assert np.array_equal(path, wpath)
print(f"p{pid}: scheduler dp route (scores+paths) OK", flush=True)
EOF
}

run_proc 1 &
WORKER=$!
run_proc 0
wait "$WORKER"
echo "multiprocess smoke OK"
