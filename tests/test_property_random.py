"""Property sweep: random HMMs across shapes, every path vs the oracle.

The reference's oracle is cross-backend agreement on a fixed corpus; this
adds randomized coverage the reference lacks — irregular state counts,
alphabets, degrees, zero-probability patches, and ragged batches.
"""

import numpy as np
import pytest

from spec_viterbi.hmm import HMM, almost_equal_vec, to_modified_prob_np
from spec_viterbi.models.decoder import ViterbiDecoder
from spec_viterbi.models.oracle import viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi.models.specializer import SpecializedViterbi


def _random_hmm(rng, states, emit, deg, zero_frac=0.0):
    rows = np.repeat(np.arange(states, dtype=np.int64), deg)
    cols = rng.integers(0, states, size=states * deg).astype(np.int64)
    probs = rng.uniform(0.01, 1.0, size=states * deg)
    em = rng.uniform(0.01, 1.0, size=(emit, states))
    if zero_frac:
        em[rng.uniform(size=em.shape) < zero_frac] = 0.0  # +inf emissions
    starts = rng.choice(states, size=max(1, states // 4), replace=False)
    return HMM(
        states_num=states,
        emit_num=emit,
        trans_rows=rows,
        trans_cols=cols,
        trans_probs=to_modified_prob_np(probs),
        emissions=to_modified_prob_np(em),
        start_probabilities_cols=np.sort(starts).astype(np.int64),
        start_probabilities=to_modified_prob_np(
            rng.uniform(0.01, 1.0, size=starts.size)
        ),
    )


def _random_structured_hmm(rng, states, emit):
    """Random model the structured decomposition fully covers: full
    diagonals at random offsets (incl. negatives/self-loops), one dense
    source row, one dense destination column, a few residual entries —
    always fused-eligible by construction."""
    entries: dict[tuple[int, int], float] = {}

    def put(s, d):
        entries[(s, d)] = float(rng.uniform(0.01, 1.0))

    offsets = rng.choice([-2, -1, 0, 1, 2], size=int(rng.integers(1, 4)), replace=False)
    for d in offsets:
        for i in range(states):
            if 0 <= i + d < states:
                put(i, i + d)
    r = int(rng.integers(0, states))
    for j in range(states):
        put(r, j)
    c = int(rng.integers(0, states))
    for i in range(states):
        put(i, c)
    for _ in range(int(rng.integers(0, 4))):
        put(int(rng.integers(0, states)), int(rng.integers(0, states)))

    rows = np.array([k[0] for k in entries], dtype=np.int64)
    cols = np.array([k[1] for k in entries], dtype=np.int64)
    probs = np.array(list(entries.values()))
    em = rng.uniform(0.01, 1.0, size=(emit, states))
    starts = rng.choice(states, size=max(1, states // 4), replace=False)
    order = np.argsort(starts)
    return HMM(
        states_num=states,
        emit_num=emit,
        trans_rows=rows,
        trans_cols=cols,
        trans_probs=to_modified_prob_np(probs),
        emissions=to_modified_prob_np(em),
        start_probabilities_cols=np.sort(starts).astype(np.int64),
        start_probabilities=to_modified_prob_np(
            rng.uniform(0.01, 1.0, size=starts.size)[order]
        ),
    )


@pytest.mark.parametrize("seed", range(6))
def test_random_hmm_all_paths_agree(seed):
    rng = np.random.default_rng(seed)
    states = int(rng.integers(2, 150))
    emit = int(rng.integers(2, 24))
    deg = int(rng.integers(1, min(6, states) + 1))
    hmm = _random_hmm(rng, states, emit, deg, zero_frac=0.1 * (seed % 3))

    t = int(rng.integers(1, 60))
    seq = rng.integers(0, emit, size=t).astype(np.int32)
    want = viterbi_scores_oracle(hmm, seq)

    for mode in ("dense", "structured"):
        dec = ViterbiDecoder(hmm, mode=mode)
        assert almost_equal_vec(dec.decode(seq), want), (seed, mode)
        assert almost_equal_vec(dec.decode_batch([seq])[0], want), (seed, mode)
        if t > 1:
            scores, path = dec.decode_path(seq)
            oscores, opath = viterbi_path_oracle(hmm, seq)
            assert almost_equal_vec(scores, oscores), (seed, mode)
            assert np.array_equal(path, opath), (seed, mode)

    for level in (1, 2):
        spec = SpecializedViterbi(level=level)
        spec.spec_with(hmm)
        assert almost_equal_vec(spec.run_spec(seq), want), (seed, level)


@pytest.mark.parametrize("seed", range(3))
def test_random_hmm_streaming_paths(seed):
    """Streaming scores AND checkpoint/rematerialize paths vs the oracle
    on random fused-eligible models (random chunk splits)."""
    from spec_viterbi.ops.fused_pallas import (
        FusedStructuredDecoder,
        fused_eligible,
    )
    from spec_viterbi.ops.structured import StructuredOperator

    rng = np.random.default_rng(100 + seed)
    hmm = _random_structured_hmm(
        rng, int(rng.integers(6, 60)), int(rng.integers(2, 12))
    )
    sop = StructuredOperator.from_hmm(hmm)
    assert fused_eligible(sop), seed  # generator guarantees eligibility
    fd = FusedStructuredDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        interpret=True,
    )
    t = int(rng.integers(2, 50))
    b = int(rng.integers(1, 4))
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for _ in range(b)]
    block = np.stack(seqs, axis=1)

    state = fd.stream_begin_path(block[0])
    pos = 1
    while pos < t:
        w = int(rng.integers(1, t - pos + 1))
        state = fd.stream_feed_path(state, block[pos : pos + w])
        pos += w
    scores, paths = fd.stream_path_finalize(state)
    for i in range(b):
        want, opath = viterbi_path_oracle(hmm, seqs[i])
        assert almost_equal_vec(scores[i, : hmm.states_num], want), (seed, i)
        assert np.array_equal(paths[i], opath), (seed, i)


@pytest.mark.parametrize("seed", range(4))
def test_random_hmm_streaming_universal(seed):
    """EVERY random model streams (scores + exact paths) and matches the
    oracle through ``ViterbiDecoder.streaming(interpret=True)`` —
    fused-eligible models via the interpreted kernel engine, irregular
    ones via the XLA engine; the accessor must never raise (the streaming
    extension must not be narrower than the parity API)."""
    rng = np.random.default_rng(300 + seed)
    states = int(rng.integers(2, 120))
    emit = int(rng.integers(2, 16))
    deg = int(rng.integers(1, min(8, states) + 1))
    hmm = _random_hmm(rng, states, emit, deg, zero_frac=0.1 * (seed % 3))

    dec = ViterbiDecoder(hmm)  # auto mode: dense or structured
    eng = dec.streaming(interpret=True)
    t = int(rng.integers(2, 50))
    b = int(rng.integers(1, 4))
    block = rng.integers(0, emit, size=(t, b)).astype(np.int32)

    state = eng.stream_begin_path(block[0])
    pos = 1
    while pos < t:
        w = int(rng.integers(1, t - pos + 1))
        state = eng.stream_feed_path(state, block[pos : pos + w])
        pos += w
    scores, paths = eng.stream_path_finalize(state)
    for i in range(b):
        want, opath = viterbi_path_oracle(hmm, block[:, i])
        assert almost_equal_vec(scores[i, : hmm.states_num], want), (seed, i)
        assert np.array_equal(paths[i], opath), (seed, i)


@pytest.mark.parametrize("seed", range(4))
def test_random_hmm_kernel_bit_equal_to_xla_scan(seed):
    """Random fused-eligible models: the interpreted kernel's batched
    scores are bit-equal to the XLA structured scan and its paths equal
    the XLA path scan's and the oracle's, ragged lanes included."""
    rng = np.random.default_rng(900 + seed)
    hmm = _random_structured_hmm(
        rng, int(rng.integers(6, 60)), int(rng.integers(2, 12))
    )
    kernel = ViterbiDecoder(hmm, mode="structured", interpret=True)
    xla = ViterbiDecoder(hmm, mode="structured", use_pallas=False)
    assert kernel._fused is not None and xla._fused is None
    seqs = [
        rng.integers(0, hmm.emit_num, size=int(t)).astype(np.int32)
        for t in rng.integers(1, 40, size=5)
    ]
    for g, w in zip(kernel.decode_batch(seqs), xla.decode_batch(seqs)):
        np.testing.assert_array_equal(g, w)
    got, want = kernel.decode_path_batch(seqs), xla.decode_path_batch(seqs)
    for (gs, gp), (ws, wp), s in zip(got, want, seqs):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gp, wp)
        assert np.array_equal(gp, viterbi_path_oracle(hmm, s)[1]), seed


def test_single_state_hmm():
    """Degenerate 1-state model decodes on every path."""
    rng = np.random.default_rng(0)
    hmm = _random_hmm(rng, 1, 3, 1)
    seq = np.array([0, 2, 1], dtype=np.int32)
    want = viterbi_scores_oracle(hmm, seq)
    for mode in ("dense", "structured"):
        assert almost_equal_vec(ViterbiDecoder(hmm, mode=mode).decode(seq), want)


def test_init_distributed_single_process(monkeypatch):
    from spec_viterbi.parallel import init_distributed, process_info

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert init_distributed() is False
    info = process_info()
    assert info["process_count"] == 1 and info["global_devices"] == 8


@pytest.mark.parametrize("seed", range(6))
def test_random_hmm_time_parallel_band_closure(seed):
    """Random structured operators (whatever diagonals/rows/cols/residual
    the decomposition finds) through BOTH time-parallel compose schedules:
    scores within the ±1.0 contract, paths exact — the band-closure
    generalization stressed beyond hand-built banded models."""
    from spec_viterbi.ops.structured import StructuredOperator
    from spec_viterbi.ops.time_parallel import (
        TimeParallelDecoder,
        time_parallel_supported,
    )

    rng = np.random.default_rng(7000 + seed)
    states = int(rng.integers(4, 120))
    emit = int(rng.integers(2, 12))
    deg = int(rng.integers(1, min(5, states) + 1))
    hmm = _random_hmm(rng, states, emit, deg, zero_frac=0.1 * (seed % 3))
    sop = StructuredOperator.from_hmm(hmm)
    k = 4
    if not time_parallel_supported(sop, k):
        pytest.skip(f"band too wide at k={k} (seed {seed})")
    em = hmm.emission_matrix(pad_to=sop.n)
    pi = hmm.start_vector(pad_to=sop.n)
    t = int(rng.integers(2, 40))
    seq = rng.integers(0, emit, size=t).astype(np.int32)
    want = viterbi_scores_oracle(hmm, seq)
    _, opath = viterbi_path_oracle(hmm, seq)
    for compose in ("scan", "tree"):
        tp = TimeParallelDecoder(sop, em, pi, k=k, compose=compose)
        got = tp.decode(seq)
        assert almost_equal_vec(got, want), (seed, compose)
        _, path = tp.decode_path(seq)
        assert np.array_equal(path, opath), (seed, compose)
