"""Structured-operator decomposition and decode vs the NumPy oracle.

The structured path plays the role of the reference's sparse backends
(GraphBLAS/CUSP) in the cross-validation matrix (SURVEY.md §4 tier 3).
"""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR, TEST_CHMMS

from spec_viterbi.hmm import HMM, almost_equal_vec, to_modified_prob_np
from spec_viterbi.io import read_hmm, read_emit_seq
from spec_viterbi.models.decoder import ViterbiDecoder
from spec_viterbi.models.oracle import viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi.ops.structured import StructuredOperator


def _random_hmm(states, emit, deg, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(states, dtype=np.int64), deg)
    cols = rng.integers(0, states, size=states * deg).astype(np.int64)
    probs = to_modified_prob_np(rng.uniform(0.05, 1.0, size=states * deg))
    em = to_modified_prob_np(rng.uniform(0.05, 1.0, size=(emit, states)))
    start_cols = np.arange(min(4, states), dtype=np.int64)
    start_probs = to_modified_prob_np(rng.uniform(0.05, 1.0, size=start_cols.size))
    return HMM(
        states_num=states,
        emit_num=emit,
        trans_rows=rows,
        trans_cols=cols,
        trans_probs=probs,
        emissions=em,
        start_probabilities_cols=start_cols,
        start_probabilities=start_probs,
    )


def test_corpus_decomposition_is_exact_and_compact():
    """Every profile model decomposes with zero residual and ≤5 parts."""
    from spec_viterbi.io.generators import generate_profile_hmm

    for name in ("100", "500", "1200", "2405"):
        path = os.path.join(CHMM_DIR, f"{name}.chmm")
        hmm = (
            read_hmm(path) if os.path.exists(path)
            else generate_profile_hmm(int(name), seed=int(name))
        )
        sop = StructuredOperator.from_hmm(hmm)
        assert sop.residual_nnz == 0, name
        assert sop.num_components <= 5, (name, sop.num_components)
        assert sop.cost_ratio() < 0.05, name


def test_decomposition_random_hmm_reconstructs_matrix():
    """diag ∪ rows ∪ cols ∪ residual reproduces the dense operator exactly."""
    hmm = _random_hmm(64, 4, 3, seed=11)
    n = hmm.padded_states
    sop = StructuredOperator.from_hmm(hmm, pad_to=n)
    dense = np.full((n, n), np.inf, dtype=np.float32)  # dense[dst, src] = Aᵀ
    for k, d in enumerate(sop.diag_offsets):
        for i in range(n):
            j = i - d
            if 0 <= j < n:
                dense[i, j] = min(dense[i, j], sop.diag_vals[k, i])
    for k, s in enumerate(sop.row_idx):
        for i in range(n):
            dense[i, s] = min(dense[i, s], sop.row_vals[k, i])
    for k, c in enumerate(sop.col_idx):
        for j in range(n):
            dense[c, j] = min(dense[c, j], sop.col_vals[k, j])
    for s, d, v in zip(sop.res_src, sop.res_dst, sop.res_vals):
        dense[d, s] = min(dense[d, s], v)
    want = hmm.transposed_transition_matrix(pad_to=n)
    np.testing.assert_array_equal(dense, want)


@pytest.mark.parametrize("name", ["100", "500"])
def test_structured_decode_matches_oracle(name):
    hmm = read_hmm(os.path.join(CHMM_DIR, f"{name}.chmm"))
    rng = np.random.default_rng(5)
    dec = ViterbiDecoder(hmm, mode="structured")
    assert dec.mode == "structured"
    for t in (1, 2, 63, 200):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        got = dec.decode(seq)
        want = viterbi_scores_oracle(hmm, seq)
        assert almost_equal_vec(got, want), t


def test_structured_batch_matches_oracle():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    rng = np.random.default_rng(9)
    dec = ViterbiDecoder(hmm, mode="structured")
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (30, 77, 5)]
    got = dec.decode_batch(seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))


def test_structured_path_matches_oracle_exactly():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    rng = np.random.default_rng(13)
    dec = ViterbiDecoder(hmm, mode="structured")
    for t in (2, 40, 111):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        scores, path = dec.decode_path(seq)
        oscores, opath = viterbi_path_oracle(hmm, seq)
        assert almost_equal_vec(scores, oscores)
        assert np.array_equal(path, opath), t


def test_structured_fixtures_with_unreachable_states(fixture_paths):
    """The tiny fixtures exercise +inf rows and residual-COO handling."""
    for chmm_path, ess_path in fixture_paths:
        hmm = read_hmm(chmm_path)
        seqs = read_emit_seq(ess_path)
        dec = ViterbiDecoder(hmm, mode="structured")
        for s in seqs:
            got = dec.decode(s)
            assert almost_equal_vec(got, viterbi_scores_oracle(hmm, s))
            scores, path = dec.decode_path(s)
            oscores, opath = viterbi_path_oracle(hmm, s)
            assert almost_equal_vec(scores, oscores)
            assert np.array_equal(path, opath)


def test_random_hmm_structured_decode_with_residual():
    """A random HMM (no exploitable structure) still decodes correctly via
    the residual-COO slow path."""
    hmm = _random_hmm(48, 5, 3, seed=21)
    sop = StructuredOperator.from_hmm(hmm)
    assert sop.residual_nnz > 0  # genuinely exercises the residual branch
    rng = np.random.default_rng(2)
    dec = ViterbiDecoder(hmm, mode="structured")
    for t in (3, 17):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        assert almost_equal_vec(dec.decode(seq), viterbi_scores_oracle(hmm, seq))
        scores, path = dec.decode_path(seq)
        _, opath = viterbi_path_oracle(hmm, seq)
        assert np.array_equal(path, opath)


def test_auto_mode_selects_structured_on_corpus():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    dec = ViterbiDecoder(hmm)  # mode="auto"
    assert dec.mode == "structured"


def test_spec_level1_delegates_to_structured_path():
    from spec_viterbi.models.specializer import SpecializedViterbi

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    spec = SpecializedViterbi(level=1)
    spec.spec_with(hmm)
    assert spec._delegate is not None  # structured routing engaged
    rng = np.random.default_rng(17)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (9, 33)]
    for s in seqs:
        assert almost_equal_vec(spec.run_spec(s), viterbi_scores_oracle(hmm, s))
    got = spec.run_spec_batch(seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))


@pytest.mark.parametrize("level", [2, 3])
def test_spec_levelL_batched_decode(level):
    """Dense-spec level-L batched decode: one device program per length
    bucket over per-lane tuple-operator gathers — never a host loop
    — exactly equal to the scalar chunked path and
    oracle-close."""
    from spec_viterbi.models.specializer import SpecializedViterbi

    hmm = read_hmm(os.path.join(TEST_CHMMS, "1_test_chmm.chmm"))
    spec = SpecializedViterbi(level=level)
    spec.spec_with(hmm)
    assert spec._delegate is None
    rng = np.random.default_rng(23)
    # mixed lengths incl. chunk-boundary cases (tail of 0, 1, level-1)
    lens = (1, 4, 7, 7, 2 * level + 1, 3 * level)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens]
    got = spec.run_spec_batch(seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))
        # same chunk boundaries as the scalar path -> identical floats
        assert np.array_equal(
            np.nan_to_num(g, posinf=-1),
            np.nan_to_num(spec.run_spec(s), posinf=-1),
        )
    # lane-chunking must not change results
    spec._batch_lane_cap = 2
    got2 = spec.run_spec_batch(seqs)
    for a, b in zip(got, got2):
        assert np.array_equal(np.nan_to_num(a, posinf=-1), np.nan_to_num(b, posinf=-1))


def test_mode_validation():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    with pytest.raises(ValueError, match="mode must be one of"):
        ViterbiDecoder(hmm, mode="structure")
    # the removed dense-Pallas backend is not silently accepted
    with pytest.raises(ValueError, match="mode must be one of"):
        ViterbiDecoder(hmm, mode="pallas")


def test_structured_mode_skips_dense_uploads():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    dec = ViterbiDecoder(hmm)  # auto → structured
    assert dec.dev.a is None and dec.dev.a_t is None
    dense = ViterbiDecoder(hmm, mode="dense")
    assert dense.dev.a is not None


def test_fingerprint_distinguishes_start_array_shapes():
    from spec_viterbi.hmm import HMM, to_modified_prob_np

    base = dict(
        states_num=4,
        emit_num=2,
        trans_rows=np.array([0, 1], dtype=np.int64),
        trans_cols=np.array([1, 2], dtype=np.int64),
        trans_probs=to_modified_prob_np(np.array([0.5, 0.5])),
        emissions=to_modified_prob_np(np.full((2, 4), 0.5)),
    )
    h1 = HMM(**base, start_probabilities_cols=np.array([0], dtype=np.int64),
             start_probabilities=to_modified_prob_np(np.array([1.0])))
    h2 = HMM(**base, start_probabilities_cols=np.array([0, 1], dtype=np.int64),
             start_probabilities=to_modified_prob_np(np.array([0.5, 0.5])))
    assert h1.fingerprint() != h2.fingerprint()
    # canonical dtypes: int32 vs int64 index arrays hash identically
    h3 = HMM(**{**base, "trans_rows": base["trans_rows"].astype(np.int32)},
             start_probabilities_cols=np.array([0], dtype=np.int64),
             start_probabilities=to_modified_prob_np(np.array([1.0])))
    assert h1.fingerprint() == h3.fingerprint()
