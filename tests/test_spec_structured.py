"""Structured level-L specialization vs the dense specializer and oracle."""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR, TEST_CHMMS

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_emit_seq, read_hmm
from spec_viterbi.models.oracle import viterbi_scores_oracle
from spec_viterbi.models.spec_structured import StructuredSpecializedViterbi
from spec_viterbi.models.specializer import SpecializedViterbi
from spec_viterbi.ops import structured_compose as sc
from spec_viterbi.ops.structured import StructuredOperator


def test_composition_algebra_matches_dense_products():
    """Closure rules vs dense tropical matmuls on a production model."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    n = hmm.padded_states
    sop = StructuredOperator.from_hmm(hmm, pad_to=n)
    comps = sc.from_structured(sop)
    at = hmm.transposed_transition_matrix(pad_to=n)
    mask = lambda a: np.where(np.isinf(a), -1.0, a)
    np.testing.assert_array_equal(mask(sc.to_dense(comps, n)), mask(at))

    em = hmm.emission_matrix(pad_to=n)

    def sym_op(o):
        return [
            sc.Diag(c.offset, c.vals + em[o])
            if isinstance(c, sc.Diag)
            else sc.Rank1(c.u + em[o], c.w)
            for c in comps
        ]

    m0, m1 = sym_op(0), sym_op(1)
    d0, d1 = sc.to_dense(m0, n), sc.to_dense(m1, n)
    ref = np.min(d1[:, :, None] + d0[None, :, :], axis=1)
    got = sc.to_dense(sc.compose(m1, m0), n)
    np.testing.assert_allclose(mask(got), mask(ref), atol=1e-4)


def test_batched_compose_matches_pairwise_algebra():
    """The array-form level step must produce the same dense operator as
    the pairwise compose() path for every symbol pair."""
    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))  # has residual
    n = hmm.padded_states
    sop = StructuredOperator.from_hmm(hmm, pad_to=n)
    em = hmm.emission_matrix(pad_to=n)
    e = hmm.emit_num

    l1, l2 = sc.batched_levels(sop, em, 2)
    offsets, dv, uu, ww = l2
    mask = lambda a: np.where(np.isinf(a), -1.0, a)

    base = sc.from_structured(sop)

    def sym_op(o):
        return [
            sc.Diag(c.offset, c.vals + em[o])
            if isinstance(c, sc.Diag)
            else sc.Rank1(c.u + em[o], c.w)
            for c in base
        ]

    for o2 in range(e):
        for o1 in range(e):
            want = sc.to_dense(sc.compose(sym_op(o2), sym_op(o1)), n)
            ti = o1 + o2 * e  # earliest symbol least significant
            comps = [
                sc.Diag(d, dv[ti, k]) for k, d in enumerate(offsets)
            ] + [
                sc.Rank1(uu[ti, r], ww[ti, r]) for r in range(uu.shape[1])
            ]
            got = sc.to_dense(comps, n)
            np.testing.assert_allclose(
                mask(got), mask(want), atol=1e-4, err_msg=f"{o2},{o1}"
            )


def test_structured_spec_operator_cache_roundtrip(tmp_path):
    from spec_viterbi.utils.cache import OperatorCache

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    cache = OperatorCache(cache_dir=str(tmp_path))
    rng = np.random.default_rng(41)
    seq = rng.integers(0, hmm.emit_num, size=33).astype(np.int32)

    cold = StructuredSpecializedViterbi(level=2, cache=cache)
    cold.spec_with(hmm)
    want = cold.run_spec(seq)
    cold._store_thread.join()  # background publish
    assert os.listdir(tmp_path)  # something persisted

    warm = StructuredSpecializedViterbi(level=2, cache=cache)
    warm.spec_with(hmm)
    assert warm.tuple_offsets == cold.tuple_offsets
    assert almost_equal_vec(warm.run_spec(seq), want)
    assert almost_equal_vec(want, viterbi_scores_oracle(hmm, seq))


def test_component_growth_is_small():
    hmm = read_hmm(os.path.join(CHMM_DIR, "500.chmm"))
    spec = StructuredSpecializedViterbi(level=2)
    spec.spec_with(hmm)
    assert spec.num_components <= 12  # vs a dense N×N matrix per tuple
    # level-2 memory: E²·C·N floats ≪ E²·N² dense
    dense_bytes = SpecializedViterbi.spec_memory_bytes(hmm.states_num, hmm.emit_num, 2)
    structured_bytes = (
        hmm.emit_num**2 * spec.num_components * hmm.padded_states * 4
    )
    assert structured_bytes < dense_bytes / 20


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("i", range(4))
def test_structured_spec_fixture_golden(fixture_paths, i, level):
    chmm_path, ess_path = fixture_paths[i]
    hmm = read_hmm(chmm_path)
    seq = read_emit_seq(ess_path)[0]
    spec = StructuredSpecializedViterbi(level=level)
    spec.spec_with(hmm)
    got = spec.run_spec(seq)
    assert almost_equal_vec(got, viterbi_scores_oracle(hmm, seq)), (i, level)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_structured_spec_matches_dense_spec_on_corpus(level):
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    rng = np.random.default_rng(19)
    s_spec = StructuredSpecializedViterbi(level=level)
    s_spec.spec_with(hmm)
    d_spec = SpecializedViterbi(level=level)
    d_spec.spec_with(hmm)
    for t in (1, 2, 5, 64, 101):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        got = s_spec.run_spec(seq)
        assert almost_equal_vec(got, d_spec.run_spec(seq)), (level, t)
        assert almost_equal_vec(got, viterbi_scores_oracle(hmm, seq)), (level, t)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_structured_spec_batched_matches_scalar(level):
    """run_spec_batch (per-lane tuple gather, length-bucketed) must agree
    with the scalar chunked path and the oracle on ragged batches."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    rng = np.random.default_rng(23)
    spec = StructuredSpecializedViterbi(level=level)
    spec.spec_with(hmm)
    # ragged lengths incl. chunk-boundary cases: len-1 ≡ 0/1/2 (mod level)
    lens = (1, 2, 3, 7, 40, 41, 42, 7)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens]
    got = spec.run_spec_batch(seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, spec.run_spec(s)), len(s)
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s)), len(s)


def test_structured_spec_batched_rejects_bad_symbols():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    spec = StructuredSpecializedViterbi(level=2)
    spec.spec_with(hmm)
    with pytest.raises(ValueError, match="out of range"):
        spec.run_spec_batch([np.array([0, hmm.emit_num], dtype=np.int32)])


def test_structured_spec_respecialization(fixture_paths):
    spec = StructuredSpecializedViterbi(level=2)
    h0 = read_hmm(fixture_paths[0][0])
    h1 = read_hmm(fixture_paths[1][0])
    s0 = read_emit_seq(fixture_paths[0][1])[0]
    s1 = read_emit_seq(fixture_paths[1][1])[0]
    spec.spec_with(h0)
    assert almost_equal_vec(spec.run_spec(s0), viterbi_scores_oracle(h0, s0))
    spec.spec_with(h1)
    assert almost_equal_vec(spec.run_spec(s1), viterbi_scores_oracle(h1, s1))
