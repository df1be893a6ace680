"""State-sharded structured decode (halo-exchange TP) vs the oracle."""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_hmm
from spec_viterbi.models.oracle import viterbi_scores_oracle
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.parallel import make_mesh
from spec_viterbi.parallel.structured_tp import (
    decode_batch_structured_tp,
    structured_tp_supported,
)


@pytest.fixture(scope="module")
def model():
    return read_hmm(os.path.join(CHMM_DIR, "100.chmm"))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_structured_tp_matches_oracle(model, shards):
    mesh = make_mesh(state=shards)
    sop = StructuredOperator.from_hmm(model)
    assert structured_tp_supported(sop, shards)
    rng = np.random.default_rng(31)
    seqs = [rng.integers(0, model.emit_num, size=t).astype(np.int32) for t in (1, 9, 40)]
    got = decode_batch_structured_tp(model, seqs, mesh)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(model, s)), len(s)


def test_structured_tp_larger_model():
    hmm = read_hmm(os.path.join(CHMM_DIR, "500.chmm"))
    mesh = make_mesh(state=8)
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, hmm.emit_num, size=64).astype(np.int32)]
    got = decode_batch_structured_tp(hmm, seqs, mesh)
    assert almost_equal_vec(got[0], viterbi_scores_oracle(hmm, seqs[0]))


def test_structured_tp_self_loop_diagonal():
    """d == 0 (self-loop) diagonals need no halo and must be supported."""
    from spec_viterbi.hmm import HMM, to_modified_prob_np

    rng = np.random.default_rng(17)
    states = 48
    # dense fan-out row 0 + self-loop on every state (offset-0 diagonal)
    rows = [0] * states + list(range(2, states))
    cols = list(range(states)) + list(range(2, states))
    probs = rng.uniform(0.1, 1.0, size=len(rows))
    hmm = HMM(
        states_num=states,
        emit_num=4,
        trans_rows=np.asarray(rows, dtype=np.int64),
        trans_cols=np.asarray(cols, dtype=np.int64),
        trans_probs=to_modified_prob_np(probs),
        emissions=to_modified_prob_np(rng.uniform(0.1, 1.0, size=(4, states))),
        start_probabilities_cols=np.array([0], dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.array([1.0])),
    )
    sop = StructuredOperator.from_hmm(hmm)
    assert 0 in sop.diag_offsets, sop.diag_offsets
    assert structured_tp_supported(sop, 4)
    mesh = make_mesh(state=4)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (3, 21)]
    got = decode_batch_structured_tp(hmm, seqs, mesh)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s)), len(s)


@pytest.mark.parametrize("shards", [2, 8])
def test_structured_dp_matches_oracle(model, shards):
    from spec_viterbi.parallel import decode_batch_structured_dp

    mesh = make_mesh(data=shards)
    rng = np.random.default_rng(41)
    seqs = [rng.integers(0, model.emit_num, size=t).astype(np.int32) for t in (5, 27, 50)]
    got = decode_batch_structured_dp(model, seqs, mesh)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(model, s)), len(s)
