"""HMMER3 → chmm converter on the seeded corpus.

The seeded corpus ships each profile twice: as ``.hmm`` text (with the
reference's raw ``B→M1`` token and per-node neg-ln scores) and as the
``.chmm`` built directly from the profile numbers. The converter must
reproduce the ``.chmm`` from the text (including the reference's
off-by-one match-transition quirk — see io/hmmer.py) numerically.
"""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR

from spec_viterbi.io import hmmer_to_hmm, read_hmm


def _masked(a):
    return np.where(np.isinf(a), -1.0, a)


@pytest.mark.parametrize("name", ["100", "500", "1200"])
def test_converter_reproduces_committed_corpus(name):
    got = hmmer_to_hmm(os.path.join(CHMM_DIR, f"{name}.hmm"))
    want = read_hmm(os.path.join(CHMM_DIR, f"{name}.chmm"))
    assert got.states_num == want.states_num
    assert got.emit_num == want.emit_num
    assert got.trans_num == want.trans_num
    np.testing.assert_allclose(
        _masked(got.emissions), _masked(want.emissions), atol=1e-4
    )
    gd, wd = got.transition_matrix(), want.transition_matrix()
    assert np.array_equal(np.isinf(gd), np.isinf(wd))  # exact sparsity pattern
    np.testing.assert_allclose(_masked(gd), _masked(wd), atol=1e-4)
    np.testing.assert_array_equal(
        got.start_probabilities_cols, want.start_probabilities_cols
    )


def test_converter_roundtrips_through_chmm(tmp_path):
    from spec_viterbi.cli import main

    out = tmp_path / "conv.chmm"
    rc = main(["hmmer-to-chmm", os.path.join(CHMM_DIR, "100.hmm"), str(out)])
    assert rc == 0
    got = read_hmm(str(out))
    want = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    np.testing.assert_allclose(
        _masked(got.transition_matrix()), _masked(want.transition_matrix()), atol=1e-4
    )
