"""Parser golden test — field-by-field check of 0_test_chmm.chmm.

Mirrors ``tests/test_chmm_reader.cpp:3-31`` exactly: every parsed field of
the fixture is compared against hand-computed −log2 values.
"""

import numpy as np
import pytest

from spec_viterbi.hmm import almost_equal, to_modified_prob
from spec_viterbi.io import read_hmm
from tests.conftest import TEST_CHMMS


def test_chmm_reader_fixture0():
    hmm = read_hmm(f"{TEST_CHMMS}/0_test_chmm.chmm")

    assert hmm.states_num == 3
    assert hmm.non_zero_start_probs == 2
    assert almost_equal(hmm.start_probabilities[0], to_modified_prob(0.5))
    assert almost_equal(hmm.start_probabilities[1], to_modified_prob(0.5))
    assert list(hmm.start_probabilities_cols) == [0, 1]

    assert hmm.emit_num == 4
    assert hmm.emissions.shape == (4, 3)
    # emissions[symbol][state] — transposed from file layout
    expected = {
        (0, 0): 0.2, (1, 0): 0.3, (2, 0): 0.3, (3, 0): 0.2,
        (0, 1): 0.3, (1, 1): 0.2, (2, 1): 0.2, (3, 1): 0.3,
        (0, 2): 0.3, (1, 2): 0.2, (2, 2): 0.2, (3, 2): 0.3,
    }
    for (sym, state), p in expected.items():
        assert almost_equal(hmm.emissions[sym, state], to_modified_prob(p))

    assert hmm.trans_num == 4
    assert list(hmm.trans_rows) == [0, 0, 1, 1]
    assert list(hmm.trans_cols) == [0, 1, 0, 1]
    for i, p in enumerate([0.5, 0.5, 0.4, 0.6]):
        assert almost_equal(hmm.trans_probs[i], to_modified_prob(p))


def test_chmm_reader_exact_neglog2():
    """Exact −log2 conversion (tighter than the reference's ±1.0 check)."""
    hmm = read_hmm(f"{TEST_CHMMS}/0_test_chmm.chmm")
    np.testing.assert_allclose(
        hmm.start_probabilities, [1.0, 1.0], rtol=1e-6
    )  # −log2(0.5) = 1
    assert hmm.trans_probs[3] == pytest.approx(-np.log2(0.6), rel=1e-6)


def test_chmm_zero_prob_maps_to_inf():
    """p == 0 must load as the semiring zero +inf (HMM.h:51-57)."""
    hmm = read_hmm(f"{TEST_CHMMS}/1_test_chmm.chmm")
    # fixture 1: start prob of state 1 is 0.0
    assert np.isposinf(hmm.start_probabilities[1])


def test_chmm_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        read_hmm("/nonexistent/path.chmm")


def test_chmm_roundtrip(tmp_path):
    from spec_viterbi.io import write_chmm

    hmm = read_hmm(f"{TEST_CHMMS}/3_test_chmm.chmm")
    out = tmp_path / "rt.chmm"
    write_chmm(hmm, out)
    hmm2 = read_hmm(out)
    assert hmm2.states_num == hmm.states_num
    assert hmm2.emit_num == hmm.emit_num
    np.testing.assert_allclose(hmm2.emissions, hmm.emissions, rtol=1e-5)
    np.testing.assert_array_equal(hmm2.trans_rows, hmm.trans_rows)
    np.testing.assert_array_equal(hmm2.trans_cols, hmm.trans_cols)
    np.testing.assert_allclose(hmm2.trans_probs, hmm.trans_probs, rtol=1e-5)
