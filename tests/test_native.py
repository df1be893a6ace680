"""Native C++ parsers vs the pure-Python semantics reference.

Field-for-field equality on every fixture and a production model — the
native layer must be bit-identical, not merely almost_equal (both compute
−log2 in double then round to f32).
"""

import glob
import os

import numpy as np
import pytest

from conftest import CHMM_DIR, ESS_DIR, TEST_CHMMS, TEST_SEQS

from spec_viterbi.io.chmm import _parse_tokens as parse_chmm_py
from spec_viterbi.io.ess import _parse_tokens as parse_ess_py
from spec_viterbi.native import loader


@pytest.fixture(scope="module")
def native():
    if not loader.native_available():
        pytest.skip("native library unavailable (no toolchain)")
    return loader


def _py_hmm(path):
    with open(path) as f:
        return parse_chmm_py(f.read().split(), path)


def _py_ess(path):
    with open(path) as f:
        return parse_ess_py(f.read().split(), path)


@pytest.mark.parametrize(
    "path",
    sorted(glob.glob(os.path.join(TEST_CHMMS, "*.chmm")))
    + [os.path.join(CHMM_DIR, "500.chmm")],
)
def test_chmm_native_matches_python(native, path):
    got = native.read_hmm_native(path)
    assert got is not None
    want = _py_hmm(path)
    assert got.states_num == want.states_num
    assert got.emit_num == want.emit_num
    np.testing.assert_array_equal(got.trans_rows, want.trans_rows)
    np.testing.assert_array_equal(got.trans_cols, want.trans_cols)
    np.testing.assert_array_equal(got.trans_probs, want.trans_probs)
    np.testing.assert_array_equal(got.emissions, want.emissions)
    np.testing.assert_array_equal(
        got.start_probabilities_cols, want.start_probabilities_cols
    )
    np.testing.assert_array_equal(got.start_probabilities, want.start_probabilities)


@pytest.mark.parametrize(
    "path",
    sorted(glob.glob(os.path.join(TEST_SEQS, "*.ess")))
    + [os.path.join(ESS_DIR, "emit_3_3500_20.ess")],
)
def test_ess_native_matches_python(native, path):
    got = native.read_ess_native(path)
    assert got is not None
    want = _py_ess(path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_rejects_bad_ess_numbering(native, tmp_path):
    bad = tmp_path / "bad.ess"
    bad.write_text("2\n0 2\n1 1\n5 2\n0 0\n")  # second header says 5, not 1
    assert native.read_ess_native(str(bad)) is None


def test_native_rejects_missing_file(native):
    assert native.read_hmm_native("/nonexistent/x.chmm") is None
    assert native.read_ess_native("/nonexistent/x.ess") is None


def test_native_rejects_hostile_allocation_header(native, tmp_path):
    """A corrupt header claiming 2e9 states must return None (Python
    fallback then raises), not abort the process via bad_alloc."""
    bad = tmp_path / "hostile.chmm"
    bad.write_text("2000000000\n0\n20\n")
    assert native.read_hmm_native(str(bad)) is None
    bad_ess = tmp_path / "hostile.ess"
    bad_ess.write_text("1\n0 9000000000\n")
    assert native.read_ess_native(str(bad_ess)) is None


def test_public_api_uses_native_when_available(native):
    """read_hmm goes through the native fast path transparently."""
    from spec_viterbi.io import read_hmm

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    assert hmm.states_num == 102
