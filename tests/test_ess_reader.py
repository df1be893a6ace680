"""Parser golden test for .ess files (mirrors tests/test_ess_reader.cpp:3-10)."""

import numpy as np
import pytest

from spec_viterbi.io import read_emit_seq, write_ess
from tests.conftest import TEST_SEQS


def test_ess_reader_fixture0():
    seqs = read_emit_seq(f"{TEST_SEQS}/0_test_seq.ess")
    assert len(seqs) == 2
    np.testing.assert_array_equal(seqs[0], [2, 2, 1, 0, 1, 3, 2, 0, 0])
    np.testing.assert_array_equal(seqs[1], [3, 2, 1, 0])


def test_ess_numbering_validation(tmp_path):
    """Bad sequence numbering is rejected (data_reader.cpp:111-119)."""
    bad = tmp_path / "bad.ess"
    bad.write_text("2\n0 2\n1 1\n5 2\n0 0\n")
    with pytest.raises(ValueError, match="expected sequence number"):
        read_emit_seq(bad)


def test_ess_roundtrip(tmp_path):
    seqs = read_emit_seq(f"{TEST_SEQS}/0_test_seq.ess")
    out = tmp_path / "rt.ess"
    write_ess(seqs, out)
    seqs2 = read_emit_seq(out)
    assert len(seqs2) == len(seqs)
    for a, b in zip(seqs, seqs2):
        np.testing.assert_array_equal(a, b)
