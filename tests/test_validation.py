"""Observation-symbol validation at decode entry.

A sequence symbol outside ``[0, emit_num)`` used to decode garbage
silently (JAX gathers clamp; the fused kernel's one-hot zeroes out) —
every public decode entry point must raise instead.
"""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR

from spec_viterbi.hmm import validate_obs_seq
from spec_viterbi.io import read_hmm
from spec_viterbi.models.decoder import ViterbiDecoder
from spec_viterbi.models.spec_structured import StructuredSpecializedViterbi
from spec_viterbi.models.specializer import SpecializedViterbi


@pytest.fixture(scope="module")
def hmm():
    return read_hmm(os.path.join(CHMM_DIR, "100.chmm"))


def test_validate_obs_seq_passthrough():
    out = validate_obs_seq([0, 1, 2], emit_num=3)
    assert out.dtype == np.int32 and out.tolist() == [0, 1, 2]
    assert validate_obs_seq(np.zeros(0, np.int64), emit_num=3).size == 0


@pytest.mark.parametrize("bad", [[0, 20, 1], [-1, 0], [0, 1000]])
def test_validate_obs_seq_raises(bad):
    with pytest.raises(ValueError, match="out of range"):
        validate_obs_seq(np.asarray(bad), emit_num=20)


def test_validate_obs_seq_rejects_2d():
    with pytest.raises(ValueError, match="1-D"):
        validate_obs_seq(np.zeros((2, 3), np.int32), emit_num=4)


@pytest.mark.parametrize("mode", ["dense", "structured"])
def test_decoder_rejects_bad_symbols(hmm, mode):
    dec = ViterbiDecoder(hmm, mode=mode)
    bad = np.array([0, hmm.emit_num, 1], dtype=np.int32)
    good = np.array([0, 1], dtype=np.int32)
    with pytest.raises(ValueError, match="out of range"):
        dec.decode(bad)
    with pytest.raises(ValueError, match="out of range"):
        dec.decode_batch([good, bad])
    with pytest.raises(ValueError, match="out of range"):
        dec.decode_path(bad)
    with pytest.raises(ValueError, match="out of range"):
        dec.decode_path_batch([bad])


def test_specializers_reject_bad_symbols(hmm):
    bad = np.array([0, hmm.emit_num], dtype=np.int32)
    spec = SpecializedViterbi(level=2)
    spec.spec_with(hmm)
    with pytest.raises(ValueError, match="out of range"):
        spec.run_spec(bad)
    sspec = StructuredSpecializedViterbi(level=1)
    sspec.spec_with(hmm)
    with pytest.raises(ValueError, match="out of range"):
        sspec.run_spec(bad)
    # level-1 dense spec delegates to the decoder; must still raise
    spec1 = SpecializedViterbi(level=1)
    spec1.spec_with(hmm)
    with pytest.raises(ValueError, match="out of range"):
        spec1.run_spec(bad)


def test_dense_level2_big_model_warns_footgun():
    """Instantiating the dense level-L specializer where
    its batched decode is predicted >=10x slower than the structured
    specializer must emit a documented warning naming the alternative. A
    small-alphabet 160-state model crosses the threshold (256 padded /
    14 slots ~ 18x) while keeping the tuple build cheap for CI."""
    from spec_viterbi.io.generators import generate_random_hmm

    big = generate_random_hmm(
        states_num=160, trans_per_state=2, emit_range=2, seed=3
    )
    spec = SpecializedViterbi(level=2)
    with pytest.warns(UserWarning, match="StructuredSpecializedViterbi"):
        spec.spec_with(big)
    # the prediction model itself: 1024 padded states / 14 slots ~ 73x
    assert SpecializedViterbi.predicted_dense_decode_slowdown(902, 2) > 10
    assert SpecializedViterbi.predicted_dense_decode_slowdown(902, 1) == 1.0


def test_dense_spec_small_model_does_not_warn(hmm):
    """The 102-state fixture stays under the 10x prediction at level 2
    (128 padded / 14 slots ~ 9.1x) -- no warning noise for the sizes the
    dense path is actually good at."""
    import warnings as _w

    spec = SpecializedViterbi(level=2)
    with _w.catch_warnings():
        _w.simplefilter("error")
        spec.spec_with(hmm)
