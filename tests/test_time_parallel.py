"""Time-parallel single-sequence decode (lanes = time blocks) vs the
serial paths and the oracle.

Scores carry the reference's ±1.0 contract (float association differs by
design — the composed-operator reorder, like the reference's own
specialization); paths must match the oracle EXACTLY (rematerialized with
the serial per-step rules from the composed frontiers)."""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_hmm
from spec_viterbi.models.decoder import ViterbiDecoder
from spec_viterbi.models.oracle import viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.ops.time_parallel import (
    TimeParallelDecoder,
    time_parallel_supported,
)


@pytest.fixture(scope="module")
def model():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    sop = StructuredOperator.from_hmm(hmm)
    assert time_parallel_supported(sop)  # Pfam match chain: one diagonal
    tp = TimeParallelDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        k=8,
    )
    return hmm, sop, tp


@pytest.mark.parametrize("t", [1, 2, 8, 9, 17, 65, 200])
def test_scores_match_serial_and_oracle(model, t):
    hmm, sop, tp = model
    rng = np.random.default_rng(t)
    seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
    got = tp.decode(seq)
    want = viterbi_scores_oracle(hmm, seq)
    assert almost_equal_vec(got, want)
    # drift vs the serial structured path is ulp-scale, not contract-scale
    serial = ViterbiDecoder(hmm, mode="structured", use_pallas=False).decode(seq)
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    if finite.any():
        assert np.max(np.abs(got[finite] - serial[finite])) < 1e-3


@pytest.mark.parametrize("k", [3, 8, 16])
def test_k_invariance(model, k):
    hmm, sop, _ = model
    tp = TimeParallelDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), k=k
    )
    rng = np.random.default_rng(100 + k)
    seq = rng.integers(0, hmm.emit_num, size=3 * k + 2).astype(np.int32)
    assert almost_equal_vec(tp.decode(seq), viterbi_scores_oracle(hmm, seq))


@pytest.mark.parametrize("t", [2, 9, 33, 100])
def test_paths_match_oracle_exactly(model, t):
    hmm, sop, tp = model
    rng = np.random.default_rng(1000 + t)
    seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
    scores, path = tp.decode_path(seq)
    oscores, opath = viterbi_path_oracle(hmm, seq)
    assert almost_equal_vec(scores, oscores)
    assert np.array_equal(path, opath)


@pytest.mark.parametrize("lane_padded", [True, False])
def test_paths_via_fused_engine(model, lane_padded):
    """Rematerialization through the kernel's path mode (interpreted
    here) produces the same exact paths, also when the kernel's
    tile-padded state axis (128 for 102 states) is wider than the
    operator's."""
    from spec_viterbi.ops.fused_pallas import FusedStructuredDecoder, tile_layout

    hmm, sop, tp = model
    if not lane_padded:
        sop = StructuredOperator.from_hmm(hmm, pad_to=hmm.states_num)
        assert tile_layout(sop.n)[1] != sop.n
        tp = TimeParallelDecoder(
            sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), k=8
        )
    fd = FusedStructuredDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        interpret=True,
    )
    rng = np.random.default_rng(77)
    seq = rng.integers(0, hmm.emit_num, size=25).astype(np.int32)
    scores, path = tp.decode_path(seq, engine=fd)
    _, opath = viterbi_path_oracle(hmm, seq)
    assert np.array_equal(path, opath)


@pytest.mark.parametrize(
    "offsets,k", [((-1, 1), 4), ((1, 2), 8), ((-2, 0, 3), 5)]
)
def test_multi_diag_band_closure(offsets, k):
    """Multi-diagonal banded operators compose into a k·span+1-wide band
    (not just the single diagonal of the profile models).
    Scores vs oracle under the ±1.0 contract; paths exact."""
    from conftest import banded_hmm

    hmm = banded_hmm(n=128, offsets=offsets, seed=sum(abs(d) for d in offsets))
    sop = StructuredOperator.from_hmm(hmm)
    assert time_parallel_supported(sop, k)
    tp = TimeParallelDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), k=k
    )
    span = max(offsets) - min(offsets)
    assert tp.w_band == k * span + 1
    rng = np.random.default_rng(k)
    for t in (2, k, 3 * k + 2, 50):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        got = tp.decode(seq)
        want = viterbi_scores_oracle(hmm, seq)
        assert almost_equal_vec(got, want), (offsets, k, t)
        scores, path = tp.decode_path(seq)
        _, opath = viterbi_path_oracle(hmm, seq)
        assert np.array_equal(path, opath), (offsets, k, t)


def test_band_width_cap():
    """A band wider than MAX_BAND_SLOTS is rejected with a clear error."""
    from conftest import banded_hmm

    from spec_viterbi.ops.time_parallel import MAX_BAND_SLOTS

    hmm = banded_hmm(n=512, offsets=(-8, 8), seed=3)
    sop = StructuredOperator.from_hmm(hmm)
    k = MAX_BAND_SLOTS // 16 + 1  # k·span+1 > cap
    assert not time_parallel_supported(sop, k)
    with pytest.raises(ValueError, match="band"):
        TimeParallelDecoder(
            sop,
            hmm.emission_matrix(pad_to=sop.n),
            hmm.start_vector(pad_to=sop.n),
            k=k,
        )


@pytest.mark.parametrize("k", [2, 4, 8, 16])
def test_tree_compose_matches_scan_and_oracle(model, k):
    """The pairwise tree compose (k/log2(k) less HBM traffic) must agree
    with the scan compose, the oracle, and produce exact paths."""
    hmm, sop, _ = model
    em = hmm.emission_matrix(pad_to=sop.n)
    pi = hmm.start_vector(pad_to=sop.n)
    tp_tree = TimeParallelDecoder(sop, em, pi, k=k, compose="tree")
    tp_scan = TimeParallelDecoder(sop, em, pi, k=k, compose="scan")
    rng = np.random.default_rng(500 + k)
    for t in (2, k + 1, 4 * k + 3):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        want = viterbi_scores_oracle(hmm, seq)
        got_t = tp_tree.decode(seq)
        got_s = tp_scan.decode(seq)
        assert almost_equal_vec(got_t, want), (k, t)
        finite = np.isfinite(want)
        # scan and tree differ only by float association: ulp-scale
        if finite.any():
            assert np.max(np.abs(got_t[finite] - got_s[finite])) < 1e-3
        _, path = tp_tree.decode_path(seq)
        _, opath = viterbi_path_oracle(hmm, seq)
        assert np.array_equal(path, opath), (k, t)


def test_tree_compose_multi_diag():
    from conftest import banded_hmm

    hmm = banded_hmm(n=128, offsets=(-1, 1))
    sop = StructuredOperator.from_hmm(hmm)
    em = hmm.emission_matrix(pad_to=sop.n)
    pi = hmm.start_vector(pad_to=sop.n)
    tp = TimeParallelDecoder(sop, em, pi, k=4, compose="tree")
    rng = np.random.default_rng(9)
    for t in (2, 9, 30):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        assert almost_equal_vec(tp.decode(seq), viterbi_scores_oracle(hmm, seq)), t


def test_tree_compose_rejects_non_power_of_two(model):
    hmm, sop, _ = model
    with pytest.raises(ValueError, match="power of two"):
        TimeParallelDecoder(
            sop,
            hmm.emission_matrix(pad_to=sop.n),
            hmm.start_vector(pad_to=sop.n),
            k=6,
            compose="tree",
        )
