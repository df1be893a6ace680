"""Sharded decode paths cross-validate against the NumPy oracle on a virtual
8-device CPU mesh (the reference never tests multi-node because it is
single-node, SURVEY.md §4; this suite is the extension's oracle)."""

import numpy as np
import pytest

from spec_viterbi.io import read_hmm, read_emit_seq
from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.models.decoder import DeviceHMM
from spec_viterbi.models.oracle import viterbi_scores_oracle
from spec_viterbi.parallel import (
    decode_batch_dp,
    decode_batch_dp_tp,
    decode_time_parallel,
    decode_tp,
    make_mesh,
)

from conftest import CHMM_DIR, TEST_CHMMS, TEST_SEQS
import os


@pytest.fixture(scope="module")
def small_model():
    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    seqs = read_emit_seq(os.path.join(TEST_SEQS, "3_test_seq.ess"))
    return hmm, seqs


@pytest.fixture(scope="module")
def production_model():
    """Smallest production model: real sparsity, 102 states, 20 symbols."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    rng = np.random.default_rng(7)
    seqs = [rng.integers(0, hmm.emit_num, size=n).astype(np.int32) for n in (37, 64, 129)]
    return hmm, seqs


def test_dp_matches_oracle(production_model):
    hmm, seqs = production_model
    mesh = make_mesh(data=8)
    dev = DeviceHMM.from_hmm(hmm)
    got = decode_batch_dp(dev, seqs, mesh)
    for g, s in zip(got, seqs):
        want = viterbi_scores_oracle(hmm, s)
        assert almost_equal_vec(g, want), s[:8]


def test_tp_matches_oracle(production_model):
    hmm, seqs = production_model
    mesh = make_mesh(state=8)
    dev = DeviceHMM.from_hmm(hmm)
    for s in seqs:
        got = decode_tp(dev, s, mesh)
        want = viterbi_scores_oracle(hmm, s)
        assert almost_equal_vec(got, want)


def test_dp_tp_matches_oracle(production_model):
    hmm, seqs = production_model
    mesh = make_mesh(data=4, state=2)
    dev = DeviceHMM.from_hmm(hmm)
    got = decode_batch_dp_tp(dev, seqs, mesh)
    for g, s in zip(got, seqs):
        want = viterbi_scores_oracle(hmm, s)
        assert almost_equal_vec(g, want)


@pytest.mark.parametrize("t_axis", [2, 4, 8])
def test_time_parallel_matches_oracle(production_model, t_axis):
    hmm, seqs = production_model
    mesh = make_mesh(time=t_axis)
    for s in seqs:
        got = decode_time_parallel(hmm, s, mesh)
        want = viterbi_scores_oracle(hmm, s)
        assert almost_equal_vec(got, want)


def test_time_parallel_fixture_unreachable_states(small_model):
    """+inf (unreachable state) propagation survives block composition."""
    hmm, seqs = small_model
    mesh = make_mesh(time=4)
    for s in seqs:
        got = decode_time_parallel(hmm, s, mesh)
        want = viterbi_scores_oracle(hmm, s)
        assert almost_equal_vec(got, want)


def test_empty_sequence_rejected(production_model):
    hmm, _ = production_model
    from spec_viterbi.models.decoder import ViterbiDecoder

    dec = ViterbiDecoder(hmm, mode="structured")
    with pytest.raises(ValueError, match="empty sequence"):
        dec.decode_batch([np.zeros(0, dtype=np.int32)])


def test_dp_handles_ragged_lengths(production_model):
    hmm, _ = production_model
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, hmm.emit_num, size=n).astype(np.int32) for n in (5, 80, 41, 3)]
    mesh = make_mesh(data=8)
    dev = DeviceHMM.from_hmm(hmm)
    got = decode_batch_dp(dev, seqs, mesh)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))


def _fused_for(hmm):
    from spec_viterbi.ops.fused_pallas import FusedStructuredDecoder
    from spec_viterbi.ops.structured import StructuredOperator

    sop = StructuredOperator.from_hmm(hmm)
    return FusedStructuredDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        interpret=True,
    )


@pytest.mark.parametrize("d", [2, 4])
def test_fused_dp_scores_match_oracle(production_model, d):
    """The kernel DP-sharded over the data axis (shard_map wrapper,
    interpret-mode kernels on the CPU mesh)."""
    from spec_viterbi.parallel import decode_batch_dp_fused

    hmm, _ = production_model
    fd = _fused_for(hmm)
    mesh = make_mesh(data=d)
    rng = np.random.default_rng(29)
    seqs = [rng.integers(0, hmm.emit_num, size=n).astype(np.int32) for n in (4, 33, 17)]
    got = decode_batch_dp_fused(fd, seqs, mesh)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s)), len(s)
    # uniform lengths: per-lane work only, so sharding cannot change a bit
    useqs = [rng.integers(0, hmm.emit_num, size=21).astype(np.int32) for _ in range(3)]
    got = decode_batch_dp_fused(fd, useqs, mesh)
    for g, w, s in zip(got, fd.decode_batch(useqs), useqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))
        np.testing.assert_array_equal(g, w)


def test_fused_dp_output_shards_cover_the_mesh(production_model):
    """Each device holds its own lane block of the DP output — the work
    is spread, not gathered onto the first device."""
    from spec_viterbi.parallel.sharded import _fused_dp_stage, make_fused_dp

    hmm, _ = production_model
    fd = _fused_for(hmm)
    mesh = make_mesh(data=4)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, hmm.emit_num, size=12).astype(np.int32) for _ in range(8)]
    seqs_t, lengths = _fused_dp_stage(fd, seqs, mesh)
    scores_fn, _ = make_fused_dp(fd, mesh)
    out = scores_fn(seqs_t, lengths)
    devices = {shard.device for shard in out.addressable_shards}
    assert devices == set(mesh.devices.flat)
    assert all(shard.data.shape[1] == out.shape[1] // 4 for shard in out.addressable_shards)


def test_fused_dp_paths_match_oracle(production_model):
    from spec_viterbi.models.oracle import viterbi_path_oracle
    from spec_viterbi.parallel import decode_path_batch_dp_fused

    hmm, _ = production_model
    fd = _fused_for(hmm)
    mesh = make_mesh(data=2)
    rng = np.random.default_rng(31)
    seqs = [rng.integers(0, hmm.emit_num, size=n).astype(np.int32) for n in (9, 26)]
    got = decode_path_batch_dp_fused(fd, seqs, mesh)
    for (scores, path), s in zip(got, seqs):
        oscores, opath = viterbi_path_oracle(hmm, s)
        assert almost_equal_vec(scores, oscores), len(s)
        assert np.array_equal(path, opath), len(s)
