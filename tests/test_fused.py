"""Whole-sequence kernel, run in the Pallas interpreter on the CPU.

The compiled kernel is exercised on the GPU by ``chip_smoke.py`` and the
``gpu``-marked tests; this suite checks the kernel's algebra (offset
reads, dense rows and columns, residual patches, +inf handling, masking
of finished lanes, the backpointer tie rule) against the XLA structured
scan and the NumPy oracle, hardware-free.
"""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR, TEST_CHMMS

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_hmm
from spec_viterbi.models.decoder import ViterbiDecoder
from spec_viterbi.models.oracle import viterbi_scores_oracle
from spec_viterbi.ops.fused_pallas import FusedStructuredDecoder, fused_eligible
from spec_viterbi.ops.structured import StructuredOperator


def _fused_for(hmm):
    sop = StructuredOperator.from_hmm(hmm)
    assert fused_eligible(sop)
    return FusedStructuredDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        interpret=True,
    )


def test_fused_matches_oracle_production_model():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (1, 2, 37, 60)]
    got = fd.decode_batch(seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s)), len(s)


def test_fused_fixture_with_unreachable_state():
    """Fixture 0 has an unreachable state: it must stay +inf
    (test_helper.h:18 expects {25.66, 24.49, inf})."""
    hmm = read_hmm(os.path.join(TEST_CHMMS, "0_test_chmm.chmm"))
    fd = _fused_for(hmm)
    seq = np.array([0, 1, 0], dtype=np.int32)
    got = fd.decode_batch([seq])[0]
    want = viterbi_scores_oracle(hmm, seq)
    assert np.isinf(want[2]) and np.isinf(got[2])
    assert almost_equal_vec(got, want)


def test_fused_residual_entries():
    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    sop = StructuredOperator.from_hmm(hmm)
    assert sop.residual_nnz > 0
    fd = _fused_for(hmm)
    rng = np.random.default_rng(4)
    for t in (2, 5, 9):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        got = fd.decode_batch([seq])[0]
        assert almost_equal_vec(got, viterbi_scores_oracle(hmm, seq)), t


def test_fused_path_kernel_matches_oracle():
    from spec_viterbi.models.oracle import viterbi_path_oracle

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (2, 31, 60)]
    got = fd.decode_path_batch(seqs)
    for (scores, path), s in zip(got, seqs):
        oscores, opath = viterbi_path_oracle(hmm, s)
        assert almost_equal_vec(scores, oscores), len(s)
        assert np.array_equal(path, opath), len(s)


def test_fused_path_kernel_ragged_and_residual():
    from spec_viterbi.models.oracle import viterbi_path_oracle

    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(7)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (9, 3, 6)]
    got = fd.decode_path_batch(seqs)
    for (scores, path), s in zip(got, seqs):
        oscores, opath = viterbi_path_oracle(hmm, s)
        assert almost_equal_vec(scores, oscores), len(s)
        assert np.array_equal(path, opath), len(s)



def _chain_hmm(rng, states, em_probs):
    """Profile-shaped HMM (chain + dense fan-out row) -> fused-eligible."""
    from spec_viterbi.hmm import HMM, to_modified_prob_np

    rows = [0] * states + list(range(1, states - 1))
    cols = list(range(states)) + list(range(2, states))
    probs = rng.uniform(0.1, 1.0, size=len(rows))
    return HMM(
        states_num=states,
        emit_num=em_probs.shape[0],
        trans_rows=np.asarray(rows, dtype=np.int64),
        trans_cols=np.asarray(cols, dtype=np.int64),
        trans_probs=to_modified_prob_np(probs),
        emissions=to_modified_prob_np(em_probs),
        start_probabilities_cols=np.array([0, 1], dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.array([0.5, 0.5])),
    )


def test_fused_path_parity_through_dead_symbol():
    """A symbol emitted by no state drives every carry to +inf; the
    kernel must still emit the oracle's pointers (all-inf rows backtrace
    to state 0)."""
    from spec_viterbi.hmm import HMM, to_modified_prob_np
    from spec_viterbi.models.oracle import viterbi_path_oracle

    rng = np.random.default_rng(2)
    states, emit = 40, 4
    em = rng.uniform(0.1, 1.0, size=(emit, states))
    em[3, :] = 0.0  # dead symbol
    hmm = _chain_hmm(rng, states, em)
    fd = _fused_for(hmm)
    seq = np.array([0, 1, 3, 2, 0, 1], dtype=np.int32)  # dies at step 2
    (scores, path), = fd.decode_path_batch([seq])
    oscores, opath = viterbi_path_oracle(hmm, seq)
    assert almost_equal_vec(scores, oscores)
    assert np.array_equal(path, opath), (path, opath)


def test_fused_large_alphabet():
    """Alphabets beyond 32 symbols: the emission gather indexes any row."""
    from spec_viterbi.models.oracle import viterbi_scores_oracle

    rng = np.random.default_rng(6)
    states, emit = 40, 40
    hmm = _chain_hmm(rng, states, rng.uniform(0.1, 1.0, size=(emit, states)))
    fd = _fused_for(hmm)
    seq = rng.integers(0, emit, size=17).astype(np.int32)
    got = fd.decode_batch([seq])[0]
    assert almost_equal_vec(got, viterbi_scores_oracle(hmm, seq))


def test_fused_negative_diag_offset():
    """A subdiagonal (i → i−1 chain) is an offset read past the top of the
    carry; out-of-range reads must contribute nothing."""
    from spec_viterbi.hmm import HMM, to_modified_prob_np

    rng = np.random.default_rng(11)
    states = 40
    # dense fan-out row 0 + descending chain i -> i-1 (offset -1 diagonal)
    rows = [0] * states + list(range(2, states))
    cols = list(range(states)) + list(range(1, states - 1))
    probs = rng.uniform(0.1, 1.0, size=len(rows))
    hmm = HMM(
        states_num=states,
        emit_num=4,
        trans_rows=np.asarray(rows, dtype=np.int64),
        trans_cols=np.asarray(cols, dtype=np.int64),
        trans_probs=to_modified_prob_np(probs),
        emissions=to_modified_prob_np(rng.uniform(0.1, 1.0, size=(4, states))),
        start_probabilities_cols=np.array([0, states - 1], dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.array([0.5, 0.5])),
    )
    sop = StructuredOperator.from_hmm(hmm)
    assert any(d < 0 for d in sop.diag_offsets), sop.diag_offsets
    fd = _fused_for(hmm)
    from spec_viterbi.models.oracle import viterbi_path_oracle

    for t in (2, 17, 33):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        got = fd.decode_batch([seq])[0]
        assert almost_equal_vec(got, viterbi_scores_oracle(hmm, seq)), t
        (scores, path), = fd.decode_path_batch([seq])
        oscores, opath = viterbi_path_oracle(hmm, seq)
        assert almost_equal_vec(scores, oscores), t
        assert np.array_equal(path, opath), t


def test_fused_rejects_out_of_range_symbols():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    bad = np.array([0, hmm.emit_num, 1], dtype=np.int32)
    with pytest.raises(ValueError, match="out of range"):
        fd.decode_batch([bad])
    with pytest.raises(ValueError, match="out of range"):
        fd.decode_path_batch([np.array([-1, 0], dtype=np.int32)])


def test_fused_uniform_length_one_batch():
    """A uniform batch of length-1 sequences must not run the min_t padding
    step unmasked (regression: masked=False skipped the freeze)."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    seqs = [np.array([2], dtype=np.int32), np.array([5], dtype=np.int32)]
    got = fd.decode_batch(seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))


def _xla_scores(hmm, seqs):
    return ViterbiDecoder(hmm, use_pallas=False).decode_batch(seqs, bucketed=False)


@pytest.mark.parametrize("b,t", [(1, 2), (3, 6), (5, 23), (9, 40), (16, 9)])
def test_kernel_scores_bit_equal_to_xla_scan(b, t):
    """Same float32 adds, exact mins: the kernel's scores are BIT-equal to
    the XLA structured scan, not just within the ±1.0 contract."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(b * 100 + t)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for _ in range(b)]
    got = fd.decode_batch(seqs, bucketed=False)
    for g, w in zip(got, _xla_scores(hmm, seqs)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lens", [(2, 31), (17, 17, 17), (40, 3, 25, 9)])
def test_kernel_paths_equal_to_xla_path_scan(lens):
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(sum(lens))
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens]
    got = fd.decode_path_batch(seqs)
    want = ViterbiDecoder(hmm, use_pallas=False).decode_path_batch(seqs)
    for (gs, gp), (ws, wp) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gp, wp)


def _kernel_at(hmm, sop, seqs, tile):
    """Scores [B, Np] and paths [B, T] from the kernel called directly at
    one state tile."""
    import jax.numpy as jnp

    from spec_viterbi.ops.fused_pallas import backtrace, kernel_arrays, structured_scan
    from spec_viterbi.utils.batching import pad_batch

    em, pi = hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)
    batch, lengths = pad_batch(seqs, 1, min_t=2)
    seqs_t, lengths = jnp.asarray(batch.T), jnp.asarray(lengths)
    v0 = jnp.asarray(em.T)[:, seqs_t[0]] + jnp.asarray(pi)[:, None]
    kw = dict(tile=tile, interpret=True)
    arrays = kernel_arrays(sop, em, tile)
    scores, _ = structured_scan(sop, arrays, v0, seqs_t[1:], lengths, **kw)
    _, bp = structured_scan(sop, arrays, v0, seqs_t[1:], lengths, path=True, **kw)
    last = jnp.argmin(scores, axis=0).astype(jnp.int32)
    rev = backtrace(bp, last, interpret=True)
    paths = jnp.concatenate([rev, last[None]], axis=0)
    return np.asarray(scores).T, np.asarray(paths).T


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_kernel_state_tiles_bit_identical(tile):
    """The state tile only changes how a program sweeps the state axis
    (one tile at 128, eight at 16, the dense-column mins carried across
    them); the scores and paths are the same bits at every tile."""
    from spec_viterbi.models.oracle import viterbi_path_oracle

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    sop = StructuredOperator.from_hmm(hmm)
    rng = np.random.default_rng(tile)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (12, 7, 12)]
    scores, paths = _kernel_at(hmm, sop, seqs, tile)
    for i, (w, s) in enumerate(zip(_xla_scores(hmm, seqs), seqs)):
        np.testing.assert_array_equal(scores[i, : hmm.states_num], w)
        assert np.array_equal(paths[i, : len(s)], viterbi_path_oracle(hmm, s)[1])


@pytest.mark.parametrize("offsets", [(1,), (-1, 1), (0, 2), (-3,)])
def test_kernel_banded_operators(offsets):
    """Purely banded operators (several and negative diagonals, the
    self-loop diagonal 0): scores bit-equal to the XLA scan, paths equal
    to the oracle."""
    from conftest import banded_hmm
    from spec_viterbi.models.oracle import viterbi_path_oracle

    hmm = banded_hmm(n=128, offsets=offsets, seed=sum(abs(d) for d in offsets))
    sop = StructuredOperator.from_hmm(hmm)
    assert not sop.row_idx and not sop.col_idx and sop.residual_nnz == 0
    fd = _fused_for(hmm)
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (9, 14)]
    for g, w in zip(fd.decode_batch(seqs, bucketed=False), _xla_scores(hmm, seqs)):
        np.testing.assert_array_equal(g, w)
    for (scores, path), s in zip(fd.decode_path_batch(seqs), seqs):
        assert np.array_equal(path, viterbi_path_oracle(hmm, s)[1])


def test_kernel_scan_composes_over_chunks():
    """The start carry is a resumable input: one call over T steps equals
    two calls over a split of them, bit for bit (what streaming relies on)."""
    import jax.numpy as jnp

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(9)
    obs = jnp.asarray(rng.integers(0, hmm.emit_num, size=(20, 4)).astype(np.int32))
    lengths = jnp.full((1, 4), 21, jnp.int32)
    v0 = fd._start(obs[0])
    whole, _ = fd.scan(v0, obs[1:], lengths)
    half, _ = fd.scan(v0, obs[1:8], lengths)
    rest, _ = fd.scan(half, obs[8:], lengths)
    np.testing.assert_array_equal(np.asarray(whole), np.asarray(rest))


def test_state_axis_pads_only_to_a_tile_multiple():
    from spec_viterbi.ops.fused_pallas import tile_layout

    assert tile_layout(2432, 256) == (256, 2560)  # not 4096
    assert tile_layout(2432, 128) == (128, 2432)
    assert tile_layout(128, 256) == (128, 128)  # small models: one tile
    assert tile_layout(102, 32) == (32, 128)
    assert tile_layout(3, 128) == (4, 4)
    assert tile_layout(1, 128) == (1, 1)


@pytest.mark.parametrize("tile", [8, 32, 64])
def test_kernel_padded_state_axis_bit_identical(tile):
    """An unpadded 102-state operator swept in tiles that do not divide
    it: the +inf padding states change no score and no path."""
    from spec_viterbi.models.oracle import viterbi_path_oracle

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    sop = StructuredOperator.from_hmm(hmm, pad_to=hmm.states_num)
    assert sop.n % tile
    rng = np.random.default_rng(tile)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (15, 8)]
    scores, paths = _kernel_at(hmm, sop, seqs, tile)
    xla = ViterbiDecoder(hmm, pad=False, use_pallas=False).decode_batch(seqs, bucketed=False)
    for i, (w, s) in enumerate(zip(xla, seqs)):
        np.testing.assert_array_equal(scores[i], w)
        assert np.array_equal(paths[i, : len(s)], viterbi_path_oracle(hmm, s)[1])


def test_capability_check_keeps_the_cpu_on_the_xla_scan():
    """Off a GPU the decoders never pick the kernel, nor interpret mode,
    unless a caller asks with ``interpret=True``."""
    from spec_viterbi.models.streaming_xla import XLAStreamDecoder
    from spec_viterbi.ops.fused_pallas import gpu_kernel_available

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    assert not gpu_kernel_available()
    dec = ViterbiDecoder(hmm)
    assert dec.mode == "structured" and dec._fused is None
    assert isinstance(dec.streaming(), XLAStreamDecoder)
    asked = ViterbiDecoder(hmm, interpret=True)
    assert asked._fused is not None and asked._fused.interpret
    assert asked.streaming() is asked._fused
    assert dec.streaming(interpret=True).interpret


def test_fused_multi_group_ragged_batch():
    """Many lanes with ragged lengths: every lane's mask freezes it at its
    own end."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(13)
    seqs = [
        rng.integers(0, hmm.emit_num, size=rng.integers(2, 23)).astype(np.int32)
        for _ in range(30)
    ]
    got = fd.decode_batch(seqs, bucketed=False)
    for g, w in zip(got, _xla_scores(hmm, seqs)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_scan_on_gpu(on_gpu):
    """The kernel as compiled for the card: scores bit-equal to the XLA
    scan and paths equal, at a corpus width."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "1200.chmm"))
    sop = StructuredOperator.from_hmm(hmm)
    fd = FusedStructuredDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)
    )
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, hmm.emit_num, size=300).astype(np.int32) for _ in range(64)]
    for g, w in zip(fd.decode_batch(seqs), _xla_scores(hmm, seqs)):
        np.testing.assert_array_equal(g, w)
    want = ViterbiDecoder(hmm, use_pallas=False).decode_path_batch(seqs[:8])
    for (gs, gp), (ws, wp) in zip(fd.decode_path_batch(seqs[:8]), want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gp, wp)


def test_fused_ragged_lengths_frozen_lanes():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(8)
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in (3, 50, 11, 29)]
    got = fd.decode_batch(seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s)), len(s)


def test_whole_batch_path_budget_refusal():
    """bucketed=False must refuse over-budget shapes BEFORE dispatch (the
    documented ValueError bench_ragged records as NaN), not device-OOM."""
    import os

    import pytest

    from conftest import CHMM_DIR
    from spec_viterbi.io import read_hmm
    from spec_viterbi.ops.structured import StructuredOperator

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    sop = StructuredOperator.from_hmm(hmm)
    fd = FusedStructuredDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        interpret=True,
    )
    seqs = [np.zeros(64, np.int32) for _ in range(4)]
    old = fd.MAX_PATH_BYTES
    try:
        fd.MAX_PATH_BYTES = 1024  # force the budget wall
        with pytest.raises(ValueError, match="budget"):
            fd.decode_path_batch(seqs, bucketed=False)
    finally:
        fd.MAX_PATH_BYTES = old
