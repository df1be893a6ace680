"""Streaming decode: chunked feeds must reproduce whole-sequence scores.

The carry is the kernel's v0 seed, so decode composes over chunks with
IDENTICAL float order to the one-shot batched call — equality is exact,
not ±1.0. No reference analog (`run_Viterbi` takes the full sequence,
`Viterbi_impl.h:8`).
"""

import os

import numpy as np
import pytest

from conftest import CHMM_DIR, TEST_CHMMS

from spec_viterbi.io import read_hmm
from spec_viterbi.models.oracle import viterbi_scores_oracle
from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.ops.fused_pallas import FusedStructuredDecoder
from spec_viterbi.ops.structured import StructuredOperator


def _fused_for(hmm):
    sop = StructuredOperator.from_hmm(hmm)
    return FusedStructuredDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        interpret=True,
    )


@pytest.mark.parametrize("splits", [[1], [40, 1, 19], [7, 13, 23, 17]])
def test_stream_matches_batch(splits):
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(13)
    t = 1 + sum(splits)
    b = 5  # non-multiple of 128: lane padding handled inside
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for _ in range(b)]
    block = np.stack(seqs, axis=1)  # [T, B]

    state = fd.stream_begin(block[0])
    pos = 1
    for w in splits:
        state = fd.stream_feed(state, block[pos : pos + w])
        pos += w
    got = fd.stream_scores(state)

    want = fd.decode_batch(seqs, bucketed=False)
    for g, w in zip(got, want):
        assert np.array_equal(
            np.nan_to_num(g, posinf=-1), np.nan_to_num(w, posinf=-1)
        )
    # and vs the oracle (fuzzy, reference semantics)
    assert almost_equal_vec(got[0], viterbi_scores_oracle(hmm, seqs[0]))


def test_stream_peek_and_continue():
    """stream_scores mid-stream must not perturb the carry."""
    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(14)
    block = rng.integers(0, hmm.emit_num, size=(30, 3)).astype(np.int32)
    state = fd.stream_begin(block[0])
    state = fd.stream_feed(state, block[1:11])
    mid = fd.stream_scores(state)
    seqs10 = [block[:11, i] for i in range(3)]
    for g, w in zip(mid, fd.decode_batch(seqs10, bucketed=False)):
        assert np.array_equal(np.nan_to_num(g, posinf=-1), np.nan_to_num(w, posinf=-1))
    state = fd.stream_feed(state, block[11:])
    final = fd.stream_scores(state)
    seqs = [block[:, i] for i in range(3)]
    for g, w in zip(final, fd.decode_batch(seqs, bucketed=False)):
        assert np.array_equal(np.nan_to_num(g, posinf=-1), np.nan_to_num(w, posinf=-1))


@pytest.mark.parametrize("splits", [[59], [7, 13, 23, 17]])
def test_stream_path_matches_one_shot_and_oracle(splits):
    """Checkpoint/rematerialize path streaming: exact paths, exact scores."""
    from spec_viterbi.models.oracle import viterbi_path_oracle

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(21)
    t = 1 + sum(splits)
    b = 3
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for _ in range(b)]
    block = np.stack(seqs, axis=1)

    state = fd.stream_begin_path(block[0])
    pos = 1
    for w in splits:
        state = fd.stream_feed_path(state, block[pos : pos + w])
        pos += w
    scores, paths = fd.stream_path_finalize(state)

    one_shot = fd.decode_path_batch(seqs)
    for i in range(b):
        os_scores, os_path = one_shot[i]
        assert np.array_equal(
            np.nan_to_num(scores[i, : hmm.states_num], posinf=-1),
            np.nan_to_num(os_scores[: hmm.states_num], posinf=-1),
        ), i
        assert np.array_equal(paths[i], os_path), i
        osc, opath = viterbi_path_oracle(hmm, seqs[i])
        assert np.array_equal(paths[i], opath), i

    # finalize does not consume the state — feeding continues
    more = rng.integers(0, hmm.emit_num, size=(5, b)).astype(np.int32)
    state = fd.stream_feed_path(state, more)
    scores2, paths2 = fd.stream_path_finalize(state)
    full = [np.concatenate([seqs[i], more[:, i]]) for i in range(b)]
    for i in range(b):
        _, opath = viterbi_path_oracle(hmm, full[i])
        assert np.array_equal(paths2[i], opath), i


def test_stream_path_single_symbol():
    """begin-only stream: path is just the argmin end state."""
    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    fd = _fused_for(hmm)
    from spec_viterbi.models.oracle import viterbi_path_oracle

    state = fd.stream_begin_path(np.array([0, 1], dtype=np.int32))
    scores, paths = fd.stream_path_finalize(state)
    assert paths.shape == (2, 1)
    for i, s in enumerate([np.array([0]), np.array([1])]):
        _, opath = viterbi_path_oracle(hmm, s.astype(np.int32))
        assert np.array_equal(paths[i], opath)


@pytest.mark.parametrize("d", [2, 4])
def test_stream_dp_scores_match_single_chip(d):
    """DP-sharded streaming is bit-identical to the single-chip stream."""
    from spec_viterbi.parallel import StreamDP, make_mesh

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    sdp = StreamDP(fd, make_mesh(data=d))
    rng = np.random.default_rng(41)
    t, b = 30, 3
    block = rng.integers(0, hmm.emit_num, size=(t, b)).astype(np.int32)

    st_dp = sdp.begin(block[0])
    st_1 = fd.stream_begin(block[0])
    for pos in (1, 9, 22):
        end = {1: 9, 9: 22, 22: t}[pos]
        st_dp = sdp.feed(st_dp, block[pos:end])
        st_1 = fd.stream_feed(st_1, block[pos:end])
    got = sdp.scores(st_dp)
    want = fd.stream_scores(st_1)
    assert np.array_equal(
        np.nan_to_num(got, posinf=-1), np.nan_to_num(want, posinf=-1)
    )


def test_stream_dp_paths_match_oracle():
    from spec_viterbi.models.oracle import viterbi_path_oracle
    from spec_viterbi.parallel import StreamDP, make_mesh

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    sdp = StreamDP(fd, make_mesh(data=2))
    rng = np.random.default_rng(43)
    t, b = 41, 2
    block = rng.integers(0, hmm.emit_num, size=(t, b)).astype(np.int32)
    st = sdp.begin_path(block[0])
    for pos, end in ((1, 18), (18, 41)):
        st = sdp.feed_path(st, block[pos:end])
    scores, paths = sdp.path_finalize(st)
    assert paths.shape == (b, t)
    for i in range(b):
        want, opath = viterbi_path_oracle(hmm, block[:, i])
        assert almost_equal_vec(scores[i, : hmm.states_num], want), i
        assert np.array_equal(paths[i], opath), i


def test_decoder_streaming_accessor():
    """ViterbiDecoder.streaming() exposes an engine on every backend."""
    from spec_viterbi.models.decoder import ViterbiDecoder

    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    dec = ViterbiDecoder(hmm, mode="structured")
    fd = dec.streaming()
    assert fd is dec.streaming()  # cached
    rng = np.random.default_rng(3)
    block = rng.integers(0, hmm.emit_num, size=(12, 2)).astype(np.int32)
    st = fd.stream_begin(block[0])
    st = fd.stream_feed(st, block[1:])
    got = fd.stream_scores(st)
    for i in range(2):
        assert almost_equal_vec(
            got[i, : hmm.states_num], viterbi_scores_oracle(hmm, block[:, i])
        )

    # streaming is universal: dense-mode decoders and use_pallas=False
    # pins get the XLA engine (never the kernel) and still produce
    # oracle-correct scores
    from spec_viterbi.models.streaming_xla import XLAStreamDecoder

    for dec2 in (
        ViterbiDecoder(hmm, mode="dense"),
        ViterbiDecoder(hmm, mode="structured", use_pallas=False),
    ):
        eng = dec2.streaming()
        assert isinstance(eng, XLAStreamDecoder)
        assert eng is dec2.streaming()  # cached
        st = eng.stream_begin(block[0])
        st = eng.stream_feed(st, block[1:])
        got2 = eng.stream_scores(st)
        for i in range(2):
            assert almost_equal_vec(
                got2[i, : hmm.states_num],
                viterbi_scores_oracle(hmm, block[:, i]),
            )


def test_xla_stream_engine_full_protocol(tmp_path):
    """The fallback engine honors the whole protocol on an operator the
    fused kernel REJECTS (heavy residual): scores, exact paths across
    chunk boundaries, peek, save/load, cross-engine load rejection."""
    from spec_viterbi.models.decoder import ViterbiDecoder
    from spec_viterbi.models.oracle import viterbi_path_oracle
    from spec_viterbi.models.streaming_xla import XLAStreamDecoder
    from spec_viterbi.io.generators import generate_random_hmm
    from spec_viterbi.ops.fused_pallas import fused_eligible

    # dense-ish random model: decomposition keeps a large residual
    hmm = generate_random_hmm(states_num=37, trans_per_state=9, emit_range=5,
                              num_non_zero_start_probs=6, seed=7)
    dec = ViterbiDecoder(hmm, mode="structured")
    eng = dec.streaming()
    assert isinstance(eng, XLAStreamDecoder)
    assert not fused_eligible(eng.sop)

    rng = np.random.default_rng(9)
    t, b = 41, 3
    block = rng.integers(0, hmm.emit_num, size=(t, b)).astype(np.int32)

    st = eng.stream_begin_path(block[0])
    st = eng.stream_feed_path(st, block[1:18])
    mid = eng.stream_path_scores(st)  # peek must not perturb
    st = eng.stream_feed_path(st, block[18:])
    p = str(tmp_path / "xla.npz")
    eng.stream_save(st, p)
    st = eng.stream_load(p)
    scores, paths = eng.stream_path_finalize(st)
    assert paths.shape == (b, t)
    for i in range(b):
        want, opath = viterbi_path_oracle(hmm, block[:, i])
        assert almost_equal_vec(scores[i, : hmm.states_num], want), i
        assert np.array_equal(paths[i], opath), i
        assert almost_equal_vec(
            mid[i, : hmm.states_num],
            viterbi_scores_oracle(hmm, block[:18, i]),
        ), i

    # a kernel-engine state must not load into the XLA engine (their lane
    # padding differs, so a cross-engine resume would misplace lanes)
    smooth = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    fd = _fused_for(smooth)
    stf = fd.stream_begin(np.array([0], dtype=np.int32))
    pf = str(tmp_path / "fused.npz")
    fd.stream_save(stf, pf)
    eng2 = ViterbiDecoder(smooth, use_pallas=False).streaming()
    with pytest.raises(ValueError, match="different model"):
        eng2.stream_load(pf)


@pytest.mark.parametrize("engine", ["kernel", "xla"])
def test_stream_load_refuses_an_older_carry_format(tmp_path, monkeypatch, engine):
    """States written under another carry encoding (STREAM_FORMAT) are
    refused, never resumed: the format tag is part of the model key."""
    from spec_viterbi.models.decoder import ViterbiDecoder
    from spec_viterbi.ops import stream_api

    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    monkeypatch.setattr(stream_api, "STREAM_FORMAT", "carry-v1")
    old = (
        _fused_for(hmm) if engine == "kernel"
        else ViterbiDecoder(hmm, use_pallas=False).streaming()
    )
    path = str(tmp_path / "old.npz")
    old.stream_save(old.stream_begin(np.array([0, 1], np.int32)), path)
    monkeypatch.undo()
    new = (
        _fused_for(hmm) if engine == "kernel"
        else ViterbiDecoder(hmm, use_pallas=False).streaming()
    )
    with pytest.raises(ValueError, match="different model"):
        new.stream_load(path)
    new.stream_save(new.stream_begin(np.array([0, 1], np.int32)), path)
    assert new.stream_load(path).b_real == 2


def test_stream_save_load_roundtrip(tmp_path):
    """A persisted stream resumes bit-identically (scores AND paths)."""
    from spec_viterbi.models.oracle import viterbi_path_oracle

    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(51)
    block = rng.integers(0, hmm.emit_num, size=(25, 2)).astype(np.int32)

    # scores stream: save mid-way, resume in a "new" state object
    st = fd.stream_begin(block[0])
    st = fd.stream_feed(st, block[1:11])
    p = str(tmp_path / "scores.npz")
    fd.stream_save(st, p)
    st2 = fd.stream_load(p)
    st = fd.stream_feed(st, block[11:])
    st2 = fd.stream_feed(st2, block[11:])
    assert np.array_equal(
        np.nan_to_num(fd.stream_scores(st), posinf=-1),
        np.nan_to_num(fd.stream_scores(st2), posinf=-1),
    )

    # path stream: checkpoints and chunks survive the roundtrip
    stp = fd.stream_begin_path(block[0])
    stp = fd.stream_feed_path(stp, block[1:11])
    pp = str(tmp_path / "paths.npz")
    fd.stream_save(stp, pp)
    stp2 = fd.stream_load(pp)
    stp2 = fd.stream_feed_path(stp2, block[11:])
    scores, paths = fd.stream_path_finalize(stp2)
    for i in range(2):
        _, opath = viterbi_path_oracle(hmm, block[:, i])
        assert np.array_equal(paths[i], opath), i

    # wrong-model guard
    other = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fo = _fused_for(other)
    with pytest.raises(ValueError, match="state"):
        fo.stream_load(p)


def test_stream_load_rejects_structurally_different_model(tmp_path):
    """Two models with IDENTICAL value bytes but different diagonal
    offsets must not cross-load (the fingerprint hashes structure too)."""
    from spec_viterbi.hmm import HMM, to_modified_prob_np

    def ring(step):
        n = 8
        rows = np.arange(n, dtype=np.int64)
        cols = (rows + step) % n
        return HMM(
            states_num=n,
            emit_num=2,
            trans_rows=rows,
            trans_cols=cols,
            trans_probs=to_modified_prob_np(np.full(n, 0.5)),
            emissions=to_modified_prob_np(np.full((2, n), 0.5)),
            start_probabilities_cols=np.array([0], dtype=np.int64),
            start_probabilities=to_modified_prob_np(np.array([1.0])),
        )

    fd1, fd2 = _fused_for(ring(1)), _fused_for(ring(2))
    assert fd1._model_key != fd2._model_key
    st = fd1.stream_begin(np.array([0], dtype=np.int32))
    p = str(tmp_path / "ring.npz")
    fd1.stream_save(st, p)
    with pytest.raises(ValueError, match="different model"):
        fd2.stream_load(p)


def test_stream_validation():
    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    fd = _fused_for(hmm)
    state = fd.stream_begin(np.array([0, 1], dtype=np.int32))
    with pytest.raises(ValueError):
        fd.stream_feed(state, np.zeros((4, 3), np.int32))  # wrong lane count
    with pytest.raises(ValueError):
        fd.stream_feed(state, np.full((2, 2), 99, np.int32))  # bad symbol
    with pytest.raises(ValueError):
        fd.stream_begin(np.array([], dtype=np.int32))


# ---- per-lane ragged streaming ------------------------------------------


def _engines(hmm):
    """Both stream engines for one model: fused Pallas (interpret) and
    the universal XLA fallback — the protocol-parity pair."""
    from spec_viterbi.models.streaming_xla import XLAStreamDecoder

    sop = StructuredOperator.from_hmm(hmm)
    em = hmm.emission_matrix(pad_to=sop.n)
    pi = hmm.start_vector(pad_to=sop.n)
    return {
        "fused": FusedStructuredDecoder(sop, em, pi, interpret=True),
        "xla": XLAStreamDecoder(sop, em, pi),
    }


def _ragged_feed(eng, seqs, width, paths=False):
    """Stream ragged lanes through fixed-width chunks with per-lane valid
    counts; returns (scores [B, Np], paths [B, T_pad] | None)."""
    lens = [len(s) for s in seqs]
    t_max = max(lens)
    block = np.zeros((t_max, len(seqs)), np.int32)  # 0-padded tails
    for i, s in enumerate(seqs):
        block[: len(s), i] = s
    begin = eng.stream_begin_path if paths else eng.stream_begin
    feed = eng.stream_feed_path if paths else eng.stream_feed
    state = begin(block[0])
    pos = 1
    while pos < t_max:
        w = min(width, t_max - pos)
        valid = np.clip([ln - pos for ln in lens], 0, w)
        state = feed(state, block[pos : pos + w], valid=valid)
        pos += w
    if paths:
        return eng.stream_path_finalize(state)
    return eng.stream_scores(state), None


@pytest.mark.parametrize("engine", ["fused", "xla"])
@pytest.mark.parametrize("width", [8, 16])
def test_ragged_lane_stream_scores(engine, width):
    """Per-lane valid counts: each lane's streamed scores must equal its
    own whole-sequence decode (finished lanes freeze mid-chunk)."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    eng = _engines(hmm)[engine]
    rng = np.random.default_rng(31 + width)
    lens = [31, 17, 44, 2, 1]
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens]
    got, _ = _ragged_feed(eng, seqs, width)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_ragged_lane_stream_paths(engine):
    """Ragged path streaming: sliced to each lane's true length, paths
    must match the oracle exactly (frozen steps are identity pointers)."""
    from spec_viterbi.models.oracle import viterbi_path_oracle

    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    eng = _engines(hmm)[engine]
    rng = np.random.default_rng(77)
    lens = [29, 12, 40]
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens]
    scores, paths = _ragged_feed(eng, seqs, 16, paths=True)
    for i, s in enumerate(seqs):
        osc, op = viterbi_path_oracle(hmm, s)
        assert almost_equal_vec(scores[i], osc[: scores.shape[1]])
        assert np.array_equal(paths[i, : len(s)], op), (engine, i)


def test_ragged_valid_validation():
    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    eng = _engines(hmm)["xla"]
    state = eng.stream_begin(np.zeros(3, np.int32))
    chunk = np.zeros((5, 3), np.int32)
    with pytest.raises(ValueError, match="valid"):
        eng.stream_feed(state, chunk, valid=np.array([1, 2], np.int32))
    with pytest.raises(ValueError, match="valid"):
        eng.stream_feed(state, chunk, valid=np.array([1, 6, 2], np.int32))
