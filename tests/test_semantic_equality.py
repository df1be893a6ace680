"""Cross-implementation semantic equality — parity with
``tests/test_semantic_equality.cpp:19-98``.

The reference's correctness oracle: every backend agrees with every other,
spec agrees with non-spec, on production models × the ``emit_3_3500_20``
dataset. Here the "backends" are the framework's execution paths:

  non-spec:  dense XLA, structured XLA, NumPy oracle, the whole-sequence
             kernel (Pallas interpreter), streaming on both engines,
             time-parallel
  spec:      levels 1 and 2 (GraphBLAS runs L1+L2, GPU backends L1 —
             ``test_semantic_equality.cpp:45-56``)

The models are the seeded corpus's profile models; sequences are
truncated to keep the CPU run (and the interpreted kernel) bounded.
"""

import itertools
import os

import numpy as np
import pytest

from conftest import CHMM_DIR, ESS_DIR

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_emit_seq, read_hmm
from spec_viterbi.io.corpus import PROFILE_LENGTHS
from spec_viterbi.models.decoder import ViterbiDecoder
from spec_viterbi.models.oracle import viterbi_scores_oracle
from spec_viterbi.models.spec_structured import StructuredSpecializedViterbi
from spec_viterbi.models.specializer import SpecializedViterbi

MODELS = [f"{length}.chmm" for length in PROFILE_LENGTHS]
SEQ_TRUNC = 160


_STREAM_DECODERS: dict[str, object] = {}


def _stream_decode(hmm, seq, width: int = 37):
    """Decode one sequence through stream_begin/feed/scores (1 lane)."""
    from spec_viterbi.ops.fused_pallas import (
        FusedStructuredDecoder,
        fused_eligible,
    )
    from spec_viterbi.ops.structured import StructuredOperator

    fd = _STREAM_DECODERS.get(hmm.fingerprint())
    if fd is None:
        sop = StructuredOperator.from_hmm(hmm)
        assert fused_eligible(sop)  # holds for the whole production corpus
        fd = FusedStructuredDecoder(
            sop,
            hmm.emission_matrix(pad_to=sop.n),
            hmm.start_vector(pad_to=sop.n),
            interpret=True,
        )
        _STREAM_DECODERS.clear()  # one cached decoder is enough
        _STREAM_DECODERS[hmm.fingerprint()] = fd
    state = fd.stream_begin(seq[:1])
    block = np.asarray(seq, np.int32)[:, None]  # [T, 1 lane]
    for pos in range(1, len(seq), width):
        state = fd.stream_feed(state, block[pos : pos + width])
    return fd.stream_scores(state)[0]


def _stream_path_decode(hmm, seq, width: int = 53):
    """Scores via the exact-path streaming finalize (1 lane); the path
    itself is oracle-checked in test_streaming/test_property_random — the
    matrix compares score vectors."""
    fd = _STREAM_DECODERS[hmm.fingerprint()]  # built by _stream_decode
    block = np.asarray(seq, np.int32)[:, None]
    state = fd.stream_begin_path(block[0])
    for pos in range(1, len(seq), width):
        state = fd.stream_feed_path(state, block[pos : pos + width])
    scores, _ = fd.stream_path_finalize(state)
    return scores[0]


_AUX_DECODERS: dict[tuple, object] = {}


def _xla_stream_decode(hmm, seq, width: int = 41):
    """Scores via the universal XLA streaming fallback engine (1 lane)."""
    from spec_viterbi.models.streaming_xla import XLAStreamDecoder
    from spec_viterbi.ops.structured import StructuredOperator

    key = ("xla_stream", hmm.fingerprint())
    eng = _AUX_DECODERS.get(key)
    if eng is None:
        sop = StructuredOperator.from_hmm(hmm)
        eng = XLAStreamDecoder(
            sop,
            hmm.emission_matrix(pad_to=sop.n),
            hmm.start_vector(pad_to=sop.n),
        )
        # evict other models' decoders only (one model resident at a time)
        for kk in list(_AUX_DECODERS):
            if kk[1] != hmm.fingerprint():
                del _AUX_DECODERS[kk]
        _AUX_DECODERS[key] = eng
    block = np.asarray(seq, np.int32)[:, None]
    st = eng.stream_begin(block[0])
    for pos in range(1, len(seq), width):
        st = eng.stream_feed(st, block[pos : pos + width])
    return eng.stream_scores(st)[0]


def _kernel_decoder(hmm):
    key = ("kernel", hmm.fingerprint())
    dec = _AUX_DECODERS.get(key)
    if dec is None:
        dec = ViterbiDecoder(hmm, interpret=True)
        assert dec._fused is not None
        _AUX_DECODERS[key] = dec
    return dec


def _time_parallel_decode(hmm, seq, k: int = 8):
    from spec_viterbi.ops.structured import StructuredOperator
    from spec_viterbi.ops.time_parallel import TimeParallelDecoder

    key = ("time_parallel", hmm.fingerprint(), k)
    tp = _AUX_DECODERS.get(key)
    if tp is None:
        sop = StructuredOperator.from_hmm(hmm)
        tp = TimeParallelDecoder(
            sop,
            hmm.emission_matrix(pad_to=sop.n),
            hmm.start_vector(pad_to=sop.n),
            k=k,
        )
        _AUX_DECODERS[key] = tp
    return tp.decode(seq)


@pytest.fixture(scope="module")
def sequences():
    seqs = read_emit_seq(os.path.join(ESS_DIR, "emit_3_3500_20.ess"))
    if SEQ_TRUNC:
        seqs = [s[:SEQ_TRUNC] for s in seqs]
    return seqs


@pytest.mark.parametrize("model", MODELS)
def test_all_paths_agree(model, sequences):
    hmm = read_hmm(os.path.join(CHMM_DIR, model))

    non_spec = {
        "dense": ViterbiDecoder(hmm, mode="dense"),
        "structured": ViterbiDecoder(hmm, mode="structured"),
    }
    spec_impls = {}
    for level in (1, 2):
        if (
            SpecializedViterbi.spec_memory_bytes(hmm.states_num, hmm.emit_num, level)
            <= 2 << 30
        ):  # reference memory policy (test_semantic_equality.cpp:45-46)
            s = SpecializedViterbi(level=level)
            s.spec_with(hmm)
            spec_impls[f"spec_L{level}"] = s
        # the structured specializer has no dense memory wall
        ss = StructuredSpecializedViterbi(level=level)
        ss.spec_with(hmm)
        spec_impls[f"spec_struct_L{level}"] = ss

    for seq in sequences:
        results = {name: d.decode(seq) for name, d in non_spec.items()}
        results["oracle"] = viterbi_scores_oracle(hmm, seq)
        results.update(
            {name: s.run_spec(seq) for name, s in spec_impls.items()}
        )
        # batched paths too (the DP upgrades must agree)
        results["dense_batched"] = non_spec["dense"].decode_batch([seq])[0]
        results["spec_struct_L2_batched"] = spec_impls[
            "spec_struct_L2"
        ].run_spec_batch([seq])[0]
        # the kernel (interpreted), streaming on both engines (uneven
        # chunk widths exercise the quantized masked feed), and the
        # time-parallel single-sequence path
        results["kernel_batched"] = _kernel_decoder(hmm).decode_batch([seq])[0]
        results["streaming"] = _stream_decode(hmm, seq)
        results["streaming_path"] = _stream_path_decode(hmm, seq)
        results["streaming_xla"] = _xla_stream_decode(hmm, seq)
        results["time_parallel"] = _time_parallel_decode(hmm, seq)
        # the kernel and the XLA scan perform the same float32 adds
        np.testing.assert_array_equal(
            results["kernel_batched"], results["structured"]
        )

        for (na, va), (nb, vb) in itertools.combinations(results.items(), 2):
            assert almost_equal_vec(va, vb), (model, na, nb, len(seq))


def test_ragged_stream_nonfused_model_in_matrix():
    """Equality case for universal streaming: a
    NON-fused-eligible model streamed with per-lane ragged valid counts —
    every lane shares one XLA-fallback stream, finishes at its own
    length, and must agree with the serial decoders and the oracle."""
    from spec_viterbi.io.generators import generate_random_hmm
    from spec_viterbi.models.streaming_xla import XLAStreamDecoder
    from spec_viterbi.ops.fused_pallas import fused_eligible
    from spec_viterbi.ops.structured import StructuredOperator

    hmm = generate_random_hmm(
        states_num=48, trans_per_state=24, emit_range=6, seed=9
    )
    sop = StructuredOperator.from_hmm(hmm)
    assert not fused_eligible(sop)  # the case the fallback engine exists for
    eng = XLAStreamDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
    )
    rng = np.random.default_rng(5)
    lens = [53, 21, 64, 2]
    seqs = [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens]
    t_max = max(lens)
    block = np.zeros((t_max, len(seqs)), np.int32)
    for i, s in enumerate(seqs):
        block[: len(s), i] = s
    st = eng.stream_begin(block[0])
    width = 19  # uneven: exercises quantized masked feeds mid-lane-end
    for pos in range(1, t_max, width):
        w = min(width, t_max - pos)
        valid = np.clip([t - pos for t in lens], 0, w)
        st = eng.stream_feed(st, block[pos : pos + w], valid=valid)
    got = eng.stream_scores(st)

    dense = ViterbiDecoder(hmm, mode="dense")
    structured = ViterbiDecoder(hmm, mode="structured", use_pallas=False)
    for i, s in enumerate(seqs):
        results = {
            "ragged_stream_xla": got[i],
            "dense": dense.decode(s),
            "structured": structured.decode(s),
            "oracle": viterbi_scores_oracle(hmm, s),
        }
        for (na, va), (nb, vb) in itertools.combinations(results.items(), 2):
            assert almost_equal_vec(va, vb), (na, nb, i)
