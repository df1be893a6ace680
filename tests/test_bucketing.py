"""Length-bucketed ragged-batch planning and its fused-decode wiring.

The planner is a pure host-side scheduler (no reference analog — the
reference decodes sequences serially, `bench_Viterbi.h:53-56`); the fused
kernel is exercised in interpreter mode on CPU. Bucketed results must be
bitwise equal to the whole-batch call: both run the same kernel, only the
padded step counts differ, and padded steps never touch live lanes.
"""

import os

import numpy as np

from conftest import CHMM_DIR, TEST_CHMMS

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_hmm
from spec_viterbi.models.oracle import (
    viterbi_path_oracle,
    viterbi_scores_oracle,
)
from spec_viterbi.ops.fused_pallas import FusedStructuredDecoder
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.utils.batching import bucket_plan, quantize_t


def _fused_for(hmm):
    sop = StructuredOperator.from_hmm(hmm)
    return FusedStructuredDecoder(
        sop,
        hmm.emission_matrix(pad_to=sop.n),
        hmm.start_vector(pad_to=sop.n),
        interpret=True,
    )


def test_quantize_t_grid():
    assert quantize_t(1) == 64
    assert quantize_t(64) == 64
    assert quantize_t(65) == 96
    assert quantize_t(96) == 96
    assert quantize_t(97) == 128
    assert quantize_t(3500) == 4096
    assert quantize_t(7096) == 8192
    for t in (1, 63, 64, 100, 500, 5000, 100_000):
        q = quantize_t(t)
        assert q >= t and q <= max(64, int(np.ceil(t * 1.5)))


def test_bucket_plan_none_for_small_or_uniform():
    # single lane block: nothing to split
    assert bucket_plan([100] * 128) is None
    # uniform multi-block: no step savings
    assert bucket_plan([3500] * 512) is None
    # mild raggedness under the gain threshold
    assert bucket_plan([3400] * 256 + [3500] * 256) is None


def test_bucket_plan_partitions_and_orders():
    lengths = [40] * 200 + [7000] * 56
    plan = bucket_plan(lengths)
    assert plan is not None
    covered = sorted(i for idx, _ in plan for i in idx)
    assert covered == list(range(len(lengths)))  # exact partition
    # longest-first and every index's length fits its bucket
    assert [t for _, t in plan] == sorted([t for _, t in plan], reverse=True)
    for idx, t in plan:
        assert max(lengths[i] for i in idx) <= t
    # the long sequences pay ~8192 steps, the short ones only 64
    assert plan[0][1] == 8192 and plan[-1][1] == 64


def test_bucket_plan_merges_equal_buckets():
    # 384 same-length lanes quantize identically -> merged into one call
    lengths = [500] * 384 + [60] * 384
    plan = bucket_plan(lengths)
    assert plan is not None
    assert len(plan) == 2
    assert sorted(len(idx) for idx, _ in plan) == [384, 384]


def test_bucketed_decode_matches_whole_batch():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(7)
    lens = np.concatenate(
        [rng.integers(2, 30, 150), rng.integers(150, 300, 30)]
    )
    seqs = [
        rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens
    ]
    assert bucket_plan([len(s) for s in seqs]) is not None  # plan active
    got = fd.decode_batch(seqs)
    want = fd.decode_batch(seqs, bucketed=False)
    for g, w, s in zip(got, want, seqs):
        assert np.array_equal(
            np.nan_to_num(g, posinf=-1), np.nan_to_num(w, posinf=-1)
        ), len(s)
    # spot-check vs the oracle too (bucketed path is a real decode)
    for i in (0, 75, 160, 179):
        assert almost_equal_vec(got[i], viterbi_scores_oracle(hmm, seqs[i]))


def test_path_budget_quantization_fallback():
    """When the QUANTIZED bucket length crosses the backpointer budget but
    the real max length fits, the bucket must run at the real length
    instead of raising (regression: the first bucketed implementation
    checked only t_q)."""
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(5)
    lens = list(rng.integers(2, 10, 300)) + list(rng.integers(270, 281, 20))
    seqs = [
        rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens
    ]
    assert bucket_plan(lens) is not None
    t_max, n = max(lens), fd.n
    # budget admits the real max length for one lane but not
    # quantize(280)
    fd.MAX_PATH_BYTES = (t_max - 1) * n * 2 + 1
    assert fd.path_supported(t_max) and not fd.path_supported(
        quantize_t(t_max)
    )
    got = fd.decode_path_batch(seqs)
    for i in (0, 150, 299, 305, 319):
        osc, op = viterbi_path_oracle(hmm, seqs[i])
        assert almost_equal_vec(got[i][0], osc)
        assert np.array_equal(got[i][1], op)


def test_decoder_path_batch_delegates_and_chunks():
    """ViterbiDecoder.decode_path_batch must reach the kernel whenever
    ONE lane fits the budget, relying on lane chunking for the rest
    (regression: a gate that required the WHOLE batch to fit silently fell
    back to per-sequence decode)."""
    from spec_viterbi.models.decoder import ViterbiDecoder

    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    dec = ViterbiDecoder(hmm, mode="structured", use_pallas=False)
    fd = _fused_for(hmm)
    dec._fused = fd  # CPU tests: inject the interpret-mode kernel
    rng = np.random.default_rng(6)
    t, b, n = 100, 256, fd.n
    # one 128-lane call fits, the whole 256-lane batch does not
    fd.MAX_PATH_BYTES = (t - 1) * n * 128 * 2
    assert fd.path_supported(t) and not fd.path_supported(t, b)
    seqs = [
        rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        for _ in range(b)
    ]
    got = dec.decode_path_batch(seqs)
    for i in (0, 127, 128, 255):
        osc, op = viterbi_path_oracle(hmm, seqs[i])
        assert almost_equal_vec(got[i][0], osc)
        assert np.array_equal(got[i][1], op)


def test_bucketed_path_decode_matches_oracle():
    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    fd = _fused_for(hmm)
    rng = np.random.default_rng(11)
    lens = np.concatenate([rng.integers(2, 20, 140), rng.integers(150, 250, 20)])
    seqs = [
        rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lens
    ]
    assert bucket_plan([len(s) for s in seqs]) is not None
    got = fd.decode_path_batch(seqs)
    for (sc, p), s in zip(got, seqs):
        osc, op = viterbi_path_oracle(hmm, s)
        assert almost_equal_vec(sc, osc)
        assert np.array_equal(p, op)


def test_bucketed_decode_non_fused_modes():
    """Dense and structured-XLA batched decodes bucket
    ragged batches too (lane block = the f32 sublane tile, 8) instead of
    padding every lane to the global max. Results must match the
    unbucketed whole-batch call and the oracle."""
    from spec_viterbi.io.generators import generate_random_hmm
    from spec_viterbi.models.decoder import ViterbiDecoder
    from spec_viterbi.utils.batching import bucket_plan as bp

    # irregular random operator: NOT fused-eligible -> the decoder takes
    # an XLA mode on its own
    hmm = generate_random_hmm(
        states_num=24, trans_per_state=3, emit_range=4, seed=5
    )
    rng = np.random.default_rng(7)
    lens = list(rng.integers(2, 12, 26)) + [200, 210, 220, 230]
    seqs = [
        rng.integers(0, hmm.emit_num, size=int(t)).astype(np.int32)
        for t in lens
    ]
    assert bp([len(s) for s in seqs], lane_block=8) is not None

    for mode in ("dense", "structured"):
        dec = ViterbiDecoder(hmm, mode=mode, use_pallas=False)
        assert dec._fused is None
        got = dec.decode_batch(seqs)
        flat = dec.decode_batch(seqs, bucketed=False)
        for g, f, s in zip(got, flat, seqs):
            assert np.array_equal(
                np.nan_to_num(g, posinf=-1), np.nan_to_num(f, posinf=-1)
            ), (mode, len(s))
            assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s)), (
                mode,
                len(s),
            )
