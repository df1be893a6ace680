"""Operator-cache persistence and profiling utilities."""

import os

import numpy as np

from conftest import TEST_CHMMS, TEST_SEQS

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_emit_seq, read_hmm
from spec_viterbi.models.specializer import SpecializedViterbi
from spec_viterbi.models.oracle import viterbi_scores_oracle
from spec_viterbi.utils import OperatorCache, StepTimer


def test_operator_cache_roundtrip(tmp_path):
    cache = OperatorCache(str(tmp_path))
    hmm = read_hmm(os.path.join(TEST_CHMMS, "1_test_chmm.chmm"))
    seq = read_emit_seq(os.path.join(TEST_SEQS, "1_test_seq.ess"))[0]

    spec = SpecializedViterbi(level=2, cache=cache)
    spec.spec_with(hmm)
    want = spec.run_spec(seq)
    files = os.listdir(tmp_path)
    # v2 format: one directory of .npy files per cache entry (mmap loads)
    assert len(files) == 1 and os.path.isdir(os.path.join(tmp_path, files[0]))
    entry = os.path.join(tmp_path, files[0])
    assert all(f.endswith(".npy") for f in os.listdir(entry))

    # second specialization loads from disk and produces identical results
    spec2 = SpecializedViterbi(level=2, cache=cache)
    spec2.spec_with(hmm)
    got = spec2.run_spec(seq)
    np.testing.assert_array_equal(got, want)
    assert almost_equal_vec(got, viterbi_scores_oracle(hmm, seq))


def test_operator_cache_key_discriminates(tmp_path):
    cache = OperatorCache(str(tmp_path))
    h1 = read_hmm(os.path.join(TEST_CHMMS, "1_test_chmm.chmm"))
    h2 = read_hmm(os.path.join(TEST_CHMMS, "2_test_chmm.chmm"))
    for level in (2, 3):
        for h in (h1, h2):
            s = SpecializedViterbi(level=level, cache=cache)
            s.spec_with(h)
    assert len(os.listdir(tmp_path)) == 4  # 2 models × 2 levels


def test_level1_structured_delegation_skips_cache(tmp_path):
    """A structured-eligible HMM at level 1 decodes via the structured
    path and builds no dense operator cache (nothing to persist)."""
    cache = OperatorCache(str(tmp_path))
    hmm = read_hmm(os.path.join(TEST_CHMMS, "1_test_chmm.chmm"))
    seq = read_emit_seq(os.path.join(TEST_SEQS, "1_test_seq.ess"))[0]
    spec = SpecializedViterbi(level=1, cache=cache)
    spec.spec_with(hmm)
    assert spec._delegate is not None
    assert os.listdir(tmp_path) == []
    assert almost_equal_vec(spec.run_spec(seq), viterbi_scores_oracle(hmm, seq))


def test_operator_cache_corrupt_entry_rebuilds(tmp_path):
    cache = OperatorCache(str(tmp_path))
    hmm = read_hmm(os.path.join(TEST_CHMMS, "1_test_chmm.chmm"))
    seq = read_emit_seq(os.path.join(TEST_SEQS, "1_test_seq.ess"))[0]
    spec = SpecializedViterbi(level=2, cache=cache)
    spec.spec_with(hmm)
    entry = os.path.join(str(tmp_path), os.listdir(tmp_path)[0])
    victim = os.path.join(entry, sorted(os.listdir(entry))[0])
    with open(victim, "wb") as f:
        f.write(b"garbage")
    spec2 = SpecializedViterbi(level=2, cache=cache)
    spec2.spec_with(hmm)  # silently rebuilds
    assert almost_equal_vec(spec2.run_spec(seq), viterbi_scores_oracle(hmm, seq))


def test_identity_padding_symbol_is_noop():
    """Appending the identity symbol (index E) must not change scores —
    the ragged-batch padding contract of the chunked spec decode."""
    import jax.numpy as jnp

    hmm = read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm"))
    seq = read_emit_seq(os.path.join(TEST_SEQS, "3_test_seq.ess"))[0]
    for level in (2, 3):
        spec = SpecializedViterbi(level=level)
        spec.spec_with(hmm)
        want = spec.run_spec(seq)
        for pad in (1, 2, 5):
            padded = np.concatenate(
                [seq, np.full(pad, hmm.emit_num, dtype=np.int32)]
            )
            got = np.asarray(spec._decode(jnp.asarray(padded)))[: hmm.states_num]
            np.testing.assert_array_equal(got, want), (level, pad)


def test_step_timer_summary():
    t = StepTimer()
    for _ in range(5):
        with t.step():
            pass
    s = t.summary()
    assert s["count"] == 5
    assert s["median_ms"] >= 0
    assert StepTimer().summary() == {"count": 0}


def test_operator_cache_migration_and_tmp_sweep(tmp_path):
    """The FIRST STORE (not construction — read-only consumers must never
    race concurrent processes out of their entries) reclaims
    unreachable old-format entries and stale tmp dirs, keeps
    current-format entries, fresh tmp dirs and non-entry names, and
    namespaces dense/struct kinds so their schemas can never collide."""
    import os
    import time

    import numpy as np

    d = str(tmp_path)
    old_entry = os.path.join(d, "ops_v2_deadbeef_L3_N2432")
    os.makedirs(old_entry)  # old layout
    unrelated = os.path.join(d, "ops_v2_backup")  # NOT an entry pattern
    os.makedirs(unrelated)
    stale_tmp = os.path.join(d, "xyz.tmp")
    os.makedirs(stale_tmp)
    os.utime(stale_tmp, (time.time() - 7200, time.time() - 7200))
    fresh_tmp = os.path.join(d, "abc.tmp")
    os.makedirs(fresh_tmp)

    cache = OperatorCache(d)
    cache.load("fp", 2, 64, kind="dense")
    assert os.path.exists(old_entry)  # reads/construction never sweep

    cache.store("fp", 2, 64, {"a": np.arange(3)}, kind="dense")
    assert not os.path.exists(old_entry)
    assert not os.path.exists(stale_tmp)  # older than the sweep horizon
    assert os.path.exists(fresh_tmp)  # live concurrent writer untouched
    assert os.path.exists(unrelated)  # full-pattern match only

    cache.store("fp", 2, 64, {"b": np.arange(4)}, kind="struct")
    dense = cache.load("fp", 2, 64, kind="dense")
    struct = cache.load("fp", 2, 64, kind="struct")
    assert set(dense) == {"a"} and set(struct) == {"b"}
    # a second writer must not touch current-format entries
    OperatorCache(d).store("fp2", 1, 8, {"c": np.arange(2)})
    assert cache.load("fp", 2, 64, kind="dense") is not None
