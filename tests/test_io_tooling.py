"""Data tooling: FASTA conversion vs the reference's own outputs,
generator round-trips, chmm/ess writers."""

import os

import numpy as np

from conftest import ESS_DIR

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_emit_seq, read_hmm, write_chmm, write_ess
from spec_viterbi.io.fasta import fasta_to_ess, fasta_to_sequences
from spec_viterbi.io.generators import (
    generate_random_hmm,
    generate_random_sequences,
)
from spec_viterbi.models.oracle import viterbi_scores_oracle
from spec_viterbi.models.decoder import ViterbiDecoder


def test_fasta_matches_reference_covid_ess():
    """Converting covid-19.fasta must reproduce the committed covid-19.ess
    (the reference's own converter output, fasta_to_ess.py)."""
    got = fasta_to_sequences(os.path.join(ESS_DIR, "covid-19.fasta"))
    want = read_emit_seq(os.path.join(ESS_DIR, "covid-19.ess"))
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fasta_to_ess_roundtrip(tmp_path):
    out = tmp_path / "covid.ess"
    fasta_to_ess(os.path.join(ESS_DIR, "covid-19.fasta"), str(out))
    got = read_emit_seq(str(out))
    want = read_emit_seq(os.path.join(ESS_DIR, "covid-19.ess"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_generated_hmm_roundtrips_through_chmm(tmp_path):
    hmm = generate_random_hmm(32, trans_per_state=3, emit_range=6, seed=5)
    path = tmp_path / "gen.chmm"
    write_chmm(hmm, str(path))
    back = read_hmm(str(path))
    assert back.states_num == hmm.states_num
    assert back.emit_num == hmm.emit_num
    np.testing.assert_allclose(back.emissions, hmm.emissions, rtol=1e-5)
    np.testing.assert_allclose(back.trans_probs, hmm.trans_probs, rtol=1e-5)
    # decode equivalence after the round trip
    seq = generate_random_sequences(1, 25, emit_range=6, seed=1)[0]
    assert almost_equal_vec(
        viterbi_scores_oracle(back, seq), viterbi_scores_oracle(hmm, seq)
    )


def test_generated_sequences_roundtrip_through_ess(tmp_path):
    seqs = generate_random_sequences(4, 11, emit_range=20, seed=3)
    path = tmp_path / "gen.ess"
    write_ess(seqs, str(path))
    back = read_emit_seq(str(path))
    for g, w in zip(back, seqs):
        np.testing.assert_array_equal(g, w)


def test_generated_hmm_decodes_on_all_paths():
    hmm = generate_random_hmm(40, trans_per_state=4, emit_range=8, seed=9)
    seq = generate_random_sequences(1, 30, emit_range=8, seed=2)[0]
    want = viterbi_scores_oracle(hmm, seq)
    for mode in ("dense", "structured"):
        assert almost_equal_vec(ViterbiDecoder(hmm, mode=mode).decode(seq), want)
