"""End-to-end covid-19-shaped workload (CPU-sized).

The real covid-19 dataset (16 SARS-CoV-2 protein sequences, lens 38–7,096)
decoded against a production profile HMM with full backtrace, validated
against the NumPy oracle. The largest sequences run on the 102-state model
to keep the CPU oracle tractable; chip_smoke.py covers the big models.
"""

import os

import numpy as np

from conftest import CHMM_DIR, ESS_DIR

from spec_viterbi.hmm import almost_equal_vec
from spec_viterbi.io import read_emit_seq, read_hmm
from spec_viterbi.models.decoder import ViterbiDecoder
from spec_viterbi.models.oracle import viterbi_path_oracle, viterbi_scores_oracle


def test_covid_full_dataset_scores_and_paths():
    hmm = read_hmm(os.path.join(CHMM_DIR, "100.chmm"))
    seqs = read_emit_seq(os.path.join(ESS_DIR, "covid-19.ess"))
    assert len(seqs) == 16
    assert min(len(s) for s in seqs) == 38
    assert max(len(s) for s in seqs) == 7096

    dec = ViterbiDecoder(hmm)  # auto → structured
    # batched scores across the whole ragged dataset
    got = dec.decode_batch(seqs)
    for g, s in zip(got, seqs):
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s)), len(s)

    # full backtrace on a spread of lengths, exact path parity
    for s in (seqs[0], seqs[5], max(seqs, key=len)):
        scores, path = dec.decode_path(s)
        oscores, opath = viterbi_path_oracle(hmm, s)
        assert almost_equal_vec(scores, oscores)
        assert np.array_equal(path, opath), len(s)
        assert path.shape[0] == len(s)
