"""A seeded stand-in for the reference corpus, written as files.

The reference suite ships Pfam-derived ``.chmm`` models (with their
HMMER3 ``.hmm`` sources), random ``.ess`` sequence sets, the covid-19
proteome as FASTA and ``.ess``, and four tiny parser/golden fixtures.
:func:`write_corpus` writes the same kinds of files with the same shapes
from fixed seeds, so tests, the benchmark and ``chip_smoke.py`` run
without the reference checkout:

- ``chmm_files/<L>.chmm`` + ``<L>.hmm``: profile models of ``L`` match
  states (``L + 2`` states, :func:`~spec_viterbi.io.generators.
  generate_profile_hmm`), the ``.hmm`` written from the same profile;
- ``chmm_files/test_chmms/<i>_test_chmm.chmm`` and
  ``ess_files/test_sequences/<i>_test_seq.ess``, i = 0..3: fixture 0 is
  the reference's own first fixture, whose every field the reference's
  parser test spells out; fixtures 1-3 are small models of the same kinds
  (a zero start probability; a dense 3-state model; an irregular operator
  that decomposes into residual entries only);
- ``ess_files/emit_3_3500_20.ess`` (3 × 3,500 uniform symbols over 20);
- ``ess_files/covid-19.fasta`` + ``covid-19.ess``: 16 protein-length
  sequences (38 to 7,096 residues, the covid-19 length profile), the
  ``.ess`` written from the symbols and the FASTA from their letters.
"""

from __future__ import annotations

import os

import numpy as np

from spec_viterbi.hmm import HMM, to_modified_prob_np
from spec_viterbi.io.chmm import write_chmm
from spec_viterbi.io.ess import write_ess
from spec_viterbi.io.fasta import AMINO2NUM
from spec_viterbi.io.generators import generate_profile, generate_random_sequences
from spec_viterbi.io.hmmer import msv_hmm, write_hmmer_msv

PROFILE_LENGTHS = (100, 500, 1200)

# SARS-CoV-2 protein lengths (ORF1ab ... ORF10): the covid-19 set's profile
COVID_LENGTHS = (
    7096, 4405, 1273, 419, 275, 222, 121, 121,
    75, 61, 43, 38, 1945, 932, 346, 290,
)


def _hmm(n, e, trans, emissions, start):
    """HMM from probability-space parts: ``trans`` [(src, dst, p)],
    ``emissions`` [state][symbol], ``start`` [(state, p)]."""
    rows, cols, probs = zip(*trans)
    scols, sprobs = zip(*start)
    return HMM(
        states_num=n,
        emit_num=e,
        trans_rows=np.asarray(rows, np.int64),
        trans_cols=np.asarray(cols, np.int64),
        trans_probs=to_modified_prob_np(np.asarray(probs)),
        emissions=to_modified_prob_np(np.asarray(emissions, np.float64).T),
        start_probabilities_cols=np.asarray(scols, np.int64),
        start_probabilities=to_modified_prob_np(np.asarray(sprobs)),
    )


def tiny_fixtures() -> list[tuple[HMM, list[np.ndarray]]]:
    """The four tiny (model, sequences) fixtures."""
    f0 = _hmm(
        3, 4,
        [(0, 0, 0.5), (0, 1, 0.5), (1, 0, 0.4), (1, 1, 0.6)],
        [[0.2, 0.3, 0.3, 0.2], [0.3, 0.2, 0.2, 0.3], [0.3, 0.2, 0.2, 0.3]],
        [(0, 0.5), (1, 0.5)],
    )
    s0 = [np.array([2, 2, 1, 0, 1, 3, 2, 0, 0]), np.array([3, 2, 1, 0])]
    f1 = _hmm(
        2, 3,
        [(0, 0, 0.7), (0, 1, 0.3), (1, 0, 0.2), (1, 1, 0.8)],
        [[0.6, 0.3, 0.1], [0.2, 0.3, 0.5]],
        [(0, 1.0), (1, 0.0)],
    )
    s1 = [np.array([0, 2, 1, 2, 2, 0])]
    f2 = _hmm(
        3, 2,
        [(s, d, p) for s, row in enumerate(
            [[0.5, 0.3, 0.2], [0.1, 0.6, 0.3], [0.3, 0.3, 0.4]]
        ) for d, p in enumerate(row)],
        [[0.9, 0.1], [0.4, 0.6], [0.2, 0.8]],
        [(0, 0.6), (2, 0.4)],
    )
    s2 = [np.array([1, 0, 0, 1, 1, 0, 1])]
    f3 = _hmm(
        4, 5,
        [(1, 2, 0.5), (1, 3, 0.5), (2, 1, 0.7), (2, 3, 0.3),
         (3, 3, 0.9), (3, 2, 0.1), (0, 1, 1.0)],
        [[0.2] * 5, [0.1, 0.4, 0.1, 0.3, 0.1],
         [0.3, 0.1, 0.3, 0.1, 0.2], [0.25, 0.25, 0.1, 0.2, 0.2]],
        [(1, 0.5), (2, 0.3), (3, 0.2)],
    )
    s3 = [np.array([1, 4, 0, 2, 3, 1, 1, 0, 4, 2])]
    return [
        (h, [np.asarray(s, np.int32) for s in seqs])
        for h, seqs in ((f0, s0), (f1, s1), (f2, s2), (f3, s3))
    ]


def covid_like_sequences(seed: int = 19) -> list[np.ndarray]:
    """16 amino-acid sequences with the covid-19 proteome's lengths."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 20, size=n).astype(np.int32) for n in COVID_LENGTHS]


def write_corpus(root: str | os.PathLike, profile_lengths=PROFILE_LENGTHS) -> None:
    """Write the seeded corpus under ``root`` (layout in the module doc)."""
    root = os.fspath(root)
    chmm_dir = os.path.join(root, "chmm_files")
    ess_dir = os.path.join(root, "ess_files")
    test_chmms = os.path.join(chmm_dir, "test_chmms")
    test_seqs = os.path.join(ess_dir, "test_sequences")
    for d in (test_chmms, test_seqs):
        os.makedirs(d, exist_ok=True)

    for length in profile_lengths:
        emissions, trans = generate_profile(length, seed=length)
        write_chmm(msv_hmm(length, emissions, trans), os.path.join(chmm_dir, f"{length}.chmm"))
        write_hmmer_msv(os.path.join(chmm_dir, f"{length}.hmm"), emissions, trans)

    for i, (hmm, seqs) in enumerate(tiny_fixtures()):
        write_chmm(hmm, os.path.join(test_chmms, f"{i}_test_chmm.chmm"))
        write_ess(seqs, os.path.join(test_seqs, f"{i}_test_seq.ess"))

    write_ess(
        generate_random_sequences(3, 3500, emit_range=20, seed=3),
        os.path.join(ess_dir, "emit_3_3500_20.ess"),
    )
    covid = covid_like_sequences()
    write_ess(covid, os.path.join(ess_dir, "covid-19.ess"))
    letters = np.array(sorted((v, k) for k, v in AMINO2NUM.items() if k != "X"))[:, 1]
    with open(os.path.join(ess_dir, "covid-19.fasta"), "w") as f:
        for i, s in enumerate(covid):
            f.write(f">protein_{i}\n")
            text = "".join(letters[s])
            for k in range(0, len(text), 60):
                f.write(text[k : k + 60] + "\n")
