"""Random dataset generators.

Parameterized, seeded re-designs of the reference's edit-the-source scripts
(``chmm_files/chmm_gen.py:1-63``, ``ess_files/ess_gen.py:1-21``): same output
distributions, but as callable APIs.
"""

from __future__ import annotations

import numpy as np

from spec_viterbi.hmm import HMM, MOD_PROB_DTYPE, to_modified_prob_np


def generate_random_hmm(
    states_num: int,
    trans_per_state: int = 3,
    emit_range: int = 20,
    num_non_zero_start_probs: int = 2,
    seed: int = 0,
) -> HMM:
    """Random HMM with normalized probability rows (chmm_gen.py semantics)."""
    rng = np.random.default_rng(seed)

    def prob_row(length: int) -> np.ndarray:
        # chmm_gen.py:20-30 draws integers in [0, 100) then normalizes.
        row = rng.integers(0, 100, size=length).astype(np.float64)
        s = row.sum()
        if s == 0:
            row[:] = 1.0
            s = float(length)
        return row / s

    start_cols = np.arange(num_non_zero_start_probs, dtype=np.int64)
    start_probs = to_modified_prob_np(prob_row(num_non_zero_start_probs))

    emissions_by_state = np.stack(
        [prob_row(emit_range) for _ in range(states_num)]
    )  # [N, E]
    emissions = to_modified_prob_np(emissions_by_state.T)  # [E, N]

    rows, cols, probs = [], [], []
    for src in range(states_num):
        dsts = rng.choice(states_num, size=trans_per_state, replace=False)
        p = prob_row(trans_per_state)
        rows.extend([src] * trans_per_state)
        cols.extend(int(d) for d in dsts)
        probs.extend(p)
    hmm = HMM(
        states_num=states_num,
        emit_num=emit_range,
        trans_rows=np.asarray(rows, dtype=np.int64),
        trans_cols=np.asarray(cols, dtype=np.int64),
        trans_probs=to_modified_prob_np(np.asarray(probs)),
        emissions=np.ascontiguousarray(emissions, dtype=MOD_PROB_DTYPE),
        start_probabilities_cols=start_cols,
        start_probabilities=start_probs,
    )
    hmm.validate()
    return hmm


def generate_profile(length: int, seed: int = 0):
    """Seeded stand-in for a Pfam profile's match states.

    Returns ``(match_emissions [L][20], match_trans [L+1])`` in the
    semantics of :func:`~spec_viterbi.io.hmmer.read_hmmer_msv`: emission
    rows are amino-acid distributions peaked like real match states (a
    sparse Dirichlet draw mixed with 10% background, so no residue falls
    below HMMER's usual floor); ``match_trans[0]`` is the raw ``B→M1``
    token and the rest are ``Mk→Mk+1`` probabilities near 1.
    """
    from spec_viterbi.io.hmmer import NUM_AMINO_ACIDS

    rng = np.random.default_rng(seed)
    peaked = rng.dirichlet(np.full(NUM_AMINO_ACIDS, 0.5), size=length)
    emissions = 0.9 * peaked + 0.1 / NUM_AMINO_ACIDS
    trans = np.exp(-rng.uniform(0.005, 0.2, size=length + 1))
    trans[0] = rng.uniform(0.001, 0.05)  # raw neg-ln B→M1 token
    return emissions.tolist(), trans.tolist()


def generate_profile_hmm(length: int, seed: int = 0) -> HMM:
    """Profile HMM of ``length`` match states (``length + 2`` states).

    The MSV construction of :func:`~spec_viterbi.io.hmmer.msv_hmm` over
    :func:`generate_profile`: one dense source row (N fans out to every
    match state), two dense destination columns (returns to N and C) and
    the match-chain diagonal — the structure of every Pfam-derived model.
    """
    from spec_viterbi.io.hmmer import msv_hmm

    return msv_hmm(length, *generate_profile(length, seed))


def generate_random_sequences(
    count: int, length: int, emit_range: int = 20, seed: int = 0
) -> list[np.ndarray]:
    """Uniform random symbol sequences (ess_gen.py semantics)."""
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, emit_range, size=length).astype(np.int32)
        for _ in range(count)
    ]
