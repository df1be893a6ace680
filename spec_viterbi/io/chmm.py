""".chmm parser/writer.

Format (comment block at ``Viterbi_impl/data_reader.cpp:7-15``)::

    N                     # number of states
    S                     # states with non-zero start probability
    S x "state prob"
    E                     # emission alphabet size
    N rows of E emission probabilities (row = state, col = symbol)
    T                     # number of transitions
    T x "src dst prob"

Every probability is converted to −log2 at load (``data_reader.cpp:41,54,71``)
and emissions are stored transposed to the file layout as
``emissions[symbol][state]`` (``data_reader.cpp:49-57``).

Whitespace handling matches C++ ``operator>>``: any run of spaces/newlines
separates tokens, so we tokenize the whole file.

A native C++ fast parser (``spec_viterbi/native``) is used when its
shared library is available; this module is the pure-Python fallback and the
semantics reference.
"""

from __future__ import annotations

import os

import numpy as np

from spec_viterbi.hmm import HMM, MOD_PROB_DTYPE, to_modified_prob_np


def _parse_tokens(tokens: np.ndarray | list, path: str) -> HMM:
    """Build an HMM from the whitespace-split token stream of a .chmm file."""
    pos = 0

    def take(n: int):
        nonlocal pos
        if pos + n > len(tokens):
            raise ValueError(f"{path}: truncated .chmm file (needed {n} more tokens)")
        out = tokens[pos : pos + n]
        pos += n
        return out

    states_num = int(take(1)[0])

    s = int(take(1)[0])
    start_block = np.asarray(take(2 * s), dtype=np.float64).reshape(s, 2)
    start_cols = start_block[:, 0].astype(np.int64)
    start_probs = to_modified_prob_np(start_block[:, 1])

    emit_num = int(take(1)[0])
    emit_block = np.asarray(
        take(states_num * emit_num), dtype=np.float64
    ).reshape(states_num, emit_num)
    # transpose to [symbol, state] (data_reader.cpp:49-57)
    emissions = to_modified_prob_np(emit_block.T)

    trans_num = int(take(1)[0])
    trans_block = np.asarray(take(3 * trans_num), dtype=np.float64).reshape(
        trans_num, 3
    )
    trans_rows = trans_block[:, 0].astype(np.int64)
    trans_cols = trans_block[:, 1].astype(np.int64)
    trans_probs = to_modified_prob_np(trans_block[:, 2])

    hmm = HMM(
        states_num=states_num,
        emit_num=emit_num,
        trans_rows=trans_rows,
        trans_cols=trans_cols,
        trans_probs=trans_probs,
        emissions=np.ascontiguousarray(emissions, dtype=MOD_PROB_DTYPE),
        start_probabilities_cols=start_cols,
        start_probabilities=start_probs,
    )
    hmm.validate()
    return hmm


def read_hmm(path: str | os.PathLike) -> HMM:
    """Parse a ``.chmm`` file into an :class:`HMM`.

    Unlike the reference (which prints to stderr and returns an empty HMM on
    a bad file, ``data_reader.cpp:19-22``), this raises — a deliberate
    upgrade for a production framework.
    """
    path = os.fspath(path)
    from spec_viterbi.native import loader as _native

    parsed = _native.read_hmm_native(path)
    if parsed is not None:
        return parsed
    with open(path, "r") as f:
        tokens = f.read().split()
    return _parse_tokens(tokens, path)


def write_chmm(hmm: HMM, path: str | os.PathLike) -> None:
    """Write an HMM back to ``.chmm`` (probabilities as ``2**-modprob``).

    Used by the dataset generators; round-trips through :func:`read_hmm`.
    """
    with open(os.fspath(path), "w") as f:
        f.write(f"{hmm.states_num}\n")
        f.write(f"{hmm.non_zero_start_probs}\n")
        for c, p in zip(hmm.start_probabilities_cols, hmm.start_probabilities):
            f.write(f"{int(c)} {_from_mod(p)}\n")
        f.write(f"{hmm.emit_num}\n")
        emit_by_state = hmm.emissions.T  # back to file layout [state, symbol]
        for row in emit_by_state:
            f.write(" ".join(_from_mod(p) for p in row) + "\n")
        f.write(f"{hmm.trans_num}\n")
        for r, c, p in zip(hmm.trans_rows, hmm.trans_cols, hmm.trans_probs):
            f.write(f"{int(r)} {int(c)} {_from_mod(p)}\n")


def _from_mod(mod_prob: float) -> str:
    if np.isinf(mod_prob):
        return "0"
    return repr(float(2.0 ** (-float(mod_prob))))
