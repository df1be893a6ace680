""".ess (emitted sequence set) parser/writer.

Format (comment block at ``Viterbi_impl/data_reader.cpp:81-91``)::

    N                         # number of sequences
    0 len(seq[0])
    seq[0] symbols (any line wrapping)
    ...
    N-1 len(seq[N-1])
    seq[N-1] symbols

Sequence numbering is validated exactly like the reference
(``data_reader.cpp:111-119``), except that a violation raises instead of
returning an empty set.
"""

from __future__ import annotations

import os

import numpy as np


def read_emit_seq(path: str | os.PathLike) -> list[np.ndarray]:
    """Parse an ``.ess`` file into a list of int32 symbol arrays."""
    path = os.fspath(path)
    from spec_viterbi.native import loader as _native

    parsed = _native.read_ess_native(path)
    if parsed is not None:
        return parsed
    with open(path, "r") as f:
        tokens = f.read().split()
    return _parse_tokens(tokens, path)


def _parse_tokens(tokens: list, path: str) -> list[np.ndarray]:
    pos = 0

    def take_int() -> int:
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError(f"{path}: truncated .ess file")
        v = int(tokens[pos])
        pos += 1
        return v

    num_sequences = take_int()
    sequences: list[np.ndarray] = []
    for i in range(num_sequences):
        seq_num = take_int()
        if seq_num != i:
            # mirrors the reference's numbering check (data_reader.cpp:113-119)
            raise ValueError(
                f"Error in .ess file {path}: expected sequence number is "
                f"{i}, but read {seq_num}"
            )
        seq_len = take_int()
        if pos + seq_len > len(tokens):
            raise ValueError(f"{path}: truncated sequence {i}")
        seq = np.asarray(tokens[pos : pos + seq_len], dtype=np.int32)
        pos += seq_len
        sequences.append(seq)
    return sequences


def write_ess(sequences: list[np.ndarray], path: str | os.PathLike) -> None:
    """Write sequences in ``.ess`` format (used by generators/converters)."""
    with open(os.fspath(path), "w") as f:
        f.write(f"{len(sequences)}\n")
        for i, seq in enumerate(sequences):
            f.write(f"{i} {len(seq)}\n")
            f.write(" ".join(str(int(s)) for s in seq) + "\n")
