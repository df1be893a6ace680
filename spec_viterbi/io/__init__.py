"""I/O: .chmm / .ess parsers (with native C++ fast path), FASTA conversion,
and dataset generators."""

from spec_viterbi.io.chmm import read_hmm, write_chmm
from spec_viterbi.io.ess import read_emit_seq, write_ess
from spec_viterbi.io.fasta import fasta_to_sequences
from spec_viterbi.io.hmmer import hmmer_to_chmm, hmmer_to_hmm

__all__ = [
    "read_hmm",
    "write_chmm",
    "read_emit_seq",
    "write_ess",
    "fasta_to_sequences",
    "hmmer_to_chmm",
    "hmmer_to_hmm",
]
