"""Viterbi decoders: NumPy oracle, JAX non-specialized and specialized
paths, and the backtrace extension."""

from spec_viterbi.models.oracle import (
    viterbi_scores_oracle,
    viterbi_path_oracle,
)
from spec_viterbi.models.decoder import DeviceHMM, ViterbiDecoder
from spec_viterbi.models.spec_structured import StructuredSpecializedViterbi
from spec_viterbi.models.specializer import SpecializedViterbi

__all__ = [
    "viterbi_scores_oracle",
    "viterbi_path_oracle",
    "DeviceHMM",
    "ViterbiDecoder",
    "SpecializedViterbi",
    "StructuredSpecializedViterbi",
]
