"""spec_viterbi — Viterbi decoding via (min,+) semiring matrix products
with HMM specialization, in JAX, with a whole-sequence GPU kernel.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the reference
CUDA/C++ suite Spec_Viterbi (see SURVEY.md): .chmm/.ess corpus I/O,
non-specialized and specialized (level-L) decoding, cross-validating
execution paths, a median-of-N benchmark harness with .dat outputs — plus
extensions: batched data-parallel decode, state-sharded (TP) and
time-parallel (SP) decoding over device meshes, exact Viterbi backtrace, and
a persistent operator cache.
"""

from spec_viterbi.hmm import (
    HMM,
    ZERO_PROB,
    almost_equal,
    almost_equal_vec,
    to_modified_prob,
)
from spec_viterbi.io import hmmer_to_hmm, read_hmm, read_emit_seq
from spec_viterbi.models import (
    DeviceHMM,
    SpecializedViterbi,
    StructuredSpecializedViterbi,
    ViterbiDecoder,
    viterbi_path_oracle,
    viterbi_scores_oracle,
)
from spec_viterbi.scheduler import (
    Route,
    Workload,
    decode_auto,
    execute_route,
    plan_route,
    stream_engine,
)

__version__ = "0.1.0"

__all__ = [
    "HMM",
    "ZERO_PROB",
    "almost_equal",
    "almost_equal_vec",
    "to_modified_prob",
    "read_hmm",
    "read_emit_seq",
    "hmmer_to_hmm",
    "DeviceHMM",
    "ViterbiDecoder",
    "SpecializedViterbi",
    "StructuredSpecializedViterbi",
    "viterbi_scores_oracle",
    "viterbi_path_oracle",
    "Route",
    "Workload",
    "plan_route",
    "execute_route",
    "decode_auto",
    "stream_engine",
]
