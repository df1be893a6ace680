"""(min,+) tropical-semiring ops: jnp implementations, the structured
operators, and the whole-sequence Pallas kernel for the GPU."""

from spec_viterbi.ops.tropical import (
    tropical_mv,
    tropical_mm,
    tropical_mv_argmin,
    tropical_mm_blocked,
    tropical_mm_tn_blocked,
)

__all__ = [
    "tropical_mv",
    "tropical_mm",
    "tropical_mv_argmin",
    "tropical_mm_blocked",
    "tropical_mm_tn_blocked",
]
