"""Named (min,+) ops used by the decode/specialization paths.

All dense tropical algebra routes to the XLA implementations in
:mod:`spec_viterbi.ops.tropical` (the cuASR analog,
``cuASR_helper.cu:65-73``): XLA fuses the broadcast-add-min of a dense
step on its own, so there is no hand-written dense kernel. The one
hand-written kernel is the structured whole-sequence decode in
:mod:`spec_viterbi.ops.fused_pallas`.
"""

from __future__ import annotations

import jax

from spec_viterbi.ops import tropical


def step_mv(a_t: jax.Array, v: jax.Array) -> jax.Array:
    """One recurrence matvec: min_j a_t[i,j] + v[j]."""
    return tropical.tropical_mv(a_t, v)


def step_mv_argmin(a_t: jax.Array, v: jax.Array):
    return tropical.tropical_mv_argmin(a_t, v)


def batch_step_t(a: jax.Array, v_t: jax.Array) -> jax.Array:
    """Batched step on a state-major carry: U_T[i,b] = min_j a[j,i] + v_t[j,b].

    ``a`` is the *untransposed* transition matrix: in the TN form
    ``C[i,j] = min_k AT[k,i] + B[k,j]`` it already plays the AT role, so no
    per-step transpose is needed anywhere in the scan.
    """
    return tropical.tropical_mm_tn_blocked(a, v_t)


def matmul_tn(AT: jax.Array, B: jax.Array) -> jax.Array:
    """TN tropical matmul, used by the specialization (add_level) path."""
    return tropical.tropical_mm_tn_blocked(AT, B)
