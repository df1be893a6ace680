"""Tropical (min,+) semiring linear algebra — jnp reference implementations.

The reference expresses Viterbi as iterated (min,+) matrix products over
three semiring libraries (GraphBLAS ``GrB_MIN_PLUS_SEMIRING_FP32``,
``GraphBLAS_helper.cpp:32-36``; CUSP generalized SpGEMM with combine=+,
reduce=min, ``CUSP_helper.cu:9-15``; cuASR ``Srgemm<minimum, plus>``,
``cuASR_helper.cu:65-73``). Here the same algebra is written as XLA-fusable
broadcast+reduce expressions. The semiring zero is ``+inf``: ``inf + x = inf``
and ``min(inf, x) = x`` hold in IEEE float32, so no masking is needed.

These are also the *performance* implementations for dense operands: inside
the decode scan XLA pre-layouts the loop-invariant operator and runs the
step at the VPU compute roofline (see :mod:`spec_viterbi.ops.dispatch`
for why the dense Pallas SRGEMM was removed).

Orientation conventions (all row-major):

- ``tropical_mv(M, v)[i]   = min_j M[i, j] + v[j]``        (operator ⊗ vector)
- ``tropical_mm(A, B)[i,j] = min_k A[i, k] + B[k, j]``     (A ⊗ B)
- a batch of row-vectors ``V [B, N]`` advances by ``tropical_mm(V, A)`` with
  the *untransposed* transition matrix, since
  ``min_j V[b, j] + A[j, i] = min_j Aᵀ[i, j] + V[b, j]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tropical_mv(M: jax.Array, v: jax.Array) -> jax.Array:
    """``(M ⊗ v)[i] = min_j M[i,j] + v[j]``. Shapes: [N, K] ⊗ [K] → [N]."""
    return jnp.min(M + v[None, :], axis=1)


def tropical_mv_argmin(M: jax.Array, v: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Tropical matvec that also returns the argmin index per output row.

    Ties break to the lowest index (``jnp.argmin`` semantics) so Viterbi
    backtraces are deterministic across shardings.
    """
    s = M + v[None, :]
    return jnp.min(s, axis=1), jnp.argmin(s, axis=1).astype(jnp.int32)


def tropical_mm(A: jax.Array, B: jax.Array) -> jax.Array:
    """``(A ⊗ B)[i,j] = min_k A[i,k] + B[k,j]``. [I, K] ⊗ [K, J] → [I, J].

    Materializes an [I, K, J] broadcast, so use only for small operands
    (XLA fuses the reduce, but there is no cache blocking). Use
    :func:`tropical_mm_blocked` or the Pallas kernel for large shapes.
    """
    return jnp.min(A[:, :, None] + B[None, :, :], axis=1)


def tropical_mm_blocked(
    A: jax.Array, B: jax.Array, k_block: int = 8
) -> jax.Array:
    """Blocked jnp tropical matmul: accumulates a running min over K chunks.

    Keeps the broadcast intermediate at [I, k_block, J], trading one big
    temporary for a ``fori_loop``. Works on any backend.
    """
    I, K = A.shape
    K2, J = B.shape
    assert K == K2, (A.shape, B.shape)
    if K % k_block != 0:
        # Fall back: pad K with semiring zeros (+inf rows never win the min)
        pad = k_block - K % k_block
        A = jnp.pad(A, ((0, 0), (0, pad)), constant_values=jnp.inf)
        B = jnp.pad(B, ((0, pad), (0, 0)), constant_values=jnp.inf)
        K = K + pad

    def body(c, a_b):
        a_chunk, b_chunk = a_b
        partial = jnp.min(a_chunk[:, :, None] + b_chunk[None, :, :], axis=1)
        return jnp.minimum(c, partial), None

    a_chunks = A.reshape(I, K // k_block, k_block).transpose(1, 0, 2)
    b_chunks = B.reshape(K // k_block, k_block, J)
    # Init from the first chunk (not a fresh +inf fill) so the carry carries
    # the operands' varying-axis types under shard_map.
    init = jnp.min(a_chunks[0][:, :, None] + b_chunks[0][None, :, :], axis=1)
    out, _ = jax.lax.scan(body, init, (a_chunks[1:], b_chunks[1:]))
    return out


def tropical_mm_tn_blocked(
    AT: jax.Array, B: jax.Array, k_block: int = 8
) -> jax.Array:
    """TN tropical matmul: ``C[i,j] = min_k AT[k,i] + B[k,j]``.

    jnp reference for the Pallas TN kernel; same chunked-K min accumulation.
    """
    K, I = AT.shape
    K2, J = B.shape
    assert K == K2, (AT.shape, B.shape)
    if K % k_block != 0:
        pad = k_block - K % k_block
        AT = jnp.pad(AT, ((0, pad), (0, 0)), constant_values=jnp.inf)
        B = jnp.pad(B, ((0, pad), (0, 0)), constant_values=jnp.inf)
        K = K + pad

    def body(c, ab):
        at_chunk, b_chunk = ab  # [k_block, I], [k_block, J]
        partial = jnp.min(at_chunk[:, :, None] + b_chunk[:, None, :], axis=0)
        return jnp.minimum(c, partial), None

    at_chunks = AT.reshape(K // k_block, k_block, I)
    b_chunks = B.reshape(K // k_block, k_block, J)
    # Init from the first chunk (not a fresh +inf fill) so the carry carries
    # the operands' varying-axis types under shard_map.
    init = jnp.min(at_chunks[0][:, :, None] + b_chunks[0][:, None, :], axis=0)
    out, _ = jax.lax.scan(body, init, (at_chunks[1:], b_chunks[1:]))
    return out
