"""Universal streaming decode: the XLA structured engine.

The kernel engine (:class:`~spec_viterbi.ops.fused_pallas.
FusedStructuredDecoder`) runs on a GPU and requires a fused-eligible
operator (residual ≤ 8, ≤ 24 components). This engine implements the SAME
streaming protocol (:class:`~spec_viterbi.ops.stream_api._StreamAPI`:
``stream_begin/feed/scores``, the ``stream_*_path`` family,
``stream_save/load``) on the plain XLA structured scan (:func:`~spec_viterbi.ops.structured.
structured_mv_batch`), which accepts ANY decomposition — arbitrary
residual COO included — so ``ViterbiDecoder.streaming()`` works for every
HMM the parity API accepts (``Viterbi_impl.h:8`` takes whole sequences of
any model; the long-context extension must not be narrower).

Differences from the kernel engine, by design:

- path-finalize backpointers are int32 (no 32k-state limit) produced by a
  ``vmap``-over-lanes :func:`structured_mv_argmin` — same lowest-source /
  inf-ties-never-adopt contract, so paths are bit-identical to the oracle;
- lanes pad to 8 (the kernel pads none), and ``_model_key``
  names the engine, so a cross-engine ``stream_load`` fails loudly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spec_viterbi.ops.stream_api import _StreamAPI, model_key
from spec_viterbi.ops.structured import (
    StructuredOperator,
    structured_mv_argmin,
    structured_mv_batch,
)
from spec_viterbi.utils.device import path_budget_bytes

SUBLANE = 8  # lane-pad granularity for the scan batch dim


class XLAStreamDecoder(_StreamAPI):
    """Streaming engine on the XLA structured scan; any operator, any backend."""

    # one [T_q, Np, B] int32 backpointer block materializes per finalize
    # chunk; None reads the budget from the device
    MAX_PATH_BYTES: int | None = None

    def __init__(self, sop: StructuredOperator, emissions: np.ndarray, pi: np.ndarray):
        self.sop = sop
        self.n = sop.n
        self.states_num = sop.states_num
        self.emit_num = int(emissions.shape[0])
        self._arrs = sop.device_arrays()
        self.em_t = jnp.asarray(np.asarray(emissions).T)  # [Np, E]
        self.pi = jnp.asarray(pi)
        self._sym_dtype = np.int8 if self.emit_num <= 127 else np.int32

        self._model_key = model_key(
            "xla", np.asarray(emissions), np.asarray(pi), sop
        )

        # operator/emission arrays are threaded through jit as ARGUMENTS,
        # not closure constants baked into every compiled program; only
        # the static index structure closes over
        em_t, pi_d, arrs = self.em_t, self.pi, self._arrs

        @jax.jit
        def begin(em_t, pi_d, syms):
            b = syms.shape[0]
            b_pad = -(-b // SUBLANE) * SUBLANE
            syms = jnp.pad(syms, (0, b_pad - b))
            return em_t[:, syms] + pi_d[:, None]

        @jax.jit
        def feed(em_t, arrs, carry, syms, lengths):
            def step(v, xs):
                o, t = xs
                u = structured_mv_batch(sop, arrs, v)
                v_new = em_t[:, o] + u
                keep = ((t + 1) < lengths[0])[None, :]
                return jnp.where(keep, v_new, v), None

            obs = syms.astype(jnp.int32)
            ts = jnp.arange(obs.shape[0])
            v, _ = jax.lax.scan(step, carry, (obs, ts))
            return v

        @jax.jit
        def last(carry):
            # per-lane argmin end state; jnp.argmin ties -> lowest index,
            # all-inf lanes -> 0 (oracle contract)
            return jnp.argmin(carry, axis=0).astype(jnp.int32)[None, :]

        mv_argmin = jax.vmap(
            lambda arrs, vv: structured_mv_argmin(sop, arrs, vv),
            in_axes=(None, 1),
            out_axes=1,
        )

        @functools.partial(jax.jit, static_argnames=("b_real",))
        def path_block(em_t, arrs, carry, chunk, lengths, boundary, *, b_real: int):
            """One finalize block (the fused ``_path_block`` contract):
            rematerialize this chunk's backpointers from its checkpoint,
            backtrace from ``boundary`` (state at the chunk's end), return
            (piece [T_q, b_real] — states at positions p+1..p+T_q, pad
            steps repeating the boundary via identity pointers — and the
            new boundary rev[0] = state at position p)."""
            obs = chunk.astype(jnp.int32)
            n = carry.shape[0]
            iota = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)

            def step(v, xs):
                o, t = xs
                u, src = mv_argmin(arrs, v)  # [Np, B] each
                v_new = em_t[:, o] + u
                keep = ((t + 1) < lengths[0])[None, :]
                # frozen steps store identity pointers: backtrace through
                # padding is a no-op
                return jnp.where(keep, v_new, v), jnp.where(keep, src, iota)

            ts = jnp.arange(obs.shape[0])
            _, srcs = jax.lax.scan(step, carry, (obs, ts))  # [T_q, Np, B]

            def back(state, src_t):  # state [1, B]
                prev = jnp.take_along_axis(src_t, state, axis=0)
                return prev, prev

            _, rev = jax.lax.scan(back, boundary, srcs, reverse=True)
            rev = rev[:, 0, :]  # [T_q, B]: rev[t] = state at position p+t
            piece = jnp.concatenate([rev[1:], boundary], axis=0)
            return piece[:, :b_real], rev[0:1]

        self._jit_begin = lambda syms: begin(em_t, pi_d, syms)
        self._jit_feed = lambda carry, syms, ln: feed(em_t, arrs, carry, syms, ln)
        # jitted: one dispatch for the transpose + slice
        self._jit_extract = jax.jit(self._extract, static_argnames=("b_real",))
        self._jit_last = last
        self._jit_path_block = lambda ck, ch, ln, bd, b_real: path_block(
            em_t, arrs, ck, ch, ln, bd, b_real=b_real
        )

    def _extract(self, carry, b_real: int | None = None):
        out = carry.T  # already true +inf space
        if b_real is not None:
            out = out[:b_real]
        return out[:, : self.states_num]  # same [B, states_num] as fused

    def path_supported(self, t_max: int, batch: int = SUBLANE) -> bool:
        """Whether one finalize block of this shape fits the pointer budget."""
        budget = self.MAX_PATH_BYTES
        if budget is None:
            budget = path_budget_bytes()
        if budget is None:
            return True
        b_pad = -(-batch // SUBLANE) * SUBLANE
        return max(0, t_max - 1) * self.n * b_pad * 4 <= budget
