"""HMM specialization: precomputed (min,+) operators, level-L tuple operators.

API parity target: ``Viterbi_spec_impl`` (``Viterbi_impl/Viterbi_spec_impl.h:6-24``):
``spec_with(hmm)`` (re-specializable), ``run_Viterbi_spec(seq)``,
``get_level()``.

Level-1 specialization precomputes, per observation symbol ``o``:

- ``start_ops[o] = diag(emit_o) ⊗ π``   (N-vector;   GraphBLAS_spec_impl.cpp:142-150)
- ``ops[o]       = diag(emit_o) ⊗ Aᵀ``  (N×N matrix; GraphBLAS_spec_impl.cpp:152-161)

In log space the diagonal product is a row-wise add, so the whole level-1
stack is one broadcast: ``ops = emissions[:, :, None] + Aᵀ[None]``.

Level L > 1 exploits (min,+) matmul associativity to collapse L consecutive
steps into one operator per observation L-tuple. The reference stores
``emit_num^L`` matrices in a hash map keyed by symbol tuples
(``GraphBLAS_spec_impl.h:10``, ``.cpp:15-36``); the array-shaped equivalent
is a dense ``[emit_num^L, N, N]`` tensor indexed by the radix-``emit_num``
encoding of the tuple (earliest symbol = least-significant digit), built by
one batched tropical matmul per level:

    T_l[p + i·E^(l-1)] = ops[i] ⊗ T_{l-1}[p]        (add_level, .cpp:15-36)

Decode consumes ``seq[1:]`` in chunks of ``level`` via one matvec per chunk
and finishes the remainder with level-1 operators, exactly like the
reference's tail loop (``GraphBLAS_spec_impl.cpp:64-89``).
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from spec_viterbi.hmm import HMM, pad_to_lane, validate_obs_seq
from spec_viterbi.ops import dispatch


@jax.jit
def _build_level1(a_t, pi, em):
    """Level-1 stack with a trailing IDENTITY operator at index ``E``.

    The identity slot (tropical identity: 0 diagonal, +inf elsewhere) is a
    padding symbol: applying it leaves the carry unchanged, so ragged
    sequences can be padded to a common length and decoded through the
    chunked path with exact results and ONE compiled shape per dataset
    (instead of one per distinct sequence length). The tuple radix is
    therefore ``E+1``.
    """
    start_ops = em + pi[None, :]  # [E, Np]
    n = a_t.shape[0]
    eye = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
        == jax.lax.broadcasted_iota(jnp.int32, (n, n), 1),
        jnp.zeros((n, n), a_t.dtype),
        jnp.full((n, n), jnp.inf, a_t.dtype),
    )
    ops = jnp.concatenate(
        [em[:, :, None] + a_t[None, :, :], eye[None]], axis=0
    )  # [E+1, Np, Np]
    return start_ops, ops


@jax.jit
def _add_level(ops_t, t_prev):
    """ops ⊗ t_prev: [E, N, N] ⊗ [P, N, N] → [E·P, N, N].

    ``ops_t`` is the level-1 stack with each operator transposed (TN matmul
    layout). Output ordering matches the radix encoding: new symbol ``i`` is
    the most-significant digit (it is applied last in time), i.e. the result
    index is ``p + i·P``.
    """
    e = ops_t.shape[0]
    p = t_prev.shape[0]

    def per_symbol(op_i_t):
        return jax.vmap(lambda tp: dispatch.matmul_tn(op_i_t, tp))(t_prev)

    t_next = jax.lax.map(per_symbol, ops_t)  # [E, P, N, N]
    return t_next.reshape(e * p, *t_prev.shape[1:])


def make_chunked_decode(
    level: int, emit_num: int, start_fn, chunk_fn, tail_fn, operands=None, operands_fn=None
):
    """Shared chunked-decode skeleton (GraphBLAS_spec_impl.cpp:50-89).

    ``seq[0]`` consumes the start operator; the remaining T−1 symbols go
    ``level`` at a time through ``chunk_fn(v, tuple_index, operands)``
    (tuple index = radix-``emit_num`` encoding, earliest symbol least
    significant); the final ``(T−1) mod level`` symbols go through
    ``tail_fn(v, symbol, operands)``. Used by both the dense and the
    structured specializers so the chunking semantics cannot diverge.

    ``operands`` (a pytree of device arrays) is threaded through as a jit
    ARGUMENT — closing over it would bake hundreds of MB of operator data
    into the compiled program as constants. ``operands_fn`` defers the
    operand fetch to call time (lazy cache→device upload).
    """

    @jax.jit
    def decode(seq, operands):
        v = start_fn(seq[0], operands)
        rest = seq[1:]
        t_rest = rest.shape[0]
        n_full = t_rest // level
        tail = t_rest - n_full * level

        if n_full > 0:
            chunks = rest[: n_full * level].reshape(n_full, level)
            radix = emit_num ** jnp.arange(level, dtype=jnp.int32)
            idxs = jnp.sum(chunks * radix[None, :], axis=1)
            v, _ = jax.lax.scan(
                lambda v, i: (chunk_fn(v, i, operands), None), v, idxs
            )

        if tail > 0:
            v, _ = jax.lax.scan(
                lambda v, o: (tail_fn(v, o, operands), None),
                v,
                rest[n_full * level :],
            )
        return v

    if operands_fn is None:
        return lambda seq: decode(seq, operands)
    return lambda seq: decode(seq, operands_fn())


class SpecializedViterbi:
    """Re-specializable specialized decoder (``Viterbi_spec_impl`` parity).

    ``level`` is the number of observation handlers combined into one
    operator (``Viterbi_spec_impl.h:20-23``). Memory for tuple operators is
    ``(emit_num+1)^level · Np² · 4`` bytes (the +1 is the identity padding
    symbol, ``_build_level1``) — the same wall that limits the reference's
    GPU backends to level 1 on the 20-symbol corpus
    (``bench_Viterbi_spec.h:37-47``); :meth:`spec_memory_bytes` lets callers
    apply the same policy deliberately.
    """

    def __init__(
        self,
        level: int = 1,
        use_pallas: bool | None = None,
        pad: bool = True,
        cache: "OperatorCache | None" = None,
    ):
        if level < 1:
            raise ValueError("level must be >= 1 (Viterbi_spec_impl.h:20-23)")
        self.level = level
        self.pad = pad
        self.cache = cache
        # use_pallas gates only the fused-kernel delegate (False pins the
        # XLA paths — the cross-validating independent implementation);
        # dense tropical algebra is always XLA (ops/dispatch.py rationale)
        self._explicit_pallas = use_pallas
        self._specialized = False
        self.start_ops = None  # [E, Np]
        self.ops = None  # [E, Np, Np]
        self.tuple_ops = None  # [E^level, Np, Np]
        self.states_num = 0
        self.emit_num = 0
        # At level 1 the specialized operator stack is exactly the HMM's
        # transition structure with emissions folded in — the structured
        # decoder (kernel or XLA scan) realizes it directly, so run_spec
        # delegates to it when available. Level > 1 keeps dense
        # tuple operators (the reference's own spec story; profitable for
        # small/dense models, memory-walled for the 20-symbol corpus,
        # bench_Viterbi_spec.h:37-47).
        self._delegate = None

    def get_level(self) -> int:
        return self.level

    @staticmethod
    def spec_memory_bytes(states_num: int, emit_num: int, level: int) -> int:
        # +1: the identity padding symbol joins the tuple radix
        np_states = pad_to_lane(states_num)
        return ((emit_num + 1) ** level) * np_states * np_states * 4

    @staticmethod
    def predicted_dense_decode_slowdown(states_num: int, level: int) -> float:
        """Predicted batched-decode slowdown of the dense level-L gather
        path vs :class:`StructuredSpecializedViterbi` at the same level.

        Both paths are memory-bound per chunk step: the dense path streams
        each lane's ``[Np, Np]`` tuple operator, the structured path
        streams ``6·level + 2`` component ``[Np]`` vectors per lane (the
        slot growth of ``structured_compose``). The byte ratio
        ``Np / (6·level + 2)`` is the slowdown model."""
        if level <= 1:
            return 1.0
        return pad_to_lane(states_num) / (6 * level + 2)

    def spec_with(self, hmm: HMM) -> None:
        """(Re)build all specialized operators for ``hmm``.

        Mirrors ``spec_with = deleter(); initializer(hmm, level)``
        (``GraphBLAS_spec_impl.cpp:45-48``): previous operators are dropped
        before the new ones are built.
        """
        self._specialized = False
        self.start_ops = self.ops = self.tuple_ops = None
        self.states_num = hmm.states_num
        self.emit_num = hmm.emit_num

        # Footgun guard: at level > 1 on a big model the dense per-lane
        # [B, Np, Np] tuple gather streams far more bytes than the
        # structured specializer. Warn when the bandwidth model predicts
        # ≥10×; this class stays available as the cross-validating second
        # implementation.
        slowdown = self.predicted_dense_decode_slowdown(
            hmm.states_num, self.level
        )
        if slowdown >= 10.0:
            warnings.warn(
                f"dense level-{self.level} specialization at "
                f"{hmm.states_num} states: batched decode streams a dense "
                f"[Np, Np] operator per lane-step — predicted ≥{slowdown:.0f}× "
                "slower than StructuredSpecializedViterbi at the same level. Use "
                "spec_viterbi.StructuredSpecializedViterbi unless you "
                "need the dense path for cross-validation.",
                stacklevel=2,
            )

        np_states = pad_to_lane(hmm.states_num) if self.pad else hmm.states_num

        # At level 1, a structured-eligible HMM decodes through the
        # structured/fused path, which precomputes its own (tiny) operator
        # vectors — building and caching the dense [E, Np, Np] stack would
        # only pin ~E·Np²·4 bytes of HBM that run_spec never touches.
        self._delegate = None
        if self.level == 1 and self.pad:
            from spec_viterbi.models.decoder import ViterbiDecoder

            # an explicit use_pallas=False must reach the delegate (it
            # gates the fused Pallas kernel inside ViterbiDecoder)
            dec = ViterbiDecoder(
                hmm,
                mode="structured",
                use_pallas=self._explicit_pallas,
            ) if self._explicit_pallas is False else ViterbiDecoder(hmm, mode="auto")
            if dec.mode == "structured":
                self._delegate = dec
                self._specialized = True
                return

        cached = None
        if self.cache is not None:
            cached = self.cache.load(
                hmm.fingerprint(), self.level, np_states, kind="dense"
            )
        # "ops_id" (identity-slot format) — entries without it predate the
        # identity padding symbol and are rebuilt
        if cached is not None and "ops_id" in cached:
            start_ops = jnp.asarray(cached["start_ops"])
            ops = jnp.asarray(cached["ops_id"])
            # level 1's tuple_ops ARE the level-1 ops (not stored twice)
            tuple_ops = (
                jnp.asarray(cached["tuple_ops"]) if "tuple_ops" in cached else ops
            )
        else:
            a_t = jnp.asarray(hmm.transposed_transition_matrix(pad_to=np_states))
            pi = jnp.asarray(hmm.start_vector(pad_to=np_states))
            em = jnp.asarray(hmm.emission_matrix(pad_to=np_states))

            start_ops, ops = _build_level1(a_t, pi, em)
            tuple_ops = ops
            if self.level > 1:
                ops_t = jnp.transpose(ops, (0, 2, 1))
                for _ in range(self.level - 1):
                    tuple_ops = _add_level(ops_t, tuple_ops)
            if self.cache is not None:
                arrays = {
                    "start_ops": np.asarray(start_ops),
                    "ops_id": np.asarray(ops),
                }
                if self.level > 1:
                    arrays["tuple_ops"] = np.asarray(tuple_ops)
                self.cache.store(
                    hmm.fingerprint(), self.level, np_states, arrays, kind="dense"
                )

        self.start_ops = start_ops
        self.ops = ops
        self.tuple_ops = tuple_ops
        self._decode = make_chunked_decode(
            self.level,
            self.emit_num + 1,  # identity padding symbol joins the radix
            start_fn=lambda o, ops3: ops3[0][o],
            chunk_fn=lambda v, i, ops3: dispatch.step_mv(ops3[2][i], v),
            tail_fn=lambda v, o, ops3: dispatch.step_mv(ops3[1][o], v),
            operands=(start_ops, ops, tuple_ops),
        )
        self._build_decode_batch(start_ops, ops, tuple_ops)
        self._specialized = True

    def _build_decode_batch(self, start_ops, ops, tuple_ops):
        """Batched chunked decode over per-lane dense-operator gathers —
        the dense mirror of ``spec_structured.decode_batch_uniform``
        (``run_spec_batch`` is never a host loop).

        Each chunk step gathers every lane's tuple operator
        (``tuple_ops[idx_b]`` → [B, Np, Np], the batched analog of
        ``precalc_obs_handlers.at(tuple)``, GraphBLAS_spec_impl.cpp:67-81)
        and applies one broadcast tropical matvec; sequential step count is
        T/level like the scalar path, with the per-step operator read
        amortized over nothing (each lane needs its own operator — the
        cost model that makes the FACTORED structured form the production
        path).
        """
        level, radix_e = self.level, self.emit_num + 1

        @jax.jit
        def decode_batch_uniform(seqs_t, operands):
            start_ops, ops, tuple_ops = operands
            v = start_ops[seqs_t[0]].T  # [Np, B]
            rest = seqs_t[1:]
            n_full = rest.shape[0] // level
            tail = rest.shape[0] - n_full * level

            def apply_gathered(v, g):
                # g [B, Np, Np] per-lane operators; v [Np, B] carry
                return jnp.min(g + v.T[:, None, :], axis=2).T

            if n_full:
                chunks = rest[: n_full * level].reshape(n_full, level, -1)
                radix = radix_e ** jnp.arange(level, dtype=jnp.int32)
                idxs = jnp.sum(chunks * radix[None, :, None], axis=1)  # [n_full, B]
                v, _ = jax.lax.scan(
                    lambda v, i: (apply_gathered(v, tuple_ops[i]), None), v, idxs
                )
            if tail:
                v, _ = jax.lax.scan(
                    lambda v, o: (apply_gathered(v, ops[o]), None),
                    v,
                    rest[n_full * level :],
                )
            return v.T

        operands = (start_ops, ops, tuple_ops)
        self._decode_batch_uniform = lambda seqs_t: decode_batch_uniform(
            seqs_t, operands
        )
        # per-lane gathers materialize [B, Np, Np]; cap lanes per call so
        # one scan step stays within a fixed HBM transient budget
        n = int(ops.shape[1])
        self._batch_lane_cap = max(1, int((1 << 30) // (n * n * 4)))

    def run_spec(self, seq: np.ndarray) -> np.ndarray:
        """``run_Viterbi_spec`` parity: final score vector for one sequence."""
        if not self._specialized:
            raise RuntimeError("call spec_with(hmm) before run_spec(seq)")
        if self._delegate is not None:
            return self._delegate.decode(seq)
        seq = jnp.asarray(validate_obs_seq(seq, self.emit_num))
        v = self._decode(seq)
        return np.asarray(v[: self.states_num])

    def run_spec_batch(self, seqs: list[np.ndarray]) -> list[np.ndarray]:
        """Batched specialized decode (DP extension of run_Viterbi_spec).

        Level 1 rides the batched structured/fused path; higher levels run
        the batched chunked scan over per-lane tuple-operator gathers
        (:meth:`_build_decode_batch`), bucketed by exact length so the
        chunk/tail boundaries stay positionally aligned, and lane-chunked
        so the [B, Np, Np] gather transient fits a fixed budget.
        """
        if not self._specialized:
            raise RuntimeError("call spec_with(hmm) before run_spec_batch")
        if self._delegate is not None:
            return self._delegate.decode_batch(seqs)
        if not seqs:
            return []
        from spec_viterbi.utils.batching import quantize_t

        e = self.emit_num
        level = self.level
        # Compiled-shape bounding: ragged workloads would otherwise compile
        # one program per distinct (T, lanes) pair. Sequences group by
        # QUANTIZED length and pad to it with the identity symbol (index E
        # — an exact no-op step, _build_level1), and lane counts round up
        # to powers of two (pad lanes repeat the group's first sequence
        # and are discarded). Each tail symbol gets a chunk of its own
        # (``[o, E, …, E]`` is exactly the level-1 operator of ``o``), so
        # the batch applies the same operators in the same order as
        # ``run_spec``'s tail loop and the floats agree bit for bit.
        seqs = [validate_obs_seq(s, e) for s in seqs]
        laid = []
        for s in seqs:
            n_full = (len(s) - 1) // level
            head = s[: 1 + n_full * level]
            tail = [np.full(level, e, np.int32) for _ in s[1 + n_full * level :]]
            for chunk, o in zip(tail, s[1 + n_full * level :]):
                chunk[0] = o
            laid.append(np.concatenate([head, *tail]).astype(np.int32))
        out: list[np.ndarray | None] = [None] * len(seqs)
        by_tq: dict[int, list[int]] = {}
        for i, s in enumerate(laid):
            by_tq.setdefault(quantize_t(len(s)), []).append(i)
        cap = self._batch_lane_cap
        for t_q, idxs in sorted(by_tq.items()):
            for k in range(0, len(idxs), cap):
                part = idxs[k : k + cap]
                b = len(part)
                b_pad = min(cap, 1 << (b - 1).bit_length())
                cols = [
                    np.concatenate(
                        [laid[i], np.full(t_q - len(laid[i]), e, np.int32)]
                    )
                    for i in part
                ]
                cols += [cols[0]] * (b_pad - b)
                batch = np.stack(cols, axis=1)  # [t_q, b_pad]
                v = np.asarray(self._decode_batch_uniform(jnp.asarray(batch)))
                for j, i in enumerate(part):
                    out[i] = v[j, : self.states_num]
        return out
