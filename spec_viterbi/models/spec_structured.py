"""Level-L specialization with structured (diag + rank-1) tuple operators.

Same API as :class:`~spec_viterbi.models.specializer.SpecializedViterbi`
(``spec_with`` / ``run_Viterbi_spec`` parity, ``Viterbi_spec_impl.h:6-24``)
but tuple operators are stored as O(N) component vectors via the tropical
closure in :mod:`spec_viterbi.ops.structured_compose` — level-L memory
is ``E^L · components · N`` floats instead of the reference's dense
``E^L · N²`` (the wall that limits its GPU backends to level 1,
``bench_Viterbi_spec.h:37-47``). On the Pfam corpus level 2 shrinks from
9.3 GB to ~23 MB.

Decode consumes ``seq[1:]`` in chunks of ``level`` through the composed
components (one gather of a few [N] vectors per chunk instead of one dense
[N,N] matrix), with the reference's tail handling
(``GraphBLAS_spec_impl.cpp:64-89``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from spec_viterbi.hmm import HMM, pad_to_lane, validate_obs_seq
from spec_viterbi.ops import structured_compose as sc
from spec_viterbi.ops.structured import StructuredOperator

INF = np.float32(np.inf)


class StructuredSpecializedViterbi:
    """Re-specializable level-L decoder over structured tuple operators.

    Two decode realizations cross-validate (the reference's multi-backend
    role, ``test_semantic_equality.cpp:19-98``):

    - **composed**: the stored level-L component vectors (diag stacks +
      rank-1 u/w) gathered per tuple index and applied — the direct
      materialization of ``precalc_obs_handlers.at(tuple) ⊗ v``
      (``GraphBLAS_spec_impl.cpp:64-81``). Runs everywhere; the batched
      form gathers per-lane tuples.
    - **fused** (GPU, fused-eligible operators): the tuple operator applied
      in *factored* form — the level-1 structured operators applied
      ``level`` times per tuple inside the whole-sequence kernel. Composing
      squares the dense row/col interactions (each level-2 tuple needs two
      extra full column reductions to save one intermediate carry), so
      the factored form does less work per symbol. Factored application
      is also bit-identical to the non-specialized order, so
      spec-vs-non-spec equality is exact rather than ±1.0.
    """

    def __init__(
        self,
        level: int = 1,
        use_pallas: bool | None = None,
        cache: "OperatorCache | None" = None,
    ):
        if level < 1:
            raise ValueError("level must be >= 1 (Viterbi_spec_impl.h:20-23)")
        self.level = level
        self._explicit_pallas = use_pallas
        self.cache = cache
        self._specialized = False

    def get_level(self) -> int:
        return self.level

    @staticmethod
    def spec_memory_bytes(states_num: int, emit_num: int, level: int) -> int:
        """Upper-bound estimate: E^L tuples × component vectors × N floats.

        The slot-structured batched composition grows the rank-1 slot
        count LINEARLY per level (R' = R_b + R_a·D_a; measured on the Pfam
        corpus: 7/13/19 stored vectors per tuple at levels 1-3), so the
        per-tuple estimate is ``6·level + 2`` vectors.
        """
        vectors = 6 * level + 2
        return (emit_num**level) * vectors * pad_to_lane(states_num) * 4

    def spec_with(self, hmm: HMM) -> None:
        # deleter(); initializer(hmm, level) semantics
        # (GraphBLAS_spec_impl.cpp:45-48): drop previous operators first
        self._specialized = False
        self._fused = None
        n = pad_to_lane(hmm.states_num)
        self.n = n
        self.states_num = hmm.states_num
        self.emit_num = e = hmm.emit_num

        sop = StructuredOperator.from_hmm(hmm, pad_to=n)
        em = hmm.emission_matrix(pad_to=n)
        pi = hmm.start_vector(pad_to=n)

        cached = None
        if self.cache is not None:
            cached = self.cache.load(hmm.fingerprint(), self.level, n, kind="struct")
        if cached is not None and "l1_offsets" not in cached:
            cached = None  # foreign/old schema under this key: rebuild
        if cached is not None:
            l1_offsets = tuple(int(d) for d in cached["l1_offsets"])
            all_offsets = tuple(int(d) for d in cached["tuple_offsets"])
            dv1, uu1, ww1 = cached["dv1"], cached["uu1"], cached["ww1"]
            dv, uu, ww = cached["dv"], cached["uu"], cached["ww"]
        else:
            # batched array-form composition (structured_compose docstring):
            # level-L stacks built in whole-array NumPy ops — at level 3 on
            # the 2405-state corpus this replaces ~616k per-pair calls
            (l1_offsets, dv1, uu1, ww1), (all_offsets, dv, uu, ww) = (
                sc.batched_levels(sop, em, self.level)
            )
            if self.cache is not None:
                # background publish — the write must not double cold prep
                self._store_thread = self.cache.store_async(
                    hmm.fingerprint(),
                    self.level,
                    n,
                    {
                        "l1_offsets": np.asarray(l1_offsets, np.int64),
                        "tuple_offsets": np.asarray(all_offsets, np.int64),
                        "dv1": dv1, "uu1": uu1, "ww1": ww1,
                        "dv": dv, "uu": uu, "ww": ww,
                    },
                    kind="struct",
                )

        self.tuple_offsets = tuple(all_offsets)
        self.l1_offsets = tuple(l1_offsets)
        self.num_components = int(dv.shape[1] + uu.shape[1])
        # device upload is LAZY: cache loads are memory-mapped and the
        # fused factored path never reads the level-L stacks at all, so a
        # warm spec_with costs milliseconds; the composed decode paths
        # fault/upload the arrays on first use.
        self._arrays_host = (dv, uu, ww, dv1, uu1, ww1)
        self._arrays_dev = None
        self.start_ops = jnp.asarray(em + pi[None, :])  # [E, N]
        self._build_decode()

        # GPU + regular operator: the factored kernel for batched decode
        # (and single-sequence, unless use_pallas=False pins the composed
        # path — the independent implementation tests cross-validate with)
        self._fused = None
        if self._explicit_pallas is not False:
            from spec_viterbi.ops import fused_pallas

            if fused_pallas.gpu_kernel_available() and fused_pallas.fused_eligible(sop):
                # sequential application IS the composed operator, and
                # sharing the non-spec kernel means one compile serves both
                self._fused = fused_pallas.FusedStructuredDecoder(sop, em, pi)
        self._specialized = True

    @property
    def arrays(self):
        """Device copies of (dv, uu, ww, dv1, uu1, ww1), uploaded once on
        first use (lazy so mmap-cached loads stay cheap)."""
        if self._arrays_dev is None:
            self._arrays_dev = tuple(jnp.asarray(a) for a in self._arrays_host)
        return self._arrays_dev

    def _build_decode(self):
        tuple_offsets = self.tuple_offsets
        l1_offsets = self.l1_offsets
        level = self.level
        emit_num = self.emit_num

        def apply(offsets, dvals, u, w, v):
            # dvals [D, N], u/w [R, N], v [N]
            out = jnp.full(v.shape, jnp.inf, v.dtype)
            for k, d in enumerate(offsets):
                out = jnp.minimum(out, dvals[k] + jnp.roll(v, d))
            if u.shape[0]:
                dots = jnp.min(w + v[None, :], axis=1)  # [R]
                out = jnp.minimum(out, jnp.min(u + dots[:, None], axis=0))
            return out

        from spec_viterbi.models.specializer import make_chunked_decode

        operands_fn = lambda: (self.start_ops, *self.arrays)  # noqa: E731
        self._decode = make_chunked_decode(
            level,
            emit_num,
            start_fn=lambda o, ar: ar[0][o],
            chunk_fn=lambda v, i, ar: apply(tuple_offsets, ar[1][i], ar[2][i], ar[3][i], v),
            tail_fn=lambda v, o, ar: apply(l1_offsets, ar[4][o], ar[5][o], ar[6][o], v),
            operands_fn=operands_fn,
        )

        def apply_batch(offsets, dvb, uub, wwb, v):
            # dvb [B, D, N], uub/wwb [B, R, N] per-lane gathered tuple
            # components; v [N, B] state-major carry
            out = jnp.full(v.shape, jnp.inf, v.dtype)
            for k, d in enumerate(offsets):
                out = jnp.minimum(out, dvb[:, k, :].T + jnp.roll(v, d, axis=0))
            if uub.shape[1]:
                dots = jnp.min(wwb + v.T[:, None, :], axis=2)  # [B, R]
                cand = jnp.min(uub + dots[:, :, None], axis=1)  # [B, N]
                out = jnp.minimum(out, cand.T)
            return out

        @jax.jit
        def decode_batch_uniform(seqs_t, operands):
            """Uniform-length batched chunked decode; seqs_t [T, B] int32.

            The per-chunk tuple index is per-lane ([B]); the chunk applies
            each lane's gathered component vectors — the batched analog of
            ``precalc_obs_handlers.at(tuple)`` (GraphBLAS_spec_impl.cpp:67-81)
            with the same positional chunk/tail split as the scalar path.
            """
            start_ops, dv, uu, ww, dv1, uu1, ww1 = operands
            v = start_ops[seqs_t[0]].T  # [N, B]
            rest = seqs_t[1:]
            t_rest = rest.shape[0]
            n_full = t_rest // level
            tail = t_rest - n_full * level
            if n_full:
                chunks = rest[: n_full * level].reshape(n_full, level, -1)
                radix = emit_num ** jnp.arange(level, dtype=jnp.int32)
                idxs = jnp.sum(chunks * radix[None, :, None], axis=1)  # [n_full, B]
                v, _ = jax.lax.scan(
                    lambda v, i: (
                        apply_batch(tuple_offsets, dv[i], uu[i], ww[i], v),
                        None,
                    ),
                    v,
                    idxs,
                )
            if tail:
                v, _ = jax.lax.scan(
                    lambda v, o: (
                        apply_batch(l1_offsets, dv1[o], uu1[o], ww1[o], v),
                        None,
                    ),
                    v,
                    rest[n_full * level :],
                )
            return v.T

        self._decode_batch_uniform = lambda seqs_t: decode_batch_uniform(
            seqs_t, operands_fn()
        )

    def run_spec(self, seq: np.ndarray) -> np.ndarray:
        if not self._specialized:
            raise RuntimeError("call spec_with(hmm) before run_spec(seq)")
        if self._fused is not None:
            return self._fused.decode_batch([np.asarray(seq)])[0]
        seq = jnp.asarray(validate_obs_seq(seq, self.emit_num))
        v = self._decode(seq)
        return np.asarray(v[: self.states_num])

    def run_spec_batch(self, seqs: list[np.ndarray]) -> list[np.ndarray]:
        """Batched specialized decode (DP extension of ``run_Viterbi_spec``).

        On a GPU with a fused-eligible operator the whole batch rides the
        factored kernel (any raggedness handled by per-lane masks). The composed path needs positionally aligned chunk/tail
        boundaries, so it buckets lanes by exact length and decodes each
        uniform bucket as one device program.
        """
        if not self._specialized:
            raise RuntimeError("call spec_with(hmm) before run_spec_batch")
        if not seqs:
            return []
        if self._fused is not None:
            return self._fused.decode_batch(seqs)
        seqs = [validate_obs_seq(s, self.emit_num) for s in seqs]
        out: list[np.ndarray | None] = [None] * len(seqs)
        by_len: dict[int, list[int]] = {}
        for i, s in enumerate(seqs):
            by_len.setdefault(len(s), []).append(i)
        for _, idxs in sorted(by_len.items()):
            batch = np.stack([seqs[i] for i in idxs], axis=1)  # [T, b]
            v = np.asarray(self._decode_batch_uniform(jnp.asarray(batch)))
            for j, i in enumerate(idxs):
                out[i] = v[j, : self.states_num]
        return out
