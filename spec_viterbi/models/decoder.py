"""Non-specialized Viterbi decoding.

API parity target: ``Viterbi_impl::run_Viterbi(hmm, seq) -> Mod_prob_vec_t``
(``Viterbi_impl/Viterbi_impl.h:6-11``): returns the final per-state −log2
score vector. The recurrence (``CUSP_impl.cu:13-20``) is a ``lax.scan`` over
observation symbols with a fused (min,+) matvec per step — the reference's
two sparse matvecs per step, with the emission-diagonal product folded
into an elementwise add (``diag(e) ⊗ u = e + u`` in log space).

Batched decode (our DP extension, SURVEY.md §2.9) advances all sequences of
a dataset at once: ``U = V ⊗ A`` reads the transition operator from HBM once
per step for the whole batch, which is the bandwidth-optimal formulation for
the many-sequence workloads (``emit_50_3500_20.ess``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spec_viterbi.hmm import HMM, pad_to_lane, validate_obs_seq
from spec_viterbi.ops import dispatch
from spec_viterbi.ops import fused_pallas
from spec_viterbi.utils.batching import bucket_plan, pad_batch
from spec_viterbi.ops.structured import (
    StructuredOperator,
    structured_mv,
    structured_mv_argmin,
    structured_mv_batch,
)
from spec_viterbi.utils.device import path_budget_bytes

SUBLANE = 8  # lane-padding quantum of the XLA batch programs


@dataclasses.dataclass(frozen=True)
class DeviceHMM:
    """HMM materialized as dense, lane-padded device arrays.

    ``a_t`` is the transposed transition operator the recurrence multiplies
    by (built like ``GraphBLAS_impl.cpp:38-45``); ``a`` is the untransposed
    matrix used by the batched right-multiplication form. Padding states
    carry +inf everywhere, so they stay at the semiring zero through any
    number of steps and are sliced off on extraction (the reference likewise
    fills absent entries with inf, ``GraphBLAS_helper.cpp:65-68``).
    """

    a_t: jax.Array  # [Np, Np]
    a: jax.Array  # [Np, Np]
    pi: jax.Array  # [Np]
    emissions: jax.Array  # [E, Np]
    states_num: int
    padded: int

    @classmethod
    def from_hmm(cls, hmm: HMM, pad: bool = True, dense: bool = True) -> "DeviceHMM":
        """``dense=False`` skips the [Np, Np] transition uploads (structured
        mode reads only emissions/π — 2×23 MB saved on the big models)."""
        np_states = pad_to_lane(hmm.states_num) if pad else hmm.states_num
        if dense:
            a = hmm.transition_matrix(pad_to=np_states)
            a_t, a_d = jnp.asarray(a.T.copy()), jnp.asarray(a)
        else:
            a_t = a_d = None
        return cls(
            a_t=a_t,
            a=a_d,
            pi=jnp.asarray(hmm.start_vector(pad_to=np_states)),
            emissions=jnp.asarray(hmm.emission_matrix(pad_to=np_states)),
            states_num=hmm.states_num,
            padded=np_states,
        )


@jax.jit
def _decode_scores(a_t, pi, em, seq):
    v0 = em[seq[0]] + pi

    def step(v, o):
        u = dispatch.step_mv(a_t, v)
        return em[o] + u, None

    v, _ = jax.lax.scan(step, v0, seq[1:])
    return v


@jax.jit
def _decode_scores_and_path(a_t, pi, em, seq):
    v0 = em[seq[0]] + pi

    def step(v, o):
        u, idx = dispatch.step_mv_argmin(a_t, v)
        return em[o] + u, idx

    v, ptrs = jax.lax.scan(step, v0, seq[1:])  # ptrs: [T-1, Np]

    last = jnp.argmin(v).astype(jnp.int32)

    def back(state, ptr_row):
        prev = ptr_row[state]
        return prev, prev

    _, rev_path = jax.lax.scan(back, last, ptrs, reverse=True)
    path = jnp.concatenate([rev_path, last[None]])
    return v, path


@jax.jit
def _decode_scores_batch(a, pi, em, seqs, lengths):
    """seqs: [B, Tmax] int32 (padded), lengths: [B]. Returns [B, Np].

    The carry is kept state-major ([Np, B]) so each step is one TN tropical
    matmul that reads the transition operator from HBM exactly once for the
    whole batch — the bandwidth-optimal DP formulation.
    """
    em_t = em.T  # [Np, E]
    v_t = em_t[:, seqs[:, 0]] + pi[:, None]

    def step(carry, xs):
        o_t, t = xs
        u_t = dispatch.batch_step_t(a, carry)
        v_new = em_t[:, o_t] + u_t
        keep = (t < lengths)[None, :]
        return jnp.where(keep, v_new, carry), None

    ts = jnp.arange(1, seqs.shape[1])
    v_t, _ = jax.lax.scan(step, v_t, (seqs[:, 1:].T, ts))
    return v_t.T


class ViterbiDecoder:
    """Non-specialized decoder; the counterpart of the reference's
    ``*_impl`` classes. Where the reference ships three backends
    (GraphBLAS/CUSP/cuASR) this class exposes independent execution paths
    that cross-validate the same way:

    - ``"dense"``       — jnp/XLA dense tropical algebra (works anywhere;
      the cuASR-analog backend, see ``ops/dispatch.py``),
    - ``"structured"``  — diagonal/row/col-decomposed operator
      (:mod:`spec_viterbi.ops.structured`), O((D+R+C)·N) per step
      instead of O(N²) — the answer to the reference's sparse backends.
      On a GPU, fused-eligible operators run batched scores and paths
      through the whole-sequence kernel (:mod:`~spec_viterbi.ops.
      fused_pallas`); elsewhere through the XLA structured scan.

    ``mode="auto"`` picks structured when the decomposition is effective
    (cost ratio < 1/8 of dense), else dense. ``use_pallas=False`` pins the
    XLA scan; ``interpret=True`` runs the kernel in the Pallas interpreter
    (CPU tests) — the only way the kernel runs off a GPU.
    """

    MODES = ("auto", "dense", "structured")

    def __init__(
        self,
        hmm: HMM,
        use_pallas: bool | None = None,
        pad: bool = True,
        mode: str = "auto",
        interpret: bool = False,
    ):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        self.hmm = hmm
        self._use_pallas = use_pallas
        self.interpret = interpret

        padded = pad_to_lane(hmm.states_num) if pad else hmm.states_num
        self._sop = None
        self._sop_arrs = None
        if mode in ("auto", "structured"):
            sop = StructuredOperator.from_hmm(hmm, pad_to=padded)
            if mode == "structured" or sop.cost_ratio() < 0.125:
                self._sop = sop
                self._sop_arrs = sop.device_arrays()
                mode = "structured"
            else:
                mode = "dense"
        self.mode = mode
        # structured mode never reads the dense [Np, Np] operators — skip
        # materializing/uploading 2×23 MB per decoder on the big models
        self.dev = DeviceHMM.from_hmm(hmm, pad=pad, dense=mode != "structured")
        self._fused = None
        if mode == "structured":
            self._build_structured_fns()
            # the whole-sequence kernel where it is compiled for (a GPU,
            # or the interpreter on request) — unless ``use_pallas=False``
            # pins the XLA structured scan, the independent cross-check
            if (
                use_pallas is not False
                and (interpret or fused_pallas.gpu_kernel_available())
                and fused_pallas.fused_eligible(self._sop)
            ):
                self._fused = fused_pallas.FusedStructuredDecoder(
                    self._sop,
                    hmm.emission_matrix(pad_to=padded),
                    hmm.start_vector(pad_to=padded),
                    interpret=interpret,
                )

    # ---- structured-mode jitted closures (static decomposition) ---------

    def _build_structured_fns(self):
        # NOTE: these bodies deliberately DUPLICATE the dense scan/backtrace
        # skeletons (_decode_scores*) rather than sharing them — dense and
        # structured are independent implementations that cross-validate in
        # tests/test_semantic_equality.py, the same role the reference's
        # separate backends play (test_semantic_equality.cpp:19-98). A
        # shared skeleton would let one bug hide in both.
        # Operator value arrays are threaded through jit as ARGUMENTS, not
        # closure constants baked into every compiled program.
        sop = self._sop

        @jax.jit
        def decode(em, pi, seq, arrs):
            v0 = em[seq[0]] + pi

            def step(v, o):
                return em[o] + structured_mv(sop, arrs, v), None

            v, _ = jax.lax.scan(step, v0, seq[1:])
            return v

        @jax.jit
        def decode_path(em, pi, seq, arrs):
            v0 = em[seq[0]] + pi

            def step(v, o):
                u, idx = structured_mv_argmin(sop, arrs, v)
                return em[o] + u, idx

            v, ptrs = jax.lax.scan(step, v0, seq[1:])
            last = jnp.argmin(v).astype(jnp.int32)

            def back(state, ptr_row):
                prev = ptr_row[state]
                return prev, prev

            _, rev_path = jax.lax.scan(back, last, ptrs, reverse=True)
            return v, jnp.concatenate([rev_path, last[None]])

        @jax.jit
        def decode_batch(em_t, pi, seqs_t, lengths, arrs):
            v_t = em_t[:, seqs_t[0]] + pi[:, None]

            def step(carry, xs):
                o_t, t = xs
                u_t = structured_mv_batch(sop, arrs, carry)
                v_new = em_t[:, o_t] + u_t
                keep = (t < lengths)[None, :]
                return jnp.where(keep, v_new, carry), None

            ts = jnp.arange(1, seqs_t.shape[0])
            v_t, _ = jax.lax.scan(step, v_t, (seqs_t[1:], ts))
            return v_t.T

        mv_argmin = jax.vmap(
            lambda arrs, v: structured_mv_argmin(sop, arrs, v),
            in_axes=(None, 1),
            out_axes=1,
        )

        @jax.jit
        def decode_path_batch(em_t, pi, seqs_t, lengths, arrs):
            """Batched path scan: (scores [B, Np], paths [B, T]).

            Frozen steps (past a lane's length) store identity pointers,
            so the backtrace through padding stays on the end state."""
            v_t = em_t[:, seqs_t[0]] + pi[:, None]
            n = v_t.shape[0]
            iota = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
            bp_dtype = jnp.int16 if n <= np.iinfo(np.int16).max else jnp.int32

            def step(carry, xs):
                o_t, t = xs
                u_t, src = mv_argmin(arrs, carry)
                keep = (t < lengths)[None, :]
                v_new = jnp.where(keep, em_t[:, o_t] + u_t, carry)
                return v_new, jnp.where(keep, src, iota).astype(bp_dtype)

            ts = jnp.arange(1, seqs_t.shape[0])
            v_t, ptrs = jax.lax.scan(step, v_t, (seqs_t[1:], ts))
            last = jnp.argmin(v_t, axis=0).astype(jnp.int32)

            def back(state, ptr):
                prev = jnp.take_along_axis(ptr, state[None, :], axis=0)[0]
                prev = prev.astype(jnp.int32)
                return prev, prev

            _, rev = jax.lax.scan(back, last, ptrs, reverse=True)
            return v_t.T, jnp.concatenate([rev, last[None]], axis=0).T

        arrs = self._sop_arrs
        self._s_decode_path_batch = lambda em_t, pi, st, ln: decode_path_batch(
            em_t, pi, st, ln, arrs
        )
        self._s_decode = lambda em, pi, seq: decode(em, pi, seq, arrs)
        self._s_decode_path = lambda em, pi, seq: decode_path(em, pi, seq, arrs)
        self._s_decode_batch = lambda em_t, pi, st, ln: decode_batch(
            em_t, pi, st, ln, arrs
        )

    def decode(self, seq: np.ndarray) -> np.ndarray:
        """``run_Viterbi`` parity: final score vector for one sequence."""
        if self._fused is not None:
            return self.decode_batch([np.asarray(seq)])[0]
        seq = jnp.asarray(validate_obs_seq(seq, self.hmm.emit_num))
        if self.mode == "structured":
            v = self._s_decode(self.dev.emissions, self.dev.pi, seq)
        else:
            v = _decode_scores(self.dev.a_t, self.dev.pi, self.dev.emissions, seq)
        return np.asarray(v[: self.dev.states_num])

    def decode_path(self, seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(scores, path) — backtrace extension (not in the reference)."""
        if self._fused is not None:
            return self.decode_path_batch([np.asarray(seq)])[0]
        seq = jnp.asarray(validate_obs_seq(seq, self.hmm.emit_num))
        if self.mode == "structured":
            v, path = self._s_decode_path(self.dev.emissions, self.dev.pi, seq)
        else:
            v, path = _decode_scores_and_path(
                self.dev.a_t, self.dev.pi, self.dev.emissions, seq
            )
        return np.asarray(v[: self.dev.states_num]), np.asarray(path)

    def decode_path_batch(
        self, seqs: list[np.ndarray]
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """(scores, path) per sequence, oracle-exact tie-breaking.

        The kernel (or, elsewhere, the batched XLA path scan) decodes the
        batch with device-resident backpointers, bucketed by length and
        lane-chunked so every call fits the device's backpointer budget.
        Dense-mode decoders, and sequences whose one-lane backpointers
        exceed the budget, decode one at a time.
        """
        if not seqs:
            return []
        t_max = max(len(s) for s in seqs)
        if self._fused is not None and self._fused.path_supported(t_max):
            return self._fused.decode_path_batch(seqs)
        if self.mode != "structured" or not self._xla_path_fits(t_max, 1):
            return [self.decode_path(s) for s in seqs]
        seqs = [validate_obs_seq(s, self.hmm.emit_num) for s in seqs]
        plan = bucket_plan([len(s) for s in seqs], lane_block=SUBLANE) or [
            (list(range(len(seqs))), t_max)
        ]
        calls = []
        for idx, t_q in plan:
            if not self._xla_path_fits(t_q, 1):
                t_q = max(len(seqs[i]) for i in idx)
            lanes = len(idx)
            while lanes > 1 and not self._xla_path_fits(t_q, lanes):
                lanes = (lanes + 1) // 2
            calls += [(idx[k : k + lanes], t_q) for k in range(0, len(idx), lanes)]
        outs = []
        for idx, t_q in calls:  # enqueue every call, drain below
            st, ln = self.prepare_batch([seqs[i] for i in idx], t_pad=t_q)
            outs.append(
                self._s_decode_path_batch(self.dev.emissions.T, self.dev.pi, st, ln)
            )
        result: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(seqs)
        for (idx, _), (scores, paths) in zip(calls, outs):
            scores, paths = np.asarray(scores), np.asarray(paths)
            for row, i in enumerate(idx):
                result[i] = (
                    scores[row, : self.dev.states_num],
                    paths[row, : len(seqs[i])].astype(np.int32),
                )
        return result

    def _xla_path_fits(self, t: int, lanes: int) -> bool:
        """Whether one batched XLA path call fits the backpointer budget."""
        budget = path_budget_bytes()
        if budget is None:
            return True
        b_pad = -(-lanes // SUBLANE) * SUBLANE
        itemsize = 2 if self.dev.padded <= np.iinfo(np.int16).max else 4
        return max(0, t - 1) * self.dev.padded * b_pad * itemsize <= budget

    def streaming(self, interpret: bool = False):
        """The streaming decode engine for this model: ``stream_begin`` /
        ``stream_feed`` / ``stream_scores`` for constant-memory scores over
        unbounded input, and the ``stream_*_path`` family for exact paths
        via checkpoint + rematerialize (long-context extension; the
        reference requires whole sequences in memory, ``Viterbi_impl.h:8``).

        Works for EVERY model. The decoder's kernel engine serves streams
        where it exists (a GPU, or a decoder built with ``interpret=True``);
        ``interpret=True`` here asks for an interpret-mode kernel engine on
        its own. Everything else — other backends, irregular operators,
        dense-mode decoders, ``use_pallas=False`` pins — gets the XLA
        structured engine
        (:class:`~spec_viterbi.models.streaming_xla.XLAStreamDecoder`),
        which implements the same protocol on the ``structured_mv_batch``
        scan. Persisted stream states load only into the engine that wrote
        them (``stream_load`` rejects the other's).
        """
        if self._fused is not None:
            return self._fused
        sop = self._sop
        if interpret and self._use_pallas is not False and sop is not None and (
            fused_pallas.fused_eligible(sop)
        ):
            cached = getattr(self, "_stream_engine", None)
            if cached is None:
                n = sop.n
                cached = fused_pallas.FusedStructuredDecoder(
                    sop,
                    self.hmm.emission_matrix(pad_to=n),
                    self.hmm.start_vector(pad_to=n),
                    interpret=True,
                )
                self._stream_engine = cached
            return cached
        # universal fallback: any operator (dense-mode decoders build the
        # decomposition on demand — from_hmm always yields a valid one,
        # worst case all-residual)
        cached = getattr(self, "_stream_engine_xla", None)
        if cached is None:
            from spec_viterbi.models.streaming_xla import XLAStreamDecoder

            if sop is None:
                sop = StructuredOperator.from_hmm(self.hmm, pad_to=self.dev.padded)
            cached = XLAStreamDecoder(
                sop,
                self.hmm.emission_matrix(pad_to=sop.n),
                self.hmm.start_vector(pad_to=sop.n),
            )
            self._stream_engine_xla = cached
        return cached

    def prepare_batch(self, seqs: list[np.ndarray], t_pad: int | None = None):
        """Pad and transfer a batch once; returns a device-side handle.

        Splitting prepare from run lets callers amortize host↔device
        transfer across repeated decodes (the benchmark's timed unit is
        then pure device compute, mirroring the reference whose sequence
        symbols live in host RAM outside the timed loop). ``t_pad`` forces
        a fixed (bucket-quantized) time length for compiled-shape reuse.
        """
        if self._fused is not None:
            return self._fused.prepare(seqs, t_pad=t_pad)
        seqs = [validate_obs_seq(s, self.hmm.emit_num) for s in seqs]
        batch, lengths = pad_batch(seqs, SUBLANE, t_pad=t_pad)
        if self.mode == "structured":
            return jnp.asarray(batch.T.copy()), jnp.asarray(lengths)
        return jnp.asarray(batch), jnp.asarray(lengths)

    def run_batch(self, handle) -> "jax.Array":
        """Decode a prepared batch; returns [B, Np] device scores."""
        if self._fused is not None:
            return self._fused.run_prepared(handle)
        seqs_d, lengths_d = handle
        if self.mode == "structured":
            return self._s_decode_batch(
                self.dev.emissions.T, self.dev.pi, seqs_d, lengths_d
            )
        return _decode_scores_batch(
            self.dev.a, self.dev.pi, self.dev.emissions, seqs_d, lengths_d
        )

    def decode_batch(
        self, seqs: list[np.ndarray], bucketed: bool = True
    ) -> list[np.ndarray]:
        """Decode a set of sequences as one batched device program.

        Pads the batch (and sequences to the max length); per-sequence
        masking freezes finished lanes so results are identical to
        one-at-a-time decoding. Ragged batches are length-bucketed on
        EVERY mode (``bucket_plan``): the decodes otherwise pad every lane
        to the global max — up to ~7× padded-step waste on the covid-19
        length profile — while bucketed
        calls run each group at its own quantized max, enqueued
        back-to-back with one device concat → one host transfer.
        """
        if not seqs:
            return []
        if self._fused is not None:
            return self._fused.decode_batch(seqs, bucketed=bucketed)
        plan = (
            bucket_plan([len(s) for s in seqs], lane_block=SUBLANE)
            if bucketed
            else None
        )
        if plan is None:
            v = np.asarray(self.run_batch(self.prepare_batch(seqs)))
            return [v[i, : self.dev.states_num] for i in range(len(seqs))]
        outs = []
        for idx, t_q in plan:  # enqueue every bucket, drain once below
            out = self.run_batch(
                self.prepare_batch([seqs[i] for i in idx], t_pad=t_q)
            )
            outs.append(out[: len(idx)])  # drop padding lanes on device
        v = np.asarray(jnp.concatenate(outs, axis=0))
        result: list[np.ndarray | None] = [None] * len(seqs)
        row = 0
        for idx, _ in plan:
            for i in idx:
                result[i] = v[row, : self.dev.states_num]
                row += 1
        return result
