"""Time-parallel single-sequence decode via the structured closure.

Batched decode's throughput comes from lane occupancy: a batch fills many
lanes, but a SINGLE sequence occupies one lane and leaves the rest idle.
This module attacks that hole by mapping TIME BLOCKS of one sequence onto
lanes:

1. **Compose** (parallel over blocks): split the T−1 recurrence steps into
   ``nb = (T−1)//k`` blocks of ``k`` symbols and build each block's
   composed operator ``M_block = M_{o_k} ⊗ … ⊗ M_{o_1}`` in the
   banded+low-rank closure of :mod:`spec_viterbi.ops.structured_compose`
   (``README.md:9-13`` associativity — the same algebra the reference's
   specializer exploits per alphabet tuple, applied across *time* of one
   concrete sequence). The composed block operator is a **band** plus
   rank-1 slots: per-step diagonals at offsets ``D`` compose into
   diagonals at the ``t``-fold sums of ``D`` — a band of static width
   ``t·span+1`` (``span = max(D) − min(D)``) — while rank-1 components
   grow linearly (``R1·k`` slots; ``R' = R_b + R_a·D_a``), never
   densifying. The Pfam match chain is the ``span = 0`` special case
   (one diagonal stays one diagonal at offset ``k·d``). All ``nb``
   blocks compose together as array ops over a ``[nb, ·, N]`` layout —
   the lanes-as-time-blocks trick.

   The composition runs as a ``lax.scan`` over the ``k−1`` steps with the
   slot/band stores padded to their final size upfront (dead slots hold
   ``+inf`` — the semiring zero — and provably stay dead through every
   product rule), so the traced program is O(1) in ``k`` (an unrolled form
   traces ~32×4 concat/min ops at ``k = 32`` and its compile time grows
   with every k of a sweep).
2. **Fold** (sequential, short): apply the ``nb`` block operators to the
   frontier in order — ``nb`` applies of O((W+R1·k)·N) work instead of
   ``T`` dependent steps. The frontier before each block is retained.
3. **Tail**: the ``(T−1) mod k`` leftover symbols run serially.
4. **Paths** (optional): rematerialize every block's backpointers in ONE
   batched pass — block b decodes from its retained frontier on lane b
   (the checkpoint/rematerialize trade of the streaming engine, applied
   across time blocks instead of stream chunks) — then backtrace across
   block boundaries.

Work accounting (the go/no-go law): compose is ``O(k·(R1·k + m·W)·N)``
per block but data-parallel over ``nb`` lanes, while fold is
``O((W+R1·k)·T/k·N)`` with k-fold fewer dependent steps than serial
decode. Serial decode is ``O(C·T·N)`` with T dependent steps. The scan
layout pays up to 2× the unrolled form's compose FLOPs (early steps carry
the full padded slot store) to bound compile time. Time-parallel can win
when the machine has idle lanes and k is small enough that the quadratic
compose term stays below the lane count; it has not been measured on the
GPU yet, which is why the scheduler routes here only on request.

Exactness: real-arithmetic scores are identical to serial decode (min
distributes over ⊗; every path's weight is the same sum). Float addition
association differs (operator values pre-combine before meeting the
frontier), so scores can drift by ulps relative to the serial kernel —
within the reference's ±1.0 contract (``HMM.h:43-49``), like the
reference's own specialization. Paths are rematerialized with the exact
serial per-step rules from the composed frontiers, so a path can differ
from the oracle only if an ulp drift crosses an argmin tie; the test
suite checks paths against the oracle.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from spec_viterbi.hmm import validate_obs_seq
from spec_viterbi.ops.structured import StructuredOperator, structured_mv
from spec_viterbi.ops.structured_compose import batched_level1

INF = np.float32(np.inf)

# Composed-band width ceiling: per compose step the band product costs
# m·W state passes over [nb, N]; past ~256 slots the compose work swamps
# the lanes it parallelizes over. Every Pfam corpus model has span = 0
# (W = 1); the cap only gates wide synthetic multi-diagonal bands.
MAX_BAND_SLOTS = 256


def _band_geometry(sop: StructuredOperator, k: int) -> tuple[int, int, int]:
    """(min_d, span, W): the composed block band after ``k`` steps holds
    offsets ``k·min_d + j`` for ``j`` in [0, W)."""
    if sop.diag_offsets:
        min_d = min(sop.diag_offsets)
        span = max(sop.diag_offsets) - min_d
    else:
        min_d, span = 0, 0
    return min_d, span, k * span + 1


def time_parallel_supported(sop: StructuredOperator, k: int = 8) -> bool:
    """Any structured operator composes in the banded+low-rank closure;
    the only gate is the composed band width ``k·span+1`` staying below
    ``MAX_BAND_SLOTS``."""
    _, _, w = _band_geometry(sop, k)
    return w <= MAX_BAND_SLOTS


def _shift(x: jnp.ndarray, d: int, axis: int = -1) -> jnp.ndarray:
    """out[..., i, ...] = x[..., i−d, ...] along ``axis``, +inf fill
    (``_shift_dst`` in jnp; static ``d``)."""
    if d == 0:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim

    def sl(lo, hi):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(lo, hi)
        return tuple(idx)

    if d > 0:
        pad[axis] = (d, 0)
        return jnp.pad(x[sl(0, n - d)], pad, constant_values=jnp.inf)
    pad[axis] = (0, -d)
    return jnp.pad(x[sl(-d, n)], pad, constant_values=jnp.inf)


def _shift_traced(x: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """_shift along the last axis by a TRACED amount (roll + validity
    mask — the scan body's only data-dependent shift)."""
    n = x.shape[-1]
    rolled = jnp.roll(x, s, axis=-1)
    iota = jnp.arange(n)
    valid = (iota >= jnp.maximum(s, 0)) & (iota < n + jnp.minimum(s, 0))
    return jnp.where(valid, rolled, jnp.inf)


class TimeParallelDecoder:
    """Single-sequence decoder that trades lane occupancy for latency.

    ``compose`` picks the block-composition schedule:

    - ``"scan"`` (default): sequential ``lax.scan`` over the k−1 steps.
      HBM traffic ≈ k × the slot store (the whole padded store is
      read+written per step).
    - ``"tree"``: pairwise merges, log2(k) levels (k must be a power of
      two). Same total FLOPs (the cross-dots term dominates both), but
      the store is touched once per LEVEL — ≈ k/log2(k) less HBM traffic,
      which matters because at production shape the store is ~400 MB and
      compose is bandwidth-bound, not compute-bound. Float association
      differs from the scan (and from serial decode) — both stay inside
      the reference's ±1.0 contract, and paths rematerialize with the
      exact serial rules either way.
    """

    def __init__(
        self,
        sop: StructuredOperator,
        emissions,
        pi,
        k: int = 8,
        compose: str = "scan",
    ):
        if not time_parallel_supported(sop, k):
            raise ValueError(
                f"composed band would exceed {MAX_BAND_SLOTS} slots at k={k} "
                "(see time_parallel_supported)"
            )
        if compose not in ("scan", "tree"):
            raise ValueError(f"compose must be 'scan' or 'tree', got {compose!r}")
        if compose == "tree" and (k & (k - 1)):
            raise ValueError(f"tree compose needs k a power of two, got {k}")
        self.compose = compose
        self.sop = sop
        self.k = int(k)
        self.n = sop.n
        self.states_num = sop.states_num
        self.emit_num = int(np.asarray(emissions).shape[0])
        self.min_d, self.span, self.w_band = _band_geometry(sop, self.k)
        offsets, dv1, uu1, ww1 = batched_level1(sop, np.asarray(emissions))
        assert offsets == tuple(sop.diag_offsets)
        self.offsets = offsets
        self.r1 = uu1.shape[1]  # rank-1 slots per level-1 operator
        self._dv1 = jnp.asarray(dv1)  # [E, m, N]
        self._uu1 = jnp.asarray(uu1)  # [E, R1, N]
        self._ww1 = jnp.asarray(ww1)  # [E, R1, N]
        self._em_t = jnp.asarray(np.asarray(emissions).T)  # [N, E]
        self._pi = jnp.asarray(np.asarray(pi))
        self._arrs = sop.device_arrays()
        self._jit_compose = jax.jit(
            self._compose if compose == "scan" else self._compose_tree
        )
        self._jit_fold = jax.jit(self._fold)

        # operator/emission arrays thread through jit as ARGUMENTS, not
        # closure constants baked into the compiled program
        @jax.jit
        def tail(em_t, arrs, v, syms):
            def step(v, o):
                return em_t[:, o] + structured_mv(sop, arrs, v), None

            v, _ = jax.lax.scan(step, v, syms)
            return v

        self._jit_tail = lambda v, syms: tail(self._em_t, self._arrs, v, syms)

        # path-remat jits are built ONCE here: defining them per decode_path
        # call would create fresh function objects and re-trace/re-compile
        # every call
        from spec_viterbi.ops.structured import structured_mv_argmin

        mv_argmin = jax.vmap(
            lambda arrs, vv: structured_mv_argmin(sop, arrs, vv),
            in_axes=(None, 1),
            out_axes=1,
        )

        @jax.jit
        def block_srcs(em_t, arrs, fronts_t, syms_t):
            """fronts_t [N, nb] lane-major frontiers; syms_t [k, nb] →
            (carry [N, nb], srcs [k, N, nb])."""

            def step(vv, o):
                u, src = mv_argmin(arrs, vv)
                return em_t[:, o] + u, src

            return jax.lax.scan(step, fronts_t, syms_t)

        self._jit_block_srcs = lambda fronts_t, syms_t: block_srcs(
            self._em_t, self._arrs, fronts_t, syms_t
        )

        @jax.jit
        def back(last, srcs_all):
            def bstep(state, src_t):
                prev = src_t[state]
                return prev, prev

            _, rev = jax.lax.scan(bstep, last, srcs_all, reverse=True)
            return rev

        self._jit_back = back

    # ---- phase 1: block-operator composition (lanes = time blocks) ------

    def _compose(self, dv1, uu1, ww1, syms):
        """syms [nb, k] → block operators (bv [nb, W, N] band, uu/ww
        [nb, R1·k, N] rank-1 slots), via ``lax.scan`` over steps 1..k−1.

        Product rules (structured_compose module docstring) with A = this
        step's level-1 operator, B = the running block operator, in the
        fixed-size padded layout: band slot ``j`` at time ``t`` holds the
        diagonal at offset ``t·min_d + j`` (composing A's diagonal ``d_i``
        shifts slot indices by ``d_i − min_d`` — static); inherited rank-1
        slots keep their w and min-merge their u over A's diagonal shifts
        and A's rank-1 dots; A's R1 rank-1 components land in slot block
        ``t`` (``dynamic_update_slice``), their w composed through B's
        band (static per-slot shifts + one traced ``t·min_d`` shift).
        Dead (+inf) slots absorb nothing and emit nothing.
        """
        k, r1, w_band = self.k, self.r1, self.w_band
        min_d, offsets = self.min_d, self.offsets
        nb, n = syms.shape[0], dv1.shape[-1]
        s_tot = r1 * k

        bv0 = jnp.full((nb, w_band, n), jnp.inf, jnp.float32)
        for i, d_i in enumerate(offsets):
            bv0 = bv0.at[:, d_i - min_d, :].set(dv1[syms[:, 0], i])
        acc_u0 = jnp.full((nb, s_tot, n), jnp.inf, jnp.float32)
        acc_w0 = jnp.full((nb, s_tot, n), jnp.inf, jnp.float32)
        if r1:
            acc_u0 = acc_u0.at[:, :r1].set(uu1[syms[:, 0]])
            acc_w0 = acc_w0.at[:, :r1].set(ww1[syms[:, 0]])

        def step(carry, xs):
            bv, acc_u, acc_w = carry
            o_t, t = xs  # o_t [nb]; t = number of operators already in B
            a_dv = dv1[o_t]  # [nb, m, N]
            a_u = uu1[o_t]  # [nb, R1, N]
            a_w = ww1[o_t]
            # Band(A) ⊗ Band(B): offset d_i lands at slot j + (d_i − min_d)
            new_bv = jnp.full_like(bv, jnp.inf)
            for i, d_i in enumerate(offsets):
                term = a_dv[:, i, None, :] + _shift(
                    _shift(bv, d_i - min_d, axis=1), d_i
                )
                new_bv = jnp.minimum(new_bv, term)
            # inherited slots: Diag(a) ⊗ Rank1(b)  ∪  Rank1(a) ⊗ Rank1(b)
            u_diag = jnp.full_like(acc_u, jnp.inf)
            for i, d_i in enumerate(offsets):
                u_diag = jnp.minimum(
                    u_diag, a_dv[:, i, None, :] + _shift(acc_u, d_i)
                )
            if r1:
                dots = jnp.min(
                    a_w[:, :, None, :] + acc_u[:, None, :, :], axis=-1
                )  # [nb, R1, S]
                u_rank = jnp.min(
                    a_u[:, :, None, :] + dots[:, :, :, None], axis=1
                )  # [nb, S, N]
                new_u = jnp.minimum(u_diag, u_rank)
                # new slots at block t: Rank1(a) ⊗ Band(b, offsets t·min_d+j)
                y = a_w[:, :, None, :] + bv[:, None, :, :]  # [nb, R1, W, N]
                z = _shift(y[:, :, 0, :], 0)
                for j in range(1, w_band):
                    z = jnp.minimum(z, _shift(y[:, :, j, :], -j))
                w_new = _shift_traced(z, -(t * min_d)) if min_d else z
                new_u = jax.lax.dynamic_update_slice(new_u, a_u, (0, t * r1, 0))
                new_w = jax.lax.dynamic_update_slice(acc_w, w_new, (0, t * r1, 0))
            else:
                new_u, new_w = u_diag, acc_w
            return (new_bv, new_u, new_w), None

        if k > 1:
            xs = (syms[:, 1:].T, jnp.arange(1, k))
            (bv, acc_u, acc_w), _ = jax.lax.scan(step, (bv0, acc_u0, acc_w0), xs)
        else:
            bv, acc_u, acc_w = bv0, acc_u0, acc_w0
        return bv, acc_u, acc_w

    def _compose_tree(self, dv1, uu1, ww1, syms):
        """syms [nb, k] → block operators via pairwise merges (log2(k)
        levels). Same output schema as :meth:`_compose` (band slot j =
        offset k·min_d + j; R1·k rank-1 slots), so ``_fold`` and the path
        remat are shared.

        Merge C = A ⊗ B (A later in time) of two t-operator composites
        (bands at offsets t·min_d + i, rank-1 slot lists):

        - band: offset sums — ``new_bv[i+j] = A_bv[i] + shift(B_bv[j],
          t·min_d + i)`` min-merged; width 2W−1.
        - B's slots keep their w; their u min-merges A's band applied to
          it with the cross term ``min_a (u_a + dot(w_a, U_s))``.
        - A's slots keep their u; their w composes through B's band
          (``min_j shift(w_a + B_bv[j], −(t·min_d+j))``); their cross
          with B's slots is already the inherited-slot term.

        Every shift amount is static (t is a Python constant per level) —
        no traced rolls at all, unlike the scan's new-slot placement.
        """
        k, r1 = self.k, self.r1
        min_d, span = self.min_d, self.span
        nb, n = syms.shape[0], dv1.shape[-1]

        # level 0: nb·k level-1 operators, band width span+1
        flat = syms.reshape(nb * k)
        bv = jnp.full((nb * k, span + 1, n), jnp.inf, jnp.float32)
        for i, d_i in enumerate(self.offsets):
            bv = bv.at[:, d_i - min_d, :].set(dv1[flat, i])
        uu = uu1[flat]  # [L, R1, N]
        ww = ww1[flat]

        t = 1
        while t < k:
            a_bv, b_bv = bv[1::2], bv[0::2]  # A later, B earlier
            a_u, b_u = uu[1::2], uu[0::2]
            a_w, b_w = ww[1::2], ww[0::2]
            w_band = bv.shape[1]  # t·span + 1
            new_w_band = 2 * w_band - 1

            # band ⊗ band (i is static: plain slice-min accumulation)
            new_bv = jnp.full((a_bv.shape[0], new_w_band, n), jnp.inf, jnp.float32)
            for i in range(w_band):
                term = a_bv[:, i, None, :] + _shift(b_bv, t * min_d + i)
                new_bv = new_bv.at[:, i : i + w_band, :].min(term)

            if r1:
                # inherited (B) slots: A's band over U_s ∪ A-slot cross
                u_band = jnp.full_like(b_u, jnp.inf)
                for i in range(w_band):
                    u_band = jnp.minimum(
                        u_band, a_bv[:, i, None, :] + _shift(b_u, t * min_d + i)
                    )
                dots = jnp.min(
                    a_w[:, :, None, :] + b_u[:, None, :, :], axis=-1
                )  # [L/2, S_A, S_B]
                cross = jnp.min(
                    a_u[:, :, None, :] + dots[:, :, :, None], axis=1
                )  # [L/2, S_B, N]
                u_inh = jnp.minimum(u_band, cross)
                # A slots: w composes through B's band (static shifts)
                y = a_w[:, :, None, :] + b_bv[:, None, :, :]  # [L/2,S_A,W,N]
                w_new = _shift(y[:, :, 0, :], -(t * min_d))
                for j in range(1, w_band):
                    w_new = jnp.minimum(
                        w_new, _shift(y[:, :, j, :], -(t * min_d + j))
                    )
                uu = jnp.concatenate([u_inh, a_u], axis=1)
                ww = jnp.concatenate([b_w, w_new], axis=1)
            else:  # purely banded: keep the (empty) slot axis paired up
                uu, ww = a_u, a_w
            bv = new_bv
            t *= 2

        # pad the band to the scan layout's k·span+1 (they are equal when
        # k is a power of two: 2^log·span + 1), slots already R1·k
        assert bv.shape[1] == self.w_band
        return bv, uu, ww

    # ---- phase 2: sequential fold over block operators ------------------

    def _fold(self, v0, bv, acc_u, acc_w):
        """Apply nb block operators in order; returns (v_final, frontiers)
        with frontiers[b] = carry BEFORE block b (for path remat)."""
        base = self.k * self.min_d  # band slot j = offset base + j (static)
        w_band = self.w_band

        def step(v, op):
            bv_b, u_b, w_b = op  # [W, N], [S, N], [S, N]
            diag = bv_b[0] + _shift(v, base)
            for j in range(1, w_band):
                diag = jnp.minimum(diag, bv_b[j] + _shift(v, base + j))
            if u_b.shape[0]:  # purely banded operators carry no rank-1 slots
                dots = jnp.min(w_b + v[None, :], axis=-1)  # [S]
                cand = jnp.min(u_b + dots[:, None], axis=0)  # [N]
                diag = jnp.minimum(diag, cand)
            return diag, v

        v, frontiers = jax.lax.scan(step, v0, (bv, acc_u, acc_w))
        return v, frontiers

    # ---- public API -----------------------------------------------------

    def plan(self, t: int) -> tuple[int, int]:
        """(full blocks, tail steps) for a T-symbol sequence."""
        nb = (t - 1) // self.k
        return nb, (t - 1) - nb * self.k

    def decode(self, seq: np.ndarray) -> np.ndarray:
        """Final score vector; time-parallel compose + fold + serial tail."""
        v, _, _, _, _ = self._decode_parts(seq)
        return np.asarray(v)[: self.states_num]

    def _decode_parts(self, seq: np.ndarray):
        seq = validate_obs_seq(seq, self.emit_num)
        t = len(seq)
        nb, tail = self.plan(t)
        seq_d = jnp.asarray(seq)
        v = self._em_t[:, seq_d[0]] + self._pi
        frontiers = None
        if nb:
            syms = seq_d[1 : 1 + nb * self.k].reshape(nb, self.k)
            ops = self._jit_compose(self._dv1, self._uu1, self._ww1, syms)
            v, frontiers = self._jit_fold(v, *ops)
        v_blocks = v  # carry after all full blocks, before the tail
        if tail:
            v = self._jit_tail(v, seq_d[1 + nb * self.k :])
        return v, frontiers, v_blocks, nb, tail

    def decode_path(self, seq: np.ndarray, engine=None):
        """(scores, path) — exact per-step rules rematerialized per block.

        ``engine``: a FusedStructuredDecoder for this operator (the
        kernel's path mode); defaults to a vmapped XLA argmin pass. Blocks decode in
        ONE batched pass from their retained frontiers (lane b = block b),
        then the backtrace threads block boundaries in reverse.
        """
        seq = validate_obs_seq(seq, self.emit_num)
        t = len(seq)
        v, frontiers, v_blocks, nb, tail = self._decode_parts(seq)
        scores = np.asarray(v)

        # per-step argmin pointers for the tail + blocks, then backtrace
        seq_d = jnp.asarray(seq)
        n = self.n
        block_srcs = self._jit_block_srcs

        pieces = []
        if nb:
            syms = np.asarray(seq[1 : 1 + nb * self.k]).reshape(nb, self.k)
            if engine is not None and n <= np.iinfo(np.int16).max:
                # the kernel's path mode, block b on lane b from its frontier;
                # its backpointers span the tile-padded state axis
                lengths = jnp.full((1, nb), self.k + 1, jnp.int32)
                _, bp = engine.scan(frontiers.T, jnp.asarray(syms.T), lengths, path=True)
                srcs_time = jnp.transpose(bp[:, :, :n], (1, 0, 2))  # [nb, k, N]
            else:
                _, srcs = block_srcs(frontiers.T, jnp.asarray(syms.T))  # [k, N, nb]
                srcs_time = jnp.transpose(srcs, (2, 0, 1))
            # time order: step j of block b = global step b·k+j
            srcs_time = srcs_time.reshape(nb * self.k, n).astype(jnp.int32)
            pieces.append(srcs_time)
        if tail:
            tail_syms = seq_d[1 + nb * self.k :]
            _, tsrcs = block_srcs(v_blocks[:, None], tail_syms[:, None])
            pieces.append(tsrcs[:, :, 0])
        if pieces:
            srcs_all = jnp.concatenate(pieces, axis=0)  # [T-1, N]
            last = jnp.argmin(jnp.asarray(scores)).astype(jnp.int32)
            rev = self._jit_back(last, srcs_all)
            path = np.concatenate([np.asarray(rev), [int(last)]])
        else:
            path = np.array([int(np.argmin(scores))])
        return scores[: self.states_num], path.astype(np.int32)
