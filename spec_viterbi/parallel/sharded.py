"""Sharded Viterbi decoding over a device mesh (DP × TP × SP).

The reference decodes one sequence at a time in a single process
(``benchmark/bench_Viterbi.h:51-57``); everything in this module is the
multi-device scaling extension called for by SURVEY.md §2.9:

- **DP** (``data`` axis): the batch of sequences is sharded; each device
  runs the batched TN recurrence on its slice with zero per-step
  communication. Natural fit for ``emit_50_3500_20.ess``.
- **TP** (``state`` axis): the N×N (min,+) operator is column-blocked; the
  score carry is state-sharded and each step all-gathers the carry
  (the gather-based tropical matvec: N·4B per step per device).
- **SP** (``time`` axis): observation time-blocks compose their operator
  products ``⊗_{t∈block} M_{o_t}`` in parallel — the same associativity the
  reference exploits for specialization (``README.md:9-13``) applied across
  time — then the O(devices) block frontier is folded sequentially.
  Block composition is O(N³·T/S) vs O(N²·T) serial matvecs, a scheduling
  tradeoff the caller makes deliberately (SURVEY.md §5 long-context note).

All functions are jit-compiled with `shard_map` inner bodies so XLA sees
static shapes and explicit collectives (`all_gather`/`pmin`), which it
hands to the collective library (NCCL on GPUs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spec_viterbi.hmm import HMM, pad_to_lane
from spec_viterbi.models.decoder import DeviceHMM
from spec_viterbi.ops import dispatch
from spec_viterbi.parallel.mesh import (
    DATA_AXIS,
    STATE_AXIS,
    TIME_AXIS,
    fetch_global,
)
from spec_viterbi.utils.batching import pad_batch


# --------------------------------------------------------------------------
# DP: batch-sharded decode (GSPMD — sharding constraints, XLA inserts nothing
# per step because the batch axis is embarrassingly parallel)
# --------------------------------------------------------------------------


@jax.jit
def _dp_decode(a, pi, em_t, seqs_t, lengths):
    """seqs_t: [Tmax, B] time-major (already batch-sharded). Returns [B, Np].

    Identical math to the single-device batched decoder; the batch (lane)
    dimension of the carry inherits the input sharding, so each device
    advances only its local sequences.
    """
    v_t = em_t[:, seqs_t[0]] + pi[:, None]

    def step(carry, xs):
        o_t, t = xs
        u_t = dispatch.batch_step_t(a, carry)
        v_new = em_t[:, o_t] + u_t
        keep = (t < lengths)[None, :]
        return jnp.where(keep, v_new, carry), None

    ts = jnp.arange(1, seqs_t.shape[0])
    v_t, _ = jax.lax.scan(step, v_t, (seqs_t[1:], ts))
    return v_t.T


def decode_batch_dp(
    dev: DeviceHMM,
    seqs: list[np.ndarray],
    mesh: Mesh,
) -> list[np.ndarray]:
    """Data-parallel batched decode: sequences sharded over the ``data`` axis.

    Pads the batch to a multiple of (data-axis size × lane) and each
    sequence to the common max length; masking freezes finished lanes so
    results equal one-at-a-time decoding.
    """
    if not seqs:
        return []
    d = mesh.shape[DATA_AXIS]
    batch, lengths = pad_batch(seqs, d * 8)

    batch_sh = NamedSharding(mesh, P(None, DATA_AXIS))  # [Tmax, B]
    len_sh = NamedSharding(mesh, P(DATA_AXIS))
    repl = NamedSharding(mesh, P())

    seqs_t = jax.device_put(batch.T.copy(), batch_sh)
    lengths_d = jax.device_put(jnp.asarray(lengths), len_sh)
    a = jax.device_put(dev.a, repl)
    pi = jax.device_put(dev.pi, repl)
    em_t = jax.device_put(dev.emissions.T, repl)

    v = np.asarray(_dp_decode(a, pi, em_t, seqs_t, lengths_d))
    return [v[i, : dev.states_num] for i in range(len(seqs))]


# --------------------------------------------------------------------------
# DP for the whole-sequence kernel: shard_map over the lane (batch) axis.
# A pallas_call has no partitioning rule under plain GSPMD jit; shard_map
# runs the unmodified kernel per device on its local lane block with zero
# collectives — the kernel's multi-device path.
# --------------------------------------------------------------------------


def make_fused_dp(fd, mesh: Mesh):
    """Jitted (scores_fn, path_fn) running ``fd``'s kernel DP-sharded.

    ``fd`` is a :class:`~spec_viterbi.ops.fused_pallas.FusedStructuredDecoder`.
    Inputs are globally shaped [T, B] / [1, B] with the lane axis sharded
    over ``data``.

    The jitted pair is memoized **on the decoder instance** (keyed by
    mesh) rather than in a module-level cache, so dropping the
    decoder frees its device-resident operators and compiled executables —
    a process-lifetime ``lru_cache`` here would pin every decoder's HBM
    forever in a long-lived service.
    """
    cache = fd.__dict__.setdefault("_dp_fn_cache", {})
    key = mesh
    hit = cache.get(key)
    if hit is not None:
        return hit
    from jax.sharding import PartitionSpec as P  # local alias

    # check_vma=False: pallas_call's out_shape carries no varying-mesh-axes
    # annotation; the body is collective-free (pure per-lane work), so the
    # varying-axis check adds nothing here.
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS), P(None, DATA_AXIS)),
        out_specs=P(None, DATA_AXIS),
        check_vma=False,
    )
    def scores_body(seqs_t, lengths):
        return fd._scores_core(seqs_t, lengths)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS), P(None, DATA_AXIS)),
        out_specs=(P(None, DATA_AXIS), P(None, DATA_AXIS)),
        check_vma=False,
    )
    def path_body(seqs_t, lengths):
        return fd._path_core(seqs_t, lengths)

    out = (jax.jit(scores_body), jax.jit(path_body))
    cache[key] = out
    return out


def _fused_dp_stage(fd, seqs, mesh):
    """Pad/validate/shard a batch for the kernel's DP path."""
    from spec_viterbi.hmm import validate_obs_seq

    seqs = [validate_obs_seq(s, fd.emit_num) for s in seqs]
    d = mesh.shape[DATA_AXIS]
    batch, lengths = pad_batch(seqs, d, min_t=2)
    sh = NamedSharding(mesh, P(None, DATA_AXIS))
    seqs_t = jax.device_put(batch.T.copy(), sh)
    lengths_d = jax.device_put(lengths[None, :], sh)
    return seqs_t, lengths_d


def decode_batch_dp_fused(fd, seqs: list[np.ndarray], mesh: Mesh) -> list[np.ndarray]:
    """Kernel batched decode sharded over ``data``; score vectors."""
    if not seqs:
        return []
    seqs_t, lengths_d = _fused_dp_stage(fd, seqs, mesh)
    scores_fn, _ = make_fused_dp(fd, mesh)
    v = fetch_global(scores_fn(seqs_t, lengths_d))  # [Np, B]
    return [v[: fd.states_num, i] for i in range(len(seqs))]


def decode_path_batch_dp_fused(
    fd, seqs: list[np.ndarray], mesh: Mesh
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Kernel batched path decode sharded over ``data``.

    Returns [(scores, exact path)] per sequence with the oracle's
    tie-breaking — the multi-chip form of ``decode_path_batch``.
    """
    if not seqs:
        return []
    seqs_t, lengths_d = _fused_dp_stage(fd, seqs, mesh)
    _, path_fn = make_fused_dp(fd, mesh)
    scores, paths = path_fn(seqs_t, lengths_d)
    scores = fetch_global(scores)  # [Np, B]
    paths = fetch_global(paths)  # [T, B]
    return [
        (scores[: fd.states_num, i], paths[: len(s), i].astype(np.int32))
        for i, s in enumerate(seqs)
    ]


class StreamDP:
    """DP-sharded streaming decode: the carry lives lane-sharded over
    ``data``; every feed runs the fused kernels per shard with ZERO
    collectives (the streaming analog of ``decode_batch_dp_fused``).

    Mirrors the single-device API of
    :class:`~spec_viterbi.ops.fused_pallas.FusedStructuredDecoder`:
    ``begin/feed/scores`` for constant-memory score streaming and
    ``begin_path/feed_path/path_finalize`` for exact paths via
    checkpoint + rematerialize. Bit-identical to the single-device stream
    (per-lane work only; sharding cannot reorder it).
    """

    def __init__(self, fd, mesh: Mesh):
        self.fd = fd
        self.mesh = mesh
        self._d = mesh.shape[DATA_AXIS]
        self._lane_mult = self._d
        self._sh = NamedSharding(mesh, P(None, DATA_AXIS))

        def smap(body, in_specs, out_specs):
            # check_vma=False as in make_fused_dp: collective-free bodies
            return jax.jit(
                jax.shard_map(
                    body,
                    mesh=mesh,
                    in_specs=in_specs,
                    out_specs=out_specs,
                    check_vma=False,
                )
            )

        lane2 = P(None, DATA_AXIS)
        self._begin_fn = smap(fd._begin, (P(DATA_AXIS),), lane2)
        self._feed_fn = smap(fd._feed, (lane2, lane2, lane2), lane2)
        self._extract_fn = smap(fd._extract, (lane2,), P(DATA_AXIS, None))
        self._last_fn = smap(fd._last_state, (lane2,), lane2)
        self._path_block_fn = smap(
            lambda c, ch, ln, bd: fd._path_block(c, ch, ln, bd, b_real=None),
            (lane2, lane2, lane2, lane2),
            (lane2, lane2),
        )

    # ---- host staging -------------------------------------------------

    def _put(self, arr):
        return jax.device_put(arr, self._sh)

    def _stage_prepped(self, chunk, t_c: int, valid=None):
        """T-quantize + upload an already lane-padded [t_c, B_pad] chunk,
        placed with the mesh sharding (the single-device staging protocol
        with a placement hook)."""
        return self.fd._stage_quantized(chunk, t_c, put=self._put, valid=valid)

    def _stage_chunk(self, carry, b_real: int, chunk, valid=None):
        """Validate/lane-pad/T-quantize a chunk for the sharded feed."""
        prep = self.fd._prep_stream_chunk(carry, b_real, chunk, valid)
        if prep is None:
            return None
        chunk, t_c, valid = prep
        return (*self._stage_prepped(chunk, t_c, valid), t_c)

    def _begin_state(self, first_symbols):
        from spec_viterbi.hmm import validate_obs_seq

        syms = validate_obs_seq(first_symbols, self.fd.emit_num)
        if len(syms) == 0:
            raise ValueError("cannot stream an empty lane set")
        b_real = len(syms)
        m = self._lane_mult
        b_pad = ((b_real + m - 1) // m) * m
        syms = np.pad(syms, (0, b_pad - b_real))
        syms_d = jax.device_put(syms, NamedSharding(self.mesh, P(DATA_AXIS)))
        return self._begin_fn(syms_d), b_real

    # ---- scores streaming --------------------------------------------

    def begin(self, first_symbols):
        from spec_viterbi.ops.stream_api import StreamState

        carry, b_real = self._begin_state(first_symbols)
        return StreamState(carry, b_real)

    def feed(self, state, chunk, valid=None):
        from spec_viterbi.ops.stream_api import StreamState

        staged = self._stage_chunk(state.carry, state.b_real, chunk, valid)
        if staged is None:
            return state
        chunk_d, lengths_d, _ = staged
        return StreamState(
            self._feed_fn(state.carry, chunk_d, lengths_d), state.b_real
        )

    def scores(self, state) -> np.ndarray:
        return fetch_global(self._extract_fn(state.carry))[: state.b_real]

    # ---- exact-path streaming ----------------------------------------

    def begin_path(self, first_symbols):
        from spec_viterbi.ops.stream_api import PathStreamState

        if self.fd.n > np.iinfo(np.int16).max:
            raise ValueError("path streaming needs int16-addressable states")
        carry, b_real = self._begin_state(first_symbols)
        return PathStreamState(carry, b_real, (), ())

    def feed_path(self, state, chunk, valid=None):
        from spec_viterbi.ops.stream_api import PathStreamState, StreamChunk
        from spec_viterbi.utils.batching import quantize_t

        prep = self.fd._prep_stream_chunk(state.carry, state.b_real, chunk, valid)
        if prep is None:
            return state
        chunk, t_c, valid = prep
        # per-shard budget: each device materializes its own bp block
        if not self.fd.path_supported(
            quantize_t(t_c) + 1, batch=chunk.shape[1] // self._d
        ):
            raise ValueError(
                f"path chunk of {t_c} symbols exceeds the per-device "
                f"backpointer budget; feed smaller chunks"
            )
        chunk_d, lengths_d = self._stage_prepped(chunk, t_c, valid)
        return PathStreamState(
            self._feed_fn(state.carry, chunk_d, lengths_d),
            state.b_real,
            state.checkpoints + (state.carry,),
            state.chunks + (StreamChunk(chunk_d, lengths_d, t_c),),
        )

    def path_scores(self, state) -> np.ndarray:
        return fetch_global(self._extract_fn(state.carry))[: state.b_real]

    def path_finalize(self, state):
        """→ (scores [B, Np], paths [B, T_total]); state not consumed."""
        from spec_viterbi.ops.stream_api import _run_path_finalize

        return _run_path_finalize(
            state,
            self._extract_fn,
            self._last_fn,
            self._path_block_fn,
            fetch=fetch_global,  # shards may span processes
        )


# --------------------------------------------------------------------------
# TP: state-sharded decode (shard_map, explicit all_gather per step)
# --------------------------------------------------------------------------


def _tp_step_body(a_t_block, v_block):
    """One TP step: gather the carry, produce this device's output block.

    a_t_block: [Nb, Np] — the row block of Aᵀ for this device's output
    states. The all-gather moves Np·4 bytes per step.
    """
    v_full = jax.lax.all_gather(v_block, STATE_AXIS, tiled=True)  # [Np]
    return dispatch.step_mv(a_t_block, v_full)  # [Nb]


@functools.lru_cache(maxsize=None)
def make_tp_decode(mesh: Mesh):
    """Build a jitted state-sharded (TP) single-sequence decoder.

    Partitioning: Aᵀ row-blocked over ``state`` (each device owns the rows
    producing its output states), π / emissions / carry state-sharded the
    same way. Per step: one all-gather of the N-float carry.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(STATE_AXIS, None),  # a_t  [Np, Np] row-blocked
            P(STATE_AXIS),  # pi    [Np]
            P(None, STATE_AXIS),  # em    [E, Np] state-blocked
            P(),  # seq   [T] replicated
        ),
        out_specs=P(STATE_AXIS),
    )
    def tp_decode(a_t_block, pi_block, em_block, seq):
        v = em_block[seq[0]] + pi_block

        def step(v_block, o):
            u = _tp_step_body(a_t_block, v_block)
            return em_block[o] + u, None

        v, _ = jax.lax.scan(step, v, seq[1:])
        return v

    return jax.jit(tp_decode)


def decode_tp(
    dev: DeviceHMM,
    seq: np.ndarray,
    mesh: Mesh,
) -> np.ndarray:
    """State-sharded decode of one sequence; returns the score vector."""
    s = mesh.shape[STATE_AXIS]
    if dev.padded % s != 0:
        raise ValueError(f"padded states {dev.padded} not divisible by state axis {s}")
    fn = make_tp_decode(mesh)
    seq_d = jnp.asarray(np.asarray(seq, dtype=np.int32))
    v = fn(dev.a_t, dev.pi, dev.emissions, seq_d)
    return np.asarray(v)[: dev.states_num]


# --------------------------------------------------------------------------
# DP × TP: batched decode sharded over both axes (the dryrun/multichip path)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def make_dp_tp_decode(mesh: Mesh):
    """Batched decode with the batch on ``data`` and states on ``state``.

    Layouts (TN form, state-major carry):
      a     [Np, Np]  — A[j, i], columns (output states i) sharded
      v_t   [Np, B]   — rows state-sharded, columns batch-sharded
    Per step, each device all-gathers the carry over ``state`` only
    (Np × B/D floats) and computes its [Nb, Bd] output block locally.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(None, STATE_AXIS),  # a     [Np, Np] col-blocked (output states)
            P(STATE_AXIS),  # pi    [Np]
            P(STATE_AXIS, None),  # em_t  [Np, E]
            P(None, DATA_AXIS),  # seqs_t [Tmax, B]
            P(DATA_AXIS),  # lengths [B]
        ),
        out_specs=P(DATA_AXIS, STATE_AXIS),
    )
    def dp_tp_decode(a_block, pi_block, em_t_block, seqs_t, lengths):
        v_t = em_t_block[:, seqs_t[0]] + pi_block[:, None]  # [Nb, Bd]

        def step(carry, xs):
            o_t, t = xs
            v_full = jax.lax.all_gather(carry, STATE_AXIS, tiled=True)  # [Np, Bd]
            u_t = dispatch.matmul_tn(a_block, v_full)  # [Nb, Bd]
            v_new = em_t_block[:, o_t] + u_t
            keep = (t < lengths)[None, :]
            return jnp.where(keep, v_new, carry), None

        ts = jnp.arange(1, seqs_t.shape[0])
        v_t, _ = jax.lax.scan(step, v_t, (seqs_t[1:], ts))
        return v_t.T  # [Bd, Nb]

    return jax.jit(dp_tp_decode)


def decode_batch_dp_tp(
    dev: DeviceHMM,
    seqs: list[np.ndarray],
    mesh: Mesh,
) -> list[np.ndarray]:
    """Batched decode sharded over ``data`` × ``state``."""
    if not seqs:
        return []
    d = mesh.shape[DATA_AXIS]
    s = mesh.shape[STATE_AXIS]
    if dev.padded % s != 0:
        raise ValueError(f"padded states {dev.padded} not divisible by state axis {s}")
    batch, lengths = pad_batch(seqs, d * 8)

    fn = make_dp_tp_decode(mesh)
    v = np.asarray(
        fn(
            dev.a,
            dev.pi,
            jnp.asarray(dev.emissions).T,
            jnp.asarray(batch.T.copy()),
            jnp.asarray(lengths),
        )
    )
    return [v[i, : dev.states_num] for i in range(len(seqs))]


# --------------------------------------------------------------------------
# SP: time-parallel decode via associative operator composition
# --------------------------------------------------------------------------


def _identity_op(n: int) -> np.ndarray:
    """Tropical identity: 0 on the diagonal, +inf elsewhere."""
    m = np.full((n, n), np.inf, dtype=np.float32)
    np.fill_diagonal(m, 0.0)
    return m


@functools.lru_cache(maxsize=None)
def make_time_parallel_decode(mesh: Mesh):
    """Build a jitted time-parallel decoder.

    Each ``time``-axis device owns a contiguous observation block and
    composes its block operator ``M_block = M_{o_k} ⊗ … ⊗ M_{o_1}`` with a
    local scan of tropical mat-mats (the reference's add_level algebra,
    ``GraphBLAS_spec_impl.cpp:15-36``, applied across time instead of across
    the alphabet). Block operators are then all-gathered (S·N²·4 bytes over
    the interconnect, once per sequence — not per step) and folded into the start vector
    with S matvecs.

    The operator stack must carry a trailing identity at index ``E`` so the
    caller can pad sequences to ``S × block_len`` without changing results.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(),  # ops_t [E+1, Np, Np] replicated (pre-transposed, TN)
            P(),  # v0    [Np]
            P(TIME_AXIS),  # obs   [T-1] time-blocked
        ),
        out_specs=P(),
    )
    def sp_decode(ops_t, v0, obs_block):
        n = ops_t.shape[1]
        eye = jnp.where(
            jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
            == jax.lax.broadcasted_iota(jnp.int32, (n, n), 1),
            jnp.zeros((n, n), ops_t.dtype),
            jnp.full((n, n), jnp.inf, ops_t.dtype),
        )
        # The scan consumes the device-varying obs block, so its carry must
        # be typed as varying over the time axis too.
        eye = jax.lax.pcast(eye, (TIME_AXIS,), to="varying")

        def compose(m_acc, o):
            # new step applies after the accumulated block: M_o ⊗ m_acc.
            # TN form: C[i,j] = min_k (M_o)ᵀ[k,i] + m_acc[k,j]; ops arrive
            # pre-transposed so the scan body does no per-step transpose
            return dispatch.matmul_tn(ops_t[o], m_acc), None

        m_block, _ = jax.lax.scan(compose, eye, obs_block)
        blocks = jax.lax.all_gather(m_block, TIME_AXIS)  # [S, Np, Np]

        def fold(v, m):
            return dispatch.step_mv(m, v), None

        # `blocks` is typed varying post-all_gather; match the carry.
        v0 = jax.lax.pcast(v0, (TIME_AXIS,), to="varying")
        v, _ = jax.lax.scan(fold, v0, blocks)
        # Every device folded identical gathered blocks; an all-reduce min
        # is a numeric no-op that reclaims the replicated type for P().
        return jax.lax.pmin(v, TIME_AXIS)

    return jax.jit(sp_decode)


def decode_time_parallel(
    hmm: HMM,
    seq: np.ndarray,
    mesh: Mesh,
) -> np.ndarray:
    """Time-parallel decode of a single long sequence over the ``time`` axis.

    Semantically identical to serial decode; compute cost is
    O(N³·(T−1)/S) block composition vs O(N²·T) serial — the tradeoff is the
    caller's scheduling decision (profitable for very long sequences on
    small-N models, or when the time axis is otherwise idle).

    This is the DENSE block-operator form — the didactic mesh-SP path and
    the cross-check for the production-scale schedule. At corpus sizes
    (N≈2400) dense N³ block products are infeasible; the production
    time-parallel schedule is
    :class:`spec_viterbi.ops.time_parallel.TimeParallelDecoder`, which
    composes block operators in the banded+low-rank closure (O(rank·N)
    per block, rank linear in block length) with time blocks mapped onto
    the SINGLE-chip lane axis — on one chip the lane axis is the idle
    resource, so mesh sharding adds nothing until multi-chip latency
    decoding matters.
    """
    s_axis = mesh.shape[TIME_AXIS]
    np_states = pad_to_lane(hmm.states_num)
    seq = np.asarray(seq, dtype=np.int32)
    e = hmm.emit_num

    a_t = hmm.transposed_transition_matrix(pad_to=np_states)
    em = hmm.emission_matrix(pad_to=np_states)
    pi = hmm.start_vector(pad_to=np_states)

    # level-1 operators + trailing identity for padding, stored
    # pre-transposed (TN layout) so composition does no per-step transpose
    ops = np.concatenate(
        [em[:, :, None] + a_t[None, :, :], _identity_op(np_states)[None]], axis=0
    )
    ops_t = np.ascontiguousarray(np.transpose(ops, (0, 2, 1)))

    rest = seq[1:]
    block = -(-len(rest) // s_axis)  # ceil
    pad = s_axis * block - len(rest)
    obs = np.concatenate([rest, np.full(pad, e, dtype=np.int32)])

    v0 = em[seq[0]] + pi
    fn = make_time_parallel_decode(mesh)
    v = np.asarray(fn(jnp.asarray(ops_t), jnp.asarray(v0), jnp.asarray(obs)))
    return v[: hmm.states_num]
