"""State-sharded (TP) decode of a *structured* operator with halo exchange.

The dense TP path (:mod:`spec_viterbi.parallel.sharded`) all-gathers the
N-float carry every step. For structured operators the communication
collapses to O(D + R + C) tiny messages per step:

- **diagonal** offset ``d``: each shard needs only a ``|d|``-row halo from
  its neighbor — a `ppermute` of ``[|d|, B]`` floats;
- **dense row** source ``s``: all shards need the scalar carry row
  ``v[s]`` — the owner contributes it, everyone else +inf, combined with
  an all-reduce min (`pmin`) of ``[1, B]``;
- **dense col** destination ``c``: shards reduce their partial min and
  `pmin` combines — ``[1, B]`` again;
- **residual** entries ride the same scalar mechanism.

For the Pfam corpus (1 diagonal, 1 dense row, 2 dense cols) a step moves
4×B floats per device instead of N×B — the communication no longer grows
with the model. This answers "how do you TP a sparse recurrence"
(SURVEY.md §2.9: shard the N×N operator over a state mesh axis with
min-reductions).

Restrictions (checked, with dense-TP fallback available): every diagonal
offset must be smaller than the per-shard block, so halos only touch
adjacent shards.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spec_viterbi.hmm import HMM
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.parallel.mesh import STATE_AXIS
from spec_viterbi.utils.batching import pad_batch


def structured_tp_supported(sop: StructuredOperator, shards: int) -> bool:
    if sop.n % shards != 0:
        return False
    block = sop.n // shards
    # d == 0 (self-loop diagonal) needs no halo at all — always supported
    return all(abs(d) < block for d in sop.diag_offsets)


def make_structured_tp_decode(sop: StructuredOperator, mesh: Mesh):
    """Build a jitted batched decoder sharded over the ``state`` axis.

    Inputs (sharded as noted):
      dv [D, Np] (state-blocked)   rv [R, Np] (state-blocked)
      cv [C, Np] (state-blocked)   em_t [Np, E] (state-blocked)
      pi [Np] (state-blocked)      seqs_t [T, B] (replicated)
      lengths [B] (replicated)
    Output: [B, Np] scores, state-blocked on the last dim.
    """
    shards = mesh.shape[STATE_AXIS]
    if not structured_tp_supported(sop, shards):
        raise ValueError("structured TP needs |diag offset| < block size")
    block = sop.n // shards
    diag_offsets = sop.diag_offsets
    row_idx = sop.row_idx
    col_idx = sop.col_idx
    res = list(zip(sop.res_src.tolist(), sop.res_dst.tolist(), range(len(sop.res_vals))))

    def _scalar_row(v_blk, s, r):
        """v[s] broadcast to every shard as a [1, B] vector."""
        owner, local = divmod(s, block)
        cand = jnp.where(r == owner, v_blk[local : local + 1, :], jnp.inf)
        return jax.lax.pmin(cand, STATE_AXIS)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(None, STATE_AXIS),  # dv [D?, Np]
            P(None, STATE_AXIS),  # rv
            P(None, STATE_AXIS),  # cv
            P(),  # resv [1, Z] replicated (few scalars)
            P(STATE_AXIS, None),  # em_t [Np, E]
            P(STATE_AXIS),  # pi
            P(),  # seqs_t [T, B]
            P(),  # lengths [B]
        ),
        out_specs=P(None, STATE_AXIS),
    )
    def tp_decode(dv_blk, rv_blk, cv_blk, resv, em_t_blk, pi_blk, seqs_t, lengths):
        r = jax.lax.axis_index(STATE_AXIS)
        rows_local = jax.lax.broadcasted_iota(jnp.int32, (block, 1), 0)
        rows_global = rows_local + r * block  # [block, 1]

        v = em_t_blk[:, seqs_t[0]] + pi_blk[:, None]  # [block, B] (varying)

        def step(v_blk, xs):
            o_t, t = xs
            u = jnp.full(v_blk.shape, jnp.inf, dtype=v_blk.dtype)

            # diagonals: shift + halo from the adjacent shard
            for k, d in enumerate(diag_offsets):
                w = abs(d)
                if d == 0:
                    # self-loop diagonal: purely local, no halo exchange
                    u = jnp.minimum(u, dv_blk[k][:, None] + v_blk)
                    continue
                if d > 0:
                    # u[i] needs v[i-d]: top d rows come from left neighbor
                    halo = jax.lax.ppermute(
                        v_blk[-w:, :], STATE_AXIS,
                        [(i, (i + 1) % shards) for i in range(shards)],
                    )
                    shifted = jnp.concatenate([halo, v_blk[:-w, :]], axis=0)
                    # shard 0's halo wrapped from the last shard: mask via
                    # the global-row boundary (i-d < 0 → +inf)
                    valid = rows_global >= d
                else:
                    halo = jax.lax.ppermute(
                        v_blk[:w, :], STATE_AXIS,
                        [(i, (i - 1) % shards) for i in range(shards)],
                    )
                    shifted = jnp.concatenate([v_blk[w:, :], halo], axis=0)
                    valid = rows_global < (sop.n + d)
                cand = dv_blk[k][:, None] + shifted
                u = jnp.minimum(u, jnp.where(valid, cand, jnp.inf))

            # dense rows: scalar carry broadcast
            for k, s in enumerate(row_idx):
                vs = _scalar_row(v_blk, s, r)  # [1, B]
                u = jnp.minimum(u, rv_blk[k][:, None] + vs)

            # dense cols: partial min + all-reduce, applied on the owner row
            for k, c in enumerate(col_idx):
                part = jnp.min(cv_blk[k][:, None] + v_blk, axis=0, keepdims=True)
                cu = jax.lax.pmin(part, STATE_AXIS)  # [1, B]
                u = jnp.where(rows_global == c, jnp.minimum(u, cu), u)

            # residual entries: same scalar mechanism
            for s, dst, k in res:
                vs = _scalar_row(v_blk, s, r)
                cand = resv[0, k] + vs
                u = jnp.where(rows_global == dst, jnp.minimum(u, cand), u)

            v_new = em_t_blk[:, o_t] + u
            keep = (t < lengths)[None, :]
            return jnp.where(keep, v_new, v_blk), None

        ts = jnp.arange(1, seqs_t.shape[0])
        v, _ = jax.lax.scan(step, v, (seqs_t[1:], ts))
        return v.T  # [B, block]

    return jax.jit(tp_decode)


def make_structured_dp_decode(sop: StructuredOperator, mesh: Mesh):
    """Batched structured decode sharded over the ``data`` axis only.

    Zero per-step communication: operators replicate, each device advances
    its slice of the batch — the scaling path for many-sequence workloads
    (``emit_50_3500_20``-shaped). Used by the scaling benchmark.
    """
    from spec_viterbi.ops.structured import structured_mv_batch
    from spec_viterbi.parallel.mesh import DATA_AXIS

    arrs = sop.device_arrays()  # replicated closure constants

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(),  # em_t [Np, E]
            P(),  # pi [Np]
            P(None, DATA_AXIS),  # seqs_t [T, B]
            P(DATA_AXIS),  # lengths [B]
        ),
        out_specs=P(DATA_AXIS, None),
    )
    def dp_decode(em_t, pi, seqs_t, lengths):
        v = em_t[:, seqs_t[0]] + pi[:, None]  # [Np, Bd] (varying via seqs_t)

        def step(carry, xs):
            o_t, t = xs
            u = structured_mv_batch(sop, arrs, carry)
            v_new = em_t[:, o_t] + u
            keep = (t < lengths)[None, :]
            return jnp.where(keep, v_new, carry), None

        ts = jnp.arange(1, seqs_t.shape[0])
        v, _ = jax.lax.scan(step, v, (seqs_t[1:], ts))
        return v.T

    return jax.jit(dp_decode)


def decode_batch_structured_dp(
    hmm: HMM,
    seqs: list[np.ndarray],
    mesh: Mesh,
) -> list[np.ndarray]:
    """Data-parallel batched structured decode over the ``data`` axis."""
    if not seqs:
        return []
    from spec_viterbi.parallel.mesh import DATA_AXIS, fetch_global

    sop = StructuredOperator.from_hmm(hmm)
    fn = make_structured_dp_decode(sop, mesh)
    d = mesh.shape[DATA_AXIS]
    batch, lengths = pad_batch(seqs, d * 8, min_t=2)
    n = sop.n

    # explicit placement (not jnp.asarray): on a multi-host process group
    # the inputs must be GLOBAL arrays laid out per the shard_map in_specs
    def put(a, *spec):
        return jax.device_put(a, NamedSharding(mesh, P(*spec)))

    v = fetch_global(
        fn(
            put(hmm.emission_matrix(pad_to=n).T),
            put(hmm.start_vector(pad_to=n)),
            put(batch.T.copy(), None, DATA_AXIS),
            put(lengths, DATA_AXIS),
        )
    )
    return [v[i, : hmm.states_num] for i in range(len(seqs))]


def decode_batch_structured_tp(
    hmm: HMM,
    seqs: list[np.ndarray],
    mesh: Mesh,
) -> list[np.ndarray]:
    """Batched decode with the structured operator sharded over ``state``."""
    if not seqs:
        return []
    from spec_viterbi.parallel.mesh import fetch_global

    sop = StructuredOperator.from_hmm(hmm)
    fn = make_structured_tp_decode(sop, mesh)

    batch, lengths = pad_batch(seqs, 8, min_t=2)

    n = sop.n
    em_t = hmm.emission_matrix(pad_to=n).T  # [Np, E]
    pi = hmm.start_vector(pad_to=n)
    resv = sop.res_vals.reshape(1, -1) if sop.residual_nnz else np.zeros((1, 1), np.float32)

    def pad_comp(a):
        return a if a.shape[0] else np.zeros((0, n), np.float32)

    def put(a, *spec):  # global placement per the shard_map in_specs
        return jax.device_put(np.asarray(a), NamedSharding(mesh, P(*spec)))

    v = fetch_global(
        fn(
            put(pad_comp(sop.diag_vals), None, STATE_AXIS),
            put(pad_comp(sop.row_vals), None, STATE_AXIS),
            put(pad_comp(sop.col_vals), None, STATE_AXIS),
            put(resv),
            put(em_t, STATE_AXIS, None),
            put(pi, STATE_AXIS),
            put(batch.T.copy()),
            put(lengths),
        )
    )
    return [v[i, : hmm.states_num] for i in range(len(seqs))]
