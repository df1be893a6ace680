"""Structure-aware (min,+) operators: diagonals + dense rows/cols + residual.

The reference handles the corpus's extreme sparsity (~0.17%, SURVEY.md §6)
with general sparse libraries (GraphBLAS/CUSP COO). General gather/scatter
sparsity wastes a vector machine's lanes — but the *actual* structure of
the Pfam-derived models is far stronger than "sparse": every `.chmm` decomposes
exactly into

- one dense **source row** (the N-background state fans out to all match
  states — `silent_hmm_to_chmm.py`'s MSV construction),
- two dense **destination columns** (returns to the background states),
- the match-chain **superdiagonal** (state k → k+1),

and nothing else. This module implements the general decomposition
`A = diagonals ∪ dense-rows ∪ dense-cols ∪ residual-COO` with the tropical
matvec evaluated per component in O((D+R+C)·N·B) work instead of
O(N²·B) — shifts, broadcasts, and reductions, all dense vectorized ops. Duplicated coverage would be harmless (min is idempotent) but each
entry is assigned to exactly one component for accountability.

The decomposition is *detected*, never assumed: any HMM (including the unit
fixtures and randomly generated ones) gets a valid decomposition, with
leftovers in a COO residual applied by scatter-min. Callers can inspect
:meth:`StructuredOperator.cost_ratio` to decide structured vs dense.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spec_viterbi.hmm import HMM, MOD_PROB_DTYPE, ZERO_PROB, pad_to_lane


@dataclasses.dataclass(frozen=True)
class StructuredOperator:
    """A −log2-space transition operator in structured form.

    Semantics (TN/state-major, `v` is the incoming score carry):

        u[i] = min(
            min_k  diag_vals[k, i] + v[i - diag_offsets[k]],
            min_k  row_vals[k, i]  + v[row_idx[k]],
            (for i = col_idx[k])  min_j col_vals[k, j] + v[j],
            (residual)            min over entries (s→i): res_vals + v[s],
        )

    All value arrays are +inf-padded; diagonal boundary wrap is pre-baked
    as +inf so `jnp.roll` needs no masking.
    """

    n: int  # padded state count (lane-aligned)
    states_num: int
    diag_offsets: tuple[int, ...]
    diag_vals: np.ndarray  # [D, n]
    row_idx: tuple[int, ...]
    row_vals: np.ndarray  # [R, n]
    col_idx: tuple[int, ...]
    col_vals: np.ndarray  # [C, n]
    res_src: np.ndarray  # [Z] int32
    res_dst: np.ndarray  # [Z] int32
    res_vals: np.ndarray  # [Z] f32
    nnz: int

    @property
    def num_components(self) -> int:
        return len(self.diag_offsets) + len(self.row_idx) + len(self.col_idx)

    @property
    def residual_nnz(self) -> int:
        return int(self.res_vals.shape[0])

    def cost_ratio(self) -> float:
        """Structured work / dense work per matvec (lower is better)."""
        comp = self.num_components * self.n + self.residual_nnz
        return comp / float(self.n * self.n)

    @classmethod
    def from_hmm(
        cls,
        hmm: HMM,
        pad_to: int | None = None,
        dense_threshold: int | None = None,
        max_diags: int = 8,
    ) -> "StructuredOperator":
        """Decompose the transition matrix ``A[src, dst]``.

        Detection policy: a source/destination is "dense" when its degree
        reaches ``dense_threshold`` (default ``max(16, N/16)``); among the
        remaining entries, offsets covering ≥ the threshold become
        diagonals (up to ``max_diags``); everything else is residual COO.
        """
        n_real = hmm.states_num
        n = pad_to if pad_to is not None else pad_to_lane(n_real)
        thresh = dense_threshold if dense_threshold is not None else max(16, n_real // 16)

        src = np.asarray(hmm.trans_rows, dtype=np.int64)
        dst = np.asarray(hmm.trans_cols, dtype=np.int64)
        val = np.asarray(hmm.trans_probs, dtype=MOD_PROB_DTYPE)
        nnz = val.shape[0]
        alive = np.ones(nnz, dtype=bool)

        # 1. dense source rows
        row_idx: list[int] = []
        if nnz:
            deg = np.bincount(src[alive], minlength=n_real)
            row_idx = [int(s) for s in np.nonzero(deg >= thresh)[0]]
            for s in row_idx:
                alive &= src != s
        row_vals = np.full((len(row_idx), n), ZERO_PROB, dtype=MOD_PROB_DTYPE)
        for k, s in enumerate(row_idx):
            m = (np.asarray(hmm.trans_rows) == s)
            np.minimum.at(row_vals[k], dst[m], val[m])

        # 2. dense destination columns (among remaining entries)
        col_idx: list[int] = []
        if alive.any():
            deg = np.bincount(dst[alive], minlength=n_real)
            col_idx = [int(c) for c in np.nonzero(deg >= thresh)[0]]
        col_vals = np.full((len(col_idx), n), ZERO_PROB, dtype=MOD_PROB_DTYPE)
        for k, c in enumerate(col_idx):
            m = alive & (dst == c)
            np.minimum.at(col_vals[k], src[m], val[m])
            alive &= dst != c

        # 3. diagonals (among remaining entries)
        diag_offsets: list[int] = []
        if alive.any():
            offs = dst[alive] - src[alive]
            uniq, counts = np.unique(offs, return_counts=True)
            order = np.argsort(-counts)
            for j in order[:max_diags]:
                if counts[j] >= thresh:
                    diag_offsets.append(int(uniq[j]))
        diag_vals = np.full((len(diag_offsets), n), ZERO_PROB, dtype=MOD_PROB_DTYPE)
        for k, d in enumerate(diag_offsets):
            m = alive & (dst - src == d)
            # value indexed by output (dst) state: diag_vals[k, i] = A[i-d, i]
            np.minimum.at(diag_vals[k], dst[m], val[m])
            alive &= (dst - src) != d

        # 4. residual COO
        res_src = src[alive].astype(np.int32)
        res_dst = dst[alive].astype(np.int32)
        res_vals = val[alive].astype(MOD_PROB_DTYPE)

        return cls(
            n=n,
            states_num=n_real,
            diag_offsets=tuple(diag_offsets),
            diag_vals=diag_vals,
            row_idx=tuple(row_idx),
            row_vals=row_vals,
            col_idx=tuple(col_idx),
            col_vals=col_vals,
            res_src=res_src,
            res_dst=res_dst,
            res_vals=res_vals,
            nnz=nnz,
        )

    def device_arrays(self):
        """jnp copies of the value arrays (indices stay static Python)."""
        return (
            jnp.asarray(self.diag_vals),
            jnp.asarray(self.row_vals),
            jnp.asarray(self.col_vals),
            jnp.asarray(self.res_src),
            jnp.asarray(self.res_dst),
            jnp.asarray(self.res_vals),
        )


def structured_mv(op: StructuredOperator, arrs, v: jax.Array) -> jax.Array:
    """Structured tropical matvec: ``u[i] = min over components``. v: [n]."""
    diag_vals, row_vals, col_vals, res_src, res_dst, res_vals = arrs
    u = jnp.full(v.shape, jnp.inf, dtype=v.dtype)
    for k, d in enumerate(op.diag_offsets):
        u = jnp.minimum(u, diag_vals[k] + jnp.roll(v, d))
    for k, s in enumerate(op.row_idx):
        u = jnp.minimum(u, row_vals[k] + v[s])
    if op.col_idx:
        cu = jnp.min(col_vals + v[None, :], axis=1)  # [C]
        u = u.at[jnp.asarray(op.col_idx)].min(cu)
    if op.residual_nnz:
        u = u.at[res_dst].min(res_vals + v[res_src])
    return u


def structured_mv_batch(op: StructuredOperator, arrs, v: jax.Array) -> jax.Array:
    """Batched structured tropical matvec. v: [n, B] state-major."""
    diag_vals, row_vals, col_vals, res_src, res_dst, res_vals = arrs
    u = jnp.full(v.shape, jnp.inf, dtype=v.dtype)
    for k, d in enumerate(op.diag_offsets):
        u = jnp.minimum(u, diag_vals[k][:, None] + jnp.roll(v, d, axis=0))
    for k, s in enumerate(op.row_idx):
        u = jnp.minimum(u, row_vals[k][:, None] + v[s][None, :])
    if op.col_idx:
        cu = jnp.min(col_vals[:, :, None] + v[None, :, :], axis=1)  # [C, B]
        u = u.at[jnp.asarray(op.col_idx)].min(cu)
    if op.residual_nnz:
        u = u.at[res_dst].min(res_vals[:, None] + v[res_src])
    return u


def structured_mv_argmin(
    op: StructuredOperator, arrs, v: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Structured matvec + argmin source state per output (backtrace).

    Tie-breaking matches the dense paths: the lowest source index wins.
    Implemented by tracking (value, src) pairs through the same component
    sweep; on equal values the candidate with the smaller source index is
    kept, which reproduces `jnp.argmin`'s first-match rule regardless of
    component evaluation order.
    """
    diag_vals, row_vals, col_vals, res_src, res_dst, res_vals = arrs
    n = v.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n)
    u = jnp.full(v.shape, jnp.inf, dtype=v.dtype)
    src = jnp.full(v.shape, np.iinfo(np.int32).max, dtype=jnp.int32)

    def take(u, src, cand, cand_src):
        # ties only matter for finite scores; an inf==inf tie must not
        # adopt a (possibly out-of-range) candidate source index.
        better = (cand < u) | ((cand == u) & (cand_src < src) & jnp.isfinite(cand))
        return jnp.where(better, cand, u), jnp.where(better, cand_src, src)

    for k, d in enumerate(op.diag_offsets):
        cand = diag_vals[k] + jnp.roll(v, d)
        u, src = take(u, src, cand, iota - d)
    for k, s in enumerate(op.row_idx):
        u, src = take(u, src, row_vals[k] + v[s], jnp.full((n,), s, jnp.int32))
    if op.col_idx:
        s_mat = col_vals + v[None, :]  # [C, n]
        cu = jnp.min(s_mat, axis=1)
        cs = jnp.argmin(s_mat, axis=1).astype(jnp.int32)
        ci = jnp.asarray(op.col_idx)
        u2, src2 = take(u[ci], src[ci], cu, cs)
        u, src = u.at[ci].set(u2), src.at[ci].set(src2)
    if op.residual_nnz:
        # sequential min over the few residual entries, with index ties
        def body(carry, e):
            u, src = carry
            s_, d_, val_ = e
            cand = val_ + v[s_]  # scalar
            cur_u, cur_s = u[d_], src[d_]
            # same finite-tie guard as take(): an inf==inf tie must not
            # adopt the candidate source
            better = (cand < cur_u) | (
                (cand == cur_u) & (s_ < cur_s) & jnp.isfinite(cand)
            )
            u = u.at[d_].set(jnp.where(better, cand, cur_u))
            src = src.at[d_].set(jnp.where(better, s_, cur_s))
            return (u, src), None

        (u, src), _ = jax.lax.scan(
            body, (u, src), (res_src, res_dst, res_vals)
        )
    # states with no incoming edge keep +inf and an out-of-range pointer;
    # normalize to 0 like argmin over an all-inf row would give.
    src = jnp.where(src == np.iinfo(np.int32).max, 0, src)
    return u, src
