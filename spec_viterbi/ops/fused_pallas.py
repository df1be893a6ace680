"""Whole-sequence structured Viterbi kernel (Pallas, Triton route).

The XLA structured scan (:func:`~spec_viterbi.ops.structured.
structured_mv_batch` inside ``lax.scan``) launches several kernels per
recurrence step, T times per sequence. This kernel runs the whole T-step
recurrence as ONE ``pallas_call``:

- lanes are independent, so each program owns one sequence (one lane,
  one warp) and loops over all T steps inside the kernel;
- the program's score carry ping-pongs between two [Np'] buffers that
  stay hot in L2 for the whole sequence; the state axis is swept in
  power-of-two tiles, padded inside the kernel with +inf states only up to
  the next tile multiple (Np' = 2,560 for Np = 2,432 at 512-state tiles);
- per step and tile, a diagonal is an offset read of the previous carry,
  a dense row is a per-lane broadcast of one carry element, the emission
  is a direct gather ``em[o_t, i]``, and the dense-column mins accumulate
  across the tiles; after a block barrier the few special rows (the
  dense-column targets and residual destinations) are patched;
- a per-lane length mask freezes lanes past their end (ragged buckets);
- in path mode the argmin source is kept with the oracle's tie rule
  (lowest source state wins; an ``inf == inf`` tie never adopts a source)
  and stored as an int16 backpointer per (step, lane, state); frozen steps
  store identity pointers.

Every candidate is the same float32 add the XLA scan performs, and min is
exact, so the scores are bit-equal to the XLA engine and the paths are
array-equal to it and to ``viterbi_path_oracle``. No matrix product is
involved anywhere.

The kernel is compiled only for a GPU (:func:`gpu_kernel_available`). The
Pallas interpreter runs it only when a caller passes ``interpret=True``,
which is how the CPU tests exercise it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from spec_viterbi.hmm import validate_obs_seq
from spec_viterbi.ops.stream_api import _StreamAPI, model_key
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.utils.batching import bucket_plan, quantize_t
from spec_viterbi.utils.device import path_budget_bytes

# States per tile (a power of two); small models use one tile of the next
# power of two above their state count. One lane and one warp per program
# with 512-state tiles measured fastest on the H100 at the 2,407-state
# model (PERF.md): many independent one-warp programs per SM hide each
# program's serial chain of L2 round trips.
TILE = 512

# Each residual entry is a per-lane scalar candidate on a special row.
MAX_FUSED_RESIDUAL = 8

_NO_SRC = 2**30  # "no finite candidate yet" source marker (> any state)


def gpu_kernel_available() -> bool:
    """The one capability check: the kernel is compiled only for a GPU.

    Everywhere else the decoders run the XLA structured scan; the Pallas
    interpreter is used only when a caller asks for it (``interpret=True``).
    """
    return jax.default_backend() == "gpu"


def fused_eligible(sop: StructuredOperator) -> bool:
    return (
        sop.residual_nnz <= MAX_FUSED_RESIDUAL
        and sop.num_components + sop.residual_nnz <= 24
    )


def tile_layout(n: int, tile: int = TILE) -> tuple[int, int]:
    """(tile, padded state count) for ``n`` states: the tile shrinks to
    the next power of two above small models; the state axis pads to a
    tile multiple with +inf states, which no recurrence step can leave."""
    tile = min(tile, 1 << max(0, (n - 1).bit_length()))
    return tile, -(-n // tile) * tile


def _make_kernel(sop: StructuredOperator, steps: int, tile: int, path: bool, interpret: bool):
    """Kernel body for ``steps`` recurrence steps; program b decodes lane b.

    Refs (all whole arrays; each program indexes its own lane), with
    the state axis padded to ``n = tile_layout(sop.n, tile)[1]``:
    ``v0 [B, n]`` start carry, ``obs [T, B]`` symbols, ``lengths [B]``,
    ``em [E, n]``, ``dv [D, n]``, ``rv [R, n]``, ``cv [C, n]``, ``resv [Z]``
    (each padded to >= 1 row, +inf past ``sop.n``), then the outputs
    ``buf [2, B, n]`` (ping-pong carry; step t reads ``buf[t % 2]``) and,
    in path mode, ``bp [T, B, n]`` int16 backpointers. A diagonal read
    past ``sop.n`` lands on a padded +inf state, matching the +inf the
    XLA scan's cyclic roll meets there.
    """
    tile, n = tile_layout(sop.n, tile)
    n_tiles = n // tile
    diag = sop.diag_offsets
    rows = sop.row_idx
    cols = sop.col_idx
    res = list(zip(sop.res_src.tolist(), sop.res_dst.tolist()))
    specials = sorted(set(cols) | {dst for _, dst in res})
    inf = np.float32(np.inf)

    def barrier():
        # orders one step's carry writes before the next step's reads
        # across the program's threads; the interpreter runs programs
        # sequentially and has no lowering for it
        if not interpret:
            plgpu.debug_barrier()

    def empty(shape):
        if path:
            return jnp.full(shape, inf), jnp.full(shape, _NO_SRC, jnp.int32)
        return jnp.full(shape, inf)

    def pick(best, value, src):
        """Fold one candidate into the running min. Path mode keeps the
        (value, source) lexicographic min over finite candidates, which
        is what ``structured_mv_argmin``'s sequential take() computes in
        any component order."""
        if not path:
            return jnp.minimum(best, value)
        u, s = best
        src = jnp.broadcast_to(jnp.asarray(src, jnp.int32), value.shape)
        better = (value < u) | ((value == u) & (src < s) & (value < inf))
        return jnp.where(better, value, u), jnp.where(better, src, s)

    def kernel(v0_ref, obs_ref, len_ref, em_ref, dv_ref, rv_ref, cv_ref, resv_ref, buf_ref, *bp):
        lane = pl.program_id(0)
        iota = lax.broadcasted_iota(jnp.int32, (tile,), 0)
        length = len_ref[lane]

        def copy_in(j, carry):
            st = j * tile + iota
            buf_ref[0, lane, st] = v0_ref[lane, st]
            return carry

        lax.fori_loop(0, n_tiles, copy_in, 0)
        barrier()

        def step(t, carry):
            s = lax.rem(t, 2)
            d = 1 - s
            o = obs_ref[t, lane]
            keep = (t + 1) < length
            v_rows = [buf_ref[s, lane, r] for r in rows]  # dense-row sources

            def tile_body(j, acc):
                st = j * tile + iota  # [TS]
                v = buf_ref[s, lane, st]
                best = empty(v.shape)
                for k, off in enumerate(diag):
                    sh = st - off
                    v_sh = plgpu.load(
                        buf_ref.at[s, lane, sh], mask=(sh >= 0) & (sh < n), other=inf
                    )
                    best = pick(best, dv_ref[k, st] + v_sh, sh)
                for k, r in enumerate(rows):
                    best = pick(best, rv_ref[k, st] + v_rows[k], r)
                u = best[0] if path else best
                new = em_ref[o, st] + u
                buf_ref[d, lane, st] = jnp.where(keep, new, v)
                if path:
                    src = jnp.where(u < inf, best[1], 0)
                    src = jnp.where(keep, src, st)  # identity when frozen
                    bp[0][t, lane, st] = src.astype(jnp.int16)
                # dense columns: running min (and lowest argmin) over tiles
                out = []
                for k in range(len(cols)):
                    c = cv_ref[k, st] + v
                    m = jnp.min(c)
                    if path:
                        idx = jnp.min(jnp.where(c == m, st, _NO_SRC))
                        pm, pidx = acc[k]
                        lower = m < pm  # strict: earlier tiles win ties
                        out.append((jnp.where(lower, m, pm), jnp.where(lower, idx, pidx)))
                    else:
                        out.append(jnp.minimum(acc[k], m))
                return tuple(out)

            col_min = lax.fori_loop(0, n_tiles, tile_body, tuple(empty(()) for _ in cols))
            barrier()
            for r in specials:
                best = empty(())
                for k, off in enumerate(diag):
                    if 0 <= r - off < n:
                        best = pick(best, dv_ref[k, r] + buf_ref[s, lane, r - off], r - off)
                for k, src_row in enumerate(rows):
                    best = pick(best, rv_ref[k, r] + v_rows[k], src_row)
                for k, c in enumerate(cols):
                    if c == r:
                        best = pick(best, *col_min[k]) if path else pick(best, col_min[k], 0)
                for e, (src_state, dst) in enumerate(res):
                    if dst == r:
                        best = pick(best, resv_ref[e] + buf_ref[s, lane, src_state], src_state)
                u = best[0] if path else best
                new = em_ref[o, r] + u
                buf_ref[d, lane, r] = jnp.where(keep, new, buf_ref[s, lane, r])
                if path:
                    src = jnp.where(keep, jnp.where(u < inf, best[1], 0), r)
                    bp[0][t, lane, r] = src.astype(jnp.int16)
            barrier()
            return carry

        lax.fori_loop(0, steps, step, 0)

    return kernel


def kernel_arrays(sop: StructuredOperator, emissions, tile: int = TILE):
    """The kernel's operand arrays ``(em, dv, rv, cv, resv)``: emissions
    ``[E, Np]`` and component values, each with >= 1 row and the state
    axis padded with +inf to ``tile_layout(sop.n, tile)``."""
    n = sop.n
    _, n_k = tile_layout(n, tile)

    def stack(a):  # [K, n_k] values, >= 1 row (+inf filler)
        out = np.full((max(1, a.shape[0]), n_k), np.inf, dtype=np.float32)
        out[: a.shape[0], :n] = a
        return jnp.asarray(out)

    resv = np.full(max(1, sop.residual_nnz), np.inf, dtype=np.float32)
    resv[: sop.residual_nnz] = sop.res_vals
    return (
        stack(np.asarray(emissions, dtype=np.float32)),
        stack(sop.diag_vals),
        stack(sop.row_vals),
        stack(sop.col_vals),
        jnp.asarray(resv),
    )


def structured_scan(
    sop: StructuredOperator,
    arrays,
    carry,
    obs,
    lengths,
    *,
    path: bool = False,
    tile: int = TILE,
    interpret: bool = False,
):
    """Advance ``carry [Np, B]`` over ``obs [T, B]`` in one kernel call.

    ``lengths [B]``: step ``t`` (0-based over ``obs``) applies to lane b
    only while ``t + 1 < lengths[b]`` — the batch decoders' convention,
    where ``obs`` starts at each sequence's second symbol. ``arrays``
    come from :func:`kernel_arrays` at the same ``tile``, which only the
    tests vary. Returns
    ``(carry [Np, B], bp)`` with ``bp [T, B, Np']`` int16 in path mode
    (``Np'`` the padded state count), else ``None``.
    """
    n, b = carry.shape
    steps = obs.shape[0]
    tile, n_k = tile_layout(n, tile)
    if steps == 0:
        return carry, (jnp.zeros((0, b, n_k), jnp.int16) if path else None)
    out_shape = [jax.ShapeDtypeStruct((2, b, n_k), jnp.float32)]
    if path:
        out_shape.append(jax.ShapeDtypeStruct((steps, b, n_k), jnp.int16))
    v0 = jnp.pad(carry.T, ((0, 0), (0, n_k - n)), constant_values=jnp.inf)
    outs = pl.pallas_call(
        _make_kernel(sop, steps, tile, path, interpret),
        out_shape=out_shape,
        grid=(b,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="viterbi_paths" if path else "viterbi_scores",
    )(v0, obs.astype(jnp.int32), lengths.astype(jnp.int32), *arrays)
    final = outs[0][steps % 2, :, :n].T
    return final, (outs[1] if path else None)


def _make_backtrace_kernel(steps: int):
    """Reverse walk: program b follows lane b's pointers from the last
    position down to the first, one dependent gather per step."""

    def kernel(bp_ref, last_ref, out_ref):
        lane = pl.program_id(0)

        def step(i, state):
            t = steps - 1 - i
            prev = bp_ref[t, lane, state].astype(jnp.int32)
            out_ref[t, lane] = prev
            return prev

        lax.fori_loop(0, steps, step, last_ref[lane])

    return kernel


def backtrace(bp, last, *, interpret: bool = False):
    """Reverse walk over ``bp [T, B, Np]`` from ``last [B]`` (the state at
    position T) → ``[T, B]`` int32: row t = the state at position t.

    A kernel of its own: as a ``lax.scan`` the walk cost more than the
    path kernel that wrote the pointers (PERF.md)."""
    steps, b, _ = bp.shape
    if steps == 0:
        return jnp.zeros((0, b), jnp.int32)
    return pl.pallas_call(
        _make_backtrace_kernel(steps),
        out_shape=jax.ShapeDtypeStruct((steps, b), jnp.int32),
        grid=(b,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="viterbi_backtrace",
    )(bp, last.astype(jnp.int32))


def _quantize_total(n: int) -> int:
    """Quantized concatenated-stream length (bounds compiled shapes)."""
    return quantize_t(max(n, 1))


@functools.partial(jax.jit, static_argnames=("t_total",))
def _expand_symbols(flat, off, last, t_total: int):
    """Device-side ragged→rectangular expansion: ``[T, B]`` from the
    concatenated symbol stream.

    ``out[t, b] = flat[min(off[b] + t, last[b])]`` — time padding repeats
    each lane's final symbol (value irrelevant: padded steps are masked or
    belong to sliced-off lanes). The host ships only the real symbols,
    O(Σ len) instead of O(B · max len) for ragged batches.
    """
    t_iota = jnp.arange(t_total, dtype=jnp.int32)[:, None]
    idx = jnp.minimum(off[None, :] + t_iota, last[None, :])
    # flat may arrive int8 (narrow upload); widen after the gather
    return jnp.take(flat, idx).astype(jnp.int32)


class FusedStructuredDecoder(_StreamAPI):
    """Whole-sequence kernel decoder for one HMM: batched scores, exact
    paths, and the streaming protocol."""

    # Byte budget for one call's int16 backpointer tensor; None reads it
    # from the device (see ``utils.device.path_budget_bytes``).
    MAX_PATH_BYTES: int | None = None

    def __init__(
        self,
        sop: StructuredOperator,
        emissions: np.ndarray,
        pi: np.ndarray,
        interpret: bool = False,
    ):
        if not fused_eligible(sop):
            raise ValueError(
                f"operator too irregular for the fused kernel "
                f"(components={sop.num_components}, residual={sop.residual_nnz})"
            )
        self.interpret = interpret
        _, self.n_k = tile_layout(sop.n, TILE)
        self.sop = sop
        self.n = sop.n
        self.states_num = sop.states_num
        self.emit_num = emissions.shape[0]
        self._arrays = kernel_arrays(sop, emissions)
        self.em_t = jnp.asarray(np.asarray(emissions).T)  # [Np, E]
        self.pi = jnp.asarray(pi)  # [Np]
        # symbol uploads ride the narrowest dtype the alphabet allows
        # (int8 covers the whole amino-acid corpus)
        self._sym_dtype = np.int8 if self.emit_num <= 127 else np.int32
        self._model_key = model_key("kernel", emissions, pi, sop)

        self._jit_run = jax.jit(self._run, static_argnames=("b_real",))
        self._jit_run_path = jax.jit(self._run_path, static_argnames=("b_real",))
        self._jit_begin = jax.jit(self._begin)
        self._jit_feed = jax.jit(self._feed)
        self._jit_extract = jax.jit(self._extract, static_argnames=("b_real",))
        self._jit_last = jax.jit(self._last_state)
        self._jit_path_block = jax.jit(
            self._path_block, static_argnames=("b_real",)
        )

    def scan(self, carry, obs, lengths, path: bool = False):
        """One kernel call: ``carry [Np, B]``, ``obs [T, B]``,
        ``lengths [1, B]`` → ``(carry, bp | None)`` (see structured_scan)."""
        return structured_scan(
            self.sop, self._arrays, carry, obs, lengths[0],
            path=path, interpret=self.interpret,
        )

    def _start(self, first):
        """[B] first symbols → [Np, B] start carry (the XLA scan's add)."""
        return self.em_t[:, first] + self.pi[:, None]

    def _scores_core(self, seqs_t, lengths) -> jax.Array:
        """State-major decode: [T, B] symbols → [Np, B] scores.

        The shard_map DP wrapper (``parallel.sharded.make_fused_dp``) calls
        this directly on each device's lane block: lanes are independent,
        so the kernel runs unmodified on the local shard.
        """
        out, _ = self.scan(self._start(seqs_t[0]), seqs_t[1:], lengths)
        return out

    def _path_core(self, seqs_t, lengths):
        """State-major path decode: → (scores [Np, B], path [T, B])."""
        out, bp = self.scan(self._start(seqs_t[0]), seqs_t[1:], lengths, path=True)
        last = jnp.argmin(out, axis=0).astype(jnp.int32)
        rev = backtrace(bp, last, interpret=self.interpret)
        return out, jnp.concatenate([rev, last[None]], axis=0)

    def _run(self, seqs_t, lengths, b_real: int | None = None):
        """[T, B] symbols → [B, Np] scores; ``b_real`` (static) slices the
        padding lanes off on device before any host transfer."""
        out = self._scores_core(seqs_t, lengths).T
        return out if b_real is None else out[:b_real, : self.states_num]

    def _run_path(self, seqs_t, lengths, b_real: int | None = None):
        """→ (scores [B, Np], paths [B, T] int16)."""
        scores, path = self._path_core(seqs_t, lengths)
        scores, path = scores.T, path.T
        if b_real is not None:
            scores = scores[:b_real, : self.states_num]
            path = path[:b_real]
        # states fit int16 (path_supported guarantees it)
        return scores, path.astype(jnp.int16)

    def _path_budget(self) -> int | None:
        if self.MAX_PATH_BYTES is not None:
            return self.MAX_PATH_BYTES
        return path_budget_bytes()

    def path_supported(self, t_max: int, batch: int = 1) -> bool:
        """Whether ONE path call of this shape fits the backpointer budget
        (always, on a device that reports no memory size).

        `decode_path_batch` additionally chunks wide batches into
        successive budget-sized calls, so a batch is decodable whenever
        ``path_supported(t_max)`` holds for one lane.
        """
        if self.n > np.iinfo(np.int16).max:  # int16 backpointers
            return False
        budget = self._path_budget()
        if budget is None:
            return True
        return max(0, t_max - 1) * self.n_k * batch * 2 <= budget

    def _path_lane_budget(self, t_q: int) -> int | None:
        """Max lanes whose backpointers fit."""
        budget = self._path_budget()
        if budget is None:
            return None
        return budget // (max(1, t_q - 1) * self.n_k * 2)

    def decode_path_batch(
        self, seqs: list[np.ndarray], bucketed: bool = True
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """[(scores, path)] per sequence, exact oracle tie-breaking.

        Bucketing (see `decode_batch`) additionally shrinks the int16
        backpointer tensor: each bucket allocates ``t_q·Np·lanes`` instead
        of every lane paying the global max length.
        """
        if not seqs:
            return []
        if bucketed:
            lens = [len(s) for s in seqs]
            plan = bucket_plan(lens, lane_block=1) or [
                (list(range(len(seqs))), max(lens))
            ]
            # lane-chunk each bucket so no single call's backpointer tensor
            # exceeds the device budget
            calls = []
            for idx, t_q in plan:
                if not self.path_supported(t_q):
                    # quantization overshoot (≤1.5×) may cross the budget
                    # even when the real lengths fit — trade shape reuse
                    # for feasibility before giving up
                    t_q = max(lens[i] for i in idx)
                    if not self.path_supported(t_q):
                        raise ValueError(
                            f"path decode of length {t_q} exceeds the "
                            f"backpointer budget even for one lane"
                        )
                step = self._path_lane_budget(t_q) or len(idx)
                calls += [
                    (idx[i : i + step], t_q) for i in range(0, len(idx), step)
                ]
        else:
            t_max = max(len(s) for s in seqs)
            if not self.path_supported(t_max, batch=len(seqs)):
                # refuse BEFORE dispatch: the one-call whole-batch
                # backpointer tensor would not fit the device
                raise ValueError(
                    f"whole-batch path decode ({len(seqs)} lanes × "
                    f"{t_max} steps) exceeds the backpointer budget; "
                    f"use bucketed=True"
                )
            calls = [(list(range(len(seqs))), t_max)]
        outs = []
        for idx, t_q in calls:  # enqueue all calls, drain in order below
            st, ln = self.prepare([seqs[i] for i in idx], t_pad=t_q)
            outs.append(self._jit_run_path(st, ln, b_real=len(idx)))
        result: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(seqs)
        for (idx, _), (scores, paths) in zip(calls, outs):
            scores = np.asarray(scores)
            paths = np.asarray(paths)
            for row, i in enumerate(idx):
                result[i] = (
                    scores[row],
                    paths[row, : len(seqs[i])].astype(np.int32),
                )
        return result

    # ---- streaming hooks (protocol in ops.stream_api) -------------------
    #
    # The kernel's start carry is a resumable input, so decoding composes
    # over chunks: scores(concat(c1, c2)) == feed(feed(begin(o0), c1), c2).

    def _check_path_stream(self) -> None:
        if self.n > np.iinfo(np.int16).max:
            raise ValueError("path streaming needs int16-addressable states")

    def _last_state(self, carry):
        """Per-lane argmin end state (ties → lowest) as [1, B]."""
        return jnp.argmin(carry, axis=0).astype(jnp.int32)[None, :]

    def _path_block(self, carry, chunk, lengths, boundary, b_real: int | None):
        """One finalize block: rematerialize backpointers, backtrace.

        Returns (piece [T_q, b_real] int16 — states at positions
        p+1..p+T_q relative to the chunk start p (entries past the real
        chunk length repeat the boundary via identity pointers; the
        caller slices [:t_c]) — and the new boundary rev[0] = state at
        position p)."""
        _, bp = self.scan(carry, chunk.astype(jnp.int32), lengths, path=True)
        # states at positions p..p+T_q-1
        rev = backtrace(bp, boundary[0], interpret=self.interpret)
        piece = jnp.concatenate([rev[1:], boundary], axis=0)
        return piece[:, :b_real].astype(jnp.int16), rev[0:1]

    def _begin(self, syms):
        return self._start(syms)

    def _feed(self, carry, chunk, lengths):
        out, _ = self.scan(carry, chunk.astype(jnp.int32), lengths)
        return out

    def _extract(self, carry, b_real: int | None = None):
        out = carry.T
        if b_real is not None:  # slice padding lanes off before any D2H
            out = out[:b_real]
        return out[:, : self.states_num]

    def prepare(self, seqs: list[np.ndarray], t_pad: int | None = None):
        """Pad/transfer a batch once; returns (seqs_t [T, B], lengths [1, B]).

        The host ships only the real sequences, concatenated at the narrow
        symbol dtype, and the device expands them. ``t_pad`` forces the
        time dimension to a fixed (e.g. bucket-quantized) length so
        repeated ragged workloads reuse compiled shapes.
        """
        seqs = [validate_obs_seq(s, self.emit_num) for s in seqs]
        if any(len(s) == 0 for s in seqs):
            # the recurrence consumes seq[0] before any masking (the
            # reference likewise indexes seq[0] unconditionally,
            # GraphBLAS_impl.cpp:59)
            raise ValueError("cannot decode an empty sequence")
        t_total = max(2, t_pad or 2, max(len(s) for s in seqs))
        lengths = np.array([len(s) for s in seqs], dtype=np.int32)
        # compact upload: concatenated symbols + per-lane offsets, expanded
        # to [T, B] on device
        off = np.zeros(len(seqs), dtype=np.int32)
        np.cumsum(lengths[:-1], out=off[1:])
        last = (off + lengths - 1).astype(np.int32)
        flat = np.concatenate(seqs).astype(self._sym_dtype)
        q_tot = _quantize_total(flat.size)
        if q_tot != flat.size:  # bound the set of compiled expand shapes
            flat = np.pad(flat, (0, q_tot - flat.size))
        seqs_t = _expand_symbols(
            jnp.asarray(flat), jnp.asarray(off), jnp.asarray(last), t_total
        )
        return seqs_t, jnp.asarray(lengths[None, :])

    def run_prepared(self, handle) -> jax.Array:
        """Decode a prepared batch; returns [B, Np] device scores."""
        return self._jit_run(*handle)

    def decode_batch(
        self, seqs: list[np.ndarray], bucketed: bool = True
    ) -> list[np.ndarray]:
        """Decode a set of sequences; returns final score vectors.

        Ragged batches are length-bucketed (`bucket_plan`): each bucket
        runs only its own quantized max length instead of the global max,
        with all bucket calls enqueued back-to-back and the device queue
        drained once. ``bucketed=False`` forces the single whole-batch
        call (used by the equality tests to cross-check).
        """
        if not seqs:
            return []
        plan = (
            bucket_plan([len(s) for s in seqs], lane_block=1)
            if bucketed
            else None
        )
        if plan is None:
            st, ln = self.prepare(seqs)
            v = np.asarray(self._jit_run(st, ln, b_real=len(seqs)))
            return [v[i] for i in range(len(seqs))]
        outs = []
        for idx, t_q in plan:  # enqueue every bucket
            st, ln = self.prepare([seqs[i] for i in idx], t_pad=t_q)
            outs.append(self._jit_run(st, ln, b_real=len(idx)))
        # single device-side concat → ONE host transfer for all buckets
        v = np.asarray(jnp.concatenate(outs, axis=0))
        result: list[np.ndarray | None] = [None] * len(seqs)
        row = 0
        for idx, _ in plan:
            for i in idx:
                result[i] = v[row]
                row += 1
        return result
