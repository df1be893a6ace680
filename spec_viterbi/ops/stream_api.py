"""The streaming-decode protocol shared by both decode engines.

``stream_begin/feed/scores`` keep one O(Np·B) score carry over unbounded
input; the ``stream_*_path`` family gives exact paths by checkpointing
the carry at each chunk boundary and re-running the pointer pass per
chunk in reverse; ``stream_save/load`` persist either state. The engines
— the whole-sequence kernel
(:class:`~spec_viterbi.ops.fused_pallas.FusedStructuredDecoder`) and the
XLA structured scan
(:class:`~spec_viterbi.models.streaming_xla.XLAStreamDecoder`) — supply
the compute hooks. No reference analog: ``run_Viterbi`` takes whole
sequences (``Viterbi_impl.h:8``).
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from spec_viterbi.hmm import validate_obs_seq

# Persisted stream states carry this tag inside their model key. Bump it
# whenever the carry encoding changes, so ``stream_load`` refuses files
# written under an older encoding instead of resuming from them.
STREAM_FORMAT = "carry-v2"


def model_key(engine: str, emissions, pi, sop) -> str:
    """Content fingerprint guarding persisted stream states.

    Covers the operator's values AND structure (two models can share
    value bytes while differing in diagonal offsets or index placement),
    with shape+dtype delimiters so array-boundary collisions are
    impossible, plus the engine name and :data:`STREAM_FORMAT`: a state
    only loads into the engine and carry encoding that wrote it.
    """
    h = hashlib.sha1(f"{engine}|{STREAM_FORMAT}|".encode())
    for a in (
        emissions, pi,
        sop.diag_vals, sop.row_vals, sop.col_vals, sop.res_vals,
        np.asarray(sop.diag_offsets, np.int64),
        np.asarray(sop.row_idx, np.int64),
        np.asarray(sop.col_idx, np.int64),
        np.asarray(sop.res_src, np.int64),
        np.asarray(sop.res_dst, np.int64),
    ):
        a = np.ascontiguousarray(a)
        h.update(f"{a.shape}{a.dtype}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


class StreamState(NamedTuple):
    """Resumable streaming-decode state: device carry + real lane count."""

    carry: "jax.Array"  # [Np, B_pad] scores, +inf = unreachable
    b_real: int


class StreamChunk(NamedTuple):
    """One retained chunk: the staged device symbols (already quantized +
    lane-padded — reused verbatim by the finalize re-run, so finalize does
    ZERO host→device transfer) and the real step count."""

    syms: "jax.Array"  # [T_q, B_pad] narrow-dtype device symbols
    lengths: "jax.Array"  # [1, B_pad] int32 per-lane (valid_i + 1)
    t_c: int


class PathStreamState(NamedTuple):
    """Streaming exact-path state: carry + per-chunk checkpoints.

    ``checkpoints[k]`` is the device carry at chunk ``k``'s start (O(Np·B)
    each); ``chunks[k]`` is the chunk's :class:`StreamChunk` (symbols stay
    device-resident — ~0.2 MB/chunk at int8, smaller than the checkpoint;
    the device never holds more than one chunk's [T_c, Np, B] bp
    tensor)."""

    carry: "jax.Array"  # [Np, B_pad]
    b_real: int
    checkpoints: tuple  # tuple of [Np, B_pad] device carries
    chunks: tuple  # tuple of StreamChunk


def _run_path_finalize(state: "PathStreamState", extract, last, block, fetch=np.asarray):
    """Shared checkpoint-rematerialize finalize protocol (single-device
    and DP-sharded): enqueue the score extract, the boundary argmin and
    every reverse path block back to back, then drain once. The chunk
    symbols are already device-resident (StreamChunk), so finalize does
    no host-to-device transfer.

    ``block(ckpt, syms_dev, lengths_dev, boundary) → (piece, boundary)``.
    ``fetch``: host-transfer hook — ``np.asarray`` single-chip; the
    DP-sharded stream passes ``fetch_global`` so finalize works when the
    mesh spans a multi-host process group.
    """
    scores_d = extract(state.carry)
    boundary = last(state.carry)
    pieces = []
    for rec, ckpt in zip(reversed(state.chunks), reversed(state.checkpoints)):
        piece, boundary = block(ckpt, rec.syms, rec.lengths, boundary)
        pieces.append((piece, rec.t_c))
    # ---- single drain of everything enqueued above ----
    first = fetch(boundary)[:, : state.b_real]  # states at position 0
    path = np.concatenate(
        [
            first,
            *[
                fetch(p)[:t_c, : state.b_real].astype(np.int32)
                for p, t_c in reversed(pieces)
            ],
        ],
        axis=0,
    )  # [T_total, B]
    return fetch(scores_d)[: state.b_real], path.T


class _StreamAPI:
    """The streaming-decode protocol, shared by every stream engine.

    ``stream_begin/feed/scores`` (constant-memory scores over unbounded
    input), the ``stream_*_path`` family (exact paths via checkpoint +
    rematerialize), and ``stream_save/load`` persistence. Engines provide
    the compute hooks (``_jit_begin``, ``_jit_feed``, ``_jit_extract``,
    ``_jit_last``, ``_jit_path_block``), plus ``emit_num``/``n``/
    ``_sym_dtype``/``_model_key``/``path_supported``. Two engines exist:
    the whole-sequence kernel
    (:class:`~spec_viterbi.ops.fused_pallas.FusedStructuredDecoder`) and
    the XLA structured scan
    (:class:`~spec_viterbi.models.streaming_xla.XLAStreamDecoder`,
    which accepts ANY operator) — keeping the protocol in one place means
    the long-context API can never be narrower than the parity decode API
    (``Viterbi_impl.h:8`` takes whole sequences; streaming is the
    extension).
    """

    def stream_begin(self, first_symbols: np.ndarray) -> "StreamState":
        """[B] first symbols → streaming state (device carry [Np, B_pad])."""
        syms = validate_obs_seq(first_symbols, self.emit_num)
        if len(syms) == 0:
            raise ValueError("cannot stream an empty lane set")
        return StreamState(self._jit_begin(jnp.asarray(syms)), len(syms))

    def stream_feed(
        self, state: "StreamState", chunk: np.ndarray, valid=None
    ) -> "StreamState":
        """Advance the carry by a [T_c, B] block of symbols.

        ``valid`` (optional, [B] ints): per-lane count of REAL symbols in
        this chunk — lane ``i`` advances by ``valid[i]`` steps and then
        freezes (a finished lane passes 0 and its scores stay fixed), so
        ragged lanes can share one stream exactly like the batch API's
        per-lane masking (the streaming extension must not be narrower
        than the parity decode API, ``Viterbi_impl.h:8``). Omitted = all lanes take
        the full chunk. Symbols past a lane's valid count must still be
        in-alphabet (pad with 0); they are masked off, never decoded.

        The chunk is padded to the ``quantize_t`` length grid and run with
        the masked step (padding steps freeze the carry — bit-identical
        to the unpadded run), so arbitrary arriving chunk sizes compile at
        most ~2 program shapes per octave instead of one per distinct
        ``T_c``."""
        prep = self._prep_stream_chunk(state.carry, state.b_real, chunk, valid)
        if prep is None:
            return state
        chunk, t_c, valid = prep
        return StreamState(
            self._feed_quantized(state.carry, chunk, t_c, valid), state.b_real
        )

    def _prep_stream_chunk(self, carry, b_real: int, chunk, valid=None):
        """Validate + lane-pad a streaming chunk →
        ([T_c, B_pad], t_c, valid [B_pad] | None)."""
        chunk = np.asarray(chunk, dtype=np.int32)
        if chunk.ndim != 2 or chunk.shape[1] != b_real:
            raise ValueError(f"chunk must be [T_c, {b_real}], got {chunk.shape}")
        t_c = chunk.shape[0]
        if t_c == 0:
            return None
        validate_obs_seq(chunk.reshape(-1), self.emit_num)
        b_pad = carry.shape[1]
        if b_pad != chunk.shape[1]:  # padding lanes see symbol 0 — discarded
            chunk = np.pad(chunk, ((0, 0), (0, b_pad - chunk.shape[1])))
        if valid is not None:
            valid = np.asarray(valid, dtype=np.int32)
            if valid.shape != (b_real,):
                raise ValueError(f"valid must be [{b_real}], got {valid.shape}")
            if (valid < 0).any() or (valid > t_c).any():
                raise ValueError(f"valid counts must be in [0, {t_c}]")
            valid = np.pad(valid, (0, b_pad - b_real))  # pad lanes freeze
        return chunk, t_c, valid

    def _stage_quantized(self, chunk, t_c: int, put=None, valid=None):
        """T-quantize + narrow-upload a lane-padded [t_c, B_pad] chunk →
        (syms_dev, lengths_dev). THE one copy of the chunk-staging
        protocol (scores stream, path stream, and the DP-sharded stream
        via its ``put`` placement hook all use it).

        The masked keep-condition is (step + 1) < lengths (the batch
        path's obs starts at symbol 1); chunk steps are absolute, so
        lane length ``valid_i + 1`` (``t_c + 1`` uniform) applies exactly
        steps 0..valid_i-1 and freezes the rest — per-lane raggedness and
        the quantization pad ride the same mask."""
        from spec_viterbi.utils.batching import quantize_t

        t_q = quantize_t(t_c)
        if t_q != t_c:  # padding steps are masked off via lengths
            chunk = np.pad(chunk, ((0, t_q - t_c), (0, 0)))
        if valid is None:
            lengths = np.full((1, chunk.shape[1]), t_c + 1, np.int32)
        else:
            lengths = (valid + 1).astype(np.int32)[None, :]
        syms = chunk.astype(self._sym_dtype)
        if put is None:
            return jnp.asarray(syms), jnp.asarray(lengths)
        return put(syms), put(lengths)

    def _feed_quantized(self, carry, chunk, t_c: int, valid=None):
        """Advance the carry by a lane-padded [t_c, B_pad] chunk."""
        syms_d, lengths_d = self._stage_quantized(chunk, t_c, valid=valid)
        return self._jit_feed(carry, syms_d, lengths_d)

    def stream_scores(self, state: "StreamState") -> np.ndarray:
        """Extract current [B, Np] score vectors (+inf restored); the
        state stays valid — peeking mid-stream is allowed."""
        return np.asarray(self._jit_extract(state.carry, b_real=state.b_real))

    # ---- streaming EXACT-PATH decode: checkpoint + rematerialize ----
    #
    # Exact full-path output needs every step's backpointer, but one
    # device-resident [T, Np, B] pointer tensor caps T at the HBM budget.
    # Streaming instead checkpoints the O(Np·B) carry at each chunk
    # boundary during the forward pass (scores math only — no
    # backpointers), then ``finalize`` re-runs the pointer-producing pass
    # one chunk at a time in REVERSE, backtracing across chunk boundaries.
    # Device memory stays O(chunk) regardless of total length; total
    # device work is 2× the forward pass — the jax.checkpoint/
    # rematerialization trade applied to Viterbi backtrace. No reference
    # analog (the reference has no backtrace at all, Viterbi_impl.h:8-9);
    # paths are bit-identical to the one-shot path decode and the NumPy
    # oracle.

    def _check_path_stream(self) -> None:
        """Engine veto hook for path streaming (pointer-dtype limits)."""

    def stream_begin_path(self, first_symbols: np.ndarray) -> "PathStreamState":
        """[B] first symbols → path-streaming state."""
        self._check_path_stream()
        syms = validate_obs_seq(first_symbols, self.emit_num)
        if len(syms) == 0:
            raise ValueError("cannot stream an empty lane set")
        return PathStreamState(self._jit_begin(jnp.asarray(syms)), len(syms), (), ())

    def stream_feed_path(
        self, state: "PathStreamState", chunk: np.ndarray, valid=None
    ) -> "PathStreamState":
        """Advance by a [T_c, B] block, checkpointing the pre-chunk carry.

        ``valid``: per-lane real-symbol counts as in :meth:`stream_feed`
        — frozen steps store identity pointers during finalize, so a
        ragged lane's path repeats its end state past its true length
        (the caller slices to ``1 + Σ valid``, exactly like the batch
        path API's padding contract).

        The forward pass runs the cheap scores step (identical carry
        math to the pointer pass); backpointers for this chunk only
        materialize during ``stream_path_finalize``. The chunk's quantized
        length must fit the single-call backpointer budget
        (``path_supported``) since finalize re-runs it as one call."""
        from spec_viterbi.utils.batching import quantize_t

        prep = self._prep_stream_chunk(state.carry, state.b_real, chunk, valid)
        if prep is None:
            return state
        chunk, t_c, valid = prep
        b_pad = chunk.shape[1]
        t_q = quantize_t(t_c)
        if not self.path_supported(t_q + 1, batch=b_pad):
            raise ValueError(
                f"path chunk of {t_c} symbols ({t_q} quantized) exceeds the "
                f"backpointer budget at {b_pad} lanes; feed smaller chunks"
            )
        syms_d, lengths_d = self._stage_quantized(chunk, t_c, valid=valid)
        return PathStreamState(
            self._jit_feed(state.carry, syms_d, lengths_d),
            state.b_real,
            state.checkpoints + (state.carry,),
            state.chunks + (StreamChunk(syms_d, lengths_d, t_c),),
        )

    def stream_path_scores(self, state: "PathStreamState") -> np.ndarray:
        """Current [B, Np] scores (peeking is allowed; state stays valid)."""
        return np.asarray(self._jit_extract(state.carry, b_real=state.b_real))

    def stream_path_finalize(
        self, state: "PathStreamState"
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (scores [B, Np], paths [B, T_total]), T_total = 1 + Σ chunk.

        Re-runs the pointer pass per chunk in reverse order; the state is
        not consumed — feeding may continue afterwards."""
        return _run_path_finalize(
            state,
            lambda c: self._jit_extract(c, b_real=state.b_real),
            self._jit_last,
            lambda ck, ch, ln, bd: self._jit_path_block(
                ck, ch, ln, bd, b_real=state.b_real
            ),
        )

    # ---- stream-state persistence (checkpoint/resume across processes) --
    #
    # The carry IS the whole forward state, so a stream survives process
    # restarts by writing it to disk — the streaming analog of the
    # operator cache (SURVEY.md §5 checkpoint/resume; the reference
    # rebuilds everything from scratch every run).

    def stream_save(self, state, path: str) -> None:
        """Persist a StreamState or PathStreamState to ``path`` (.npz)."""
        payload = {
            "carry": np.asarray(state.carry),
            "b_real": np.int64(state.b_real),
            "model_key": np.bytes_(self._model_key.encode()),
        }
        if isinstance(state, PathStreamState):
            payload["n_chunks"] = np.int64(len(state.chunks))
            for k, (ck, rec) in enumerate(zip(state.checkpoints, state.chunks)):
                payload[f"ckpt_{k}"] = np.asarray(ck)
                payload[f"chunk_{k}"] = np.asarray(rec.syms)
                payload[f"tc_{k}"] = np.int64(rec.t_c)
                # per-lane lengths (ragged chunks): finalize re-runs with
                # the exact mask the forward pass used
                payload[f"len_{k}"] = np.asarray(rec.lengths)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)  # atomic publish

    def stream_load(self, path: str):
        """Load a stream state saved by :meth:`stream_save`; resumes
        bit-identically (the carry is the complete forward state)."""
        with np.load(path) as z:
            if bytes(z["model_key"]).decode() != self._model_key:
                raise ValueError(
                    "stream state was saved for a different model/decoder"
                )
            carry = jnp.asarray(z["carry"])
            b_real = int(z["b_real"])
            if "n_chunks" not in z:
                return StreamState(carry, b_real)
            n_chunks = int(z["n_chunks"])
            ckpts = tuple(jnp.asarray(z[f"ckpt_{k}"]) for k in range(n_chunks))
            chunks = []
            for k in range(n_chunks):
                chunks.append(
                    StreamChunk(
                        jnp.asarray(z[f"chunk_{k}"]),
                        jnp.asarray(z[f"len_{k}"]),
                        int(z[f"tc_{k}"]),
                    )
                )
            return PathStreamState(carry, b_real, ckpts, tuple(chunks))


