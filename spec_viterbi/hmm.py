"""Core HMM data model in modified-probability (−log2) space.

Re-design of the reference data model (``Viterbi_impl/HMM.h:7-60``).
Probabilities are stored as "modified probabilities" ``−log2(p)``; ``p == 0``
maps to ``+inf`` which is the (min,+) semiring zero (``HMM.h:41,51-57``).

The reference keeps the transition structure in COO form because its CPU/GPU
backends are sparse-library based. This class keeps the exact COO fields for
format fidelity *and* offers dense, 128-padded materializations (≤2,407
states ≈ 23 MB per dense f32 operator) and the structured decomposition
(:mod:`spec_viterbi.ops.structured`) builds on them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

# ``Mod_prob_t`` equivalent: float32 everywhere (HMM.h:9-10).
MOD_PROB_DTYPE = np.float32

# The (min,+) semiring zero: probability 0 → +inf (HMM.h:41).
ZERO_PROB = float("inf")

# Fuzzy-equality delta in −log2 space (HMM.h:43-49). Specialization reorders
# float reductions, so the reference tolerates ±1.0.
ALMOST_EQUAL_DELTA = 1.0

# State-axis padding quantum: padded decoders round the state count up to a
# multiple of this, so compiled shapes stay few and aligned.
LANE = 128


def to_modified_prob(p: float) -> float:
    """``−log2(p)`` for p > 0, else the semiring zero ``+inf`` (HMM.h:51-57)."""
    if p > 0.0:
        return -math.log2(p)
    return ZERO_PROB


def to_modified_prob_np(p: np.ndarray) -> np.ndarray:
    """Vectorized :func:`to_modified_prob`."""
    p = np.asarray(p, dtype=np.float64)
    out = np.full(p.shape, ZERO_PROB, dtype=MOD_PROB_DTYPE)
    pos = p > 0.0
    out[pos] = (-np.log2(p[pos])).astype(MOD_PROB_DTYPE)
    return out


def almost_equal(x: float, y: float, delta: float = ALMOST_EQUAL_DELTA) -> bool:
    """Reference fuzzy equality: both +inf, or |x−y| ≤ delta (HMM.h:43-49)."""
    if math.isinf(x) and math.isinf(y) and x > 0 and y > 0:
        return True
    return abs(x - y) <= delta


def almost_equal_vec(
    x: np.ndarray, y: np.ndarray, delta: float = ALMOST_EQUAL_DELTA
) -> bool:
    """Vector fuzzy equality with the reference's semantics (test_helper.h:25-42)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape:
        return False
    both_inf = np.isposinf(x) & np.isposinf(y)
    with np.errstate(invalid="ignore"):  # inf - inf → nan is handled by both_inf
        close = np.abs(x - y) <= delta
    return bool(np.all(both_inf | close))


def is_not_zero_mod_prob(x: float) -> bool:
    """``!almost_equal(x, zero_prob)`` (HMM.h:59)."""
    return not almost_equal(x, ZERO_PROB)


def validate_obs_seq(seq, emit_num: int) -> np.ndarray:
    """Validate an observation sequence against the model's alphabet.

    Returns the sequence as a contiguous int32 array. Raises ``ValueError``
    on any symbol outside ``[0, emit_num)`` — without this check a
    mismatched ``.chmm``/``.ess`` pair decodes garbage silently: JAX
    gathers clamp out-of-range indices and the fused kernel's in-kernel
    one-hot comes out all-zero (not even a NaN). The reference has the
    same silent failure mode (``data_reader.cpp`` never cross-checks
    symbols against ``emit_num``); raising here is a deliberate upgrade.
    """
    arr = np.ascontiguousarray(np.asarray(seq, dtype=np.int32))
    if arr.ndim != 1:
        raise ValueError(f"observation sequence must be 1-D, got shape {arr.shape}")
    if arr.size:
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= emit_num:
            raise ValueError(
                f"observation symbol out of range: sequence contains "
                f"{lo if lo < 0 else hi} but the model emits {emit_num} "
                f"symbols (0..{emit_num - 1}) — mismatched .chmm/.ess pair?"
            )
    return arr


def pad_to_lane(n: int, lane: int = LANE) -> int:
    """Round ``n`` up to a multiple of ``lane`` (min ``lane``)."""
    return max(lane, ((n + lane - 1) // lane) * lane)


@dataclasses.dataclass
class HMM:
    """An HMM in −log2 space, mirroring ``Viterbi_impl/HMM.h:28-38``.

    Fields hold exactly what the ``.chmm`` format carries:

    - ``states_num`` / ``emit_num``: state and alphabet sizes.
    - COO transitions ``trans_rows`` (src), ``trans_cols`` (dst),
      ``trans_probs`` (−log2).
    - ``emissions[symbol, state]`` (−log2) — note the transpose relative to
      the file layout, matching ``data_reader.cpp:49-57``.
    - sparse start distribution ``start_probabilities_cols`` /
      ``start_probabilities`` (−log2).
    """

    states_num: int = 0
    emit_num: int = 0
    trans_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    trans_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    trans_probs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=MOD_PROB_DTYPE)
    )
    emissions: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), dtype=MOD_PROB_DTYPE)
    )
    start_probabilities_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    start_probabilities: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=MOD_PROB_DTYPE)
    )

    @property
    def trans_num(self) -> int:
        return int(self.trans_rows.shape[0])

    @property
    def non_zero_start_probs(self) -> int:
        return int(self.start_probabilities_cols.shape[0])

    # ---- dense materializations (compute path) ------------------------------

    def transition_matrix(self, pad_to: int | None = None) -> np.ndarray:
        """Dense ``[N, N]`` transition matrix ``A[src, dst]`` in −log2 space.

        Missing edges are the semiring zero ``+inf`` (mirrors the dense
        scatter in ``cuASR_helper.cu:167-225``). Duplicate COO entries take
        the min (best path semantics).
        """
        n = pad_to if pad_to is not None else self.states_num
        mat = np.full((n, n), ZERO_PROB, dtype=MOD_PROB_DTYPE)
        if self.trans_num:
            np.minimum.at(
                mat,
                (self.trans_rows, self.trans_cols),
                self.trans_probs.astype(MOD_PROB_DTYPE),
            )
        return mat

    def transposed_transition_matrix(self, pad_to: int | None = None) -> np.ndarray:
        """Dense ``Aᵀ[dst, src]``, the operator the recurrence multiplies by.

        The reference builds this by swapping COO rows/cols at matrix build
        time (``GraphBLAS_impl.cpp:38-45``, ``CUSP_helper.cu:48-55``).
        """
        return self.transition_matrix(pad_to=pad_to).T.copy()

    def start_vector(self, pad_to: int | None = None) -> np.ndarray:
        """Dense start column π in −log2 space, default ``+inf``
        (``GraphBLAS_impl.cpp:9-21``)."""
        n = pad_to if pad_to is not None else self.states_num
        vec = np.full(n, ZERO_PROB, dtype=MOD_PROB_DTYPE)
        if self.non_zero_start_probs:
            np.minimum.at(
                vec,
                self.start_probabilities_cols,
                self.start_probabilities.astype(MOD_PROB_DTYPE),
            )
        return vec

    def emission_matrix(self, pad_to: int | None = None) -> np.ndarray:
        """Dense ``[emit_num, N]`` emission rows, padded states are ``+inf``."""
        n = pad_to if pad_to is not None else self.states_num
        mat = np.full((self.emit_num, n), ZERO_PROB, dtype=MOD_PROB_DTYPE)
        mat[:, : self.states_num] = self.emissions
        return mat

    @property
    def padded_states(self) -> int:
        """State count rounded up to the padding quantum ``LANE``."""
        return pad_to_lane(self.states_num)

    # ---- identity ----------------------------------------------------------

    def fingerprint(self) -> str:
        """Stable content hash, used as the operator-cache key.

        The reference has no persistence — ``spec_with`` rebuilds operators
        on every call (``GraphBLAS_spec_impl.cpp:45-48``); keying a disk
        cache by content hash is our extension (SURVEY.md §5 checkpoint).
        """
        h = hashlib.sha256()
        h.update(np.int64([self.states_num, self.emit_num, self.trans_num]).tobytes())
        for arr in (
            self.trans_rows,
            self.trans_cols,
            self.trans_probs,
            self.emissions,
            self.start_probabilities_cols,
            self.start_probabilities,
        ):
            # shape+dtype delimiters: without them, array byte boundaries
            # are ambiguous and differently-shaped HMMs could alias; with a
            # canonical dtype, int32 vs int64 index arrays hash the same
            a = np.ascontiguousarray(arr)
            canon = (
                a.astype(np.int64) if np.issubdtype(a.dtype, np.integer)
                else a.astype(np.float32)
            )
            h.update(repr((canon.shape, str(canon.dtype))).encode())
            h.update(canon.tobytes())
        return h.hexdigest()[:32]

    def validate(self) -> None:
        """Structural sanity checks (bounds, shapes)."""
        n, e = self.states_num, self.emit_num
        if self.emissions.shape != (e, n):
            raise ValueError(
                f"emissions shape {self.emissions.shape} != ({e}, {n})"
            )
        for name, idx, bound in (
            ("trans_rows", self.trans_rows, n),
            ("trans_cols", self.trans_cols, n),
            ("start_probabilities_cols", self.start_probabilities_cols, n),
        ):
            if idx.size and (idx.min() < 0 or idx.max() >= bound):
                raise ValueError(f"{name} has out-of-range state index")
        if self.trans_rows.shape != self.trans_cols.shape or self.trans_rows.shape != self.trans_probs.shape:
            raise ValueError("COO transition arrays have mismatched lengths")
        if self.start_probabilities_cols.shape != self.start_probabilities.shape:
            raise ValueError("start probability arrays have mismatched lengths")
