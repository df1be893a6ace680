"""Collective-traffic accounting from compiled HLO.

The halo-exchange structured TP path exists to make per-step communication
O(components)·B instead of the dense TP path's N·B
(:mod:`spec_viterbi.parallel.structured_tp`). This module measures that
claim instead of asserting it: lower a sharded decode, compile it, and sum
the payload bytes of every collective op in the HLO. Since the decode scan
compiles to a single `while` body, each collective appears once per step —
the static sum IS the per-step traffic.
"""

from __future__ import annotations

import re

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "collective-permute",
    "reduce-scatter",
    "all-to-all",
)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1,
}

# e.g. "%all-gather.3 = f32[2432,8]{1,0} all-gather(" — shape then op name
_OP_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([0-9,]*)\][^=]*?\s(" + "|".join(COLLECTIVE_OPS) + r")\("
)


def collective_payload_bytes(hlo_text: str) -> dict[str, int]:
    """Sum output-payload bytes per collective kind in an HLO dump.

    Payload is approximated by each collective's result shape (for
    all-gather that is the post-gather size — an upper bound on what moves;
    for collective-permute it is exactly the transferred block).
    """
    out: dict[str, int] = {}
    for m in _OP_RE.finditer(hlo_text):
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out[kind] = out.get(kind, 0) + n * _DTYPE_BYTES[dtype]
    return out


def total_collective_bytes(hlo_text: str) -> int:
    return sum(collective_payload_bytes(hlo_text).values())
