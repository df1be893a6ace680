"""Mesh-parallel decoding: DP (batch), TP (state blocks), SP (time blocks).

The reference has no distributed machinery (SURVEY.md §2.9); this package is
the scaling layer over `jax.sharding.Mesh` + `shard_map` with XLA
collectives.
"""

from spec_viterbi.parallel.mesh import (
    DATA_AXIS,
    STATE_AXIS,
    TIME_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
)
from spec_viterbi.parallel.sharded import (
    decode_batch_dp,
    decode_batch_dp_fused,
    decode_batch_dp_tp,
    decode_path_batch_dp_fused,
    decode_time_parallel,
    decode_tp,
    make_dp_tp_decode,
    make_fused_dp,
    StreamDP,
    make_time_parallel_decode,
    make_tp_decode,
)
from spec_viterbi.parallel.distributed import init_distributed, process_info
from spec_viterbi.parallel.structured_tp import (
    decode_batch_structured_dp,
    decode_batch_structured_tp,
    make_structured_dp_decode,
    make_structured_tp_decode,
    structured_tp_supported,
)

__all__ = [
    "DATA_AXIS",
    "STATE_AXIS",
    "TIME_AXIS",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "decode_batch_dp",
    "decode_batch_dp_fused",
    "decode_batch_dp_tp",
    "decode_path_batch_dp_fused",
    "make_fused_dp",
    "StreamDP",
    "decode_time_parallel",
    "decode_tp",
    "make_dp_tp_decode",
    "make_time_parallel_decode",
    "make_tp_decode",
    "init_distributed",
    "process_info",
    "decode_batch_structured_dp",
    "decode_batch_structured_tp",
    "make_structured_dp_decode",
    "make_structured_tp_decode",
    "structured_tp_supported",
]
