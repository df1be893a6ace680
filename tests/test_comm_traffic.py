"""Regression tests for the TP communication bounds.

The halo-exchange structured TP design's reason to exist is that per-step
collective traffic is O(components)·B — independent of model size — while
dense TP all-gathers the N-row carry. These tests compile both paths on
the virtual CPU mesh and assert the bound from the HLO itself.
"""

import os

import jax.numpy as jnp

from conftest import CHMM_DIR

from spec_viterbi.io import read_hmm
from spec_viterbi.ops.structured import StructuredOperator
from spec_viterbi.parallel import make_mesh
from spec_viterbi.parallel.sharded import make_dp_tp_decode
from spec_viterbi.parallel.structured_tp import make_structured_tp_decode
from spec_viterbi.utils.comm import (
    collective_payload_bytes,
    total_collective_bytes,
)

B = 8
T = 6


def _structured_tp_hlo(model: str, shards: int) -> str:
    hmm = read_hmm(os.path.join(CHMM_DIR, model))
    sop = StructuredOperator.from_hmm(hmm)
    mesh = make_mesh(state=shards)
    fn = make_structured_tp_decode(sop, mesh)
    n = sop.n
    args = (
        jnp.zeros((max(1, sop.diag_vals.shape[0]), n), jnp.float32),
        jnp.zeros((max(1, sop.row_vals.shape[0]), n), jnp.float32),
        jnp.zeros((max(1, sop.col_vals.shape[0]), n), jnp.float32),
        jnp.zeros((1, max(1, sop.residual_nnz)), jnp.float32),
        jnp.zeros((n, hmm.emit_num), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((T, B), jnp.int32),
        jnp.full((B,), T, jnp.int32),
    )
    return fn.lower(*args).compile().as_text(), sop


def test_halo_tp_traffic_is_model_size_independent():
    """Per-step collective payload of halo TP must not grow with N."""
    hlo_small, sop_s = _structured_tp_hlo("100.chmm", 4)
    hlo_large, sop_l = _structured_tp_hlo("1200.chmm", 4)
    assert sop_l.n > 4 * sop_s.n  # genuinely different model sizes
    small = total_collective_bytes(hlo_small)
    large = total_collective_bytes(hlo_large)
    assert small > 0  # the halos and pmin reductions are really there
    assert large == small, (
        f"halo-TP per-step collective bytes grew with model size: "
        f"{small} -> {large}"
    )


def test_halo_tp_traffic_bound_vs_dense_tp():
    """Halo TP must move a small constant per step; dense TP moves O(N·B)."""
    model = "1200.chmm"
    hlo_halo, sop = _structured_tp_hlo(model, 4)
    halo = collective_payload_bytes(hlo_halo)
    halo_total = sum(halo.values())

    # analytic bound: per diagonal a |d|-row halo [|d|, B]; per dense row /
    # col / residual entry a [1, B] pmin; pmin doubles as an all-reduce
    # (result counted at full size on every device). Allow 4x slack for
    # XLA's accounting (e.g. fused/rewritten reductions).
    comp_msgs = (
        sum(abs(d) for d in sop.diag_offsets)
        + len(sop.row_idx)
        + len(sop.col_idx)
        + sop.residual_nnz
    )
    bound = 4 * comp_msgs * B * 4
    assert halo_total <= bound, (halo, bound)

    # dense TP: the per-step all-gather materializes the [N, B] carry
    hmm = read_hmm(os.path.join(CHMM_DIR, model))
    from spec_viterbi.models.decoder import DeviceHMM

    dev = DeviceHMM.from_hmm(hmm)
    mesh = make_mesh(data=2, state=4)
    fn = make_dp_tp_decode(mesh)
    args = (
        dev.a,
        dev.pi,
        jnp.asarray(dev.emissions).T,
        jnp.zeros((T, B), jnp.int32),
        jnp.full((B,), T, jnp.int32),
    )
    hlo_dense = fn.lower(*args).compile().as_text()
    dense_total = total_collective_bytes(hlo_dense)
    assert dense_total >= dev.padded * (B // 2) * 4  # N·B_local floats
    # the design claim: orders of magnitude less traffic
    assert halo_total * 20 < dense_total, (halo_total, dense_total)
