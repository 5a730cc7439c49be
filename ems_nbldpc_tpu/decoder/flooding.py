"""Flooding-schedule EMS/min-sum decoder, batched over frames.

One iteration updates *all* M check nodes from the previous iteration's
messages — the maximally parallel schedule (the reference's layered loop at
``NB_LDPC.c:313-472`` is the serial special case; see layered.py for the
super-layer version).  All tensors are ``[F, ..., q]`` with F = frames.

Early termination: the per-frame syndrome check (``NB_LDPC.c:468-471``,
``tools.c:284-299``) becomes a convergence mask; decisions latch at the first
syndrome-zero iteration and the loop exits when every frame has converged
(or the iteration budget is spent).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..ops.minconv import (fb_checknode_dense, fb_checknode_topk,
                           delta_message, ems_input_truncate,
                           ems_output_saturate, topk_message)
from ..ops.syndrome_cn import syndrome_checknode
from ..ops.fht import fb_checknode_spa, fb_checknode_spa_fused
from .graph import DeviceGraph

# see layered.SPA_FUSED (shared env switch)
SPA_FUSED = os.environ.get("NBLDPC_SPA_FUSED", "1") != "0"


def zeros_like_vma(ref, shape, dtype):
    """Zeros carrying ``ref``'s device-varying (vma) annotation.

    Inside ``shard_map(..., check_vma=True)`` a plain ``jnp.zeros`` is
    *replicated*; if a while_loop carry starts replicated but becomes
    device-varying after one iteration the carry types mismatch.  Deriving
    the zeros from ``ref`` (any per-shard input) gives them the same vma,
    so loop carries typecheck — and outside shard_map this folds away."""
    seed = (ref.reshape(-1)[0] * 0).astype(dtype)
    return jnp.zeros(shape, dtype) + seed


def _vn_totals(g: DeviceGraph, intrinsic, ctov_pad):
    """APP totals: intrinsic + sum of incident CtoV.  [F, N, q]."""
    inc = ctov_pad[:, g.col_edges]          # [F, N, dv, q]
    return intrinsic + inc.sum(axis=2)


def _rows_from_edges(g: DeviceGraph, x_pad):
    """[F, E+1, q] -> [F, M, dc, q] via static row-edge gather."""
    return x_pad[:, g.row_edges]


def _edges_from_rows(g: DeviceGraph, x_rows):
    """[F, M, dc, q] -> [F, E, q]."""
    return x_rows[:, g.code.edge_row, g.edge_slot]


def _rotate_in(g: DeviceGraph, vtoc):
    """msg over c -> msg over u = h*c (coefficient-grouped static perms)."""
    return g.rotplan.apply(vtoc, "in")


def _rotate_out(g: DeviceGraph, mcv_r):
    """msg over u -> msg over c (coefficient-grouped static perms)."""
    return g.rotplan.apply(mcv_r, "out")


def syndrome_ok(g: DeviceGraph, decide):
    """[F, N] hard decisions -> [F] bool all-checks-satisfied.

    u_e = h_e * decide[col_e] via the rotation permutation; XOR-reduce per
    row (GF add = XOR in poly rep).  Batched ``Syndrom`` (tools.c:284-299).
    """
    sym = decide[:, g.edge_col]                              # [F, E]
    u = g.rotplan.apply_indices(sym[..., None], "in")[..., 0]
    u_pad = jnp.pad(u, ((0, 0), (0, 1)))                     # pad edge -> 0
    u_rows = u_pad[:, g.row_edges]                           # [F, M, dc]
    synd = u_rows[..., 0]
    for i in range(1, u_rows.shape[-1]):
        synd = synd ^ u_rows[..., i]
    return jnp.all(synd == 0, axis=-1)


def use_topk(cn: str, nm: int, q: int, cn_impl: str) -> bool:
    if cn_impl == "topk":
        return True
    if cn_impl == "dense":
        return False
    # auto: truncated combine wins when nm is well below q (it is also the
    # only option that fits HBM for GF(256) at scale)
    return cn == "ems" and 0 < nm <= q // 2


def checknode(g: DeviceGraph, vtoc, nm: int, offset: float, cn: str,
              cn_impl: str = "auto", syn: dict | None = None,
              nboper: int = 0):
    """Shared CN step: rotate in, dense F/B min-conv, rotate out.

    vtoc: [F, E, q] min-normalized variable-to-check messages.
    Returns mcv [F, E, q].
    """
    q = g.q
    f = vtoc.shape[0]
    if cn == "ems" and nm < q:
        vtoc = ems_input_truncate(vtoc, nm)
    if cn == "spa" and SPA_FUSED:
        # rotations folded into the Hadamard matmuls (fht.grouped_wht);
        # padding slots (edge id E -> zero msg, h=0) transform to the
        # neutral w=1 with no masking
        vt_pad = jnp.concatenate(
            [vtoc, jnp.zeros((f, 1, q), vtoc.dtype)], axis=1
        )
        rows = _rows_from_edges(g, vt_pad)               # [F, M, dc, q]
        mcv_rows = fb_checknode_spa_fused(rows, g.rows_rotplan, g.code.gf)
        mcv = _edges_from_rows(g, mcv_rows)
        return mcv - jnp.min(mcv, axis=-1, keepdims=True)
    vr = _rotate_in(g, vtoc)
    pad = delta_message((f, 1), q, vr.dtype)
    vr_pad = jnp.concatenate([vr, pad], axis=1)
    vr_rows = _rows_from_edges(g, vr_pad)                    # [F, M, dc, q]
    valid = None if g.regular else jnp.asarray(g.edge_valid_row)[None]
    if cn == "spa":
        mcv_rows = fb_checknode_spa(vr_rows, valid)
    elif cn == "syndrome":
        nm_eff = nm if nm > 0 else min(q, 32)
        vals, gfs = topk_message(vr_rows, nm_eff)
        mcv_rows = syndrome_checknode(
            vals, gfs, q, offset=offset, **(syn or {})
        )
    elif cn_impl in ("bubble", "lbubble"):
        # EXACT sequential bubble emulation (validation tool, not a
        # throughput path — see ops/bubble_cn.py)
        from ..ops.bubble_cn import fb_checknode_bubble

        if valid is not None:
            neutral = delta_message(vr_rows.shape[:-1], q, vr_rows.dtype)
            vr_rows = jnp.where(valid[..., None], vr_rows, neutral)
        budget = nboper if nboper > 0 else 2 * nm
        mcv_rows = fb_checknode_bubble(
            vr_rows, nm, budget, offset,
            variant="8" if cn_impl == "bubble" else "L",
        )
        mcv_r = _edges_from_rows(g, mcv_rows)
        mcv = _rotate_out(g, mcv_r)
        # the exact fill rule is applied inside (golden.check_pass_ems
        # semantics); ems_output_saturate would be a redundant no-op
        return mcv - jnp.min(mcv, axis=-1, keepdims=True)
    elif use_topk(cn, nm, q, cn_impl):
        mcv_rows = fb_checknode_topk(vr_rows, nm, valid)
    else:
        mcv_rows = fb_checknode_dense(vr_rows, valid)
    mcv_r = _edges_from_rows(g, mcv_rows)
    mcv = _rotate_out(g, mcv_r)
    if cn == "ems" and nm < q:
        # output saturation: entries beyond the nm best are clamped to
        # (nm-th best + offset), the dense-expansion fill rule of
        # bubble_decoder.c:262-278
        mcv = ems_output_saturate(mcv, nm, offset)
    return mcv - jnp.min(mcv, axis=-1, keepdims=True)


def decode_flooding(
    g: DeviceGraph,
    intrinsic,               # [F, N, q] min-cost, normalized
    max_iters: int,
    nm: int = 0,
    offset: float = 0.0,
    cn: str = "minsum",      # minsum (dense-exact) | ems (truncated) | syndrome
    cn_impl: str = "auto",   # "dense" | "topk" | "auto"
    syn: dict | None = None,
    nboper: int = 0,
):
    """Returns (decide [F,N] int32, iters [F] int32, converged [F] bool)."""
    f, n, q = intrinsic.shape
    e = g.n_edges
    ctov_pad0 = zeros_like_vma(intrinsic, (f, e + 1, q), intrinsic.dtype)

    def compute_decide(ctov_pad):
        app = _vn_totals(g, intrinsic, ctov_pad)
        return jnp.argmin(app, axis=-1).astype(jnp.int32)

    d0 = compute_decide(ctov_pad0)
    conv0 = syndrome_ok(g, d0)

    def cond(state):
        it, _, _, conv, _ = state
        return (it < max_iters) & ~jnp.all(conv)

    def body(state):
        it, ctov_pad, decide, conv, iters = state
        tot = _vn_totals(g, intrinsic, ctov_pad)
        vtoc = tot[:, g.edge_col] - ctov_pad[:, :e]
        vtoc = vtoc - jnp.min(vtoc, axis=-1, keepdims=True)
        mcv = checknode(g, vtoc, nm, offset, cn, cn_impl, syn, nboper)
        active = ~conv
        ctov_new = jnp.where(
            active[:, None, None],
            jnp.pad(mcv, ((0, 0), (0, 1), (0, 0))),
            ctov_pad,
        )
        d_new = compute_decide(ctov_new)
        decide = jnp.where(active[:, None], d_new, decide)
        now_ok = syndrome_ok(g, decide)
        conv_new = conv | now_ok
        iters = iters + active.astype(jnp.int32)
        return it + 1, ctov_new, decide, conv_new, iters

    state = (jnp.int32(0), ctov_pad0, d0, conv0,
             zeros_like_vma(intrinsic, (f,), jnp.int32))
    _, _, decide, conv, iters = jax.lax.while_loop(cond, body, state)
    return decide, iters, conv
