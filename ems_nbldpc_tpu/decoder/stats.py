"""Decoder observability: iteration/convergence traces and candidate-rank
histograms.

The reference carries a dormant ``stat_bubble`` instrumentation array that
histograms which bubble position produced each elementary-step output
(``NB_LDPC.c:159-164,517-556``).  The batched analog: in the truncated combine
``out[s] = min_j Bv[j] + A[s ^ Bg[j]]``, record which *rank* ``j`` of the
truncated side won each output symbol.  The rank histogram tells you how
big ``nm`` really needs to be — exactly what bubble statistics were for.

Also provides a per-iteration convergence trace (frames converged after
each iteration) — the batched analog of the reference's per-frame progress
line (``NB_LDPC.c:498-500``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.minconv import ems_input_truncate, topk_message
from .flooding import (
    _rotate_in,
    _rows_from_edges,
    _vn_totals,
    checknode,
    delta_message,
    syndrome_ok,
)
from .graph import DeviceGraph


@dataclasses.dataclass
class DecodeStats:
    conv_by_iter: np.ndarray      # [max_iters+1] frames converged after i
    iters: np.ndarray             # [F]
    rank_hist: np.ndarray         # [nm] winner-rank histogram (last iter)
    avg_iters: float


def winner_rank_histogram(g: DeviceGraph, vtoc, nm: int):
    """One CN pass recording arg-min ranks. vtoc: [F, E, q] normalized."""
    q = g.q
    f = vtoc.shape[0]
    vt = ems_input_truncate(vtoc, nm)
    vr = _rotate_in(g, vt)
    pad = delta_message((f, 1), q, vr.dtype)
    vr_rows = _rows_from_edges(g, jnp.concatenate([vr, pad], axis=1))
    bv, bg = topk_message(vr_rows, nm)
    dc = vr_rows.shape[-2]
    # forward sweep only (representative of all elementary steps)
    acc = vr_rows[..., 0, :]
    hist = jnp.zeros(nm, jnp.int32)
    s = jax.lax.broadcasted_iota(jnp.int32, (1, q), 1)
    for i in range(1, dc):
        idx = bg[..., i, :, None] ^ s
        ax = jnp.take_along_axis(acc[..., None, :], idx, axis=-1)
        cand = bv[..., i, :, None] + ax
        ranks = jnp.argmin(cand, axis=-2)             # [F, M, q]
        hist = hist + jnp.zeros(nm, jnp.int32).at[ranks.reshape(-1)].add(1)
        acc = jnp.min(cand, axis=-2)
    return hist


def decode_flooding_stats(
    g: DeviceGraph, intrinsic, max_iters: int, nm: int = 0,
    offset: float = 0.0, cn: str = "minsum", cn_impl: str = "auto",
) -> tuple:
    """Like decode_flooding but host-stepped, returning DecodeStats."""
    f, n, q = intrinsic.shape
    e = g.n_edges
    nm_eff = nm if 0 < nm < q else min(q, 32)

    ctov_pad = jnp.zeros((f, e + 1, q), intrinsic.dtype)

    @jax.jit
    def step(ctov_pad, conv):
        tot = _vn_totals(g, intrinsic, ctov_pad)
        vtoc = tot[:, g.edge_col] - ctov_pad[:, :e]
        vtoc = vtoc - jnp.min(vtoc, axis=-1, keepdims=True)
        mcv = checknode(g, vtoc, nm, offset, cn, cn_impl)
        active = ~conv
        ctov_new = jnp.where(
            active[:, None, None],
            jnp.pad(mcv, ((0, 0), (0, 1), (0, 0))), ctov_pad,
        )
        app = _vn_totals(g, intrinsic, ctov_new)
        decide = jnp.argmin(app, axis=-1).astype(jnp.int32)
        conv_new = conv | syndrome_ok(g, decide)
        return ctov_new, conv_new, decide, vtoc

    decide0 = jnp.argmin(intrinsic, axis=-1).astype(jnp.int32)
    conv = syndrome_ok(g, decide0)
    conv_trace = [int(np.asarray(conv.sum()))]
    iters = jnp.zeros(f, jnp.int32)
    last_vtoc = None
    for _ in range(max_iters):
        if bool(np.asarray(conv.all())):
            break
        iters = iters + (~conv).astype(jnp.int32)
        ctov_pad, conv, decide, last_vtoc = step(ctov_pad, conv)
        conv_trace.append(int(np.asarray(conv.sum())))
    if last_vtoc is not None:
        hist = np.asarray(winner_rank_histogram(g, last_vtoc, nm_eff))
    else:
        hist = np.zeros(nm_eff, np.int64)
    iters_np = np.asarray(iters)
    trace = np.asarray(conv_trace + [conv_trace[-1]] * (max_iters + 1 - len(conv_trace)))
    return DecodeStats(
        conv_by_iter=trace,
        iters=iters_np,
        rank_hist=hist,
        avg_iters=float(iters_np.mean()),
    )
