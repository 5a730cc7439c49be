"""Truncated-list EMS check node — sorted (value, GF) lists end to end.

This is the data-parallel redesign of the reference's actual hot path: the
nm-truncated F/B check node of ``/root/reference/bubble_decoder.c:72-593``
(and the v2 program's truncated-output variant,
``EMS_HS_L-BubbleCheck_UBS_decoder_v2.c:1732-1876``).  The reference
approximates each 2-input merge with a sequential 8-bubble extract-min loop
bounded by nbOper candidate examinations with GF dedup.  Here the same merge
is a *data-parallel selection*:

  1. build all na*nb candidate sums / XORs (the full ``tab_aux`` the bubble
     check only samples, ``bubble_decoder.c:384-423``),
  2. one vectorized sort by value,
  3. examine the first W candidates in ascending order with GF dedup —
     exactly the reference's nbOper budget semantics, W = nbOper — via a
     W x W "seen earlier" mask,
  4. keep the best nm distinct-GF entries.

With W >= na*nb this is the *exact* top-nm-distinct merge (an upper bound
on every bubble trajectory); with W = nbOper it reproduces the reference's
truncation structure.  Everything is sorts + elementwise int/float ops:
no gathers, no per-row dynamic indexing.

GF rotation of id lists uses the GF(2)-linearity of multiplication:
``h*g = XOR_b bit_b(g) * (h * 2^b)`` — logq selects + XORs per element
against per-edge constant columns, replacing the reference's MULGF/DIVGF
table lookups (``bubble_decoder.c:133-152,231-254``) without any gather.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .minconv import INF, scatter_topk_dense

# value assigned to deduplicated / unfilled slots; must sort after every
# real LLR but stay far from f32/bf16 saturation when offsets are added
BIG = np.float32(1e9)


def _sort1(x):
    """Single-operand last-axis sort, optionally on a flattened batch.

    NBLDPC_LISTSORT=flat reshapes [..., w] to [prod(batch), w] around the
    sort (a layout choice for sorts of 4-D+ operands; unmeasured on the
    H100).
    """
    if os.environ.get("NBLDPC_LISTSORT", "native") != "flat" or x.ndim <= 2:
        return jax.lax.sort(x)
    shp = x.shape
    return jax.lax.sort(x.reshape(-1, shp[-1])).reshape(shp)


def mul_cols(gf, coefs: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Per-position GF(2)-basis columns of multiplication by ``coefs``.

    Returns int32 [*coefs.shape, logq] with ``out[..., b] = h * alpha_b``
    (or ``h^-1 * alpha_b``), where alpha_b = 2^b in the polynomial basis.
    ``h = 0`` (padding) yields all-zero columns (maps everything to 0);
    padding lanes must be masked to the neutral list by the caller anyway.
    """
    coefs = np.asarray(coefs)
    logq = int(np.log2(gf.q))
    h = coefs.reshape(-1).astype(np.int64)
    if inverse:
        hi = np.zeros_like(h)
        nz = h != 0
        hi[nz] = gf.inv(h[nz])
        h = hi
    basis = 1 << np.arange(logq)
    cols = gf.mul_table[h[:, None], basis[None, :]]
    return cols.reshape(*coefs.shape, logq).astype(np.int32)


def rotate_ids(g: jax.Array, cols: jax.Array) -> jax.Array:
    """XOR-fold rotation of GF id tensors: out = h * g elementwise.

    g: [..., nm] int; cols: [..., logq] int32 broadcastable against
    g's batch dims (typically [G, dc, logq] vs [F, G, dc, nm]).
    """
    logq = cols.shape[-1]
    out = jnp.zeros_like(g)
    for b in range(logq):
        bit = ((g >> b) & 1) != 0
        out = out ^ jnp.where(bit, cols[..., b : b + 1], 0)
    return out


def topk_list(dense: jax.Array, nm: int):
    """Best-nm (ascending values, GF ids) of a dense non-negative message.

    Packed-key variant of ``ops.minconv.topk_message``: values quantize to
    bf16 whose bit pattern is order-isomorphic for non-negatives, so the
    (value, GF) pair sorts as ONE int32 key — the same sort-truncate as
    ``NB_LDPC.c:354-374`` at single-operand sort cost.

    NBLDPC_LIST_TRUNC selects the selection primitive (perf A/B, all three
    produce ascending (vals, ids)):
      - "sort" (default): full packed-key lane sort, slice nm.
      - "topk": ``lax.top_k`` on the negated packed key — EXACT same
        result through a top-k selection instead of a full sort.
      - "approx": ``lax.approx_min_k`` (recall ~0.95) on the f32 values —
        approximate (can miss a true top-nm entry); experimental turbo
        mode, NOT used for parity claims.
    """
    q = dense.shape[-1]
    mode = os.environ.get("NBLDPC_LIST_TRUNC", "sort")
    if mode == "approx":
        vals, ids = jax.lax.approx_min_k(
            jnp.minimum(dense, BIG).astype(jnp.float32), nm
        )
        # quantize like the packed path so downstream dtype behavior matches
        vals = vals.astype(jnp.bfloat16).astype(jnp.float32)
        return vals, ids.astype(jnp.int32)
    vbits = jax.lax.bitcast_convert_type(
        jnp.minimum(dense, BIG).astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.int32)
    key = (vbits << 8) | jnp.arange(q, dtype=jnp.int32)
    if mode == "topk":
        key = -jax.lax.top_k(-key, nm)[0]
    else:
        key = _sort1(key)[..., :nm]
    vals = jax.lax.bitcast_convert_type(
        ((key >> 8) & 0xFFFF).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    return vals, key & 0xFF


def neutral_list(shape, nm: int, dtype=jnp.float32):
    """Identity of the list merge: cost 0 at GF 0, unfilled elsewhere.

    GF ids of the unfilled tail are distinct (iota) so dedup never
    collapses real entries against padding.
    """
    v = jnp.full(tuple(shape) + (nm,), BIG, dtype).at[..., 0].set(0.0)
    g = jnp.broadcast_to(jnp.arange(nm, dtype=jnp.int32), tuple(shape) + (nm,))
    return v, g


def list_combine(
    av: jax.Array,
    ag: jax.Array,
    bv: jax.Array,
    bg: jax.Array,
    nm: int,
    nboper: int = 0,
):
    """Merge two sorted truncated messages: best-nm distinct-GF sums.

    av/bv: [..., na]/[..., nb] ascending costs (BIG = unfilled);
    ag/bg: matching GF ids (int32).  Returns (ov [..., nm] ascending,
    og [..., nm] int32); unfilled slots carry cost >= BIG.

    nboper <= 0: exact top-nm-distinct (every candidate examined — the
    superset of any bubble trajectory).  nboper > 0: candidates are
    restricted to the static staircase {(i+1)(j+1) <= nboper}, which
    contains every candidate an nboper-budgeted extract-min loop
    (``bubble_decoder.c:470-562``) could ever examine — so the result
    dominates (is never worse than) the reference's at the same budget.
    """
    na, nb = av.shape[-1], bv.shape[-1]
    batch = av.shape[:-1]
    if nboper <= 0:
        # exact: full candidate set, f32 values (bit-exact top-nm-distinct)
        cand_v = (av[..., :, None] + bv[..., None, :]).reshape(
            *batch, na * nb
        )
        cand_g = (ag[..., :, None] ^ bg[..., None, :]).reshape(
            *batch, na * nb
        )
        cand_v = jnp.minimum(cand_v, BIG)
        cand_g = cand_g.astype(jnp.int32)
        # dedup: lexicographic sort by (GF, value); the first entry of each
        # GF run is its minimum, the rest are masked out; then order by value
        g_l, v_l = jax.lax.sort((cand_g, cand_v), num_keys=2)
        first = jnp.concatenate(
            [jnp.ones(batch + (1,), bool), g_l[..., 1:] != g_l[..., :-1]],
            axis=-1,
        )
        v_l = jnp.where(first, v_l, BIG)
        v_w, g_w = jax.lax.sort((v_l, g_l), num_keys=1)
        if v_w.shape[-1] < nm:
            pad = nm - v_w.shape[-1]
            pad_v, pad_g = neutral_list(batch, pad, v_w.dtype)
            v_w = jnp.concatenate([v_w, jnp.full_like(pad_v, BIG)], axis=-1)
            g_w = jnp.concatenate([g_w, pad_g], axis=-1)
        return v_w[..., :nm], g_w[..., :nm]

    # budgeted path: staircase candidate support + packed single-key sorts.
    # Values are quantized to bf16 (the message storage dtype anyway): the
    # bit pattern of a non-negative bf16 is order-isomorphic to its value,
    # so (GF, value) packs into ONE int32 sort key — two single-operand
    # int32 sorts instead of two two-operand mixed-type sorts.
    w = min(nboper, na * nb)
    pieces = []
    for i in range(na):
        wi = min(nb, w // (i + 1))
        if wi == 0:
            break
        pv = av[..., i : i + 1] + bv[..., :wi]          # [..., wi]
        pg = ag[..., i : i + 1] ^ bg[..., :wi]
        pieces.append((pv, pg))
    cand_v = jnp.concatenate([p[0] for p in pieces], axis=-1)
    cand_g = jnp.concatenate([p[1] for p in pieces], axis=-1)
    cand_v = jnp.minimum(cand_v, BIG)
    vbits = jax.lax.bitcast_convert_type(
        cand_v.astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.int32)
    g32 = cand_g.astype(jnp.int32)
    # key1: g major, value minor -> GF runs sorted by value
    k1 = _sort1((g32 << 16) | vbits)
    gpart = k1 >> 16
    first = jnp.concatenate(
        [jnp.ones(batch + (1,), bool), gpart[..., 1:] != gpart[..., :-1]],
        axis=-1,
    )
    # key2: value major, g minor (both recoverable); dups -> +inf key
    k2 = ((k1 & 0xFFFF) << 8) | gpart
    k2 = jnp.where(first, k2, jnp.int32(0x7FFFFFFF))
    width = k2.shape[-1]
    if width < nm:
        k2 = jnp.pad(k2, [(0, 0)] * len(batch) + [(0, nm - width)],
                     constant_values=0x7FFFFFFF)
    if os.environ.get("NBLDPC_LIST_CNSEL", "sort") == "topk":
        # only the best nm of the ~nboper*ln(nm) candidates are kept:
        # top_k instead of a full sort — bit-identical
        k2 = -jax.lax.top_k(-k2, nm)[0]
    else:
        k2 = _sort1(k2)[..., :nm]
    dup = k2 == 0x7FFFFFFF
    g_w = jnp.where(dup, jnp.arange(nm, dtype=jnp.int32), k2 & 0xFF)
    v_w = jax.lax.bitcast_convert_type(
        ((k2 >> 8) & 0xFFFF).astype(jnp.uint16), jnp.bfloat16
    ).astype(av.dtype)
    v_w = jnp.where(dup, BIG, v_w)
    return v_w, g_w


def fb_checknode_list(
    bv: jax.Array, bg: jax.Array, nm: int, nboper: int = 0
):
    """Forward/backward CN over truncated lists (EMS semantics exactly).

    bv/bg: [..., dc, nm] sorted rotated input lists.  Returns
    (ov, og): [..., dc, nm] truncated extrinsic outputs per slot — the op
    structure of ``CheckPassLogEMS`` (``bubble_decoder.c:97,166-227``):
    2*(dc-2) chain merges + (dc-2) middle merges, with the fwd and bwd
    chains batched into one merge per step and all middles in one merge.

    NBLDPC_LIST_FB selects the recursion shape:
      - "chain" (default): the reference's own F/B association — dc-2
        sequential 2-wide merges + one (dc-2)-wide middle merge.  The
        budget-matched parity mode.
      - "tree": Hillis-Steele scan over the dc axis — ceil(log2 dc)+1
        sequential merges, each 2*dc wide.  Same objective (truncated
        min-conv of the dc-1 extrinsic inputs, per-merge staircase budget
        honored) under a different association: intermediate truncations
        happen at different points, so outputs are NOT bit-identical to
        the chain; FER equivalence is validated by CI overlap (see
        tests + benchmarks).  Built for wide rows (Ahmed dc=20: 19
        sequential merges/layer -> 6) where chain depth, not width,
        might dominate.
      - "auto": "chain".  On the device it was first tuned on, the tree's
        2*dc-wide merges cost far more sort volume than the depth saved;
        unmeasured on the H100.  Tree stays available as an explicit
        knob only.
    """
    mode = os.environ.get("NBLDPC_LIST_FB", "auto")
    dc = bv.shape[-2]
    # tree mode relies on merge-with-neutral being an exact identity,
    # which needs the staircase to keep every row at column 0: true iff
    # nboper >= nm (or unbudgeted).  The rare nboper < nm configs (e.g.
    # the reference Release target's nm=25 nbOper=24) stay on the chain.
    if mode == "tree" and dc > 3 and (nboper <= 0 or nboper >= nm):
        return _fb_list_tree(bv, bg, nm, nboper)
    if dc == 1:
        nv, ng = neutral_list(bv.shape[:-2], nm, bv.dtype)
        return nv[..., None, :], ng[..., None, :]
    if dc == 2:
        return bv[..., ::-1, :], bg[..., ::-1, :]
    fwd_v, fwd_g = [bv[..., 0, :]], [bg[..., 0, :]]
    bwd_v, bwd_g = [bv[..., dc - 1, :]], [bg[..., dc - 1, :]]
    for i in range(1, dc - 1):
        j = dc - 1 - i
        acc_v = jnp.stack([fwd_v[-1], bwd_v[-1]], axis=-2)
        acc_g = jnp.stack([fwd_g[-1], bwd_g[-1]], axis=-2)
        in_v = jnp.stack([bv[..., i, :], bv[..., j, :]], axis=-2)
        in_g = jnp.stack([bg[..., i, :], bg[..., j, :]], axis=-2)
        nv, ng = list_combine(acc_v, acc_g, in_v, in_g, nm, nboper)
        fwd_v.append(nv[..., 0, :])
        fwd_g.append(ng[..., 0, :])
        bwd_v.append(nv[..., 1, :])
        bwd_g.append(ng[..., 1, :])
    bwd_v = bwd_v[::-1]
    bwd_g = bwd_g[::-1]  # bwd[i] = merge of slots i+1..dc-1
    out_v = [bwd_v[0]]
    out_g = [bwd_g[0]]
    if dc > 2:
        f_v = jnp.stack(fwd_v[: dc - 2], axis=-2)  # [..., dc-2, nm]
        f_g = jnp.stack(fwd_g[: dc - 2], axis=-2)
        b_v = jnp.stack(bwd_v[1 : dc - 1], axis=-2)
        b_g = jnp.stack(bwd_g[1 : dc - 1], axis=-2)
        mv, mg = list_combine(f_v, f_g, b_v, b_g, nm, nboper)
        out_v.extend(mv[..., i, :] for i in range(dc - 2))
        out_g.extend(mg[..., i, :] for i in range(dc - 2))
    out_v.append(fwd_v[-1])
    out_g.append(fwd_g[-1])
    return jnp.stack(out_v, axis=-2), jnp.stack(out_g, axis=-2)


def _fb_list_tree(bv: jax.Array, bg: jax.Array, nm: int, nboper: int):
    """Log-depth prefix/suffix list merges (see fb_checknode_list).

    The suffix scan of x is the reverse of the prefix scan of reversed x,
    so both scans run as ONE Hillis-Steele doubling pass over a stacked
    [..., 2, dc, nm] tensor: ceil(log2 dc) sequential ``list_combine``
    calls of width 2*dc, then one final prefix-x-suffix merge.  Merging
    with the neutral list is exact identity (the staircase always keeps
    column j=0, and neutral tails sort behind every real entry), so the
    masked lanes of the doubling pass are free of special cases.
    """
    dc = bv.shape[-2]
    batch = bv.shape[:-2]

    def shift_down(v, g, s):
        # prepend s neutral slots along the dc axis
        nv, ng = neutral_list(batch + (2, s), nm, v.dtype)
        return (
            jnp.concatenate([nv, v[..., :-s, :]], axis=-2),
            jnp.concatenate([ng, g[..., :-s, :]], axis=-2),
        )

    pv = jnp.stack([bv, bv[..., ::-1, :]], axis=-3)       # [..., 2, dc, nm]
    pg = jnp.stack([bg, bg[..., ::-1, :]], axis=-3)
    s = 1
    while s < dc:
        sv, sg = shift_down(pv, pg, s)
        pv, pg = list_combine(pv, pg, sv, sg, nm, nboper)
        s *= 2
    pre_v, pre_g = pv[..., 0, :, :], pg[..., 0, :, :]     # prefix 0..i
    suf_v = pv[..., 1, ::-1, :]                            # suffix i..dc-1
    suf_g = pg[..., 1, ::-1, :]
    nv1, ng1 = neutral_list(batch + (1,), nm, bv.dtype)
    lo_v = jnp.concatenate([nv1, pre_v[..., :-1, :]], axis=-2)  # 0..i-1
    lo_g = jnp.concatenate([ng1, pre_g[..., :-1, :]], axis=-2)
    hi_v = jnp.concatenate([suf_v[..., 1:, :], nv1], axis=-2)   # i+1..dc-1
    hi_g = jnp.concatenate([suf_g[..., 1:, :], ng1], axis=-2)
    return list_combine(lo_v, lo_g, hi_v, hi_g, nm, nboper)


def saturate_list(ov: jax.Array, offset: float):
    """(normalized ov, sat): reference output handling
    (``bubble_decoder.c:262-278``) on device.

    Normalizes min to 0, computes sat = (last *filled* value) + offset and
    clamps unfilled tail slots to sat.  ov must be ascending.
    """
    ov = ov - ov[..., 0:1]
    filled = ov < BIG / 2
    last = jnp.max(jnp.where(filled, ov, 0.0), axis=-1)
    sat = last + offset
    ov = jnp.minimum(ov, sat[..., None])
    return ov, sat


def expand_list(ov, og, sat, q: int, dtype=None):
    """Truncated (ov, og, sat) -> dense [..., q] message (scatter-min)."""
    dense = scatter_topk_dense(ov, og.astype(jnp.int32), q, fill=INF)
    dense = jnp.minimum(dense, sat[..., None])
    return dense if dtype is None else dense.astype(dtype)
