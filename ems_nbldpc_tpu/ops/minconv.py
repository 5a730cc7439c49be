"""Dense min-convolution over the XOR group GF(2)^m — the check-node core.

The EMS check node computes, for each output symbol ``s``, the cheapest way
to write ``s`` as an XOR of one symbol from each input message (reference:
forward/backward recursion of ``CheckPassLogEMS``,
``/root/reference/bubble_decoder.c:72-305``, built from 2-input
``ElementaryStep`` merges).  The C code approximates each 2-input merge with a
sequential 8-bubble extract-min loop (``bubble_decoder.c:316-593``) — a
CPU-ism.  Batched on an accelerator, the same 2-input merge is a *dense tropical convolution*:

    out[s] = min_a (A[a] + B[a ^ s])

which is a superset of every bubble/L-bubble approximation (SURVEY.md §7.3):
it examines all q^2 candidate pairs instead of a bubble-bounded subset, at
perfectly regular elementwise cost with zero data-dependent control flow.

``nm``-truncation semantics (EMS) are recovered by saturating inputs outside
their best-``nm`` entries before the convolution and clamping outputs — see
:func:`ems_truncate`.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

INF = 1e9

# elementary-combine implementation: "shuffle" (xor block swaps),
# "gather" (take_along_axis), or "auto" (gather for small q, shuffle for
# q >= 128, where per-element minor-dim gathers were slow on the device
# this was first tuned on; the threshold is unmeasured on the H100).
MINCONV_IMPL = os.environ.get("NBLDPC_MINCONV", "auto")


def _mc(a, bv, bg):
    impl = MINCONV_IMPL
    if impl == "auto":
        impl = "shuffle" if a.shape[-1] >= 128 else "gather"
    if impl == "shuffle":
        return minconv_topk_shuffle(a, bv, bg)
    return minconv_topk(a, bv, bg)  # "unreachable" cost; reference uses 1e5 (bubble_decoder.c:107)


@functools.lru_cache(maxsize=None)
def _xor_table(q: int) -> np.ndarray:
    a = np.arange(q)
    return (a[:, None] ^ a[None, :]).astype(np.int32)


def minconv_xor(a: jax.Array, b: jax.Array) -> jax.Array:
    """Tropical XOR-convolution: out[..., s] = min_t a[..., t] + b[..., t^s].

    ``a``/``b``: [..., q]. The [q, q] XOR gather table is a trace-time
    constant, so XLA fuses gather + add + min-reduce without materializing
    the q×q intermediate per row.
    """
    q = a.shape[-1]
    xt = jnp.asarray(_xor_table(q))
    bx = b[..., xt]                      # [..., q_t, q_s]
    return jnp.min(a[..., :, None] + bx, axis=-2)


def delta_message(shape, q: int, dtype=jnp.float32) -> jax.Array:
    """Identity element of minconv: cost 0 at symbol 0, INF elsewhere."""
    base = jnp.full((q,), INF, dtype=dtype).at[0].set(0.0)
    return jnp.broadcast_to(base, tuple(shape) + (q,))


def ems_input_truncate(v: jax.Array, nm: int) -> jax.Array:
    """Exclude everything outside the best ``nm`` entries of a message.

    Mirrors the sort-truncate at ``NB_LDPC.c:354-374``: the reference CN
    only ever *sees* the nm best (value, GF) pairs of each VtoC message —
    symbols beyond the list can never participate in a candidate sum.  In
    dense form that is a hard exclusion (cost = INF), NOT an offset
    saturation (which would wrongly make tail symbols look cheap).
    """
    q = v.shape[-1]
    if nm >= q:
        return v
    kth = -jax.lax.top_k(-v, nm)[0][..., -1:]
    return jnp.where(v <= kth, v, INF)


def ems_output_saturate(v: jax.Array, nm: int, offset: float) -> jax.Array:
    """Clamp a dense CN output to its nm best entries + offset saturation.

    The reference keeps at most nm CN outputs and re-densifies with fill
    value ``(last kept) + offset`` (``bubble_decoder.c:262-278``).  Densely:
    every entry above the nm-th best collapses to ``nm-th best + offset``.
    """
    q = v.shape[-1]
    if nm >= q:
        return v
    kth = -jax.lax.top_k(-v, nm)[0][..., -1:]
    return jnp.minimum(v, kth + offset)


def topk_message(v: jax.Array, nm: int):
    """Best-nm (ascending values, GF ids) of a dense min-cost message."""
    negv, gfs = jax.lax.top_k(-v, nm)
    return -negv, gfs


def xor_gather(a: jax.Array, g: jax.Array) -> jax.Array:
    """out[..., s] = a[..., s ^ g[...]] without any gather.

    XOR-permutation by a per-row value ``g`` decomposes into log2(q)
    data-independent block swaps: for each bit b of g, swap lane blocks of
    stride 2^b.  Each swap is two static rolls + a static lane mask, plus
    an elementwise select on the per-row bit — pure elementwise work
    instead of a per-element dynamic gather along the minor dimension
    (see ``MINCONV_IMPL`` for when it is chosen).

    a: [..., q]; g: [...] int32 (broadcastable to a.shape[:-1]).
    """
    q = a.shape[-1]
    m = q.bit_length() - 1
    iota = jnp.arange(q)
    for b in range(m):
        s = 1 << b
        lo = (iota & s) == 0  # static lane mask: bit b of the index clear
        swapped = jnp.where(
            lo, jnp.roll(a, -s, axis=-1), jnp.roll(a, s, axis=-1)
        )
        bit = ((g >> b) & 1).astype(bool)
        a = jnp.where(bit[..., None], swapped, a)
    return a


def minconv_topk_shuffle(a: jax.Array, bv: jax.Array,
                         bg: jax.Array) -> jax.Array:
    """Gather-free variant of :func:`minconv_topk` using xor_gather.

    out[..., s] = min_j bv[..., j] + a[..., s ^ bg[..., j]].

    Vectorized over the nm candidates for small q; sequential fori
    accumulation for large q (bounds the [..., nm, q] intermediate).
    """
    q = a.shape[-1]
    nm = bv.shape[-1]
    if q <= 64:
        ax = xor_gather(
            jnp.broadcast_to(a[..., None, :], a.shape[:-1] + (nm, q)), bg
        )
        return jnp.min(bv[..., :, None] + ax, axis=-2)

    def body(j, acc):
        shifted = xor_gather(a, bg[..., j])
        return jnp.minimum(acc, bv[..., j, None] + shifted)

    init = bv[..., 0, None] + xor_gather(a, bg[..., 0])
    return jax.lax.fori_loop(1, nm, body, init)


def scatter_topk_dense(bv: jax.Array, bg: jax.Array, q: int,
                       fill: float = INF) -> jax.Array:
    """Dense [..., q] message from a truncated (values, GF ids) list:
    out[g] = bv[j] where bg[j] == g, else ``fill`` — a one-hot masked min
    (no scatter primitive)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, q), 1)
    onehot = bg[..., :, None] == iota                    # [..., nm, q]
    return jnp.min(jnp.where(onehot, bv[..., :, None], fill), axis=-2)


def minconv_topk(a: jax.Array, bv: jax.Array, bg: jax.Array) -> jax.Array:
    """Truncated tropical XOR-convolution.

    out[..., s] = min_j bv[..., j] + a[..., s ^ bg[..., j]]

    ``a``: dense [..., q]; ``(bv, bg)``: the nm best entries of the other
    message.  This is the EMS elementary step with the *b* side truncated to
    nm symbols — the same information the reference's bubble check consumes
    (``bubble_decoder.c:316-593``) but examining all nm*q candidates instead
    of a bubble-bounded subset.  Peak memory [..., nm, q] instead of the
    dense version's [..., q, q].
    """
    q = a.shape[-1]
    s = jax.lax.broadcasted_iota(jnp.int32, (1, q), 1)
    idx = bg[..., :, None] ^ s                      # [..., nm, q]
    ax = jnp.take_along_axis(a[..., None, :], idx, axis=-1)
    return jnp.min(bv[..., :, None] + ax, axis=-2)


def fb_checknode_topk(
    vr: jax.Array, nm: int, valid: jax.Array | None = None
) -> jax.Array:
    """F/B CN with nm-truncated combine steps (EMS semantics).

    vr: [..., dc, q] rotated inputs (already INF-excluded outside their nm
    best is NOT required — truncation happens here via top_k).
    Intermediate accumulations stay dense (a superset of the reference's
    nm-truncated intermediates); each combine only admits the nm best of the
    incoming side, exactly the reference's deviation structure.
    """
    dc = vr.shape[-2]
    q = vr.shape[-1]
    if valid is not None:
        neutral = delta_message(vr.shape[:-1], q, vr.dtype)
        vr = jnp.where(valid[..., None], vr, neutral)
    if dc <= 2:
        return fb_checknode_dense(vr)
    bv, bg = topk_message(vr, nm)                   # [..., dc, nm]
    msgs = [vr[..., i, :] for i in range(dc)]
    # F/B recursion: run both directions in one batched combine per step
    fwd = [msgs[0]]
    bwd = [msgs[-1]]
    for i in range(1, dc - 1):
        j = dc - 1 - i
        acc = jnp.stack([fwd[-1], bwd[-1]], axis=-2)          # [..., 2, q]
        sv = jnp.stack([bv[..., i, :], bv[..., j, :]], axis=-2)
        sg = jnp.stack([bg[..., i, :], bg[..., j, :]], axis=-2)
        nxt = _mc(acc, sv, sg)
        fwd.append(nxt[..., 0, :])
        bwd.append(nxt[..., 1, :])
    bwd = bwd[::-1]  # bwd[i] = conv of msgs[i+1..dc-1]
    outs = [bwd[0]]
    if dc > 2:
        # all middle merges in one batched combine
        b_stack = jnp.stack(bwd[1: dc - 1], axis=-2)          # [..., dc-2, q]
        tv, tg = topk_message(b_stack, nm)
        f_stack = jnp.stack(fwd[: dc - 2], axis=-2)
        mid = _mc(f_stack, tv, tg)
        outs.extend(mid[..., i, :] for i in range(dc - 2))
    outs.append(fwd[-1])
    return jnp.stack(outs, axis=-2)


def fb_checknode_dense(vr: jax.Array, valid: jax.Array | None = None) -> jax.Array:
    """Forward/backward dense CN over the dc axis.

    vr: [..., dc, q] rotated input messages (min-cost, XOR constraint).
    valid: optional [..., dc] bool — False entries are padding (treated as
    the delta message so they contribute nothing and their outputs are
    meaningless but well-defined).

    Returns mcv_r: [..., dc, q], the extrinsic output for each input slot.
    Cost: 3*(dc-2) minconvs, matching the reference op structure
    (``bubble_decoder.c:97,166-227``) but each a dense q^2 kernel.
    """
    dc = vr.shape[-2]
    q = vr.shape[-1]
    if valid is not None:
        neutral = delta_message(vr.shape[:-1], q, vr.dtype)
        vr = jnp.where(valid[..., None], vr, neutral)
    if dc == 1:
        return delta_message(vr.shape[:-1], q, vr.dtype)
    if dc == 2:
        return vr[..., ::-1, :]
    msgs = [vr[..., i, :] for i in range(dc)]
    fwd = [msgs[0]]
    bwd = [msgs[-1]]
    for i in range(1, dc - 1):
        fwd.append(minconv_xor(fwd[-1], msgs[i]))
        bwd.append(minconv_xor(bwd[-1], msgs[dc - 1 - i]))
    bwd = bwd[::-1]  # bwd[i] = conv of msgs[i+1..dc-1] at position i
    outs = [bwd[0]]
    # middle outputs: batch the dc-2 merge convolutions in one call
    if dc > 2:
        f_stack = jnp.stack(fwd[: dc - 2], axis=-2)       # fwd of 0..i-1
        b_stack = jnp.stack(bwd[1: dc - 1], axis=-2)      # bwd of i+1..dc-1
        mid = minconv_xor(f_stack, b_stack)               # [..., dc-2, q]
        outs.extend([mid[..., i, :] for i in range(dc - 2)])
    outs.append(fwd[-1])
    return jnp.stack(outs, axis=-2)
