"""Sum-product (belief propagation) check node via fast Hadamard transform.

Not in the C reference (which is min-sum/EMS only) — a bonus decoder that
suits matrix hardware: over GF(2^m), the check-node convolution over the XOR group
diagonalizes under the Walsh-Hadamard transform, so the exact sum-product
CN is

    out_i  =  IWHT( prod_{j != i} WHT(P_j) ) / q

with the partial products computed by a forward/backward sweep (no unstable
division).  The WHT of a length-q vector is one q x q +-1 matrix multiply —
pure matrix-unit work, in contrast to the gather-heavy min-sum path.  FER of SPA
upper-bounds every EMS variant, so this is both the quality ceiling and the
throughput showcase.

Interface matches the other CN backends: min-cost messages in, min-cost
messages out (costs are true negative log-likelihoods for the AWGN
channels, so P = exp(-cost) is the exact likelihood up to normalization).
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .minconv import delta_message

_LOG_EPS = 60.0  # cost clamp: exp(-60) ~ 1e-26 keeps WHT well-conditioned

# The WHT is a sum of q same-magnitude terms with massive cancellation in
# the inverse direction: out_p ~ 1/q * sum of O(1) terms.  Reduced-precision
# matmul inputs (bf16; TF32 on a GPU at the default precision) destroy the
# small probabilities (with bf16 the flagship GF(256) decode stops
# converging at all), so the default is Precision.HIGHEST, true fp32;
# "butterfly" uses log2(q) elementwise add/sub stages instead (exact f32,
# no matmul).
_WHT_IMPL = os.environ.get("NBLDPC_WHT", "matmul")
_WHT_PRECISION = jax.lax.Precision(
    os.environ.get("NBLDPC_WHT_PRECISION", "highest")
)


def wht(x: jax.Array) -> jax.Array:
    """Walsh-Hadamard transform along the last axis (unnormalized)."""
    q = x.shape[-1]
    if _WHT_IMPL == "butterfly":
        m = q.bit_length() - 1
        for b in range(m):
            s = 1 << b
            lo = (jnp.arange(q) & s) == 0
            flip = jnp.roll(x, -s, axis=-1)
            flop = jnp.roll(x, s, axis=-1)
            x = jnp.where(lo, x + flip, flop - x)
        return x
    h = jnp.asarray(hadamard(q))
    return jnp.einsum("...v,uv->...u", x, h, precision=_WHT_PRECISION,
                      preferred_element_type=jnp.float32)


@functools.lru_cache(maxsize=None)
def hadamard(q: int) -> np.ndarray:
    """[q, q] Walsh-Hadamard matrix H[u, v] = (-1)^popcount(u & v)."""
    u = np.arange(q)
    pc = np.vectorize(lambda x: bin(x).count("1"))(u[:, None] & u[None, :])
    return np.where(pc % 2 == 0, 1.0, -1.0).astype(np.float32)


def costs_to_probs(cost: jax.Array) -> jax.Array:
    """Min-cost messages -> normalized probabilities."""
    c = cost - jnp.min(cost, axis=-1, keepdims=True)
    p = jnp.exp(-jnp.minimum(c, _LOG_EPS))
    return p / jnp.sum(p, axis=-1, keepdims=True)


def probs_to_costs(p: jax.Array) -> jax.Array:
    p = jnp.maximum(p, jnp.float32(np.exp(-_LOG_EPS)))
    c = -jnp.log(p)
    return c - jnp.min(c, axis=-1, keepdims=True)


def _fb_products(w: jax.Array) -> jax.Array:
    """Extrinsic forward/backward products along the dc axis (transform
    domain): out[..., i, :] = prod_{j != i} w[..., j, :]."""
    dc = w.shape[-2]
    if dc == 1:
        return jnp.ones_like(w)
    if dc == 2:
        return w[..., ::-1, :]
    fwd = [w[..., 0, :]]
    bwd = [w[..., dc - 1, :]]
    for i in range(1, dc - 1):
        fwd.append(fwd[-1] * w[..., i, :])
        bwd.append(bwd[-1] * w[..., dc - 1 - i, :])
    bwd = bwd[::-1]
    outs = [bwd[0]]
    for i in range(1, dc - 1):
        outs.append(fwd[i - 1] * bwd[i])
    outs.append(fwd[-1])
    return jnp.stack(outs, axis=-2)


def mul_transpose_perm(gf, h: int) -> np.ndarray:
    """Index map t with t[u] = M_h^T u, where M_h is the GF(2)-bit-matrix
    of multiplication by h (column b = bits of h * 2^b).

    Used to fold GF rotations into the Hadamard transform:
    WHT(x rotated by h)[u] = WHT(x)[t[u]]  (rotation is linear over
    GF(2)^m, and the WHT character pairing transposes it)."""
    q = gf.q
    if h == 0:
        return np.zeros(q, np.int64)
    u = np.arange(q)
    t = np.zeros(q, np.int64)
    for b in range(gf.m):
        col = int(gf.mul(h, 1 << b))
        par = u & col                       # parity of popcount(u & col)
        for s in (4, 2, 1):                 # folds up to 8-bit values
            par = par ^ (par >> s)
        t |= (par & 1).astype(np.int64) << b
    return t


@functools.lru_cache(maxsize=None)
def fused_hadamard(q: int, prim: int, h: int) -> np.ndarray:
    """[q, q] rotation-folded Hadamard matrix H_h[u, v] = H[t_h[u], v].

    Contracting x against H_h's second index (out[u] = sum_v x[v] H_h[u,v])
    computes (rotate by h, then WHT); contracting against the first index
    (out[c] = sum_u x[u] H_h[u,c]) computes (WHT, then un-rotate by h) —
    the same matrix serves both directions, transposed.  For h == 0
    (padding lanes) every row is H[0] = all-ones, so padded inputs
    transform IN to the exact neutral element w == 1 with no masking."""
    from .. import gf as gfmod

    g = gfmod.get_gf(q)
    assert g.prim == prim
    t = mul_transpose_perm(g, h)
    return hadamard(q)[t]


def grouped_wht(x: jax.Array, rotplan, gf, direction: str) -> jax.Array:
    """Rotation-folded WHT over coefficient groups.

    x: [F, P, q] (positions flattened); rotplan: decoder.graph.RotationPlan
    whose group_coefs give each group's GF coefficient.  direction 'in':
    WHT of the h-rotated message; 'out': h-un-rotated inverse WHT (caller
    divides by q).  One matmul per coefficient group either way.

    NBLDPC_SPA_GROUPED selects the lowering (same math either way):
      - "concat": one ragged einsum per group + concat.  Fine for few
        groups; a code like Ahmed_64800_R910_GF256 has 33 distinct
        coefficients -> ~34 tiny matmuls + 34-part concats per direction
        per layer.
      - "blocked": ONE batched einsum — positions sorted by coefficient
        are padded into fixed-size blocks, each block contracting against
        its own fused-Hadamard matrix gathered from a per-code stack
        (the grouped-GEMM / MoE dispatch pattern).
      - "auto" (default): concat, which measured faster than blocked at
        the 33-group shape on the device it was first tuned on; the
        choice is unmeasured on the H100.  blocked stays as an explicit
        knob.
    """
    mode = os.environ.get("NBLDPC_SPA_GROUPED", "auto")
    if mode == "auto":
        mode = "concat"
    if mode == "blocked":
        return blocked_wht(x, rotplan, gf, direction)
    spec = "fpv,uv->fpu" if direction == "in" else "fpu,uv->fpv"
    xs = x[:, rotplan.sort_idx]
    parts = []
    for i, (s, e) in enumerate(rotplan.bounds):
        hh = jnp.asarray(fused_hadamard(gf.q, gf.prim, rotplan.group_coefs[i]))
        parts.append(
            jnp.einsum(spec, xs[:, s:e], hh,
                       precision=_WHT_PRECISION,
                       preferred_element_type=jnp.float32)
        )
    xs = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    return xs[:, rotplan.unsort_idx]


_BLOCK = 8  # positions per block


def _blocked_layout(rotplan):
    """Pad coefficient-sorted positions into _BLOCK-sized single-coef
    blocks.  Returns (pos [B*_BLOCK] int32 source positions — padding
    slots repeat a real position and are simply never read back —,
    gids [B] int32 coefficient ids, unsort [P] int32 padded-slot of each
    original position)."""
    pos, gids, unsort = [], [], np.zeros(len(rotplan.sort_idx), np.int64)
    for i, (s, e) in enumerate(rotplan.bounds):
        grp = rotplan.sort_idx[s:e]
        nblk = -(-len(grp) // _BLOCK)
        padded = np.concatenate(
            [grp, np.full(nblk * _BLOCK - len(grp), grp[0], grp.dtype)]
        )
        unsort[grp] = sum(len(p) for p in pos) + np.arange(len(grp))
        pos.append(padded)
        gids.extend([rotplan.group_coefs[i]] * nblk)
    return (
        np.concatenate(pos).astype(np.int32),
        np.asarray(gids, np.int64),
        unsort.astype(np.int32),
    )


@functools.lru_cache(maxsize=None)
def hadamard_stack(q: int, prim: int, vocab: tuple) -> np.ndarray:
    """[V, q, q] stack of fused-Hadamard matrices for a code's distinct
    coefficients.  ONE np array per (q, prim, vocab) so every layer's
    blocked einsum bakes the identical literal (XLA dedups it)."""
    return np.stack([fused_hadamard(q, prim, h) for h in vocab])


def blocked_wht(x: jax.Array, rotplan, gf, direction: str) -> jax.Array:
    """Rotation-folded WHT as ONE batched einsum over coefficient blocks.

    Equivalent to the concat lowering of ``grouped_wht`` (same per-group
    matrices, same contraction, float-associativity aside): positions are
    ordered by coefficient, padded to _BLOCK-multiples per group, and each
    block contracts against its own fused-Hadamard matrix — 'fbkv,buv'
    lowers to one batched GEMM, with no per-group slices or
    concats regardless of how many distinct coefficients the code has.
    """
    vocab = tuple(sorted(set(rotplan.group_coefs)))
    gid_of = {h: i for i, h in enumerate(vocab)}
    pos, gids, unsort = _blocked_layout(rotplan)
    stack = hadamard_stack(gf.q, gf.prim, vocab)
    f, _, q = x.shape
    b = len(gids)
    xs = x[:, pos].reshape(f, b, _BLOCK, q)
    hs = jnp.asarray(stack)[
        jnp.asarray([gid_of[int(h)] for h in gids], jnp.int32)
    ]                                                     # [B, q, q]
    spec = "fbkv,buv->fbku" if direction == "in" else "fbku,buv->fbkv"
    y = jnp.einsum(spec, xs, hs, precision=_WHT_PRECISION,
                   preferred_element_type=jnp.float32)
    return y.reshape(f, b * _BLOCK, q)[:, unsort]


def fb_checknode_spa_fused(mvc: jax.Array, rotplan, gf) -> jax.Array:
    """SPA check node with GF rotations folded into the WHT matmuls.

    mvc: [F, G, dc, q] UN-rotated min-cost VtoC messages; returns
    [F, G, dc, q] UN-rotated min-cost extrinsic CtoV messages.  Equivalent
    to rotate -> fb_checknode_spa -> un-rotate, minus both rotation passes
    (and minus the padding mask: h = 0 rows transform to the neutral w = 1).
    """
    f, gdim, dcdim, q = mvc.shape
    p = costs_to_probs(mvc)
    w = grouped_wht(p.reshape(f, gdim * dcdim, q), rotplan, gf, "in")
    out_w = _fb_products(w.reshape(f, gdim, dcdim, q))
    out_p = grouped_wht(
        out_w.reshape(f, gdim * dcdim, q), rotplan, gf, "out"
    ) / q
    out_p = jnp.maximum(out_p, 1e-30)
    return probs_to_costs(out_p).reshape(f, gdim, dcdim, q)


def fb_checknode_spa(vr_cost: jax.Array,
                     valid: jax.Array | None = None) -> jax.Array:
    """Exact SPA CN over the XOR group.

    vr_cost: [..., dc, q] rotated min-cost messages.
    Returns [..., dc, q] extrinsic min-cost messages.
    """
    q = vr_cost.shape[-1]
    dc = vr_cost.shape[-2]
    if valid is not None:
        neutral = delta_message(vr_cost.shape[:-1], q, vr_cost.dtype)
        vr_cost = jnp.where(valid[..., None], vr_cost, neutral)
    p = costs_to_probs(vr_cost)
    w = wht(p)                                           # [..., dc, q]
    if dc == 1:
        out_w = jnp.ones_like(w)
    elif dc == 2:
        out_w = w[..., ::-1, :]
    else:
        fwd = [w[..., 0, :]]
        bwd = [w[..., dc - 1, :]]
        for i in range(1, dc - 1):
            fwd.append(fwd[-1] * w[..., i, :])
            bwd.append(bwd[-1] * w[..., dc - 1 - i, :])
        bwd = bwd[::-1]
        outs = [bwd[0]]
        for i in range(1, dc - 1):
            outs.append(fwd[i - 1] * bwd[i])
        outs.append(fwd[-1])
        out_w = jnp.stack(outs, axis=-2)
    out_p = wht(out_w) / q
    # numerical floor: tiny negatives from cancellation clamp to ~0
    out_p = jnp.maximum(out_p, 1e-30)
    return probs_to_costs(out_p)
