"""Channel models + intrinsic-LLR demappers, batched in JAX.

Reference behaviors reproduced (see ``/root/reference/channel.c``):

* BPSK-AWGN with the Eb/N0 sigma convention
  ``sigma = sqrt(1 / (2 * rate * 10^(EbN/10)))`` (``channel.c:51``) and
  per-symbol intrinsic cost
  ``sum_bits (y_b - bpsk(bit_b(g)))^2 / (2 sigma^2)`` (``channel.c:66-76``).
* 2-D QAM / rotated-QAM / APSK constellations with the SNR convention
  ``sigma = sqrt(1 / (2 * 10^(EbN/10)))`` (``channel.c:231,598``), optional
  Rayleigh fading, per-component SSD fading and symbol erasures
  (``channel.c:588-594,648-672``).

Demapping as matrix products: the BPSK cost expands to an affine function
of the bit image, so the whole demapper is one matmul::

    cost[g] = C + (2/sigma^2) * sum_b y_b * bit_b(g)

(the constant C cancels under min-normalization).  2-D/4-D constellations use
the gram trick ``|y - x_g|^2 = |y|^2 - 2 y.x_g + |x_g|^2`` — again a matmul
against the constellation table.  These f32 products run at
``Precision.HIGHEST``: left at the default a GPU takes them in TF32, which
keeps about 3 decimal digits of costs that reach ~50; the operands are
[q x m]-sized, so full precision costs nothing.

Symbols use the framework's polynomial representation: bit b of symbol g is
bit b of the integer g (LSB first), replacing the reference's BINGF lookup.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..gf import get_gf

HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """What to simulate between encoder and decoder."""
    kind: str = "bpsk"            # bpsk | qam | apsk64 | qam256_4d
    sigma_convention: str = "ebn0"  # ebn0 (channel.c:51) | snr (channel.c:598)
    rotated: bool = False          # rotated QAM (channel.c:348-357)
    rayleigh: bool = False         # Rayleigh fading per 2-D symbol
    ssd: bool = False              # per-component fading (SSD)
    erasure_prob: float = 0.0      # component erasures (channel.c:592-594)
    labeling: str = "ref"          # "ref": the reference's symbol->point
    #                                labeling (channel.h tables / DVB-S2X
    #                                APSK; FER-comparable with the C binary
    #                                under fading) | "gray": the round-1
    #                                synthetic Gray labeling


def sigma_for(spec: ChannelSpec, ebn0_db, rate: float):
    """Noise sigma; works on python floats and traced arrays alike."""
    import jax.numpy as _jnp

    xp = _jnp if hasattr(ebn0_db, "dtype") else np
    snr_lin = 10.0 ** (xp.asarray(ebn0_db) / 10.0)
    if spec.sigma_convention == "ebn0":
        out = xp.sqrt(1.0 / (2.0 * rate * snr_lin))
    else:
        out = xp.sqrt(1.0 / (2.0 * snr_lin))
    return out if hasattr(ebn0_db, "dtype") else float(out)


@functools.lru_cache(maxsize=None)
def bit_matrix(q: int) -> np.ndarray:
    """[q, m] float: bit image (LSB-first) of each poly-rep symbol."""
    return get_gf(q).bits(np.arange(q)).astype(np.float32)


def bpsk_awgn(key, cw, q: int, sigma: float, dtype=jnp.float32):
    """BPSK-modulate + AWGN; return (intrinsic_cost [F,N,q], y [F,N,m]).

    cw: [F, N] poly-rep codeword symbols.
    intrinsic_cost is min-normalized per symbol (best entry = 0), matching
    the decoder convention; the reference's sorted list + full-cost pair
    (channel.c:78-91) is recovered by ``lax.top_k(-cost)``.
    """
    m = q.bit_length() - 1
    bits = ((cw[..., None] >> jnp.arange(m)) & 1).astype(dtype)   # [F,N,m]
    tx = 1.0 - 2.0 * bits
    noise = jax.random.normal(key, tx.shape, dtype=dtype)
    y = tx + sigma * noise
    return intrinsic_from_bpsk(y, q, sigma), y


def intrinsic_from_bpsk(y, q: int, sigma: float):
    """cost[.., g] = sum_b (y_b - (1-2 g_b))^2 / (2 sigma^2), min-normalized.

    Expanded: cost[g] = C + (2/sigma^2) * sum_b g_b * y_b  — one matmul.
    """
    bmat = jnp.asarray(bit_matrix(q), dtype=y.dtype)              # [q, m]
    lin = (2.0 / (sigma * sigma)) * jnp.einsum(
        "...b,gb->...g", y, bmat, precision=HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return lin - jnp.min(lin, axis=-1, keepdims=True)


# ---------------- 2-D constellations ----------------

def _gray(n: int) -> np.ndarray:
    a = np.arange(n)
    return a ^ (a >> 1)


def _ref_qam_pam(labels: np.ndarray, mag_bits: int) -> np.ndarray:
    """One PAM coordinate of the reference's square-QAM labeling.

    The channel.h tables (``table_16/64/256QAM``, :66-424) follow a
    sign-refinement rule (verified bit-exact against all three, see
    tests/test_channels.py): bit 0 of ``labels`` is the sign; the magnitude
    nests outward from the HIGHEST magnitude bit,
    ``mag = 2^k + (1-2 b_1)(2^(k-1) + (1-2 b_2)(... (2 + (1-2 b_k))))``
    with b_1 the lowest magnitude bit — yielding the magnitude sequences
    [3,1], [7,1,5,3], [15,1,9,7,13,3,11,5].
    """
    v = np.ones_like(labels, dtype=np.float64)
    for j in range(mag_bits, 0, -1):          # innermost = highest bit
        b = (labels >> j) & 1
        v = (1 << (mag_bits - j + 1)) + (1 - 2 * b) * v
    sign = 1 - 2 * (labels & 1)
    return sign * v


# DVB-S2X 8+16+20+20 64-APSK labeling (reference ``table_64APSK``,
# channel.c:130-198 — "from DVB S2X code identifier 135/180"): per binary
# label, a ring code into radii (1.0, 2.2, 3.6, 5.2) and an angle in units
# of pi/80.  Encoded compactly rather than as 128 floats.
_APSK64_RING = np.array([
    1, 1, 1, 1, 3, 3, 3, 3, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
    0, 0, 0, 0, 3, 3, 3, 3, 1, 1, 1, 1, 2, 2, 2, 2,
    0, 0, 0, 0, 3, 3, 3, 3, 1, 1, 1, 1, 2, 2, 2, 2])
_APSK64_ANG80 = np.array([
    125, 115, 35, 45, 140, 100, 20, 60, 135, 105, 25, 55,
    140, 100, 20, 60, 124, 116, 36, 44, 132, 108, 28, 52,
    124, 116, 36, 44, 132, 108, 28, 52, 130, 110, 30, 50,
    148, 92, 12, 68, 145, 95, 15, 65, 148, 92, 12, 68,
    150, 90, 10, 70, 156, 84, 4, 76, 155, 85, 5, 75,
    156, 84, 4, 76])


@functools.lru_cache(maxsize=None)
def constellation(kind: str, q: int, rotated: bool = False,
                  labeling: str = "ref") -> np.ndarray:
    """[q, 2] unit-average-power constellation points.

    ``labeling="ref"`` reproduces the reference's symbol->point maps: the
    transmitted constellation index is the symbol's binary image
    (``channel.c:630-636``; the ``pos_gf*_to_bin`` tables, channel.h:48-50,
    are the power->polynomial conversion, which is the identity in this
    framework's polynomial representation), and the point coordinates
    follow channel.h's tables — generated from their structural rules
    rather than shipped as data.  ``labeling="gray"`` keeps the round-1
    synthetic Gray maps.
    """
    if kind == "qam":
        side = int(round(np.sqrt(q)))
        assert side * side == q, "QAM needs square q"
        g = np.arange(q)
        if labeling == "v2":
            # the v2 standalone program's 256QAM grid (EMS_..._v2.c:
            # 1186-1443, TABLEAU): natural binary raster labeling —
            # I = high half of the bits, Q = low half, PAM value
            # proportional to the index (no Gray / sign refinement).
            # v2 scales by R=0.4338609 (mean symbol power 8); here unit
            # power, so compare at SNR + 10*log10(8) (benchmarks/
            # v2_compare.py).
            hi, lo = g // side, g % side
            pts = np.stack([2.0 * hi - (side - 1),
                            2.0 * lo - (side - 1)], axis=1)
        elif labeling == "ref":
            # even bits -> I coordinate, odd bits -> Q (channel.h rule)
            m = q.bit_length() - 1
            xl = np.zeros(q, np.int64)
            yl = np.zeros(q, np.int64)
            for b in range(0, m, 2):
                xl |= ((g >> b) & 1) << (b // 2)
            for b in range(1, m, 2):
                yl |= ((g >> b) & 1) << (b // 2)
            mag_bits = m // 2 - 1
            pts = np.stack([_ref_qam_pam(xl, mag_bits),
                            _ref_qam_pam(yl, mag_bits)], axis=1)
        else:
            pam = 2 * np.arange(side) - (side - 1)
            # Gray map: low bits -> I index, high bits -> Q index
            gi = np.argsort(_gray(side))
            pts = np.zeros((q, 2))
            for s in range(q):
                pts[s] = (pam[gi[s % side]], pam[gi[s // side]])
    elif kind == "apsk64":
        radii = np.array([1.0, 2.2, 3.6, 5.2])
        if labeling == "ref":
            r = radii[_APSK64_RING]
            ang = np.pi * _APSK64_ANG80 / 80.0
            pts = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
        else:
            # round-1 synthetic: rings filled in label order
            counts = [8, 16, 20, 20]
            pts = []
            for c, r in zip(counts, radii):
                ang = 2 * np.pi * (np.arange(c) + 0.5) / c
                pts.extend([(r * np.cos(a), r * np.sin(a)) for a in ang])
            pts = np.array(pts)
    else:
        raise ValueError(kind)
    if rotated:
        th = np.deg2rad(31.7)  # channel.c:348-357 rotation angle
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        pts = pts @ rot.T
    # unit average power (channel.c:205-221)
    pts = pts / np.sqrt((pts ** 2).sum(axis=1).mean())
    return pts.astype(np.float32)


def channel_2d(key, cw, q: int, sigma: float, spec: ChannelSpec,
               dtype=jnp.float32):
    """Generic 2-D modulated channel: QAM/rotated-QAM/APSK with optional
    Rayleigh, SSD per-component fading and erasures.

    Returns min-normalized intrinsic cost [F, N, q].
    Reference counterpart: ``ModelChannel`` (channel.c:328-746) and
    ``ModelChannel_AWGN_64`` (channel.c:112-312).
    """
    kind = "apsk64" if spec.kind == "apsk64" else "qam"
    pts = jnp.asarray(
        constellation(kind, q, spec.rotated, spec.labeling)
    )                                                             # [q, 2]
    x = pts[cw]                                                   # [F, N, 2]
    knoise, kfade, kerase = jax.random.split(key, 3)
    noise = sigma * jax.random.normal(knoise, x.shape, dtype=dtype)

    if spec.ssd:
        # independent per-component Rayleigh fades (channel.c:648-672)
        u = jax.random.uniform(kfade, x.shape, dtype=dtype, minval=1e-12)
        att = jnp.sqrt(-jnp.log(u))
    elif spec.rayleigh:
        u = jax.random.uniform(kfade, x.shape[:-1] + (1,), dtype=dtype,
                               minval=1e-12)
        att = jnp.sqrt(-jnp.log(u))
    else:
        att = jnp.ones_like(x)
    if spec.erasure_prob > 0.0:
        # erased components carry nothing; survivors are re-normalized to
        # keep unit average channel power (channel.c:652-669)
        er = jax.random.bernoulli(kerase, spec.erasure_prob, x.shape)
        att = jnp.where(er, 0.0, att / np.sqrt(1.0 - spec.erasure_prob))

    y = att * x + noise
    return demap_2d(y, att, pts, sigma)


def demap_2d(y, att, pts, sigma):
    """cost[g] = |y - att*x_g|^2 / (2 sigma^2), min-normalized.

    With fading the receiver knows att (coherent detection, as in the
    reference) so the candidate points are att-scaled too.
    y, att: [..., 2]; pts: [q, 2].
    """
    xg = att[..., None, :] * pts                                  # [...,q,2]
    d2 = jnp.sum((y[..., None, :] - xg) ** 2, axis=-1)
    cost = d2 / (2.0 * sigma * sigma)
    return cost - jnp.min(cost, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def constellation_4d(labeling: str = "ref",
                     rotated: bool = False) -> np.ndarray:
    """[256, 4] 4-D constellation (two 16QAM uses), mean 2-D power = 1.

    ``labeling="ref"`` reproduces the reference's
    ``table_256QAM_4D_16QAM_R`` (channel.h:686-945, selected at
    channel.c:784-788) bit-exactly up to the shared normalization
    (verified in tests/test_channels.py).  Its structure, recovered
    numerically from the table: the base 2-D set is the {±1,±3}² grid in
    raster order (x fast, y slow) rotated by −31.7°, the low nibble of
    the symbol indexes it at +1 offset, the high nibble directly::

        table[g] = ( Q[(lo(g)+1) % 16],  Q[hi(g)] )

    ``labeling="gray"`` keeps the round-1 synthetic map (two independent
    Gray 16QAM uses, ``rotated`` honored).
    """
    if labeling == "ref":
        r = np.arange(16)
        grid = np.stack([2.0 * (r % 4) - 3.0, 2.0 * (r // 4) - 3.0], 1)
        th = np.deg2rad(-31.7)
        rot = np.array([[np.cos(th), -np.sin(th)],
                        [np.sin(th), np.cos(th)]])
        q16 = grid @ rot.T                                        # [16, 2]
        lo = np.arange(256) & 0xF
        hi = np.arange(256) >> 4
        pts = np.concatenate([q16[(lo + 1) % 16], q16[hi]], axis=1)
    else:
        q16 = constellation("qam", 16, rotated, "gray")
        lo = np.arange(256) & 0xF
        hi = np.arange(256) >> 4
        pts = np.concatenate([q16[lo], q16[hi]], axis=1)
    # norm_factor = sqrt(2*GF / sum |x|^2)  (channel.c:800-814): mean
    # power per 2-D channel use is 1.
    pts = pts / np.sqrt((pts ** 2).sum(axis=1).mean() / 2.0)
    return pts.astype(np.float32)


def qam256_4d(key, cw, sigma: float, spec: ChannelSpec, dtype=jnp.float32):
    """GF(256) symbols over a 4-D (two 16QAM uses) faded channel.

    Reference: ``ModelChannel_AWGN_256QAM_4D`` (channel.c:749-929):
    Rayleigh fading is drawn independently per REAL DIMENSION (4 fades per
    symbol, channel.c:829-840) — unconditionally in the reference;
    here gated by ``spec.ssd`` so the pure-AWGN variant stays testable.
    Erasure quirk, unlike the 2-D path: the 4-D transmitter computes
    NoisyBin BEFORE the erasure block (channel.c:840 vs 843-862; the 2-D
    path transmits after it, channel.c:648-675), so the SIGNAL always
    carries the raw fade while only the receiver's assumed attenuation is
    zeroed/renormalized by 1/sqrt(1-p).  FER-validated against the C
    binary (benchmarks/results_r3/CHANNEL_VALIDATION_4D.md); with the 2-D
    convention instead, the framework measures ~2x optimistic.  The
    receiver knows the fades (coherent, per-dimension gating
    channel.c:884-906).

    The demapper is :func:`demap_4d`.
    """
    cand = jnp.asarray(constellation_4d(spec.labeling, spec.rotated),
                       dtype=dtype)                               # [256, 4]
    x = cand[cw]                                                  # [F,N,4]
    knoise, kfade, kerase = jax.random.split(key, 3)
    noise = sigma * jax.random.normal(knoise, x.shape, dtype=dtype)
    if spec.ssd:
        u = jax.random.uniform(kfade, x.shape, dtype=dtype, minval=1e-12)
        att = jnp.sqrt(-jnp.log(u))          # 4 independent per-dim fades
    else:
        att = jnp.ones_like(x)
    y = att * x + noise                      # raw fade on the signal
    if spec.erasure_prob > 0.0:              # receiver-side only (quirk)
        er = jax.random.bernoulli(kerase, spec.erasure_prob, x.shape)
        att = jnp.where(er, 0.0, att / np.sqrt(1.0 - spec.erasure_prob))
    return demap_4d(y, att, cand, sigma)


def demap_4d(y, att, cand, sigma):
    """cost[g] = |y - att*x_g|^2 / (2 sigma^2), min-normalized.

    With per-dim fades the squared distance expands to
    ``|a·y|·const − 2 (a⊙y)·x_g + (a⊙a)·(x_g⊙x_g)`` — two matmuls against
    the [256, 4] table instead of a [F, N, 256, 4] broadcast.
    y, att: [..., 4]; cand: [q, 4].
    """
    cross = jnp.einsum("...d,gd->...g", att * y, cand, precision=HIGHEST,
                       preferred_element_type=jnp.float32)
    pw = jnp.einsum("...d,gd->...g", att * att, cand * cand,
                    precision=HIGHEST, preferred_element_type=jnp.float32)
    cost = (pw - 2.0 * cross) / (2.0 * sigma * sigma)
    return cost - jnp.min(cost, axis=-1, keepdims=True)


def simulate(key, cw, q: int, spec: ChannelSpec, ebn0_db: float, rate: float):
    """Dispatch to the right channel model; returns intrinsic cost [F,N,q]."""
    sigma = sigma_for(spec, ebn0_db, rate)
    if spec.kind == "bpsk":
        cost, _ = bpsk_awgn(key, cw, q, sigma)
        return cost
    if spec.kind in ("qam", "apsk64"):
        return channel_2d(key, cw, q, sigma, spec)
    if spec.kind == "qam256_4d":
        return qam256_4d(key, cw, sigma, spec)
    raise ValueError(spec.kind)
