"""Device-ready constant index arrays for a code graph.

Everything here is a trace-time constant: XLA folds these gathers into
efficient static data movement.  This replaces the reference's pointer-based
``code_t``/``decoder_t`` state (``/root/reference/include/struct.h:29-108``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..models.code import NBCode


@dataclasses.dataclass(frozen=True, eq=False)
class RotationPlan:
    """Coefficient-grouped static lane permutations for GF rotations.

    A per-edge rotation by coefficient h is a lane permutation; applying a
    *different* permutation per row is a per-row gather, but
    codes use only a handful of distinct coefficients, so: sort positions
    by coefficient (a batch-axis gather — cheap), apply one *shared* static
    permutation per group (compiles to plain data movement), and un-sort.
    """

    sort_idx: np.ndarray     # [P] positions ordered by coefficient
    unsort_idx: np.ndarray   # [P] inverse
    bounds: tuple            # group (start, end) pairs
    perm_in: tuple           # per group: [q] perm for c-domain -> u-domain
    perm_out: tuple          # per group: [q] perm for u-domain -> c-domain
    group_coefs: tuple       # per group: the GF coefficient h (0 = padding)

    @staticmethod
    def build(coefs: np.ndarray, gf) -> "RotationPlan":
        coefs = np.asarray(coefs).reshape(-1)
        order = np.argsort(coefs, kind="stable")
        inv_order = np.argsort(order)
        sorted_c = coefs[order]
        bounds, pin, pout, gcoefs = [], [], [], []
        start = 0
        ident = np.arange(gf.q)
        while start < len(sorted_c):
            h = sorted_c[start]
            end = start + int(np.searchsorted(sorted_c[start:], h, "right"))
            if h == 0:  # padding positions: identity
                pin.append(ident)
                pout.append(ident)
            else:
                # vr[u] = v[h^-1 u]  -> perm_in[u] = h^-1 * u
                pin.append(gf.mul_table[int(gf.inv(h))])
                # mcv[c] = mcv_r[h c] -> perm_out[c] = h * c
                pout.append(gf.mul_table[int(h)])
            bounds.append((start, end))
            gcoefs.append(int(h))
            start = end
        return RotationPlan(
            sort_idx=order.astype(np.int32),
            unsort_idx=inv_order.astype(np.int32),
            bounds=tuple(bounds),
            perm_in=tuple(p.astype(np.int32) for p in pin),
            perm_out=tuple(p.astype(np.int32) for p in pout),
            group_coefs=tuple(gcoefs),
        )

    def apply(self, x, direction: str, mode: str | None = None):
        """x: [F, P, q] -> rotated [F, P, q]. direction: 'in' | 'out'.

        ``mode`` selects the implementation (grouped | gather | matmul |
        auto).  Callers that cache compiled programs must resolve it ONCE
        at build time and pass it explicitly, so the value baked into the
        trace is the value in their cache key (round-4 ADVICE: reading the
        env here at trace time could diverge from a key computed earlier).
        """
        import os

        import jax.numpy as jnp

        # auto policy: grouped static perms for few coefficient groups; with
        # many groups the slice/concat overhead exceeds a single
        # per-position gather.  The 24-group threshold was tuned on another
        # device and is unmeasured on the H100.
        if mode is None:
            mode = os.environ.get("NBLDPC_ROT", "auto")
        if mode == "auto":
            mode = "grouped" if len(self.bounds) <= 24 else "gather"
        if mode == "matmul":
            # one-hot permutation matmul per coefficient group: a matrix
            # product instead of a gather (bf16 0/1 operands are exact)
            perms = self.perm_in if direction == "in" else self.perm_out
            xs = x[:, self.sort_idx]
            parts = []
            for i, (s, e) in enumerate(self.bounds):
                q = len(perms[i])
                oh = np.zeros((q, q), np.float32)
                # out[c] = in[perm[c]]  ->  oh[perm[c], c] = 1
                oh[perms[i], np.arange(q)] = 1.0
                parts.append(
                    jnp.einsum(
                        "fpu,uc->fpc",
                        xs[:, s:e].astype(jnp.bfloat16),
                        jnp.asarray(oh, jnp.bfloat16),
                        preferred_element_type=jnp.float32,
                    ).astype(x.dtype)
                )
            xs = (parts[0] if len(parts) == 1
                  else jnp.concatenate(parts, axis=1))
            return xs[:, self.unsort_idx]
        if mode == "gather":
            perms = self.perm_in if direction == "in" else self.perm_out
            full = np.zeros((len(self.sort_idx), len(perms[0])), np.int32)
            for i, (s, e) in enumerate(self.bounds):
                full[self.sort_idx[s:e]] = perms[i]
            return jnp.take_along_axis(
                x, jnp.asarray(full)[None], axis=-1
            )
        perms = self.perm_in if direction == "in" else self.perm_out
        xs = x[:, self.sort_idx]
        parts = [
            xs[:, s:e][:, :, perms[i]]
            for i, (s, e) in enumerate(self.bounds)
        ]
        xs = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
        return xs[:, self.unsort_idx]

    def apply_indices(self, idx, direction: str):
        """Rotate small GF *index* tensors: idx [F, P, nm] ints -> h*idx
        ('in') or h^-1*idx ('out') — used to rotate top-k symbol lists
        without touching dense messages.  Note: index rotation 'in' maps
        c -> u = h*c, which is perm_out's table; kept explicit here."""
        import jax.numpy as jnp

        perms = self.perm_out if direction == "in" else self.perm_in
        xs = idx[:, self.sort_idx]
        parts = [
            jnp.asarray(perms[i])[xs[:, s:e]]
            for i, (s, e) in enumerate(self.bounds)
        ]
        xs = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
        return xs[:, self.unsort_idx]


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Static index arrays (NumPy; passed into jit as constants)."""

    code: NBCode
    regular: bool            # all rows have degree dc_max
    edge_col: np.ndarray     # [E]
    col_edges: np.ndarray    # [N, dv_max], pad = E
    row_edges: np.ndarray    # [M, dc_max], pad = E
    edge_valid_row: np.ndarray  # [M, dc_max] bool
    edge_slot: np.ndarray    # [E] position of edge within its row
    rot: np.ndarray          # [E, q]  rot[e, c]   = h_e * c
    inv_rot: np.ndarray      # [E, q]  inv_rot[e, u] = h_e^{-1} * u
    layers: tuple            # tuple of row-id arrays (column-disjoint groups)

    @classmethod
    @functools.lru_cache(maxsize=None)
    def from_code(cls, code: NBCode) -> "DeviceGraph":
        e = code.n_edges
        row_edges = code.row_edges
        valid = row_edges < e
        slot = np.zeros(e, dtype=np.int32)
        offs = np.concatenate([[0], np.cumsum(code.row_deg)])
        for r in range(code.m_rows):
            d = int(code.row_deg[r])
            slot[offs[r]: offs[r] + d] = np.arange(d)
        return cls(
            code=code,
            regular=bool(np.all(code.row_deg == code.dc_max)),
            edge_col=code.edge_col.astype(np.int32),
            col_edges=code.col_edges.astype(np.int32),
            row_edges=row_edges.astype(np.int32),
            edge_valid_row=valid,
            edge_slot=slot,
            rot=code.rot_perm,
            inv_rot=code.inv_rot_perm,
            layers=code.layers,
        )

    @functools.cached_property
    def rotplan(self) -> "RotationPlan":
        return RotationPlan.build(self.code.edge_coef, self.code.gf)

    @functools.cached_property
    def rows_rotplan(self) -> "RotationPlan":
        """Rotation plan in [M, dc] row-major layout (padding slots h=0),
        for CN kernels that operate on row-gathered messages."""
        return RotationPlan.build(self.code.row_coefs, self.code.gf)

    @property
    def q(self) -> int:
        return self.code.q

    @property
    def n_edges(self) -> int:
        return self.code.n_edges
