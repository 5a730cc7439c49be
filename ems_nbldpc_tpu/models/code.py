"""Code graph structure: everything the device kernels need, precomputed.

This replaces the reference's ``LoadCode``/``AllocateDecoder`` pair
(``/root/reference/init.c:143-272,310-384``) with a single immutable host-side
structure of flat NumPy index arrays.  The decoder kernels consume these as
static (trace-time constant) gather/scatter indices, so nothing here ever
costs device time beyond the gathers themselves.

Canonical conventions (SURVEY.md §7.3 item 5):

* field elements are in **polynomial representation** (GF add = XOR),
* LLRs are **min-convention** costs (smaller = more likely), normalized so the
  best entry is 0,
* parity-check coefficients are poly-rep; the per-edge "rotation" of a dense
  ``[q]`` message by coefficient ``h`` is the precomputed permutation
  ``rot[s] = h * s`` (the table-free equivalent of the MULGF/DIVGF loops at
  ``/root/reference/bubble_decoder.c:133-152,231-254``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..gf import GF, get_gf
from .formats import ParsedMatrix, parse


@dataclasses.dataclass(frozen=True, eq=False)  # id-hash: cacheable by identity
class NBCode:
    """A non-binary LDPC code over GF(2^m), ready for batched decoding."""

    q: int
    n: int          # codeword length in GF symbols
    m_rows: int     # number of check rows
    name: str

    # per-row padded views ([M, dc_max]; pad col = n (dummy), pad coef = 0)
    row_cols: np.ndarray
    row_coefs: np.ndarray      # poly rep
    row_deg: np.ndarray        # [M]
    col_deg: np.ndarray        # [N]

    # flat edge arrays, row-major edge order (reference numB order,
    # NB_LDPC.c:266,460)
    edge_row: np.ndarray       # [E]
    edge_col: np.ndarray       # [E]
    edge_coef: np.ndarray      # [E] poly rep
    # col_edges[n, j] = j-th edge id incident to column n (pad = E)
    col_edges: np.ndarray      # [N, dv_max]

    # super-layers for the layered schedule: rows grouped so that no two rows
    # in a group share a column (host graph coloring). layers[i] = row ids.
    layers: tuple

    @property
    def logq(self) -> int:
        return self.q.bit_length() - 1

    @property
    def k(self) -> int:
        return self.n - self.m_rows

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def n_edges(self) -> int:
        return int(self.edge_row.shape[0])

    @property
    def dc_max(self) -> int:
        return int(self.row_cols.shape[1])

    @property
    def dv_max(self) -> int:
        return int(self.col_edges.shape[1])

    @property
    def gf(self) -> GF:
        return get_gf(self.q)

    # ---- derived device-ready index arrays (cached) ----
    @functools.cached_property
    def row_edges(self) -> np.ndarray:
        """[M, dc_max] edge ids of each row (pad = E)."""
        e = self.n_edges
        out = np.full((self.m_rows, self.dc_max), e, dtype=np.int32)
        offs = np.concatenate([[0], np.cumsum(self.row_deg)])
        for r in range(self.m_rows):
            d = int(self.row_deg[r])
            out[r, :d] = np.arange(offs[r], offs[r] + d)
        return out

    @functools.cached_property
    def rot_perm(self) -> np.ndarray:
        """[E, q] int32: rot_perm[e, s] = h_e * s  (poly mul).

        Used to *read* a message indexed by symbol c as one indexed by
        u = h*c:  msg_u[u] = msg_c[h^-1 u], i.e. gather msg_c with
        ``inv_rot_perm``; and vice versa.
        """
        gf = self.gf
        return gf.mul_table[self.edge_coef].astype(np.int32)

    @functools.cached_property
    def inv_rot_perm(self) -> np.ndarray:
        """[E, q] int32: inv_rot_perm[e, u] = h_e^{-1} * u."""
        gf = self.gf
        inv = gf.inv(self.edge_coef)
        return gf.mul_table[inv].astype(np.int32)

    def validate(self):
        assert self.row_cols.shape == (self.m_rows, self.dc_max)
        assert np.all(self.edge_coef > 0)
        assert self.edge_row.shape == self.edge_col.shape
        used = np.zeros(self.n, dtype=np.int64)
        np.add.at(used, self.edge_col, 1)
        assert np.array_equal(used, self.col_deg)
        # layers partition rows and are column-disjoint
        allrows = np.sort(np.concatenate(self.layers))
        assert np.array_equal(allrows, np.arange(self.m_rows))
        for rows in self.layers:
            cols = self.row_cols[rows]
            cols = cols[cols < self.n]
            assert len(np.unique(cols)) == cols.size, "layer has column clash"


# Version of the layer-coloring algorithm.  Bumped whenever the coloring
# changes layer composition/order for EXISTING codes (the layered
# fixed-point trajectory, and hence per-point FER/throughput, shifts with
# the schedule).  Folded into sim.mc.config_key so resumed sweeps and
# cross-round artifact comparisons never silently mix schedules
# (round-4 ADVICE).  v1 = round-1 balanced greedy only; v2 = round-4
# best-of(greedy, DSATUR+repair).
COLORING_VERSION = 2


def _color_rows(parsed: ParsedMatrix) -> tuple:
    """Partition rows into column-disjoint groups (super-layers).

    The reference's layered schedule is strictly sequential over rows
    (``NB_LDPC.c:320``); rows that share no variable are order-independent, so
    they may run in one batched step with identical fixed-point semantics.

    The layer count IS the decoder's sequential depth per iteration, so
    fewer layers = fewer (and wider) batched CN steps.  Two candidate
    colorings of the row-conflict graph (rows adjacent iff they share a
    column) are computed and the better one kept — fewest layers, then
    most balanced:

    - the round-1 balanced greedy (place each row in the smallest
      conflict-free group);
    - DSATUR + two repair passes ((a) dissolve dwarf layers into the
      others where possible, (b) re-balance sizes).  DSATUR wins big on
      wide rows — 9 vs 13 layers on Ahmed_64800_R910_GF256 (dc=20), 3 vs
      5 on the Declercq flagship — but its tie-breaking loses to the
      greedy on a couple of small codes, hence best-of-both.
    """
    a = _balanced_greedy_color(parsed)
    b = _dsatur_color(parsed)

    def score(layers):
        sizes = [len(g) for g in layers]
        return (len(layers), max(sizes) - min(sizes))

    return a if score(a) <= score(b) else b


def _balanced_greedy_color(parsed: ParsedMatrix) -> tuple:
    groups: list[list[int]] = []
    gcols: list[set] = []
    for r in range(parsed.m):
        cols = set(parsed.row_cols[r].tolist())
        cand = [i for i in range(len(groups)) if not (gcols[i] & cols)]
        if cand:
            gi = min(cand, key=lambda i: len(groups[i]))
            groups[gi].append(r)
            gcols[gi] |= cols
        else:
            groups.append([r])
            gcols.append(set(cols))
    return tuple(np.array(g, dtype=np.int32) for g in groups)


def _dsatur_color(parsed: ParsedMatrix) -> tuple:
    from collections import defaultdict

    m = parsed.m
    row_cols = [set(parsed.row_cols[r].tolist()) for r in range(m)]
    colrows = defaultdict(list)
    for r in range(m):
        for c in row_cols[r]:
            colrows[c].append(r)
    adj: list[set] = [set() for _ in range(m)]
    for rs in colrows.values():
        for a in rs:
            adj[a].update(rs)
    for r in range(m):
        adj[r].discard(r)
    deg = [len(a) for a in adj]

    # DSATUR: color the most saturation-constrained row first
    colors = np.full(m, -1, dtype=np.int64)
    sat: list[set] = [set() for _ in range(m)]
    order = sorted(range(m), key=lambda r: -deg[r])
    for _ in range(m):
        r = max((x for x in order if colors[x] < 0),
                key=lambda x: (len(sat[x]), deg[x]))
        c = 0
        while c in sat[r]:
            c += 1
        colors[r] = c
        for b in adj[r]:
            sat[b].add(c)
    k = int(colors.max()) + 1
    groups = [list(np.flatnonzero(colors == c)) for c in range(k)]
    gcols = [set().union(*(row_cols[r] for r in g)) for g in groups]

    def fits(r, gi):
        return not (row_cols[r] & gcols[gi])

    # (a) dissolve the smallest groups entirely when every row relocates
    improved = True
    while improved and len(groups) > 1:
        improved = False
        gi = min(range(len(groups)), key=lambda i: len(groups[i]))
        moves = []
        for r in groups[gi]:
            tgt = next((j for j in range(len(groups))
                        if j != gi and fits(r, j)), None)
            if tgt is None:
                break
            moves.append((r, tgt))
            gcols[tgt] |= row_cols[r]   # tentative; rolled back via rebuild
        else:
            for r, tgt in moves:
                groups[tgt].append(r)
            del groups[gi], gcols[gi]
            improved = True
        if not improved:
            gcols = [set().union(*(row_cols[r] for r in g)) for g in groups]

    # (b) balance: shift rows from the largest into the smallest groups
    for _ in range(m):
        big = max(range(len(groups)), key=lambda i: len(groups[i]))
        small = min(range(len(groups)), key=lambda i: len(groups[i]))
        if len(groups[big]) - len(groups[small]) <= 1:
            break
        r = next((r for r in groups[big] if fits(r, small)), None)
        if r is None:
            break
        groups[big].remove(r)
        groups[small].append(r)
        gcols[small] |= row_cols[r]
        gcols[big] = set().union(*(row_cols[x] for x in groups[big]))

    return tuple(np.sort(np.array(g, dtype=np.int32)) for g in groups)


def from_parsed(parsed: ParsedMatrix, name: str = "") -> NBCode:
    n, m, q = parsed.n, parsed.m, parsed.q
    row_deg = np.array([len(c) for c in parsed.row_cols], dtype=np.int32)
    dc_max = int(row_deg.max())
    row_cols = np.full((m, dc_max), n, dtype=np.int32)
    row_coefs = np.zeros((m, dc_max), dtype=np.int32)
    for r in range(m):
        d = row_deg[r]
        row_cols[r, :d] = parsed.row_cols[r]
        row_coefs[r, :d] = parsed.row_coefs_poly[r]

    edge_row = np.repeat(np.arange(m, dtype=np.int32), row_deg)
    edge_col = np.concatenate(parsed.row_cols).astype(np.int32)
    edge_coef = np.concatenate(parsed.row_coefs_poly).astype(np.int32)
    e = edge_col.shape[0]

    col_deg = np.zeros(n, dtype=np.int32)
    np.add.at(col_deg, edge_col, 1)
    dv_max = int(col_deg.max())
    col_edges = np.full((n, dv_max), e, dtype=np.int32)
    fill = np.zeros(n, dtype=np.int64)
    for ei in range(e):
        c = edge_col[ei]
        col_edges[c, fill[c]] = ei
        fill[c] += 1

    code = NBCode(
        q=q, n=n, m_rows=m, name=name,
        row_cols=row_cols, row_coefs=row_coefs,
        row_deg=row_deg, col_deg=col_deg,
        edge_row=edge_row, edge_col=edge_col, edge_coef=edge_coef,
        col_edges=col_edges,
        layers=_color_rows(parsed),
    )
    code.validate()
    return code


def load(path: str, fmt: str = "auto", name: str = "") -> NBCode:
    parsed = parse(path, fmt)
    return from_parsed(parsed, name=name or path.rsplit("/", 1)[-1])


def random_regular(
    n: int, m: int, q: int, dv: int = 2, seed: int = 0, name: str = ""
) -> NBCode:
    """Random (dv, dc)-regular code for tests; dc = n*dv/m must be integral."""
    assert (n * dv) % m == 0
    dc = n * dv // m
    rng = np.random.default_rng(seed)
    gf = get_gf(q)
    for _attempt in range(100):
        # random permutation construction (configuration model, no repeats
        # of a column within a row)
        sockets = np.repeat(np.arange(n), dv)
        rng.shuffle(sockets)
        rows = [sockets[r * dc:(r + 1) * dc] for r in range(m)]
        if all(len(np.unique(r)) == dc for r in rows):
            break
    else:
        raise RuntimeError("failed to build simple graph")
    del gf  # coefficients drawn directly in poly rep (any nonzero element)
    coefs = [rng.integers(1, q, size=dc) for _ in range(m)]
    parsed = ParsedMatrix(
        n, m, q, [np.sort(r) for r in rows], [np.asarray(c) for c in coefs]
    )
    return from_parsed(parsed, name=name or f"rand_N{n}_M{m}_GF{q}")
