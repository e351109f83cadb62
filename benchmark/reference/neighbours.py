"""Exact neighbour queries in plain PyTorch: the candidate pairs of a uniform
grid's 27-cell stencil, k nearest neighbours and all neighbours within a
radius.  Independent of the program; it runs on whatever device its inputs
are on, in blocks of pairs so that it fits.

Squared distances are float32 `dx * dx + dy * dy + dz * dz` of float32
coordinates, each operation rounded on its own: the arithmetic in which the
configuration states its radius tests.
"""
from __future__ import annotations

import math

import torch

BLOCK_PAIRS = 1 << 24  # candidate pairs per block


def d2(pts: torch.Tensor, q: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """float32 squared distances between rows q and rows j of pts."""
    d = pts[j] - pts[q]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    return dx * dx + dy * dy + dz * dz


def candidate_blocks(pts: torch.Tensor, cell: float, rows: torch.Tensor | None = None,
                     block: int = BLOCK_PAIRS):
    """Yields (q, j) i64 pairs: every row j in the 27 cells (of side `cell`)
    around each query row q of `rows` (default: every row), self included,
    in blocks of about `block` pairs; the pairs of one query are never
    split.  A row's stencil holds every row within `cell` of it."""
    dev = pts.device
    n = pts.shape[0]
    if rows is None:
        rows = torch.arange(n, device=dev)
    if n == 0 or rows.numel() == 0:
        return
    p64 = pts.to(torch.float64)
    origin = p64.amin(0) - 0.5 * cell
    c = torch.floor((p64 - origin) / cell).to(torch.int64)
    dims = c.amax(0) + 1
    key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    ks, order = torch.sort(key)
    rows = rows[torch.argsort(key[rows], stable=True)]
    cq = c[rows]
    off = torch.tensor([-1, 0, 1], device=dev)
    xs = cq[:, :1] + off.repeat_interleave(3)[None]
    ys = cq[:, 1:2] + off.repeat(3)[None]
    inb = (xs >= 0) & (xs < dims[0]) & (ys >= 0) & (ys < dims[1])
    base = (xs * dims[1] + ys) * dims[2]
    zlo = (cq[:, 2] - 1).clamp_min(0)[:, None]
    zhi = torch.minimum(cq[:, 2] + 1, dims[2] - 1)[:, None]
    start = torch.searchsorted(ks, base + zlo)
    lens = torch.where(inb, torch.searchsorted(ks, base + zhi, right=True) - start, 0)
    cum = torch.cumsum(lens.sum(1), 0)
    total = int(cum[-1])
    cuts = []
    if total > block:
        cuts = torch.searchsorted(cum, torch.arange(block, total, block, device=dev)).tolist()
    bounds = [0] + sorted(set(int(v) + 1 for v in cuts)) + [rows.shape[0]]
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b <= a:
            continue
        L = lens[a:b].reshape(-1)
        S = start[a:b].reshape(-1)
        rid = torch.repeat_interleave(torch.arange(L.shape[0], device=dev), L)
        first = torch.cumsum(L, 0) - L
        j = S[rid] + (torch.arange(rid.shape[0], device=dev) - first[rid])
        yield rows[a + rid // 9], order[j]


def _start_cell(pts: torch.Tensor, k: int) -> float:
    """A first cell for a k-NN query: points lie on surfaces, so the k-NN
    radius scales like spacing * sqrt(k / pi), spacing ~ diag / sqrt(n)."""
    n = max(pts.shape[0], 1)
    diag = float((pts.amax(0) - pts.amin(0)).double().norm())
    return max(diag / math.sqrt(n) * math.sqrt(max(k, 2) / math.pi) * 1.5, 1e-9)


def _segment_rank(q: torch.Tensor) -> torch.Tensor:
    """Rank of each entry within its run of equal (sorted) q."""
    idx = torch.arange(q.shape[0], device=q.device)
    start = torch.ones_like(q, dtype=torch.bool)
    start[1:] = q[1:] != q[:-1]
    return idx - torch.cummax(torch.where(start, idx, 0), 0).values


def knn_nonself(pts: torch.Tensor, k: int, max_doublings: int = 10):
    """The k nearest rows at nonzero distance of every row of pts f32[n, 3]:
    (dist f32[n, k] ascending, idx i64[n, k]); inf where a row has fewer.
    Exact: a row is taken from a grid pass only where its k-th neighbour
    lies within the cell, else it is queried again at twice the cell, and
    the few left at the end against the whole cloud."""
    dev = pts.device
    n = pts.shape[0]
    dist = torch.full((n, k), torch.inf, dtype=torch.float32, device=dev)
    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    todo = torch.arange(n, device=dev)
    cell = _start_cell(pts, k + 1)
    for _ in range(max_doublings):
        if todo.numel() == 0:
            break
        for q, j in candidate_blocks(pts, cell, todo):
            dd = d2(pts, q, j)
            dd = torch.where(dd > 0.0, dd, torch.inf)
            o = torch.argsort(dd, stable=True)
            o = o[torch.argsort(q[o], stable=True)]
            rank = _segment_rank(q[o])
            take = rank < k
            o = o[take]
            dist[q[o], rank[take]] = dd[o].sqrt()
            idx[q[o], rank[take]] = j[o]
        todo = todo[~(dist[todo, k - 1] < cell * (1.0 - 1e-6))]
        cell *= 2.0
    for s in range(0, todo.shape[0], 8):
        rows = todo[s:s + 8]
        dx, dy, dz = (pts[None, :, a] - pts[rows, a, None] for a in range(3))
        dd = dx * dx + dy * dy + dz * dz
        dd = torch.where(dd > 0.0, dd, torch.inf)
        vals, ids = torch.topk(dd, min(k, n), dim=1, largest=False)
        dist[rows, :vals.shape[1]] = vals.sqrt()
        idx[rows, :ids.shape[1]] = ids
    return dist, idx


def pairs_within(pts: torch.Tensor, r2: float, cell: float):
    """Every ordered pair of rows (self included) with float32 d2 <= r2, as
    (q i64, j i64, d2 f32) grouped by q; `cell` must be at least the
    radius."""
    qs, js, ds = [], [], []
    for q, j in candidate_blocks(pts, cell):
        dd = d2(pts, q, j)
        keep = dd <= r2
        qs.append(q[keep])
        js.append(j[keep])
        ds.append(dd[keep])
    if not qs:
        e = torch.zeros((0,), dtype=torch.int64, device=pts.device)
        return e, e, torch.zeros((0,), dtype=torch.float32, device=pts.device)
    return torch.cat(qs), torch.cat(js), torch.cat(ds)
