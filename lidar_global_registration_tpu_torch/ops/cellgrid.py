"""Cell-list neighbour passes: surface (normals, density), ISS keypoints
and FPFH.

The counterpart of lidar_global_registration_tpu/ops/pallas/cellgrid.py,
laid out for the H100 instead of the TPU:

  plan:   points sorted by an int64 lexicographic cell key (cell = search
          radius, so the 27-cell stencil holds every neighbour) with ONE
          stable sort; for every occupied cell a CSR row of the 9 z-columns
          of its stencil, each a contiguous [start, end) range of the sorted
          order (z is the fastest key axis), found with searchsorted.
  passes: one CUDA thread per sorted query walks its cell's 9 ranges
          (csrc/surface.cu, csrc/iss.cu, csrc/fpfh.cu; K5 gives a warp up
          to 32 queries of one cell, spfh_items; K4 leaves out the columns
          beyond its radius, near_columns, and ends a query at its first
          blocking neighbour).  Neighbouring threads of a warp sit in one
          cell, so their candidate loads hit the same lines.

Every kernel has a plain PyTorch version here that walks the same plan
with padded candidate blocks over query chunks.  A wrapper runs the plain
version only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises.  Outputs keep the JAX package's layout (input order,
SoA channels) at the public functions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from lidar_global_registration_tpu_torch import kernels

NR_BINS = 11
DIM = 33
BIG = 3.0e38
_INT32_MAX = 2**31 - 1
# the cell is the radius widened by this relative margin: a pair whose
# float32 d2 rounds to <= r2 can be up to ~1e-7 relatively beyond r, and
# must still lie in adjacent cells
_CELL_MARGIN = 1e-5
_CHUNK_PAIRS = 1 << 21  # candidate slots per query chunk of the plain versions


@dataclass(frozen=True)
class GridPlan:
    """Sorted state + CSR stencil table of one grid.

    order:   i64[N] input row of each sorted slot (valid points first);
    n_valid: number of valid points (sorted slots [0, n_valid));
    pts:     f32[N, 4] sorted xyz (w = 0), 16-byte rows for one vector load;
    nrm:     f32[N, 4] sorted normals (zeros until set_normals);
    oid:     i32[n_valid] = order[:n_valid], the input id of each query;
    cell_of: i32[n_valid] CSR row of each sorted point's cell;
    cols:    i32[n_cells, 9, 2] [start, end) of the 9 stencil columns;
    valid:   bool[N] input-order validity;
    origin, cell, dims, keys: the grid (f64[3] corner, widened cell size,
             i64[3] cells per axis) and the sorted cell keys i64[n_valid],
             which place any position on it (position_cols)."""

    order: torch.Tensor
    n_valid: int
    pts: torch.Tensor
    nrm: torch.Tensor
    oid: torch.Tensor
    cell_of: torch.Tensor
    cols: torch.Tensor
    valid: torch.Tensor
    origin: torch.Tensor
    cell: float
    dims: torch.Tensor
    keys: torch.Tensor


def _column_ranges(keys: torch.Tensor, cx, cy, cz, dims: torch.Tensor, s: int = 1):
    """[start, end) ranges (i64[m, (2s+1)^2, 2]) of the sorted `keys` in
    the z-columns of every cell within s cells (Chebyshev) of the cells
    (cx, cy, cz) i64[m]: for each (dx, dy), x-major, the contiguous key
    run from z - s to z + s (z is the fastest key axis).  Cells may lie
    off the grid; their off-grid columns are empty."""
    dev = keys.device
    off = torch.arange(-s, s + 1, dtype=torch.int64, device=dev)
    ox = off.repeat_interleave(2 * s + 1)
    oy = off.repeat(2 * s + 1)
    nx, ny, nz = dims[0], dims[1], dims[2]
    xs = cx[:, None] + ox[None, :]
    ys = cy[:, None] + oy[None, :]
    inb = ((xs >= 0) & (xs < nx) & (ys >= 0) & (ys < ny)
           & ((cz + s >= 0) & (cz - s < nz))[:, None])
    base = (xs * ny + ys) * nz
    start = torch.searchsorted(keys, base + (cz - s).clamp_min(0)[:, None], right=False)
    end = torch.searchsorted(keys, base + torch.minimum(cz + s, nz - 1)[:, None], right=True)
    return torch.stack([torch.where(inb, start, 0), torch.where(inb, end, 0)], -1)


def plan_grid(xyz: torch.Tensor, valid: torch.Tensor, cell: float) -> GridPlan:
    """Sort the cloud by cell and build the 9-column CSR stencil table
    (counterpart of plan_grid / plan_grid_many / _grid_frame / _lex_keys,
    cellgrid.py:133-166, 504-531, with the exact m=1 cell)."""
    dev = xyz.device
    N = xyz.shape[0]
    cell = float(cell) * (1.0 + _CELL_MARGIN)
    x64 = xyz.to(torch.float64)
    n_valid = int(valid.sum())
    if n_valid > 0:
        lo = x64[valid].amin(0)
        origin = lo - 0.5 * cell
        c = torch.floor((x64 - origin) / cell).clamp_min(0).to(torch.int64)
        dims = c[valid].amax(0) + 1
    else:
        origin = torch.zeros(3, dtype=torch.float64, device=dev)
        c = torch.zeros((N, 3), dtype=torch.int64, device=dev)
        dims = torch.ones(3, dtype=torch.int64, device=dev)
    ny, nz = dims[1], dims[2]
    key = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
    key = torch.where(valid, key, torch.iinfo(torch.int64).max)
    ks, order = torch.sort(key, stable=True)
    ks = ks[:n_valid]
    uniq, counts = torch.unique_consecutive(ks, return_counts=True)
    n_cells = uniq.shape[0]
    cell_of = torch.repeat_interleave(
        torch.arange(n_cells, dtype=torch.int32, device=dev), counts
    )
    cx, cy, cz = uniq // (ny * nz), (uniq // nz) % ny, uniq % nz
    cols = _column_ranges(ks, cx, cy, cz, dims).to(torch.int32).contiguous()
    pad = torch.zeros((N, 1), dtype=torch.float32, device=dev)
    pts = torch.cat([xyz.to(torch.float32)[order], pad], 1).contiguous()
    return GridPlan(
        order=order, n_valid=n_valid, pts=pts, nrm=torch.zeros_like(pts),
        oid=order[:n_valid].to(torch.int32).contiguous(), cell_of=cell_of,
        cols=cols, valid=valid, origin=origin, cell=cell, dims=dims, keys=ks,
    )


def position_cols(plan: GridPlan, xyz: torch.Tensor) -> torch.Tensor:
    """i64[m, 9, 2]: the 9 stencil column ranges of the cell that holds
    each position xyz f32[m, 3] (any point, on the plan's cloud or not; its
    cell may be empty or off the grid), found with plan_grid's
    searchsorted."""
    c = torch.floor((xyz.to(torch.float64) - plan.origin) / plan.cell).to(torch.int64)
    return _column_ranges(plan.keys, c[:, 0], c[:, 1], c[:, 2], plan.dims)


def set_normals(plan: GridPlan, normal: torch.Tensor) -> GridPlan:
    """The plan with `normal` (input order, [N, 3]) in its sorted state."""
    pad = torch.zeros((normal.shape[0], 1), dtype=torch.float32, device=normal.device)
    nrm = torch.cat([normal.to(torch.float32)[plan.order], pad], 1).contiguous()
    return replace(plan, nrm=nrm)


def _unsort(plan: GridPlan, sorted_rows: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Scatter per-sorted-query rows [n_valid, ...] back to input order [N, ...]."""
    N = plan.order.shape[0]
    out = torch.full((N,) + sorted_rows.shape[1:], fill, dtype=sorted_rows.dtype,
                     device=sorted_rows.device)
    out[plan.order[:plan.n_valid]] = sorted_rows
    return out


def candidates_from_cols(cols: torch.Tensor):
    """Padded candidate block of queries with stencil column ranges
    `cols` (i64[m, C, 2]): (ids i64[m, L], ok bool[m, L]), every sorted
    slot of the columns, in column order."""
    cols = cols.long()
    start = cols[..., 0]
    ln = cols[..., 1] - start
    cum = ln.cumsum(1)
    tot = cum[:, -1]
    L = max(int(tot.max()) if tot.numel() else 0, 1)
    k = torch.arange(L, device=cols.device)[None, :].expand(cols.shape[0], L).contiguous()
    col = torch.searchsorted(cum, k, right=True).clamp_max(cols.shape[1] - 1)
    before = cum.gather(1, col) - ln.gather(1, col)
    ids = start.gather(1, col) + (k - before)
    ok = k < tot[:, None]
    return torch.where(ok, ids, 0), ok


def candidates_at(plan: GridPlan, slots: torch.Tensor):
    """Padded candidate block of the sorted queries `slots` (i64[m]):
    (ids i64[m, L], ok bool[m, L]) — every point of the 9 stencil columns,
    in column order."""
    return candidates_from_cols(plan.cols[plan.cell_of[slots].long()])


def candidates(plan: GridPlan, q0: int, q1: int):
    """candidates_at for the sorted queries [q0, q1)."""
    return candidates_at(plan, torch.arange(q0, q1, device=plan.pts.device))


_CHUNK_BLOCK = 256  # queries per block when grouping queries into chunks


def _chunk_ranges(lens: torch.Tensor):
    """[a, b) ranges over queries with stencil sizes `lens` whose padded
    candidate blocks (rows x the widest row) hold about _CHUNK_PAIRS slots.
    Queries come in cell order, so a block's rows are alike; the blocks'
    widest rows are read to the host once and grouped greedily."""
    m = lens.shape[0]
    if m == 0:
        return []
    nb = -(-m // _CHUNK_BLOCK)
    pad = torch.zeros(nb * _CHUNK_BLOCK - m, dtype=lens.dtype, device=lens.device)
    widest = torch.cat([lens, pad]).view(nb, _CHUNK_BLOCK).amax(1).clamp_min(1).tolist()
    out, a, cur = [], 0, 0
    for blk, w in enumerate(widest):
        b = blk * _CHUNK_BLOCK
        if b > a and (b + _CHUNK_BLOCK - a) * max(cur, w) > _CHUNK_PAIRS:
            out.append((a, b))
            a, cur = b, 0
        cur = max(cur, w)
    out.append((a, m))
    return out


def _stencil_lens(plan: GridPlan, slots: torch.Tensor | None = None) -> torch.Tensor:
    """Candidates in the stencil of each sorted query (of `slots`, or all)."""
    per_cell = (plan.cols[..., 1] - plan.cols[..., 0]).sum(1)
    cell = plan.cell_of if slots is None else plan.cell_of[slots]
    return per_cell[cell.long()]


def _query_chunks(plan: GridPlan):
    """Ranges of sorted queries, about _CHUNK_PAIRS candidate slots each."""
    if plan.n_valid == 0:
        return []
    return _chunk_ranges(_stencil_lens(plan))


def _slot_chunks(plan: GridPlan, slots: torch.Tensor):
    """(position range, slot tensor) chunks of a sorted-slot list."""
    if slots.numel() == 0:
        return []
    return [((a, b), slots[a:b]) for a, b in _chunk_ranges(_stencil_lens(plan, slots))]


def _pair_d2(plan: GridPlan, slots: torch.Tensor, ids: torch.Tensor):
    """Candidate offsets from their queries (dx, dy, dz) and d2, rounded
    like the kernels (no FMA)."""
    d = plan.pts[ids, :3] - plan.pts[slots, None, :3]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


def slot_of(plan: GridPlan) -> torch.Tensor:
    """i64[N]: sorted slot of each input row, -1 for invalid rows."""
    N = plan.order.shape[0]
    inv = torch.full((N,), -1, dtype=torch.int64, device=plan.order.device)
    inv[plan.order[:plan.n_valid]] = torch.arange(plan.n_valid, device=plan.order.device)
    return inv


# ---------------------------------------------------------------------------
# Smith closed-form smallest eigenpair (cellgrid._smallest_eig3, eigen3.py)
# ---------------------------------------------------------------------------
def atan2_poly(y, x):
    """The JAX package's polynomial atan2 (cellgrid._atan2_poly,
    Abramowitz-Stegun 4.4.49, ~1e-5 rad)."""
    ax, ay = x.abs(), y.abs()
    z = torch.minimum(ax, ay) / torch.maximum(ax, ay).clamp_min(1e-30)
    s = z * z
    p = z * (0.99986614 + s * (-0.33029951 + s * (0.18014100 + s * (-0.08513300
                                                                   + s * 0.02083510))))
    r = torch.where(ay > ax, math.pi / 2 - p, p)
    r = torch.where(x < 0, math.pi - r, r)
    return torch.where(y < 0, -r, r)


def smallest_eig3(a00, a01, a02, a11, a12, a22):
    """(l0 <= l1 <= l2, unit eigenvector of l0) of symmetric 3x3 matrices
    given as 6 component tensors; the degenerate fallback vector is +z.
    The angle uses the reference's polynomial acos: l0 of a flat patch is
    the small difference of two O(trace) terms, so the angle's rounding
    shows in the curvature, and the port keeps the reference's."""
    eps = 1e-20
    scale = torch.stack([a00.abs(), a11.abs(), a22.abs(), a01.abs(), a02.abs(),
                         a12.abs()]).amax(0).clamp_min(eps)
    b00, b11, b22 = a00 / scale, a11 / scale, a22 / scale
    b01, b02, b12 = a01 / scale, a02 / scale, a12 / scale
    q = (b00 + b11 + b22) / 3.0
    p1 = b01 * b01 + b02 * b02 + b12 * b12
    c00, c11, c22 = b00 - q, b11 - q, b22 - q
    p2 = c00 * c00 + c11 * c11 + c22 * c22 + 2.0 * p1
    p = (p2 / 6.0).clamp_min(0.0).sqrt()
    sp = p.clamp_min(eps)
    d00, d11, d22 = c00 / sp, c11 / sp, c22 / sp
    d01, d02, d12 = b01 / sp, b02 / sp, b12 / sp
    det = (d00 * (d11 * d22 - d12 * d12) - d01 * (d01 * d22 - d12 * d02)
           + d02 * (d01 * d12 - d11 * d02))
    r = (det / 2.0).clamp(-1.0, 1.0)
    phi = atan2_poly((1.0 - r * r).clamp_min(0.0).sqrt(), r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    iso = p <= eps
    e_hi = torch.where(iso, q, e_hi)
    e_mid = torch.where(iso, q, e_mid)
    e_lo = torch.where(iso, q, e_lo)
    m00, m11, m22 = b00 - e_lo, b11 - e_lo, b22 - e_lo

    def cross(ax, ay, az, bx, by, bz):
        return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)

    c01 = cross(m00, b01, b02, b01, m11, b12)
    c02 = cross(m00, b01, b02, b02, b12, m22)
    c12 = cross(b01, m11, b12, b02, b12, m22)
    n01, n02, n12 = (v[0] * v[0] + v[1] * v[1] + v[2] * v[2] for v in (c01, c02, c12))
    best12 = n12 > torch.maximum(n01, n02)
    best02 = (~best12) & (n02 > n01)
    v = [torch.where(best12, c12[i], torch.where(best02, c02[i], c01[i])) for i in range(3)]
    degen = torch.maximum(torch.maximum(n01, n02), n12) <= eps * 10.0
    vx = torch.where(degen, 0.0, v[0])
    vy = torch.where(degen, 0.0, v[1])
    vz = torch.where(degen, 1.0, v[2])
    vn = (vx * vx + vy * vy + vz * vz).clamp_min(eps).sqrt()
    return e_lo * scale, e_mid * scale, e_hi * scale, vx / vn, vy / vn, vz / vn


# ---------------------------------------------------------------------------
# K1 · surface: radius moments -> normal, curvature, eigenvalues, count, NN
# ---------------------------------------------------------------------------
def _surface_rows(plan: GridPlan, r2: float, slots: torch.Tensor, oid: torch.Tensor):
    """K1's rows (f32[m, 8], nn_d f32[m], nn_id i32[m]) of the sorted
    queries `slots`."""
    ids, ok = candidates_at(plan, slots)
    dx, dy, dz, d2 = _pair_d2(plan, slots, ids)
    w = (ok & (d2 <= r2)).to(torch.float32)
    s0 = w.sum(1)
    cnt = s0.clamp_min(1.0)
    mx, my, mz = (dx * w).sum(1) / cnt, (dy * w).sum(1) / cnt, (dz * w).sum(1) / cnt
    l0, l1, l2, vx, vy, vz = smallest_eig3(
        (dx * dx * w).sum(1) / cnt - mx * mx,
        (dx * dy * w).sum(1) / cnt - mx * my,
        (dx * dz * w).sum(1) / cnt - mx * mz,
        (dy * dy * w).sum(1) / cnt - my * my,
        (dy * dz * w).sum(1) / cnt - my * mz,
        (dz * dz * w).sum(1) / cnt - mz * mz,
    )
    tot = (l0 + l1 + l2).clamp_min(1e-30)
    curv = l0.clamp_min(0.0) / tot
    rows = torch.stack([vx, vy, vz, curv, l0, l1, l2, s0], 1)
    dpos = torch.where((w > 0) & (d2 > 0.0), d2, torch.inf)
    dmin = dpos.amin(1)
    cand = torch.where(dpos == dmin[:, None], oid[ids], _INT32_MAX)
    has = torch.isfinite(dmin)
    return (rows, torch.where(has, dmin, 0.0).sqrt(),
            torch.where(has, cand.amin(1), -1).to(torch.int32))


def surface_plain(plan: GridPlan, r2: float, slots=None):
    """Plain version of csrc/surface.cu.  Per sorted query: moments of the
    neighbours within r (self included) centred on the query, covariance,
    smallest eigenpair; nearest neighbour at nonzero distance (ties to the
    lowest input id).  Returns (out f32[n, 8] = normal xyz, curvature,
    l0, l1, l2, count; nn_d f32[n] (0 without a neighbour); nn_id i32[n]
    input id, -1 without a neighbour).  With `slots` (i64[m] sorted slots)
    only those queries are computed; every other row stays 0 / 0 / -1."""
    dev = plan.pts.device
    n = plan.n_valid
    out = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    nn_d = torch.zeros((n,), dtype=torch.float32, device=dev)
    nn_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    oid = plan.order.to(torch.int32)
    if slots is None:
        chunks = [torch.arange(a, b, device=dev) for a, b in _query_chunks(plan)]
    else:
        chunks = [sl for _pos, sl in _slot_chunks(plan, slots)]
    for sl in chunks:
        out[sl], nn_d[sl], nn_id[sl] = _surface_rows(plan, r2, sl, oid)
    return out, nn_d, nn_id


def _launch_surface(plan: GridPlan, r2: float, slots, m: int):
    n = plan.n_valid
    dev = plan.pts.device
    out = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    nn_d = torch.zeros((n,), dtype=torch.float32, device=dev)
    nn_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if m == 0:
        return out, nn_d, nn_id
    _check_plan(plan)
    if slots is not None:
        kernels.check(slots, torch.int32, (m,), "slots")
    kernels.launch(
        "lgr_surface", plan.pts.data_ptr(), plan.cell_of.data_ptr(),
        plan.cols.data_ptr(), plan.oid.data_ptr(), 0 if slots is None else slots.data_ptr(),
        m, r2, out.data_ptr(), nn_d.data_ptr(), nn_id.data_ptr(), _stream(plan),
    )
    return out, nn_d, nn_id


def surface_cuda(plan: GridPlan, r2: float):
    """K1 · csrc/surface.cu over every query: same contract as
    surface_plain without slots."""
    out = _launch_surface(plan, r2, None, plan.n_valid)
    if plan.n_valid:
        surface_cuda.launches += 1
    return out


surface_cuda.launches = 0


def surface_at_cuda(plan: GridPlan, r2: float, slots: torch.Tensor):
    """K1 slot-list form · `surface_kernel` over the sorted queries
    `slots`: same contract as surface_plain with slots."""
    sl = slots.to(torch.int32).contiguous()
    out = _launch_surface(plan, r2, sl, sl.shape[0])
    if sl.shape[0]:
        surface_at_cuda.launches += 1
    return out


surface_at_cuda.launches = 0


def surface_sorted(plan: GridPlan, r2: float, slots=None):
    """K1 on the plan's device: the kernel on CUDA, the plain version on CPU."""
    if plan.pts.is_cuda:
        if slots is None:
            return surface_cuda(plan, r2)
        return surface_at_cuda(plan, r2, slots)
    return surface_plain(plan, r2, slots)


def _f32_square(r: float) -> float:
    """r*r rounded like the JAX package's float32 `r * r`."""
    r32 = np.float32(r)
    return float(r32 * r32)


def surface_pass(plan: GridPlan, normal_radius: float, viewpoint=None, need=None):
    """Surface pass on a plan (cellgrid.surface_pass + the epilogue of
    _surface_iss_impl, cellgrid.py:1734-1784): normals flipped towards the
    viewpoint and zeroed where fewer than 3 points lie within the radius,
    curvature, k=2 smoothed density through the nearest neighbour,
    eigenvalues.  need (bool[N] input order): K1 runs only on the points
    of the cells within one cell of a needed point, which holds every
    needed point's nearest neighbour, so the density is exact at needed
    points; ok = valid & count >= 3 & need, and the normal is 0 elsewhere.
    Returns (normal [N,3], curv [N], density [N], eigvals [N,3], ok [N])
    in input order."""
    dev = plan.pts.device
    slots = None
    if need is not None:
        slots = stencil_slots(plan, torch.nonzero(need[plan.order[:plan.n_valid]]).squeeze(1))
    rows, nn_d, nn_id = surface_sorted(plan, _f32_square(normal_radius), slots)
    rows = _unsort(plan, rows)
    dmin = _unsort(plan, nn_d)
    nnid = _unsort(plan, nn_id, fill=-1).long()
    valid = plan.valid
    normal = rows[:, 0:3]
    cnt = rows[:, 7]
    ok = valid & (cnt >= 3)
    if need is not None:
        ok = ok & need
    vp = torch.zeros(3, dtype=torch.float32, device=dev) if viewpoint is None else (
        torch.as_tensor(viewpoint, dtype=torch.float32, device=dev))
    xyz = _unsort(plan, plan.pts[:plan.n_valid, :3])
    to_vp = vp[None, :] - xyz
    flip = (normal * to_vp).sum(-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    normal = torch.where(ok[:, None], normal, 0.0)
    has_nn = nnid >= 0
    d_raw = torch.where(valid & has_nn, dmin, 0.0)
    d_nn = torch.where(has_nn, d_raw[nnid.clamp_min(0)], d_raw)
    density = torch.where(
        valid & has_nn, torch.minimum(d_raw, torch.where(d_nn > 0, d_nn, d_raw)), 0.0
    )
    return normal, rows[:, 3], density, rows[:, 4:7], ok


# ---------------------------------------------------------------------------
# K2-K4 · ISS keypoints: radius count, weighted scatter saliency, NMS
# ---------------------------------------------------------------------------
def _sorted_chunks(plan: GridPlan):
    dev = plan.pts.device
    for a, b in _query_chunks(plan):
        sl = torch.arange(a, b, device=dev)
        ids, ok = candidates_at(plan, sl)
        yield a, b, sl, ids, ok


def iss_count_plain(plan: GridPlan, r2: float):
    """Plain version of csrc/iss.cu `iss_count_kernel` (_iss_count_cell):
    per sorted query the points within r, self included, and K3's weight
    of the point, its reciprocal.  Returns (count i32[n], inv f32[n] =
    1 / max(count, 1), the float32 quotient)."""
    count = torch.zeros((plan.n_valid,), dtype=torch.int32, device=plan.pts.device)
    for a, b, sl, ids, ok in _sorted_chunks(plan):
        d2 = _pair_d2(plan, sl, ids)[3]
        count[a:b] = (ok & (d2 <= r2)).sum(1).to(torch.int32)
    return count, 1.0 / count.to(torch.float32).clamp_min(1.0)


def iss_saliency_plain(plan: GridPlan, r2: float, inv: torch.Tensor,
                       gamma21: float, gamma32: float):
    """Plain version of csrc/iss.cu `iss_saliency_kernel`
    (_iss_saliency_cell): the scatter sum w (c - q)(c - q)^T / sum w over
    the neighbours within r (self excluded by d2 > 0), each weighted by
    `inv`, 1 / its K2 count; eigenvalues l3 <= l2 <= l1.  A query passes where
    l2 / l1 < gamma21, l3 / l2 < gamma32 and l3 > 0.  Returns (saliency
    f32[n] = l3 where it passes else 0, ok bool[n], neighbours i32[n])."""
    dev = plan.pts.device
    n = plan.n_valid
    sal = torch.zeros((n,), dtype=torch.float32, device=dev)
    okq = torch.zeros((n,), dtype=torch.bool, device=dev)
    nnb = torch.zeros((n,), dtype=torch.int32, device=dev)
    for a, b, sl, ids, ok in _sorted_chunks(plan):
        dx, dy, dz, d2 = _pair_d2(plan, sl, ids)
        nb = ok & (d2 > 0.0) & (d2 <= r2)
        w = torch.where(nb, inv[ids], 0.0)
        ws = w.sum(1)
        wdx, wdy, wdz = w * dx, w * dy, w * dz
        wsafe = ws.clamp_min(1e-30)
        l3, l2, l1, _vx, _vy, _vz = smallest_eig3(
            (wdx * dx).sum(1) / wsafe, (wdx * dy).sum(1) / wsafe,
            (wdx * dz).sum(1) / wsafe, (wdy * dy).sum(1) / wsafe,
            (wdy * dz).sum(1) / wsafe, (wdz * dz).sum(1) / wsafe,
        )
        good = ((ws > 0) & (l2 / l1.clamp_min(1e-30) < gamma21)
                & (l3 / l2.clamp_min(1e-30) < gamma32) & (l3 > 0))
        sal[a:b] = torch.where(good, l3, 0.0)
        okq[a:b] = good
        nnb[a:b] = nb.sum(1).to(torch.int32)
    return sal, okq, nnb


def iss_nms_plain(plan: GridPlan, r2: float, sal: torch.Tensor, okq: torch.Tensor,
                  min_neighbors: int) -> torch.Tensor:
    """Plain version of csrc/iss.cu `iss_nms_kernel` (_iss_nms_cell): a
    keypoint passed K3, has at least min_neighbors neighbours within r
    (self excluded) and a saliency above every neighbour's.  bool[n]."""
    kp = torch.zeros((plan.n_valid,), dtype=torch.bool, device=plan.pts.device)
    for a, b, sl, ids, ok in _sorted_chunks(plan):
        d2 = _pair_d2(plan, sl, ids)[3]
        nb = ok & (d2 > 0.0) & (d2 <= r2)
        nb_max = torch.where(nb, sal[ids], -BIG).amax(1)
        kp[a:b] = okq[a:b] & (nb.sum(1) >= min_neighbors) & (sal[a:b] > nb_max)
    return kp


def _stream(plan: GridPlan):
    return torch.cuda.current_stream(plan.pts.device).cuda_stream


_FACE_GUARD = 1e-6  # csrc/cellgrid.cuh kFaceGuard, in cells
_NEAR_MARGIN = 1e-5  # csrc/cellgrid.cuh kNearMargin, on r2


def near_columns(plan: GridPlan, r2: float) -> torch.Tensor:
    """bool[n, 9]: the stencil columns (x-major over dx, dy, as `cols`)
    that K4 walks for each sorted query; the others provably hold no point
    within r.  The plain mirror of csrc/cellgrid.cuh `near_columns`
    on the kernels' own arguments (the sorted float32 rows, plan.origin,
    plan.cell, r2): per axis the query's place in its cell from the float64
    quotient, lower bounds of its gaps to the neighbouring cell layers
    (none within _FACE_GUARD of a face), and a column is left out when its
    squared gap exceeds r2 (1 + _NEAR_MARGIN) / cell^2.  No kernel takes
    this table: K4 applies the rule per thread from plan.origin and
    plan.cell (`origin`, `cell` of lgr_iss_nms), and the tests and the count
    of the candidates it may visit use the mirror."""
    q = plan.pts[:plan.n_valid, :2]
    inv_cell = 1.0 / plan.cell
    u = (q.to(torch.float64) - plan.origin[:2]) * inv_cell
    f = (u - torch.floor(u)).to(torch.float32)
    safe = (u.abs() < 1e8) & (f > _FACE_GUARD) & (f < 1.0 - _FACE_GUARD)
    zero = torch.zeros_like(f)
    lo = torch.where(safe, f - _FACE_GUARD, zero)
    hi = torch.where(safe, (1.0 - f) - _FACE_GUARD, zero)
    gap = torch.stack([lo, zero, hi], -1)  # [n, axis, layer]
    lim = math.inf  # an r2 too small for the rounding argument: skip nothing
    if r2 >= 1e-30:
        lim = float(np.float32(r2 * (1.0 + _NEAR_MARGIN) * inv_cell * inv_cell))
    gx, gy = gap[:, 0, :, None], gap[:, 1, None, :]
    return (gx * gx + gy * gy <= lim).reshape(-1, 9)


def iss_count_cuda(plan: GridPlan, r2: float):
    """K2 · csrc/iss.cu `iss_count_kernel`: same contract as iss_count_plain."""
    n = plan.n_valid
    count = torch.empty((n,), dtype=torch.int32, device=plan.pts.device)
    inv = torch.empty((n,), dtype=torch.float32, device=plan.pts.device)
    if n == 0:
        return count, inv
    _check_plan(plan)
    kernels.launch("lgr_iss_count", plan.pts.data_ptr(), plan.cell_of.data_ptr(),
                   plan.cols.data_ptr(), n, r2, count.data_ptr(), inv.data_ptr(),
                   _stream(plan))
    iss_count_cuda.launches += 1
    return count, inv


iss_count_cuda.launches = 0


def iss_saliency_cuda(plan: GridPlan, r2: float, inv: torch.Tensor,
                      gamma21: float, gamma32: float):
    """K3 · csrc/iss.cu `iss_saliency_kernel`: same contract as
    iss_saliency_plain."""
    n = plan.n_valid
    dev = plan.pts.device
    sal = torch.empty((n,), dtype=torch.float32, device=dev)
    okq = torch.empty((n,), dtype=torch.bool, device=dev)
    nnb = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return sal, okq, nnb
    _check_plan(plan)
    kernels.check(inv, torch.float32, (n,), "inv")
    kernels.launch("lgr_iss_saliency", plan.pts.data_ptr(), plan.cell_of.data_ptr(),
                   plan.cols.data_ptr(), inv.data_ptr(), n, r2, gamma21, gamma32,
                   sal.data_ptr(), okq.data_ptr(), nnb.data_ptr(), _stream(plan))
    iss_saliency_cuda.launches += 1
    return sal, okq, nnb


iss_saliency_cuda.launches = 0


def iss_nms_cuda(plan: GridPlan, r2: float, sal: torch.Tensor, okq: torch.Tensor,
                 min_neighbors: int) -> torch.Tensor:
    """K4 · csrc/iss.cu `iss_nms_kernel`: same contract as iss_nms_plain.
    The kernel gets the plan's grid (origin, cell) to leave out the stencil
    columns beyond the radius (near_columns)."""
    n = plan.n_valid
    kp = torch.empty((n,), dtype=torch.bool, device=plan.pts.device)
    if n == 0:
        return kp
    _check_plan(plan)
    kernels.check(sal, torch.float32, (n,), "sal")
    kernels.check(okq, torch.bool, (n,), "ok")
    kernels.check(plan.origin, torch.float64, (3,), "origin")
    kernels.launch("lgr_iss_nms", plan.pts.data_ptr(), plan.cell_of.data_ptr(),
                   plan.cols.data_ptr(), sal.data_ptr(), okq.data_ptr(), n, r2,
                   int(min_neighbors), plan.origin.data_ptr(), plan.cell, kp.data_ptr(),
                   _stream(plan))
    iss_nms_cuda.launches += 1
    return kp


iss_nms_cuda.launches = 0


def iss_pass(plan: GridPlan, iss_radius: float, gamma21: float = 0.975,
             gamma32: float = 0.975, min_neighbors: int = 4):
    """ISS keypoints on a plan (cellgrid.iss_pass: the ISS half of
    _surface_iss_impl, cellgrid.py:1706-1727): K2 counts, K3 saliency, K4
    non-maximum suppression, each a pass over the plan (every pass needs
    its predecessor's result at every candidate).  The kernels on CUDA,
    the plain versions on CPU.  Returns (kp bool[N], saliency f32[N]) in
    input order, False / 0 at invalid rows."""
    r2 = _f32_square(iss_radius)
    if plan.pts.is_cuda:
        _count, inv = iss_count_cuda(plan, r2)
        sal, okq, _nnb = iss_saliency_cuda(plan, r2, inv, gamma21, gamma32)
        kp = iss_nms_cuda(plan, r2, sal, okq, min_neighbors)
    else:
        _count, inv = iss_count_plain(plan, r2)
        sal, okq, _nnb = iss_saliency_plain(plan, r2, inv, gamma21, gamma32)
        kp = iss_nms_plain(plan, r2, sal, okq, min_neighbors)
    return _unsort(plan, kp, fill=False) & plan.valid, _unsort(plan, sal)


def radius_counts(xyz: torch.Tensor, valid: torch.Tensor, radius: float) -> torch.Tensor:
    """The valid points within `radius` of each valid row, itself included
    (d2 <= r2): K2 (iss_count_cuda) on a plan at the radius, or its plain
    version on the CPU.  Returns i32[N] in input order, 0 at invalid rows."""
    plan = plan_grid(xyz, valid, radius)
    r2 = _f32_square(radius)
    count = (iss_count_cuda if plan.pts.is_cuda else iss_count_plain)(plan, r2)[0]
    return _unsort(plan, count, fill=0)


# ---------------------------------------------------------------------------
# K5 · SPFH: Darboux pair features binned 3 x 11, x 100 / count
# ---------------------------------------------------------------------------
def pair_feature_bins(q, qn, c, cn, centre, r2):
    """Bins (b1, b2, b3 i64) and validity of the pair features of query
    point/normal q, qn [m, 1, 3] against candidates c, cn [m, L, 3]
    (cellgrid._pair_feature_bins, PCL computePairFeatures with its |cos|
    source/target swap).  Coordinates are centred on `centre` (the cloud's
    AABB centre), so the arithmetic is the same on every grid."""
    qd = q - centre
    cd = c - centre
    dp = cd - qd
    dpx, dpy, dpz = dp[..., 0], dp[..., 1], dp[..., 2]
    qnx, qny, qnz = qn[..., 0], qn[..., 1], qn[..., 2]
    cnx, cny, cnz = cn[..., 0], cn[..., 1], cn[..., 2]
    d2 = dpx * dpx + dpy * dpy + dpz * dpz
    qn2 = qnx * qnx + qny * qny + qnz * qnz
    cn2 = cnx * cnx + cny * cny + cnz * cnz
    qndp = qnx * dpx + qny * dpy + qnz * dpz
    cndp = cnx * dpx + cny * dpy + cnz * dpz
    nsnt = qnx * cnx + qny * cny + qnz * cnz
    trip = (dpx * (qny * cnz - qnz * cny) + dpy * (qnz * cnx - qnx * cnz)
            + dpz * (qnx * cny - qny * cnx))
    dsafe = d2.clamp_min(0.0).sqrt().clamp_min(1e-30)
    a1 = qndp / dsafe
    a2 = cndp / dsafe
    swap = a1.abs() < a2.abs()
    f3 = torch.where(swap, a2, a1)
    ns_dp = torch.where(swap, cndp, qndp)
    ns2 = torch.where(swap, cn2, qn2)
    vn = (d2 * ns2 - ns_dp * ns_dp).clamp_min(0.0).sqrt()
    okv = (d2 > 0.0) & (vn > 1e-12)
    vsn = vn.clamp_min(1e-30)
    f2 = trip / vsn
    w_num = torch.where(swap, cndp * nsnt - cn2 * qndp, qn2 * cndp - qndp * nsnt)
    f1 = torch.atan2(w_num, nsnt * vsn)
    # Python scalars round to float32 inside the op, like JAX's weak types
    b1 = torch.floor(NR_BINS * (f1 + math.pi) / (2.0 * math.pi)).clamp(0, NR_BINS - 1)
    b2 = torch.floor(NR_BINS * (f2 + 1.0) / 2.0).clamp(0, NR_BINS - 1)
    b3 = torch.floor(NR_BINS * (f3 + 1.0) / 2.0).clamp(0, NR_BINS - 1)
    ok = okv & (d2 <= r2) & (cn2 > 0.5) & (qn2 > 0.5)
    return b1.long(), b2.long(), b3.long(), ok


def _hist_scale(cnt):
    """100 / count where count > 0, else 0 (float32, like _spfh_cell)."""
    return torch.where(cnt > 0, 100.0 / cnt.clamp_min(1.0), 0.0)


def _spfh_rows(plan: GridPlan, r2: float, centre: torch.Tensor, slots: torch.Tensor):
    """SPFH rows [m, 33] and pair counts [m] of the sorted queries `slots`."""
    dev = plan.pts.device
    ids, ok = candidates_at(plan, slots)
    m = slots.shape[0]
    b1, b2, b3, okp = pair_feature_bins(
        plan.pts[slots, None, :3], plan.nrm[slots, None, :3],
        plan.pts[ids, :3], plan.nrm[ids, :3], centre, r2,
    )
    okp = okp & ok
    hist = torch.zeros((m, DIM), dtype=torch.float32, device=dev)
    row = torch.arange(m, device=dev)[:, None].expand_as(b1)
    for blk, b in enumerate((b1, b2, b3)):
        flat = (row * DIM + blk * NR_BINS + b)[okp]
        hist.view(-1).index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    cnt = okp.sum(1).to(torch.float32)
    return hist * _hist_scale(cnt)[:, None], cnt


def spfh_plain(plan: GridPlan, r2: float, centre: torch.Tensor, slots=None):
    """Plain version of csrc/fpfh.cu `spfh_kernel`: per sorted query the
    3 x 11 histogram of its pair features x 100 / count.  With `slots`
    (i64[m] sorted slots) only those queries are computed and every other
    row stays 0.  Returns (spfh f32[n, 33], count f32[n])."""
    dev = plan.pts.device
    n = plan.n_valid
    spfh = torch.zeros((n, DIM), dtype=torch.float32, device=dev)
    count = torch.zeros((n,), dtype=torch.float32, device=dev)
    if slots is None:
        chunks = [(None, torch.arange(a, b, device=dev)) for a, b in _query_chunks(plan)]
    else:
        chunks = _slot_chunks(plan, slots)
    for _pos, sl in chunks:
        spfh[sl], count[sl] = _spfh_rows(plan, r2, centre, sl)
    return spfh, count


SPFH_ITEM = 32  # queries per K5 work item: one warp's lanes


def spfh_items(cells: torch.Tensor, n_cells: int) -> torch.Tensor:
    """K5's work list over a query list whose cells are `cells` (i32 or
    i64[m], nondecreasing, as ascending slots give them; n_cells bounds the
    cells they touch): i32[K, 2] rows (first position, length), each run of
    equal cells cut into pieces of at most SPFH_ITEM positions, in position
    order, then rows (m, 0) up to K = min(m, n_cells + ceil(m /
    SPFH_ITEM)), a bound on the item count that needs no host read.  Every
    position lies in exactly one item, no item crosses a cell, and the
    kernel skips the rows of length 0."""
    m = cells.shape[0]
    pos = torch.arange(m, device=cells.device)
    starts = (pos - torch.searchsorted(cells, cells)) % SPFH_ITEM == 0
    K = min(m, n_cells + -(-m // SPFH_ITEM))
    first = torch.full((K + 2,), m, dtype=torch.int64, device=cells.device)  # [K + 1]: a sink
    first.scatter_(0, torch.where(starts, torch.cumsum(starts, 0) - 1, K + 1), pos)
    return torch.stack([first[:K], first[1:K + 1] - first[:K]], 1).to(torch.int32).contiguous()


def _launch_spfh(plan: GridPlan, r2: float, centre: torch.Tensor, slots, m: int):
    """K5 over the sorted queries `slots` (every query when None): one warp
    per work item of spfh_items, on the rows centred on `centre`."""
    n = plan.n_valid
    dev = plan.pts.device
    spfh = torch.zeros((n, DIM), dtype=torch.float32, device=dev)
    count = torch.zeros((n,), dtype=torch.float32, device=dev)
    if m == 0:
        return spfh, count
    _check_plan(plan)
    N = plan.pts.shape[0]
    kernels.check(plan.nrm, torch.float32, (N, 4), "nrm")
    if N >= 1 << 26:  # the kernel's queue packs a slot and a lane in 32 bits
        raise ValueError(f"K5 takes plans of fewer than 2^26 rows, got {N}")
    if slots is not None:
        kernels.check(slots, torch.int32, (m,), "slots")
    items = spfh_items(plan.cell_of if slots is None else plan.cell_of[slots.long()],
                       plan.cols.shape[0])
    # the same float32 subtraction per coordinate as the pair features'
    # centring (w stays 0)
    ctr = plan.pts - torch.nn.functional.pad(centre.to(torch.float32), (0, 1))
    kernels.launch(
        "lgr_spfh", ctr.data_ptr(), plan.nrm.data_ptr(), plan.cell_of.data_ptr(),
        plan.cols.data_ptr(), 0 if slots is None else slots.data_ptr(), items.data_ptr(),
        items.shape[0], r2, spfh.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return spfh, count


def spfh_cuda(plan: GridPlan, r2: float, centre: torch.Tensor):
    """K5 · csrc/fpfh.cu `spfh_kernel` over every query: same contract as
    spfh_plain without slots."""
    out = _launch_spfh(plan, r2, centre, None, plan.n_valid)
    if plan.n_valid:
        spfh_cuda.launches += 1
    return out


spfh_cuda.launches = 0


def spfh_at_cuda(plan: GridPlan, r2: float, centre: torch.Tensor, slots: torch.Tensor):
    """K5 subset form · `spfh_kernel` over the sorted queries `slots`: same
    contract as spfh_plain with slots."""
    sl = slots.to(torch.int32).contiguous()
    out = _launch_spfh(plan, r2, centre, sl, sl.shape[0])
    if sl.shape[0]:
        spfh_at_cuda.launches += 1
    return out


spfh_at_cuda.launches = 0


def spfh_sorted(plan: GridPlan, r2: float, centre: torch.Tensor, slots=None):
    """K5 on the plan's device: the kernel on CUDA, the plain version on CPU."""
    if plan.pts.is_cuda:
        if slots is None:
            return spfh_cuda(plan, r2, centre)
        return spfh_at_cuda(plan, r2, centre, slots)
    return spfh_plain(plan, r2, centre, slots)


# ---------------------------------------------------------------------------
# K6 · combine: own SPFH + 1/d^2-weighted mean of the neighbours' SPFH
# ---------------------------------------------------------------------------
def _combine_finish(own, wsum, kcnt):
    """feat = own + wsum / max(k, 1), each 11-bin block rescaled to sum 100."""
    feat = own + wsum / kcnt.clamp_min(1.0)[:, None]
    blocks = []
    for blk in range(3):
        f = feat[:, blk * NR_BINS:(blk + 1) * NR_BINS]
        s = f.sum(1, keepdim=True)
        blocks.append(torch.where(s > 0, 100.0 * f / s.clamp_min(1e-30), f))
    return torch.cat(blocks, 1)


def _combine_rows(plan: GridPlan, r2: float, spfh: torch.Tensor, slots: torch.Tensor):
    ids, ok = candidates_at(plan, slots)
    _dx, _dy, _dz, d2 = _pair_d2(plan, slots, ids)
    nb = ok & (d2 > 0.0) & (d2 <= r2)
    w = torch.where(nb, 1.0 / d2.clamp_min(1e-30), 0.0)
    wsum = (spfh[ids] * w[..., None]).sum(1)
    k = nb.sum(1).to(torch.float32)
    return _combine_finish(spfh[slots], wsum, k), k


def combine_plain(plan: GridPlan, r2: float, spfh: torch.Tensor, slots=None):
    """Plain version of csrc/fpfh.cu `combine_kernel` (cellgrid._combine_cell).
    Without `slots`: (feat f32[n, 33], neighbour count f32[n]) per sorted
    query.  With `slots` (i64[M] sorted slots, -1 for padding): compacted
    rows (feat f32[M, 33], count f32[M]), 0 at the padding."""
    dev = plan.pts.device
    if slots is None:
        n = plan.n_valid
        feat = torch.zeros((n, DIM), dtype=torch.float32, device=dev)
        kcnt = torch.zeros((n,), dtype=torch.float32, device=dev)
        for a, b in _query_chunks(plan):
            feat[a:b], kcnt[a:b] = _combine_rows(plan, r2, spfh, torch.arange(a, b, device=dev))
        return feat, kcnt
    M = slots.shape[0]
    feat = torch.zeros((M, DIM), dtype=torch.float32, device=dev)
    kcnt = torch.zeros((M,), dtype=torch.float32, device=dev)
    real = torch.nonzero(slots >= 0).squeeze(1)
    for (a, b), sl in _slot_chunks(plan, slots[real]):
        feat[real[a:b]], kcnt[real[a:b]] = _combine_rows(plan, r2, spfh, sl)
    return feat, kcnt


def combine_order(slots: torch.Tensor):
    """The K6 launch order of a slot list: (slots i32[M] ascending, i.e. by
    cell, padding first; rows i32[M], the output row of each).  A stable
    sort, so repeats keep their order; neighbouring warps then walk
    neighbouring cells and share SPFH rows in cache."""
    srt, rows = torch.sort(slots, stable=True)
    return srt.to(torch.int32).contiguous(), rows.to(torch.int32).contiguous()


def _launch_combine(plan: GridPlan, r2: float, spfh: torch.Tensor, slots, m: int):
    """K6 over every sorted query (slots None: one thread per query, the
    threads of a warp share their cells' reads) or at a slot list (one warp
    per query, in cell order)."""
    dev = plan.pts.device
    feat = torch.empty((m, DIM), dtype=torch.float32, device=dev)
    kcnt = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:
        return feat, kcnt
    _check_plan(plan)
    kernels.check(spfh, torch.float32, (plan.n_valid, DIM), "spfh")
    srt = rows = None
    if slots is not None:
        kernels.check(slots, torch.int32, (m,), "slots")
        srt, rows = combine_order(slots)
    kernels.launch(
        "lgr_combine", plan.pts.data_ptr(), plan.cell_of.data_ptr(),
        plan.cols.data_ptr(), spfh.data_ptr(), 0 if srt is None else srt.data_ptr(),
        0 if rows is None else rows.data_ptr(), m, r2, int(slots is None),
        feat.data_ptr(), kcnt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    return feat, kcnt


def combine_cuda(plan: GridPlan, r2: float, spfh: torch.Tensor):
    """K6 · csrc/fpfh.cu `combine_kernel` over every query: same contract
    as combine_plain without slots."""
    out = _launch_combine(plan, r2, spfh, None, plan.n_valid)
    if plan.n_valid:
        combine_cuda.launches += 1
    return out


combine_cuda.launches = 0


def combine_at_cuda(plan: GridPlan, r2: float, spfh: torch.Tensor, slots: torch.Tensor):
    """K6 subset form · `combine_kernel` at the sorted queries `slots`
    (-1 = padding), compacted: same contract as combine_plain with slots."""
    sl = slots.to(torch.int32).contiguous()
    out = _launch_combine(plan, r2, spfh, sl, sl.shape[0])
    if sl.shape[0]:
        combine_at_cuda.launches += 1
    return out


combine_at_cuda.launches = 0


def combine_sorted(plan: GridPlan, r2: float, spfh: torch.Tensor, slots=None):
    """K6 on the plan's device: the kernel on CUDA, the plain version on CPU."""
    if plan.pts.is_cuda:
        if slots is None:
            return combine_cuda(plan, r2, spfh)
        return combine_at_cuda(plan, r2, spfh, slots)
    return combine_plain(plan, r2, spfh, slots)


def aabb_centre(plan: GridPlan) -> torch.Tensor:
    """Centre of the valid points' bounding box (float32, as _fpfh_impl)."""
    p = plan.pts[:plan.n_valid, :3]
    if plan.n_valid == 0:
        return torch.zeros(3, dtype=torch.float32, device=p.device)
    return 0.5 * (p.amin(0) + p.amax(0))


def _union_slots(n: int, ranges: torch.Tensor) -> torch.Tensor:
    """Ascending sorted slots of the union of [start, end) ranges
    (i64[r, 2]): a difference array over the slots and one cumsum."""
    diff = torch.zeros((n + 1,), dtype=torch.int32, device=ranges.device)
    one = torch.ones((ranges.shape[0],), dtype=torch.int32, device=ranges.device)
    diff.index_add_(0, ranges[:, 0], one)
    diff.index_add_(0, ranges[:, 1], -one)
    return torch.nonzero(diff.cumsum(0)[:n] > 0).squeeze(1)


def stencil_slots(plan: GridPlan, slots: torch.Tensor) -> torch.Tensor:
    """Sorted slots (ascending) of every point in the 27-cell stencil of a
    cell that holds one of the sorted queries `slots`: the union of those
    cells' CSR column ranges (the `kp` stencil of _fpfh_impl's SPFH pass)."""
    cells = torch.unique(plan.cell_of[slots])
    return _union_slots(plan.n_valid, plan.cols[cells.long()].reshape(-1, 2).long())


def point_need(plan: GridPlan, flags: torch.Tensor, s: int) -> torch.Tensor:
    """bool[N] input order: the valid points whose cell lies within `s`
    cells (Chebyshev, on this plan's grid) of the cell of a flagged point
    (flags bool[N] input order) (cellgrid.point_need).  Every point within
    s x the plan's radius of a flagged point is marked.  Per cell, finer
    than the JAX package's mask, which marks whole blocks of cells; the
    distance guarantee is the same."""
    N = plan.order.shape[0]
    need = torch.zeros((N,), dtype=torch.bool, device=plan.order.device)
    flagged = torch.nonzero(flags[plan.order[:plan.n_valid]]).squeeze(1)
    if flagged.numel() == 0:
        return need
    keys = torch.unique(plan.keys[flagged])
    ny, nz = plan.dims[1], plan.dims[2]
    cx, cy, cz = keys // (ny * nz), (keys // nz) % ny, keys % nz
    ranges = _column_ranges(plan.keys, cx, cy, cz, plan.dims, int(s)).reshape(-1, 2)
    need[plan.order[_union_slots(plan.n_valid, ranges)]] = True
    return need


def surface_iss_masked(plan_n: GridPlan, plan_f: GridPlan, normal_radius: float,
                       iss_radius: float, viewpoint=None, shot: bool = False):
    """The keypoint-regime side stage (cellgrid.surface_iss_masked): ISS
    keypoints on plan_n (K2-K4), then the surface pass (K1) masked to the
    points a later stage reads: those within 2 cells of a keypoint on
    plan_f's grid (the SPFH support of the keypoints' FPFH), or within 1
    cell for SHOT.  plan_n's cell holds both radii.  Returns (normal, kp,
    density, saliency) in input order."""
    kp, sal = iss_pass(plan_n, iss_radius)
    need = point_need(plan_f, kp, 1 if shot else 2)
    normal, _curv, density, _eig, _ok = surface_pass(plan_n, normal_radius, viewpoint, need=need)
    return normal, kp, density, sal


def surface_iss_cells(plan: GridPlan, normal_radius: float, iss_radius: float, viewpoint=None):
    """The unmasked side stage (cellgrid.surface_iss_cells): the surface
    pass (K1, every point) and ISS keypoints (K2-K4) on ONE plan, whose
    cell holds both radii (cell >= max(normal_radius, iss_radius)); each
    kernel masks its own radius.  Returns the JAX dict in input order:
    normal, curv, density, eigvals, ok, kp, saliency."""
    kp, sal = iss_pass(plan, iss_radius)
    normal, curv, density, eigvals, ok = surface_pass(plan, normal_radius, viewpoint)
    return dict(normal=normal, curv=curv, density=density, eigvals=eigvals, ok=ok, kp=kp,
                saliency=sal)


def fpfh_pass(plan: GridPlan, radius: float, kp=None, kp_rows=None):
    """FPFH on a plan whose normals are set (cellgrid.fpfh_pass): SPFH (K5)
    then the weighted combine (K6).

    kp (bool[N] input order): SPFH runs only on the points in the 27-cell
    stencil of a keypoint's cell, which holds every point the combine at a
    keypoint reads; descriptors are then exact at keypoint rows and 0
    elsewhere.  kp_rows (i64[M] input rows, repeats allowed, >= N =
    padding): the combine runs only there and returns compacted rows.

    Returns (feat f32[N, 33], feat_valid bool[N]) in input order, or
    (feat f32[M, 33], feat_valid bool[M]) with kp_rows; feat_valid = valid
    row & (neighbour count > 0), and feat is 0 where it is False."""
    dev = plan.pts.device
    N = plan.order.shape[0]
    r2 = _f32_square(radius)
    centre = aabb_centre(plan)
    inv = slot_of(plan) if (kp is not None or kp_rows is not None) else None
    if kp is None:
        spfh, _count = spfh_sorted(plan, r2, centre)
    else:
        kp_slots = torch.nonzero(kp[plan.order[:plan.n_valid]]).squeeze(1)
        spfh, _count = spfh_sorted(plan, r2, centre, stencil_slots(plan, kp_slots))
    if kp_rows is not None:
        srt = torch.where(kp_rows < N, inv[kp_rows.clamp_max(N - 1)], -1)
        feat, kcnt = combine_sorted(plan, r2, spfh, srt)
        fv = (srt >= 0) & (kcnt > 0)
        return torch.where(fv[:, None], feat, 0.0), fv
    if kp is None:
        feat_s, kcnt_s = combine_sorted(plan, r2, spfh)
        feat = _unsort(plan, feat_s)
        kcnt = _unsort(plan, kcnt_s)
    else:
        rows = torch.nonzero(kp & plan.valid).squeeze(1)
        feat_k, kcnt_k = combine_sorted(plan, r2, spfh, inv[rows])
        feat = torch.zeros((N, DIM), dtype=torch.float32, device=dev)
        kcnt = torch.zeros((N,), dtype=torch.float32, device=dev)
        feat[rows], kcnt[rows] = feat_k, kcnt_k
    feat_valid = plan.valid & (kcnt > 0)
    return torch.where(feat_valid[:, None], feat, 0.0), feat_valid


def _check_plan(plan: GridPlan) -> None:
    N = plan.pts.shape[0]
    kernels.check(plan.pts, torch.float32, (N, 4), "pts")
    kernels.check(plan.cell_of, torch.int32, (plan.n_valid,), "cell_of")
    kernels.check(plan.cols, torch.int32, (None, 9, 2), "cols")
    kernels.check(plan.oid, torch.int32, (plan.n_valid,), "oid")
