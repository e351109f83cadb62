// Device code shared by the cell-list kernels (surface.cu, iss.cu, fpfh.cu): the
// 9-column CSR stencil walk and the Smith closed-form smallest eigenpair.
//
// The plan (ops/cellgrid.py plan_grid) sorts the points by an int64
// lexicographic cell key with z fastest, cell = search radius.  For every
// occupied cell, cols[9 * cell + c] holds the [start, end) range of sorted
// points in stencil column c (fixed dx, dy in {-1, 0, 1}, z from cell z - 1
// to z + 1): one contiguous range each, so a query's 27-cell neighbourhood
// is 9 linear scans.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace lgr {

constexpr float kBig = 3.0e38f;
constexpr double kPi = 3.14159265358979323846;

// Visit every sorted point of the 27-cell stencil of `cell`, column by
// column (the radius test is the visitor's).  The candidate loop is plain,
// so the compiler unrolls it and batches its loads.  K2 and K6's full pass
// walk this way: for K2, walk_near (below) with every column measured 0.3 %
// slower on the H100; K6's full pass has not been measured on it.
template <class Visit>
__device__ __forceinline__ void walk_stencil(const int2* __restrict__ cols, int cell,
                                             Visit&& visit) {
  const int2* row = cols + 9 * static_cast<size_t>(cell);
#pragma unroll 1
  for (int c = 0; c < 9; ++c) {
    const int2 r = __ldg(row + c);
    for (int j = r.x; j < r.y; ++j) visit(j);
  }
}

// The same walk with U candidate rows in flight: each column goes in groups
// of U, whose float4 rows are all loaded before the visitor sees the first
// of them.  visit(j0, c, n) gets candidates j0 .. j0 + n - 1 (n <= U; a
// column's last group holds its tail) with c[u] the row of j0 + u, and must
// visit them in u order: the visit order is walk_stencil's, so sums taken
// in it keep their bits.  A full group is visited with the literal U, so
// the visitor's `u < n` guards fold away there.  after() runs after every
// group.  The next column's range is read before the current one is walked.
template <int U, class VisitGroup, class AfterGroup>
__device__ __forceinline__ void walk_stencil_ahead(const float4* __restrict__ pts,
                                                   const int2* __restrict__ cols, int cell,
                                                   VisitGroup&& visit, AfterGroup&& after) {
  const int2* row = cols + 9 * static_cast<size_t>(cell);
  int2 next = __ldg(row);
#pragma unroll 1
  for (int c = 0; c < 9; ++c) {
    const int2 r = next;
    if (c < 8) next = __ldg(row + c + 1);
#pragma unroll 1
    for (int j0 = r.x; j0 < r.y; j0 += U) {
      float4 p[U];
      if (r.y - j0 >= U) {
#pragma unroll
        for (int u = 0; u < U; ++u) p[u] = __ldg(pts + j0 + u);
        visit(j0, p, U);
      } else {
        const int n = r.y - j0;
#pragma unroll
        for (int u = 0; u < U; ++u) p[u] = __ldg(pts + j0 + min(u, n - 1));
        visit(j0, p, n);
      }
      after();
    }
  }
}

// ---------------------------------------------------------------------------
// A walk that knows the radius (K4): stencil columns that provably hold no
// point within r of the query are left out.
//
// Which columns may go.  The plan put a float32 row x in cell
// floor(u_plan), u_plan = (x64 - origin) / cell evaluated in float64
// (ops/cellgrid.py plan_grid; PyTorch may multiply by 1 / cell instead).
// face_gaps evaluates u the same way from the same float32 row: both values
// are within 4 ulp64 of the exact quotient, so they differ by less than
// 1e-15 |u|, under 1e-7 cells while |u| < 1e8 (checked per query, else
// nothing is skipped on that axis).  With f = u - floor(u):
//   - f within kFaceGuard (1e-6) of 0 or 1: the query's own cell is in
//     doubt, both gaps of that axis are 0 (nothing skipped on that axis);
//   - else the kernel's cell is the plan's, and every point p the plan put
//     in the next lower / higher cell layer has u_plan(p) <= c resp.
//     >= c + 1, so |p - q| along that axis is at least cell * (f - 1e-6)
//     resp. cell * (1 - f - 1e-6): the guard swallows the 1e-7 of both
//     quotients and the float32 roundings of f and 1 - f (6e-8 each).
// A column (dx, dy) is left out when gap_x^2 + gap_y^2 > lim, lim = r2 (1 +
// kNearMargin) / cell^2 with kNearMargin = 1e-5: then the exact squared
// distance of every point in it exceeds r2 (1 + 1e-5).  The kernels' d2 is
// float32 from p - q (one rounding a difference, one a square, two for the
// sums: under 5e-7 relatively; a square that underflows loses under 1e-37,
// nothing beside r2 >= 1e-30, below which near_grid skips nothing), and
// the float32 test itself rounds by under 1e-6 of lim: d2 > r2 for every
// such point, so it is no hit for any visitor that tests d2 <= r2, and a
// column left out changes no sum, count or order.  The rows must be the
// float32 values the plan binned (plan_grid takes them from one tensor).
constexpr float kFaceGuard = 1e-6f;
constexpr double kNearMargin = 1e-5;
constexpr unsigned kEveryColumn = 0x1ffu;  // a `todo` that leaves nothing out

struct NearGrid {
  const double* origin;  // device f64[3], the plan's grid corner
  double inv_cell;
  float lim;  // squared gap, in cells, above which a column is left out
};

// Host side: the grid of a plan (GridPlan.origin, GridPlan.cell) and the
// search radius, as the kernels take them.
inline NearGrid near_grid(const void* origin, double cell, float r2) {
  NearGrid g;
  g.origin = static_cast<const double*>(origin);
  g.inv_cell = 1.0 / cell;
  g.lim = r2 >= 1e-30f
              ? static_cast<float>(r2 * (1.0 + kNearMargin) * g.inv_cell * g.inv_cell)
              : INFINITY;
  return g;
}

// Lower bounds, in cells, of the distance along one axis from coordinate q
// to the cell layers below (lo) and above (hi) the query's own.
__device__ __forceinline__ void face_gaps(float q, double origin, double inv_cell, float& lo,
                                          float& hi) {
  const double u = (static_cast<double>(q) - origin) * inv_cell;
  const float f = static_cast<float>(u - floor(u));
  const bool safe = fabs(u) < 1e8 && f > kFaceGuard && f < 1.f - kFaceGuard;
  lo = safe ? f - kFaceGuard : 0.f;
  hi = safe ? (1.f - f) - kFaceGuard : 0.f;
}

// Bit c = 3 (dx + 1) + (dy + 1) set: stencil column c may hold a point
// within r of q and is walked (ops/cellgrid.py near_columns is the plain
// mirror of this rule).
__device__ __forceinline__ unsigned near_columns(const float4 q, const NearGrid g) {
  float gx[3], gy[3];
  gx[1] = gy[1] = 0.f;
  face_gaps(q.x, __ldg(g.origin), g.inv_cell, gx[0], gx[2]);
  face_gaps(q.y, __ldg(g.origin + 1), g.inv_cell, gy[0], gy[2]);
  unsigned keep = 0;
#pragma unroll
  for (int c = 0; c < 9; ++c)
    if (gx[c / 3] * gx[c / 3] + gy[c % 3] * gy[c % 3] <= g.lim) keep |= 1u << c;
  return keep;
}

// The order in which a walk takes the stencil columns: ascending, as
// walk_stencil, or with kCentreFirst the query's own column, then the four
// that share a face with it, then the corners: nearer columns hold more of
// the neighbours, which suits a visitor that may stop early and needs no
// order.
template <bool kCentreFirst>
struct NearOrder {
  static constexpr unsigned long long kCols = kCentreFirst ? 0x862075314ull : 0x876543210ull;
  // the stencil column that is k-th in the order
  __device__ __forceinline__ static int column(int k) {
    return static_cast<int>(kCols >> (4 * k)) & 15;
  }
  // near_columns' mask in the order: bit k set when the k-th column is kept
  __device__ __forceinline__ static unsigned todo(unsigned keep) {
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) m |= (keep >> column(k) & 1u) << k;
    return m;
  }
};

// walk_stencil over the kept columns only: a lane takes its own next kept
// column per step (`todo`, from NearOrder::todo or kEveryColumn, loses a bit
// a step).  visit(j0, j1) gets the column's range of sorted slots and takes
// them in ascending order: with the ascending NearOrder a lane's visit order
// is walk_stencil's without the columns left out, so sums taken in it keep
// their bits.  after(more) runs after every step, `more` telling whether
// this lane has columns left, and ends the lane's walk by returning false:
// `return more` walks every kept column; a warp vote there must return the
// same on all lanes.  The candidate loop is the visitor's own plain loop:
// the compiler unrolls it and batches its loads.  Lanes whose masks differ
// fall out of step, and a warp whose lanes read different columns in one
// step loses the coalescing of its loads: worth it for a visitor that ends
// early (K4), not for one that takes every hit (K3 walks every column).
template <bool kCentreFirst = false, class VisitRange, class After>
__device__ __forceinline__ void walk_near(const int2* __restrict__ cols, int cell,
                                          unsigned& todo, VisitRange&& visit, After&& after) {
  const int2* row = cols + 9 * static_cast<size_t>(cell);
  for (;;) {
    if (todo) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1;
      const int2 r = __ldg(row + NearOrder<kCentreFirst>::column(k));
      visit(r.x, r.y);
    }
    if (!after(todo != 0)) break;
  }
}

// The reference's polynomial atan2 (cellgrid._atan2_poly, Abramowitz-Stegun
// 4.4.49, ~1e-5 rad), operation for operation as ops/cellgrid.atan2_poly.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float z = fminf(ax, ay) / fmaxf(fmaxf(ax, ay), 1e-30f);
  const float s = z * z;
  const float p =
      z * (0.99986614f +
           s * (-0.33029951f + s * (0.18014100f + s * (-0.08513300f + s * 0.02083510f))));
  float r = ay > ax ? static_cast<float>(kPi / 2) - p : p;
  r = x < 0.f ? static_cast<float>(kPi) - r : r;
  return y < 0.f ? -r : r;
}

// Smallest (l0 <= l1 <= l2, unit eigenvector of l0) of a symmetric 3x3
// matrix: the Smith closed form of cellgrid._smallest_eig3 / ops/eigen3.py,
// with the reference's polynomial acos (l0 of a flat patch is a small
// difference of O(trace) terms, so the acos rounding shows in the
// curvature); the vector is the largest cross product of two rows of
// (A - l0 I), +z when all are degenerate.
__device__ __forceinline__ void smallest_eig3(float a00, float a01, float a02, float a11,
                                              float a12, float a22, float& l0, float& l1,
                                              float& l2, float& vx, float& vy, float& vz) {
  const float eps = 1e-20f;
  const float scale =
      fmaxf(fmaxf(fmaxf(fmaxf(fmaxf(fabsf(a00), fabsf(a11)), fabsf(a22)), fabsf(a01)),
                  fmaxf(fabsf(a02), fabsf(a12))),
            eps);
  const float b00 = a00 / scale, b11 = a11 / scale, b22 = a22 / scale;
  const float b01 = a01 / scale, b02 = a02 / scale, b12 = a12 / scale;
  const float q = (b00 + b11 + b22) / 3.0f;
  const float p1 = b01 * b01 + b02 * b02 + b12 * b12;
  const float c00 = b00 - q, c11 = b11 - q, c22 = b22 - q;
  const float p2 = c00 * c00 + c11 * c11 + c22 * c22 + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 0.0f));
  const float sp = fmaxf(p, eps);
  const float d00 = c00 / sp, d11 = c11 / sp, d22 = c22 / sp;
  const float d01 = b01 / sp, d02 = b02 / sp, d12 = b12 / sp;
  const float det = d00 * (d11 * d22 - d12 * d12) - d01 * (d01 * d22 - d12 * d02) +
                    d02 * (d01 * d12 - d11 * d02);
  const float r = fminf(fmaxf(det / 2.0f, -1.0f), 1.0f);
  const float phi = atan2_poly(sqrtf(fmaxf(1.0f - r * r, 0.0f)), r) / 3.0f;
  float e_hi = q + 2.0f * p * cosf(phi);
  float e_lo = q + 2.0f * p * cosf(phi + static_cast<float>(2.0 * kPi / 3.0));
  float e_mid = 3.0f * q - e_hi - e_lo;
  if (p <= eps) e_hi = e_mid = e_lo = q;
  const float m00 = b00 - e_lo, m11 = b11 - e_lo, m22 = b22 - e_lo;
  // cross products of the row pairs (0,1), (0,2), (1,2) of B - e_lo I
  const float c01x = b01 * b12 - b02 * m11, c01y = b02 * b01 - m00 * b12,
              c01z = m00 * m11 - b01 * b01;
  const float c02x = b01 * m22 - b02 * b12, c02y = b02 * b02 - m00 * m22,
              c02z = m00 * b12 - b01 * b02;
  const float c12x = m11 * m22 - b12 * b12, c12y = b12 * b02 - b01 * m22,
              c12z = b01 * b12 - m11 * b02;
  const float n01 = c01x * c01x + c01y * c01y + c01z * c01z;
  const float n02 = c02x * c02x + c02y * c02y + c02z * c02z;
  const float n12 = c12x * c12x + c12y * c12y + c12z * c12z;
  const bool best12 = n12 > fmaxf(n01, n02);
  const bool best02 = !best12 && (n02 > n01);
  float x = best12 ? c12x : (best02 ? c02x : c01x);
  float y = best12 ? c12y : (best02 ? c02y : c01y);
  float z = best12 ? c12z : (best02 ? c02z : c01z);
  if (fmaxf(fmaxf(n01, n02), n12) <= eps * 10.0f) {
    x = 0.0f;
    y = 0.0f;
    z = 1.0f;
  }
  const float vn = sqrtf(fmaxf(x * x + y * y + z * z, eps));
  l0 = e_lo * scale;
  l1 = e_mid * scale;
  l2 = e_hi * scale;
  vx = x / vn;
  vy = y / vn;
  vz = z / vn;
}

}  // namespace lgr
