// K1 · surface pass: PCA normal, curvature, eigenvalues, neighbour count and
// nearest neighbour of every point.
//
// Replaces lidar_global_registration_tpu/ops/pallas/cellgrid.py
// `_surface_cell` (:1241, with `_block_geometry` and `_smallest_eig3`), which
// on the TPU contracts block-centred candidate moments against a pair mask
// on the MXU.  Here one thread owns one sorted query and walks its 9 stencil
// columns, accumulating the moments [1, d, d (x) d] of the neighbours within
// r (self included) in registers, centred on the query itself: the self
// pair's difference is then exactly 0, so the d2 > 0 self-exclusion of the
// nearest-neighbour search holds (cellgrid.py:1278-1282).
//
// Bound on the H100: the walk, not arithmetic (a test per candidate, 10
// adds / multiplies per neighbour, one eigen solve per query; ~30
// neighbours inside r out of the ~3-9x that the stencil scans).  Points are
// sorted by cell, so the 32 threads of a warp mostly scan the same columns
// in step and their loads of one candidate coalesce into one L1
// transaction.  The walk keeps kSurfaceAhead candidate rows in flight
// (lgr::walk_stencil_ahead; 4 measured faster than 2 and 8) and visits them
// in the plain walk's order, so the moment sums keep their bits; the
// nearest neighbour is tracked by slot and its input id read only at a
// distance tie and once at the end, which leaves the walk no dependent
// load (the nearest neighbour is the lexicographic minimum of (d2, input
// id), whatever the order).  With the eigen finish the kernel
// takes 48 registers, 10 blocks of 128 an SM, so it needs no register cap.
//
// An optional list of sorted query slots gives the need-masked form
// (`surface_pass(need=)`, cellgrid.py:1734-1747, where the TPU retabs its
// blocks with a 1-cell flag stencil): thread s then computes query slots[s]
// and writes its row at that slot, so a masked pass computes only the
// cells around needed points.  The slots come in ascending order, so the
// threads of a warp still mostly share cells.
#include "cellgrid.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSurfaceAhead = 4;  // candidate rows in flight on the walk

__global__ void __launch_bounds__(kThreads)
    surface_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                   const int2* __restrict__ cols, const int* __restrict__ oid,
                   const int* __restrict__ slots, int m, float r2, float* __restrict__ out,
                   float* __restrict__ nn_d, int* __restrict__ nn_id) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const int i = slots ? slots[s] : s;
  const float4 q = pts[i];
  float s0 = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  float sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;
  float dmin = lgr::kBig;
  int bj = -1;  // sorted slot of the nearest neighbour so far
  int bo = -1;  // its input id once a tie has read it, else -1
  lgr::walk_stencil_ahead<kSurfaceAhead>(
      pts, cols, cell_of[i], [&](int j0, const float4 (&c)[kSurfaceAhead], int n) {
#pragma unroll
        for (int u = 0; u < kSurfaceAhead; ++u) {
          if (u >= n) break;
          const float dx = c[u].x - q.x, dy = c[u].y - q.y, dz = c[u].z - q.z;
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (!(d2 <= r2)) continue;
          s0 += 1.f;
          sx += dx;
          sy += dy;
          sz += dz;
          sxx += dx * dx;
          sxy += dx * dy;
          sxz += dx * dz;
          syy += dy * dy;
          syz += dy * dz;
          szz += dz * dz;
          if (d2 > 0.f) {
            if (d2 < dmin) {
              dmin = d2;
              bj = j0 + u;
              bo = -1;
            } else if (d2 == dmin) {  // a tie goes to the lower input id
              if (bo < 0) bo = __ldg(oid + bj);
              const int o = __ldg(oid + j0 + u);
              if (o < bo) {
                bj = j0 + u;
                bo = o;
              }
            }
          }
        }
      },
      [] {});
  const float cnt = fmaxf(s0, 1.f);
  const float mx = sx / cnt, my = sy / cnt, mz = sz / cnt;
  float l0, l1, l2, vx, vy, vz;
  lgr::smallest_eig3(sxx / cnt - mx * mx, sxy / cnt - mx * my, sxz / cnt - mx * mz,
                     syy / cnt - my * my, syz / cnt - my * mz, szz / cnt - mz * mz, l0, l1,
                     l2, vx, vy, vz);
  const float tot = fmaxf(l0 + l1 + l2, 1e-30f);
  float* o = out + 8 * static_cast<size_t>(i);
  o[0] = vx;
  o[1] = vy;
  o[2] = vz;
  o[3] = fmaxf(l0, 0.f) / tot;
  o[4] = l0;
  o[5] = l1;
  o[6] = l2;
  o[7] = s0;
  const bool has = dmin < lgr::kBig;
  nn_d[i] = has ? sqrtf(dmin) : 0.f;
  nn_id[i] = has ? (bo >= 0 ? bo : __ldg(oid + bj)) : -1;
}

}  // namespace

// pts f32[N,4] sorted xyz; cell_of i32[n]; cols i32[n_cells,9,2]; oid i32[n]
// input id per sorted point; slots i32[m] sorted query slots, or null for
// the m = n queries 0..n-1; out f32[n,8] (normal xyz, curvature, l0, l1,
// l2, count), nn_d f32[n] and nn_id i32[n] (-1: no neighbour at d2 > 0) are
// written at the queries' slots only.
extern "C" int lgr_surface(const void* pts, const void* cell_of, const void* cols,
                           const void* oid, const void* slots, int m, float r2, void* out,
                           void* nn_d, void* nn_id, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  surface_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const int*>(oid),
      static_cast<const int*>(slots), m, r2, static_cast<float*>(out),
      static_cast<float*>(nn_d), static_cast<int*>(nn_id));
  return static_cast<int>(cudaGetLastError());
}
