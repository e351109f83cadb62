// K5 · SPFH and K6 · FPFH combine.
//
// spfh_kernel replaces lidar_global_registration_tpu/ops/pallas/cellgrid.py
// `_spfh_cell` (with `_pair_feature_bins`, `_spfh_query_geom`,
// `_atan2_poly`): for every pair within r it computes the Darboux features
// (alpha via atan2, phi, theta) with PCL's |cos| source/target swap, bins
// each into 11, and scales the 3 x 11 histogram by 100 / count.  On the TPU
// the bins were packed bit-fields reduced on the VPU; here each thread owns
// one sorted query and counts into its own column of a shared-memory
// histogram (33 x 128 ints, no atomics, no bank conflicts: thread t touches
// word b * 128 + t).  Coordinates are centred on the cloud's AABB centre, so
// the arithmetic is the same on every grid (cellgrid.py:1528-1534).  atan2f
// replaces the TPU polynomial (~1e-5 rad), which only moves pairs that lie
// on a bin edge.
//
// combine_kernel replaces `_combine_cell`: own SPFH + (1/d^2-weighted sum of
// the neighbours' SPFH) / neighbour count, each 11-bin block rescaled to sum
// 100.  The 33 sums live in registers.
//
// Both take an optional list of sorted query slots (the `kp` / `kp_rows`
// forms of _fpfh_impl, cellgrid.py:1822-1827, 1848-1862): thread s then
// computes query slots[s] instead of query s.  SPFH writes its row at the
// query's sorted slot (the combine reads rows by slot); the combine writes
// row s of a compacted output, zeros for a padding slot (< 0).  The slots
// come in ascending order (SPFH) or in keypoint order (combine), so the
// threads of a warp still mostly share cells.
//
// Bound on the H100: the stencil walk at the feature radius scans ~3000
// candidates per query; SPFH is bound by the pair-feature arithmetic (a
// sqrt, two divides and an atan2 per pair within r), combine by the 132 B
// SPFH row it reads per neighbour.  Points are sorted by cell, so the
// threads of a warp read the same candidate rows in step (broadcast loads).
#include "cellgrid.cuh"

namespace {

constexpr int kBins = 11;
constexpr int kDim = 33;
constexpr int kThreads = 128;

__device__ __forceinline__ int bin_of(float x) {
  return static_cast<int>(fminf(fmaxf(floorf(x), 0.f), static_cast<float>(kBins - 1)));
}

__global__ void __launch_bounds__(kThreads)
    spfh_kernel(const float4* __restrict__ pts, const float4* __restrict__ nrm,
                const int* __restrict__ cell_of, const int2* __restrict__ cols,
                const int* __restrict__ slots, int m, float r2, float gx, float gy, float gz,
                float* __restrict__ spfh, float* __restrict__ count) {
  __shared__ int hist[kDim * kThreads];
  const int t = threadIdx.x;
  const int s = blockIdx.x * blockDim.x + t;
  if (s >= m) return;  // no block-wide barrier below: each thread owns its column
  const int i = slots ? slots[s] : s;
#pragma unroll
  for (int b = 0; b < kDim; ++b) hist[b * kThreads + t] = 0;
  const float4 q = pts[i];
  const float4 qn = nrm[i];
  const float qdx = q.x - gx, qdy = q.y - gy, qdz = q.z - gz;
  const float qn2 = qn.x * qn.x + qn.y * qn.y + qn.z * qn.z;
  const float pi = static_cast<float>(lgr::kPi);
  const float two_pi = static_cast<float>(2.0 * lgr::kPi);
  int cnt = 0;
  if (qn2 > 0.5f) {
    lgr::walk_stencil(cols, cell_of[i], [&](int j) {
      const float4 c = __ldg(pts + j);
      const float dpx = (c.x - gx) - qdx, dpy = (c.y - gy) - qdy, dpz = (c.z - gz) - qdz;
      const float d2 = dpx * dpx + dpy * dpy + dpz * dpz;
      if (!(d2 <= r2) || !(d2 > 0.f)) return;
      const float4 cn = __ldg(nrm + j);
      const float cn2 = cn.x * cn.x + cn.y * cn.y + cn.z * cn.z;
      if (!(cn2 > 0.5f)) return;
      const float qndp = qn.x * dpx + qn.y * dpy + qn.z * dpz;
      const float cndp = cn.x * dpx + cn.y * dpy + cn.z * dpz;
      const float nsnt = qn.x * cn.x + qn.y * cn.y + qn.z * cn.z;
      const float trip = dpx * (qn.y * cn.z - qn.z * cn.y) + dpy * (qn.z * cn.x - qn.x * cn.z) +
                         dpz * (qn.x * cn.y - qn.y * cn.x);
      const float dsafe = fmaxf(sqrtf(fmaxf(d2, 0.f)), 1e-30f);
      const float a1 = qndp / dsafe, a2 = cndp / dsafe;
      const bool swap = fabsf(a1) < fabsf(a2);
      const float f3 = swap ? a2 : a1;
      const float ns_dp = swap ? cndp : qndp;
      const float ns2 = swap ? cn2 : qn2;
      const float vn = sqrtf(fmaxf(d2 * ns2 - ns_dp * ns_dp, 0.f));
      if (!(vn > 1e-12f)) return;
      const float vsn = fmaxf(vn, 1e-30f);
      const float f2 = trip / vsn;
      const float w_num = swap ? (cndp * nsnt - cn2 * qndp) : (qn2 * cndp - qndp * nsnt);
      const float f1 = atan2f(w_num, nsnt * vsn);
      const int b1 = bin_of(static_cast<float>(kBins) * (f1 + pi) / two_pi);
      const int b2 = bin_of(static_cast<float>(kBins) * (f2 + 1.f) / 2.f);
      const int b3 = bin_of(static_cast<float>(kBins) * (f3 + 1.f) / 2.f);
      hist[b1 * kThreads + t] += 1;
      hist[(kBins + b2) * kThreads + t] += 1;
      hist[(2 * kBins + b3) * kThreads + t] += 1;
      ++cnt;
    });
  }
  const float fc = static_cast<float>(cnt);
  const float incr = cnt > 0 ? 100.f / fmaxf(fc, 1.f) : 0.f;
  float* o = spfh + kDim * static_cast<size_t>(i);
#pragma unroll
  for (int b = 0; b < kDim; ++b) o[b] = static_cast<float>(hist[b * kThreads + t]) * incr;
  count[i] = fc;
}

__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                   const int2* __restrict__ cols, const float* __restrict__ spfh,
                   const int* __restrict__ slots, int m, float r2, float* __restrict__ feat,
                   float* __restrict__ kcnt) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const int i = slots ? slots[s] : s;
  float* o = feat + kDim * static_cast<size_t>(s);
  if (i < 0) {  // padding slot of a compacted output
#pragma unroll
    for (int b = 0; b < kDim; ++b) o[b] = 0.f;
    kcnt[s] = 0.f;
    return;
  }
  const float4 q = pts[i];
  float acc[kDim];
#pragma unroll
  for (int b = 0; b < kDim; ++b) acc[b] = 0.f;
  float k = 0.f;
  lgr::walk_stencil(cols, cell_of[i], [&](int j) {
    const float4 c = __ldg(pts + j);
    const float dx = c.x - q.x, dy = c.y - q.y, dz = c.z - q.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (!(d2 > 0.f) || !(d2 <= r2)) return;
    const float w = 1.f / fmaxf(d2, 1e-30f);
    k += 1.f;
    const float* s = spfh + kDim * static_cast<size_t>(j);
#pragma unroll
    for (int b = 0; b < kDim; ++b) acc[b] += __ldg(s + b) * w;
  });
  const float kk = fmaxf(k, 1.f);
  const float* own = spfh + kDim * static_cast<size_t>(i);
#pragma unroll
  for (int blk = 0; blk < 3; ++blk) {
    float f[kBins];
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      f[b] = own[blk * kBins + b] + acc[blk * kBins + b] / kk;
      s += f[b];
    }
#pragma unroll
    for (int b = 0; b < kBins; ++b)
      o[blk * kBins + b] = s > 0.f ? 100.f * f[b] / fmaxf(s, 1e-30f) : f[b];
  }
  kcnt[s] = k;
}

}  // namespace

// pts, nrm f32[N,4] sorted xyz / normals; cell_of i32[n]; cols
// i32[n_cells,9,2]; slots i32[m] sorted query slots, or null for the m = n
// queries 0..n-1; (gx, gy, gz) the AABB centre; spfh f32[n,33] and count
// f32[n] are written at the queries' slots only.
extern "C" int lgr_spfh(const void* pts, const void* nrm, const void* cell_of, const void* cols,
                        const void* slots, int m, float r2, float gx, float gy, float gz,
                        void* spfh, void* count, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  spfh_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const float4*>(nrm),
      static_cast<const int*>(cell_of), static_cast<const int2*>(cols),
      static_cast<const int*>(slots), m, r2, gx, gy, gz, static_cast<float*>(spfh),
      static_cast<float*>(count));
  return static_cast<int>(cudaGetLastError());
}

// spfh f32[n,33] from lgr_spfh; slots i32[m] sorted query slots (< 0:
// padding), or null for the m = n queries 0..n-1; feat f32[m,33]; kcnt
// f32[m] neighbours at 0 < d2 <= r2.
extern "C" int lgr_combine(const void* pts, const void* cell_of, const void* cols,
                           const void* spfh, const void* slots, int m, float r2, void* feat,
                           void* kcnt, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  combine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const float*>(spfh),
      static_cast<const int*>(slots), m, r2, static_cast<float*>(feat),
      static_cast<float*>(kcnt));
  return static_cast<int>(cudaGetLastError());
}
