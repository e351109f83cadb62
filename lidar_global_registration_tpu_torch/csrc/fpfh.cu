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
// The combine replaces `_combine_cell`: own SPFH + (1/d^2-weighted sum of
// the neighbours' SPFH) / neighbour count, each 11-bin block rescaled to sum
// 100.
//
// Both take an optional list of sorted query slots (the `kp` / `kp_rows`
// forms of _fpfh_impl, cellgrid.py:1822-1827, 1848-1862): SPFH thread s
// then computes query slots[s] instead of query s and writes its row at the
// query's sorted slot (the combine reads rows by slot).  The combine's
// query w is slots[w], written to output row rows[w] of a compacted output
// (zeros for a padding slot < 0); its wrapper sorts the slots, so
// neighbouring queries walk neighbouring cells.
//
// Bound on the H100: the stencil walk at the feature radius scans ~3000
// candidates per query.  SPFH is bound by the pair-feature arithmetic (a
// sqrt, two divides and an atan2 per pair within r); one thread per sorted
// query, so the threads of a warp read the same candidate rows in step
// (broadcast loads).  The combine reads one 16 B position per candidate and
// one 132 B SPFH row per neighbour; its bound (a distance test per
// candidate, 67 flops per neighbour, each input byte read once) is ~0.03 ms
// at the 10M pair's keypoint rows and ~0.08 ms for the full pass at 65,536
// points, and what holds it is the latency of those dependent reads.  It has
// two forms, the same bits from each:
//   - combine_thread_kernel, one thread per query, for the full pass: the
//     sorted queries of a warp share their cells, so a candidate's position
//     and a neighbour's SPFH row are one broadcast read for up to 32 queries.
//   - combine_warp_kernel, one warp per query, for a slot list (`kp_rows`:
//     scattered keypoints, whose threads would share nothing): 32
//     candidates are tested per coalesced read, a neighbour's row is one
//     coalesced read, and up to 4 rows are in flight.
// Each dimension's sum runs over the neighbours in walk order with the same
// `acc += s * w` in both, and the finish is the same arithmetic, so the
// warp form's output and count are bit-identical to the thread form's.
#include "cellgrid.cuh"

namespace {

constexpr int kBins = 11;
constexpr int kDim = 33;
constexpr int kThreads = 128;
constexpr int kCombineWarps = 8;  // output rows per combine block

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

// One thread per output row: the 33 sums live in registers.  The threads
// of a warp walk the same cells in step, so a candidate's position and a
// neighbour's SPFH row are one broadcast read for up to 32 queries.
__global__ void __launch_bounds__(kThreads)
    combine_thread_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                          const int2* __restrict__ cols, const float* __restrict__ spfh,
                          const int* __restrict__ slots, const int* __restrict__ rows, int m,
                          float r2, float* __restrict__ feat, float* __restrict__ kcnt) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= m) return;
  const int i = slots ? slots[w] : w;
  const int s = rows ? rows[w] : w;
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

// One warp per output row; lane b owns dimension b, lane 0 also dimension
// 32.  The lanes test 32 consecutive candidates of a stencil column at once,
// ballot the neighbours (0 < d2 <= r2), and the warp then adds the
// neighbours' SPFH rows in walk order.
__global__ void __launch_bounds__(kCombineWarps * 32)
    combine_warp_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                        const int2* __restrict__ cols, const float* __restrict__ spfh,
                        const int* __restrict__ slots, const int* __restrict__ rows, int m,
                        float r2, float* __restrict__ feat, float* __restrict__ kcnt) {
  __shared__ float fin[kCombineWarps][kDim];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int w = blockIdx.x * kCombineWarps + wid;
  if (w >= m) return;  // warp-uniform; no block-wide barrier below
  const int i = slots ? slots[w] : w;
  const int s = rows ? rows[w] : w;
  float* o = feat + kDim * static_cast<size_t>(s);
  if (i < 0) {  // padding slot of a compacted output
    o[lane] = 0.f;
    if (lane == 0) {
      o[32] = 0.f;
      kcnt[s] = 0.f;
    }
    return;
  }
  const float4 q = pts[i];
  float acc = 0.f, acc32 = 0.f;
  int k = 0;
  const int2* crow = cols + 9 * static_cast<size_t>(cell_of[i]);
#pragma unroll 1
  for (int c = 0; c < 9; ++c) {
    const int2 r = __ldg(crow + c);
    for (int base = r.x; base < r.y; base += 32) {
      const int j = base + lane;
      bool nb = false;
      float wt = 0.f;
      if (j < r.y) {
        const float4 p = __ldg(pts + j);
        const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        nb = (d2 > 0.f) && (d2 <= r2);
        wt = 1.f / fmaxf(d2, 1e-30f);
      }
      unsigned mask = __ballot_sync(0xffffffffu, nb);
      k += __popc(mask);
      while (mask) {
        int src[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // the next 4 neighbours in walk order (-1: none)
          src[u] = __ffs(mask) - 1;
          mask &= mask - 1;
        }
        float v[4], v32[4], wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int su = src[u] < 0 ? src[0] : src[u];
          wv[u] = __shfl_sync(0xffffffffu, wt, su);
          const float* row = spfh + kDim * static_cast<size_t>(base + su);
          v[u] = __ldg(row + lane);
          v32[u] = lane == 0 ? __ldg(row + 32) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (src[u] >= 0) {
            acc += v[u] * wv[u];
            if (lane == 0) acc32 += v32[u] * wv[u];
          }
        }
      }
    }
  }
  // own SPFH + the weighted mean, each 11-bin block rescaled to sum 100
  const float kf = static_cast<float>(k);
  const float kk = fmaxf(kf, 1.f);
  const float* own = spfh + kDim * static_cast<size_t>(i);
  float* f = fin[wid];
  f[lane] = own[lane] + acc / kk;
  if (lane == 0) f[32] = own[32] + acc32 / kk;
  __syncwarp();
  // lane b sums its 11-bin block in bin order; lane 31 (block 2) also
  // finishes dimension 32
  const int blk = lane / kBins;
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < kBins; ++e) sum += f[blk * kBins + e];
  o[lane] = sum > 0.f ? 100.f * f[lane] / fmaxf(sum, 1e-30f) : f[lane];
  if (lane == 31) o[32] = sum > 0.f ? 100.f * f[32] / fmaxf(sum, 1e-30f) : f[32];
  if (lane == 0) kcnt[s] = kf;
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
// padding), or null for the m = n queries 0..n-1; rows i32[m] the output
// row of each slot (a permutation of 0..m-1), or null for row w = slot w;
// feat f32[m,33]; kcnt f32[m] neighbours at 0 < d2 <= r2.  per_thread
// picks combine_thread_kernel, else combine_warp_kernel (the same bits).
extern "C" int lgr_combine(const void* pts, const void* cell_of, const void* cols,
                           const void* spfh, const void* slots, const void* rows, int m,
                           float r2, int per_thread, void* feat, void* kcnt, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* p = static_cast<const float4*>(pts);
  const int* co = static_cast<const int*>(cell_of);
  const int2* cl = static_cast<const int2*>(cols);
  const float* sp = static_cast<const float*>(spfh);
  const int* sl = static_cast<const int*>(slots);
  const int* rw = static_cast<const int*>(rows);
  if (per_thread) {
    combine_thread_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        p, co, cl, sp, sl, rw, m, r2, static_cast<float*>(feat), static_cast<float*>(kcnt));
  } else {
    combine_warp_kernel<<<(m + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32, 0, st>>>(
        p, co, cl, sp, sl, rw, m, r2, static_cast<float*>(feat), static_cast<float*>(kcnt));
  }
  return static_cast<int>(cudaGetLastError());
}
