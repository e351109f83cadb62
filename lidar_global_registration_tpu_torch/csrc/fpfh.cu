// K5 · SPFH and K6 · FPFH combine.
//
// spfh_kernel replaces lidar_global_registration_tpu/ops/pallas/cellgrid.py
// `_spfh_cell` (:1554, with `_pair_feature_bins` :1452, `_spfh_query_geom`,
// `_atan2_poly`): for every pair within r it computes the Darboux features
// (alpha via atan2, phi, theta) with PCL's |cos| source/target swap, bins
// each into 11, and scales the 3 x 11 histogram by 100 / count.  On the TPU
// the bins were packed bit-fields reduced on the VPU.  Coordinates are
// centred on the cloud's AABB centre, so the arithmetic is the same on every
// grid (cellgrid.py:1528-1534); the wrapper centres the rows once, one
// float32 subtraction per coordinate.  atan2f replaces the TPU polynomial
// (~1e-5 rad), which only moves pairs that lie on a bin edge.
//
// Bound on the H100: the pair-feature arithmetic.  At the feature radius a
// query's stencil holds 1,000-3,000 candidates, 12-35 % of them within r,
// and each pair within r costs two square roots, up to four IEEE divisions,
// an atan2f and three bins (a few hundred instructions under -fmad=false)
// against ~10 for the distance test.  Run inline by one thread per query,
// that body stalls the whole warp whenever any lane hits.  So:
//   - one warp owns a work item of up to 32 consecutive sorted queries of
//     ONE cell (the wrapper's list): its lanes walk the same 9 ranges in
//     step (every candidate load is one broadcast, U of them in flight) and
//     each lane tests the candidate against its own query;
//   - the hits are ballotted into a per-warp queue of (candidate, query
//     lane) pairs; after each group, every lane takes one of each 32 queued
//     and runs the pair body, so the expensive part runs on full warps;
//   - each pair adds 1 to three bins of its query's row of a per-warp
//     shared histogram (shared atomics, which measured free beside the
//     pair body; aggregating them with __match_any_sync lost 60 %); the
//     finish scales the rows and writes them with coalesced stores.
// The wrapper's list cuts every cell into items of up to 32 queries
// without a host read (ops/cellgrid.spfh_items).  A block holds 4 warps
// and 25.6 KB of shared memory.  A pair's bins depend only on its float
// expressions (pair_bins), and integer counts do not depend on the order
// they are added in, so the output bits do not depend on how the pairs are
// spread over lanes.
//
// The combine replaces `_combine_cell`: own SPFH + (1/d^2-weighted sum of
// the neighbours' SPFH) / neighbour count, each 11-bin block rescaled to sum
// 100.
//
// Both take an optional list of sorted query slots (the `kp` / `kp_rows`
// forms of _fpfh_impl, cellgrid.py:1822-1827, 1848-1862): SPFH then
// computes the queries slots[s] instead of s and writes their rows at their
// sorted slots (the combine reads rows by slot).  The combine's
// query w is slots[w], written to output row rows[w] of a compacted output
// (zeros for a padding slot < 0); its wrapper sorts the slots, so
// neighbouring queries walk neighbouring cells.
//
// The combine reads one 16 B position per candidate and
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
constexpr int kSpfhWarps = 4;     // work items per SPFH block
constexpr int kSpfhAhead = 8;     // candidate rows in flight on the SPFH walk
// A group of kSpfhAhead candidates queues at most 32 hits each on top of
// fewer than 32 left over, and the queue is drained after every group.
constexpr int kQueue = 32 * (kSpfhAhead + 1);
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int bin_of(float x) {
  return static_cast<int>(fminf(fmaxf(floorf(x), 0.f), static_cast<float>(kBins - 1)));
}

// The bins of one pair within r (0 < d2 <= r2): query normal qn with qn2 =
// |qn|^2 > 0.5, candidate normal cn, offset (dpx, dpy, dpz) from the query
// to the candidate with d2 its squared length.  False where the candidate
// has no normal (cn2 <= 0.5) or the pair is degenerate (vn <= 1e-12).
__device__ __forceinline__ bool pair_bins(float dpx, float dpy, float dpz, float d2, float4 qn,
                                          float qn2, float4 cn, int& b1, int& b2, int& b3) {
  const float pi = static_cast<float>(lgr::kPi);
  const float two_pi = static_cast<float>(2.0 * lgr::kPi);
  const float cn2 = cn.x * cn.x + cn.y * cn.y + cn.z * cn.z;
  if (!(cn2 > 0.5f)) return false;
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
  if (!(vn > 1e-12f)) return false;
  const float vsn = fmaxf(vn, 1e-30f);
  const float f2 = trip / vsn;
  const float w_num = swap ? (cndp * nsnt - cn2 * qndp) : (qn2 * cndp - qndp * nsnt);
  const float f1 = atan2f(w_num, nsnt * vsn);
  b1 = bin_of(static_cast<float>(kBins) * (f1 + pi) / two_pi);
  b2 = bin_of(static_cast<float>(kBins) * (f2 + 1.f) / 2.f);
  b3 = bin_of(static_cast<float>(kBins) * (f3 + 1.f) / 2.f);
  return true;
}

// One warp's shared state: its queries' histograms (row = query lane, 33
// bins; the odd stride puts a warp's 32 consecutive words on 32 banks), the
// queue of pairs, each packed as candidate slot << 5 | query lane, and each
// lane's query (centred xyz, qn2; normal) for the lanes that run its pairs.
struct SpfhWarp {
  int hist[32 * kDim];
  int queue[kQueue];
  float4 qc[32];
  float4 qv[32];
};

// items[w] = (first position, length <= 32) of work item w: the positions
// p .. p + length - 1 of the query list (slots[p], or p itself without
// slots), all in one cell; length 0 pads the list.  ctr holds the sorted
// rows centred on the AABB centre (xyz - centre, w = 0).
__global__ void __launch_bounds__(kSpfhWarps * 32)
    spfh_kernel(const float4* __restrict__ ctr, const float4* __restrict__ nrm,
                const int* __restrict__ cell_of, const int2* __restrict__ cols,
                const int* __restrict__ slots, const int2* __restrict__ items, int n_items,
                float r2, float* __restrict__ spfh, float* __restrict__ count) {
  __shared__ SpfhWarp warps[kSpfhWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int w = blockIdx.x * kSpfhWarps + wid;
  if (w >= n_items) return;  // warp-uniform; no block-wide barrier below
  const int2 item = __ldg(items + w);
  if (item.y == 0) return;
  SpfhWarp& sw = warps[wid];
  const bool mine = lane < item.y;
  const int pos = item.x + (mine ? lane : 0);  // a spare lane shadows the first query
  const int i = slots ? __ldg(slots + pos) : pos;
  for (int k = lane; k < 32 * kDim; k += 32) sw.hist[k] = 0;
  const float4 q = ctr[i];
  const float4 qn = nrm[i];
  const float qn2 = qn.x * qn.x + qn.y * qn.y + qn.z * qn.z;
  // a lane whose query has no normal (or no query) takes no pair: d2 <= -1
  // holds for no d2
  const float r2q = mine && qn2 > 0.5f ? r2 : -1.f;
  const unsigned below = (1u << lane) - 1u;
  sw.qc[lane] = make_float4(q.x, q.y, q.z, qn2);
  sw.qv[lane] = qn;
  int size = 0;  // queued pairs, warp-uniform
  __syncwarp();

  // The pair of queue entry e, if this lane has one: its bins, counted in
  // the query's row.
  auto pair = [&](bool has, int e) {
    if (has) {
      const int j = e >> 5, o = e & 31;
      const float4 oc = sw.qc[o];
      const float4 on = sw.qv[o];
      const float ox = oc.x, oy = oc.y, oz = oc.z, on2 = oc.w;
      const float4 c = __ldg(ctr + j);
      const float4 cn = __ldg(nrm + j);
      const float dpx = c.x - ox, dpy = c.y - oy, dpz = c.z - oz;
      const float d2 = dpx * dpx + dpy * dpy + dpz * dpz;
      int b1, b2, b3;
      if (pair_bins(dpx, dpy, dpz, d2, on, on2, cn, b1, b2, b3)) {
        int* h = sw.hist + o * kDim;
        atomicAdd(h + b1, 1);
        atomicAdd(h + kBins + b2, 1);
        atomicAdd(h + 2 * kBins + b3, 1);
      }
    }
  };

  lgr::walk_stencil_ahead<kSpfhAhead>(
      ctr, cols, cell_of[i],
      [&](int j0, const float4 (&c)[kSpfhAhead], int n) {  // test, queue the hits
#pragma unroll
        for (int u = 0; u < kSpfhAhead; ++u) {
          if (u < n) {  // n is warp-uniform
            const float dpx = c[u].x - q.x, dpy = c[u].y - q.y, dpz = c[u].z - q.z;
            const float d2 = dpx * dpx + dpy * dpy + dpz * dpz;
            const bool hit = d2 <= r2q && d2 > 0.f;
            const unsigned m = __ballot_sync(kAll, hit);
            if (hit) sw.queue[size + __popc(m & below)] = (j0 + u) << 5 | lane;
            size += __popc(m);
          }
        }
      },
      [&] {  // run the queued pairs 32 at a time, keep the rest (< 32) in front
        if (size < 32) return;
        __syncwarp();
        int k = 0;
        do {
          pair(true, sw.queue[k + lane]);
          k += 32;
        } while (k + 32 <= size);
        const int rest = size - k;
        const int e = lane < rest ? sw.queue[k + lane] : 0;
        __syncwarp();
        if (lane < rest) sw.queue[lane] = e;
        size = rest;
      });
  __syncwarp();
  pair(lane < size, lane < size ? sw.queue[lane] : 0);
  __syncwarp();

  // Each lane scales its query's row: count = the pairs binned (each adds 1
  // to one bin of every block).  Then the warp writes the item's rows, 32
  // consecutive words of them a store.
  int cnt = 0;
#pragma unroll
  for (int b = 0; b < kBins; ++b) cnt += sw.hist[lane * kDim + b];
  const float fc = static_cast<float>(cnt);
  const float incr = cnt > 0 ? 100.f / fmaxf(fc, 1.f) : 0.f;
  if (mine) count[i] = fc;
  for (int k0 = 0; k0 < item.y * kDim; k0 += 32) {
    const int k = k0 + lane;
    const int r = min(k / kDim, 31);
    const int ir = __shfl_sync(kAll, i, r);
    const float sr = __shfl_sync(kAll, incr, r);
    if (k < item.y * kDim)
      spfh[kDim * static_cast<size_t>(ir) + (k - r * kDim)] = static_cast<float>(sw.hist[k]) * sr;
  }
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

// ctr f32[N,4] sorted xyz - AABB centre (w = 0), nrm f32[N,4] sorted
// normals, N < 2^26; cell_of i32[n]; cols i32[n_cells,9,2]; slots i32[m]
// ascending query slots, or null for the m = n queries 0..n-1; items
// i32[n_items,2] the work items over positions 0..m-1
// (ops/cellgrid.spfh_items); spfh f32[n,33] and count f32[n] are written at
// the queries' slots only.
extern "C" int lgr_spfh(const void* ctr, const void* nrm, const void* cell_of, const void* cols,
                        const void* slots, const void* items, int n_items, float r2, void* spfh,
                        void* count, void* stream) {
  const int blocks = (n_items + kSpfhWarps - 1) / kSpfhWarps;
  spfh_kernel<<<blocks, kSpfhWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ctr), static_cast<const float4*>(nrm),
      static_cast<const int*>(cell_of), static_cast<const int2*>(cols),
      static_cast<const int*>(slots), static_cast<const int2*>(items), n_items, r2,
      static_cast<float*>(spfh), static_cast<float*>(count));
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
