// K2-K4 · ISS keypoints: radius count, weighted scatter saliency, NMS.
//
// Replace lidar_global_registration_tpu/ops/pallas/cellgrid.py
// `_iss_count_cell`, `_iss_saliency_cell` and `_iss_nms_cell`.  On the TPU
// each is a block of 128 query lanes contracting block-centred candidate
// moments against the pair mask on the MXU, with shift identities to move
// the moments back onto each query.  Here one thread owns one sorted query
// and walks its cell's 9 CSR stencil columns (lgr::walk_stencil for K2,
// lgr::walk_near for K3 and K4), as K1 does; the moments are accumulated in
// registers, centred on the query itself, so the self pair is exactly 0 and
// d2 > 0 excludes it.
//
// Three launches, because every pass needs its predecessor's result at
// every candidate: K3 weights each neighbour by 1 / (its K2 count), which K2
// also writes out once per point, K4 compares the query's saliency with each
// neighbour's K3 saliency.
//
// Each kernel has a slot-list form (kAt = true, the `_at` entry points) for
// a tp peer of parallel/batch.py, which owns a shard of the input rows: they
// land scattered over the plan's slots.  Thread t takes slots[t] (ascending,
// so a warp's queries still share cells) and writes output row t; K3
// and K4 read the whole cloud's K2 weights and K3 saliencies, gathered from
// the peers.  The per-query body is the full form's, so a slot's outputs are
// the full pass's bit for bit.
//
// Bound on the H100 by the warps' issue rate with part of each warp idle,
// not by bytes and not by load latency: a thread tests every candidate of its
// 27-cell stencil (3 to 8 times the points within the ISS radius), the
// lanes of a warp sit in several cells whose columns differ in length, and
// whatever a hit costs runs with only the lanes that hit.  With some 1,500
// resident threads an SM the loads' latency is hidden.  Points are sorted
// by cell, so the threads of a warp mostly scan the same columns in step
// and their loads coalesce; K3 lost 17 % when that was given up.  The build
// uses -fmad=false: the radius tests round exactly like the plain versions
// in ops/cellgrid.py.
#include "cellgrid.cuh"

namespace {

constexpr int kThreads = 128;

// K2.  The scan alone: a distance test is ~10 of a candidate's ~13
// instructions, so a candidate row shared by two queries of a thread cannot
// save much, and measured on the H100 (1.12M queries, cell = r and 1.545 r)
// it loses: a thread owning two consecutive slots (one walk when they share
// a cell) took 1.9x / 1.65x the time, per-cell pairs from a list 1.5x /
// 1.33x before the list's own cost; lgr::walk_near with every column, which
// K3 gained 2-3 % from, measured 0.3 % slower here.  What K2 adds is the
// second output: 1 / max(count, 1) once per point, where the count is in a
// register, for K3 to read at every hit.
template <bool kAt>
__global__ void __launch_bounds__(kThreads)
    iss_count_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                     const int2* __restrict__ cols, const int* __restrict__ slots, int n,
                     float r2, int* __restrict__ count, float* __restrict__ inv) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = kAt ? slots[t] : t;
  const float4 q = pts[i];
  int c = 0;
  lgr::walk_stencil(cols, cell_of[i], [&](int j) {
    const float4 p = __ldg(pts + j);
    const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z;
    if (dx * dx + dy * dy + dz * dz <= r2) ++c;  // self included (d2 = 0)
  });
  count[t] = c;
  inv[t] = 1.f / fmaxf(static_cast<float>(c), 1.f);  // the IEEE float32 quotient
}

constexpr unsigned kFull = 0xffffffffu;

// K3.  One thread per sorted query with the fold inside the candidate
// loop, as the sums must keep each query's visit order; every column is
// walked.  Measured on the H100 at the route shapes (1.12M queries, 125 and
// 333 stencil candidates a query), all bit-identical: the radius mask loses
// here, because a warp walks a column as long as one of its lanes keeps it
// (1-3 % slower than no mask), and lanes that each take their own next kept
// column read different rows in one step (16-20 % slower); candidate rows
// loaded by hand in groups of 4 to 12 cost registers and resident warps
// (18-85 % slower: the compiler already batches the loop's loads); queueing
// a lane's hits in shared memory to fold them with the warp converged costs
// more than the idle lanes it saves (30-40 % slower).  About half the time
// is the fold, where a third of a warp's lanes hit on a step.
//
// The weight of a hit is read from K2's `inv`, which takes the convert,
// clamp and divide out of every hit, with the same bits: 18 % faster where
// the cell is the radius (a quarter of the candidates hit), 7 % SLOWER on a
// plan whose cell is 1.545 radii (a tenth hit), where the two forms cross at
// 1.4 radii; the cause is not known.  With `inv` read: the fold behind an
// empty asm statement measured the same, a warp vote that skips steps no
// lane hits lost 27 %, the weight loaded ahead of the test 19 %.
template <bool kAt>
__global__ void __launch_bounds__(kThreads)
    iss_saliency_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                        const int2* __restrict__ cols, const float* __restrict__ inv,
                        const int* __restrict__ slots, int n, float r2, float gamma21, float gamma32, float* __restrict__ sal,
                        unsigned char* __restrict__ ok, int* __restrict__ nnb) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = kAt ? slots[t] : t;
  const float4 q = pts[i];
  float ws = 0.f, sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;
  int nb = 0;
  unsigned todo = lgr::kEveryColumn;
  lgr::walk_near(
      cols, cell_of[i], todo,
      [&](int j0, int j1) {
        for (int j = j0; j < j1; ++j) {
          const float4 p = __ldg(pts + j);
          const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z;
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (!(d2 > 0.f) || !(d2 <= r2)) continue;
          const float w = __ldg(inv + j);
          const float wdx = w * dx, wdy = w * dy, wdz = w * dz;
          ws += w;
          sxx += wdx * dx;
          sxy += wdx * dy;
          sxz += wdx * dz;
          syy += wdy * dy;
          syz += wdy * dz;
          szz += wdz * dz;
          ++nb;
        }
      },
      [](bool more) { return more; });
  const float wsafe = fmaxf(ws, 1e-30f);
  float l3, l2, l1, vx, vy, vz;
  lgr::smallest_eig3(sxx / wsafe, sxy / wsafe, sxz / wsafe, syy / wsafe, syz / wsafe,
                     szz / wsafe, l3, l2, l1, vx, vy, vz);
  const bool good = ws > 0.f && l2 / fmaxf(l1, 1e-30f) < gamma21 &&
                    l3 / fmaxf(l2, 1e-30f) < gamma32 && l3 > 0.f;
  sal[t] = good ? l3 : 0.f;
  ok[t] = good ? 1 : 0;
  nnb[t] = nb;
}

// K4.  kp = ok && nb >= min_nb && s > max over the neighbours' sal, which
// is: s > -kBig, no neighbour within r has sal[j] >= s (a NaN sal[j] fails
// the test as fmaxf drops it), and then nb >= min_nb.  So a query ends at
// its first such neighbour, and only one that finds none needs its count:
// a predicate and a count, so the visit order is free, and the walk starts
// with the query's own column, where most neighbours are.  Few queries find
// no blocker (the keypoints), and a warp would wait for each of them: while
// more than kCoopBelow lanes of a warp are open, every open lane walks
// its next column; then the warp takes the open queries one by one, all 32
// lanes testing 32 candidates of the query's remaining columns at a time.
// kCoopBelow of 4 to 16 measured alike at the route shapes, 0 to 2 up to
// twice as slow.
constexpr int kCoopBelow = 8;

template <bool kAt>
__global__ void __launch_bounds__(kThreads)
    iss_nms_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                   const int2* __restrict__ cols, const float* __restrict__ sal,
                   const unsigned char* __restrict__ ok, const int* __restrict__ slots, int n,
                   float r2, int min_nb,
                   const lgr::NearGrid grid, unsigned char* __restrict__ kp) {
  using Order = lgr::NearOrder<true>;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t >= n ? 0 : kAt ? slots[t] : t;
  float s = 0.f;
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  int cell = 0;
  unsigned todo = 0;
  bool open = t < n && ok[t];  // only queries that passed K3 can be keypoints
  if (open) {
    s = sal[i];
    open = s > -lgr::kBig;
  }
  if (open) {
    q = pts[i];
    cell = cell_of[i];
    todo = Order::todo(lgr::near_columns(q, grid));
  }
  bool key = false;
  int nb = 0;
  lgr::walk_near<true>(
      cols, cell, todo,
      [&](int j0, int j1) {
        for (int j = j0; j < j1; ++j) {
          const float4 p = __ldg(pts + j);
          const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z;
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 > 0.f && d2 <= r2) {
            if (__ldg(sal + j) >= s) {
              open = false;
              break;
            }
            ++nb;
          }
        }
      },
      [&](bool more) {
        if (!open) {
          todo = 0;
        } else if (!more) {  // every column walked and no blocker
          key = nb >= min_nb;
          open = false;
        }
        return __popc(__ballot_sync(kFull, open)) > kCoopBelow;
      });
  unsigned owners = __ballot_sync(kFull, open);
  while (owners) {
    const int owner = __ffs(owners) - 1;
    owners &= owners - 1;
    const float qx = __shfl_sync(kFull, q.x, owner), qy = __shfl_sync(kFull, q.y, owner),
                qz = __shfl_sync(kFull, q.z, owner), so = __shfl_sync(kFull, s, owner);
    const unsigned left = __shfl_sync(kFull, todo, owner);
    const int2* row = cols + 9 * static_cast<size_t>(__shfl_sync(kFull, cell, owner));
    int2 r[9];
    int tot = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      r[k] = (left >> k & 1) ? __ldg(row + Order::column(k)) : make_int2(0, 0);
      tot += r[k].y - r[k].x;
    }
    bool blocked = false;
    int cnt = 0;
    for (int t0 = 0; t0 < tot && !blocked; t0 += 32) {
      int rem = t0 + lane, j = -1;  // this lane's candidate: the rem-th of those columns
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int len = r[k].y - r[k].x;
        if (j < 0 && rem < len) j = r[k].x + rem;
        rem -= len;
      }
      bool within = false, blocks = false;
      if (j >= 0) {
        const float4 p = __ldg(pts + j);
        const float dx = p.x - qx, dy = p.y - qy, dz = p.z - qz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        within = d2 > 0.f && d2 <= r2;
        blocks = within && __ldg(sal + j) >= so;
      }
      cnt += __popc(__ballot_sync(kFull, within));
      blocked = __any_sync(kFull, blocks);
    }
    if (lane == owner) key = !blocked && nb + cnt >= min_nb;
  }
  if (t < n) kp[t] = key ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// pts f32[N,4] sorted xyz; cell_of i32[n]; cols i32[n_cells,9,2]; count
// i32[n] points within r, self included; inv f32[n] = 1 / max(count, 1).
extern "C" int lgr_iss_count(const void* pts, const void* cell_of, const void* cols, int n,
                             float r2, void* count, void* inv, void* stream) {
  iss_count_kernel<false><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), nullptr, n, r2, static_cast<int*>(count),
      static_cast<float*>(inv));
  return static_cast<int>(cudaGetLastError());
}

// The slot-list forms: thread t takes the sorted query slots[t] and writes
// output row t of m rows; the per-query body is the full form's, so a
// slot's outputs are bit-equal to the full pass's at that slot.  slots
// ascending (by cell, as the full pass runs) keeps a warp's walks together.
extern "C" int lgr_iss_count_at(const void* pts, const void* cell_of, const void* cols,
                                const void* slots, int m, float r2, void* count, void* inv,
                                void* stream) {
  iss_count_kernel<true><<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const int*>(slots), m, r2,
      static_cast<int*>(count), static_cast<float*>(inv));
  return static_cast<int>(cudaGetLastError());
}

// inv f32[n] of lgr_iss_count; sal f32[n]; ok bool[n]; nnb i32[n] neighbours
// at 0 < d2 <= r2.
extern "C" int lgr_iss_saliency(const void* pts, const void* cell_of, const void* cols,
                                const void* inv, int n, float r2, float gamma21,
                                float gamma32, void* sal, void* ok, void* nnb, void* stream) {
  iss_saliency_kernel<false><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const float*>(inv), nullptr, n, r2,
      gamma21, gamma32, static_cast<float*>(sal), static_cast<unsigned char*>(ok),
      static_cast<int*>(nnb));
  return static_cast<int>(cudaGetLastError());
}

// inv f32[n]: every sorted point's weight (the whole cloud's); sal, ok, nnb
// [m] at the output rows.
extern "C" int lgr_iss_saliency_at(const void* pts, const void* cell_of, const void* cols,
                                   const void* inv, const void* slots, int m, float r2, float gamma21, float gamma32, void* sal, void* ok,
                                   void* nnb, void* stream) {
  iss_saliency_kernel<true><<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const float*>(inv),
      static_cast<const int*>(slots), m, r2, gamma21, gamma32,
      static_cast<float*>(sal), static_cast<unsigned char*>(ok), static_cast<int*>(nnb));
  return static_cast<int>(cudaGetLastError());
}

// sal f32[n], ok bool[n] from lgr_iss_saliency; origin f64[3] (device) and
// cell: the plan's grid (GridPlan.origin, GridPlan.cell); kp bool[n].
extern "C" int lgr_iss_nms(const void* pts, const void* cell_of, const void* cols,
                           const void* sal, const void* ok, int n, float r2, int min_nb,
                           const void* origin, double cell, void* kp, void* stream) {
  iss_nms_kernel<false><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const float*>(sal),
      static_cast<const unsigned char*>(ok), nullptr, n, r2, min_nb,
      lgr::near_grid(origin, cell, r2), static_cast<unsigned char*>(kp));
  return static_cast<int>(cudaGetLastError());
}

// sal f32[n]: every sorted point's saliency (the whole cloud's); ok bool[m]
// and kp bool[m] at the output rows.
extern "C" int lgr_iss_nms_at(const void* pts, const void* cell_of, const void* cols,
                              const void* sal, const void* ok, const void* slots, int m,
                              float r2, int min_nb, const void* origin, double cell, void* kp,
                              void* stream) {
  iss_nms_kernel<true><<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const float*>(sal),
      static_cast<const unsigned char*>(ok), static_cast<const int*>(slots), m, r2, min_nb,
      lgr::near_grid(origin, cell, r2),
      static_cast<unsigned char*>(kp));
  return static_cast<int>(cudaGetLastError());
}
