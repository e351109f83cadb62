// K8 · exact k-NN over xyz rows: the cluster gate's same-set keypoint k-NN.
//
// Replaces no TPU kernel: the JAX package computes this k-NN with
// matchers.match_bf's tiled XLA top-k (lax.top_k over Gram-trick distance
// tiles, lidar_global_registration_tpu/ops/matchers.py:92-149), which the
// port's plain version ops/matchers._topk_l2 follows with a float32 distance
// matrix and torch.topk.  This kernel computes the same function: for each
// query the k train rows least by (d2, index), d2 = max(|q|^2 + |t|^2 -
// 2 q.t, 0) in float32 (each product and sum rounded on its own: the library
// builds with -fmad=false), invalid train rows and the query's own row (by
// id) left out, slots beyond the rows found carrying (BIG, 0).
//
// Bound on the H100: 10 nq nt float32 operations (2 nq nt D + 4 nq nt at
// D = 3, K7's count) at 67 TFLOP/s: 0.090 ms at 24,576^2.  The distance
// matrix never touches device memory.  What the brute force would spend on
// issue, this design spends on skipping; what remains is the latency of one
// block's walk and its list inserts (~0.23 ms of kernel a side at the 10M
// cell's 24,576 keypoints).
//
// Design:
//   - Order.  The rows come in the caller's order (the working cloud's
//     z-major voxel order), in which a query's neighbours lie far apart.
//     lgr_knn_xyz_keys gives every row a 15-bit Morton key of its cell in
//     the valid rows' bounding cube (5 bits an axis, so a sort takes two
//     radix passes; invalid rows last), the wrapper sorts both sets by it,
//     and the kernel works in that order: a block's 32 queries are
//     neighbours in space, and its walk starts at the train tile where its
//     first query's key falls (home, +1, -1, +2, -2, ...).  The order moves
//     only the work, never the result: the lists compare (d2, original
//     index).
//   - Skipping.  The pack records each tile of 128 rows' bounding box and
//     largest |t|^2; a block skips every tile whose `gap` to its queries'
//     box exceeds the largest of their bars, a margin covering every float32
//     rounding of a computed d2, so no row of a skipped tile could have
//     entered a list.  A block of the 10M cell reads 11-12 of its ~175
//     valid tiles on average.
//   - One thread per query and part: a block holds 32 queries and four
//     warps; warp p scans rows p, p + 4, ... of every tile (staged through
//     shared memory, one float4 a row: -2x, -2y, -2z, |t|^2, +inf as |t|^2
//     for an invalid or padding row), each lane into its own sorted list of
//     K = k rounded up to 8 (<= 64) 64-bit keys (d2 bits << 32 | original
//     index) in registers, a template over K.  Keys order as (d2, index)
//     since d2 >= +0, so ties go to the lowest index whatever the order of
//     the scan.  At the end warp 0 merges the four lists.
//   - The bar (knn_xyz_kernel): an upper bound of the query's true K-th d2
//     from the first row on, so few rows are ever inserted.
//   - The train side is not split over blocks: a range of a split fills its
//     own lists with a far looser K-th d2 (measured: 1.19 ms of kernel a
//     side at 24,576^2 over 8 ranges, before skipping).  Nor is a block one
//     warp: that leaves an SM one or two warps to hide the walk's latency.
//   - Rows whose Morton key marks them invalid: a query writes (BIG, 0) and
//     scans nothing; a train tile past the last valid row is never loaded.
//     No count is read back: every size comes from the shapes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // train rows per shared-memory tile
constexpr int kQ = 32;      // queries per block, a query a lane of each warp
constexpr int kParts = kTile / kQ;  // warps per block, each scanning its part of every tile
static_assert(kParts == 4, "knn_xyz_kernel merges four lists");
constexpr int kBatch = 8;   // rows a thread loads before it queues any
constexpr int kQueue = 16;  // a thread's queue of rows waiting for its list
constexpr int kLbTiles = 1024;  // tiles whose gaps a block keeps in shared memory
constexpr int kKeyThreads = 256;  // threads of a block of knn_xyz_box and knn_xyz_keys
constexpr int kMaxBoxParts = 64;  // blocks of knn_xyz_box at most (its partial boxes)
constexpr float kBig = 3.0e38f;
constexpr short kNoKey = 0x7fff;  // the Morton key of an invalid row: sorts last

// 5 bits spread to every third bit
__device__ __forceinline__ unsigned spread3(unsigned x) {
  x &= 0x1fu;
  x = (x | (x << 8)) & 0x100fu;
  x = (x | (x << 4)) & 0x10c3u;
  x = (x | (x << 2)) & 0x1249u;
  return x;
}

// row r of the sets a (na rows) and b (nb rows, or none) taken as one
__device__ __forceinline__ const float* row_of(const float* a, int na, const float* b, int r) {
  return r < na ? a + 3 * static_cast<size_t>(r) : b + 3 * static_cast<size_t>(r - na);
}

// part[6 blk .. 6 blk + 5]: min x, y, z and max x, y, z of the valid rows
// that block blk reads of a and b (+inf / -inf for none)
__global__ void __launch_bounds__(kKeyThreads)
    knn_xyz_box(const float* __restrict__ a, const bool* __restrict__ av, int na,
                const float* __restrict__ b, const bool* __restrict__ bv, int nb,
                float* __restrict__ part) {
  const float inf = __int_as_float(0x7f800000);
  float v[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int r = blockIdx.x * kKeyThreads + threadIdx.x; r < na + nb;
       r += gridDim.x * kKeyThreads) {
    if (!(r < na ? av[r] : bv[r - na])) continue;
    const float* p = row_of(a, na, b, r);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = fminf(v[c], p[c]);
      v[3 + c] = fmaxf(v[3 + c], p[c]);
    }
  }
  __shared__ float s_v[6][kKeyThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float o = __shfl_xor_sync(0xffffffffu, v[c], off);
      v[c] = c < 3 ? fminf(v[c], o) : fmaxf(v[c], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s_v[c][warp] = v[c];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int c = threadIdx.x;
    float x = s_v[c][0];
    for (int w = 1; w < kKeyThreads / 32; ++w) x = c < 3 ? fminf(x, s_v[c][w]) : fmaxf(x, s_v[c][w]);
    part[6 * blockIdx.x + c] = x;
  }
}

// akey[r] / bkey[r]: the Morton key of row r's cell of a / b, 32 cells an
// axis over the bounding cube of the n_part partial boxes; kNoKey where the
// row is invalid, and only there
__global__ void __launch_bounds__(kKeyThreads)
    knn_xyz_keys(const float* __restrict__ a, const bool* __restrict__ av, int na,
                 const float* __restrict__ b, const bool* __restrict__ bv, int nb,
                 const float* __restrict__ part, int n_part, short* __restrict__ akey,
                 short* __restrict__ bkey) {
  __shared__ float s_box[6];
  if (threadIdx.x < 32) {  // warp 0 folds the partial boxes
    const float inf = __int_as_float(0x7f800000);
    float v[6] = {inf, inf, inf, -inf, -inf, -inf};
    for (int i = threadIdx.x; i < n_part; i += 32) {
#pragma unroll
      for (int c = 0; c < 6; ++c)
        v[c] = c < 3 ? fminf(v[c], part[6 * i + c]) : fmaxf(v[c], part[6 * i + c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float o = __shfl_xor_sync(0xffffffffu, v[c], off);
        v[c] = c < 3 ? fminf(v[c], o) : fmaxf(v[c], o);
      }
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < 6; ++c) s_box[c] = v[c];
    }
  }
  __syncthreads();
  const int r = blockIdx.x * kKeyThreads + threadIdx.x;
  if (r >= na + nb) return;
  const bool in_a = r < na;
  short key = kNoKey;
  if (in_a ? av[r] : bv[r - na]) {
    const float ext = fmaxf(fmaxf(s_box[3] - s_box[0], s_box[4] - s_box[1]), s_box[5] - s_box[2]);
    const float scale = ext > 0.f ? 32.f / ext : 0.f;
    const float* p = row_of(a, na, b, r);
    unsigned code = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      code |= spread3(static_cast<unsigned>(fminf(fmaxf((p[c] - s_box[c]) * scale, 0.f), 31.f)))
              << c;
    // cell (31, 31, 31) codes to kNoKey itself: a valid row there takes the
    // key below, the order only of the work
    key = static_cast<short>(code < static_cast<unsigned>(kNoKey) ? code : kNoKey - 1);
  }
  (in_a ? akey : bkey)[in_a ? r : r - na] = key;
}

// first position in keys[0..n) whose key is >= v
__device__ int lower_bound(const short* __restrict__ keys, int n, short v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The train rows in key order, packed, one block a tile: t4[j] = (-2x, -2y,
// -2z, |t|^2) of row perm_t[j] (|t|^2 = +inf where it is invalid, and for
// padding j >= nt), tid[j] = perm_t[j]; box[2 b], box[2 b + 1] = the valid
// rows' (min x, y, z, 0) and (max x, y, z, max |t|^2) of tile b (+inf /
// -inf and 0 for a tile of none); home[b] = the train position of query
// block b's first key (32 queries a block); *nt_valid = the valid train rows.
__global__ void __launch_bounds__(kTile)
    knn_xyz_pack(const float* __restrict__ t, const bool* __restrict__ tv,
                 const int64_t* __restrict__ perm_t, const short* __restrict__ tkey_s, int nt,
                 int nt_pad, const short* __restrict__ qkey_s, int nq, float4* __restrict__ t4,
                 int* __restrict__ tid, float4* __restrict__ box, int* __restrict__ home,
                 int* __restrict__ nt_valid) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[4] = {-inf, -inf, -inf, 0.f};
  if (j < nt_pad) {
    float4 o = make_float4(0.f, 0.f, 0.f, inf);
    int id = 0;
    if (j < nt) {
      const int64_t r = perm_t[j];
      id = static_cast<int>(r);
      if (tv[r]) {
        const float x = t[3 * r], y = t[3 * r + 1], z = t[3 * r + 2];
        o = make_float4(-2.f * x, -2.f * y, -2.f * z, (x * x + y * y) + z * z);
        lo[0] = hi[0] = x;
        lo[1] = hi[1] = y;
        lo[2] = hi[2] = z;
        hi[3] = o.w;
      }
    }
    t4[j] = o;
    tid[j] = id;
  }
  if (blockIdx.x < nt_pad / kTile) {
    __shared__ float s_box[7][kTile / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], off));
#pragma unroll
      for (int c = 0; c < 4; ++c) hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], off));
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) s_box[c][warp] = lo[c];
#pragma unroll
      for (int c = 0; c < 4; ++c) s_box[3 + c][warp] = hi[c];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kTile / 32; ++w) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s_box[c][0] = fminf(s_box[c][0], s_box[c][w]);
#pragma unroll
        for (int c = 0; c < 4; ++c) s_box[3 + c][0] = fmaxf(s_box[3 + c][0], s_box[3 + c][w]);
      }
      box[2 * blockIdx.x] = make_float4(s_box[0][0], s_box[1][0], s_box[2][0], 0.f);
      box[2 * blockIdx.x + 1] = make_float4(s_box[3][0], s_box[4][0], s_box[5][0], s_box[6][0]);
    }
  }
  if (j < (nq + kQ - 1) / kQ) home[j] = lower_bound(tkey_s, nt, qkey_s[j * kQ]);
  if (j == 0) *nt_valid = lower_bound(tkey_s, nt, kNoKey);
}

// A lower bound of every computed d2 between a query in the box qlo..qhi
// (|q|^2 <= qn_max) and a row of tile `b`: the squared distance between the
// boxes, less what float32 rounding can take off a computed d2 (9 u (|q|^2 +
// |t|^2) by the error bound of its three products, two sums and two more
// sums, u = 2^-24) and off that distance itself, with room to spare
// (1e-6 > 16 u).  A tile whose gap exceeds a query's bar holds no row that
// could enter its list; a tile of no valid row gives +inf.
__device__ __forceinline__ float gap(const float4* __restrict__ box, int b, const float* qlo,
                                     const float* qhi, float qn_max) {
  const float4 tlo = box[2 * b], thi = box[2 * b + 1];
  const float dx = fmaxf(fmaxf(tlo.x - qhi[0], qlo[0] - thi.x), 0.f);
  const float dy = fmaxf(fmaxf(tlo.y - qhi[1], qlo[1] - thi.y), 0.f);
  const float dz = fmaxf(fmaxf(tlo.z - qhi[2], qlo[2] - thi.z), 0.f);
  const float lb = (dx * dx + dy * dy) + dz * dz;
  return lb * (1.f - 1e-6f) - 1e-6f * (qn_max + thi.w);
}

// tile of step c of the walk from `home`: home, home + 1, home - 1,
// home + 2, home - 2, ...
__device__ __forceinline__ int walk(int home, int c) {
  return (c & 1) ? home + ((c + 1) >> 1) : home - (c >> 1);
}

// key into a sorted list of K keys, if it is less than the last
template <int K>
__device__ __forceinline__ void insert(unsigned long long (&list)[K], unsigned long long key) {
#pragma unroll
  for (int m = K - 1; m > 0; --m) {
    const unsigned long long prev = list[m - 1];
    list[m] = key < prev ? prev : (key < list[m] ? key : list[m]);
  }
  list[0] = key < list[0] ? key : list[0];
}

__device__ __forceinline__ float key_d2(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

// Every key this thread queued (qd[0..n) of its column of a [kQueue][kTile]
// shared array) into its sorted list, the warp's lanes in step, then the
// bar: the list's K-th d2, or g if less
template <int K>
__device__ __forceinline__ void flush(unsigned long long (&list)[K],
                                      unsigned long long (*qd)[kTile], int& n, float& kth,
                                      float g) {
  while (__any_sync(0xffffffffu, n > 0)) {
    if (n > 0) {
      const unsigned long long key = qd[--n][threadIdx.x];
      if (key < list[K - 1]) insert(list, key);
    }
  }
  kth = fminf(g, key_d2(list[K - 1]));
}

// One block: 32 key-ordered queries (one a lane) against every train tile
// in walk order from the home tile, skipping the tiles whose gap exceeds the
// largest bar of the 32 so far.  Warp p scans rows p, p + 4, ..., p + 124 of each
// tile into its own list.
//   - The bar: a row enters a list only if its d2 is at most the query's
//     bar, an upper bound of its true K-th d2.  It starts as the K-th d2 of
//     the home tile's 128 rows (rounded up to 1/16 of an octave by 12
//     bisection steps over the float's bits, the four warps' counts summed
//     in shared memory), which the Morton order makes the query's
//     neighbourhood, and falls with the query's four lists as of the tile
//     before: to their least K-th d2 or, once each holds K/4 rows, their
//     largest (K/4)-th (K rows lie at or below it), and to its own list's
//     K-th if less.  Each bounds the true K-th d2 from above, so no row of
//     the true K is ever refused, and each list keeps all of its own.
//   - A row that passes goes to the thread's queue in shared memory; when a
//     queue may fill, every lane's queue goes into its list together, so a
//     warp pays for an insert about as often as its busiest lane inserts,
//     not at every row some lane wants.
//   - At the end warp 0 merges the four sorted lists from shared memory
//     and writes best_d / best_i [nq, k] at the queries' own rows.
template <int K>
__global__ void __launch_bounds__(kTile)
    knn_xyz_kernel(const float* __restrict__ q, const int64_t* __restrict__ perm_q,
                   const short* __restrict__ qkey_s, int nq, const float4* __restrict__ t4,
                   const int* __restrict__ tid, const float4* __restrict__ box,
                   const int* __restrict__ home, const int* __restrict__ nt_valid,
                   const int64_t* __restrict__ exclude_ids, long long id_offset, int diag, int k,
                   float* __restrict__ best_d, int64_t* __restrict__ best_i) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float4 ts[2][kTile];
  __shared__ int tis[2][kTile];
  __shared__ float s_kth[2][kParts][kQ];           // each list's K-th d2, by step parity
  __shared__ float s_kq[2][kParts][kQ];            // each list's (K/4)-th d2, the same
  __shared__ int s_cnt[2][kParts][kQ];             // the bisection's counts, by step parity
  __shared__ float s_lb[kLbTiles];                 // each tile's gap
  __shared__ unsigned long long s_queue[kQueue][kTile];  // each thread's queued keys
  extern __shared__ unsigned long long s_lists[];  // [kParts][K][kQ], after the walk
  const int lane = threadIdx.x & 31, part = threadIdx.x >> 5;
  const int qs = blockIdx.x * kQ + lane;
  const bool live = qs < nq && qkey_s[qs] != kNoKey;
  const float inf = __int_as_float(0x7f800000);
  float qx = 0.f, qy = 0.f, qz = 0.f, qn = 0.f;
  long long own = -1;  // the local train id left out for this query
  if (live) {
    const int64_t r = perm_q[qs];
    qx = q[3 * r];
    qy = q[3 * r + 1];
    qz = q[3 * r + 2];
    qn = (qx * qx + qy * qy) + qz * qz;
    if (diag)
      own = r - id_offset;
    else if (exclude_ids)
      own = exclude_ids[r] - id_offset;
  }
  // the block's query box and largest |q|^2 (every warp reduces the same 32)
  float qb[7] = {live ? qx : inf, live ? qy : inf, live ? qz : inf,
                 live ? qx : -inf, live ? qy : -inf, live ? qz : -inf, qn};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) qb[c] = fminf(qb[c], __shfl_xor_sync(kAll, qb[c], off));
#pragma unroll
    for (int c = 3; c < 7; ++c) qb[c] = fmaxf(qb[c], __shfl_xor_sync(kAll, qb[c], off));
  }
  s_kth[1][part][lane] = kBig;
  s_kq[1][part][lane] = kBig;
  const int n_tiles = (*nt_valid + kTile - 1) / kTile;
  const bool cached = n_tiles <= kLbTiles;
  if (cached)
    for (int b = threadIdx.x; b < n_tiles; b += kTile) s_lb[b] = gap(box, b, qb, qb + 3, qb[6]);

  // an empty slot: (d2 = BIG, index 0)
  const unsigned long long empty = static_cast<unsigned long long>(__float_as_uint(kBig)) << 32;
  unsigned long long list[K];
#pragma unroll
  for (int s = 0; s < K; ++s) list[s] = empty;
  int queued = 0;
  float bar = kBig;  // the bar, the same in the four warps
  float kth = kBig;  // the bar, or this list's K-th d2 if less

  if (__syncthreads_or(live) && n_tiles > 0) {
    const int h = min(home[blockIdx.x] / kTile, n_tiles - 1);
    const int last = 2 * max(h, n_tiles - 1 - h);  // the walk's last step
    ts[0][threadIdx.x] = t4[h * kTile + threadIdx.x];
    tis[0][threadIdx.x] = tid[h * kTile + threadIdx.x];
    __syncthreads();
    {  // the first bar: the home tile's K-th d2, by bisection over its bits
      unsigned v[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float4 t = ts[0][part + kParts * j];
        float dot = qx * t.x;
        dot = dot + qy * t.y;
        dot = dot + qz * t.z;
        const float d2 = (qn + t.w) + dot;
        const bool in = live && tis[0][part + kParts * j] != own && d2 <= kBig;
        v[j] = in ? __float_as_uint(d2 < 0.f ? 0.f : d2) : 0x7f800000u;
      }
      unsigned prefix = 0;
#pragma unroll 1
      for (int bit = 30; bit >= 19; --bit) {
        const unsigned cand = prefix | (1u << bit);
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < kQ; ++j) cnt += v[j] < cand;
        s_cnt[bit & 1][part][lane] = cnt;
        __syncthreads();
#pragma unroll
        for (int p = 0; p < kParts; ++p) cnt += p == part ? 0 : s_cnt[bit & 1][p][lane];
        if (cnt < K) prefix = cand;
      }
      bar = __uint_as_float(min(prefix + (1u << 19) - 1, __float_as_uint(kBig)));
    }
    int c = 0, cur = h;
    float4 nx;
    int ni;
    for (int s = 0; cur >= 0; ++s) {
      const int buf = s & 1;
      if (s > 0) {
        ts[buf][threadIdx.x] = nx;
        tis[buf][threadIdx.x] = ni;
        __syncthreads();
      }
      // the four lists' least K-th d2, and their largest (K/4)-th: K rows
      // lie at or below it
      float g = kBig, g4 = 0.f;
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        g = fminf(g, s_kth[buf ^ 1][p][lane]);
        g4 = fmaxf(g4, s_kq[buf ^ 1][p][lane]);
      }
      bar = fminf(bar, fminf(g, g4));
      kth = fminf(kth, bar);
      // the next tile whose gap is within the largest of the 32 queries'
      // bars (bars only fall, so an older one is safe), 32 steps of the
      // walk at once; the same choice in every warp
      const float bound =
          __uint_as_float(__reduce_max_sync(kAll, __float_as_uint(live ? bar : 0.f)));
      cur = -1;
      for (; c < last; c += kQ) {
        const int cc = c + 1 + lane, b = walk(h, cc);
        const bool near = cc <= last && b >= 0 && b < n_tiles &&
                          !((cached ? s_lb[b] : gap(box, b, qb, qb + 3, qb[6])) > bound);
        const unsigned hit = __ballot_sync(kAll, near);
        if (hit) {
          c += __ffs(hit);
          cur = walk(h, c);
          break;
        }
      }
      if (cur >= 0) {
        nx = t4[cur * kTile + threadIdx.x];
        ni = tid[cur * kTile + threadIdx.x];
      }
      // rows part, part + 4, ... of the tile, eight loaded before any is
      // queued (a queued store could alias the tile, so later loads wait)
      for (int m = 0; m < kQ; m += kBatch) {
        float d2v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float4 t = ts[buf][part + kParts * (m + u)];
          float dot = qx * t.x;
          dot = dot + qy * t.y;
          dot = dot + qz * t.z;
          d2v[u] = (qn + t.w) + dot;  // (|q|^2 + |t|^2) - 2 q.t, exactly
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (live && d2v[u] <= kth) {
            const int ti = tis[buf][part + kParts * (m + u)];
            if (ti != own) {
              const float d = d2v[u] < 0.f ? 0.f : d2v[u];
              s_queue[queued++][threadIdx.x] =
                  (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
                  static_cast<unsigned>(ti);
            }
          }
        }
        if (__any_sync(kAll, queued > kQueue - kBatch)) flush(list, s_queue, queued, kth, kth);
      }
      s_kth[buf][part][lane] = key_d2(list[K - 1]);
      s_kq[buf][part][lane] = key_d2(list[K / kParts - 1]);
    }
    flush(list, s_queue, queued, kth, kth);
  }

  // the four lists, merged
#pragma unroll
  for (int s = 0; s < K; ++s) s_lists[(part * K + s) * kQ + lane] = list[s];
  __syncthreads();
  if (part > 0 || qs >= nq) return;
  int a1 = 0, a2 = 0, a3 = 0;
  unsigned long long h0 = list[0], h1 = s_lists[(1 * K) * kQ + lane],
                     h2 = s_lists[(2 * K) * kQ + lane], h3 = s_lists[(3 * K) * kQ + lane];
  int a0 = 0;
  const int64_t row = perm_q[qs];
  for (int o = 0; o < k; ++o) {
    const unsigned long long m01 = h1 < h0 ? h1 : h0, m23 = h3 < h2 ? h3 : h2;
    const unsigned long long best = m23 < m01 ? m23 : m01;
    best_d[row * k + o] = key_d2(best);
    best_i[row * k + o] = static_cast<int64_t>(static_cast<unsigned>(best));
    if (best == h0) {
      h0 = ++a0 < K ? s_lists[a0 * kQ + lane] : ~0ull;
    } else if (best == h1) {
      h1 = ++a1 < K ? s_lists[(1 * K + a1) * kQ + lane] : ~0ull;
    } else if (best == h2) {
      h2 = ++a2 < K ? s_lists[(2 * K + a2) * kQ + lane] : ~0ull;
    } else {
      h3 = ++a3 < K ? s_lists[(3 * K + a3) * kQ + lane] : ~0ull;
    }
  }
}

template <int K>
cudaError_t launch_kernel(int blocks, cudaStream_t st, const float* q, const int64_t* perm_q,
                          const short* qkey_s, int nq, const float4* t4, const int* tid,
                          const float4* box, const int* home, const int* nt_valid,
                          const int64_t* excl, long long id_offset, int diag, int k,
                          float* best_d, int64_t* best_i) {
  constexpr int smem = kParts * K * kQ * sizeof(unsigned long long);
  const cudaError_t err = cudaFuncSetAttribute(
      knn_xyz_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  knn_xyz_kernel<K><<<blocks, kTile, smem, st>>>(q, perm_q, qkey_s, nq, t4, tid, box, home,
                                                 nt_valid, excl, id_offset, diag, k, best_d,
                                                 best_i);
  return cudaGetLastError();
}

}  // namespace

// q f32[nq, 3], qv bool[nq]; t f32[nt, 3], tv bool[nt], or t null: the same
// set as q.  part f32[6 * 64] (scratch); qkey i16[nq], tkey i16[nt] (t
// only): each row's Morton key over the valid rows' bounding cube of both
// sets.
extern "C" int lgr_knn_xyz_keys(const void* q, const void* qv, int nq, const void* t,
                                const void* tv, int nt, void* part, void* qkey, void* tkey,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = nq + (t ? nt : 0);
  const int n_part = min(max((n + kKeyThreads - 1) / kKeyThreads, 1), kMaxBoxParts);
  const float* a = static_cast<const float*>(q);
  const float* b = static_cast<const float*>(t);
  const bool* av = static_cast<const bool*>(qv);
  const bool* bv = static_cast<const bool*>(tv);
  knn_xyz_box<<<n_part, kKeyThreads, 0, st>>>(a, av, nq, b, bv, t ? nt : 0,
                                             static_cast<float*>(part));
  if (n > 0)
    knn_xyz_keys<<<(n + kKeyThreads - 1) / kKeyThreads, kKeyThreads, 0, st>>>(
        a, av, nq, b, bv, t ? nt : 0, static_cast<const float*>(part), n_part,
        static_cast<short*>(qkey), static_cast<short*>(tkey));
  return static_cast<int>(cudaGetLastError());
}

// After the sort: perm_q i64[nq] / qkey_s i16[nq] and perm_t i64[nt] /
// tkey_s i16[nt] the key order of each set; nt_pad a multiple of 128;
// exclude_ids i64[nq] or null, diag != 0: the query's own row (either less
// id_offset).  Scratch: t4 f32[nt_pad, 4], tid i32[nt_pad], box
// f32[nt_pad / 64, 4], home i32[ceil(nq / 32)], nt_valid i32[1].  Writes
// best_d f32[nq, k] and best_i i64[nq, k], 1 <= k <= 64.
extern "C" int lgr_knn_xyz(const void* q, const void* perm_q, const void* qkey_s, int nq,
                           const void* t, const void* tv, const void* perm_t,
                           const void* tkey_s, int nt, int nt_pad, const void* exclude_ids,
                           long long id_offset, int diag, int k, void* t4, void* tid, void* box,
                           void* home, void* nt_valid, void* best_d, void* best_i,
                           void* stream) {
  if (k < 1 || k > 64 || nt_pad % kTile) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_blocks = (nq + kQ - 1) / kQ;
  const int pack_blocks = max(nt_pad / kTile, (q_blocks + kTile - 1) / kTile);
  knn_xyz_pack<<<pack_blocks, kTile, 0, st>>>(
      static_cast<const float*>(t), static_cast<const bool*>(tv),
      static_cast<const int64_t*>(perm_t), static_cast<const short*>(tkey_s), nt, nt_pad,
      static_cast<const short*>(qkey_s), nq, static_cast<float4*>(t4), static_cast<int*>(tid),
      static_cast<float4*>(box), static_cast<int*>(home), static_cast<int*>(nt_valid));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nq == 0) return static_cast<int>(err);
  auto* qf = static_cast<const float*>(q);
  auto* pq = static_cast<const int64_t*>(perm_q);
  auto* qk = static_cast<const short*>(qkey_s);
  auto* pt4 = static_cast<const float4*>(t4);
  auto* ptid = static_cast<const int*>(tid);
  auto* pbox = static_cast<const float4*>(box);
  auto* ph = static_cast<const int*>(home);
  auto* pnv = static_cast<const int*>(nt_valid);
  auto* ex = static_cast<const int64_t*>(exclude_ids);
  auto* bd = static_cast<float*>(best_d);
  auto* bi = static_cast<int64_t*>(best_i);
#define LGR_KNN_CASE(KK)                                                                      \
  case KK:                                                                                    \
    return static_cast<int>(launch_kernel<KK>(q_blocks, st, qf, pq, qk, nq, pt4, ptid, pbox, \
                                              ph, pnv, ex, id_offset, diag, k, bd, bi));
  switch ((k + 7) / 8 * 8) {
    LGR_KNN_CASE(8)
    LGR_KNN_CASE(16)
    LGR_KNN_CASE(24)
    LGR_KNN_CASE(32)
    LGR_KNN_CASE(40)
    LGR_KNN_CASE(48)
    LGR_KNN_CASE(56)
    LGR_KNN_CASE(64)
  }
#undef LGR_KNN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
