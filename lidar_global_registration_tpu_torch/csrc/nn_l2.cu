// K7 · exact descriptor 1-NN under squared L2.
//
// Replaces lidar_global_registration_tpu/ops/pallas/topk_l2.py `_nn_kernel`
// (via `nn_l2_pallas`): d2 = |q|^2 + |t|^2 - 2 q.t with a running argmin
// over train tiles; ties go to the lowest train index (only a strictly
// smaller d2 replaces the best); invalid train rows arrive with |t|^2 = BIG
// from the wrapper, so they never win.
//
// Bound on the H100: float32 FMA throughput, 2 * Nq * Nt * D flops at 67
// TFLOP/s (e.g. 341 GFLOP, 5.1 ms, at 22,203 x 22,623 x 352; 4.54 TFLOP,
// 68 ms, at 262,144^2 x 33).  The distance matrix never touches device
// memory; the inputs are read once from HBM and then from L2.
//
// Design: a register-tiled float32 product with a fused running argmin.
//   - A block of 256 threads owns a 128-query x 128-train output tile; each
//     thread an 8 x 8 micro-tile (rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
//     columns likewise from tx), so 4 shared-memory LDS.128 feed 64 FMAs and
//     the 8 threads of a quarter-warp read 128 contiguous bytes (no bank
//     conflicts).
//   - Query and train chunks of 16 dimensions come from dimension-major
//     copies ([D_pad, N_pad], made by the wrapper) with 16-byte cp.async,
//     double-buffered in shared memory over the flattened (train tile,
//     chunk) sequence, so the next chunk loads while this one is multiplied.
//     FPFH's D = 33 has its own kernel: the whole descriptor is one chunk
//     of 40 rows (80 KB of shared memory), one step and one barrier pair a
//     tile, its 33 dimensions unrolled.
//   - The train range may be split over gridDim.y ranges of whole tiles
//     (the wrapper chooses the count so the grid fills the SMs); each range
//     writes a partial (d2, index) per query and nn_l2_merge combines them,
//     lowest range first.
//
// Its results equal, bit for bit, a scan of the train rows in index order
// that keeps a strictly smaller d2, with each (q, t) dot product one fmaf
// chain from 0 in ascending dimension order: padding dimensions are never
// multiplied (the tail chunk runs only its real dimensions), d2 is one
// expression built with -fmad=false, and the argmin is the lexicographic
// minimum of (d2, index), which is what that scan keeps: each thread scans
// its columns in ascending order, the 16 threads of a query row then
// reduce by (d2, index), and the ranges merge in order with a strict <.
// NaN never wins.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;    // queries and train rows per block tile
constexpr int kBK = 16;       // dimensions per chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// micro-tile index (0..7) -> offset in the 128-wide tile
__device__ __forceinline__ int tile_off(int g, int i) { return (i < 4 ? 0 : 64) + g * 4 + (i & 3); }

// one dimension of the 8 x 8 micro-tile: 4 LDS.128, 64 FMAs
__device__ __forceinline__ void fma_k(const float* qk, const float* tk, int tx, int ty,
                                      float (&acc)[8][8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(qk + ty * 4);
  const float4 a1 = *reinterpret_cast<const float4*>(qk + 64 + ty * 4);
  const float4 b0 = *reinterpret_cast<const float4*>(tk + tx * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(tk + 64 + tx * 4);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// one step: a BK-dimension chunk of the query tile (rows q0..) and of the
// train tile (rows t0..) into one shared-memory stage, 16 B per cp.async.
// Offsets into the copies are size_t: d_pad * n_pad passes 2^31 (e.g. at
// d = 1,960 beyond ~1.09M rows); each factor alone is an int.
template <int BK>
__device__ __forceinline__ void load_chunk(float (*qs)[kTile], float (*ts)[kTile],
                                           const float* __restrict__ qt,
                                           const float* __restrict__ tt, int nq_pad, int nt_pad,
                                           int q0, int t0, int d0) {
#pragma unroll
  for (int u = 0; u < BK * kTile / 4 / kThreads; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int k = e >> 5, c = (e & 31) * 4;
    cp_async16(&qs[k][c], qt + static_cast<size_t>(d0 + k) * nq_pad + q0 + c);
    cp_async16(&ts[k][c], tt + static_cast<size_t>(d0 + k) * nt_pad + t0 + c);
  }
  cp_async_commit();
}

// The block's work, on two shared-memory stages qs / ts of a query and a
// train chunk.  BK dimensions per chunk; KD > 0: d == KD <= BK, one chunk a
// tile, its loop unrolled (the FPFH descriptor, KD = 33); KD == 0: any d,
// chunks of BK with a tail chunk that runs only its real dimensions.
template <int BK, int KD>
__device__ __forceinline__ void nn_l2_block(float (*qs)[BK][kTile], float (*ts)[BK][kTile],
                                            const float* __restrict__ qt,
                                            const float* __restrict__ tt,
                                            const float* __restrict__ qn,
                                            const float* __restrict__ tn, int nq, int nq_pad,
                                            int nt_pad, int d, int tiles_per,
                                            float* __restrict__ out_d2, int* __restrict__ out_i) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;
  const int tile_lo = blockIdx.y * tiles_per;
  const int tile_hi = min(tile_lo + tiles_per, nt_pad / kTile);
  const int n_chunks = KD ? 1 : (d + BK - 1) / BK;
  const int steps = (tile_hi - tile_lo) * n_chunks;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float bd[8];
  int bi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bd[i] = kBig;
    bi[i] = 0;
  }

  // the flattened (train tile, chunk) sequence, double-buffered
  load_chunk<BK>(qs[0], ts[0], qt, tt, nq_pad, nt_pad, q0, tile_lo * kTile, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      const int nx = step + 1;
      load_chunk<BK>(qs[buf ^ 1], ts[buf ^ 1], qt, tt, nq_pad, nt_pad, q0,
                     (tile_lo + nx / n_chunks) * kTile, (nx % n_chunks) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int chunk = step % n_chunks;
    const int kend = min(BK, d - chunk * BK);
    if (KD) {
#pragma unroll
      for (int k = 0; k < KD; ++k) fma_k(qs[buf][k], ts[buf][k], tx, ty, acc);
    } else if (kend == BK) {
#pragma unroll
      for (int k = 0; k < BK; ++k) fma_k(qs[buf][k], ts[buf][k], tx, ty, acc);
    } else {  // the tail chunk: only its real dimensions
#pragma unroll 1
      for (int k = 0; k < kend; ++k) fma_k(qs[buf][k], ts[buf][k], tx, ty, acc);
    }
    __syncthreads();  // the buffer may be refilled from here on
    if (chunk == n_chunks - 1) {
      // d2 and the running argmin over this tile; padded train columns
      // carry |t|^2 = BIG and a zero row, so their d2 >= BIG never wins
      const int t0 = (tile_lo + step / n_chunks) * kTile;
      const float4 n0 = __ldg(reinterpret_cast<const float4*>(tn + t0 + tx * 4));
      const float4 n1 = __ldg(reinterpret_cast<const float4*>(tn + t0 + 64 + tx * 4));
      const float tnv[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float my_qn = __ldg(qn + q0 + tile_off(ty, i));
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // columns in ascending order
          const float d2 = (my_qn + tnv[j]) - 2.f * acc[i][j];
          if (d2 < bd[i]) {
            bd[i] = d2;
            bi[i] = t0 + tile_off(tx, j);
          }
          acc[i][j] = 0.f;
        }
      }
    }
  }

  // the 16 threads of a query row are lanes l, l ^ 1, ..., l ^ 8 of a warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float dv = bd[i];
    int iv = bi[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, dv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, iv, off);
      if (od < dv || (od == dv && oi < iv)) {
        dv = od;
        iv = oi;
      }
    }
    const int r = q0 + tile_off(ty, i);
    if (tx == 0 && r < nq) {
      out_d2[static_cast<size_t>(blockIdx.y) * nq + r] = dv;
      out_i[static_cast<size_t>(blockIdx.y) * nq + r] = iv;
    }
  }
}

// any d: chunks of 16 dimensions, 32 KB of static shared memory whatever d
// is (USC's d = 1,960 runs 123 chunks a tile)
__global__ void __launch_bounds__(kThreads, 2)
    nn_l2_kernel(const float* __restrict__ qt, const float* __restrict__ tt,
                 const float* __restrict__ qn, const float* __restrict__ tn, int nq, int nq_pad,
                 int nt_pad, int d, int tiles_per, float* __restrict__ out_d2,
                 int* __restrict__ out_i) {
  __shared__ __align__(16) float qs[2][kBK][kTile];
  __shared__ __align__(16) float ts[2][kBK][kTile];
  nn_l2_block<kBK, 0>(qs, ts, qt, tt, qn, tn, nq, nq_pad, nt_pad, d, tiles_per, out_d2, out_i);
}

constexpr int kFpfhD = 33;   // the FPFH descriptor's width
constexpr int kFpfhBK = 40;  // its chunk: 33 rounded up to 8 (d_pad = 48 holds it)
constexpr int kFpfhSmem = 4 * kFpfhBK * kTile * sizeof(float);  // 80 KB, dynamic

// d == 33: the whole descriptor is one chunk
__global__ void __launch_bounds__(kThreads, 2)
    nn_l2_kernel_d33(const float* __restrict__ qt, const float* __restrict__ tt,
                     const float* __restrict__ qn, const float* __restrict__ tn, int nq,
                     int nq_pad, int nt_pad, int d, int tiles_per, float* __restrict__ out_d2,
                     int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  auto* qs = reinterpret_cast<float (*)[kFpfhBK][kTile]>(smem);
  auto* ts = reinterpret_cast<float (*)[kFpfhBK][kTile]>(smem + 2 * kFpfhBK * kTile);
  nn_l2_block<kFpfhBK, kFpfhD>(qs, ts, qt, tt, qn, tn, nq, nq_pad, nt_pad, d, tiles_per, out_d2,
                               out_i);
}

// Partial (d2, index) of S train ranges -> the result, lowest range first:
// a later range replaces only with a strictly smaller d2.
__global__ void nn_l2_merge(const float* __restrict__ pd, const int* __restrict__ pi, int nq,
                            int splits, float* __restrict__ best_d2, int* __restrict__ best_i) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  float bd = kBig;
  int bi = 0;
  for (int s = 0; s < splits; ++s) {
    const float dv = pd[static_cast<size_t>(s) * nq + q];
    if (dv < bd) {
      bd = dv;
      bi = pi[static_cast<size_t>(s) * nq + q];
    }
  }
  best_d2[q] = bd;
  best_i[q] = bi;
}

// nn_l2_kernel_d33 asks for more than the default 48 KB of shared memory.
cudaError_t allow_d33_smem() {
  return cudaFuncSetAttribute(nn_l2_kernel_d33, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kFpfhSmem);
}

}  // namespace

// Resident blocks per SM of the K7 kernel that runs dimension d (the wrapper
// sizes the split by it).
extern "C" int lgr_nn_l2_blocks_per_sm(int d, void* out) {
  int* n = static_cast<int*>(out);
  if (d != kFpfhD)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, nn_l2_kernel, kThreads, 0));
  cudaError_t err = allow_d33_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, nn_l2_kernel_d33, kThreads,
                                                        kFpfhSmem);
  return static_cast<int>(err);
}

// qt f32[d_pad, nq_pad], tt f32[d_pad, nt_pad] dimension-major, zero-padded
// (d_pad a multiple of 16, nq_pad and nt_pad of 128); qn f32[nq_pad] =
// |q|^2; tn f32[nt_pad] = |t|^2, BIG at invalid and padded rows; the train
// tiles split into `splits` ranges of `tiles_per` tiles.  splits == 1: the
// kernel writes best_d2 f32[nq] (BIG when no row won) and best_i i32[nq]
// directly; else it writes part_d2 f32[splits, nq] and part_i
// i32[splits, nq], which nn_l2_merge reduces into them.
extern "C" int lgr_nn_l2(const void* qt, const void* tt, const void* qn, const void* tn, int nq,
                         int nq_pad, int nt_pad, int d, int tiles_per, int splits, void* part_d2,
                         void* part_i, void* best_d2, void* best_i, void* stream) {
  if (d == kFpfhD) {
    const cudaError_t err = allow_d33_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool merge = splits > 1;
  const dim3 grid(nq_pad / kTile, splits);
  auto kernel = d == kFpfhD ? nn_l2_kernel_d33 : nn_l2_kernel;
  kernel<<<grid, kThreads, d == kFpfhD ? kFpfhSmem : 0, st>>>(
      static_cast<const float*>(qt), static_cast<const float*>(tt),
      static_cast<const float*>(qn), static_cast<const float*>(tn), nq, nq_pad, nt_pad, d,
      tiles_per, static_cast<float*>(merge ? part_d2 : best_d2),
      static_cast<int*>(merge ? part_i : best_i));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  nn_l2_merge<<<(nq + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_d2), static_cast<const int*>(part_i), nq, splits,
      static_cast<float*>(best_d2), static_cast<int*>(best_i));
  return static_cast<int>(cudaGetLastError());
}
