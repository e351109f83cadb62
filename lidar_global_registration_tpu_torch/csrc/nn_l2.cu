// K7 · exact descriptor 1-NN under squared L2.
//
// Replaces lidar_global_registration_tpu/ops/pallas/topk_l2.py `_nn_kernel`
// (via `nn_l2_pallas`): d2 = |q|^2 + |t|^2 - 2 q.t with a running argmin
// over train tiles; ties go to the lowest train index (rows are visited in
// order and only a strictly smaller d2 replaces the best); invalid train
// rows arrive with |t|^2 = BIG from the wrapper, so they never win.
//
// Design: a block owns 128 queries, one per thread.  Train rows stream
// through shared memory in tiles of 64 rows, the descriptor in chunks of 16
// dimensions (any D <= 512; a chunk's tail is zero-padded, which adds exact
// zeros).  Each thread keeps its 64 dot products of the tile in registers;
// a float4 read of one train row is a broadcast to the whole warp.  The dot
// product is plain float32 FMA (no TF32), accumulated in dimension order.
//
// Bound on the H100: float32 FMA throughput and shared-memory bandwidth (one
// 16 B shared load per 4 FMAs); 2 * Nq * Nt * D flops, e.g. 283 GFLOP at
// 65,536 x 65,536 x 33.  The distance matrix never touches device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kTQ = 128;  // queries per block (one per thread)
constexpr int kTT = 64;   // train rows per tile
constexpr int kDC = 16;   // descriptor dimensions per chunk (multiple of 4)
constexpr float kBig = 3.0e38f;

__global__ void __launch_bounds__(kTQ)
    nn_l2_kernel(const float* __restrict__ query, const float* __restrict__ train,
                 const float* __restrict__ qn, const float* __restrict__ tn, int nq, int nt,
                 int d, float* __restrict__ best_d2, int* __restrict__ best_i) {
  __shared__ float qs[kTQ][kDC + 1];  // +1: thread t reads row t, no bank conflicts
  __shared__ __align__(16) float ts[kTT][kDC];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTQ;
  const int qi = q0 + tid;
  const float my_qn = qi < nq ? qn[qi] : 0.f;
  float bd = kBig;
  int bi = 0;
  for (int t0 = 0; t0 < nt; t0 += kTT) {
    float acc[kTT];
#pragma unroll
    for (int t = 0; t < kTT; ++t) acc[t] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kDC) {
      for (int e = tid; e < kTQ * kDC; e += kTQ) {
        const int r = e / kDC, k = e % kDC;
        const int gq = q0 + r, gk = d0 + k;
        qs[r][k] = (gq < nq && gk < d) ? query[static_cast<size_t>(gq) * d + gk] : 0.f;
      }
      for (int e = tid; e < kTT * kDC; e += kTQ) {
        const int r = e / kDC, k = e % kDC;
        const int gt = t0 + r, gk = d0 + k;
        ts[r][k] = (gt < nt && gk < d) ? train[static_cast<size_t>(gt) * d + gk] : 0.f;
      }
      __syncthreads();
      const int kend = min(kDC, d - d0);
      for (int k = 0; k < kend; k += 4) {
        const float a0 = qs[tid][k], a1 = qs[tid][k + 1], a2 = qs[tid][k + 2],
                    a3 = qs[tid][k + 3];
#pragma unroll
        for (int t = 0; t < kTT; ++t) {
          const float4 b = *reinterpret_cast<const float4*>(&ts[t][k]);
          float s = acc[t];
          s = fmaf(a0, b.x, s);
          s = fmaf(a1, b.y, s);
          s = fmaf(a2, b.z, s);
          s = fmaf(a3, b.w, s);
          acc[t] = s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < kTT; ++t) {
      const int gt = t0 + t;
      if (gt < nt) {
        const float d2 = (my_qn + __ldg(tn + gt)) - 2.f * acc[t];
        if (d2 < bd) {
          bd = d2;
          bi = gt;
        }
      }
    }
  }
  if (qi < nq) {
    best_d2[qi] = bd;
    best_i[qi] = bi;
  }
}

}  // namespace

// query f32[nq,d], train f32[nt,d] row-major; qn f32[nq] = |q|^2; tn f32[nt]
// = |t|^2 (BIG at invalid rows); best_d2 f32[nq] (BIG when no row won);
// best_i i32[nq].
extern "C" int lgr_nn_l2(const void* query, const void* train, const void* qn, const void* tn,
                         int nq, int nt, int d, void* best_d2, void* best_i, void* stream) {
  const int blocks = (nq + kTQ - 1) / kTQ;
  nn_l2_kernel<<<blocks, kTQ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(train),
      static_cast<const float*>(qn), static_cast<const float*>(tn), nq, nt, d,
      static_cast<float*>(best_d2), static_cast<int*>(best_i));
  return static_cast<int>(cudaGetLastError());
}
