// K2-K4 · ISS keypoints: radius count, weighted scatter saliency, NMS.
//
// Replace lidar_global_registration_tpu/ops/pallas/cellgrid.py
// `_iss_count_cell`, `_iss_saliency_cell` and `_iss_nms_cell`.  On the TPU
// each is a block of 128 query lanes contracting block-centred candidate
// moments against the pair mask on the MXU, with shift identities to move
// the moments back onto each query.  Here one thread owns one sorted query
// and walks its cell's 9 CSR stencil columns (lgr::walk_stencil), as K1
// does; the moments are accumulated in registers, centred on the query
// itself, so the self pair is exactly 0 and d2 > 0 excludes it.
//
// Three launches, because every pass needs its predecessor's result at
// every candidate: K3 weights each neighbour by 1 / (its K2 count), K4
// compares the query's saliency with each neighbour's K3 saliency.
//
// Bound on the H100: the candidate loads and the latency of the dependent
// stencil walk (as K1), not arithmetic: the ISS radius holds a few dozen
// points of the ~9x that the stencil scans.  Points are sorted by cell, so
// the threads of a warp mostly scan the same columns in step and their
// loads coalesce.  The build uses -fmad=false: the radius tests round
// exactly like the plain versions in ops/cellgrid.py.
#include "cellgrid.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    iss_count_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                     const int2* __restrict__ cols, int n, float r2, int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 q = pts[i];
  int c = 0;
  lgr::walk_stencil(cols, cell_of[i], [&](int j) {
    const float4 p = __ldg(pts + j);
    const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z;
    if (dx * dx + dy * dy + dz * dz <= r2) ++c;  // self included (d2 = 0)
  });
  count[i] = c;
}

__global__ void __launch_bounds__(kThreads)
    iss_saliency_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                        const int2* __restrict__ cols, const int* __restrict__ count, int n,
                        float r2, float gamma21, float gamma32, float* __restrict__ sal,
                        unsigned char* __restrict__ ok, int* __restrict__ nnb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 q = pts[i];
  float ws = 0.f, sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;
  int nb = 0;
  lgr::walk_stencil(cols, cell_of[i], [&](int j) {
    const float4 p = __ldg(pts + j);
    const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (!(d2 > 0.f) || !(d2 <= r2)) return;
    const float w = 1.f / fmaxf(static_cast<float>(__ldg(count + j)), 1.f);
    const float wdx = w * dx, wdy = w * dy, wdz = w * dz;
    ws += w;
    sxx += wdx * dx;
    sxy += wdx * dy;
    sxz += wdx * dz;
    syy += wdy * dy;
    syz += wdy * dz;
    szz += wdz * dz;
    ++nb;
  });
  const float wsafe = fmaxf(ws, 1e-30f);
  float l3, l2, l1, vx, vy, vz;
  lgr::smallest_eig3(sxx / wsafe, sxy / wsafe, sxz / wsafe, syy / wsafe, syz / wsafe,
                     szz / wsafe, l3, l2, l1, vx, vy, vz);
  const bool good = ws > 0.f && l2 / fmaxf(l1, 1e-30f) < gamma21 &&
                    l3 / fmaxf(l2, 1e-30f) < gamma32 && l3 > 0.f;
  sal[i] = good ? l3 : 0.f;
  ok[i] = good ? 1 : 0;
  nnb[i] = nb;
}

__global__ void __launch_bounds__(kThreads)
    iss_nms_kernel(const float4* __restrict__ pts, const int* __restrict__ cell_of,
                   const int2* __restrict__ cols, const float* __restrict__ sal,
                   const unsigned char* __restrict__ ok, int n, float r2, int min_nb,
                   unsigned char* __restrict__ kp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float s = sal[i];
  if (!ok[i]) {  // only queries that passed K3 can be keypoints
    kp[i] = 0;
    return;
  }
  const float4 q = pts[i];
  float nb_max = -lgr::kBig;
  int nb = 0;
  lgr::walk_stencil(cols, cell_of[i], [&](int j) {
    const float4 p = __ldg(pts + j);
    const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (!(d2 > 0.f) || !(d2 <= r2)) return;
    nb_max = fmaxf(nb_max, __ldg(sal + j));
    ++nb;
  });
  kp[i] = (nb >= min_nb && s > nb_max) ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// pts f32[N,4] sorted xyz; cell_of i32[n]; cols i32[n_cells,9,2]; count
// i32[n] points within r, self included.
extern "C" int lgr_iss_count(const void* pts, const void* cell_of, const void* cols, int n,
                             float r2, void* count, void* stream) {
  iss_count_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), n, r2, static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// count i32[n] from lgr_iss_count; sal f32[n]; ok bool[n]; nnb i32[n]
// neighbours at 0 < d2 <= r2.
extern "C" int lgr_iss_saliency(const void* pts, const void* cell_of, const void* cols,
                                const void* count, int n, float r2, float gamma21,
                                float gamma32, void* sal, void* ok, void* nnb, void* stream) {
  iss_saliency_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const int*>(count), n, r2, gamma21, gamma32,
      static_cast<float*>(sal), static_cast<unsigned char*>(ok), static_cast<int*>(nnb));
  return static_cast<int>(cudaGetLastError());
}

// sal f32[n], ok bool[n] from lgr_iss_saliency; kp bool[n].
extern "C" int lgr_iss_nms(const void* pts, const void* cell_of, const void* cols,
                           const void* sal, const void* ok, int n, float r2, int min_nb,
                           void* kp, void* stream) {
  iss_nms_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int*>(cell_of),
      static_cast<const int2*>(cols), static_cast<const float*>(sal),
      static_cast<const unsigned char*>(ok), n, r2, min_nb, static_cast<unsigned char*>(kp));
  return static_cast<int>(cudaGetLastError());
}
