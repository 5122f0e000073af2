// Exact K nearest neighbours for Hopper (sm_90a): for every query point the
// K database points of smallest squared L2 (or L1) distance, ascending,
// ties to the lower database index.
//
// Replaces the TPU kernel `_knn_kernel` (pytorch3d_tpu/ops/knn_pallas.py:36,
// launched by the pallas_call at :135 in `knn_points_pallas_single`, :102).
// It computes the same function as the plain PyTorch version beside its
// wrapper (pytorch3d_tpu_torch/ops/knn.py): distances summed directly over
// the coordinates in order, sum((q - p)^2) or sum(|q - p|), as the Pallas
// kernel does (not the |q|^2 + |p|^2 - 2 q.p of the XLA path); database
// slots at or past lengths2 never win; a slot no database point fills holds
// +inf and index 0 (the wrapper zero-fills it and applies lengths1).
//
// Design.  One thread per query keeps its K best (distance, index) pairs in
// registers, templated on the K bucket 1/2/4/8/16 (the runtime K masks the
// live prefix).  The block's threads stage the database in chunks of
// kChunk points in shared memory, coordinate-major, and every thread then
// walks the chunk in index order: all threads read the same word, a
// broadcast.  A candidate goes in front of the first slot with a strictly
// larger distance and shifts the rest, so walking in ascending index keeps
// the lower index first among equal distances, as the Pallas kernel's
// strict `<` and the plain version's stable sort do.  Most candidates fail
// the test against the K-th best and cost no insertion.  blockIdx.y walks
// the batch; lengths2 bounds the walk.  D <= 8 and K <= 16, as on the TPU.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32). The
// arithmetic: 3*D fp32 operations per (query, point) pair for norm 2
// (difference, square, add), 25 M pairs or ~7 us at 5000 x 5000, D=3 at the
// 33.5 T operations/s that --fmad=false leaves; the bytes (the two clouds
// read once, K results written) are a fraction of that. At the chamfer fit's
// 5000 points the kernel is too small to fill the card (79 blocks of 64
// threads on 132 SMs) and its time is the latency of one thread's sequential
// walk plus the launch; splitting the database across blocks with a merge is
// the step to take when that matters.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kChunk = 256;
constexpr int kMaxD = 8;

template <int KB>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ p1,       // (N, P1, D)
           const float* __restrict__ p2,       // (N, P2, D)
           const int* __restrict__ lengths2,   // (N,) or null
           int P1, int P2, int D, int K, bool l1,
           float* __restrict__ out_d,          // (N, P1, K)
           int* __restrict__ out_i)            // (N, P1, K)
{
  __shared__ float s_db[kMaxD][kChunk];

  const int n = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < P1;
  int count = P2;
  if (lengths2 != nullptr) count = min(max(lengths2[n], 0), P2);

  float q[kMaxD];
  const float* qp = p1 + (static_cast<long long>(n) * P1 + (live ? i : 0)) * D;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) q[d] = (live && d < D) ? qp[d] : 0.0f;

  float bd[KB];
  int bi[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    bd[k] = INFINITY;
    bi[k] = 0;
  }
  float worst = INFINITY;  // the K-th best so far

  const float* db = p2 + static_cast<long long>(n) * P2 * D;
  for (int base = 0; base < count; base += kChunk) {
    const int m = min(kChunk, count - base);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = threadIdx.x; e < m * D; e += kThreads) {
      const int j = e / D;
      s_db[e - j * D][j] = db[static_cast<long long>(base) * D + e];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      float dist = 0.0f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          const float diff = q[d] - s_db[d][j];
          dist = dist + (l1 ? fabsf(diff) : diff * diff);
        }
      }
      if (!(dist < worst)) continue;
      float cd = dist;
      int ci = base + j;
      bool shifting = false;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < K && (shifting || cd < bd[k])) {
          shifting = true;
          const float td = bd[k];
          bd[k] = cd;
          cd = td;
          const int ti = bi[k];
          bi[k] = ci;
          ci = ti;
        }
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k == K - 1) worst = bd[k];
      }
    }
  }
  if (!live) return;
  const long long o = (static_cast<long long>(n) * P1 + i) * K;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k < K) {
      out_d[o + k] = bd[k];
      out_i[o + k] = bi[k];
    }
  }
}

template <int KB>
void launch(const float* p1, const float* p2, const int* lengths2, int N, int P1, int P2,
            int D, int K, bool l1, float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid((P1 + kThreads - 1) / kThreads, N);
  knn_kernel<KB><<<grid, kThreads, 0, stream>>>(p1, p2, lengths2, P1, P2, D, K, l1, out_d,
                                                 out_i);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape or norm this build does not take.
extern "C" int knn_points(const float* p1, const float* p2, const int* lengths2, int N,
                          int P1, int P2, int D, int K, int norm, float* dists, int* idx,
                          void* stream) {
  if (N < 1 || N > 65535 || P1 < 1 || P2 < 1 || D < 1 || D > kMaxD || K < 1 || K > 16 ||
      (norm != 1 && norm != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool l1 = norm == 1;
#define P3D_LAUNCH(KB) launch<KB>(p1, p2, lengths2, N, P1, P2, D, K, l1, dists, idx, s)
  if (K <= 1) P3D_LAUNCH(1);
  else if (K <= 2) P3D_LAUNCH(2);
  else if (K <= 4) P3D_LAUNCH(4);
  else if (K <= 8) P3D_LAUNCH(8);
  else P3D_LAUNCH(16);
#undef P3D_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
