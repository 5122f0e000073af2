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
// Design: the database split across blocks, then an ordered merge.
//
// Stage 1 (`knn_ranges_kernel`).  The wrapper cuts the database [0, P2)
// into S contiguous ranges of L points (`knn_ranges` in knn.py picks S per
// K bucket: 16 blocks an SM at K <= 2, fewer, longer ranges for deeper
// lists, each range at least two staged chunks long); blockIdx.y is the
// range, blockIdx.z the batch item.  A block of 128 threads holds Q queries per thread (Q = 4 at
// K <= 2, 2 at K <= 8, 1 at K = 16: the K best (distance, index) pairs of
// every query stay in registers), stages its range in chunks of 64 points
// in shared memory, coordinate-major, and every thread walks each chunk in
// ascending index: a staged coordinate, read by all threads at once (a
// broadcast), serves Q pairs.  A candidate goes in front of the first
// slot with a strictly larger distance and shifts the rest, so walking in
// ascending index keeps the lower index first among equal distances, as
// the Pallas kernel's strict `<` and the plain version's stable sort do;
// most candidates fail the test against the K-th best and cost no
// insertion.  lengths2 bounds each range.  The block writes each query's
// sorted list to a scratch (N, S, P1, K) of distances and ids, or, where
// S = 1, straight to the outputs (and stage 2 does not run).
//
// Stage 2 (`knn_merge_kernel`), one thread per query, inserts the S lists
// in range order, each list in its own order, by the same rule: a tie
// keeps the earlier list, which holds the lower indices, so the result is
// the single walk's bit for bit.  A list is left at its first entry that
// is not below the K-th best (it is sorted).  Per pair the arithmetic is
// the plain version's, dist = dist + diff*diff over d in order (the first
// term is diff*diff itself: 0 + x is x for x >= 0), built without FMA
// contraction.  D = 3 has its own instantiation; other D <= 8 loop to the
// runtime D, whose predicated dead dimensions cost the 30 000 x 30 000
// walk below 2.7x (1.19 ms; knn_study.py --runtime-d).
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32, half
// of that without FMA contraction).  The arithmetic: 3*D fp32 operations
// per (query, point) pair for norm 2 (difference, square, add), against
// which the clouds' bytes are negligible.  Measured by chip_smoke.py
// (device time, both stages; NVIDIA H100 80GB HBM3 at 700 W): the points
// fit's 30 000 x 30 000 at K=1 in 0.44 ms against a 0.24 ms bound (8.1 G
// operations), where the instruction rate caps the loop near 3*D + 2
// instructions a pair (the compare and the update) plus the shared loads;
// the chamfer fit's 5000 x 5000 in 0.019 ms, two launches' latency against
// a 0.007 ms bound; 16384 x 16384 at K=16 in 1.1 ms, where a warp runs the insertion
// whenever one lane's candidate enters (knn_study.py sweeps the cut).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // database points staged per pass
constexpr int kMaxD = 8;

// Queries per thread for each K bucket: as many as the registers take.
template <int KB>
struct Queries {
  static constexpr int value = KB <= 2 ? 4 : (KB <= 8 ? 2 : 1);
};

// Insert (dist, id) into the ascending list (bd, bi) of the K best, in
// front of the first strictly larger distance; `worst` becomes the K-th.
// Every slot takes its new value from its old one, its left neighbour's or
// the candidate's at once (no chain through the slots); slots at or past
// the runtime K take values that are never read.  Callers insert only a
// distance below `worst`.
template <int KB>
__device__ __forceinline__ void insert(float (&bd)[KB], int (&bi)[KB], float& worst, int K,
                                       float dist, int id) {
  if (KB == 1) {  // the caller has checked dist < worst = bd[0]
    bd[0] = dist;
    bi[0] = id;
    worst = dist;
    return;
  }
  bool larger[KB];  // bd[k] > dist: false up to the insertion slot, true from it on
#pragma unroll
  for (int k = 0; k < KB; ++k) larger[k] = dist < bd[k];
#pragma unroll
  for (int k = KB - 1; k >= 0; --k) {
    if (larger[k]) {
      const bool shifted = k > 0 && larger[k > 0 ? k - 1 : 0];
      bd[k] = shifted ? bd[k > 0 ? k - 1 : 0] : dist;
      bi[k] = shifted ? bi[k > 0 ? k - 1 : 0] : id;
    }
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k == K - 1) worst = bd[k];
  }
}

// DT: the point dimension where it is 3, 0 for a runtime D <= kMaxD.
template <int KB, int DT, bool L1>
__global__ void __launch_bounds__(kThreads)
knn_ranges_kernel(const float* __restrict__ p1,       // (N, P1, D)
                  const float* __restrict__ p2,       // (N, P2, D)
                  const int* __restrict__ lengths2,   // (N,) or null
                  int P1, int P2, int D, int K, int L, int S,
                  float* __restrict__ out_d,          // (N, S, P1, K)
                  int* __restrict__ out_i)            // (N, S, P1, K)
{
  constexpr int Q = Queries<KB>::value;
  constexpr int MD = DT > 0 ? DT : kMaxD;
  __shared__ float s_db[MD][kChunk];

  const int dim = DT > 0 ? DT : D;
  const int n = blockIdx.z;
  const int s = blockIdx.y;
  int count = P2;
  if (lengths2 != nullptr) count = min(max(lengths2[n], 0), P2);
  const int lo = s * L;
  const int hi = min(lo + L, count);  // empty where lengths2 ends before the range
  const int first = blockIdx.x * (kThreads * Q) + threadIdx.x;

  float q[Q][MD];
  float bd[Q][KB];
  int bi[Q][KB];
  float worst[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int i = first + j * kThreads;
    const float* qp = p1 + (static_cast<long long>(n) * P1 + (i < P1 ? i : 0)) * dim;
#pragma unroll
    for (int d = 0; d < MD; ++d) q[j][d] = (i < P1 && d < dim) ? qp[d] : 0.0f;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      bd[j][k] = INFINITY;
      bi[j][k] = 0;
    }
    worst[j] = INFINITY;
  }

  const float* db = p2 + static_cast<long long>(n) * P2 * dim;
  for (int base = lo; base < hi; base += kChunk) {
    const int m = min(kChunk, hi - base);
    __syncthreads();  // the previous chunk has been consumed
    if (threadIdx.x < m) {
      const float* pt = db + static_cast<long long>(base + threadIdx.x) * dim;
#pragma unroll
      for (int d = 0; d < MD; ++d) {
        if (d < dim) s_db[d][threadIdx.x] = pt[d];
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < m; ++t) {
      float c[MD];
#pragma unroll
      for (int d = 0; d < MD; ++d) c[d] = d < dim ? s_db[d][t] : 0.0f;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        float dist = 0.0f;
#pragma unroll
        for (int d = 0; d < MD; ++d) {
          if (d < dim) {
            const float diff = q[j][d] - c[d];
            const float term = L1 ? fabsf(diff) : diff * diff;
            dist = d == 0 ? term : dist + term;
          }
        }
        if (dist < worst[j]) insert<KB>(bd[j], bi[j], worst[j], K, dist, base + t);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int i = first + j * kThreads;
    if (i >= P1) continue;
    const long long o = ((static_cast<long long>(n) * S + s) * P1 + i) * K;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        out_d[o + k] = bd[j][k];
        out_i[o + k] = bi[j][k];
      }
    }
  }
}

// One thread per query: the S range lists in range order, by the insertion
// rule of stage 1, into the (N, P1, K) outputs.
template <int KB>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d,  // (N, S, P1, K)
                 const int* __restrict__ part_i,    // (N, S, P1, K)
                 long long queries, int P1, int K, int S,
                 float* __restrict__ out_d,         // (N, P1, K)
                 int* __restrict__ out_i)           // (N, P1, K)
{
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= queries) return;
  const long long n = t / P1;
  const long long i = t - n * P1;
  float bd[KB];
  int bi[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    bd[k] = INFINITY;
    bi[k] = 0;
  }
  float worst = INFINITY;
  // Lists in groups of 8: their first entries are loaded together, and a
  // list is walked further only while its entries still enter.
  constexpr int kGroup = 8;
  for (int s0 = 0; s0 < S; s0 += kGroup) {
    float head[kGroup];
    int head_id[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const long long o = ((n * S + s0 + u) * P1 + i) * K;
      head[u] = s0 + u < S ? part_d[o] : INFINITY;
      head_id[u] = s0 + u < S ? part_i[o] : 0;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (!(head[u] < worst)) continue;  // the list is sorted: nothing of it enters
      insert<KB>(bd, bi, worst, K, head[u], head_id[u]);
      const long long o = ((n * S + s0 + u) * P1 + i) * K;
      for (int k = 1; k < K; ++k) {
        const float d = part_d[o + k];
        if (!(d < worst)) break;
        insert<KB>(bd, bi, worst, K, d, part_i[o + k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k < K) {
      out_d[t * K + k] = bd[k];
      out_i[t * K + k] = bi[k];
    }
  }
}

template <int KB, int DT, bool L1>
cudaError_t launch(const float* p1, const float* p2, const int* lengths2, int N, int P1, int P2,
                   int D, int K, int S, int L, float* part_d, int* part_i, float* out_d,
                   int* out_i, cudaStream_t stream) {
  constexpr int per_block = kThreads * Queries<KB>::value;
  const dim3 grid((P1 + per_block - 1) / per_block, S, N);
  if (S == 1) {
    knn_ranges_kernel<KB, DT, L1><<<grid, kThreads, 0, stream>>>(p1, p2, lengths2, P1, P2, D, K,
                                                                 L, S, out_d, out_i);
    return cudaGetLastError();
  }
  knn_ranges_kernel<KB, DT, L1><<<grid, kThreads, 0, stream>>>(p1, p2, lengths2, P1, P2, D, K, L,
                                                               S, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long queries = static_cast<long long>(N) * P1;
  knn_merge_kernel<KB><<<static_cast<unsigned>((queries + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(part_d, part_i, queries, P1, K, S, out_d, out_i);
  return cudaGetLastError();
}

template <int KB>
cudaError_t launch_bucket(const float* p1, const float* p2, const int* lengths2, int N, int P1,
                          int P2, int D, int K, bool l1, int S, int L, float* part_d,
                          int* part_i, float* out_d, int* out_i, cudaStream_t stream) {
#define P3D_LAUNCH(DT, L1)                                                                      \
  return launch<KB, DT, L1>(p1, p2, lengths2, N, P1, P2, D, K, S, L, part_d, part_i, out_d, out_i, \
                            stream)
  if (D == 3) {
    if (l1) P3D_LAUNCH(3, true);
    P3D_LAUNCH(3, false);
  }
  if (l1) P3D_LAUNCH(0, true);
  P3D_LAUNCH(0, false);
#undef P3D_LAUNCH
}

}  // namespace

// Queries one block of stage 1 holds at K (threads x queries per thread),
// which the wrapper's range planner must use.
extern "C" int knn_block_queries(int K) {
  if (K <= 1) return kThreads * Queries<1>::value;
  if (K <= 2) return kThreads * Queries<2>::value;
  if (K <= 4) return kThreads * Queries<4>::value;
  if (K <= 8) return kThreads * Queries<8>::value;
  return kThreads * Queries<16>::value;
}

// Both stages on `stream`: the database cut into S ranges of L points (the
// last may be shorter; none is empty), part_d / part_i the (N, S, P1, K)
// scratch (unused where S = 1).  Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for a shape, norm or
// cut this build does not take.
extern "C" int knn_points(const float* p1, const float* p2, const int* lengths2, int N,
                          int P1, int P2, int D, int K, int norm, int S, int L, float* part_d,
                          int* part_i, float* dists, int* idx, void* stream) {
  if (N < 1 || N > 65535 || P1 < 1 || P2 < 1 || D < 1 || D > kMaxD || K < 1 || K > 16 ||
      (norm != 1 && norm != 2) || S < 1 || S > 65535 || L < 1 ||
      static_cast<long long>(S - 1) * L >= P2 || static_cast<long long>(S) * L < P2 ||
      (S > 1 && (part_d == nullptr || part_i == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool l1 = norm == 1;
  cudaError_t err;
#define P3D_LAUNCH(KB) \
  err = launch_bucket<KB>(p1, p2, lengths2, N, P1, P2, D, K, l1, S, L, part_d, part_i, dists, idx, s)
  if (K <= 1) P3D_LAUNCH(1);
  else if (K <= 2) P3D_LAUNCH(2);
  else if (K <= 4) P3D_LAUNCH(4);
  else if (K <= 8) P3D_LAUNCH(8);
  else P3D_LAUNCH(16);
#undef P3D_LAUNCH
  return static_cast<int>(err);
}
