// Backward of the points rasterizer for Hopper (sm_90a): the gradient of
// (zbuf, dists) with respect to the points, given the forward's per-pixel
// point ids and the cotangents of the two outputs.
//
// Replaces the TPU kernel `_grad_kernel`
// (pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:365, launched by
// the pallas_call at :562 in `_rpf_bwd`, :531).  It computes the same
// function as the plain PyTorch version `rasterize_points_grad_plain`
// (pytorch3d_tpu_torch/renderer/points/rasterize_points.py): autograd's
// reverse of `recompute_point_fragments`, where a filled slot holding point
// p at pixel (px, py) has zbuf = z_p and dists = (px - x_p)^2 + (py - y_p)^2,
// so it adds gz to dz_p, -2 (px - x_p) gd to dx_p and -2 (py - y_p) gd to
// dy_p.  Empty slots (id < 0) add nothing, nor does a slot whose two
// cotangents are zero, and the radius gets no gradient.  2 * (gd * dx)
// equals autograd's gd * dx + gd * dx exactly.
//
// Design: per-tile point sums, then a fixed-order sum per point; no
// atomics, so two runs give the same bits (#4's design, csrc/
// rasterize_grad.cu, and #8's, csrc/pulsar_grad.cu).  The TPU kernel
// reduces per tile slot over a sequential grid and then takes a
// segment_sum per point; here the forward's binning (`bin_points`: 16x16
// pixel tiles, each with the exact list of the points that may cover it,
// ascending id) gives every (tile, point) pair a row of a (pairs, 3) table.
//
// Pass 1 (`rasterize_points_grad_tiles_kernel`): one block of 256 threads
// per tile and list chunk, warp w on the tile's rows 2w and 2w + 1.  A
// warp reads its 32 pixels' slot ids 4 x 32 at a time in memory order (a
// row's 16 pixels x K slots are contiguous), and the lanes whose slot is
// filled append its offset to the warp's ring in shared memory, so that the
// ~94 % of empty slots at the points-fit step cost no lane of the
// differentiation.  Every 32 queued slots, one per lane, read their
// cotangents, find their point's position in the tile's list (a binary
// search in shared memory, where the pass also stages the list's x and y)
// and take their three partials.  The warp then sorts its lanes by (list
// position, lane) with a bitonic network of shuffles and sums each run of
// one position with a segmented scan; the run's last lane adds the sum to
// the warp's own row of that position.  After the walk the block adds the
// 8 warps' rows in warp order and writes the tile's rows of the table.  A
// list longer than kListChunk points is summed kListChunk positions a
// pass, each pass taking the slots whose id falls in its part of the list
// (the points-fit step's lists run to 630 points, points-bench's to 880:
// three and four passes).  The passes of a tile go to kSplits blocks
// (blockIdx.y; a block past the list's end returns at once), so that the
// dense tiles, whose lists are long and whose slots are nearly all filled,
// do not hold up the launch's end one pass after another.
//
// Pass 2 (`rasterize_points_grad_points_kernel`): one thread per (point,
// component) adds the point's rows in ascending tile order, through the
// point-major CSR of the rows the wrapper builds (`face_pair_rows`, a
// stable sort of the pairs by point, on the device without a host sync).
//
// A filled slot whose point is missing from its tile's list (the forward
// rasterizes over the same binning, so the path makes none) flags the
// point, and an id >= P flags every point of its cloud; pass 2 writes NaN
// into a flagged point's row, so the fault shows in the gradient without a
// host sync (#4 reads an error flag on the host instead, ~1.9 ms a
// render-fit step, and the points-fit step is host-bound).
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32, half
// of that without FMA contraction).  The function reads every slot's id
// (4 bytes), the given cotangents at the filled slots (4 bytes each), x
// and y of each point a filled slot holds with gd != 0 and writes the
// (N*P, 3) gradient; it does 9 operations per filled slot (two
// differences, two products by gd, two by -2 and three sums).  The bytes
// bind: 0.0079 ms at the points-fit step (8 x 256^2, K = 10, 6 % of the
// slots filled) and 0.0022 ms at points-bench (100 000 points, K = 8), by
// chip_smoke.py's count.  The design before this one (3144b18) took one
// thread per (pixel, slot) with three fp32 atomic adds per filled slot
// into a zeroed buffer, in an order that changed from run to run.  On an
// "NVIDIA H100 80GB HBM3, 700.00 W" (raster_study.py points-grad, both in
// one call, profiler device time) that build took 0.031 and 0.018 ms
// there; the two passes here take 0.055 and 0.030 ms (pass 2 0.008 and
// 0.005), 1.6-1.8x as long, and the wrapper's pair CSR (torch.sort of
// ~250 000 pairs) and flag fill bring the call to 0.134 and 0.089 ms.
// Pass 1 is latency-bound: a warp sum through shared-memory atomics
// instead of the sort and scan (not deterministic) saves only ~10 %, and
// with one block a tile the dense tiles' passes made it 12-39 % slower.
// ptxas: pass 1 40 registers, 12 / 20 bytes spilled, 35 840 bytes of
// shared memory (six blocks an SM); pass 2 32 registers.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;
constexpr int kWarps = kThreads / 32;
constexpr int kListChunk = 256;  // tile-list positions whose sums one pass holds
constexpr int kLoads = 4;        // 32-slot groups whose ids a warp loads at once
constexpr int kQueue = 256;      // a warp's ring of queued slots (31 + 4 x 32 at most)
constexpr int kSplits = 3;       // blocks that share a tile's passes
constexpr unsigned kFull = 0xffffffffu;

// The position of `id` in the ascending list[0, m), or -1.
__device__ __forceinline__ int find(const int* list, int m, int id) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < id) lo = mid + 1;
    else hi = mid;
  }
  return lo < m && list[lo] == id ? lo : -1;
}

__global__ void __launch_bounds__(kThreads)
rasterize_points_grad_tiles_kernel(const float* __restrict__ points,      // (N*P, 3)
                                   const int* __restrict__ tile_points,   // (pairs,) local ids
                                   const int* __restrict__ tile_start,    // (N*n_ty*n_tx + 1,)
                                   const int* __restrict__ idx,           // (N, H, W, K) local ids
                                   const float* __restrict__ gz,          // (N, H, W, K) or null
                                   const float* __restrict__ gdists,      // (N, H, W, K) or null
                                   const float* __restrict__ xs,          // (W,) NDC x of columns
                                   const float* __restrict__ ys,          // (H,) NDC y of rows
                                   int N, int P, int H, int W, int K, int n_ty, int n_tx,
                                   float* __restrict__ gpair,  // (pairs, 3)
                                   int* __restrict__ flagged)  // (N*P + N,): a missing point; [N*P + n]: cloud n
{
  __shared__ int s_id[kListChunk];
  __shared__ float s_x[kListChunk];
  __shared__ float s_y[kListChunk];
  __shared__ float s_acc[kWarps][kListChunk * 3];
  __shared__ int s_queue[kWarps][kQueue];  // slot offsets within the warp's 32 pixels x K

  const int tile = blockIdx.x;
  const int n = tile / (n_ty * n_tx);
  const int ty = (tile - n * n_ty * n_tx) / n_tx;
  const int tx = tile - n * n_ty * n_tx - ty * n_tx;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int row0 = ty * kTileH + 2 * warp;  // the warp's first row
  const int col0 = tx * kTileW;
  const int cols = min(kTileW, W - col0);  // live columns of the tile
  const int span = 32 * K;                 // the warp's slots: 2 rows x 16 pixels x K
  const float* pts = points + static_cast<long long>(n) * P * 3;
  float* acc = s_acc[warp];
  int* queue = s_queue[warp];
  const int begin = tile_start[tile];
  const int end = tile_start[tile + 1];

  // Slot e of the warp (pixel e / K, depth e % K; pixel p at row p >> 4,
  // column p & 15): whether it lies in the image, and its offset into the
  // (N, H, W, K) arrays.
  auto live = [&](int e) {
    const int p = e / K;
    return e < span && row0 + (p >> 4) < H && (p & 15) < cols;
  };
  auto offset = [&](int e) -> long long {
    const int p = e / K;
    return ((static_cast<long long>(n) * H + row0 + (p >> 4)) * W + col0 + (p & 15)) * K + (e - p * K);
  };

  // Differentiate 32 queued slots from ring position `head` (the first
  // `count` of them live), one per lane, and add their partials per point
  // to the warp's rows of the list chunk s_id[0, m): the lanes are sorted
  // by (list position, lane), then a segmented scan sums each run of one
  // position, and the run's last lane adds it to the row.  Fixed shuffles
  // whatever the points, and a fixed order: two runs agree bit for bit.
  auto sum_queued = [&](int head, int count, int m) {
    int pos = -1;  // the slot's list position; -1: no work
    float g[3] = {0.0f, 0.0f, 0.0f};
    if (lane < count) {
      const int e = queue[(head + lane) & (kQueue - 1)];
      const long long o = offset(e);
      const int p = idx[o];
      const float g_z = gz != nullptr ? gz[o] : 0.0f;
      const float g_d = gdists != nullptr ? gdists[o] : 0.0f;
      if (g_z != 0.0f || g_d != 0.0f) {
        pos = find(s_id, m, p);
        if (pos < 0) {
          flagged[static_cast<long long>(n) * P + p] = 1;
        } else if (g_d != 0.0f) {
          const int pix = e / K;
          const float dx = xs[col0 + (pix & 15)] - s_x[pos];
          const float dy = ys[row0 + (pix >> 4)] - s_y[pos];
          g[0] = -2.0f * (g_d * dx);
          g[1] = -2.0f * (g_d * dy);
        }
        g[2] = g_z;
      }
    }
    // Bitonic sort of the keys (pos, lane) across the warp, ascending;
    // lanes without work last.
    int key = pos >= 0 ? (pos << 5) | lane : INT_MAX;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int other = __shfl_xor_sync(kFull, key, j);
        key = (((lane & j) == 0) == ((lane & k) == 0)) ? min(key, other) : max(key, other);
      }
    }
    const int mine = key == INT_MAX ? -1 : key >> 5;
    const int src = key & 31;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = __shfl_sync(kFull, g[c], src);
      if (mine < 0) v[c] = 0.0f;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up_pos = __shfl_up_sync(kFull, mine, d);  // every lane takes part
      const bool join = lane >= d && up_pos == mine;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float up = __shfl_up_sync(kFull, v[c], d);
        if (join) v[c] += up;
      }
    }
    const int next = __shfl_down_sync(kFull, mine, 1);
    if (mine >= 0 && (lane == 31 || next != mine)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[mine * 3 + c] += v[c];
    }
    __syncwarp();
  };

  // One pass per chunk of up to kListChunk list positions (one pass for an
  // empty list, whose filled slots can only be faults), the tile's kSplits
  // blocks taking every kSplits-th chunk from their own.  Pass c takes the
  // slots whose id lies in [its first id, the next chunk's first id), so
  // every slot with work is taken by exactly one pass.
  const int stride = gridDim.y * kListChunk;
  if (blockIdx.y > 0 && begin + static_cast<int>(blockIdx.y) * kListChunk >= end) return;  // no chunk of its own
  for (int c0 = begin + blockIdx.y * kListChunk;; c0 += stride) {
    const int m = max(0, min(kListChunk, end - c0));
    __syncthreads();  // the previous pass's rows are written
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const int p = tile_points[c0 + j];
      s_id[j] = p;
      s_x[j] = pts[3 * p + 0];
      s_y[j] = pts[3 * p + 1];
    }
    for (int e = lane; e < m * 3; e += 32) acc[e] = 0.0f;
    __syncthreads();
    const int lo_id = c0 == begin ? INT_MIN : s_id[0];
    const int hi_id = c0 + m < end ? tile_points[c0 + m] : INT_MAX;  // exclusive
    int head = 0, queued = 0;
    for (int e0 = 0; e0 < span; e0 += kLoads * 32) {
      int p[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * 32 + lane;
        p[u] = live(e) ? idx[offset(e)] : -1;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (p[u] >= P) flagged[static_cast<long long>(N) * P + n] = 1;  // no such point
        const bool take = p[u] >= 0 && p[u] < P && p[u] >= lo_id && p[u] < hi_id;
        const unsigned took = __ballot_sync(kFull, take);
        if (take) queue[(head + queued + __popc(took & below)) & (kQueue - 1)] = e0 + u * 32 + lane;
        queued += __popc(took);
      }
      __syncwarp();
      while (queued >= 32) {
        sum_queued(head, 32, m);
        head += 32;
        queued -= 32;
      }
    }
    if (queued > 0) sum_queued(head, queued, m);
    __syncthreads();
    // The tile's rows: the warps' sums in warp order.
    for (int e = threadIdx.x; e < m * 3; e += kThreads) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_acc[w][e];
      gpair[static_cast<long long>(c0) * 3 + e] = sum;
    }
    if (c0 + stride >= end) break;
  }
}

// One thread per (point, component): the point's rows in ascending tile
// order; NaN where the point or its cloud is flagged.
__global__ void __launch_bounds__(kThreads)
rasterize_points_grad_points_kernel(const float* __restrict__ gpair,       // (pairs, 3)
                                    const int* __restrict__ pair_rows,     // (pairs,) point-major
                                    const int* __restrict__ point_start,   // (N*P + 1,)
                                    const int* __restrict__ flagged,       // (N*P + N,)
                                    int P, long long points,
                                    float* __restrict__ grad)              // (N*P, 3)
{
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= points * 3) return;
  const long long g = i / 3;
  const int c = static_cast<int>(i - g * 3);
  float sum = 0.0f;
  for (int q = point_start[g]; q < point_start[g + 1]; ++q) {
    sum += gpair[static_cast<long long>(pair_rows[q]) * 3 + c];
  }
  grad[i] = (flagged[g] | flagged[points + g / P]) ? __int_as_float(0x7fc00000) : sum;
}

}  // namespace

// The pixel tile (rows, cols) of one block of pass 1, which the binning
// must use.
extern "C" void rasterize_points_grad_tile(int* rows, int* cols) {
  *rows = kTileH;
  *cols = kTileW;
}

// Both passes on `stream`: writes every entry of `grad` (N*P*3 floats).
// gpair is the wrapper's (max(pairs, 1), 3) scratch and flagged its
// (N*P + N,) int32 zeros.  Returns cudaGetLastError() after the launches
// (0 on success), or cudaErrorInvalidValue for a shape this build does not
// take.
extern "C" int rasterize_points_grad(const float* points, const int* tile_points,
                                     const int* tile_start, const int* pair_rows,
                                     const int* point_start, const int* idx, const float* gz,
                                     const float* gdists, const float* xs, const float* ys, int N,
                                     int P, int H, int W, int K, int n_ty, int n_tx, float* gpair,
                                     int* flagged, float* grad, void* stream) {
  const long long n_tiles = static_cast<long long>(N) * n_ty * n_tx;
  if (N < 1 || P < 1 || H < 1 || W < 1 || K < 1 || K > 64 ||
      n_ty != (H + kTileH - 1) / kTileH || n_tx != (W + kTileW - 1) / kTileW ||
      n_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rasterize_points_grad_tiles_kernel<<<dim3(static_cast<unsigned>(n_tiles), kSplits), kThreads, 0, s>>>(
      points, tile_points, tile_start, idx, gz, gdists, xs, ys, N, P, H, W, K, n_ty, n_tx, gpair,
      flagged);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long points_total = static_cast<long long>(N) * P;
  rasterize_points_grad_points_kernel<<<static_cast<unsigned>((points_total * 3 + kThreads - 1) / kThreads),
                                        kThreads, 0, s>>>(gpair, pair_rows, point_start, flagged, P,
                                                          points_total, grad);
  return static_cast<int>(cudaGetLastError());
}
