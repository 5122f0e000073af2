// Points rasterizer for Hopper (sm_90a): per pixel, the K nearest-in-z
// points whose disc covers its center, with their z and squared distance.
//
// Replaces the TPU kernel `_fine_kernel`
// (pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:285, launched by
// the pallas_call at :497 in `_rpf_fwd`, :466, behind
// `rasterize_points_fragments_pallas`, :428).  It computes the same function
// as the plain PyTorch version `rasterize_points_plain`
// (pytorch3d_tpu_torch/renderer/points/rasterize_points.py): for every pixel
// of every cloud the K live points with z >= 0 and
// (px - x)^2 + (py - y)^2 < r^2, ascending in z with ties to the lower point
// id, and for each of them the local id, z and that squared distance; empty
// slots hold id -1, zbuf -1 and dists -1.
//
// Design.  The binning ahead of the kernel (torch, in the wrapper) gives
// each 16x16 pixel tile of each cloud the exact list of live points
// (z >= 0) whose box, center +- |radius| grown by half a pixel, reaches a
// pixel center of the tile, in ascending point id (a CSR list:
// tile_start/tile_points).  One block of 256 threads rasterizes one tile of
// one cloud, one thread per pixel, and one launch covers all N clouds.  The
// block stages its list in chunks of 256 points (x, y, z, r, id) in shared
// memory; every thread walks the chunk in id order and keeps a K-deep
// ascending buffer of (z, id, d2) in registers.  A candidate goes in front
// of the first slot with a strictly larger z, so with points walked in
// ascending id an equal z keeps the lower id first, as the plain version's
// stable sorts do (and the TPU body's strict `<`, :339).  K is a template
// bucket (1..64); the runtime K masks the live prefix.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32).  The
// function needs, for each live point, a test of every pixel center inside
// its box, 6 operations each (two differences, two products, their sum and
// the compare with r^2; built without FMA contraction each issues on its
// own, at half the data sheet's rate), and it reads 17 B per point and
// writes 12 B per slot.  The bytes bind at every shape chip_smoke.py runs:
// at the points-serving batch (8 clouds of 30 000 points, 256^2,
// r = 0.006, K = 10) the 67 MB of fragments (0.020 ms); at points-bench
// (100 000 points, r = 0.01, K = 8) 8.0 MB (0.0024 ms), against 0.66 M box
// tests.  The kernel tests more than that: every pixel of a tile against
// every point of its list (65 M and 43 M pairs there).  On an "NVIDIA H100
// 80GB HBM3, 700.00 W" the profiler put its device time at 0.231 and
// 0.082 ms there, 11.5x and 34x the bound, and the torch binning ahead of it
// took ~2.7 ms.  The lists are read once per block, and each thread writes
// its K slots of each output as one contiguous run.  The distance is computed as the plain
// version writes it, (px-x)*(px-x) + (py-y)*(py-y) against r*r with a strict
// `<`, from the same pixel centers, and --fmad=false keeps every product
// rounded on its own: coverage, d2 and with them the ids match the plain
// version bit for bit, which the backward's gradient check relies on.
//
// Select only (#6).  The template flag kIdsOnly builds the same kernel for
// `select_points_cuda`, the counterpart of `select_from_binned`
// (rasterize_points_pallas.py:766, the same `_fine_kernel` select-only, its
// pallas_call at :791), which picks pulsar's n_track spheres per pixel: the
// selection is this kernel's, so its ids equal the fragments kernel's on
// the same binning; the zbuf and dists stores (8 of the 12 bytes per slot)
// are left out.  Pulsar's valid mask is min_depth < z < max_depth, and the
// kernel, as the plain version, also drops z < 0 (the binning does): the
// two agree whenever min_depth >= 0.  What bounds it at pulsar-serving
// (100 000 spheres, 1024^2, K = 5): the box tests (chip_smoke.py counts
// them from the run's own inputs) against the ids' 21 MB.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;

template <int KB, bool kIdsOnly>
__global__ void __launch_bounds__(kThreads)
rasterize_points_kernel(const float* __restrict__ points,     // (N*P, 3)
                        const float* __restrict__ radius,     // (N*P,)
                        const int* __restrict__ tile_points,  // (pairs,) local ids
                        const int* __restrict__ tile_start,   // (N*n_ty*n_tx + 1,)
                        const float* __restrict__ xs,         // (W,) NDC x of columns
                        const float* __restrict__ ys,         // (H,) NDC y of rows
                        int P, int H, int W, int n_ty, int n_tx, int K,
                        int* __restrict__ out_idx,     // (N, H, W, K)
                        float* __restrict__ out_z,     // (N, H, W, K)
                        float* __restrict__ out_dist)  // (N, H, W, K)
{
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads], s_r2[kThreads];
  __shared__ int s_id[kThreads];

  const int tile = blockIdx.x;
  const int tiles_per_image = n_ty * n_tx;
  const int n = tile / tiles_per_image;
  const int t = tile - n * tiles_per_image;
  const int ty = t / n_tx;
  const int tx = t - ty * n_tx;
  const int row = ty * kTileH + threadIdx.y;
  const int col = tx * kTileW + threadIdx.x;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const bool live = row < H && col < W;
  const float px = live ? xs[col] : 0.0f;
  const float py = live ? ys[row] : 0.0f;

  float bz[KB], bd[KB];
  int bi[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    bz[k] = INFINITY;
    bd[k] = 0.0f;
    bi[k] = -1;
  }

  const size_t first = static_cast<size_t>(n) * P;
  const int begin = tile_start[tile];
  const int end = tile_start[tile + 1];
  for (int base = begin; base < end; base += kThreads) {
    const int m = min(kThreads, end - base);
    __syncthreads();  // the previous chunk has been consumed
    if (tid < m) {
      const int p = tile_points[base + tid];
      const size_t g = first + p;
      s_id[tid] = p;
      s_x[tid] = points[3 * g + 0];
      s_y[tid] = points[3 * g + 1];
      s_z[tid] = points[3 * g + 2];
      const float r = radius[g];
      s_r2[tid] = r * r;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      const float dx = px - s_x[j];
      const float dy = py - s_y[j];
      const float d2 = dx * dx + dy * dy;
      if (!(d2 < s_r2[j])) continue;

      // Insert in front of the first slot with a strictly larger z, then
      // shift the rest of the live prefix down by one.
      float cz = s_z[j], cd = d2;
      int ci = s_id[j];
      bool shifting = false;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < K && (shifting || cz < bz[k])) {
          shifting = true;
          float tz = bz[k]; bz[k] = cz; cz = tz;
          float td = bd[k]; bd[k] = cd; cd = td;
          int ti = bi[k]; bi[k] = ci; ci = ti;
        }
      }
    }
  }
  if (!live) return;

  const size_t pix = (static_cast<size_t>(n) * H + row) * W + col;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k < K) {
      const size_t o = pix * K + k;
      const bool empty = bi[k] < 0;
      out_idx[o] = bi[k];
      if (kIdsOnly) continue;
      out_z[o] = empty ? -1.0f : bz[k];
      out_dist[o] = empty ? -1.0f : bd[k];
    }
  }
}

template <int KB, bool kIdsOnly>
void launch(const float* points, const float* radius, const int* tile_points,
            const int* tile_start, const float* xs, const float* ys, int N, int P,
            int H, int W, int n_ty, int n_tx, int K, int* idx, float* z, float* dist,
            cudaStream_t stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid(static_cast<unsigned>(N) * n_ty * n_tx);
  rasterize_points_kernel<KB, kIdsOnly><<<grid, block, 0, stream>>>(
      points, radius, tile_points, tile_start, xs, ys, P, H, W, n_ty, n_tx, K, idx,
      z, dist);
}

}  // namespace

// The pixel tile (rows, cols) of one block, which the binning must use.
extern "C" void rasterize_points_tile(int* rows, int* cols) {
  *rows = kTileH;
  *cols = kTileW;
}

namespace {

template <bool kIdsOnly>
int dispatch(const float* points, const float* radius, const int* tile_points,
             const int* tile_start, const float* xs, const float* ys, int N, int P, int H,
             int W, int n_ty, int n_tx, int K, int* idx, float* z, float* dist,
             void* stream) {
  if (K < 1 || K > 64 || N < 1 || P < 1 ||
      static_cast<long long>(N) * n_ty * n_tx > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_LAUNCH(KB)                                                           \
  launch<KB, kIdsOnly>(points, radius, tile_points, tile_start, xs, ys, N, P, H, W, \
                       n_ty, n_tx, K, idx, z, dist, s)
  if (K <= 1) P3D_LAUNCH(1);
  else if (K <= 2) P3D_LAUNCH(2);
  else if (K <= 4) P3D_LAUNCH(4);
  else if (K <= 8) P3D_LAUNCH(8);
  else if (K <= 16) P3D_LAUNCH(16);
  else if (K <= 32) P3D_LAUNCH(32);
  else P3D_LAUNCH(64);
#undef P3D_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when K, N or the grid is not one this build takes.
extern "C" int rasterize_points(const float* points, const float* radius,
                                const int* tile_points, const int* tile_start,
                                const float* xs, const float* ys, int N, int P, int H,
                                int W, int n_ty, int n_tx, int K, int* idx, float* z,
                                float* dist, void* stream) {
  return dispatch<false>(points, radius, tile_points, tile_start, xs, ys, N, P, H, W,
                         n_ty, n_tx, K, idx, z, dist, stream);
}

// The select-only build (#6): the same launch without the zbuf and dists
// stores.
extern "C" int select_points(const float* points, const float* radius,
                             const int* tile_points, const int* tile_start,
                             const float* xs, const float* ys, int N, int P, int H, int W,
                             int n_ty, int n_tx, int K, int* idx, void* stream) {
  return dispatch<true>(points, radius, tile_points, tile_start, xs, ys, N, P, H, W,
                        n_ty, n_tx, K, idx, nullptr, nullptr, stream);
}
