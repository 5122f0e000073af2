// Points rasterizer for Hopper (sm_90a): per pixel, the K nearest-in-z
// points whose disc covers its center, with their z and squared distance.
//
// Replaces two builds of the TPU kernel `_fine_kernel`
// (pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:285): the
// fragments build, launched by the pallas_call at :497 in `_rpf_fwd` (:466,
// behind `rasterize_points_fragments_pallas`, :428), and the select-only
// build of `select_from_binned` (:766, its pallas_call at :791).  It
// computes the same function as the plain PyTorch version
// `rasterize_points_plain` (pytorch3d_tpu_torch/renderer/points/
// rasterize_points.py): for every pixel of every cloud the K live points
// with z >= 0 and (px - x)*(px - x) + (py - y)*(py - y) < r*r, ascending in
// z with ties to the lower point id, and for each of them the local id, z
// and that squared distance; empty slots hold id -1, zbuf -1 and dists -1.
//
// Design.  The binning ahead of the kernel (torch, in the wrapper) gives
// each 16x16 pixel tile of each cloud the exact list of live points
// (z >= 0) whose box, center +- |radius| grown by half a pixel, reaches a
// pixel center of the tile, in ascending point id (a CSR list:
// tile_start/tile_points).  One block of 256 threads rasterizes one tile of
// one cloud, one thread per pixel, warp w on a 4-row x 8-column rectangle
// of the tile, and one launch covers all N clouds.  The block stages its
// list in chunks of 256 points ((x, y, r^2, z) and id) in shared memory.
// The thread that stages a point also finds its box within the tile, as
// two 16-bit masks: the rows and the columns whose pixel centre c passes
// the point's test on that axis alone, fl(c - v)^2 < r^2 (16 independent
// tests an axis; chip_smoke.py's torch `point_pixel_boxes` makes the same
// boxes over the whole image by the same float ops), and marks the warp
// rectangles the box meets.  Each warp then compacts, with a ballot, the
// chunk's points that meet its rectangle into a list in ascending id and
// walks only that list.  Every lane of the warp tests each point of the
// list: a lane outside the point's box fails the test itself (see below),
// and skipping it there costs more than the test it saves (raster_study.py
// points, the `lane_box` copy).  A pass goes into a K-deep ascending
// buffer of (z, id, d2) in registers: the candidate goes in front of the
// first slot with a strictly larger z (a parallel select over the slots,
// `insert`), so with points walked in ascending id an equal z keeps the
// lower id first, as the plain version's stable sorts do (and the TPU
// body's strict `<`, :339).  K runs in a template bucket (1, 2, 4, 5, 8,
// 10, 16, 32, 64): a slot's value depends only on the slots before it, so
// the slots past K need no mask and are never stored; buckets of 16 and 8
// for K = 10 and 5 cost 45-49 % at the serving batch and 35-48 % for
// pulsar, 12 and 6 cost 12-18 % (raster_study.py points).  After the last
// chunk each warp writes its rectangle's slots through shared memory, a
// piece of up to 10 slots (16 for ids only) of every output at a time,
// read back as runs of consecutive addresses (a pixel's slots one word
// further apart than their count, an odd stride, so that the lanes'
// writes fall in different banks), where a thread storing its own run of
// K slots would leave the lanes K x 4 bytes apart.
//
// Why the cull is exact.  A warp skips a point only where the point's box
// misses its rectangle, so a pair is dropped only where the pixel's row or
// column is outside the box.  Let dx = fl(px - x) and
// dy = fl(py - y), the values the test computes.  The test passes only if
// d2 = fl(fl(dx*dx) + fl(dy*dy)) < r2 = fl(r*r); rounding is monotone and
// fl(dy*dy) >= 0, so d2 >= fl(dx*dx), and a pass needs fl(dx*dx) < r2, and
// fl(dy*dy) < r2 alike: each axis's own test, which the box is, made on
// the same operands by the same operations (built with --fmad=false, as
// the whole file).  No slack for rounding is needed, unlike the binning's
// grown box, whose half pixel stops covering the rounding of
// x +- (|r| + half a pixel) once |x| nears 2^13 at 1024^2.  A NaN
// coordinate or radius, or r^2 = 0, fails every axis test, as it fails
// the test.  tests/test_torch_points_cull.py checks on the CPU that every
// pair the plain version covers lies in its point's box and in the
// binning's tiles.
//
// The test is the plain version's, operation for operation, with a strict
// `<`, from the same pixel centers, and the walk keeps ascending id, so
// coverage, d2 and with them the ids match the plain version and the
// design before the cull bit for bit (raster_study.py points checks the
// three outputs against that build); the backward's gradient check and
// pulsar's blend backward rely on those ids.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32).  The
// function needs, for each live point, a test of every pixel center inside
// its box, 6 operations each (two differences, two products, their sum and
// the compare with r^2; without FMA contraction each issues on its own, at
// half the data sheet's rate), and it reads 17 B per point and writes 12 B
// per slot.  The bytes bind at every shape chip_smoke.py runs: at the
// points-serving batch (8 clouds of 30 000 points, 256^2, r = 0.006,
// K = 10) 67 MB (0.020 ms); at points-bench (100 000 points, r = 0.01,
// K = 8) 8.0 MB (0.0024 ms), against 0.66 M box tests; at 10^6 points
// (1024^2, r = 0.003, K = 8) 118 MB (0.035 ms).  On an "NVIDIA H100 80GB
// HBM3, 700.00 W" (raster_study.py points, profiler device time) this
// kernel takes 0.077-0.079, 0.041 and 0.287 ms there: 3.9x, 17x and 8.2x
// the bound, where the design before the cull, which tested every pixel of
// a tile against the tile's whole list (65 M, 43 M and 441 M pairs) and
// stored each thread's own run of slots, took 0.231, 0.080 and 0.535 ms.
// Its warps walk 6.7 M, 5.3 M and 61 M lanes there, 6-17x the pairs in the
// boxes.  Without the cull it takes 1.6-2.1x as long, with a per-lane skip
// of the box 5-9 % longer, and with each thread's own stores 2.5x as long
// at the serving batch and 10-17 % longer at the other two.
//
// Select only (#6).  The template flag kIdsOnly builds the same kernel for
// `select_points_cuda`, the counterpart of `select_from_binned`, which
// picks pulsar's n_track spheres per pixel: the selection is this
// kernel's, so its ids equal the fragments kernel's on the same binning;
// the zbuf and dists stores (8 of the 12 bytes per slot) are left out, and
// the compiler drops the register buffers that fed them.  Pulsar's valid
// mask is min_depth < z < max_depth, and the kernel, as the plain version,
// also drops z < 0 (the binning does): the two agree whenever
// min_depth >= 0.  What bounds it at pulsar-serving (100 000 spheres,
// 1024^2, K = 5): the ids' 21 MB (0.0068 ms), against 8.7 M box tests.
// On the same card it takes 0.045 ms there (6.6x; the design before the
// cull 0.075) and 0.33-0.34 ms at 10^6 spheres (0.76-0.77).  With ids
// only the stores through shared memory cost more than they save: each
// thread storing its own 20 B run is 13 % faster at pulsar-serving and
// level at 10^6 spheres (one store path serves both builds, and the
// fragments build needs the shared one).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;
constexpr int kWarps = kThreads / 32;
constexpr int kRectH = 4;  // a warp's rectangle of the tile: 4 rows x 8 columns
constexpr int kRectW = 8;
constexpr int kRectsPerRow = kTileW / kRectW;
constexpr unsigned kFull = 0xffffffffu;

// The bits of the tile's pixel centres c[0, 16) on one axis (NaN past the
// image) whose own test fl(c - v)^2 < r2 passes: the point's box on that
// axis (see the header).
__device__ __forceinline__ unsigned axis_bits(const float* c, float v, float r2) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float d = c[i] - v;
    bits |= (d * d < r2 ? 1u : 0u) << i;
  }
  return bits;
}

// Insert a candidate (z, d2, id) in front of the first slot of the
// ascending buffer with a strictly larger z: slot k takes slot k-1's entry
// where the candidate goes above it, the candidate where it goes at k, and
// keeps its own otherwise.
template <int KB>
__device__ __forceinline__ void insert(float (&bz)[KB], float (&bd)[KB], int (&bi)[KB], float cz, float cd,
                                       int ci) {
#pragma unroll
  for (int k = KB - 1; k >= 0; --k) {
    const int up = k > 0 ? k - 1 : 0;
    const bool here = cz < bz[k];
    const bool above = k > 0 && cz < bz[up];
    if (above) {
      bz[k] = bz[up];
      bd[k] = bd[up];
      bi[k] = bi[up];
    } else if (here) {
      bz[k] = cz;
      bd[k] = cd;
      bi[k] = ci;
    }
  }
}

// Shared memory of a block: the chunk's points (x, y, r^2, z; the id; the
// warps whose rectangle the point's box meets), each warp's list of chunk
// positions and the tile's pixel centres; after the last chunk, each
// warp's buffer for its stores.
struct Stage {
  float4 pt[kThreads];  // x, y, r^2, z
  int id[kThreads];
  unsigned char mask[kThreads];
  unsigned char list[kWarps][kThreads];
  float cx[kTileW], cy[kTileH];
};
template <int KB, bool kIdsOnly>
struct StoreBuffers {
  static constexpr int kOutputs = kIdsOnly ? 1 : 3;
  static constexpr int kPiece = KB < (kIdsOnly ? 16 : 10) ? KB : (kIdsOnly ? 16 : 10);  // slots a piece
  static constexpr int kPlane = 32 * (kPiece + 1);  // words of one output's piece
  float buf[kWarps][kOutputs * kPlane];
};
template <int KB, bool kIdsOnly>
union Shared {
  Stage s;
  StoreBuffers<KB, kIdsOnly> b;
};

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
  __shared__ Shared<KB, kIdsOnly> shared;
  Stage& s = shared.s;

  const int tile = blockIdx.x;
  const int tiles_per_image = n_ty * n_tx;
  const int n = tile / tiles_per_image;
  const int t = tile - n * tiles_per_image;
  const int ty = t / n_tx;
  const int tx = t - ty * n_tx;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int tr = (warp / kRectsPerRow) * kRectH + lane / kRectW;  // the lane's pixel in the tile
  const int tc = (warp % kRectsPerRow) * kRectW + lane % kRectW;
  const int row0 = ty * kTileH, col0 = tx * kTileW;
  const int rows_tile = min(kTileH, H - row0), cols_tile = min(kTileW, W - col0);
  const bool live = tr < rows_tile && tc < cols_tile;
  const float px = live ? xs[col0 + tc] : 0.0f;
  const float py = live ? ys[row0 + tr] : 0.0f;
  if (tid < kTileW) s.cx[tid] = tid < cols_tile ? xs[col0 + tid] : NAN;
  if (tid >= 32 && tid < 32 + kTileH) s.cy[tid - 32] = tid - 32 < rows_tile ? ys[row0 + tid - 32] : NAN;

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
      const float x = points[3 * g + 0];
      const float y = points[3 * g + 1];
      const float r = radius[g];
      const float r2 = r * r;
      const unsigned rows = axis_bits(s.cy, y, r2);
      const unsigned cols = axis_bits(s.cx, x, r2);
      s.pt[tid] = make_float4(x, y, r2, points[3 * g + 2]);
      s.id[tid] = p;
      unsigned mask = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned rect_rows = ((1u << kRectH) - 1u) << ((w / kRectsPerRow) * kRectH);
        const unsigned rect_cols = ((1u << kRectW) - 1u) << ((w % kRectsPerRow) * kRectW);
        mask |= (rows & rect_rows) && (cols & rect_cols) ? 1u << w : 0u;
      }
      s.mask[tid] = static_cast<unsigned char>(mask);
    }
    __syncthreads();

    // The warp's list: the chunk's points whose box meets its rectangle, in
    // ascending chunk position (= ascending id).
    int count = 0;
    for (int g = 0; g < m; g += 32) {
      const int j = g + lane;
      const bool take = j < m && ((s.mask[j] >> warp) & 1u);
      const unsigned took = __ballot_sync(kFull, take);
      if (take) s.list[warp][count + __popc(took & below)] = static_cast<unsigned char>(j);
      count += __popc(took);
    }
    __syncwarp();

    // The walk.  Every lane tests: one outside the point's box fails the
    // test (see the header); a lane outside the image tests at (0, 0), and
    // its slots are never stored.
    for (int i = 0; i < count; ++i) {
      const int j = s.list[warp][i];
      const float4 q = s.pt[j];
      const float dx = px - q.x;
      const float dy = py - q.y;
      const float d2 = dx * dx + dy * dy;
      if (d2 < q.z) insert(bz, bd, bi, q.w, d2, s.id[j]);
    }
  }

  // Each warp writes its rectangle's slots through its buffer, over the
  // staging memory, which every warp has finished reading: kPiece slots of
  // its 32 pixels at a time, each output in its own plane, a pixel's slots
  // one word further apart than their count (an odd stride, so that the
  // lanes' writes fall in different banks), then read back and stored as
  // runs of consecutive addresses.
  __syncthreads();
  using Buffers = StoreBuffers<KB, kIdsOnly>;
  float* buf = shared.b.buf[warp];
  const int rect_r = (warp / kRectsPerRow) * kRectH, rect_c = (warp % kRectsPerRow) * kRectW;
  const size_t rect_base = ((static_cast<size_t>(n) * H + row0 + rect_r) * W + col0 + rect_c) * K;
  const int rows_live = min(kRectH, rows_tile - rect_r), cols_live = min(kRectW, cols_tile - rect_c);
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += Buffers::kPiece) {
    if (k0 >= K) break;
    const int run = min(Buffers::kPiece, K - k0);  // one pixel's slots in this piece
    const int stride = run | 1;
#pragma unroll
    for (int kk = 0; kk < Buffers::kPiece; ++kk) {
      if (kk < run) {
        const int k = k0 + kk;
        const bool empty = bi[k] < 0;
        buf[lane * stride + kk] = __int_as_float(bi[k]);
        if (!kIdsOnly) {
          buf[Buffers::kPlane + lane * stride + kk] = empty ? -1.0f : bz[k];
          buf[2 * Buffers::kPlane + lane * stride + kk] = empty ? -1.0f : bd[k];
        }
      }
    }
    __syncwarp();
    // e / run as (e * ceil(2^16 / run)) >> 16, exact for e < 512 and
    // run <= 16: the product over 2^16 exceeds e / run by less than
    // e / 2^16 < 1/128, and e / run lies at least 1/16 below the next
    // integer.
    const unsigned magic = (0x10000u + run - 1) / run;
#pragma unroll
    for (int it = 0; it < Buffers::kPiece; ++it) {
      const int e = lane + 32 * it;
      if (e >= 32 * run) break;
      const int p = static_cast<int>((e * magic) >> 16);
      const int off = e - p * run;
      const int r = p / kRectW, c = p % kRectW;
      if (r < rows_live && c < cols_live) {
        const size_t o = rect_base + (r * W + c) * K + k0 + off;
        const int from = p * stride + off;
        out_idx[o] = __float_as_int(buf[from]);
        if (!kIdsOnly) {
          out_z[o] = buf[Buffers::kPlane + from];
          out_dist[o] = buf[2 * Buffers::kPlane + from];
        }
      }
    }
    __syncwarp();
  }
}

template <int KB, bool kIdsOnly>
void launch(const float* points, const float* radius, const int* tile_points,
            const int* tile_start, const float* xs, const float* ys, int N, int P,
            int H, int W, int n_ty, int n_tx, int K, int* idx, float* z, float* dist,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(N) * n_ty * n_tx);
  rasterize_points_kernel<KB, kIdsOnly><<<grid, kThreads, 0, stream>>>(
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
  if (K < 1 || K > 64 || N < 1 || P < 1 || n_ty != (H + kTileH - 1) / kTileH ||
      n_tx != (W + kTileW - 1) / kTileW ||
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
  else if (K <= 5) P3D_LAUNCH(5);
  else if (K <= 8) P3D_LAUNCH(8);
  else if (K <= 10) P3D_LAUNCH(10);
  else if (K <= 16) P3D_LAUNCH(16);
  else if (K <= 32) P3D_LAUNCH(32);
  else P3D_LAUNCH(64);
#undef P3D_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when K, N, the tile counts or the grid are not
// ones this build takes.
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
