// Hard mesh rasterizer for Hopper (sm_90a): per pixel the single nearest
// face that covers it (K = 1, no blur), with its perspective-correct z and
// barycentrics.  The serving rasterizer behind `MeshRasterizerOpenGL`.
//
// Replaces the TPU kernel `_hard_kernel`
// (pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:635, launched by the
// pallas_call at :770 in `rasterize_hard_pallas`, :735).  It computes the
// same function as the plain PyTorch version `rasterize_hard_plain`
// (pytorch3d_tpu_torch/renderer/mesh/rasterize_cuda.py), which is the JAX
// package's CPU route of `MeshRasterizerOpenGL` (mesh/rasterizer.py:196-203):
// `rasterize_topk(fv, valid, size, 0.0, 1)` selects, per pixel, the
// covering face of smallest z (z interpolated with the screen-space
// barycentrics, ties to the lower id), and `interpolate_fragments(...,
// perspective_correct=True)` emits that face's perspective-correct z and
// barycentrics; empty pixels hold id -1, z -1 and bary -1.
//
// Design.  The binning ahead of the kernel is the fine rasterizer's
// (`bin_faces` at blur 0, torch, in the wrapper): each 16x16 tile of each
// image gets the exact list of faces whose box, grown by half a pixel,
// reaches it, in ascending id.  One block of 256 threads rasterizes one
// tile, one thread per pixel, warp w on a 4-row x 8-column rectangle of the
// tile, one launch for the whole batch.  The block stages its list in
// chunks of 256 faces in shared memory (the vertices as SoA rows); the
// thread that stages a face also finds its pixel box (the first and last
// pixel row and column whose centre lies in its bounding box grown by half
// a pixel, by binary searches over the pixel centres, as the fine kernel
// #1 does; chip_smoke.py's torch `face_pixel_boxes` at blur 0 without
// perspective correction makes the same boxes) and marks the warp
// rectangles the box meets.  Each warp then compacts, with a ballot, the
// chunk's faces that meet its rectangle into a list in ascending id and
// walks only that list; a lane whose pixel lies outside a face's box skips
// the face.  Every test keeps one running compare, `pz < best`: the strict
// `<` over ascending ids keeps the lower id at equal z, as the plain
// version's stable sort does.  The winner's screen-space barycentrics and
// its three vertex depths stay in registers; the perspective correction
// runs once per pixel after the walk, and each thread stores its pixel's
// id, z and bary (a rectangle row's 8 pixels are runs of 32 and 96
// consecutive bytes).  Writing each warp's rectangle through shared memory
// instead, as #1 does for its K-deep fragments, took 6 % longer here
// (raster_study.py hard, the `shared_stores` copy).
//
// Why the cull is exact.  A pair is dropped only where the pixel centre
// lies outside the face's bounding box grown by half a pixel.  The inside
// test is on the screen-space barycentrics, the edge functions over
// area + eps: all three > 0 only inside the triangle (rounding moves an
// edge function by far less than half a pixel's worth at the image's
// coordinates), so no face covers a pixel outside its box.  Unlike the
// fine kernel under perspective correction, a face that crosses z = 0
// needs no wider box: the z of its vertices enters only pz, not the
// inside test.  tests/test_torch_hard_cull.py checks on the CPU that the
// plain version restricted to the boxes selects what it selects
// unrestricted, at the cull's edge cases and with faces crossing z = 0.
//
// The arithmetic is the plain version's, operation for operation: the edge
// functions divided by (area + eps) (the TPU body recentres them on the
// tile centre and multiplies by a reciprocal, :691-696, which rounds
// otherwise and can flip ids at shared edges and equal depths), the strict
// inside test, pz = (w0 z0 + w1 z1) + w2 z2, and the TPU body's guards:
// pz >= 0, |area| <= eps drops a face, and the perspective denominator is
// max(.., eps).  Built with --fmad=false, ids, z and bary then equal the
// plain version's bit for bit, and those of the design before the cull
// (3144b18), which tested every pixel of a tile against the tile's whole
// list (raster_study.py hard checks the three outputs against that build).
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32, half that for
// separate multiplies and adds): the function tests each pixel centre in
// a face's box, ~29 operations each (3 edge functions, 3 divisions, the
// inside test, pz and the compare), and writes 20 B per pixel.  At the
// serving batch (2 images at 512^2, ~15 thousand faces) the bytes bind,
// at 0.0033 ms, against 1.36 M box tests (chip_smoke.py computes the bound
// from each run's own inputs).  On an "NVIDIA H100 80GB HBM3, 700.00 W"
// (raster_study.py hard, profiler device time) this kernel takes
// 0.031 ms there, 9.4x the bound, where the design before the cull, whose
// pixels tested every face of their tile's list (10.5 M pairs), took
// 0.051-0.053 ms in the same call.  Its warps walk 3.4 M lanes, 1.64 M of
// them in the faces' boxes; each test's three IEEE divisions are
// multi-instruction sequences, kept so that the bits are the plain
// version's.  ptxas: 47 registers, no spills, 16 640 bytes of shared
// memory.
#include <cuda_runtime.h>

namespace {

constexpr float kEpsilon = 1e-8f;
constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;
constexpr int kWarps = kThreads / 32;
constexpr int kRectH = 4;  // a warp's rectangle of the tile: 4 rows x 8 columns
constexpr int kRectW = 8;
constexpr int kRectsPerRow = kTileW / kRectW;
constexpr unsigned kFull = 0xffffffffu;

// The count of the falling pixel centres c[0, n) above v, and at or above v.
__device__ __forceinline__ int count_above(const float* c, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[mid] > v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_at_or_above(const float* c, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[mid] >= v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Shared memory of a block: the chunk's faces (their vertices as SoA rows,
// ids, pixel boxes and the warps whose rectangle the box meets) and each
// warp's list of chunk positions.
struct Stage {
  float f[9][kThreads];
  int id[kThreads];
  int4 box[kThreads];  // first row, last row, first column, last column
  unsigned char mask[kThreads];
  unsigned char list[kWarps][kThreads];
};

__global__ void __launch_bounds__(kThreads)
rasterize_hard_kernel(const float* __restrict__ face_verts,  // (N*F, 9)
                      const int* __restrict__ tile_faces,    // (pairs,) local ids
                      const int* __restrict__ tile_start,    // (N*n_ty*n_tx + 1,)
                      const float* __restrict__ xs,          // (W,) NDC x of columns
                      const float* __restrict__ ys,          // (H,) NDC y of rows
                      int F, int H, int W, int n_ty, int n_tx,
                      float box_grow,  // half a pixel
                      int* __restrict__ out_idx,     // (N, H, W)
                      float* __restrict__ out_z,     // (N, H, W)
                      float* __restrict__ out_bary)  // (N, H, W, 3)
{
  __shared__ Stage s;

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
  const int row0 = ty * kTileH + (warp / kRectsPerRow) * kRectH;  // the warp's rectangle
  const int col0 = tx * kTileW + (warp % kRectsPerRow) * kRectW;
  const int row = row0 + lane / kRectW;
  const int col = col0 + lane % kRectW;
  const bool live = row < H && col < W;
  const float px = live ? xs[col] : 0.0f;
  const float py = live ? ys[row] : 0.0f;

  float best = INFINITY;
  int best_id = -1;
  float w0b = 0.0f, w1b = 0.0f, w2b = 0.0f, z0b = 0.0f, z1b = 0.0f, z2b = 0.0f;

  const float* fv_n = face_verts + static_cast<size_t>(n) * F * 9;
  const int begin = tile_start[tile];
  const int end = tile_start[tile + 1];
  for (int base = begin; base < end; base += kThreads) {
    const int m = min(kThreads, end - base);
    __syncthreads();  // the previous chunk has been consumed
    if (tid < m) {
      const int f = tile_faces[base + tid];
      const float* src = fv_n + static_cast<size_t>(f) * 9;
      float v[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        v[c] = src[c];
        s.f[c][tid] = v[c];
      }
      s.id[tid] = f;
      // The pixel box: chip_smoke.py's torch `face_pixel_boxes`, op for op
      // (the grown bounds are exact minima and maxima less or plus the same
      // float32 grow; the searches compare with the same centres).
      const float xlo = fminf(fminf(v[0], v[3]), v[6]) - box_grow;
      const float xhi = fmaxf(fmaxf(v[0], v[3]), v[6]) + box_grow;
      const float ylo = fminf(fminf(v[1], v[4]), v[7]) - box_grow;
      const float yhi = fmaxf(fmaxf(v[1], v[4]), v[7]) + box_grow;
      const int4 b = make_int4(count_above(ys, H, yhi), count_at_or_above(ys, H, ylo) - 1,
                               count_above(xs, W, xhi), count_at_or_above(xs, W, xlo) - 1);
      s.box[tid] = b;
      // The plain version's area, as each test computes it: a zero-area
      // face covers nothing, nor does one whose box holds no pixel centre.
      const float area = (v[6] - v[0]) * (v[4] - v[1]) - (v[7] - v[1]) * (v[3] - v[0]);
      unsigned mask = 0;
      if (!(fabsf(area) <= kEpsilon) && b.x <= b.y && b.z <= b.w) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int r0 = ty * kTileH + (w / kRectsPerRow) * kRectH;
          const int c0 = tx * kTileW + (w % kRectsPerRow) * kRectW;
          const bool meets = b.x < r0 + kRectH && b.y >= r0 && b.z < c0 + kRectW && b.w >= c0;
          mask |= meets ? 1u << w : 0u;
        }
      }
      s.mask[tid] = static_cast<unsigned char>(mask);
    }
    __syncthreads();

    // The warp's list: the chunk's faces whose box meets its rectangle, in
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

    for (int i = 0; i < count; ++i) {
      const int j = s.list[warp][i];
      const int4 b = s.box[j];
      if (!(live && row >= b.x && row <= b.y && col >= b.z && col <= b.w)) continue;
      // The plain version's operations in its order, divisions included.
      const float v0x = s.f[0][j], v0y = s.f[1][j], v0z = s.f[2][j];
      const float v1x = s.f[3][j], v1y = s.f[4][j], v1z = s.f[5][j];
      const float v2x = s.f[6][j], v2y = s.f[7][j], v2z = s.f[8][j];
      const float area = (v2x - v0x) * (v1y - v0y) - (v2y - v0y) * (v1x - v0x);
      const float area_eps = area + kEpsilon;
      const float w0 = ((px - v1x) * (v2y - v1y) - (py - v1y) * (v2x - v1x)) / area_eps;
      const float w1 = ((px - v2x) * (v0y - v2y) - (py - v2y) * (v0x - v2x)) / area_eps;
      const float w2 = ((px - v0x) * (v1y - v0y) - (py - v0y) * (v1x - v0x)) / area_eps;
      const bool inside = w0 > 0.0f && w1 > 0.0f && w2 > 0.0f;
      const float pz = (w0 * v0z + w1 * v1z) + w2 * v2z;
      // Zero-area faces were left out of every list.
      if (inside && pz >= 0.0f && pz < best) {
        best = pz;
        best_id = s.id[j];
        w0b = w0; w1b = w1; w2b = w2;
        z0b = v0z; z1b = v1z; z2b = v2z;
      }
    }
  }

  if (!live) return;
  // interpolate_fragments(perspective_correct=True) for the winner.
  float z = -1.0f, b0 = -1.0f, b1 = -1.0f, b2 = -1.0f;
  if (best_id >= 0) {
    const float t0 = (w0b * z1b) * z2b;
    const float t1 = (z0b * w1b) * z2b;
    const float t2 = (z0b * z1b) * w2b;
    const float denom = fmaxf((t0 + t1) + t2, kEpsilon);
    b0 = t0 / denom;
    b1 = t1 / denom;
    b2 = t2 / denom;
    z = (b0 * z0b + b1 * z1b) + b2 * z2b;
  }
  // Each thread stores its own pixel: a rectangle row's 8 pixels are runs
  // of 32 and 96 consecutive bytes.
  const size_t pix = (static_cast<size_t>(n) * H + row) * W + col;
  out_idx[pix] = best_id;
  out_z[pix] = z;
  out_bary[3 * pix + 0] = b0;
  out_bary[3 * pix + 1] = b1;
  out_bary[3 * pix + 2] = b2;
}

}  // namespace

// The pixel tile (rows, cols) of one block, which the binning must use.
extern "C" void rasterize_hard_tile(int* rows, int* cols) {
  *rows = kTileH;
  *cols = kTileW;
}

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when N or the grid is not one this build takes.
// box_grow is the binning's growth of a face's box at blur 0, half a
// pixel, rounded to float32.
extern "C" int rasterize_hard(const float* face_verts, const int* tile_faces,
                              const int* tile_start, const float* xs, const float* ys,
                              int N, int F, int H, int W, int n_ty, int n_tx, float box_grow,
                              int* idx, float* z, float* bary, void* stream) {
  if (N < 1 || n_ty != (H + kTileH - 1) / kTileH || n_tx != (W + kTileW - 1) / kTileW ||
      static_cast<long long>(N) * n_ty * n_tx > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(N) * n_ty * n_tx);
  rasterize_hard_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      face_verts, tile_faces, tile_start, xs, ys, F, H, W, n_ty, n_tx, box_grow, idx, z, bary);
  return static_cast<int>(cudaGetLastError());
}
