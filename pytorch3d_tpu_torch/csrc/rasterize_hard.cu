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
// tile, one thread per pixel, one launch for the whole batch.  The block
// stages its list in chunks of 256 faces in shared memory and every thread
// walks the chunk in id order with one running compare, `pz < best`: the
// strict `<` over ascending ids keeps the lower id at equal z, as the plain
// version's stable sort does.  The winner's screen-space barycentrics and
// its three vertex depths stay in registers; the perspective correction
// runs once per pixel after the walk, not once per candidate.  The
// arithmetic is the plain version's, operation for operation: the edge
// functions divided by (area + eps) (the TPU body recentres them on the
// tile centre and multiplies by a reciprocal, :691-696, which rounds
// otherwise and can flip ids at shared edges and equal depths), the strict
// inside test, pz = (w0 z0 + w1 z1) + w2 z2, and the TPU body's guards:
// pz >= 0, |area| <= eps drops a face, and the perspective denominator is
// max(.., eps).  Built with --fmad=false, ids, z and bary then equal the
// plain version's bit for bit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32, half that for
// separate multiplies and adds): the function tests each pixel centre in
// a face's box, ~26 operations each (3 edge functions, 3 divisions, the
// inside test, pz and the compare), and writes 20 B per pixel.  At the
// serving batch (2 images at 512^2, ~15 thousand faces) the tests bind
// (chip_smoke.py computes the bound from each run's own inputs); the
// kernel tests every pixel of a tile against its whole list, more pairs
// than the boxes hold.
#include <cuda_runtime.h>

namespace {

constexpr float kEpsilon = 1e-8f;
constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;

__global__ void __launch_bounds__(kThreads)
rasterize_hard_kernel(const float* __restrict__ face_verts,  // (N*F, 9)
                      const int* __restrict__ tile_faces,    // (pairs,) local ids
                      const int* __restrict__ tile_start,    // (N*n_ty*n_tx + 1,)
                      const float* __restrict__ xs,          // (W,) NDC x of columns
                      const float* __restrict__ ys,          // (H,) NDC y of rows
                      int F, int H, int W, int n_ty, int n_tx,
                      int* __restrict__ out_idx,     // (N, H, W)
                      float* __restrict__ out_z,     // (N, H, W)
                      float* __restrict__ out_bary)  // (N, H, W, 3)
{
  __shared__ float s_fv[9][kThreads];
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
      s_id[tid] = f;
      const float* src = fv_n + static_cast<size_t>(f) * 9;
#pragma unroll
      for (int c = 0; c < 9; ++c) s_fv[c][tid] = src[c];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      const float v0x = s_fv[0][j], v0y = s_fv[1][j], v0z = s_fv[2][j];
      const float v1x = s_fv[3][j], v1y = s_fv[4][j], v1z = s_fv[5][j];
      const float v2x = s_fv[6][j], v2y = s_fv[7][j], v2z = s_fv[8][j];
      const float area = (v2x - v0x) * (v1y - v0y) - (v2y - v0y) * (v1x - v0x);
      const float area_eps = area + kEpsilon;
      const float w0 = ((px - v1x) * (v2y - v1y) - (py - v1y) * (v2x - v1x)) / area_eps;
      const float w1 = ((px - v2x) * (v0y - v2y) - (py - v2y) * (v0x - v2x)) / area_eps;
      const float w2 = ((px - v0x) * (v1y - v0y) - (py - v0y) * (v1x - v0x)) / area_eps;
      const bool inside = w0 > 0.0f && w1 > 0.0f && w2 > 0.0f;
      const float pz = (w0 * v0z + w1 * v1z) + w2 * v2z;
      const bool zero_area = fabsf(area) <= kEpsilon;
      if (inside && pz >= 0.0f && !zero_area && pz < best) {
        best = pz;
        best_id = s_id[j];
        w0b = w0; w1b = w1; w2b = w2;
        z0b = v0z; z1b = v1z; z2b = v2z;
      }
    }
  }
  if (!live) return;

  const size_t pix = (static_cast<size_t>(n) * H + row) * W + col;
  out_idx[pix] = best_id;
  if (best_id < 0) {
    out_z[pix] = -1.0f;
    out_bary[3 * pix + 0] = -1.0f;
    out_bary[3 * pix + 1] = -1.0f;
    out_bary[3 * pix + 2] = -1.0f;
    return;
  }
  // interpolate_fragments(perspective_correct=True) for the winner.
  const float t0 = (w0b * z1b) * z2b;
  const float t1 = (z0b * w1b) * z2b;
  const float t2 = (z0b * z1b) * w2b;
  const float denom = fmaxf((t0 + t1) + t2, kEpsilon);
  const float b0 = t0 / denom, b1 = t1 / denom, b2 = t2 / denom;
  out_z[pix] = (b0 * z0b + b1 * z1b) + b2 * z2b;
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
extern "C" int rasterize_hard(const float* face_verts, const int* tile_faces,
                              const int* tile_start, const float* xs, const float* ys,
                              int N, int F, int H, int W, int n_ty, int n_tx, int* idx,
                              float* z, float* bary, void* stream) {
  if (N < 1 || static_cast<long long>(N) * n_ty * n_tx > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTileW, kTileH);
  const dim3 grid(static_cast<unsigned>(N) * n_ty * n_tx);
  rasterize_hard_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      face_verts, tile_faces, tile_start, xs, ys, F, H, W, n_ty, n_tx, idx, z, bary);
  return static_cast<int>(cudaGetLastError());
}
