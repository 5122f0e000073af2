// Fine mesh rasterizer for Hopper (sm_90a): per pixel, the K nearest faces
// that cover it within the blur radius, with their fragments.
//
// Replaces the TPU kernel `_fine_kernel` with emit_fragments=True
// (pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:324, launched by the
// pallas_call at :1235 in `_rfp_fwd_impl`).  It computes the same function
// as the plain PyTorch version beside its wrapper
// (pytorch3d_tpu_torch/renderer/mesh/rasterize_cuda.py): for every pixel
// the K faces of smallest z whose blur region covers the pixel, ascending
// in z with ties to the lower face id, and for each of them z, the
// (perspective-correct, clipped on request) barycentrics and the signed
// squared distance; empty slots hold id -1 and -1 everywhere else.
//
// Design.  The binning ahead of the kernel (torch, in the wrapper) gives
// each 16x16 pixel tile of each image the exact list of faces whose
// bounding box, grown by the blur radius and half a pixel, reaches the
// tile, in ascending face id (a CSR list: tile_start/tile_faces).  One block
// of 256 threads rasterizes one tile of one image, one thread per pixel,
// and one launch covers all N images.  The block stages its list in chunks
// of 256 faces (9 floats + id) in shared memory; every thread then walks
// the chunk in id order, tests its pixel against each face and keeps a
// K-deep ascending buffer of (z, id, bary, dist) in registers.  A candidate
// goes in front of the first slot with a strictly larger z, so with faces
// walked in ascending id an equal z keeps the lower id first, as the plain
// version's stable sort does.  K is a template bucket (1..64); the runtime
// K masks the live prefix.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32). At the
// shapes the main path gives it (two images at 512^2, K=8, ~15 thousand
// faces) the fragments written are 24 bytes per slot, ~100 MB or ~0.03 ms of
// HBM, and the candidate (pixel, face) tests are ~15 million at ~108
// operations each. Built without FMA contraction every multiply and add
// issues on its own, at half the data sheet's 67 TFLOP/s, so the tests take
// ~0.05 ms: the arithmetic binds, the bytes come close behind. Each thread
// writes its K slots of each output as one contiguous run and the face lists
// are read once per block, so nothing but the outputs moves in bulk; the
// per-face terms (area, edge vectors) are still recomputed by every thread,
// which is the arithmetic to take out first. The arithmetic is the plain
// version's, operation for operation and in its order: edge functions divided
// by (area + eps) (the TPU kernel, rasterize_pallas.py:375-460, multiplies by
// a reciprocal), the strict inside test on the perspective-corrected bary,
// max(denom, eps) for the perspective correction, max(sum, 1e-5) for the clip
// and a division for the segment parameter. With --fmad=false every value,
// and so every id, then matches the plain version's bit for bit, which lets a
// gradient through this kernel and the backward kernel be held against
// autograd through the plain path (bin_size=0) without a selection
// difference.
//
// Ids only (#2).  The template flag kIdsOnly builds the same kernel for
// `rasterize_topk_cuda`, the counterpart of `rasterize_topk_pallas`
// (rasterize_pallas.py:549, the same `_fine_kernel` with
// emit_fragments=False, its pallas_call at :601): the selection is this
// kernel's, operation for operation, so its ids equal the fragments
// kernel's pix_to_face bit for bit; only the zbuf, bary and dists stores
// (20 of the 24 bytes per slot) are left out, and the compiler drops the
// register buffers that fed them.  What bounds it: at the serving batch
// the per-pixel tests again (~0.05 ms); the bytes fall to the ids' 4 B per
// slot (~0.005 ms).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEpsilon = 1e-8f;
constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;

__device__ __forceinline__ float seg_dist2(float px, float py, float ax, float ay,
                                           float bx, float by) {
  const float vx = bx - ax;
  const float vy = by - ay;
  const float l2 = vx * vx + vy * vy;
  float t = (vx * (px - ax) + vy * (py - ay)) / fmaxf(l2, kEpsilon);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  if (l2 <= kEpsilon) t = 1.0f;  // degenerate segment: distance to b
  const float dx = px - (ax + t * vx);
  const float dy = py - (ay + t * vy);
  return dx * dx + dy * dy;
}

template <int KB, bool kIdsOnly>
__global__ void __launch_bounds__(kThreads)
rasterize_fine_kernel(const float* __restrict__ face_verts,  // (N*F, 9)
                      const int* __restrict__ tile_faces,    // (P,) local ids
                      const int* __restrict__ tile_start,    // (N*n_ty*n_tx + 1,)
                      const float* __restrict__ xs,          // (W,) NDC x of columns
                      const float* __restrict__ ys,          // (H,) NDC y of rows
                      int F, int H, int W, int n_ty, int n_tx, float blur_radius,
                      int K, bool perspective_correct, bool clip_barycentric_coords,
                      int* __restrict__ out_idx,     // (N, H, W, K)
                      float* __restrict__ out_z,     // (N, H, W, K)
                      float* __restrict__ out_bary,  // (N, H, W, K, 3)
                      float* __restrict__ out_dist)  // (N, H, W, K)
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

  float bz[KB], b0[KB], b1[KB], b2[KB], bd[KB];
  int bi[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    bz[k] = INFINITY;
    bi[k] = -1;
    b0[k] = b1[k] = b2[k] = bd[k] = 0.0f;
  }

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

      // The plain version's operations in its order, divisions included,
      // so z, bary and dists (and with them the ids) match it bit for bit.
      const float area = (v2x - v0x) * (v1y - v0y) - (v2y - v0y) * (v1x - v0x);
      const float area_eps = area + kEpsilon;
      const float w0 = ((px - v1x) * (v2y - v1y) - (py - v1y) * (v2x - v1x)) / area_eps;
      const float w1 = ((px - v2x) * (v0y - v2y) - (py - v2y) * (v0x - v2x)) / area_eps;
      const float w2 = ((px - v0x) * (v1y - v0y) - (py - v0y) * (v1x - v0x)) / area_eps;

      float wz0 = w0, wz1 = w1, wz2 = w2;
      if (perspective_correct) {
        const float t0 = (w0 * v1z) * v2z;
        const float t1 = (v0z * w1) * v2z;
        const float t2 = (v0z * v1z) * w2;
        const float denom = fmaxf((t0 + t1) + t2, kEpsilon);
        wz0 = t0 / denom;
        wz1 = t1 / denom;
        wz2 = t2 / denom;
      }
      const bool inside = wz0 > 0.0f && wz1 > 0.0f && wz2 > 0.0f;
      if (clip_barycentric_coords) {
        wz0 = fmaxf(wz0, 0.0f);
        wz1 = fmaxf(wz1, 0.0f);
        wz2 = fmaxf(wz2, 0.0f);
        const float wsum = fmaxf((wz0 + wz1) + wz2, 1e-5f);
        wz0 = wz0 / wsum;
        wz1 = wz1 / wsum;
        wz2 = wz2 / wsum;
      }
      const float pz = (wz0 * v0z + wz1 * v1z) + wz2 * v2z;

      float d2 = seg_dist2(px, py, v0x, v0y, v1x, v1y);
      d2 = fminf(d2, seg_dist2(px, py, v1x, v1y, v2x, v2y));
      d2 = fminf(d2, seg_dist2(px, py, v0x, v0y, v2x, v2y));

      const bool zero_area = fabsf(area) <= kEpsilon;
      const bool covers = (inside || d2 < blur_radius) && pz >= 0.0f && !zero_area;
      if (!covers) continue;

      // Insert in front of the first slot with a strictly larger z, then
      // shift the rest of the live prefix down by one.
      float cz = pz, c0 = wz0, c1 = wz1, c2 = wz2, cd = inside ? -d2 : d2;
      int ci = s_id[j];
      bool shifting = false;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < K && (shifting || cz < bz[k])) {
          shifting = true;
          float tz = bz[k]; bz[k] = cz; cz = tz;
          int ti = bi[k]; bi[k] = ci; ci = ti;
          float t0 = b0[k]; b0[k] = c0; c0 = t0;
          float t1 = b1[k]; b1[k] = c1; c1 = t1;
          float t2 = b2[k]; b2[k] = c2; c2 = t2;
          float td = bd[k]; bd[k] = cd; cd = td;
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
      out_bary[3 * o + 0] = empty ? -1.0f : b0[k];
      out_bary[3 * o + 1] = empty ? -1.0f : b1[k];
      out_bary[3 * o + 2] = empty ? -1.0f : b2[k];
      out_dist[o] = empty ? -1.0f : bd[k];
    }
  }
}

template <int KB, bool kIdsOnly>
void launch(const float* face_verts, const int* tile_faces, const int* tile_start,
            const float* xs, const float* ys, int N, int F, int H, int W, int n_ty,
            int n_tx, float blur_radius, int K, int perspective_correct,
            int clip_barycentric_coords, int* idx, float* z, float* bary,
            float* dist, cudaStream_t stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid(static_cast<unsigned>(N) * n_ty * n_tx);
  rasterize_fine_kernel<KB, kIdsOnly><<<grid, block, 0, stream>>>(
      face_verts, tile_faces, tile_start, xs, ys, F, H, W, n_ty, n_tx,
      blur_radius, K, perspective_correct != 0, clip_barycentric_coords != 0, idx,
      z, bary, dist);
}

}  // namespace

// The pixel tile (rows, cols) of one block, which the binning must use.
extern "C" void rasterize_fine_tile(int* rows, int* cols) {
  *rows = kTileH;
  *cols = kTileW;
}

namespace {

template <bool kIdsOnly>
int dispatch(const float* face_verts, const int* tile_faces, const int* tile_start,
             const float* xs, const float* ys, int N, int F, int H, int W, int n_ty,
             int n_tx, float blur_radius, int K, int perspective_correct,
             int clip_barycentric_coords, int* idx, float* z, float* bary, float* dist,
             void* stream) {
  if (K < 1 || K > 64 || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_LAUNCH(KB)                                                            \
  launch<KB, kIdsOnly>(face_verts, tile_faces, tile_start, xs, ys, N, F, H, W, n_ty, \
                       n_tx, blur_radius, K, perspective_correct,                    \
                       clip_barycentric_coords, idx, z, bary, dist, s)
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
// cudaErrorInvalidValue when K or N is not one this build takes.
extern "C" int rasterize_fine(const float* face_verts, const int* tile_faces,
                              const int* tile_start, const float* xs,
                              const float* ys, int N, int F, int H, int W,
                              int n_ty, int n_tx, float blur_radius, int K,
                              int perspective_correct,
                              int clip_barycentric_coords, int* idx, float* z,
                              float* bary, float* dist, void* stream) {
  return dispatch<false>(face_verts, tile_faces, tile_start, xs, ys, N, F, H, W, n_ty,
                         n_tx, blur_radius, K, perspective_correct,
                         clip_barycentric_coords, idx, z, bary, dist, stream);
}

// The ids-only build (#2): the same launch without the fragment stores.
extern "C" int rasterize_topk(const float* face_verts, const int* tile_faces,
                              const int* tile_start, const float* xs,
                              const float* ys, int N, int F, int H, int W,
                              int n_ty, int n_tx, float blur_radius, int K,
                              int perspective_correct,
                              int clip_barycentric_coords, int* idx, void* stream) {
  return dispatch<true>(face_verts, tile_faces, tile_start, xs, ys, N, F, H, W, n_ty,
                        n_tx, blur_radius, K, perspective_correct,
                        clip_barycentric_coords, idx, nullptr, nullptr, nullptr, stream);
}
