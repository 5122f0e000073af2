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
// tile, in ascending face id (a CSR list: tile_start/tile_faces).  One
// block of 256 threads rasterizes one tile of one image, one thread per
// pixel, warp w on a 4-row x 8-column rectangle of the tile, and one launch
// covers all N images.  The block stages its list in chunks of 256 faces in
// shared memory (the vertices as SoA rows); the thread that stages a face
// also computes its pixel box (the first and last pixel row and column
// whose centre lies in its box grown by sqrt(blur_radius) and half a pixel:
// the binning at one-pixel tiles, by binary searches over the pixel
// centres; chip_smoke.py's torch `face_pixel_boxes` makes the same boxes by
// the same float ops and comparisons; made here, the box costs the host
// nothing) and which warps' rectangles the box meets.  Each
// warp then compacts, with a ballot, the chunk's faces that meet its
// rectangle into a list in ascending id, and walks only that list; a lane
// whose pixel lies outside a face's pixel box skips the face.  Every test
// that is made keeps a K-deep ascending buffer of (z, id, bary, dist) in
// registers.  A candidate goes in front of the first slot with a strictly
// larger z, so with faces walked in ascending id an equal z keeps the lower
// id first, as the plain version's stable sort does.  K is a template
// bucket (1..64); the runtime K masks the live prefix.
//
// A band of rows (#1 and #4 over rows [row0, row0 + rows) of the H x W
// image, the counterpart of `rasterize_fragments_pallas_band`,
// rasterize_pallas.py:1313, whose forward runs this kernel's TPU
// counterpart with a tile-row offset).  The launch covers the band's
// tiles, 16x16 tiles starting at pixel row row0 (any row0: the TPU's band
// offset counts whole tiles of a size that depends on K and F); a thread's
// pixel row is row0 + ty * 16 + r.  Pixel centres, pixel boxes and the
// warp rectangles stay in the image's rows, so each pixel is tested
// against the faces whose box holds it, in ascending id, exactly as in the
// full image, and its slots equal that image's row bit for bit; only the
// stores go to the band's own rows.  The full image is the band (0, H),
// the same code.  That holds for a face crossing z = 0 under perspective
// correction too: its pixel box is the whole image (below), and the
// binning lists it in every tile, so it is tested at every pixel wherever
// the tiles fall.
//
// Why the cull is exact.  It drops a (pixel, face) pair only where the
// pixel centre lies outside the face's xy bounding box grown by
// sqrt(blur_radius) and half a pixel, and a face covers a pixel only if
// (inside || d2 < blur) && pz >= 0 && !zero_area.  d2 < blur puts the
// centre within sqrt(blur) of an edge, so inside the box grown by
// sqrt(blur); half a pixel (~2e-3 in NDC at 512^2) is left for rounding,
// which moves d2 by ~1e-6.  `inside` needs all three corrected
// barycentrics > 0.  Without perspective correction those are the edge
// functions over area + eps, all of one sign only inside the triangle.
// With it, bary_i = w_i z_j z_k / max(sum, eps) has the sign of w_i z_j z_k:
// where every z is > 0 that is w_i's sign again, and where a z is 0 two of
// the products are 0.  Where a z is < 0 (a face that crosses z = 0, which
// `_face_culls` keeps when its largest z is >= 0), all three can be > 0
// far outside the triangle: with z0 > 0 > z1, z2, every pixel of the
// unbounded wedge where w0 > 0 > w1, w2 is `inside`, and its pz =
// z0 z1 z2 (w0 + w1 + w2) / denom > 0 covers it.  So under perspective
// correction every face whose smallest z is < 0 gets the whole image as
// its pixel box, and the binning (`bin_faces(..., perspective_correct=)`)
// lists it in every tile, so the kernel tests it at every pixel, as the
// plain version does.  (The TPU kernel bins it by its bounding box,
// rasterize_pallas.py:148-173, and so leaves out the rest of such a wedge,
// which depends on where its tiles fall.)
// tests/test_torch_raster_fine_cull.py checks on the CPU that every pair
// the plain version covers lies in its face's pixel box, with faces
// crossing z = 0 among them; tests/test_torch_band_raster.py that it lies
// in a tile that lists its face, in bands on and off the 16-row grid.
//
// The per-test arithmetic is the plain version's, operation for operation
// and in its order: edge functions divided by (area + eps) (the TPU kernel,
// rasterize_pallas.py:375-460, multiplies by a reciprocal), the strict
// inside test on the perspective-corrected bary, max(denom, eps) for the
// perspective correction, max(sum, 1e-5) for the clip and a division for
// the segment parameter.  The per-face terms a test shares with the others
// (edge vectors, area + eps, the segments' max(|v|^2, eps)) are the same
// operations on the same operands (v0 - v2 is -(v2 - v0) exactly in IEEE
// arithmetic), so with --fmad=false every value, and so every id, matches
// the plain version's bit for bit, and the kernel before the cull's too;
// that lets a gradient through this kernel and the backward kernel be held
// against autograd through the plain path (bin_size=0) without a selection
// difference.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32). At the
// shapes the main path gives it (two images at 512^2, K=8, ~15 thousand
// faces) the fragments written are 24 bytes per slot, ~100 MB or ~0.03 ms of
// HBM, and the pixel centres inside the faces' grown boxes are ~3.1 million,
// at ~108 operations a test, which without FMA contraction issue at half the
// data sheet's rate: ~0.01 ms.  The bytes bind.  The tests the kernel makes
// are those of the lanes inside a face's box, in warps whose rectangle meets
// it (chip_smoke.py counts both), and each costs 12 IEEE divisions, which
// are multi-instruction sequences: they are kept, since they are what makes
// the ids and values the plain version's.  The per-face terms are
// recomputed in every test: staged once a chunk instead (12 more floats a
// face in shared memory), they made the kernel 1 % slower on the card
// (raster_study.py fine times both).  The
// warp writes its rectangle's slots through shared memory as runs of
// consecutive addresses, where a thread storing its own run of K slots
// would leave lanes K x 4 bytes apart.
//
// Ids only (#2).  The template flag kIdsOnly builds the same kernel for
// `rasterize_topk_cuda`, the counterpart of `rasterize_topk_pallas`
// (rasterize_pallas.py:549, the same `_fine_kernel` with
// emit_fragments=False, its pallas_call at :601): the selection is this
// kernel's, operation for operation, so its ids equal the fragments
// kernel's pix_to_face bit for bit; only the zbuf, bary and dists stores
// (20 of the 24 bytes per slot) are left out, and the compiler drops the
// register buffers that fed them.  What bounds it: at the serving batch the
// per-pixel tests (~0.01 ms); the bytes fall to the ids' 4 B per slot
// (~0.005 ms).
#include <cuda_runtime.h>

#include <cstdint>

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

// Flags of a face.
constexpr unsigned kZeroArea = 1u;
constexpr unsigned kDegenerate01 = 2u;  // |v1 - v0|^2 <= eps
constexpr unsigned kDegenerate12 = 4u;
constexpr unsigned kDegenerate02 = 8u;

// One face: its vertices and the terms its tests share, each computed by
// the same operations on the same operands as the plain version's test.
struct Face {
  float v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z;
  float d01x, d01y, d12x, d12y, d02x, d02y;  // v1 - v0, v2 - v1, v2 - v0
  float area_eps;                            // area + eps
  float z01;                                 // v0z * v1z
  float l01, l12, l02;                       // max(|edge|^2, eps)
  unsigned flags;
};

__device__ __forceinline__ void face_terms(Face& f) {
  f.d01x = f.v1x - f.v0x;
  f.d01y = f.v1y - f.v0y;
  f.d12x = f.v2x - f.v1x;
  f.d12y = f.v2y - f.v1y;
  f.d02x = f.v2x - f.v0x;
  f.d02y = f.v2y - f.v0y;
  const float area = f.d02x * f.d01y - f.d02y * f.d01x;
  f.area_eps = area + kEpsilon;
  f.z01 = f.v0z * f.v1z;
  const float l01 = f.d01x * f.d01x + f.d01y * f.d01y;
  const float l12 = f.d12x * f.d12x + f.d12y * f.d12y;
  const float l02 = f.d02x * f.d02x + f.d02y * f.d02y;
  f.l01 = fmaxf(l01, kEpsilon);
  f.l12 = fmaxf(l12, kEpsilon);
  f.l02 = fmaxf(l02, kEpsilon);
  f.flags = (fabsf(area) <= kEpsilon ? kZeroArea : 0u) | (l01 <= kEpsilon ? kDegenerate01 : 0u) |
            (l12 <= kEpsilon ? kDegenerate12 : 0u) | (l02 <= kEpsilon ? kDegenerate02 : 0u);
}

// Squared distance from p to the segment from a along v, with q = p - a,
// L = max(|v|^2, eps) and a degenerate segment measured to its end.
__device__ __forceinline__ float seg_dist2(float px, float py, float ax, float ay, float qx,
                                           float qy, float vx, float vy, float L, bool degenerate) {
  float t = (vx * qx + vy * qy) / L;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  if (degenerate) t = 1.0f;
  const float dx = px - (ax + t * vx);
  const float dy = py - (ay + t * vy);
  return dx * dx + dy * dy;
}

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

// A face's pixel box (first row, last row, first column, last column; first
// > last where no pixel centre lies in it): chip_smoke.py's torch
// `face_pixel_boxes`, op for op (the grown bounds are exact minima and
// maxima less or plus the same float32 grow; the searches compare with
// the same centres).  Where a coordinate is NaN the box here spans the
// other vertices, where torch's is empty: such a face covers nothing.
__device__ __forceinline__ int4 pixel_box(const Face& f, const float* xs, const float* ys, int H,
                                          int W, float grow, bool perspective_correct) {
  if (perspective_correct && fminf(fminf(f.v0z, f.v1z), f.v2z) < 0.0f) {
    return make_int4(0, H - 1, 0, W - 1);  // crosses z = 0: see the header
  }
  const float xlo = fminf(fminf(f.v0x, f.v1x), f.v2x) - grow;
  const float xhi = fmaxf(fmaxf(f.v0x, f.v1x), f.v2x) + grow;
  const float ylo = fminf(fminf(f.v0y, f.v1y), f.v2y) - grow;
  const float yhi = fmaxf(fmaxf(f.v0y, f.v1y), f.v2y) + grow;
  return make_int4(count_above(ys, H, yhi), count_at_or_above(ys, H, ylo) - 1,
                   count_above(xs, W, xhi), count_at_or_above(xs, W, xlo) - 1);
}

// Shared memory of a block: the chunk's faces (their vertices as SoA rows,
// ids, pixel boxes and the warps whose rectangle the box meets) and each
// warp's list of chunk positions; after the last chunk, each warp's buffer
// for its stores.
constexpr int kStaged = 9;  // floats staged a face: its vertices
struct Stage {
  float f[kStaged][kThreads];
  int id[kThreads];
  int4 box[kThreads];  // first row, last row, first column, last column
  unsigned char mask[kThreads];
  unsigned char list[kWarps][kThreads];
};
constexpr int kBufWords = 32 * (8 * 3 + 1);  // a warp's store buffer: see stage_store
union Shared {
  Stage s;
  float buf[kWarps][kBufWords];
};

__device__ __forceinline__ void store_face(Stage& s, int j, const Face& f) {
  const float v[kStaged] = {f.v0x, f.v0y, f.v0z, f.v1x, f.v1y, f.v1z, f.v2x, f.v2y, f.v2z};
#pragma unroll
  for (int c = 0; c < kStaged; ++c) s.f[c][j] = v[c];
}

__device__ __forceinline__ Face load_face(const Stage& s, int j) {
  Face f;
  f.v0x = s.f[0][j]; f.v0y = s.f[1][j]; f.v0z = s.f[2][j];
  f.v1x = s.f[3][j]; f.v1y = s.f[4][j]; f.v1z = s.f[5][j];
  f.v2x = s.f[6][j]; f.v2y = s.f[7][j]; f.v2z = s.f[8][j];
  face_terms(f);
  return f;
}

// The warp's `KB` slots of one output, `WD` values a slot, from the
// registers `val(k, c)` to out's rows: through a piece of shared memory
// `buf`, `KP` slots of its 32 pixels at a time, written as runs of
// consecutive addresses.  A pixel's values sit one word further apart in
// `buf` than their count, an odd stride, so that the lanes' writes fall
// in different banks.
template <int KB, int KP, int WD, typename T, typename Val>
__device__ __forceinline__ void stage_store(T* buf, T* out, Val val, int K, int lane,
                                            size_t rect_base, int W, int rows_live, int cols_live) {
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += KP) {
    if (k0 >= K) break;
    const int kp = min(KP, K - k0);
    const int run = kp * WD;  // one pixel's values in this piece
    const int stride = run | 1;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      if (kk < kp) {
#pragma unroll
        for (int c = 0; c < WD; ++c) buf[lane * stride + kk * WD + c] = val(k0 + kk, c);
      }
    }
    __syncwarp();
    for (int e = lane; e < 32 * run; e += 32) {
      const int p = e / run, off = e - p * run;
      const int r = p / kRectW, c = p - r * kRectW;
      if (r < rows_live && c < cols_live) {
        out[(rect_base + static_cast<size_t>(r) * W + c) * K * WD + k0 * WD + off] = buf[p * stride + off];
      }
    }
    __syncwarp();
  }
}

// Three blocks an SM where the K buffer is short (80 registers a thread,
// ~100 bytes spilled, and still 4-12 % faster at K = 8 than with no floor,
// which gives 110 registers); no floor where it is long (a K = 16 buffer
// takes ~150).
template <int KB, bool kIdsOnly>
__global__ void __launch_bounds__(kThreads, KB <= 8 ? 3 : 1)
rasterize_fine_kernel(const float* __restrict__ face_verts,  // (N*F, 9)
                      const int* __restrict__ tile_faces,    // (P,) local ids
                      const int* __restrict__ tile_start,    // (N*n_ty*n_tx + 1,)
                      const float* __restrict__ xs,          // (W,) NDC x of columns
                      const float* __restrict__ ys,          // (H,) NDC y of rows
                      int F, int H, int W,
                      int band0, int band_rows,  // the rasterized rows [band0, band0 + band_rows)
                      int n_ty, int n_tx, float blur_radius,
                      float box_grow,  // sqrt(blur_radius) + half a pixel
                      int K, bool perspective_correct, bool clip_barycentric_coords,
                      int* __restrict__ out_idx,     // (N, band_rows, W, K)
                      float* __restrict__ out_z,     // (N, band_rows, W, K)
                      float* __restrict__ out_bary,  // (N, band_rows, W, K, 3)
                      float* __restrict__ out_dist)  // (N, band_rows, W, K)
{
  __shared__ Shared shared;
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
  const int tile_row0 = band0 + ty * kTileH;  // the tile's first image row
  const int band_end = band0 + band_rows;
  const int row0 = tile_row0 + (warp / kRectsPerRow) * kRectH;  // the warp's rectangle, image rows
  const int col0 = tx * kTileW + (warp % kRectsPerRow) * kRectW;
  const int row = row0 + lane / kRectW;
  const int col = col0 + lane % kRectW;
  const bool live = row < band_end && col < W;
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
      const float* src = fv_n + static_cast<size_t>(f) * 9;
      Face face;
      face.v0x = src[0]; face.v0y = src[1]; face.v0z = src[2];
      face.v1x = src[3]; face.v1y = src[4]; face.v1z = src[5];
      face.v2x = src[6]; face.v2y = src[7]; face.v2z = src[8];
      face_terms(face);
      store_face(s, tid, face);
      s.id[tid] = f;
      const int4 b = pixel_box(face, xs, ys, H, W, box_grow, perspective_correct);
      s.box[tid] = b;
      unsigned mask = 0;
      // A zero-area face covers nothing, nor does one whose box holds no
      // pixel centre.
      if (!(face.flags & kZeroArea) && b.x <= b.y && b.z <= b.w) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int r0 = tile_row0 + (w / kRectsPerRow) * kRectH;
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
      const bool in_box = row >= b.x && row <= b.y && col >= b.z && col <= b.w;
      if (!(live && in_box)) continue;
      const Face f = load_face(s, j);

      // The plain version's operations in its order, divisions included,
      // so z, bary and dists (and with them the ids) match it bit for bit.
      const float qx0 = px - f.v0x, qy0 = py - f.v0y;
      const float qx1 = px - f.v1x, qy1 = py - f.v1y;
      const float qx2 = px - f.v2x, qy2 = py - f.v2y;
      const float w0 = (qx1 * f.d12y - qy1 * f.d12x) / f.area_eps;
      const float w1 = (qx2 * -f.d02y - qy2 * -f.d02x) / f.area_eps;
      const float w2 = (qx0 * f.d01y - qy0 * f.d01x) / f.area_eps;

      float wz0 = w0, wz1 = w1, wz2 = w2;
      if (perspective_correct) {
        const float t0 = (w0 * f.v1z) * f.v2z;
        const float t1 = (f.v0z * w1) * f.v2z;
        const float t2 = f.z01 * w2;
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
      const float pz = (wz0 * f.v0z + wz1 * f.v1z) + wz2 * f.v2z;

      float d2 = seg_dist2(px, py, f.v0x, f.v0y, qx0, qy0, f.d01x, f.d01y, f.l01, f.flags & kDegenerate01);
      d2 = fminf(d2, seg_dist2(px, py, f.v1x, f.v1y, qx1, qy1, f.d12x, f.d12y, f.l12, f.flags & kDegenerate12));
      d2 = fminf(d2, seg_dist2(px, py, f.v0x, f.v0y, qx0, qy0, f.d02x, f.d02y, f.l02, f.flags & kDegenerate02));

      // Zero-area faces were left out of every list.
      const bool covers = (inside || d2 < blur_radius) && pz >= 0.0f;
      if (!covers) continue;

      // Insert in front of the first slot with a strictly larger z, then
      // shift the rest of the live prefix down by one.
      float cz = pz, c0 = wz0, c1 = wz1, c2 = wz2, cd = inside ? -d2 : d2;
      int ci = s.id[j];
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

  // Each warp writes its rectangle's slots through its buffer, over the
  // staging memory, which every warp has finished reading.
  __syncthreads();
  float* buf = shared.buf[warp];
  const size_t rect_base = (static_cast<size_t>(n) * band_rows + (row0 - band0)) * W + col0;
  const int rows_live = min(kRectH, band_end - row0), cols_live = min(kRectW, W - col0);
  constexpr int kP1 = KB < 16 ? KB : 16;  // 32 x (16 + 1) words of one-value outputs fit kBufWords
  constexpr int kP3 = KB < 8 ? KB : 8;    // 32 x (8 x 3 + 1) of bary
  static_assert(32 * (kP1 + 1) <= kBufWords && 32 * (kP3 * 3 + 1) <= kBufWords,
                "a store piece exceeds a warp's buffer");
  stage_store<KB, kP1, 1>(reinterpret_cast<int*>(buf), out_idx, [&](int k, int) { return bi[k]; },
                          K, lane, rect_base, W, rows_live, cols_live);
  if (kIdsOnly) return;
  stage_store<KB, kP1, 1>(buf, out_z, [&](int k, int) { return bi[k] < 0 ? -1.0f : bz[k]; },
                          K, lane, rect_base, W, rows_live, cols_live);
  stage_store<KB, kP3, 3>(buf, out_bary,
                          [&](int k, int c) { return bi[k] < 0 ? -1.0f : (c == 0 ? b0[k] : c == 1 ? b1[k] : b2[k]); },
                          K, lane, rect_base, W, rows_live, cols_live);
  stage_store<KB, kP1, 1>(buf, out_dist, [&](int k, int) { return bi[k] < 0 ? -1.0f : bd[k]; },
                          K, lane, rect_base, W, rows_live, cols_live);
}

template <int KB, bool kIdsOnly>
void launch(const float* face_verts, const int* tile_faces, const int* tile_start,
            const float* xs, const float* ys, int N, int F, int H, int W, int band0,
            int band_rows, int n_ty, int n_tx,
            float blur_radius, float box_grow, int K, int perspective_correct,
            int clip_barycentric_coords, int* idx, float* z, float* bary, float* dist,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(N) * n_ty * n_tx);
  rasterize_fine_kernel<KB, kIdsOnly><<<grid, kThreads, 0, stream>>>(
      face_verts, tile_faces, tile_start, xs, ys, F, H, W, band0, band_rows, n_ty, n_tx,
      blur_radius, box_grow, K,
      perspective_correct != 0, clip_barycentric_coords != 0, idx, z, bary, dist);
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
             const float* xs, const float* ys, int N, int F, int H, int W, int band0,
             int band_rows, int n_ty, int n_tx,
             float blur_radius, float box_grow, int K, int perspective_correct,
             int clip_barycentric_coords, int* idx, float* z, float* bary, float* dist,
             void* stream) {
  if (K < 1 || K > 64 || N < 1 || band0 < 0 || band_rows < 1 || band0 + band_rows > H ||
      n_ty != (band_rows + kTileH - 1) / kTileH || n_tx != (W + kTileW - 1) / kTileW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_LAUNCH(KB)                                                                  \
  launch<KB, kIdsOnly>(face_verts, tile_faces, tile_start, xs, ys, N, F, H, W, band0,       \
                       band_rows, n_ty, n_tx,                                              \
                       blur_radius, box_grow, K, perspective_correct,                     \
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

// Rasterizes rows [row0, row0 + rows) of N H x W images into (N, rows, W,
// K) outputs; the band's n_ty = ceil(rows / 16) tile rows start at row0
// (the full image: row0 = 0, rows = H).  Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue when K, N, the band
// or the tile counts are not ones this build takes.  box_grow is the
// binning's growth of a face's box, sqrt(blur_radius) + half a pixel,
// rounded to float32.
extern "C" int rasterize_fine(const float* face_verts, const int* tile_faces,
                              const int* tile_start, const float* xs, const float* ys, int N,
                              int F, int H, int W, int row0, int rows, int n_ty, int n_tx,
                              float blur_radius, float box_grow, int K, int perspective_correct,
                              int clip_barycentric_coords, int* idx, float* z, float* bary,
                              float* dist, void* stream) {
  return dispatch<false>(face_verts, tile_faces, tile_start, xs, ys, N, F, H, W, row0, rows,
                         n_ty, n_tx,
                         blur_radius, box_grow, K, perspective_correct,
                         clip_barycentric_coords, idx, z, bary, dist, stream);
}

// The ids-only build (#2): the same launch without the fragment stores.
extern "C" int rasterize_topk(const float* face_verts, const int* tile_faces,
                              const int* tile_start, const float* xs, const float* ys, int N,
                              int F, int H, int W, int n_ty, int n_tx, float blur_radius,
                              float box_grow, int K, int perspective_correct,
                              int clip_barycentric_coords, int* idx, void* stream) {
  return dispatch<true>(face_verts, tile_faces, tile_start, xs, ys, N, F, H, W, 0, H, n_ty, n_tx,
                        blur_radius, box_grow, K, perspective_correct,
                        clip_barycentric_coords, idx, nullptr, nullptr, nullptr, stream);
}
