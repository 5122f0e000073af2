// Pulsar blend backward for Hopper (sm_90a): the gradient of pulsar's
// softmax blend with respect to the packed sphere table.
//
// Replaces the TPU kernel `_pulsar_grad_kernel`
// (pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:618, launched by
// the pallas_call at :905 in `pulsar_blend_grads`, :830, behind
// `_blend_packed_bwd` in pulsar/renderer.py:178).  It computes the same
// function as the plain PyTorch version `pulsar_blend_grads_plain`
// (pytorch3d_tpu_torch/renderer/points/rasterize_points_cuda.py): with
// table rows (x, y, z, r, o, col[C]) and, per pixel, the K selected sphere
// ids, the image cotangent ct, denom and logit_max lm of the forward and the
// background (colour bg, logit bg_norm_depth / gamma), every hit of sphere
// j at pixel p adds
//
//   A    = sum_c ct_c (col_jc - I_c) / denom               (dL/dw)
//        = sum_c ct_c (sum_k w_k (col_jc - col_kc) + w_bg (col_jc - bg_c)) / denom^2
//   e    = exp(o zn / gamma - lm),  w0 = clos e,  w = o w0
//   d x  += 2 o A e [0 < u < 1] dx / r^2     (u = 1 - d^2 / r^2, dx = px - x)
//   d y  += 2 o A e [0 < u < 1] dy / r^2
//   d r  += 2 o A e [0 < u < 1] d^2 / r^3
//   d z  += -(o^2 / gamma) [0 < zn < 1] A w0 / (max_depth - min_depth)
//   d o  += (1 + o zn / gamma) A w0
//   d col_c += o w0 ct_c / denom
//
// with zn = 1 - (z - min_depth) / (max_depth - min_depth) clipped to [0, 1]
// and clos = clip(u, 0, 1).  lm is a constant: the numerator and the
// denominator share exp(-lm), so the gradient through it is exactly zero.
// Unlike the TPU body, which splits e into exp(o zn / gamma) exp(-lm) per
// (sphere, tile), e is taken per hit as the forward takes it: at the small
// gammas pulsar is used with (1e-4 in PulsarPointsRenderer) the split
// overflows to inf * 0.  And e must be the forward's to the bit: logits
// reach 1 / gamma = 1e4 there, where one ulp moves a weight by ~1e-3.  So
// zn and the logit follow `pulsar_depth_logit` op for op, on the same
// float32 reciprocals inv_range = 1 / (max_depth - min_depth) and
// inv_gamma = 1 / gamma, which the wrapper rounds once and passes in.
// A is taken in its second, pairwise form over the pixel's K hits (the TPU
// body takes sum_c ct_c col_jc - ct . I): where one sphere makes the pixel,
// col_j - I is the image's rounding, which 1 / denom (small at a disc's
// rim) scales up, while the pairwise form is exactly 0 there, as the exact
// gradient is.  At gamma 1e-4 that takes the float32 gradient from ~4e-2
// of a field's largest entry off float64 to ~1e-4.
//
// Design (deterministic, no atomics).  The forward's binning
// (`bin_points_for_pulsar`: exact CSR lists of the spheres that reach each
// 16x16 tile, ascending id) gives every (tile, sphere) pair a slot.  Pass 1:
// one block of 256 threads per tile, one thread per pixel, holds its
// pixel's K ids and their weights w_k in registers and walks the tile's list
// in chunks of up to 64 spheres staged in shared memory (fewer where 5 + C
// fields and 4 + C partials per warp would not fit).  For each sphere every
// thread tests whether it is among its K ids; a warp in which no lane hits
// skips the sphere, the others reduce their 4 + C partial sums with
// shuffles in a fixed order, and after the chunk the block adds its 8
// warps' partials in warp order and writes the chunk's slots of the
// (pairs, 5 + C) slot table.  Pass 2: one thread per (sphere, field) adds
// the sphere's slots in ascending tile order, through the per-sphere CSR
// of slot rows the binning built (a stable sort of the pairs by id), into
// d(table).  Two runs give the same bits.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32, built without FMA
// contraction: half).  The function reads the ids (4 K B per pixel), the
// cotangent (4 C B), denom and lm (8 B) and the table (4 (5 + C) B per
// sphere) once and writes d(table) once: at pulsar-serving (1024^2, K = 5,
// C = 3, 100 000 spheres) ~46 MB, ~0.014 ms; and it does ~34 + 7 C
// operations per filled hit and 3 C per pair of hits on a pixel (5 M hits
// there: ~0.02 ms).  Which binds depends on the hits per pixel.  The kernel does more: every pixel of a tile tests every sphere of
// the tile's list (hundreds at 10^6 spheres), so its time grows with tile
// pixels x list length, not with the hits; chip_smoke.py reports both.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;  // most spheres staged per pass over the tile's list

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
pulsar_grad_tiles_kernel(const float* __restrict__ table,       // (P, F)
                         const int* __restrict__ tile_points,   // (pairs,)
                         const int* __restrict__ tile_start,    // (n_tiles + 1,)
                         const int* __restrict__ idx,           // (H, W, K)
                         const float* __restrict__ ct,          // (H, W, C)
                         const float* __restrict__ bg_col,      // (C,)
                         const float* __restrict__ denom,       // (H, W)
                         const float* __restrict__ logit_max,   // (H, W)
                         const float* __restrict__ xs,          // (W,)
                         const float* __restrict__ ys,          // (H,)
                         int C, int H, int W, int n_tx, int K, int chunk,
                         float inv_gamma, float min_depth, float inv_range, float bg_logit,
                         float* __restrict__ gslot)  // (pairs, F)
{
  extern __shared__ float smem[];
  const int F = 5 + C;
  const int R = 4 + C;  // partial sums per (warp, sphere): x, y, r, S, col[C]
  float* s_data = smem;                                    // (F, chunk)
  int* s_id = reinterpret_cast<int*>(s_data + F * chunk);  // (chunk,)
  float* s_part = reinterpret_cast<float*>(s_id + chunk);  // (kWarps, chunk, R)

  const int tile = blockIdx.x;
  const int ty = tile / n_tx;
  const int tx = tile - ty * n_tx;
  const int row = ty * kTileH + threadIdx.y;
  const int col = tx * kTileW + threadIdx.x;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool live = row < H && col < W;
  const size_t pix = live ? static_cast<size_t>(row) * W + col : 0;
  const float px = live ? xs[col] : 0.0f;
  const float py = live ? ys[row] : 0.0f;

  int ids[KB];
  float wk[KB];  // the forward's weight (o clos) e of each selected sphere
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    ids[k] = (live && k < K) ? idx[pix * K + k] : -1;
    wk[k] = 0.0f;
  }
  float inv_denom = 0.0f, lm = 0.0f, w_bg = 0.0f;
  if (live) {
    inv_denom = 1.0f / denom[pix];
    lm = logit_max[pix];
    w_bg = expf(bg_logit - lm);
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (ids[k] < 0) continue;
      const float* t = table + static_cast<size_t>(ids[k]) * (5 + C);
      const float zn = fminf(fmaxf(1.0f - (t[2] - min_depth) * inv_range, 0.0f), 1.0f);
      const float dx = px - t[0], dy = py - t[1];
      const float clos = fminf(fmaxf(1.0f - (dx * dx + dy * dy) / (t[3] * t[3]), 0.0f), 1.0f);
      wk[k] = t[4] * clos * expf(t[4] * zn * inv_gamma - lm);
    }
  }

  const int begin = tile_start[tile];
  const int end = tile_start[tile + 1];
  for (int base = begin; base < end; base += chunk) {
    const int m = min(chunk, end - base);
    __syncthreads();  // the previous chunk's slots are written
    for (int e = tid; e < m * F; e += kThreads) {
      const int j = e / F, f = e - j * F;
      const int p = tile_points[base + j];
      if (f == 0) s_id[j] = p;
      s_data[f * chunk + j] = table[static_cast<size_t>(p) * F + f];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const int pid = s_id[j];
      bool hit = false;
#pragma unroll
      for (int k = 0; k < KB; ++k) hit |= ids[k] == pid;
      float* part = s_part + (warp * chunk + j) * R;
      if (!__any_sync(0xffffffffu, hit)) {  // uniform across the warp
        for (int r = lane; r < R; r += 32) part[r] = 0.0f;
        continue;
      }
      float gx = 0.0f, gy = 0.0f, gr = 0.0f, gS = 0.0f, w0 = 0.0f;
      if (hit) {
        const float cx = s_data[0 * chunk + j], cy = s_data[1 * chunk + j];
        const float cz = s_data[2 * chunk + j], cr = s_data[3 * chunk + j];
        const float co = s_data[4 * chunk + j];
        const float zn = fminf(fmaxf(1.0f - (cz - min_depth) * inv_range, 0.0f), 1.0f);
        const float e = expf(co * zn * inv_gamma - lm);
        const float dx = px - cx, dy = py - cy;
        const float d2 = dx * dx + dy * dy;
        const float u = 1.0f - d2 / (cr * cr);
        const float clos = fminf(fmaxf(u, 0.0f), 1.0f);
        w0 = clos * e;
        float A = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float cj = s_data[(5 + c) * chunk + j];
          float num = w_bg * (cj - bg_col[c]);  // (col_jc - I_c) denom
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (ids[k] >= 0) num += wk[k] * (cj - table[static_cast<size_t>(ids[k]) * (5 + C) + 5 + c]);
          }
          A += (ct[pix * C + c] * inv_denom) * num;
        }
        A *= inv_denom;
        const float g = (u > 0.0f && u < 1.0f) ? A * e : 0.0f;
        gx = g * dx;
        gy = g * dy;
        gr = g * d2;
        gS = A * w0;
      }
      gx = warp_sum(gx);
      gy = warp_sum(gy);
      gr = warp_sum(gr);
      gS = warp_sum(gS);
      if (lane == 0) {
        part[0] = gx;
        part[1] = gy;
        part[2] = gr;
        part[3] = gS;
      }
      for (int c = 0; c < C; ++c) {
        const float v = warp_sum(hit ? w0 * (ct[pix * C + c] * inv_denom) : 0.0f);
        if (lane == 0) part[4 + c] = v;
      }
    }
    __syncthreads();
    // The chunk's slots: the 8 warps' partials in warp order, then the
    // per-sphere factors.
    for (int e = tid; e < m * F; e += kThreads) {
      const int j = e / F, f = e - j * F;
      const int r = f < 2 ? f : (f == 3 ? 2 : (f < 5 ? 3 : f - 1));  // field -> partial
      float sum = 0.0f;
      for (int w = 0; w < kWarps; ++w) sum += s_part[(w * chunk + j) * R + r];
      const float cz = s_data[2 * chunk + j], cr = s_data[3 * chunk + j];
      const float co = s_data[4 * chunk + j];
      const float inv_r2 = 1.0f / (cr * cr);
      const float zn_raw = 1.0f - (cz - min_depth) * inv_range;
      const float zn = fminf(fmaxf(zn_raw, 0.0f), 1.0f);
      float g;
      if (f < 2) g = 2.0f * inv_r2 * co * sum;
      else if (f == 3) g = 2.0f * inv_r2 * co / cr * sum;
      else if (f == 2) g = (zn_raw > 0.0f && zn_raw < 1.0f) ? -(co * co * inv_gamma) * inv_range * sum : 0.0f;
      else if (f == 4) g = (1.0f + co * zn * inv_gamma) * sum;
      else g = co * sum;
      gslot[static_cast<size_t>(base + j) * F + f] = g;
    }
  }
}

__global__ void pulsar_grad_combine_kernel(const float* __restrict__ gslot,     // (pairs, F)
                                           const int* __restrict__ slot_rows,   // (pairs,)
                                           const int* __restrict__ sphere_start,  // (P + 1,)
                                           int P, int F, float* __restrict__ dtable)  // (P, F)
{
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(P) * F) return;
  const int p = static_cast<int>(i / F);
  const int f = static_cast<int>(i - static_cast<long long>(p) * F);
  float sum = 0.0f;
  for (int q = sphere_start[p]; q < sphere_start[p + 1]; ++q) {
    sum += gslot[static_cast<size_t>(slot_rows[q]) * F + f];
  }
  dtable[i] = sum;
}

template <int KB>
cudaError_t launch_tiles(const float* table, const int* tile_points, const int* tile_start,
                         const int* idx, const float* ct, const float* bg_col,
                         const float* denom, const float* logit_max, const float* xs,
                         const float* ys, int C, int H, int W, int n_tiles, int n_tx, int K,
                         float inv_gamma, float min_depth, float inv_range, float bg_logit,
                         float* gslot, cudaStream_t stream) {
  // Spheres per chunk: as many as the block's shared memory holds, at most
  // kMaxChunk (each takes 5 + C fields, its id and kWarps x (4 + C) partials).
  int device = 0, max_bytes = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return err;
  const size_t per_sphere = (static_cast<size_t>(5 + C) + 1 + static_cast<size_t>(kWarps) * (4 + C)) * 4;
  const int chunk = static_cast<int>(std::min<size_t>(kMaxChunk, static_cast<size_t>(max_bytes) / per_sphere));
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t bytes = per_sphere * chunk;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(pulsar_grad_tiles_kernel<KB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  pulsar_grad_tiles_kernel<KB><<<n_tiles, dim3(kTileW, kTileH), bytes, stream>>>(
      table, tile_points, tile_start, idx, ct, bg_col, denom, logit_max, xs, ys, C, H, W,
      n_tx, K, chunk, inv_gamma, min_depth, inv_range, bg_logit, gslot);
  return cudaGetLastError();
}

}  // namespace

// The pixel tile (rows, cols) of one block, which the binning must use.
extern "C" void pulsar_grad_tile(int* rows, int* cols) {
  *rows = kTileH;
  *cols = kTileW;
}

// Both passes on `stream`; gslot (pairs, 5 + C) is the wrapper's scratch.
// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a K, C or size this build does not take (C is
// bounded only by one sphere's 9 C + 38 floats fitting in a block's shared
// memory: C <= 6452 in the 227 KiB of an H100).
extern "C" int pulsar_grad(const float* table, const int* tile_points, const int* tile_start,
                           const int* idx, const float* ct, const float* bg_col,
                           const float* denom, const float* logit_max, const float* xs,
                           const float* ys, const int* slot_rows, const int* sphere_start,
                           int P, int C, int H, int W, int n_ty, int n_tx, int K, int pairs,
                           float inv_gamma, float min_depth, float inv_range, float bg_logit,
                           float* gslot, float* dtable, void* stream) {
  if (K < 1 || K > 32 || C < 1 || P < 1 || H < 1 || W < 1 ||
      static_cast<long long>(n_ty) * n_tx > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_ty * n_tx;
  cudaError_t err = cudaSuccess;
  if (pairs > 0) {
#define P3D_LAUNCH(KB)                                                                  \
  err = launch_tiles<KB>(table, tile_points, tile_start, idx, ct, bg_col, denom, logit_max, \
                         xs, ys, C, H, W, n_tiles, n_tx, K, inv_gamma, min_depth, inv_range, \
                         bg_logit, gslot, s)
    if (K <= 1) P3D_LAUNCH(1);
    else if (K <= 2) P3D_LAUNCH(2);
    else if (K <= 4) P3D_LAUNCH(4);
    else if (K <= 8) P3D_LAUNCH(8);
    else if (K <= 16) P3D_LAUNCH(16);
    else P3D_LAUNCH(32);
#undef P3D_LAUNCH
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = static_cast<long long>(P) * (5 + C);
  const int threads = 256;
  pulsar_grad_combine_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                               s>>>(gslot, slot_rows, sphere_start, P, 5 + C, dtable);
  return static_cast<int>(cudaGetLastError());
}
