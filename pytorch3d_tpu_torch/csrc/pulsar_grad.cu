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
// Design (deterministic, no atomics; work in proportion to the hits).  The
// forward's binning (`bin_points_for_pulsar`: exact CSR lists of the
// spheres that reach each 16x16 tile, ascending id) gives every (tile,
// sphere) pair a slot, a row of a (pairs, 5 + C) table.  Pass 1: one block
// of 256 threads per tile, one thread per pixel (warp w on the tile's rows
// 2w and 2w + 1), holds its pixel's K ids and their weights w_k in
// registers (their colours it reads from the table, which the L1 cache
// keeps near: held in registers they cost spills).  The tile's list is taken 128
// positions a pass (fewer where 5 + C fields and 8 x (4 + C) sums per
// position would not fit the block's shared memory): the pass stages its
// spheres' table rows, and each pixel's hits whose id falls in the pass's
// part of the list find their position q there by binary search.  A hit
// then computes its 4 + C partials once (x, y, r, S, col[C]; dL/dw in the
// pairwise form from the registers), and the warp, one slot depth at a
// time, sorts its 32 lanes' hits by (q, lane) with a bitonic network of
// shuffles and sums each run of one q with a segmented scan into the
// warp's own row of q in shared memory.  After the pass the block adds its
// 8 warps' rows in warp order, applies each sphere's factors and writes
// every slot of the pass (zero where no hit falls).  Pass 2: one thread
// per (sphere, field) adds the sphere's slots in ascending tile order,
// through the per-sphere CSR of slot rows the binning built (a stable sort
// of the pairs by id), into d(table).  Two runs give the same bits.  A hit
// whose sphere is missing from its tile's list (the select, #6, runs on
// the same binning, so the path makes none) flags the sphere, and an id
// >= P flags every sphere; pass 2 writes NaN into a flagged sphere's row,
// so the fault shows in the gradient without a host sync.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32, built without FMA
// contraction: half).  The function reads the ids (4 K B per pixel), the
// cotangent (4 C B), denom and lm (8 B) and the table (4 (5 + C) B per
// sphere) once and writes d(table) once: at pulsar-fit (1024^2, K = 5,
// C = 3, 100 000 spheres) ~46 MB, ~0.014 ms; and it does ~33 + 7 C
// operations per filled hit and 3 C per pair of hits on a pixel (4.5 M hits
// there: ~0.01 ms).  The bytes bind.  The kernel's own work grows with the
// hits (their partials, one sort and scan per slot depth of a warp) and with
// the list (staging its table rows, writing its slots), no longer with
// tile pixels x list length.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;
constexpr int kWarps = kThreads / 32;
constexpr int kListChunk = 128;  // most list positions one pass sums
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

// Four blocks an SM where K <= 8 (64 registers a thread, no spills: ~20 %
// faster at pulsar-fit than no floor); no floor for the longer K buffers.
template <int KB>
__global__ void __launch_bounds__(kThreads, KB <= 8 ? 4 : 1)
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
                         int P, int C, int H, int W, int n_tx, int K, int chunk,
                         float inv_gamma, float min_depth, float inv_range, float bg_logit,
                         float* __restrict__ gslot,  // (pairs, F)
                         int* __restrict__ flagged)  // (P + 1,): a missing sphere; [P]: an id >= P
{
  extern __shared__ float smem[];
  const int F = 5 + C;
  const int R = 4 + C;  // partial sums per (warp, position): x, y, r, S, col[C]
  int* s_id = reinterpret_cast<int*>(smem);                  // (chunk,)
  float* s_data = reinterpret_cast<float*>(s_id + chunk);    // (F, chunk)
  float* s_acc = s_data + static_cast<size_t>(F) * chunk;    // (kWarps, chunk, R)

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
  float* acc = s_acc + static_cast<size_t>(warp) * chunk * R;

  int ids[KB];
  float wk[KB];  // the forward's weight (o clos) e of each selected sphere
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    ids[k] = (live && k < K) ? idx[pix * K + k] : -1;
    if (ids[k] >= P) {  // no such sphere: flag them all
      flagged[P] = 1;
      ids[k] = -1;
    }
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
      const float* t = table + static_cast<size_t>(ids[k]) * F;
      const float zn = fminf(fmaxf(1.0f - (t[2] - min_depth) * inv_range, 0.0f), 1.0f);
      const float dx = px - t[0], dy = py - t[1];
      const float clos = fminf(fmaxf(1.0f - (dx * dx + dy * dy) / (t[3] * t[3]), 0.0f), 1.0f);
      wk[k] = t[4] * clos * expf(t[4] * zn * inv_gamma - lm);
    }
  }

  const int begin = tile_start[tile];
  const int end = tile_start[tile + 1];
  // One pass per chunk of list positions (one pass for an empty list, whose
  // hits can only be faults).  Pass c takes the hits whose id lies in [its
  // first id, the next chunk's first id), so every hit is taken once.
  for (int c0 = begin;; c0 += chunk) {
    const int m = max(0, min(chunk, end - c0));
    __syncthreads();  // the previous pass's slots are written
    for (int e = tid; e < m * F; e += kThreads) {
      const int j = e / F, f = e - j * F;
      const int p = tile_points[c0 + j];
      if (f == 0) s_id[j] = p;
      s_data[f * chunk + j] = table[static_cast<size_t>(p) * F + f];
    }
    for (int e = lane; e < m * R; e += 32) acc[e] = 0.0f;
    __syncthreads();
    const int lo_id = c0 == begin ? INT_MIN : s_id[0];
    const int hi_id = c0 + m < end ? tile_points[c0 + m] : INT_MAX;  // exclusive

#pragma unroll 1  // one round per slot depth; unrolled, the rounds spill
    for (int k = 0; k < K; ++k) {
      int id = -1;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) id = kk == k ? ids[kk] : id;
      const bool take = id >= 0 && id >= lo_id && id < hi_id;
      if (!__any_sync(kFull, take)) continue;  // uniform across the warp
      const int q = take ? find(s_id, m, id) : -1;
      if (take && q < 0) flagged[id] = 1;  // missing from its tile's list
      float gx = 0.0f, gy = 0.0f, gr = 0.0f, gS = 0.0f, w0 = 0.0f;
      if (q >= 0) {
        const float cx = s_data[0 * chunk + q], cy = s_data[1 * chunk + q];
        const float cz = s_data[2 * chunk + q], cr = s_data[3 * chunk + q];
        const float co = s_data[4 * chunk + q];
        const float zn = fminf(fmaxf(1.0f - (cz - min_depth) * inv_range, 0.0f), 1.0f);
        const float e = expf(co * zn * inv_gamma - lm);
        const float dx = px - cx, dy = py - cy;
        const float d2 = dx * dx + dy * dy;
        const float u = 1.0f - d2 / (cr * cr);
        const float clos = fminf(fmaxf(u, 0.0f), 1.0f);
        w0 = clos * e;
        float A = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float cj = s_data[(5 + c) * chunk + q];
          float num = w_bg * (cj - bg_col[c]);  // (col_jc - I_c) denom
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) {
            if (ids[kk] >= 0) num += wk[kk] * (cj - table[static_cast<size_t>(ids[kk]) * F + 5 + c]);
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

      // Sort the warp's hits by (q, lane), lanes without one last, then sum
      // each run of one q with a segmented scan; the run's last lane adds
      // its sums to the warp's row of q.  A fixed order: two runs agree bit
      // for bit.
      int key = q >= 0 ? (q << 5) | lane : INT_MAX;
#pragma unroll
      for (int kb = 2; kb <= 32; kb <<= 1) {
#pragma unroll
        for (int jb = kb >> 1; jb > 0; jb >>= 1) {
          const int other = __shfl_xor_sync(kFull, key, jb);
          key = (((lane & jb) == 0) == ((lane & kb) == 0)) ? min(key, other) : max(key, other);
        }
      }
      const int mine = key == INT_MAX ? -1 : key >> 5;
      const int src = key & 31;
      unsigned join = 0;  // bit s: the scan's step 2^s adds the lane 2^s below
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int up = __shfl_up_sync(kFull, mine, 1 << s);  // every lane takes part
        if (lane >= (1 << s) && up == mine) join |= 1u << s;
      }
      const int next = __shfl_down_sync(kFull, mine, 1);
      const bool last = mine >= 0 && (lane == 31 || next != mine);
      for (int r = 0; r < R; ++r) {
        float v = r == 0 ? gx : r == 1 ? gy : r == 2 ? gr : r == 3 ? gS : w0 * (ct[pix * C + r - 4] * inv_denom);
        v = __shfl_sync(kFull, v, src);
        if (mine < 0) v = 0.0f;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          const float up = __shfl_up_sync(kFull, v, 1 << s);
          if (join & (1u << s)) v += up;
        }
        if (last) acc[mine * R + r] += v;
      }
      __syncwarp();
    }
    __syncthreads();
    // The pass's slots: the 8 warps' rows in warp order, then the
    // per-sphere factors.
    for (int e = tid; e < m * F; e += kThreads) {
      const int j = e / F, f = e - j * F;
      const int r = f < 2 ? f : (f == 3 ? 2 : (f < 5 ? 3 : f - 1));  // field -> partial
      float sum = 0.0f;
      for (int w = 0; w < kWarps; ++w) sum += s_acc[(static_cast<size_t>(w) * chunk + j) * R + r];
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
      gslot[static_cast<size_t>(c0 + j) * F + f] = g;
    }
    if (c0 + chunk >= end) break;
  }
}

__global__ void pulsar_grad_combine_kernel(const float* __restrict__ gslot,     // (pairs, F)
                                           const int* __restrict__ slot_rows,   // (pairs,)
                                           const int* __restrict__ sphere_start,  // (P + 1,)
                                           const int* __restrict__ flagged,     // (P + 1,)
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
  dtable[i] = (flagged[p] | flagged[P]) ? __int_as_float(0x7fc00000) : sum;
}

template <int KB>
cudaError_t launch_tiles(const float* table, const int* tile_points, const int* tile_start,
                         const int* idx, const float* ct, const float* bg_col,
                         const float* denom, const float* logit_max, const float* xs,
                         const float* ys, int P, int C, int H, int W, int n_tiles, int n_tx, int K,
                         float inv_gamma, float min_depth, float inv_range, float bg_logit,
                         float* gslot, int* flagged, cudaStream_t stream) {
  // List positions per pass: as many as the block's shared memory holds, at
  // most kListChunk (each takes its id, 5 + C fields and kWarps x (4 + C)
  // sums).
  int device = 0, max_bytes = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return err;
  const size_t per_position = (1 + static_cast<size_t>(5 + C) + static_cast<size_t>(kWarps) * (4 + C)) * 4;
  const int chunk = static_cast<int>(std::min<size_t>(kListChunk, static_cast<size_t>(max_bytes) / per_position));
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t bytes = per_position * chunk;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(pulsar_grad_tiles_kernel<KB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  pulsar_grad_tiles_kernel<KB><<<n_tiles, dim3(kTileW, kTileH), bytes, stream>>>(
      table, tile_points, tile_start, idx, ct, bg_col, denom, logit_max, xs, ys, P, C, H, W,
      n_tx, K, chunk, inv_gamma, min_depth, inv_range, bg_logit, gslot, flagged);
  return cudaGetLastError();
}

}  // namespace

// The pixel tile (rows, cols) of one block, which the binning must use.
extern "C" void pulsar_grad_tile(int* rows, int* cols) {
  *rows = kTileH;
  *cols = kTileW;
}

// Both passes on `stream`; gslot (pairs, 5 + C) is the wrapper's scratch and
// flagged its (P + 1,) int32 zeros.  Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for a K, C or size this
// build does not take (C is bounded only by one list position's 36 C + 152
// bytes fitting in a block's shared memory: C <= 6452 in the 227 KiB of an
// H100).
extern "C" int pulsar_grad(const float* table, const int* tile_points, const int* tile_start,
                           const int* idx, const float* ct, const float* bg_col,
                           const float* denom, const float* logit_max, const float* xs,
                           const float* ys, const int* slot_rows, const int* sphere_start,
                           int P, int C, int H, int W, int n_ty, int n_tx, int K, int pairs,
                           float inv_gamma, float min_depth, float inv_range, float bg_logit,
                           float* gslot, int* flagged, float* dtable, void* stream) {
  if (K < 1 || K > 32 || C < 1 || P < 1 || H < 1 || W < 1 ||
      n_ty != (H + kTileH - 1) / kTileH || n_tx != (W + kTileW - 1) / kTileW ||
      static_cast<long long>(n_ty) * n_tx > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_ty * n_tx;
  cudaError_t err = cudaSuccess;
#define P3D_LAUNCH(KB)                                                                          \
  err = launch_tiles<KB>(table, tile_points, tile_start, idx, ct, bg_col, denom, logit_max, xs, \
                           ys, P, C, H, W, n_tiles, n_tx, K, inv_gamma, min_depth, inv_range,      \
                           bg_logit, gslot, flagged, s)
  if (K <= 1) P3D_LAUNCH(1);
  else if (K <= 2) P3D_LAUNCH(2);
  else if (K <= 4) P3D_LAUNCH(4);
  else if (K <= 8) P3D_LAUNCH(8);
  else if (K <= 16) P3D_LAUNCH(16);
  else P3D_LAUNCH(32);
#undef P3D_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(P) * (5 + C);
  const int threads = 256;
  pulsar_grad_combine_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                               s>>>(gslot, slot_rows, sphere_start, flagged, P, 5 + C, dtable);
  return static_cast<int>(cudaGetLastError());
}
