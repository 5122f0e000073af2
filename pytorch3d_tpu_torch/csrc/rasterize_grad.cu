// Backward of the fine mesh rasterizer for Hopper (sm_90a): the gradient of
// (zbuf, bary, dists) with respect to the face vertices, given the
// forward's per-pixel face ids and the cotangents of the three outputs.
//
// Replaces the TPU kernel `_grad_kernel`
// (pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:809, launched by the
// pallas_call at :1092 in `rasterize_grad_pallas`, :1008, from `_rfp_bwd`,
// :1283).  It computes the same function as the plain PyTorch version
// `rasterize_grad_plain` (pytorch3d_tpu_torch/renderer/mesh/
// rasterize_meshes.py): autograd's reverse of `_fragments_from_gathered`
// at every filled slot, summed per face.  Empty slots (id < 0) add nothing,
// nor does a slot whose cotangents are all zero.
//
// Design: per-tile face sums, then a fixed-order sum per face; no atomics,
// so two runs give the same bits.  The TPU kernel reduces per tile slot
// over a sequential grid and then takes a segment_sum; here the forward's
// binning (16x16 pixel tiles, each with the exact list of the faces that
// may cover it, ascending id: `bin_faces`) gives every (tile, face) pair a
// row of a (pairs, 9) table.
//
// Pass 1 (`rasterize_grad_tiles_kernel`): one block of 256 threads per
// tile, warp w on the tile's rows 2w and 2w + 1, one lane per pixel.  A
// warp reads its pixels' ids 4 slot depths at a time, and the lanes whose
// slot is filled append (lane, depth) to the warp's ring of slots in
// shared memory, so that the ~60 % of empty slots cost no lane of
// `slot_grad`.  Every 32 queued slots, one per lane, read their
// cotangents (a slot whose cotangents are all zero adds nothing), find
// their face's position in the tile's list (a binary search in shared
// memory) and are differentiated by `slot_grad` (the plain version's
// reverse, op for op).  The warp then sorts its lanes by (list position,
// lane) with a bitonic network of shuffles and sums each run of one
// position with a segmented scan: a fixed cost whatever the faces, where
// summing face by face costs 45 shuffles per distinct face, and a batch
// of mixed depths holds many.  The run's last lane adds the sum to the
// warp's own accumulator row of that position.  After the walk the block
// adds the 8 warps' rows in warp order and writes the tile's rows of the
// table.  A list longer than 128 faces is summed 128 positions a pass,
// each pass taking the slots whose face id falls in its part of the list
// (the textured-mesh fit's longest list is 142; chip_smoke.py drives
// lists of up to 3846 faces, 31 passes, and grad_study.py --conditioning
// finds the sums the same, to rounding, with lists cut at other faces).
// A slot whose face is not in its tile's list (or an id >= F) sets the
// error flag, on which the wrapper raises.
//
// Pass 2 (`rasterize_grad_faces_kernel`): one thread per (face, component)
// adds the face's rows in ascending tile order, through the face-major CSR
// of the rows the wrapper builds (a stable sort of the pairs by face).
//
// The reverse mirrors autograd's on the plain version operation by
// operation: division by (area + eps) rather than a reciprocal; the
// perspective denominator's clamp at eps and the clip's clamps pass the
// gradient where the input is >= the bound, as torch.clamp's backward does;
// `inside` is taken from the unclipped (perspective-corrected) bary; the
// segment distance is reversed through its projection parameter t (the
// TPU kernel's closed form drops the term (diff . v) dt, which is zero only
// in exact arithmetic); torch.minimum splits a tie's cotangent evenly
// between its two arguments, in the plain version's order
// min(min(e01, e02), e12).
//
// A band of rows (the backward of `rasterize_fragments_pallas_band`,
// rasterize_pallas.py:1346, which runs the TPU kernel with a tile-row
// offset): ids and cotangents of rows [row0, row0 + rows) of the H x W
// image, binned into 16x16 tiles starting at row0, as the forward's band
// was.  A pixel's centre is read at its image row (row0 + its band row),
// so every slot's partials are the full image's; the band's face sums
// cover its own pixels, and the caller adds the bands' gradients (a
// collective across the devices that rasterized them).  The full image is
// the band (0, H), the same code.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32, half
// of that without FMA contraction).  Every slot's id is read once (4
// bytes), the cotangents of the filled slots (20 bytes a slot when all
// three are given), and each filled slot costs ~322 fp32 operations
// (forward recompute and reverse, counted in chip_smoke.py's
// grad_ops_per_slot).  At the textured-mesh fit's 8 views of 512^2 with
// K=16, where ~40 % of the slots are filled, the operations bind: 0.13 ms,
// against 0.12 ms for the bytes.  Measured (chip_smoke.py and
// grad_study.py --breakdown, NVIDIA H100 80GB HBM3 at 700 W): 1.3-1.4 ms
// there (pass 2 under 1 %), 0.06 ms at the headline's ico4 at K=8.  Of
// pass 1, `slot_grad` takes ~65 % (its IEEE divisions are multi-
// instruction sequences, kept so that the reverse is the plain version's
// op for op), the walk, queue and batch loads ~30 %, the sort and scan
// ~14 % (the parts overlap).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kEpsilon = 1e-8f;
constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;
constexpr int kWarps = kThreads / 32;
constexpr int kListChunk = 128;  // tile-list positions whose sums one pass holds
constexpr int kQueue = 256;      // a warp's ring of queued slots (31 + 4 x 32 at most)
constexpr int kDepths = 4;       // slot depths whose ids a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

struct Seg {
  float vx, vy, qx, qy, num, L, traw, t, dx, dy;
  bool degenerate;
};

// Forward of point_line_segment_distance2(p, a, b), keeping what the
// reverse needs.
__device__ __forceinline__ float seg_fwd(float px, float py, float ax, float ay,
                                         float bx, float by, Seg& s) {
  s.vx = bx - ax;
  s.vy = by - ay;
  const float l2 = s.vx * s.vx + s.vy * s.vy;
  s.qx = px - ax;
  s.qy = py - ay;
  s.num = s.vx * s.qx + s.vy * s.qy;
  s.L = fmaxf(l2, kEpsilon);
  s.traw = s.num / s.L;
  s.degenerate = l2 <= kEpsilon;
  s.t = s.degenerate ? 1.0f : fminf(fmaxf(s.traw, 0.0f), 1.0f);
  s.dx = px - (ax + s.t * s.vx);
  s.dy = py - (ay + s.t * s.vy);
  return s.dx * s.dx + s.dy * s.dy;
}

// Reverse of seg_fwd with cotangent g, accumulated into the endpoints.
__device__ __forceinline__ void seg_bwd(const Seg& s, float g, float& gax, float& gay,
                                        float& gbx, float& gby) {
  if (g == 0.0f) return;
  const float gdx = g * s.dx + g * s.dx;  // d*d: both factors
  const float gdy = g * s.dy + g * s.dy;
  // proj = a + t * v; d = p - proj
  const float gpx = -gdx, gpy = -gdy;
  gax += gpx;
  gay += gpy;
  float gvx = gpx * s.t;
  float gvy = gpy * s.t;
  if (!s.degenerate && s.traw >= 0.0f && s.traw <= 1.0f) {
    const float gt = gpx * s.vx + gpy * s.vy;
    const float gnum = gt / s.L;
    // num = v . q with q = p - a
    gvx += gnum * s.qx;
    gvy += gnum * s.qy;
    gax -= gnum * s.vx;
    gay -= gnum * s.vy;
    // L = max(l2, eps) passes here, as l2 > eps; l2 = v . v
    const float gl2 = -gt * s.num / (s.L * s.L);
    gvx += gl2 * s.vx + gl2 * s.vx;
    gvy += gl2 * s.vy + gl2 * s.vy;
  }
  // v = b - a
  gax -= gvx;
  gay -= gvy;
  gbx += gvx;
  gby += gvy;
}

// edge_function(p, a, b) = A*B - C*D with A = px-ax, B = by-ay,
// C = py-ay, D = bx-ax, kept for the reverse.
struct Edge {
  float A, B, C, D;
};

__device__ __forceinline__ float edge_fwd(float px, float py, float ax, float ay,
                                          float bx, float by, Edge& e) {
  e.A = px - ax;
  e.B = by - ay;
  e.C = py - ay;
  e.D = bx - ax;
  return e.A * e.B - e.C * e.D;
}

// Reverse of edge_fwd with cotangent g; p is a pixel centre (no gradient)
// unless gp is given.
__device__ __forceinline__ void edge_bwd(const Edge& e, float g, float* gp, float& gax,
                                         float& gay, float& gbx, float& gby) {
  const float gA = g * e.B, gB = g * e.A, gC = -(g * e.D), gD = -(g * e.C);
  if (gp != nullptr) {
    gp[0] += gA;
    gp[1] += gC;
  }
  gax -= gA;
  gbx += gD;
  gax -= gD;
  gby += gB;
  gay -= gB;
  gay -= gC;
}

// The 9 partials (v0x, v0y, z0, v1x, ..., z2) of one filled slot: the plain
// version's forward fragment math for face `v` at pixel (px, py), then its
// reverse with cotangents (g_z, gb0..2, gd).
__device__ __forceinline__ void slot_grad(const float* __restrict__ v, float px, float py,
                                          float g_z, float gb0, float gb1, float gb2,
                                          float gd, bool perspective_correct,
                                          bool clip_barycentric_coords, float* out) {
  const float v0x = v[0], v0y = v[1], z0 = v[2];
  const float v1x = v[3], v1y = v[4], z1 = v[5];
  const float v2x = v[6], v2y = v[7], z2 = v[8];

  // ---- forward: barycentric_coords(p, v0, v1, v2) ----
  Edge ea, e0, e1, e2;
  const float area = edge_fwd(v2x, v2y, v0x, v0y, v1x, v1y, ea) + kEpsilon;
  const float ef0 = edge_fwd(px, py, v1x, v1y, v2x, v2y, e0);
  const float ef1 = edge_fwd(px, py, v2x, v2y, v0x, v0y, e1);
  const float ef2 = edge_fwd(px, py, v0x, v0y, v1x, v1y, e2);
  const float w0 = ef0 / area, w1 = ef1 / area, w2 = ef2 / area;

  // barycentric_perspective_correction
  float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, dsum = 0.0f, den = 1.0f;
  float b0 = w0, b1 = w1, b2 = w2;
  if (perspective_correct) {
    t0 = (w0 * z1) * z2;
    t1 = (z0 * w1) * z2;
    t2 = (z0 * z1) * w2;
    dsum = (t0 + t1) + t2;
    den = fmaxf(dsum, kEpsilon);
    b0 = t0 / den;
    b1 = t1 / den;
    b2 = t2 / den;
  }
  const bool inside = b0 > 0.0f && b1 > 0.0f && b2 > 0.0f;

  // barycentric_clip
  float c0 = b0, c1 = b1, c2 = b2, csum = 0.0f, cs = 1.0f;
  float q0 = b0, q1 = b1, q2 = b2;
  if (clip_barycentric_coords) {
    c0 = fmaxf(b0, 0.0f);
    c1 = fmaxf(b1, 0.0f);
    c2 = fmaxf(b2, 0.0f);
    csum = (c0 + c1) + c2;
    cs = fmaxf(csum, 1e-5f);
    q0 = c0 / cs;
    q1 = c1 / cs;
    q2 = c2 / cs;
  }

  // point_triangle_distance2: min(min(e01, e02), e12)
  Seg s01, s02, s12;
  const float d01 = seg_fwd(px, py, v0x, v0y, v1x, v1y, s01);
  const float d02 = seg_fwd(px, py, v0x, v0y, v2x, v2y, s02);
  const float d12 = seg_fwd(px, py, v1x, v1y, v2x, v2y, s12);
  const float m = fminf(d01, d02);

  // ---- reverse ----
  float g0x = 0.0f, g0y = 0.0f, g1x = 0.0f, g1y = 0.0f, g2x = 0.0f, g2y = 0.0f;
  // pz = q0*z0 + q1*z1 + q2*z2; bary output = q
  float gz0 = g_z * q0, gz1 = g_z * q1, gz2 = g_z * q2;
  float gq0 = gb0 + g_z * z0, gq1 = gb1 + g_z * z1, gq2 = gb2 + g_z * z2;

  float gbb0 = gq0, gbb1 = gq1, gbb2 = gq2;
  if (clip_barycentric_coords) {
    const float cs2 = cs * cs;
    float gc0 = gq0 / cs, gc1 = gq1 / cs, gc2 = gq2 / cs;
    if (csum >= 1e-5f) {
      const float gcs = (-(gq0 * c0) / cs2 + -(gq1 * c1) / cs2) + -(gq2 * c2) / cs2;
      gc0 += gcs;
      gc1 += gcs;
      gc2 += gcs;
    }
    gbb0 = b0 >= 0.0f ? gc0 : 0.0f;
    gbb1 = b1 >= 0.0f ? gc1 : 0.0f;
    gbb2 = b2 >= 0.0f ? gc2 : 0.0f;
  }

  float gw0 = gbb0, gw1 = gbb1, gw2 = gbb2;
  if (perspective_correct) {
    const float den2 = den * den;
    float gt0 = gbb0 / den, gt1 = gbb1 / den, gt2 = gbb2 / den;
    if (dsum >= kEpsilon) {
      const float gden = (-(gbb0 * t0) / den2 + -(gbb1 * t1) / den2) + -(gbb2 * t2) / den2;
      gt0 += gden;
      gt1 += gden;
      gt2 += gden;
    }
    // t0 = (w0*z1)*z2
    const float gw0z1 = gt0 * z2;
    gz2 += gt0 * (w0 * z1);
    gw0 = gw0z1 * z1;
    gz1 += gw0z1 * w0;
    // t1 = (z0*w1)*z2
    const float gz0w1 = gt1 * z2;
    gz2 += gt1 * (z0 * w1);
    gz0 += gz0w1 * w1;
    gw1 = gz0w1 * z0;
    // t2 = (z0*z1)*w2
    const float gz0z1 = gt2 * w2;
    gw2 = gt2 * (z0 * z1);
    gz0 += gz0z1 * z1;
    gz1 += gz0z1 * z0;
  }

  // w_i = e_i / area
  const float area2 = area * area;
  const float ge0 = gw0 / area, ge1 = gw1 / area, ge2 = gw2 / area;
  const float garea = (-(gw0 * ef0) / area2 + -(gw1 * ef1) / area2) + -(gw2 * ef2) / area2;
  edge_bwd(e0, ge0, nullptr, g1x, g1y, g2x, g2y);  // e0 = EF(p, v1, v2)
  edge_bwd(e1, ge1, nullptr, g2x, g2y, g0x, g0y);  // e1 = EF(p, v2, v0)
  edge_bwd(e2, ge2, nullptr, g0x, g0y, g1x, g1y);  // e2 = EF(p, v0, v1)
  float garea_p[2] = {0.0f, 0.0f};                  // area = EF(v2, v0, v1) + eps
  edge_bwd(ea, garea, garea_p, g0x, g0y, g1x, g1y);
  g2x += garea_p[0];
  g2y += garea_p[1];

  // dists = where(inside, -d2, d2); torch.minimum splits ties evenly
  if (gd != 0.0f) {
    const float s = inside ? -gd : gd;
    float gm, g12;
    if (m < d12) {
      gm = s;
      g12 = 0.0f;
    } else if (m > d12) {
      gm = 0.0f;
      g12 = s;
    } else {
      gm = s / 2.0f;
      g12 = s / 2.0f;
    }
    float g01, g02;
    if (d01 < d02) {
      g01 = gm;
      g02 = 0.0f;
    } else if (d01 > d02) {
      g01 = 0.0f;
      g02 = gm;
    } else {
      g01 = gm / 2.0f;
      g02 = gm / 2.0f;
    }
    seg_bwd(s01, g01, g0x, g0y, g1x, g1y);
    seg_bwd(s02, g02, g0x, g0y, g2x, g2y);
    seg_bwd(s12, g12, g1x, g1y, g2x, g2y);
  }

  out[0] = g0x;
  out[1] = g0y;
  out[2] = gz0;
  out[3] = g1x;
  out[4] = g1y;
  out[5] = gz1;
  out[6] = g2x;
  out[7] = g2y;
  out[8] = gz2;
}

// The position of `face` in the ascending list[0, m), or -1.
__device__ __forceinline__ int find(const int* list, int m, int face) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < face) lo = mid + 1;
    else hi = mid;
  }
  return lo < m && list[lo] == face ? lo : -1;
}

struct Cots {
  float z, b0, b1, b2, d;
  __device__ bool any() const { return z != 0.0f || b0 != 0.0f || b1 != 0.0f || b2 != 0.0f || d != 0.0f; }
};

__device__ __forceinline__ Cots load_cots(const float* gz, const float* gbary, const float* gdists,
                                          long long o) {
  Cots c;
  c.z = gz != nullptr ? gz[o] : 0.0f;
  c.b0 = gbary != nullptr ? gbary[3 * o + 0] : 0.0f;
  c.b1 = gbary != nullptr ? gbary[3 * o + 1] : 0.0f;
  c.b2 = gbary != nullptr ? gbary[3 * o + 2] : 0.0f;
  c.d = gdists != nullptr ? gdists[o] : 0.0f;
  return c;
}

// Three blocks an SM: 85 registers, a few spilled, ~13 % faster than two at
// the textured-mesh fit's shape (and ~7 % slower at the headline's).
__global__ void __launch_bounds__(kThreads, 3)
rasterize_grad_tiles_kernel(const float* __restrict__ face_verts,  // (N*F, 9)
                            const int* __restrict__ tile_faces,    // (pairs,) local ids
                            const int* __restrict__ tile_start,    // (N*n_ty*n_tx + 1,)
                            const int* __restrict__ idx,           // (N, rows, W, K) local ids
                            const float* __restrict__ gz,          // (N, rows, W, K) or null
                            const float* __restrict__ gbary,       // (N, rows, W, K, 3) or null
                            const float* __restrict__ gdists,      // (N, rows, W, K) or null
                            const float* __restrict__ xs,          // (W,) NDC x of columns
                            const float* __restrict__ ys,          // (H,) NDC y of the image's rows
                            int F, int band0, int rows, int W, int K, int n_ty, int n_tx,
                            bool perspective_correct, bool clip_barycentric_coords,
                            float* __restrict__ gpair,  // (pairs, 9)
                            int* __restrict__ error)    // set to 1 on a face missing from its list
{
  __shared__ int s_face[kListChunk];
  __shared__ float s_acc[kWarps][kListChunk * 9];
  __shared__ int s_queue[kWarps][kQueue];  // lane | depth << 5

  const int tile = blockIdx.x;
  const int n = tile / (n_ty * n_tx);
  const int ty = (tile - n * n_ty * n_tx) / n_tx;
  const int tx = tile - n * n_ty * n_tx - ty * n_tx;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int row0 = ty * kTileH + 2 * warp;  // the warp's first row of the band
  const int col0 = tx * kTileW;
  const bool live = row0 + (lane >> 4) < rows && col0 + (lane & 15) < W;
  const float* verts = face_verts + static_cast<long long>(n) * F * 9;
  float* acc = s_acc[warp];
  int* queue = s_queue[warp];
  const int begin = tile_start[tile];
  const int end = tile_start[tile + 1];

  // The offset of lane l's slot at depth k into the (N, rows, W, K) arrays.
  auto slot = [&](int l, int k) -> long long {
    return ((static_cast<long long>(n) * rows + row0 + (l >> 4)) * W + col0 + (l & 15)) * K + k;
  };

  // Differentiate 32 queued slots from ring position `head` (the first
  // `count` of them live), one per lane, and add their partials per face
  // to the warp's rows of the list chunk s_face[0, m): the lanes are
  // sorted by (list position, lane), then a segmented scan sums each run
  // of one position, and the run's last lane adds it to the row.  Fixed
  // shuffles whatever the faces, and a fixed order: two runs agree bit
  // for bit.
  auto sum_queued = [&](int head, int count, int m) {
    int pos = -1;  // the slot's list position; -1: no work
    float g[9] = {};
    if (lane < count) {
      const int e = queue[(head + lane) & (kQueue - 1)];
      const int l = e & 31;
      const long long o = slot(l, e >> 5);
      const int f = idx[o];
      const Cots c = load_cots(gz, gbary, gdists, o);
      if (c.any()) {
        pos = find(s_face, m, f);
        if (pos < 0) {
          *error = 1;
        } else {
          slot_grad(verts + static_cast<long long>(f) * 9, xs[col0 + (l & 15)], ys[band0 + row0 + (l >> 4)],
                    c.z, c.b0, c.b1, c.b2, c.d, perspective_correct, clip_barycentric_coords, g);
        }
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
    float v[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      v[c] = __shfl_sync(kFull, g[c], src);
      if (mine < 0) v[c] = 0.0f;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up_pos = __shfl_up_sync(kFull, mine, d);  // every lane takes part
      const bool join = lane >= d && up_pos == mine;
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const float up = __shfl_up_sync(kFull, v[c], d);
        if (join) v[c] += up;
      }
    }
    const int next = __shfl_down_sync(kFull, mine, 1);
    if (mine >= 0 && (lane == 31 || next != mine)) {
#pragma unroll
      for (int c = 0; c < 9; ++c) acc[mine * 9 + c] += v[c];
    }
    __syncwarp();
  };

  // One pass per chunk of up to kListChunk list positions (one pass for an
  // empty list, whose slots can only be errors).  Pass c takes the slots
  // whose face id lies in [its first id, the next chunk's first id), so
  // every slot with work is taken by exactly one pass.
  for (int c0 = begin;; c0 += kListChunk) {
    const int m = max(0, min(kListChunk, end - c0));
    __syncthreads();  // the previous pass's rows are written
    for (int j = threadIdx.x; j < m; j += kThreads) s_face[j] = tile_faces[c0 + j];
    for (int e = lane; e < m * 9; e += 32) acc[e] = 0.0f;
    __syncthreads();
    const int lo_face = c0 == begin ? INT_MIN : s_face[0];
    const int hi_face = c0 + m < end ? tile_faces[c0 + m] : INT_MAX;  // exclusive
    int head = 0, queued = 0;
    for (int k0 = 0; k0 < K; k0 += kDepths) {
      int f[kDepths];
#pragma unroll
      for (int u = 0; u < kDepths; ++u) f[u] = live && k0 + u < K ? idx[slot(lane, k0 + u)] : -1;
#pragma unroll
      for (int u = 0; u < kDepths; ++u) {
        if (f[u] >= F) *error = 1;  // no such face
        const bool take = f[u] >= 0 && f[u] < F && f[u] >= lo_face && f[u] < hi_face;
        const unsigned took = __ballot_sync(kFull, take);
        if (take) queue[(head + queued + __popc(took & below)) & (kQueue - 1)] = lane | (k0 + u) << 5;
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
    for (int e = threadIdx.x; e < m * 9; e += kThreads) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_acc[w][e];
      gpair[static_cast<long long>(c0) * 9 + e] = sum;
    }
    if (c0 + kListChunk >= end) break;
  }
}

// One thread per (face, component): the face's rows in ascending tile order.
__global__ void __launch_bounds__(kThreads)
rasterize_grad_faces_kernel(const float* __restrict__ gpair,      // (pairs, 9)
                            const int* __restrict__ pair_rows,    // (pairs,) face-major
                            const int* __restrict__ face_start,   // (N*F + 1,)
                            long long faces,
                            float* __restrict__ grad)             // (N*F, 9)
{
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= faces * 9) return;
  const long long face = i / 9;
  const int c = static_cast<int>(i - face * 9);
  float sum = 0.0f;
  for (int q = face_start[face]; q < face_start[face + 1]; ++q) {
    sum += gpair[static_cast<long long>(pair_rows[q]) * 9 + c];
  }
  grad[i] = sum;
}

}  // namespace

// The pixel tile (rows, cols) of one block of pass 1, which the binning
// must use.
extern "C" void rasterize_grad_tile(int* rows, int* cols) {
  *rows = kTileH;
  *cols = kTileW;
}

// Both passes on `stream` over rows [row0, row0 + rows) of N H x W images
// (the full image: row0 = 0, rows = H; idx and the cotangents are (N, rows,
// W, K), binned into n_ty = ceil(rows / 16) tile rows from row0): writes
// every entry of `grad` (N*F*9 floats) and sets *error (zeroed by the
// caller) where a slot's face is missing from its tile's list.  gpair is
// the wrapper's (max(pairs, 1), 9) scratch.  Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for a shape
// this build does not take.
extern "C" int rasterize_grad(const float* face_verts, const int* tile_faces, const int* tile_start,
                              const int* pair_rows, const int* face_start, const int* idx,
                              const float* gz, const float* gbary, const float* gdists,
                              const float* xs, const float* ys, int N, int F, int H, int W,
                              int row0, int rows, int K, int n_ty, int n_tx,
                              int perspective_correct, int clip_barycentric_coords, float* gpair,
                              int* error, float* grad, void* stream) {
  const long long n_tiles = static_cast<long long>(N) * n_ty * n_tx;
  if (N < 1 || F < 1 || H < 1 || W < 1 || K < 1 || row0 < 0 || rows < 1 || row0 + rows > H ||
      n_ty != (rows + kTileH - 1) / kTileH || n_tx != (W + kTileW - 1) / kTileW ||
      n_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rasterize_grad_tiles_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      face_verts, tile_faces, tile_start, idx, gz, gbary, gdists, xs, ys, F, row0, rows, W, K, n_ty, n_tx,
      perspective_correct != 0, clip_barycentric_coords != 0, gpair, error);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long faces = static_cast<long long>(N) * F;
  rasterize_grad_faces_kernel<<<static_cast<unsigned>((faces * 9 + kThreads - 1) / kThreads), kThreads,
                                0, s>>>(gpair, pair_rows, face_start, faces, grad);
  return static_cast<int>(cudaGetLastError());
}
