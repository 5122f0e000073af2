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
// at every filled slot, summed per face.  Empty slots (id < 0) add nothing.
//
// Design.  The TPU kernel walks each tile's whole face list, masks the K
// slots of every pixel against each face, differentiates over the tile and
// reduces per tile slot, then a segment_sum gathers the slots per face: a
// sequential grid with no scatter.  On Hopper blocks run unordered and
// fp32 atomics in L2 are cheap, so here one thread takes one (pixel, slot)
// of the whole batch: it reads the slot's id and cotangents, loads the
// face's 9 floats (L1/L2 hits: neighbouring pixels share faces),
// recomputes the plain path's forward fragment math for that face at that
// pixel, runs its reverse by hand and adds the 9 partials into an fp32
// (N*F, 9) buffer that the wrapper zeroes.  A warp holds 32 neighbouring
// pixels at one slot depth, which mostly hold the same few faces: the
// lanes sum their partials per face with shuffles and one lane per face
// issues the atomics, so atomics scale with (warp, face) pairs rather than
// with slots.  Work is in proportion to the filled slots, not to the
// (pixel, face) candidates the forward tests, and the backward needs no
// bins.  A null cotangent pointer stands for zeros (an output the loss
// does not use), and a slot whose cotangents are all zero adds nothing.
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
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32). Every
// slot's id is read once (4 bytes), the cotangents only at the filled slots
// (20 bytes a slot when all three are given; empty slots add nothing), and
// each filled slot costs ~320 fp32 operations (forward recompute and
// reverse, counted in chip_smoke.py's grad_ops_per_slot) at the 33.5 T
// operations/s that --fmad=false leaves. At the textured-mesh fit's 8 views
// of 512^2 with K=16, where 40 % of the slots are filled, the operations
// bind (~0.13 ms, against ~0.12 ms for ~400 MB); chip_smoke.py computes both
// per run. This kernel still reads the cotangents of empty slots too.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEpsilon = 1e-8f;
constexpr int kThreads = 256;

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

// One thread per (pixel, slot).  A warp holds 32 consecutive pixels at
// one slot depth k (the block's warps take the K depths of those pixels,
// so together they read contiguous ids and cotangents), and neighbouring
// pixels at one depth mostly hold the same face: the lanes sum their
// partials per face with shuffles and one lane per face adds them to the
// gradient with 9 atomics.
__global__ void __launch_bounds__(kThreads)
rasterize_grad_kernel(const float* __restrict__ face_verts,  // (N*F, 9)
                      const int* __restrict__ idx,           // (N, H, W, K) local ids
                      const float* __restrict__ gz,          // (N, H, W, K) or null
                      const float* __restrict__ gbary,       // (N, H, W, K, 3) or null
                      const float* __restrict__ gdists,      // (N, H, W, K) or null
                      const float* __restrict__ xs,          // (W,) NDC x of columns
                      const float* __restrict__ ys,          // (H,) NDC y of rows
                      int F, int H, int W, int K, long long pixels,
                      bool perspective_correct, bool clip_barycentric_coords,
                      float* __restrict__ grad)  // (N*F, 9), zeroed
{
  constexpr unsigned kFull = 0xffffffffu;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long warp = t >> 5;
  const int k = static_cast<int>(warp % K);
  const long long pix = (warp / K) * 32 + lane;

  // Every lane stays to the end: the shuffles below need the whole warp.
  long long key = -1;  // global face id n*F + f of a slot with a cotangent
  float g[9] = {};
  if (pix < pixels) {
    const long long o = pix * K + k;
    const int f = idx[o];
    const float g_z = gz != nullptr ? gz[o] : 0.0f;
    const float gb0 = gbary != nullptr ? gbary[3 * o + 0] : 0.0f;
    const float gb1 = gbary != nullptr ? gbary[3 * o + 1] : 0.0f;
    const float gb2 = gbary != nullptr ? gbary[3 * o + 2] : 0.0f;
    const float gd = gdists != nullptr ? gdists[o] : 0.0f;
    if (f >= 0 && (g_z != 0.0f || gb0 != 0.0f || gb1 != 0.0f || gb2 != 0.0f || gd != 0.0f)) {
      const long long hw = static_cast<long long>(H) * W;
      const int n = static_cast<int>(pix / hw);
      const int rem = static_cast<int>(pix - n * hw);
      const int row = rem / W;
      const int col = rem - row * W;
      key = static_cast<long long>(n) * F + f;
      slot_grad(face_verts + key * 9, xs[col], ys[row], g_z, gb0, gb1, gb2, gd,
                perspective_correct, clip_barycentric_coords, g);
    }
  }

  unsigned todo = __ballot_sync(kFull, key >= 0);
  while (todo != 0) {  // warp-uniform: one face per pass
    const int leader = __ffs(todo) - 1;
    const long long face = __shfl_sync(kFull, key, leader);
    const bool mine = key == face;
    todo &= ~__ballot_sync(kFull, mine);
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      float sum = mine ? g[c] : 0.0f;
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) sum += __shfl_xor_sync(kFull, sum, offset);
      if (lane == leader) atomicAdd(grad + face * 9 + c, sum);
    }
  }
}

}  // namespace

// Adds the gradient into `grad` (N*F*9 floats, zeroed by the caller).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape this build does not take.
extern "C" int rasterize_grad(const float* face_verts, const int* idx, const float* gz,
                              const float* gbary, const float* gdists, const float* xs,
                              const float* ys, int N, int F, int H, int W, int K,
                              int perspective_correct, int clip_barycentric_coords,
                              float* grad, void* stream) {
  if (N < 1 || F < 1 || H < 1 || W < 1 || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 32 pixels x K depths per group of K warps.
  const long long pixels = static_cast<long long>(N) * H * W;
  const long long threads = (pixels + 31) / 32 * 32 * K;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rasterize_grad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      face_verts, idx, gz, gbary, gdists, xs, ys, F, H, W, K, pixels,
      perspective_correct != 0, clip_barycentric_coords != 0, grad);
  return static_cast<int>(cudaGetLastError());
}
