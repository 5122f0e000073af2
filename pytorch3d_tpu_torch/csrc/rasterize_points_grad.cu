// Backward of the points rasterizer for Hopper (sm_90a): the gradient of
// (zbuf, dists) with respect to the points, given the forward's per-pixel
// point ids and the cotangents of the two outputs.
//
// Replaces the TPU kernel `_grad_kernel`
// (pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:365, launched by
// the pallas_call at :562 in `_rpf_bwd`, :531).  It computes the same
// function as the plain PyTorch version `rasterize_points_grad_plain`
// (pytorch3d_tpu_torch/renderer/points/rasterize_points.py): autograd's
// reverse of `recompute_point_fragments`, where a filled slot holding point
// p at pixel (px, py) has zbuf = z_p and dists = (px - x_p)^2 + (py - y_p)^2,
// so it adds gz to dz_p, -2 (px - x_p) gd to dx_p and -2 (py - y_p) gd to
// dy_p.  Empty slots (id < 0) add nothing, and the radius gets no gradient.
//
// Design.  The TPU kernel walks each tile's point list, masks the K slots of
// every pixel against each point and reduces per tile slot, then a
// segment_sum gathers the slots per point: a sequential grid with no
// scatter.  On Hopper blocks run unordered and fp32 atomics in L2 are cheap,
// so here one thread takes one (pixel, slot) of the whole batch, reads its
// id and cotangents and the point's x and y, and adds its three partials
// into an fp32 (N*P, 3) buffer that the wrapper zeroes.  It needs no bins.
// A null cotangent pointer stands for zeros (an output the loss does not
// use: PointsRenderer reads only dists), and a slot whose cotangents are
// both zero adds nothing.  2 * (gd * dx) equals autograd's
// gd * dx + gd * dx exactly; only the order of the atomic adds differs from
// run to run, as it does for the plain version's index_add_ on the card.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s fp32).  It
// does 9 operations per filled slot (three of them atomic adds) and reads
// 4 bytes of id per slot, the given cotangents (4 bytes each) at the
// filled slots and x and y of each point a slot holds with gd != 0, and
// writes the (N*P, 3) gradient: the bytes bind, at 0.0079 ms for the
// points-fit step (8 x 256^2, K = 10, 6 % of the slots filled) by
// chip_smoke.py's count.  On an "NVIDIA H100 80GB HBM3, 700.00 W" the
// profiler put its device time at 0.032 ms there, 4x the bound; what the
// rest is made of (launch, atomics, the divisions of the slot index) is not
// measured apart yet.  Threads of a warp take 32 consecutive (pixel, slot)
// entries, so the id and cotangent reads are contiguous.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rasterize_points_grad_kernel(const float* __restrict__ points,  // (N*P, 3)
                             const int* __restrict__ idx,       // (N, H, W, K) local ids
                             const float* __restrict__ gz,      // (N, H, W, K) or null
                             const float* __restrict__ gdists,  // (N, H, W, K) or null
                             const float* __restrict__ xs,      // (W,) NDC x of columns
                             const float* __restrict__ ys,      // (H,) NDC y of rows
                             int P, int H, int W, int K, long long slots,
                             float* __restrict__ grad)  // (N*P, 3), zeroed
{
  const long long o = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= slots) return;
  const int p = idx[o];
  if (p < 0) return;
  const float g_z = gz != nullptr ? gz[o] : 0.0f;
  const float g_d = gdists != nullptr ? gdists[o] : 0.0f;
  if (g_z == 0.0f && g_d == 0.0f) return;

  const long long pix = o / K;
  const long long hw = static_cast<long long>(H) * W;
  const long long n = pix / hw;
  const int rem = static_cast<int>(pix - n * hw);
  const int row = rem / W;
  const int col = rem - row * W;
  const long long g = n * P + p;
  if (g_d != 0.0f) {
    const float dx = xs[col] - points[3 * g + 0];
    const float dy = ys[row] - points[3 * g + 1];
    atomicAdd(grad + 3 * g + 0, -2.0f * (g_d * dx));
    atomicAdd(grad + 3 * g + 1, -2.0f * (g_d * dy));
  }
  if (g_z != 0.0f) atomicAdd(grad + 3 * g + 2, g_z);
}

}  // namespace

// Adds the gradient into `grad` (N*P*3 floats, zeroed by the caller).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape this build does not take.
extern "C" int rasterize_points_grad(const float* points, const int* idx, const float* gz,
                                     const float* gdists, const float* xs, const float* ys,
                                     int N, int P, int H, int W, int K, float* grad,
                                     void* stream) {
  if (N < 1 || P < 1 || H < 1 || W < 1 || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slots = static_cast<long long>(N) * H * W * K;
  const long long blocks = (slots + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rasterize_points_grad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      points, idx, gz, gdists, xs, ys, P, H, W, K, slots, grad);
  return static_cast<int>(cudaGetLastError());
}
