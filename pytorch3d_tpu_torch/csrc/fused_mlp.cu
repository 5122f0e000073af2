// Fused ReLU MLP with input skips, and the full NeRF field (trunk + density
// head + view-conditioned colour head), forward and backward, for Hopper
// (sm_90a), float32 throughout.
//
// Replaces the TPU kernels of pytorch3d_tpu/ops/fused_mlp_pallas.py:
//   #10 `_fwd_kernel` (:70)       -> fused_mlp_fwd_kernel<false, SAVE>
//   #11 `_bwd_kernel` (:79)       -> fused_mlp_bwd_prep_kernel
//                                    + fused_mlp_bwd_rows_kernel<false>
//                                    + fused_mlp_bwd_weights_kernel
//                                    + fused_mlp_bwd_reduce_kernel
//   #12 `_nerf_fwd_kernel` (:328) -> fused_mlp_fwd_kernel<true, SAVE>
//   #13 `_nerf_bwd_kernel` (:341) -> the same four with rows_kernel<true>
// #12 is #10's layer chain with the head as its epilogue and #13 is #11's
// reverse with the head's reverse in front, so one compile-time flag (HEAD)
// serves both pairs.
//
// What bounds it on an H100: operations.  At the NeRF model's width
// (8 trunk layers of 256 with the input of 39 concatenated again at layer 5,
// a colour head of 128 fed 27 direction features) a row costs 581,120
// multiply-adds, 1.16 MFLOP, against ~280 bytes of input and output: three
// orders of magnitude above the card's ridge.  The backward does twice the
// forward's multiply-adds (the chain to dx and the weight gradients).
//
// Forward (#10, #12): a block takes BM = 64 rows and keeps their
// activations in shared memory for the whole chain, stored transposed
// (feature-major, act[k * 64 + row]) so a warp reads its 8 rows of one
// feature as two broadcast float4.  Each layer is a 64 x Nout x K product on
// the fp32 CUDA cores (67 TFLOP/s with FMA): 256 threads, warp w owns rows
// 8w..8w+7, lane l owns columns 4l..4l+3 and 128+4l..128+4l+3, so each
// thread keeps an 8 x 8 register tile.  Weights stream from global memory
// (they stay in the 50 MB L2: 2.33 MB a field) through a double-buffered
// shared-memory stage of KT rows.  A layer's output overwrites its input in
// place once every thread has read it.  The input-skip concat is not
// materialised: a layer's product runs over two segments, the hidden
// activations and the block's copy of x.  The Pallas kernels' padding of D
// and Ddir to 128 lanes, of N to 512 rows and of the head's narrow outputs to
// a 128-lane block is TPU layout and is not carried over; the density and rgb
// logits (1 and 3 outputs) are dot products reduced over four quarters of K
// and written as (N, 4).  SAVE (the forward of a training step) also stores
// what the chain computes anyway: every trunk layer's output and, with the
// head, il and the colour hidden h.
//
// Backward (#11, #13).  The Pallas backward recomputes the forward in VMEM
// and adds every row block's weight gradient into one VMEM accumulator, as
// its grid runs in order.  Neither carries over: a Hopper block has 227 KB
// where the TPU kept ~16 MB of layer inputs, and GPU blocks run in parallel
// in no order.  So the backward reads the activations its forward saved and
// runs four launches:
//   0. prep (fused_mlp_bwd_prep_kernel): each weight the reverse reads, copied
//      once per call into a scratch with its rows padded to a multiple of 8
//      and its columns to a multiple of 16, zero-filled, so that the row pass
//      stages every tile with 16-byte cp.async and no bounds tests.
//   1. rows (fused_mlp_bwd_rows_kernel): per 64-row block, the reverse chain
//      g <- mask * (g W^T), the skip split into dx, the head's reverse in
//      front.  The masks are y > 0 of the saved layer outputs: y = max(h, 0),
//      so they equal the forward's h > 0 bit for bit, whatever arithmetic
//      the backward uses.  Each layer's masked gradient goes to the scratch
//      for the weight pass.
//   2. weights (fused_mlp_bwd_weights_kernel): every weight gradient
//      dW = A^T G, A the layer's input ([hidden; x] at a skip), as a product
//      split over the N rows; a block owns a 128 x 128 output tile of one
//      product and one split of the rows, so a 256-wide G is read twice.
//      The bias gradient 1^T G is the column sums that the tile's first
//      m-block takes of the G tiles it stages, written as the row after W,
//      where the flat layout keeps b.
//   3. reduce (fused_mlp_bwd_reduce_kernel): the splits' partial sums added
//      in a fixed order.  No atomics: two calls give the same bits.
// Passes 1 and 2 run on the tensor cores: mma.sync m16n8k8 TF32 with fp32
// accumulation, each operand split into hi (rounded to TF32's 10 mantissa
// bits) and lo = a - hi, and a.b taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.
// One TF32 pass keeps ~11 bits and is ~1e-3 of a gradient's largest entry
// off float64; three passes are as close as float32 (~1e-6), at 495 / 3 =
// 165 TFLOP/s of peak, 2.5x the fp32 CUDA cores'.  The tensor cores truncate
// as they accumulate, so each k-step's three passes go into a fresh tile
// that a rounded fp32 add puts into the sum (one long chain drifted by
// ~1e-4 over 8192 rows).  Shared-memory strides are padded so that every
// fragment load is free of bank conflicts; two blocks of 256 threads fit an
// SM.  Products with at most 64 outputs (dx's x part, d d_embed) spread
// their tiles over all 8 warps.  The scratch holds L masked gradients of
// N x H floats, with the head gil (N x H) and gh (N x Hh), the packed
// weights and the splits' partials; the forward's saved activations are the
// caller's.
// * Built with FMA (fused multiply-add): nothing here needs the rasterizers'
//   bit-exact selection, and the sums run in another order than the plain
//   version's anyway.

#include <cuda_runtime.h>
#include <stdint.h>

#define BM 64      // rows per block
#define NT 256     // threads per block
#define TN 256     // output columns one block covers (32 lanes x 8)
#define KT 8       // weight rows staged per step
#define MAX_L 12   // trunk layers
#define MAX_PROD 16

struct Params {
    int N, D, Ddir, H, Hh, L;
    unsigned skips;  // bit l: layer l concatenates x after the hidden input
    const float* x;
    const float* de;
    const float* g;
    float* out;
    float* dx;
    float* dde;
    const float* w[MAX_L];    // (Kin_l, H) row-major, rows [hidden; x]
    const float* b[MAX_L];
    const float *wd, *bd, *wi, *bi, *wc1a, *wc1b, *bc1, *wc2, *bc2;
    float* ys[MAX_L];  // saved by the forward: each trunk layer's output (N, H)
    float* il;         // saved: (N, H) head intermediate
    float* hs;         // saved: (N, Hh) colour hidden
    float* gs;         // backward scratch: L x (N, H), each layer's masked output gradient
    float* gil;        // (N, H) gradient of il
    float* gh;         // (N, Hh) masked gradient of h
    // The reverse's weights, packed by the prep pass (rows padded to 8,
    // columns to 16, zero-filled): W_l[:H] (H, H) for l > 0; W_0 (D, H) and
    // the skip layers' W_l[H:] (D, H); Wi (H, H), Wc1a (H, Hh), Wc1b (Ddir, Hh).
    const float* wyP[MAX_L];
    const float* wxP[MAX_L];
    const float *wiP, *wc1aP, *wc1bP;
};

__device__ __forceinline__ int col_of(int j, int lane) {
    return j < 4 ? lane * 4 + j : 128 + lane * 4 + (j - 4);
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

__device__ __forceinline__ void fma8x8(float (&acc)[8][8], const float* a, const float* b) {
    const float4 a0 = *reinterpret_cast<const float4*>(a);
    const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b);
    const float4 b1 = *reinterpret_cast<const float4*>(b + 128);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// Thread tid's KT entries of column tid of rows k0..k0+KT-1 of W (K x Nout).
__device__ __forceinline__ void load_w(float (&pre)[KT], const float* __restrict__ W, int K, int Nout, int k0) {
    const int c = threadIdx.x;
#pragma unroll
    for (int j = 0; j < KT; ++j)
        pre[j] = (c < Nout && k0 + j < K) ? __ldg(W + (size_t)(k0 + j) * Nout + c) : 0.0f;
}

// acc += A^T-tile product: acc[i][j] += sum_k A[k * BM + row(i)] * W[k, col(j)],
// A in shared memory (K x BM, feature-major), W (K x Nout) in global memory.
// Ends with a barrier, so the caller may overwrite A.
__device__ void gemm_seg(float (&acc)[8][8], const float* A, int K, const float* __restrict__ W, int Nout,
                         float* ws) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nsteps = (K + KT - 1) / KT;
    float pre[KT];
    load_w(pre, W, K, Nout, 0);
    for (int s = 0; s < nsteps; ++s) {
        float* buf = ws + (s & 1) * KT * TN;
#pragma unroll
        for (int j = 0; j < KT; ++j) buf[j * TN + tid] = pre[j];
        __syncthreads();
        if (s + 1 < nsteps) load_w(pre, W, K, Nout, (s + 1) * KT);
        const float* a = A + (size_t)s * KT * BM + warp * 8;
        const float* b = buf + lane * 4;
        const int kk_end = min(KT, K - s * KT);
        if (kk_end == KT) {
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) fma8x8(acc, a + kk * BM, b + kk * TN);
        } else {
            for (int kk = 0; kk < kk_end; ++kk) fma8x8(acc, a + kk * BM, b + kk * TN);
        }
    }
    __syncthreads();
}

// out[j][row] = bias[j] + sum_k A[k * BM + row] * w[k * NJ + j] for j < NJ <= 4,
// each of the four row quarters of threads summing a quarter of K.
__device__ void narrow(const float* A, int K, const float* __restrict__ w, int NJ, const float* __restrict__ bias,
                       float* nar, float* out) {
    const int tid = threadIdx.x, r = tid & (BM - 1), q = tid / BM;
    const int kq = (K + 3) / 4, k0 = q * kq, k1 = min(K, k0 + kq);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = k0; k < k1; ++k) {
        const float a = A[k * BM + r];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (j < NJ) s[j] = fmaf(a, __ldg(w + k * NJ + j), s[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) nar[(q * 4 + j) * BM + r] = s[j];
    __syncthreads();
    if (tid < BM)
        for (int j = 0; j < NJ; ++j)
            out[j * BM + tid] = ((nar[j * BM + tid] + nar[(4 + j) * BM + tid]) +
                                 (nar[(8 + j) * BM + tid] + nar[(12 + j) * BM + tid])) + __ldg(bias + j);
    __syncthreads();
}

// Write the tile into shared memory A (feature-major, in place) and,
// optionally, to the row-major global matrix dst (ld = Nout).  RELU:
// relu(acc + bias); else acc + bias.  VEC (a training step's forward, whose
// stores are most of its traffic) stores a thread's columns 4l..4l+3 and
// 128+4l..128+4l+3 of a row as two float4 where Nout % 4 == 0 and dst is
// 16-byte aligned, in a second loop that leaves the first as serving runs it.
template <bool RELU, bool VEC>
__device__ __forceinline__ void epilogue(const float (&acc)[8][8], int Nout, const float* __restrict__ bias, float* A,
                                         float* dst, int row0, int N) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int c = col_of(j, lane);
        if (c >= Nout) continue;
        const float bc = __ldg(bias + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = warp * 8 + i;
            const float v = RELU ? fmaxf(acc[i][j] + bc, 0.0f) : acc[i][j] + bc;
            A[c * BM + r] = v;
            if (!VEC && dst != nullptr && row0 + r < N) dst[(size_t)(row0 + r) * Nout + c] = v;
        }
    }
    if (!VEC || dst == nullptr) return;
    const bool vec = (Nout & 3) == 0 && ((size_t)dst & 15) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int c0 = h * 128 + lane * 4;
        if (c0 >= Nout) continue;
        float bc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bc[j] = c0 + j < Nout ? __ldg(bias + c0 + j) : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = warp * 8 + i;
            if (row0 + r >= N) continue;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = RELU ? fmaxf(acc[i][4 * h + j] + bc[j], 0.0f) : acc[i][4 * h + j] + bc[j];
            float* out = dst + (size_t)(row0 + r) * Nout + c0;
            if (vec) {
                *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (c0 + j < Nout) out[j] = v[j];
            }
        }
    }
}

struct Smem {
    float *X, *DE, *Y, *WS, *NAR, *OUT4;
};

__host__ __device__ inline size_t smem_floats(int D, int Ddir, int H, int Hh, bool head) {
    const int maxw = head ? (H > Hh ? H : Hh) : H;
    size_t f = (size_t)D * BM + (head ? (size_t)Ddir * BM : 0) + (size_t)maxw * BM + 2 * KT * TN;
    if (head) f += 16 * BM + 4 * BM;  // NAR, OUT4
    return f;
}

__device__ Smem carve(float* sm, const Params& p, bool head) {
    Smem s;
    const int maxw = head ? max(p.H, p.Hh) : p.H;
    s.X = sm;
    s.DE = s.X + p.D * BM;
    s.Y = s.DE + (head ? p.Ddir * BM : 0);
    s.WS = s.Y + maxw * BM;
    float* next = s.WS + 2 * KT * TN;
    s.NAR = s.OUT4 = nullptr;
    if (head) {
        s.NAR = next;
        s.OUT4 = next + 16 * BM;
    }
    return s;
}

// Row block [row0, row0 + BM) of src (N x width, row-major) into the
// feature-major shared buffer dst, zero past N.
__device__ void load_rows(float* dst, const float* __restrict__ src, int width, int row0, int N) {
    for (int e = threadIdx.x; e < BM * width; e += NT) {
        const int r = e / width, k = e - r * width;
        dst[k * BM + r] = (row0 + r < N) ? __ldg(src + (size_t)(row0 + r) * width + k) : 0.0f;
    }
}

// The forward chain of one row block.  SAVE (a training step's forward)
// also writes every trunk layer's output, il and h to the caller's tensors.
template <bool HEAD, bool SAVE>
__device__ void forward_chain(const Params& p, const Smem& s, int row0) {
    const int N = p.N, H = p.H;
    float acc[8][8];
    for (int l = 0; l < p.L; ++l) {
        zero_acc(acc);
        if (l == 0) {
            gemm_seg(acc, s.X, p.D, p.w[0], H, s.WS);
        } else {
            gemm_seg(acc, s.Y, H, p.w[l], H, s.WS);
            if ((p.skips >> l) & 1) gemm_seg(acc, s.X, p.D, p.w[l] + (size_t)H * H, H, s.WS);
        }
        float* dst = (!HEAD && l == p.L - 1) ? p.out : (SAVE ? p.ys[l] : nullptr);
        epilogue<true, SAVE>(acc, H, p.b[l], s.Y, dst, row0, N);
        __syncthreads();
    }
    if (!HEAD) return;
    narrow(s.Y, H, p.wd, 1, p.bd, s.NAR, s.OUT4);  // raw density from the trunk output
    zero_acc(acc);
    gemm_seg(acc, s.Y, H, p.wi, H, s.WS);  // il = y Wi + bi, no ReLU
    epilogue<false, SAVE>(acc, H, p.bi, s.Y, SAVE ? p.il : nullptr, row0, N);
    __syncthreads();
    zero_acc(acc);
    gemm_seg(acc, s.Y, H, p.wc1a, p.Hh, s.WS);  // h = relu(il Wc1a + dE Wc1b + bc1)
    gemm_seg(acc, s.DE, p.Ddir, p.wc1b, p.Hh, s.WS);
    epilogue<true, SAVE>(acc, p.Hh, p.bc1, s.Y, SAVE ? p.hs : nullptr, row0, N);
    __syncthreads();
    narrow(s.Y, p.Hh, p.wc2, 3, p.bc2, s.NAR, s.OUT4 + BM);  // rgb logits
    for (int e = threadIdx.x; e < BM * 4; e += NT) {
        const int r = e >> 2, j = e & 3;
        if (row0 + r < N) p.out[(size_t)(row0 + r) * 4 + j] = s.OUT4[j * BM + r];
    }
}

template <bool HEAD, bool SAVE>
__global__ void __launch_bounds__(NT, 2) fused_mlp_fwd_kernel(const Params p) {
    extern __shared__ float4 smem4[];
    const Smem s = carve(reinterpret_cast<float*>(smem4), p, HEAD);
    const int row0 = blockIdx.x * BM;
    load_rows(s.X, p.x, p.D, row0, p.N);
    if (HEAD) load_rows(s.DE, p.de, p.Ddir, row0, p.N);
    __syncthreads();
    forward_chain<HEAD, SAVE>(p, s, row0);
}

// ---------------------------------------------------------------------------
// Backward.  Tensor-core helpers: mma.sync m16n8k8 TF32, fragments as in the
// PTX ISA (g = lane / 4, t = lane % 4): A (16 x 8, row-major) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, k x n) b0 (t, g),
// b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).

#define RB 64    // rows per block of the row pass
#define RKT 16   // reverse-input features staged per step
#define RWS 20   // staged weight row stride (RKT + 4): conflict-free B fragments

// v = hi + lo: hi is v rounded to TF32's 10 mantissa bits (half away from
// zero, on the bits: integer operations, not a conversion), lo = v - hi
// exactly; the tensor cores read lo's top 19 bits (they ignore the low 13 of
// a TF32 operand), so lo carries the next 11 bits and a b is exact to ~2^-21.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
        " {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c0 += a b and c1 += a' b (two m-tiles, one n-tile, b = (b0, b1)) in three TF32 passes,
// the small terms first: a_lo b_hi + a_hi b_lo + a_hi b_hi.  The tensor cores
// add into their accumulator with truncation, so a long chain of them
// drifts (~1e-4 of a gradient after 8192 rows): each k-step's three passes
// go into a fresh tile that is then added to c with a rounded fp32 add.
__device__ __forceinline__ void mma3x2(float (&c0)[4], float (&c1)[4], const uint32_t (&ah)[2][4],
                                       const uint32_t (&al)[2][4], float b0, float b1) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(t0, al[0], bh0, bh1);
    mma_tf32(t1, al[1], bh0, bh1);
    mma_tf32(t0, ah[0], bl0, bl1);
    mma_tf32(t1, ah[1], bl0, bl1);
    mma_tf32(t0, ah[0], bh0, bh1);
    mma_tf32(t1, ah[1], bh0, bh1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        c0[i] += t0[i];
        c1[i] += t1[i];
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

// 16 bytes, of which the first `bytes` (0..16) come from gmem and the rest
// are zero (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem), "r"(bytes));
}

// 4 bytes, or 4 zero bytes where !valid (gmem must still be a valid address).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(PENDING));
}

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride of the row pass's gradient tile: the widest layer rounded up
// to 32, plus 4, so that A fragments are free of bank conflicts.
__host__ __device__ inline int g_stride(int H, int Hh) { return round_up(H > Hh ? H : Hh, 32) + 4; }

__host__ __device__ inline size_t rows_smem_floats(int H, int Hh, bool head) {
    return (size_t)RB * g_stride(H, head ? Hh : 0) + 2 * TN * RWS + (head ? RB * 4 : 0);
}

// The weights the reverse reads, packed: job j copies rows x cols of src
// (leading dimension ld) into a zero-padded round_up(rows, 8) x
// round_up(cols, RKT) block at dst + off.
struct PackJob {
    const float* src;
    int ld, rows, cols, off;
};

struct PackParams {
    int n_jobs, total;
    float* dst;
    PackJob job[2 * MAX_L + 3];
};

__global__ void fused_mlp_bwd_prep_kernel(const PackParams pp) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pp.total; i += gridDim.x * blockDim.x) {
        int j = 0;
        while (j + 1 < pp.n_jobs && pp.job[j + 1].off <= i) ++j;
        const PackJob jb = pp.job[j];
        const int kp = round_up(jb.cols, RKT), e = i - jb.off, n = e / kp, k = e - n * kp;
        pp.dst[i] = (n < jb.rows && k < jb.cols) ? __ldg(jb.src + (size_t)n * jb.ld + k) : 0.0f;
    }
}

// Stage s of Wp (n8 rows of RKT columns) into ring slot s % 2.
__device__ __forceinline__ void stage_weights(float* ring, const float* __restrict__ Wp, int n8, int kp, int s) {
    float* buf = ring + (s & 1) * TN * RWS;
    const float* src = Wp + s * RKT;
    for (int c = threadIdx.x; c < n8 * 4; c += NT) {
        const int n = c >> 2, q = c & 3;
        cp_async16(buf + n * RWS + q * 4, src + (size_t)n * kp + q * 4);
    }
    cp_async_commit();
}

// Start stage s + 1 and wait for stage s to land in every thread's view.
__device__ __forceinline__ void next_stage(float* ring, const float* __restrict__ Wp, int n8, int kp, int s,
                                           int nsteps) {
    if (s + 1 < nsteps) {
        stage_weights(ring, Wp, n8, kp, s + 1);
        cp_async_wait<1>();
    } else {
        cp_async_wait<0>();
    }
    __syncthreads();
}

// acc = G Wp^T for the block's RB rows: G (RB x K) in shared memory with row
// stride sg, Wp the packed (round_up(Nout, 8) x round_up(K, RKT)) operand in
// global memory, staged RKT columns at a time through a two-stage cp.async
// ring.  Warp (wm, wn) = (warp / 4, warp % 4) owns rows wm * 32 + [0, 32) and
// columns wn * 64 + [0, 64): acc[mt][nt] is the 16 x 8 tile at row
// wm * 32 + mt * 16, column wn * 64 + nt * 8.  Columns of G past K must be
// finite (Wp's zero padding cancels them).  Ends with a barrier, so the
// caller may overwrite G.
__device__ void rev_product(float (&acc)[2][8][4], const float* G, int sg, int K, const float* __restrict__ Wp,
                            int Nout, float* ring) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;
    const int n8 = round_up(Nout, 8), kp = round_up(K, RKT), nsteps = kp / RKT;
    const int live = min(8, max(0, (n8 - wn * 64) / 8));  // this warp's n-tiles with outputs
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    stage_weights(ring, Wp, n8, kp, 0);
    for (int s = 0; s < nsteps; ++s) {
        next_stage(ring, Wp, n8, kp, s, nsteps);
        const float* buf = ring + (s & 1) * TN * RWS;
        if (live > 0) {
#pragma unroll
            for (int kk = 0; kk < RKT; kk += 8) {
                uint32_t ah[2][4], al[2][4];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    const float* a = G + (wm * 32 + mt * 16 + gq) * sg + s * RKT + kk + tq;
                    split_tf32(a[0], ah[mt][0], al[mt][0]);
                    split_tf32(a[8 * sg], ah[mt][1], al[mt][1]);
                    split_tf32(a[4], ah[mt][2], al[mt][2]);
                    split_tf32(a[8 * sg + 4], ah[mt][3], al[mt][3]);
                }
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < live) {
                        const float* b = buf + (wn * 64 + nt * 8 + gq) * RWS + kk + tq;
                        mma3x2(acc[0][nt], acc[1][nt], ah, al, b[0], b[4]);
                    }
                }
            }
        }
        __syncthreads();
    }
}

// rev_product for Nout <= 64 (the x part of a layer input's gradient, d
// d_embed): the (RB / 16) x (Nout / 8) output tiles spread over all 8 warps,
// tile j = warp + 8 i (i < 4) at rows 16 (j % 4), columns 8 (j / 4), where
// rev_product would leave 3 of 4 warps without an n-tile.
__device__ void rev_product_narrow(float (&acc)[4][4], const float* G, int sg, int K, const float* __restrict__ Wp,
                                   int Nout, float* ring) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
    const int n8 = round_up(Nout, 8), kp = round_up(K, RKT), nsteps = kp / RKT, tiles = (RB / 16) * (n8 / 8);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    stage_weights(ring, Wp, n8, kp, 0);
    for (int s = 0; s < nsteps; ++s) {
        next_stage(ring, Wp, n8, kp, s, nsteps);
        const float* buf = ring + (s & 1) * TN * RWS;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int j = warp + 8 * i;
            if (j >= tiles) break;
            const int r = (j & 3) * 16 + gq, n = (j >> 2) * 8 + gq;
#pragma unroll
            for (int kk = 0; kk < RKT; kk += 8) {
                const float* a = G + r * sg + s * RKT + kk + tq;
                const float* b = buf + n * RWS + kk + tq;
                uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
                split_tf32(a[0], ah[0], al[0]);
                split_tf32(a[8 * sg], ah[1], al[1]);
                split_tf32(a[4], ah[2], al[2]);
                split_tf32(a[8 * sg + 4], ah[3], al[3]);
                split_tf32(b[0], bh0, bl0);
                split_tf32(b[4], bh1, bl1);
                float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_tf32(t, al, bh0, bh1);
                mma_tf32(t, ah, bl0, bl1);
                mma_tf32(t, ah, bh0, bh1);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][e] += t[e];
            }
        }
        __syncthreads();
    }
}

template <typename F>
__device__ __forceinline__ void for_each_narrow(const float (&acc)[4][4], int Nout, F f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
    const int tiles = (RB / 16) * (round_up(Nout, 8) / 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int j = warp + 8 * i;
        if (j >= tiles) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) f((j & 3) * 16 + gq + (e >> 1) * 8, (j >> 2) * 8 + 2 * tq + (e & 1), acc[i][e]);
    }
}

// f(row, col, value) for each of the thread's accumulator entries in the
// n-tiles that reach Nout (the caller tests col < Nout).
template <typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[2][8][4], int Nout, F f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        if (wn * 64 + nt * 8 >= Nout) continue;
        const int c = wn * 64 + nt * 8 + 2 * tq;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) f(wm * 32 + mt * 16 + gq + (i >> 1) * 8, c + (i & 1), acc[mt][nt][i]);
    }
}

// f(row, col, v0, v1) for each pair of the thread's accumulator entries at
// (row, col) and (row, col + 1), col even, in the n-tiles that reach Nout.
template <typename F>
__device__ __forceinline__ void for_each_acc2(const float (&acc)[2][8][4], int Nout, F f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        if (wn * 64 + nt * 8 >= Nout) continue;
        const int c = wn * 64 + nt * 8 + 2 * tq;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) f(wm * 32 + mt * 16 + gq + h * 8, c, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
}

// Row r's pair (c, c + 1) of the masked gradient: v where the saved output y
// is > 0, else 0, into G and (rows < N) dst, both (N, H); y and dst are read
// and written as float2 where H is even.  With gd (the density gradient of
// the row) the head's term gd * wd is added before the mask.
__device__ __forceinline__ void masked_pair(float* G, int sg, int r, int c, float v0, float v1, const float* y,
                                            float* dst, int row0, int N, int H, float gd = 0.0f,
                                            const float* wd = nullptr) {
    if (c >= H) return;
    const bool in = row0 + r < N, pair = c + 1 < H;
    if (wd != nullptr) {
        v0 = fmaf(gd, __ldg(wd + c), v0);
        if (pair) v1 = fmaf(gd, __ldg(wd + c + 1), v1);
    }
    float o0 = 0.0f, o1 = 0.0f;
    const size_t at = (size_t)(row0 + r) * H + c;
    if (in) {
        if ((H & 1) == 0) {
            const float2 m = __ldg(reinterpret_cast<const float2*>(y + at));
            o0 = m.x > 0.0f ? v0 : 0.0f;
            o1 = m.y > 0.0f ? v1 : 0.0f;
            *reinterpret_cast<float2*>(dst + at) = make_float2(o0, o1);
        } else {
            o0 = __ldg(y + at) > 0.0f ? v0 : 0.0f;
            dst[at] = o0;
            if (pair) {
                o1 = __ldg(y + at + 1) > 0.0f ? v1 : 0.0f;
                dst[at + 1] = o1;
            }
        }
    }
    G[r * sg + c] = o0;
    if (pair) G[r * sg + c + 1] = o1;
}

// The row pass: the reverse chain of RB rows, from the output gradient to
// dx (and d d_embed), writing each layer's masked gradient (and, with the
// head, gil and gh) for the weight pass.
template <bool HEAD>
__global__ void __launch_bounds__(NT, 2) fused_mlp_bwd_rows_kernel(const Params p) {
    extern __shared__ float4 smem4[];
    const int N = p.N, H = p.H, D = p.D, L = p.L, tid = threadIdx.x;
    const int sg = g_stride(H, HEAD ? p.Hh : 0), row0 = blockIdx.x * RB;
    float* G = reinterpret_cast<float*>(smem4);  // (RB, sg): the current layer's masked gradient
    float* ring = G + RB * sg;
    float* G4 = ring + 2 * TN * RWS;  // (RB, 4): [g_density, g_rgb]
    for (int e = tid; e < RB * sg; e += NT) G[e] = 0.0f;
    const size_t NH = (size_t)N * H;
    float acc[2][8][4];
    if (HEAD) {
        const int Hh = p.Hh, Ddir = p.Ddir;
        for (int e = tid; e < RB * 4; e += NT) G4[e] = row0 + (e >> 2) < N ? __ldg(p.g + (size_t)row0 * 4 + e) : 0.0f;
        __syncthreads();
        for (int e = tid; e < RB * Hh; e += NT) {  // gh = mask_h * (g_rgb Wc2^T): K = 3, on the CUDA cores
            const int r = e / Hh, c = e - r * Hh;
            float v = 0.0f;
            if (row0 + r < N && __ldg(p.hs + (size_t)(row0 + r) * Hh + c) > 0.0f) {
                const float* w = p.wc2 + c * 3;
                v = fmaf(G4[r * 4 + 3], __ldg(w + 2), fmaf(G4[r * 4 + 2], __ldg(w + 1), G4[r * 4 + 1] * __ldg(w)));
            }
            G[r * sg + c] = v;
            if (row0 + r < N) p.gh[(size_t)(row0 + r) * Hh + c] = v;
        }
        __syncthreads();
        auto to_dde = [&](int r, int c, float v) {
            if (c < Ddir && row0 + r < N) p.dde[(size_t)(row0 + r) * Ddir + c] = v;
        };
        if (Ddir <= 64) {  // d d_embed = gh Wc1b^T
            float nacc[4][4];
            rev_product_narrow(nacc, G, sg, Hh, p.wc1bP, Ddir, ring);
            for_each_narrow(nacc, Ddir, to_dde);
        } else {
            rev_product(acc, G, sg, Hh, p.wc1bP, Ddir, ring);
            for_each_acc(acc, Ddir, to_dde);
        }
        rev_product(acc, G, sg, Hh, p.wc1aP, H, ring);  // gil = gh Wc1a^T
        for_each_acc(acc, H, [&](int r, int c, float v) {
            if (c >= H) return;
            G[r * sg + c] = v;
            if (row0 + r < N) p.gil[(size_t)(row0 + r) * H + c] = v;
        });
        __syncthreads();
        rev_product(acc, G, sg, H, p.wiP, H, ring);  // g_y = gil Wi^T + g_density wd^T, masked
        const float* y = p.ys[L - 1];
        float* dst = p.gs + (L - 1) * NH;
        for_each_acc2(acc, H, [&](int r, int c, float v0, float v1) {
            masked_pair(G, sg, r, c, v0, v1, y, dst, row0, N, H, G4[r * 4], p.wd);
        });
        __syncthreads();
    } else {  // the output gradient, masked by the last layer (whose output is `out`)
        const float* y = p.ys[L - 1];
        float* dst = p.gs + (L - 1) * NH;
        for (int e = tid; e < RB * H; e += NT) {
            const int r = e / H, c = e - r * H;
            const size_t at = (size_t)(row0 + r) * H + c;
            float v = 0.0f;
            if (row0 + r < N) {
                if (__ldg(y + at) > 0.0f) v = __ldg(p.g + at);
                dst[at] = v;
            }
            G[r * sg + c] = v;
        }
        __syncthreads();
    }
    bool dx_first = true;
    auto to_dx = [&](int r, int c, float v) {
        if (c >= D || row0 + r >= N) return;
        float* d = p.dx + (size_t)(row0 + r) * D + c;
        *d = dx_first ? v : *d + v;
    };
    for (int l = L - 1; l >= 0; --l) {
        if (l == 0 || ((p.skips >> l) & 1)) {  // the x part of the layer input's gradient
            if (D <= 64) {
                float nacc[4][4];
                rev_product_narrow(nacc, G, sg, H, p.wxP[l], D, ring);
                for_each_narrow(nacc, D, to_dx);
            } else {
                rev_product(acc, G, sg, H, p.wxP[l], D, ring);
                for_each_acc(acc, D, to_dx);
            }
            dx_first = false;
        }
        if (l > 0) {
            rev_product(acc, G, sg, H, p.wyP[l], H, ring);
            const float* y = p.ys[l - 1];
            float* dst = p.gs + (l - 1) * NH;
            for_each_acc2(acc, H, [&](int r, int c, float v0, float v1) {
                masked_pair(G, sg, r, c, v0, v1, y, dst, row0, N, H);
            });
            __syncthreads();
        }
    }
}

// ---------------------------------------------------------------------------
// Weight gradients: out[m, n] = sum_r A[r, m] * B[r, n] over the rows of a
// split, as a list of products.  A is [A0 | A1] (w0 + w1 features: a layer's
// hidden input and, at a skip, x); out is row-major (w0 + w1 + 1) x nb at
// out_off, its last row the bias gradient sum_r B[r, n], which the blocks of
// the product's first m-tile take as column sums of the B tiles they stage.

#define WM 128      // output tile: features of A
#define WN 128      // output tile: columns of B
#define WR 32       // rows staged per step
#define WSS (WM + 8)  // staged row stride: conflict-free fragments

struct Prod {
    const float* A0;
    const float* A1;
    const float* B;
    int lda0, w0, lda1, w1, ldb, nb, out_off, ntiles, tile0;
};

struct WParams {
    int N, rows_per_split, n_prod, tiles, total;
    float* part;  // splits x total
    Prod prod[MAX_PROD];
};

__host__ __device__ inline bool aligned16(const float* p, int ld) {
    return ((size_t)p & 15) == 0 && ld % 4 == 0;
}

__global__ void __launch_bounds__(NT, 2) fused_mlp_bwd_weights_kernel(const WParams wp) {
    extern __shared__ float4 smem4[];
    float* As = reinterpret_cast<float*>(smem4);  // 2 stages of (WR, WSS)
    float* Bs = As + 2 * WR * WSS;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 1, wn = warp & 1, gq = lane >> 2, tq = lane & 3;
    // Blocks of one split are neighbours, so the tiles that share an operand
    // read it at about the same time, from L2.
    const int split = blockIdx.x / wp.tiles, tile = blockIdx.x - split * wp.tiles;
    int pi = 0;
    while (pi + 1 < wp.n_prod && wp.prod[pi + 1].tile0 <= tile) ++pi;
    const Prod pr = wp.prod[pi];
    const int mtile = (tile - pr.tile0) / pr.ntiles, m0 = mtile * WM, n0 = (tile - pr.tile0 - mtile * pr.ntiles) * WN;
    const int M = pr.w0 + pr.w1;
    const int r0 = split * wp.rows_per_split, r1 = min(wp.N, r0 + wp.rows_per_split);
    const bool sums = mtile == 0;  // this block also writes the bias row
    const bool mlive = m0 + wm * 32 < M;
    const int live = mlive ? min(8, max(0, (pr.nb - n0 - wn * 64 + 7) / 8)) : 0;
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    float csum = 0.0f;
    // 16-byte copies where the tile lies in one aligned operand, else 4-byte.
    const bool vec_a = (pr.w1 == 0 || m0 + WM <= pr.w0) && aligned16(pr.A0, pr.lda0);
    const bool vec_b = aligned16(pr.B, pr.ldb);
    auto stage = [&](int s) {
        const int rb = r0 + s * WR;
        float* as = As + (s & 1) * WR * WSS;
        float* bs = Bs + (s & 1) * WR * WSS;
        if (vec_a) {
#pragma unroll
            for (int q = 0; q < WR * WM / 4 / NT; ++q) {
                const int e = tid + q * NT, rr = e / (WM / 4), m = (e - rr * (WM / 4)) * 4, r = rb + rr, gm = m0 + m;
                const int bytes = r < r1 ? 4 * min(4, max(0, pr.w0 - gm)) : 0;
                cp_async16z(as + rr * WSS + m, bytes ? pr.A0 + (size_t)r * pr.lda0 + gm : pr.A0, bytes);
            }
        } else {
#pragma unroll 4
            for (int q = 0; q < WR * WM / NT; ++q) {
                const int e = tid + q * NT, rr = e / WM, m = e - rr * WM, r = rb + rr, gm = m0 + m;
                const bool ok = r < r1 && gm < M;
                const float* src = !ok ? pr.A0 : (gm < pr.w0 ? pr.A0 + (size_t)r * pr.lda0 + gm
                                                             : pr.A1 + (size_t)r * pr.lda1 + (gm - pr.w0));
                cp_async4(as + rr * WSS + m, src, ok);
            }
        }
        if (vec_b) {
#pragma unroll
            for (int q = 0; q < WR * WN / 4 / NT; ++q) {
                const int e = tid + q * NT, rr = e / (WN / 4), n = (e - rr * (WN / 4)) * 4, r = rb + rr, gn = n0 + n;
                const int bytes = r < r1 ? 4 * min(4, max(0, pr.nb - gn)) : 0;
                cp_async16z(bs + rr * WSS + n, bytes ? pr.B + (size_t)r * pr.ldb + gn : pr.B, bytes);
            }
        } else {
#pragma unroll 4
            for (int q = 0; q < WR * WN / NT; ++q) {
                const int e = tid + q * NT, rr = e / WN, n = e - rr * WN, r = rb + rr, gn = n0 + n;
                const bool ok = r < r1 && gn < pr.nb;
                cp_async4(bs + rr * WSS + n, ok ? pr.B + (size_t)r * pr.ldb + gn : pr.B, ok);
            }
        }
        cp_async_commit();
    };
    const int nsteps = r1 > r0 ? (r1 - r0 + WR - 1) / WR : 0;
    if (nsteps > 0) stage(0);
    for (int s = 0; s < nsteps; ++s) {
        if (s + 1 < nsteps) {
            stage(s + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* as = As + (s & 1) * WR * WSS;
        const float* bs = Bs + (s & 1) * WR * WSS;
        if (live > 0) {
#pragma unroll
            for (int kk = 0; kk < WR; kk += 8) {
                uint32_t ah[2][4], al[2][4];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    const float* a = as + (kk + tq) * WSS + wm * 32 + mt * 16 + gq;
                    split_tf32(a[0], ah[mt][0], al[mt][0]);
                    split_tf32(a[8], ah[mt][1], al[mt][1]);
                    split_tf32(a[4 * WSS], ah[mt][2], al[mt][2]);
                    split_tf32(a[4 * WSS + 8], ah[mt][3], al[mt][3]);
                }
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < live) {
                        const float* b = bs + (kk + tq) * WSS + wn * 64 + nt * 8 + gq;
                        mma3x2(acc[0][nt], acc[1][nt], ah, al, b[0], b[4 * WSS]);
                    }
                }
            }
        }
        if (sums && tid < WN) {
#pragma unroll
            for (int rr = 0; rr < WR; ++rr) csum += bs[rr * WSS + tid];
        }
        __syncthreads();
    }
    float* part = wp.part + (size_t)split * wp.total + pr.out_off;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        if (nt >= live) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int m = m0 + wm * 32 + mt * 16 + gq + (i >> 1) * 8;
                const int n = n0 + wn * 64 + nt * 8 + 2 * tq + (i & 1);
                if (m < M && n < pr.nb) part[(size_t)m * pr.nb + n] = acc[mt][nt][i];
            }
    }
    if (sums && tid < WN && n0 + tid < pr.nb) part[(size_t)M * pr.nb + n0 + tid] = csum;
}

__global__ void fused_mlp_bwd_reduce_kernel(const float* __restrict__ part, int splits, int total,
                                            float* __restrict__ out) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
        float s = 0.0f;
        for (int k = 0; k < splits; ++k) s += part[(size_t)k * total + i];
        out[i] = s;
    }
}

// ---------------------------------------------------------------------------
// Host side: a plain C interface for ctypes.
//
// dims: N, D, Ddir, H, Hh, L, skips (bit mask).  Head weights are used only
// when head != 0.  Return 0 or a CUDA error code; -1: a shape the kernels do
// not take; -2: more shared memory than the card gives a block.

namespace {

int shape_error(const int* dims, int head) {
    const int N = dims[0], D = dims[1], Ddir = dims[2], H = dims[3], Hh = dims[4], L = dims[5];
    if (N < 0 || D < 1 || D > TN || H < 1 || H > TN || L < 1 || L > MAX_L) return -1;
    if (head && (Ddir < 1 || Ddir > TN || Hh < 1 || Hh > TN)) return -1;
    if ((unsigned)dims[6] & 1u) return -1;  // layer 0 has no hidden input to concatenate to
    return 0;
}

int launch_smem(const void* kernel, size_t bytes) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (bytes > (size_t)optin) return -2;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    return err == cudaSuccess ? 0 : (int)err;
}

Params fill(const int* dims, int head) {
    Params p = {};
    p.N = dims[0];
    p.D = dims[1];
    p.Ddir = head ? dims[2] : 0;
    p.H = dims[3];
    p.Hh = head ? dims[4] : 0;
    p.L = dims[5];
    p.skips = (unsigned)dims[6];
    return p;
}

// The 9 head tensors from q: wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2.
void fill_head(Params& p, const long long* q) {
    p.wd = (const float*)q[0]; p.bd = (const float*)q[1]; p.wi = (const float*)q[2];
    p.bi = (const float*)q[3]; p.wc1a = (const float*)q[4]; p.wc1b = (const float*)q[5];
    p.bc1 = (const float*)q[6]; p.wc2 = (const float*)q[7]; p.bc2 = (const float*)q[8];
}

// The saved activations at `saved`: layers 0..L-2 (the trunk's last is its
// output), or with a head all L layers, then il and hs.
long long saved_floats(const Params& p, int head) {
    const long long NH = (long long)p.N * p.H;
    return head ? p.L * NH + NH + (long long)p.N * p.Hh : (p.L - 1) * NH;
}

void point_saved(Params& p, float* saved, int head) {
    const long long NH = (long long)p.N * p.H;
    for (int l = 0; l < p.L; ++l) p.ys[l] = saved + l * NH;
    if (!head) {
        p.ys[p.L - 1] = p.out;
        return;
    }
    p.il = saved + p.L * NH;
    p.hs = p.il + NH;
}

// The pack jobs of the reverse's weights (see Params); fills pp and, with a
// base, the packed pointers.  Returns the floats they take.
int pack_layout(Params& p, int head, float* base, PackParams* pp) {
    int n = 0, off = 0;
    auto job = [&](const float* src, int ld, int rows, int cols) {
        pp->job[n++] = {src, ld, rows, cols, off};
        const float* at = base ? base + off : nullptr;
        off += round_up(rows, 8) * round_up(cols, RKT);
        return at;
    };
    const int H = p.H, D = p.D;
    for (int l = 0; l < p.L; ++l) {
        p.wyP[l] = l > 0 ? job(p.w[l], H, H, H) : nullptr;
        p.wxP[l] = (l == 0 || ((p.skips >> l) & 1)) ? job(p.w[l] + (l == 0 ? 0 : (size_t)H * H), H, D, H) : nullptr;
    }
    if (head) {
        p.wiP = job(p.wi, H, H, H);
        p.wc1aP = job(p.wc1a, p.Hh, H, p.Hh);
        p.wc1bP = job(p.wc1b, p.Hh, p.Ddir, p.Hh);
    }
    pp->n_jobs = n;
    pp->total = off;
    pp->dst = base;
    return off;
}

// Flat gradient layout: per layer W_l then b_l; then (head) wd, bd, wi, bi,
// wc1a, wc1b, bc1, wc2, bc2.  Returns the total.
int grad_layout(const int* dims, int head, int* offW, int* offh) {
    const int D = dims[1], Ddir = dims[2], H = dims[3], Hh = dims[4], L = dims[5];
    const unsigned skips = (unsigned)dims[6];
    int o = 0;
    for (int l = 0; l < L; ++l) {
        const int kin = (l == 0 ? D : H) + (((skips >> l) & 1) ? D : 0);
        offW[l] = o;
        o += kin * H + H;
    }
    if (head) {
        const int sizes[9] = {H, 1, H * H, H, H * Hh, Ddir * Hh, Hh, Hh * 3, 3};
        for (int i = 0; i < 9; ++i) {
            offh[i] = o;
            o += sizes[i];
        }
    }
    return o;
}

// The weight pass's products (see Prod) for what p points at; fills wp's
// list and tile count and returns the flat gradient's size.
int plan_products(const Params& p, const int* dims, int head, WParams& wp) {
    int offW[MAX_L], offh[9];
    wp.total = grad_layout(dims, head, offW, offh);
    wp.N = p.N;
    const size_t NH = (size_t)p.N * p.H;
    int n = 0, tiles = 0;
    auto add = [&](const float* A0, int lda0, int w0, const float* A1, int lda1, int w1, const float* B, int ldb,
                   int nb, int off) {
        Prod& pr = wp.prod[n++];
        pr = {A0, A1, B, lda0, w0, lda1, w1, ldb, nb, off, (nb + WN - 1) / WN, tiles};
        tiles += (w0 + w1 + WM - 1) / WM * pr.ntiles;
    };
    for (int l = 0; l < p.L; ++l) {
        const bool skip = (p.skips >> l) & 1;
        const float* a0 = l == 0 ? p.x : p.ys[l - 1];
        add(a0, l == 0 ? p.D : p.H, l == 0 ? p.D : p.H, skip ? p.x : nullptr, p.D, skip ? p.D : 0,
            p.gs + l * NH, p.H, p.H, offW[l]);
    }
    if (head) {
        const float* y = p.ys[p.L - 1];
        add(y, p.H, p.H, nullptr, 0, 0, p.g, 4, 1, offh[0]);                  // wd, bd
        add(y, p.H, p.H, nullptr, 0, 0, p.gil, p.H, p.H, offh[2]);            // wi, bi
        add(p.il, p.H, p.H, p.de, p.Ddir, p.Ddir, p.gh, p.Hh, p.Hh, offh[4]);  // wc1a, wc1b, bc1
        add(p.hs, p.Hh, p.Hh, nullptr, 0, 0, p.g + 1, 4, 3, offh[7]);         // wc2, bc2
    }
    wp.n_prod = n;
    wp.tiles = tiles;
    // Splits of the rows: about 8 blocks per SM in all (whole waves of two
    // resident blocks), at least 1024 rows each, at most 64.
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int want = (8 * sms + tiles - 1) / tiles, most = (p.N + 1023) / 1024;
    const int splits = max(1, min(64, min(want, most)));
    wp.rows_per_split = round_up((p.N + splits - 1) / splits, WR);
    return (p.N + wp.rows_per_split - 1) / wp.rows_per_split;  // splits with rows
}

// Floats before the packed weights in the scratch, rounded up for 16-byte copies.
long long grads_floats(const Params& p, int head) {
    const long long N = p.N, H = p.H, Hh = p.Hh;
    return (p.L * N * H + (head ? N * H + N * Hh : 0) + 63) / 64 * 64;
}

}  // namespace

extern "C" {

// Sizes in floats: what a saving forward stores (`saved`) and the backward's
// scratch (masked gradients, packed weights, the splits' partials).
int fused_mlp_workspace(const int* dims, int head, long long* saved, long long* scratch) {
    int err = shape_error(dims, head);
    if (err) return err;
    Params p = fill(dims, head);
    PackParams pp;
    WParams wp = {};
    *saved = saved_floats(p, head);
    const int splits = plan_products(p, dims, head, wp);
    *scratch = grads_floats(p, head) + pack_layout(p, head, nullptr, &pp) + (long long)splits * wp.total;
    return 0;
}

// ptrs: x, de, out, saved (0: serving, nothing saved), w[0..L), b[0..L), wd,
// bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2.
int fused_mlp_forward(const long long* ptrs, const int* dims, int head, long long stream) {
    int err = shape_error(dims, head);
    if (err) return err;
    Params p = fill(dims, head);
    if (p.N == 0) return 0;
    p.x = (const float*)ptrs[0];
    p.de = (const float*)ptrs[1];
    p.out = (float*)ptrs[2];
    float* saved = (float*)ptrs[3];
    for (int l = 0; l < p.L; ++l) {
        p.w[l] = (const float*)ptrs[4 + l];
        p.b[l] = (const float*)ptrs[4 + p.L + l];
    }
    if (head) fill_head(p, ptrs + 4 + 2 * p.L);
    if (saved) point_saved(p, saved, head);
    const size_t bytes = smem_floats(p.D, p.Ddir, p.H, p.Hh, head) * sizeof(float);
    const void* kernel = head ? (saved ? (const void*)fused_mlp_fwd_kernel<true, true>
                                       : (const void*)fused_mlp_fwd_kernel<true, false>)
                              : (saved ? (const void*)fused_mlp_fwd_kernel<false, true>
                                       : (const void*)fused_mlp_fwd_kernel<false, false>);
    err = launch_smem(kernel, bytes);
    if (err) return err;
    const dim3 grid((p.N + BM - 1) / BM);
    cudaStream_t st = (cudaStream_t)stream;
    if (head && saved) fused_mlp_fwd_kernel<true, true><<<grid, NT, bytes, st>>>(p);
    else if (head) fused_mlp_fwd_kernel<true, false><<<grid, NT, bytes, st>>>(p);
    else if (saved) fused_mlp_fwd_kernel<false, true><<<grid, NT, bytes, st>>>(p);
    else fused_mlp_fwd_kernel<false, false><<<grid, NT, bytes, st>>>(p);
    return (int)cudaGetLastError();
}

// ptrs: x, de, g, dx, dde, grad (flat, see grad_layout), out, saved (as the
// saving forward left them), scratch, w[0..L), then with a head wd, bd, wi,
// bi, wc1a, wc1b, bc1, wc2, bc2.
int fused_mlp_backward(const long long* ptrs, const int* dims, int head, long long stream) {
    int err = shape_error(dims, head);
    if (err) return err;
    Params p = fill(dims, head);
    if (p.N == 0) return 0;
    const long long NH = (long long)p.N * p.H;
    p.x = (const float*)ptrs[0];
    p.de = (const float*)ptrs[1];
    p.g = (const float*)ptrs[2];
    p.dx = (float*)ptrs[3];
    p.dde = (float*)ptrs[4];
    float* grad = (float*)ptrs[5];
    p.out = (float*)ptrs[6];
    point_saved(p, (float*)ptrs[7], head);
    float* scratch = (float*)ptrs[8];
    for (int l = 0; l < p.L; ++l) p.w[l] = (const float*)ptrs[9 + l];
    if (head) fill_head(p, ptrs + 9 + p.L);
    p.gs = scratch;
    if (head) {
        p.gil = scratch + p.L * NH;
        p.gh = p.gil + NH;
    }
    float* next = scratch + grads_floats(p, head);
    cudaStream_t st = (cudaStream_t)stream;

    PackParams pp;
    next += pack_layout(p, head, next, &pp);
    fused_mlp_bwd_prep_kernel<<<(pp.total + NT - 1) / NT, NT, 0, st>>>(pp);
    err = (int)cudaGetLastError();
    if (err) return err;

    const size_t bytes = rows_smem_floats(p.H, p.Hh, head) * sizeof(float);
    const void* rows = head ? (const void*)fused_mlp_bwd_rows_kernel<true> : (const void*)fused_mlp_bwd_rows_kernel<false>;
    err = launch_smem(rows, bytes);
    if (err) return err;
    const dim3 grid((p.N + RB - 1) / RB);
    if (head) fused_mlp_bwd_rows_kernel<true><<<grid, NT, bytes, st>>>(p);
    else fused_mlp_bwd_rows_kernel<false><<<grid, NT, bytes, st>>>(p);
    err = (int)cudaGetLastError();
    if (err) return err;

    WParams wp = {};
    const int splits = plan_products(p, dims, head, wp);
    wp.part = next;
    const size_t wbytes = 4 * WR * WSS * sizeof(float);
    err = launch_smem((const void*)fused_mlp_bwd_weights_kernel, wbytes);
    if (err) return err;
    fused_mlp_bwd_weights_kernel<<<wp.tiles * splits, NT, wbytes, st>>>(wp);
    err = (int)cudaGetLastError();
    if (err) return err;
    fused_mlp_bwd_reduce_kernel<<<(wp.total + NT - 1) / NT, NT, 0, st>>>(wp.part, splits, wp.total, grad);
    return (int)cudaGetLastError();
}

}  // extern "C"
