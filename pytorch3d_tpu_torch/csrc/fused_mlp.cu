// Fused ReLU MLP with input skips, and the full NeRF field (trunk + density
// head + view-conditioned colour head), forward and backward, for Hopper
// (sm_90a), float32 throughout.
//
// Replaces the TPU kernels of pytorch3d_tpu/ops/fused_mlp_pallas.py:
//   #10 `_fwd_kernel` (:70)       -> fused_mlp_fwd_kernel<false>
//   #11 `_bwd_kernel` (:79)       -> fused_mlp_bwd_rows_kernel<false>
//                                    + fused_mlp_bwd_weights_kernel
//                                    + fused_mlp_bwd_reduce_kernel
//   #12 `_nerf_fwd_kernel` (:328) -> fused_mlp_fwd_kernel<true>
//   #13 `_nerf_bwd_kernel` (:341) -> fused_mlp_bwd_rows_kernel<true> + the
//                                    same two weight-gradient passes
// #12 is #10's layer chain with the head as its epilogue and #13 is #11's
// reverse with the head's reverse in front, so one compile-time flag (HEAD)
// serves both pairs.
//
// What bounds it on an H100: operations.  At the NeRF model's width
// (8 trunk layers of 256 with the input of 39 concatenated again at layer 5,
// a colour head of 128 fed 27 direction features) a row costs 581,120
// multiply-adds, 1.16 MFLOP, against ~280 bytes of input and output: three
// orders of magnitude above the card's 20 FLOP/byte ridge at fp32 (67 TFLOP/s
// with FMA, 3.35 TB/s).  The backward does the same reverse work twice over
// (the chain to dx and the weight gradients) and, in this design, the forward
// once more.
//
// Design.
// * Forward: a block takes BM = 64 rows and keeps their activations in
//   shared memory for the whole chain, stored transposed (feature-major,
//   act[k * 64 + row]) so a warp reads its 8 rows of one feature as two
//   broadcast float4.  Each layer is a 64 x Nout x K product: 256 threads,
//   warp w owns rows 8w..8w+7, lane l owns columns 4l..4l+3 and
//   128+4l..128+4l+3, so each thread keeps an 8 x 8 register tile.  Weights
//   stream from global memory (they stay in the 50 MB L2: 2.33 MB a field)
//   through a double-buffered shared-memory stage of KT rows.  A layer's
//   output overwrites its input in place once every thread has read it, so
//   one 64 x max(H, Hh) buffer serves the chain (layers and head are limited
//   to 256 outputs, one column tile).  The input-skip concat is not
//   materialised: a layer's product runs over two segments, the hidden
//   activations and the block's copy of x, against the matching rows of the
//   weight.  The Pallas kernels' padding of D and Ddir to 128 lanes, of N to
//   512 rows and of the head's narrow outputs to a 128-lane block is TPU
//   layout and is not carried over: x (N, D) and d_embed (N, Ddir) are read as
//   they are, the ragged last row block is masked here, and the density and
//   rgb logits (1 and 3 outputs) are dot products reduced over four quarters
//   of K and written as (N, 4).
// * Backward: the two things the Pallas backward relies on do not exist on a
//   GPU.  Its grid runs in order, so it adds every row block's weight
//   gradient into one VMEM-resident accumulator; GPU blocks run in parallel
//   and in no order.  And it keeps all layer inputs of 256 rows in ~16 MB of
//   VMEM, where a Hopper block has 227 KB.  So the backward runs in passes:
//   1. rows (fused_mlp_bwd_rows_kernel): per 64-row block, the forward chain
//      again (the same code, so the ReLU masks equal the forward's bit for
//      bit), keeping each layer's ReLU mask as one bit per (thread, tile
//      entry) in shared memory and writing each layer's output to a device
//      scratch; then the reverse chain g <- mask * (g W^T), with the skip
//      split into dx, written per layer (masked g) to the scratch, and dx
//      (and d d_embed) to the outputs.  The reverse products use W^T, which
//      the wrapper transposes once per call.
//   2. weights (fused_mlp_bwd_weights_kernel): every weight gradient
//      dW = inputs^T g and bias gradient db = 1^T g as a list of products;
//      a block owns one 64-row tile of one product and one split of the N
//      rows, and writes its partial sum.  The narrow products (the density
//      and rgb columns, the biases) put their narrow side on the warps, so
//      warps with no live output row skip their arithmetic.
//   3. reduce (fused_mlp_bwd_reduce_kernel): the splits' partials summed in
//      a fixed order.  No atomics: the result is deterministic.
//   The scratch holds 2L + 2 activations of N x H floats and two of N x Hh
//   (2.5 GB at the NeRF training step's fine launch of 131,072 rows) and the
//   splits' partial sums (37 MB there), allocated by the wrapper.
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
#define MAX_PROD 48

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
    const float* wyT[MAX_L];  // reverse: l == 0: W_0^T (H, D); else W_l[:H]^T (H, H)
    const float* wxT[MAX_L];  // reverse, skip layers: W_l[H:]^T (H, D)
    const float *wd, *bd, *wi, *bi, *wc1a, *wc1b, *bc1, *wc2, *bc2;
    const float *wiT, *wc1aT, *wc1bT, *wc2T;  // (H, H), (Hh, H), (Hh, Ddir), (3, Hh)
    float* ys;   // L x (N, H): each trunk layer's output
    float* gs;   // L x (N, H): each trunk layer's masked output gradient
    float* il;   // (N, H) head intermediate
    float* hs;   // (N, Hh) colour hidden
    float* gh;   // (N, Hh) its masked gradient
    float* gil;  // (N, H) gradient of il
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

// Write the tile into shared memory A (feature-major, in place), optionally
// to the row-major global matrix dst (ld = Nout) and the ReLU mask bits.
// MODE 0: relu(acc + bias); 1: acc + bias (bias may be null); 2: acc where
// the mask bit is set, else 0 (the reverse).
template <int MODE>
__device__ __forceinline__ void epilogue(const float (&acc)[8][8], int Nout, const float* __restrict__ bias, float* A,
                                         float* dst, int row0, int N, uint64_t* mask_slot) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint64_t bits = 0;
    const uint64_t keep = (MODE == 2) ? mask_slot[tid] : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int c = col_of(j, lane);
        if (c >= Nout) continue;
        const float bc = (MODE == 2 || bias == nullptr) ? 0.0f : __ldg(bias + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = warp * 8 + i;
            float v;
            if (MODE == 0) {
                v = fmaxf(acc[i][j] + bc, 0.0f);
                bits |= (uint64_t)(v > 0.0f) << (i * 8 + j);
            } else if (MODE == 1) {
                v = acc[i][j] + bc;
            } else {
                v = ((keep >> (i * 8 + j)) & 1) ? acc[i][j] : 0.0f;
            }
            A[c * BM + r] = v;
            if (dst != nullptr && row0 + r < N) dst[(size_t)(row0 + r) * Nout + c] = v;
        }
    }
    if (MODE == 0 && mask_slot != nullptr) mask_slot[tid] = bits;
}

struct Smem {
    float *X, *DE, *Y, *WS, *NAR, *OUT4, *DX, *G4;
    uint64_t* MASK;
};

__host__ __device__ inline size_t smem_floats(int D, int Ddir, int H, int Hh, int L, bool head, bool bwd) {
    const int maxw = head ? (H > Hh ? H : Hh) : H;
    size_t f = (size_t)D * BM + (head ? (size_t)Ddir * BM : 0) + (size_t)maxw * BM + 2 * KT * TN;
    if (head) f += 16 * BM + 4 * BM;                   // NAR, OUT4 (G4 reuses OUT4's room in the backward)
    if (bwd) f += (size_t)D * BM + 2 * (size_t)(L + 1) * NT;  // DX, MASK (uint64 = 2 floats)
    return f;
}

__device__ Smem carve(float* sm, const Params& p, bool head, bool bwd) {
    Smem s;
    const int maxw = head ? max(p.H, p.Hh) : p.H;
    s.X = sm;
    s.DE = s.X + p.D * BM;
    s.Y = s.DE + (head ? p.Ddir * BM : 0);
    s.WS = s.Y + maxw * BM;
    float* next = s.WS + 2 * KT * TN;
    s.NAR = s.OUT4 = s.G4 = nullptr;
    if (head) {
        s.NAR = next;
        s.OUT4 = s.G4 = next + 16 * BM;
        next += 20 * BM;
    }
    s.DX = nullptr;
    s.MASK = nullptr;
    if (bwd) {
        s.DX = next;
        s.MASK = reinterpret_cast<uint64_t*>(next + p.D * BM);
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

// The forward chain of one row block.  SAVE (the backward's recompute)
// writes every layer's output to the scratch and keeps the ReLU masks.
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
        float* dst = SAVE ? p.ys + (size_t)l * N * H : ((!HEAD && l == p.L - 1) ? p.out : nullptr);
        epilogue<0>(acc, H, p.b[l], s.Y, dst, row0, N, SAVE ? s.MASK + l * NT : nullptr);
        __syncthreads();
    }
    if (!HEAD) return;
    if (!SAVE) narrow(s.Y, H, p.wd, 1, p.bd, s.NAR, s.OUT4);  // raw density from the trunk output
    zero_acc(acc);
    gemm_seg(acc, s.Y, H, p.wi, H, s.WS);  // il = y Wi + bi, no ReLU
    epilogue<1>(acc, H, p.bi, s.Y, SAVE ? p.il : nullptr, row0, N, nullptr);
    __syncthreads();
    zero_acc(acc);
    gemm_seg(acc, s.Y, H, p.wc1a, p.Hh, s.WS);  // h = relu(il Wc1a + dE Wc1b + bc1)
    gemm_seg(acc, s.DE, p.Ddir, p.wc1b, p.Hh, s.WS);
    epilogue<0>(acc, p.Hh, p.bc1, s.Y, SAVE ? p.hs : nullptr, row0, N, SAVE ? s.MASK + p.L * NT : nullptr);
    __syncthreads();
    if (SAVE) return;
    narrow(s.Y, p.Hh, p.wc2, 3, p.bc2, s.NAR, s.OUT4 + BM);  // rgb logits
    for (int e = threadIdx.x; e < BM * 4; e += NT) {
        const int r = e >> 2, j = e & 3;
        if (row0 + r < N) p.out[(size_t)(row0 + r) * 4 + j] = s.OUT4[j * BM + r];
    }
}

template <bool HEAD>
__global__ void __launch_bounds__(NT, 2) fused_mlp_fwd_kernel(const Params p) {
    extern __shared__ float4 smem4[];
    const Smem s = carve(reinterpret_cast<float*>(smem4), p, HEAD, false);
    const int row0 = blockIdx.x * BM;
    load_rows(s.X, p.x, p.D, row0, p.N);
    if (HEAD) load_rows(s.DE, p.de, p.Ddir, row0, p.N);
    __syncthreads();
    forward_chain<HEAD, false>(p, s, row0);
}

template <bool HEAD>
__global__ void __launch_bounds__(NT, 1) fused_mlp_bwd_rows_kernel(const Params p) {
    extern __shared__ float4 smem4[];
    const Smem s = carve(reinterpret_cast<float*>(smem4), p, HEAD, true);
    const int row0 = blockIdx.x * BM, N = p.N, H = p.H, D = p.D;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    load_rows(s.X, p.x, D, row0, N);
    if (HEAD) load_rows(s.DE, p.de, p.Ddir, row0, N);
    for (int e = tid; e < D * BM; e += NT) s.DX[e] = 0.0f;
    __syncthreads();
    forward_chain<HEAD, true>(p, s, row0);

    float acc[8][8];
    uint64_t* top = s.MASK + (p.L - 1) * NT;
    if (HEAD) {
        load_rows(s.G4, p.g, 4, row0, N);  // [g_density, g_rgb] feature-major
        __syncthreads();
        zero_acc(acc);  // gh = mask_h * (g_rgb Wc2^T)
        gemm_seg(acc, s.G4 + BM, 3, p.wc2T, p.Hh, s.WS);
        epilogue<2>(acc, p.Hh, nullptr, s.Y, p.gh, row0, N, s.MASK + p.L * NT);
        __syncthreads();
        zero_acc(acc);  // d d_embed = gh Wc1b^T, straight to the output
        gemm_seg(acc, s.Y, p.Hh, p.wc1bT, p.Ddir, s.WS);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = col_of(j, lane);
            if (c >= p.Ddir) continue;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int r = row0 + warp * 8 + i;
                if (r < N) p.dde[(size_t)r * p.Ddir + c] = acc[i][j];
            }
        }
        zero_acc(acc);  // gil = gh Wc1a^T
        gemm_seg(acc, s.Y, p.Hh, p.wc1aT, H, s.WS);
        epilogue<1>(acc, H, nullptr, s.Y, p.gil, row0, N, nullptr);
        __syncthreads();
        zero_acc(acc);  // g_y = gil Wi^T + g_density wd^T, then the last trunk mask
        gemm_seg(acc, s.Y, H, p.wiT, H, s.WS);
        gemm_seg(acc, s.G4, 1, p.wd, H, s.WS);
        epilogue<2>(acc, H, nullptr, s.Y, p.gs + (size_t)(p.L - 1) * N * H, row0, N, top);
        __syncthreads();
    } else {
        const uint64_t keep = top[tid];
        float* dst = p.gs + (size_t)(p.L - 1) * N * H;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = col_of(j, lane);
            if (c >= H) continue;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int r = warp * 8 + i;
                float v = 0.0f;
                if (row0 + r < N && ((keep >> (i * 8 + j)) & 1)) v = __ldg(p.g + (size_t)(row0 + r) * H + c);
                s.Y[c * BM + r] = v;
                if (row0 + r < N) dst[(size_t)(row0 + r) * H + c] = v;
            }
        }
        __syncthreads();
    }
    // Trunk reverse: Y holds layer l's masked output gradient.
    for (int l = p.L - 1; l >= 0; --l) {
        const bool skip = (p.skips >> l) & 1;
        if (l == 0 || skip) {
            zero_acc(acc);  // the x part of the layer input's gradient
            gemm_seg(acc, s.Y, H, l == 0 ? p.wyT[0] : p.wxT[l], D, s.WS);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int c = col_of(j, lane);
                if (c >= D) continue;
#pragma unroll
                for (int i = 0; i < 8; ++i) s.DX[c * BM + warp * 8 + i] += acc[i][j];
            }
        }
        if (l > 0) {
            zero_acc(acc);
            gemm_seg(acc, s.Y, H, p.wyT[l], H, s.WS);
            epilogue<2>(acc, H, nullptr, s.Y, p.gs + (size_t)(l - 1) * N * H, row0, N, s.MASK + (l - 1) * NT);
        }
        __syncthreads();
    }
    for (int e = tid; e < BM * D; e += NT) {
        const int r = e / D, k = e - r * D;
        if (row0 + r < N) p.dx[(size_t)(row0 + r) * D + k] = s.DX[k * BM + r];
    }
}

// ---------------------------------------------------------------------------
// Weight gradients: out[m, n] = sum_r A[r, m] * B[r, n] over the rows of a
// split, as a list of products.  A == nullptr stands for a column of ones
// (a bias gradient).  trans: out index n * out_ld + m instead of m * out_ld + n.

struct Prod {
    const float* A;
    const float* B;
    int lda, M, ldb, Nn, out_off, out_ld, trans, tile0;
};

struct WParams {
    int N, rows_per_split, n_prod, total;
    float* part;  // splits x total
    Prod prod[MAX_PROD];
};

#define RT 8  // rows staged per step

__global__ void __launch_bounds__(NT, 2) fused_mlp_bwd_weights_kernel(const WParams wp) {
    __shared__ __align__(16) float As[2][RT * BM];
    __shared__ __align__(16) float Bs[2][RT * TN];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int pi = 0;
    while (pi + 1 < wp.n_prod && wp.prod[pi + 1].tile0 <= (int)blockIdx.x) ++pi;
    const Prod pr = wp.prod[pi];
    const int m0 = ((int)blockIdx.x - pr.tile0) * BM;
    const int r0 = blockIdx.y * wp.rows_per_split, r1 = min(wp.N, r0 + wp.rows_per_split);
    const bool live = warp * 8 < pr.M - m0;  // warp-uniform: some of this warp's rows are outputs
    float acc[8][8];
    zero_acc(acc);
    float pa[2], pb[RT];
    auto load = [&](int r) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int e = tid + q * NT, rr = e / BM, m = m0 + (e & (BM - 1));
            const bool ok = r + rr < r1 && m < pr.M;
            pa[q] = !ok ? 0.0f : (pr.A == nullptr ? (m == 0 ? 1.0f : 0.0f) : __ldg(pr.A + (size_t)(r + rr) * pr.lda + m));
        }
#pragma unroll
        for (int rr = 0; rr < RT; ++rr)
            pb[rr] = (r + rr < r1 && tid < pr.Nn) ? __ldg(pr.B + (size_t)(r + rr) * pr.ldb + tid) : 0.0f;
    };
    const int nsteps = r1 > r0 ? (r1 - r0 + RT - 1) / RT : 0;
    if (nsteps > 0) load(r0);
    for (int s = 0; s < nsteps; ++s) {
        float* as = As[s & 1];
        float* bs = Bs[s & 1];
        as[tid] = pa[0];
        as[tid + NT] = pa[1];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) bs[rr * TN + tid] = pb[rr];
        __syncthreads();
        if (s + 1 < nsteps) load(r0 + (s + 1) * RT);
        if (live) {
#pragma unroll
            for (int kk = 0; kk < RT; ++kk) fma8x8(acc, as + kk * BM + warp * 8, bs + kk * TN + lane * 4);
        }
    }
    float* part = wp.part + (size_t)blockIdx.y * wp.total + pr.out_off;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + warp * 8 + i;
        if (m >= pr.M) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int n = col_of(j, lane);
            if (n >= pr.Nn) continue;
            part[pr.trans ? (size_t)n * pr.out_ld + m : (size_t)m * pr.out_ld + n] = acc[i][j];
        }
    }
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

// Flat gradient layout: per layer W_l then b_l; then (head) wd, bd, wi, bi,
// wc1a, wc1b, bc1, wc2, bc2.  Returns the total.
int grad_layout(const int* dims, int head, int* offW, int* offb, int* offh) {
    const int D = dims[1], Ddir = dims[2], H = dims[3], Hh = dims[4], L = dims[5];
    const unsigned skips = (unsigned)dims[6];
    int o = 0;
    for (int l = 0; l < L; ++l) {
        const int kin = (l == 0 ? D : H) + (((skips >> l) & 1) ? D : 0);
        offW[l] = o;
        o += kin * H;
        offb[l] = o;
        o += H;
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

int splits_for(int N) {
    int s = N / 8192;
    return s < 1 ? 1 : (s > 32 ? 32 : s);
}

}  // namespace

extern "C" {

// Scratch sizes (in floats) the backward needs: activations and partials.
int fused_mlp_workspace(const int* dims, int head, long long* acts, long long* parts) {
    int err = shape_error(dims, head);
    if (err) return err;
    const long long N = dims[0], H = dims[3], Hh = head ? dims[4] : 0, L = dims[5];
    *acts = 2 * L * N * H + (head ? 2 * N * H + 2 * N * Hh : 0);
    int offW[MAX_L], offb[MAX_L], offh[9];
    *parts = (long long)splits_for(dims[0]) * grad_layout(dims, head, offW, offb, offh);
    return 0;
}

// ptrs: x, de, out, w[0..L), b[0..L), wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2.
int fused_mlp_forward(const long long* ptrs, const int* dims, int head, long long stream) {
    int err = shape_error(dims, head);
    if (err) return err;
    Params p = fill(dims, head);
    if (p.N == 0) return 0;
    p.x = (const float*)ptrs[0];
    p.de = (const float*)ptrs[1];
    p.out = (float*)ptrs[2];
    const long long* q = ptrs + 3;
    for (int l = 0; l < p.L; ++l) p.w[l] = (const float*)q[l];
    for (int l = 0; l < p.L; ++l) p.b[l] = (const float*)q[p.L + l];
    q += 2 * p.L;
    if (head) {
        p.wd = (const float*)q[0]; p.bd = (const float*)q[1]; p.wi = (const float*)q[2];
        p.bi = (const float*)q[3]; p.wc1a = (const float*)q[4]; p.wc1b = (const float*)q[5];
        p.bc1 = (const float*)q[6]; p.wc2 = (const float*)q[7]; p.bc2 = (const float*)q[8];
    }
    const size_t bytes = smem_floats(p.D, p.Ddir, p.H, p.Hh, p.L, head, false) * sizeof(float);
    const void* kernel = head ? (const void*)fused_mlp_fwd_kernel<true> : (const void*)fused_mlp_fwd_kernel<false>;
    err = launch_smem(kernel, bytes);
    if (err) return err;
    const dim3 grid((p.N + BM - 1) / BM);
    cudaStream_t st = (cudaStream_t)stream;
    if (head) fused_mlp_fwd_kernel<true><<<grid, NT, bytes, st>>>(p);
    else fused_mlp_fwd_kernel<false><<<grid, NT, bytes, st>>>(p);
    return (int)cudaGetLastError();
}

// ptrs: x, de, g, dx, dde, grad (flat, see grad_layout), acts scratch,
// parts scratch, w[L], b[L], wyT[L], wxT[L], then with a head wd, bd, wi,
// bi, wc1a, wc1b, bc1, wc2, bc2, wiT, wc1aT, wc1bT, wc2T.
int fused_mlp_backward(const long long* ptrs, const int* dims, int head, long long stream) {
    int err = shape_error(dims, head);
    if (err) return err;
    Params p = fill(dims, head);
    if (p.N == 0) return 0;
    const long long N = p.N, H = p.H, Hh = p.Hh;
    p.x = (const float*)ptrs[0];
    p.de = (const float*)ptrs[1];
    p.g = (const float*)ptrs[2];
    p.dx = (float*)ptrs[3];
    p.dde = (float*)ptrs[4];
    float* grad = (float*)ptrs[5];
    float* acts = (float*)ptrs[6];
    float* parts = (float*)ptrs[7];
    const long long* q = ptrs + 8;
    for (int l = 0; l < p.L; ++l) {
        p.w[l] = (const float*)q[l];
        p.b[l] = (const float*)q[p.L + l];
        p.wyT[l] = (const float*)q[2 * p.L + l];
        p.wxT[l] = (const float*)q[3 * p.L + l];
    }
    q += 4 * p.L;
    if (head) {
        p.wd = (const float*)q[0]; p.bd = (const float*)q[1]; p.wi = (const float*)q[2];
        p.bi = (const float*)q[3]; p.wc1a = (const float*)q[4]; p.wc1b = (const float*)q[5];
        p.bc1 = (const float*)q[6]; p.wc2 = (const float*)q[7]; p.bc2 = (const float*)q[8];
        p.wiT = (const float*)q[9]; p.wc1aT = (const float*)q[10]; p.wc1bT = (const float*)q[11];
        p.wc2T = (const float*)q[12];
    }
    p.ys = acts;
    p.gs = acts + p.L * N * H;
    if (head) {
        p.il = acts + 2 * p.L * N * H;
        p.gil = p.il + N * H;
        p.hs = p.gil + N * H;
        p.gh = p.hs + N * Hh;
    }
    cudaStream_t st = (cudaStream_t)stream;

    const size_t bytes = smem_floats(p.D, p.Ddir, p.H, p.Hh, p.L, head, true) * sizeof(float);
    const void* rows = head ? (const void*)fused_mlp_bwd_rows_kernel<true> : (const void*)fused_mlp_bwd_rows_kernel<false>;
    err = launch_smem(rows, bytes);
    if (err) return err;
    const dim3 grid((p.N + BM - 1) / BM);
    if (head) fused_mlp_bwd_rows_kernel<true><<<grid, NT, bytes, st>>>(p);
    else fused_mlp_bwd_rows_kernel<false><<<grid, NT, bytes, st>>>(p);
    err = (int)cudaGetLastError();
    if (err) return err;

    WParams wp = {};
    int offW[MAX_L], offb[MAX_L], offh[9];
    wp.total = grad_layout(dims, head, offW, offb, offh);
    wp.N = p.N;
    const int splits = splits_for(p.N);
    wp.rows_per_split = ((p.N + splits - 1) / splits + RT - 1) / RT * RT;
    wp.part = parts;
    int n = 0, tiles = 0;
    auto add = [&](const float* A, int lda, int M, const float* B, int ldb, int Nn, int off, int ld, int trans) {
        Prod& pr = wp.prod[n++];
        pr.A = A; pr.lda = lda; pr.M = M; pr.B = B; pr.ldb = ldb; pr.Nn = Nn;
        pr.out_off = off; pr.out_ld = ld; pr.trans = trans; pr.tile0 = tiles;
        tiles += (M + BM - 1) / BM;
    };
    for (int l = 0; l < p.L; ++l) {
        const float* gl = p.gs + (size_t)l * N * H;
        if (l == 0) {
            add(p.x, p.D, p.D, gl, p.H, p.H, offW[0], p.H, 0);
        } else {
            add(p.ys + (size_t)(l - 1) * N * H, p.H, p.H, gl, p.H, p.H, offW[l], p.H, 0);
            if ((p.skips >> l) & 1) add(p.x, p.D, p.D, gl, p.H, p.H, offW[l] + p.H * p.H, p.H, 0);
        }
        add(nullptr, 0, 1, gl, p.H, p.H, offb[l], p.H, 0);
    }
    if (head) {
        const float* y = p.ys + (size_t)(p.L - 1) * N * H;
        add(p.g, 4, 1, y, p.H, p.H, offh[0], 1, 1);                // wd (H, 1)
        add(nullptr, 0, 1, p.g, 4, 1, offh[1], 1, 0);              // bd
        add(y, p.H, p.H, p.gil, p.H, p.H, offh[2], p.H, 0);        // wi
        add(nullptr, 0, 1, p.gil, p.H, p.H, offh[3], p.H, 0);      // bi
        add(p.il, p.H, p.H, p.gh, p.Hh, p.Hh, offh[4], p.Hh, 0);   // wc1a
        add(p.de, p.Ddir, p.Ddir, p.gh, p.Hh, p.Hh, offh[5], p.Hh, 0);  // wc1b
        add(nullptr, 0, 1, p.gh, p.Hh, p.Hh, offh[6], p.Hh, 0);    // bc1
        add(p.g + 1, 4, 3, p.hs, p.Hh, p.Hh, offh[7], 3, 1);       // wc2 (Hh, 3)
        add(nullptr, 0, 1, p.g + 1, 4, 3, offh[8], 3, 0);          // bc2
    }
    wp.n_prod = n;
    fused_mlp_bwd_weights_kernel<<<dim3(tiles, splits), NT, 0, st>>>(wp);
    err = (int)cudaGetLastError();
    if (err) return err;
    fused_mlp_bwd_reduce_kernel<<<(wp.total + NT - 1) / NT, NT, 0, st>>>(parts, splits, wp.total, grad);
    return (int)cudaGetLastError();
}

}  // extern "C"
