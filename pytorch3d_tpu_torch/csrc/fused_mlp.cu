// Fused ReLU MLP with input skips, and the full NeRF field (trunk + density
// head + view-conditioned colour head), forward and backward, for Hopper
// (sm_90a), float32 in and out.
//
// Replaces the TPU kernels of pytorch3d_tpu/ops/fused_mlp_pallas.py:
//   #10 `_fwd_kernel` (:70)       -> fused_mlp_fwd_prep_kernel
//                                    + fused_mlp_fwd_kernel<false, SAVE>
//   #11 `_bwd_kernel` (:79)       -> fused_mlp_bwd_prep_kernel
//                                    + fused_mlp_bwd_rows_kernel<false, WIDE>
//                                    + fused_mlp_bwd_weights_kernel
//                                    + fused_mlp_bwd_reduce_kernel
//   #12 `_nerf_fwd_kernel` (:328) -> the same two with fwd_kernel<true, SAVE>
//   #13 `_nerf_bwd_kernel` (:341) -> the same four with rows_kernel<true, WIDE>
// #12 is #10's layer chain with the head as its epilogue and #13 is #11's
// reverse with the head's reverse in front, so one compile-time flag (HEAD)
// serves both pairs.
//
// What bounds it on an H100: operations.  At the NeRF model's width
// (8 trunk layers of 256 with the input of 39 concatenated again at layer 5,
// a colour head of 128 fed 27 direction features) a row costs 581,120
// multiply-adds, 1.16 MFLOP, against ~280 bytes of input and output: three
// orders of magnitude above the card's ridge.  The backward does twice the
// forward's multiply-adds (the chain to dx and the weight gradients).  Every
// product runs on the tensor cores as three TF32 passes: each operand is
// split into hi (rounded to TF32's 10 mantissa bits) and lo = a - hi, and
// a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.  One pass keeps ~11
// bits (~3e-4 of the NeRF field's largest output off float64); three are as
// close as float32, at 495 / 3 = 165 TFLOP/s of peak against the fp32 CUDA
// cores' 67.  The tensor cores truncate as they accumulate, so every short
// run of passes goes into a fresh tile that a rounded fp32 add puts into
// the sum.
//
// Forward (#10, #12): warp-specialised wgmma (see the forward section).  A
// block runs two consumer warpgroups of 64 rows and one producer warpgroup
// and walks row blocks of 128 (one block per SM).  A prep launch packs, per
// call, every weight the chain reads into hi and lo planes of 128-output,
// 8-input tiles in the order the chain reads them (4.65 MB at the NeRF
// widths, 8 KB a tile); the producer streams them by cp.async.bulk into a
// ring of shared-memory slots (mbarriers), and both warpgroups read each
// tile, so L2 serves one tile per 128 rows.  The consumers run wgmma
// m64n128k8 with A from registers; a layer's activations never leave the
// threads that computed them (the wgmma accumulator layout is, up to a
// permutation of the input features that the packing applies, the A
// fragment layout of the next layer), so they go to one 16-byte slot per
// thread per 8 features in shared memory, with no bank conflict and no
// barrier.  Bias, ReLU, the saving stores (SAVE: every trunk layer's output
// and, with the head, il and the colour hidden h, for the backward) and
// the density and rgb dot products run on the accumulators in registers;
// the output is (N, 4) with the head.  The Pallas kernels' padding of D and
// Ddir to 128 lanes and of N to 512 rows is TPU layout and is not carried
// over; widths pad to multiples of 8 (inputs) and 128 (outputs) with zeros.
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
//      for the weight pass.  dx's x part is written straight to dx, in
//      column tiles of 256 outputs where x is wider (the view-conditioned
//      NeRF's D of 327 and 455).
//   2. weights (fused_mlp_bwd_weights_kernel): every weight gradient
//      dW = A^T G, A the layer's input ([hidden; x] at a skip), as a product
//      split over the N rows; a block owns a 128 x 128 output tile of one
//      product and one split of the rows, so a 256-wide G is read twice;
//      an m-tile that straddles a skip layer's [hidden; x] split stages its
//      rows with 4-byte copies from both.
//      The bias gradient 1^T G is the column sums that the tile's first
//      m-block takes of the G tiles it stages, written as the row after W,
//      where the flat layout keeps b.
//   3. reduce (fused_mlp_bwd_reduce_kernel): the splits' partial sums added
//      in a fixed order.  No atomics: two calls give the same bits.
// Passes 1 and 2 run the three passes as mma.sync m16n8k8 TF32 (one pass
// is ~1e-3 of a gradient's largest entry off float64, three ~1e-6), each
// k-step's passes into a fresh tile (one long chain drifted by ~1e-4 over
// 8192 rows).  Shared-memory strides are padded so that every
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

#define NT 256     // threads per block of the backward
#define TN 256     // widest layer (one column tile of the backward)
#define MAX_L 12   // trunk layers
#define MAX_PROD 16

// The backward's view of one call.
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

// ---------------------------------------------------------------------------
// Tensor-core helpers.  The backward's mma.sync m16n8k8 TF32, fragments as in the
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

// ---------------------------------------------------------------------------
// Forward (#10, #12) on the tensor cores: wgmma m64n128k8 TF32 in three passes.
//
// A block runs FWD_NC (2) consumer warpgroups of 64 rows each and one
// producer warpgroup.  Each product of the chain runs as column blocks of
// 128 outputs, each over its k-blocks (8 input features each): the producer
// streams the block's weight tiles, packed by fused_mlp_fwd_prep_kernel in
// the order the chain reads them, with cp.async.bulk into a ring of
// shared-memory slots (full / empty mbarriers), and both warpgroups read
// every tile; they issue their chunks in turn (two named barriers), so that
// one's waits and adds overlap the other's passes.  A consumer warpgroup
// issues, per k-block, wgmma m64n128k8 with A (its 64 rows x 8 features)
// from registers and B (the packed tile, 128 x 8, K-major, no swizzle) from
// the ring: a_lo b_hi + a_hi b_lo + a_hi b_hi.  The tensor cores truncate as they accumulate, and one chain of
// 37 k-blocks drifted 5e-6 off float64, enough to flip ReLU masks that the
// backward reads: so the passes of every FWD_CHUNK k-blocks go into a fresh
// tile that a rounded fp32 add puts into the sum (float32's accuracy).
//
// The activations never leave the thread that computed them.  Thread
// (warp w, lane 4g + t) of a warpgroup holds accumulator entries (16w + g
// [+ 8], 8j + 2t [+ 1]); those four values of 8-column block j are exactly
// its A fragment (rows 16w + g [+ 8], k-slots t and t + 4) of k-block j for
// the next layer, if k-slot t of block j stands for feature 8j + 2t and slot
// t + 4 for 8j + 2t + 1.  The packing applies that permutation to the rows
// of every weight, so the epilogue writes its outputs as one float4 per
// block into the thread's own column of shared memory (one 16-byte slot per
// thread per k-block: no bank conflict, no barrier between layers), and the
// next product reads it back as its A fragment.  Every column block of a
// layer reads the whole input, so the outputs replace it only once the
// product is done.  x and d_embed are loaded into the same layout once per
// row block.

#define FWD_NC 2                            // consumer warpgroups per block
#define FWD_THREADS ((FWD_NC + 1) * 128)    // + one producer warpgroup
#define FWD_N 128                           // outputs per column block (the wgmma's N)
#define FWD_CHUNK 2                         // k-blocks summed in one fresh tile
#define FWD_TILE_BYTES (2 * FWD_N * 8 * 4)  // a tile's hi and lo planes
#define FWD_MAX_SLOTS 8

struct FwdParams {
    int N, D, Ddir, H, Hh, L;
    unsigned skips;
    int nc, slots;       // consumer warpgroups, ring slots
    int nbX, nbH, nbE;   // k-blocks of x, of the hidden width, of d_embed
    const float* x;
    const float* de;
    float* out;
    const float* b[MAX_L];
    const float *wd, *bd, *bi, *bc1, *wc2, *bc2;
    float* ys[MAX_L];  // saving forward: each trunk layer's output (N, H)
    float* il;         // (N, H)
    float* hs;         // (N, Hh)
    const float* packed;  // the weight tiles in the order the chain reads them
    int n_tiles;          // per row block
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Descriptor of a 128 x 8 K-major tf32 plane without swizzle: core matrices
// of 8 rows x 16 bytes, the two along K 128 bytes apart (LBO), successive
// 8-row groups 256 bytes apart (SBO).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps a register's value where it is until this point (an in-flight wgmma
// still reads it).
__device__ __forceinline__ void keep(uint32_t (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void keep(float (&r)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d = A B + (add ? d : 0) for A (64 x 8, tf32, registers) and B (128 x 8 at desc).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, bool add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)add));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The ring as one consumer thread sees it.
struct Ring {
    uint32_t slots, full, empty;  // shared addresses: slot 0, full[0], empty[0]
    int n;                        // slots
    int slot;                     // the next tile's slot
    uint32_t parity;              // and the parity of its fill
    int wg;                       // this thread's consumer warpgroup
    bool pair;                    // two consumer warpgroups take turns issuing
    __device__ __forceinline__ void advance() {
        if (++slot == n) {
            slot = 0;
            parity ^= 1u;
        }
    }
    // One thread of each warpgroup hands a slot back (the empty barrier
    // counts warpgroups).
    __device__ __forceinline__ void release(int s, bool lead) const {
        if (s >= 0 && lead) mbar_arrive(empty + 8 * s);
    }
    // Two warpgroups issue their chunks in turn (named barriers 1 and 2), so
    // that one's wait and fp32 adds overlap the other's passes.
    __device__ __forceinline__ void my_turn() const {
        if (pair) bar_sync(1 + wg, 256);
    }
    __device__ __forceinline__ void your_turn() const {
        if (pair) bar_arrive(2 - wg, 256);
    }
};

__device__ __forceinline__ void split4(const float4 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    split_tf32(v.x, hi[0], lo[0]);
    split_tf32(v.y, hi[1], lo[1]);
    split_tf32(v.z, hi[2], lo[2]);
    split_tf32(v.w, hi[3], lo[3]);
}

// sums[h] = bias[128h..] + [A0 | A1] B_h for the NH column blocks of one
// product (bias zero past width), over nb0 + nb1 k-blocks, A0 and A1 in the
// fragment layout (a0[q * nct] is this thread's fragment of k-block q).  The
// bias goes in first, so the epilogue loads none.  Per chunk of FWD_CHUNK
// k-blocks, their fragments are loaded and split once; then, column block
// by column block, the tiles land in ring order (the packing's order), the
// passes go into a fresh tile (the chunk's first pass overwrites it), all
// retire, the tile goes into the block's sum and the slots go back.
template <int NH>
__device__ __forceinline__ void product(float (&sums)[NH][64], const float* __restrict__ bias, int width,
                                        const float4* a0, int nb0, const float4* a1, int nb1, int nct, Ring& r,
                                        bool lead) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < FWD_N / 8; ++j) {
            const int f = FWD_N * h + 8 * j + 2 * t;
            const float b0 = f < width ? __ldg(bias + f) : 0.0f, b1 = f + 1 < width ? __ldg(bias + f + 1) : 0.0f;
            sums[h][4 * j] = sums[h][4 * j + 2] = b0;
            sums[h][4 * j + 1] = sums[h][4 * j + 3] = b1;
        }
    float tile[64];
    uint32_t hi[FWD_CHUNK][4], lo[FWD_CHUNK][4];
    const int nq = nb0 + nb1;
    for (int q = 0; q < nq; q += FWD_CHUNK) {
        const int nk = min(FWD_CHUNK, nq - q);
#pragma unroll
        for (int k = 0; k < FWD_CHUNK; ++k)
            if (k < nk) split4(q + k < nb0 ? a0[(q + k) * nct] : a1[(q + k - nb0) * nct], hi[k], lo[k]);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
            int used[FWD_CHUNK];
            r.my_turn();
#pragma unroll
            for (int k = 0; k < FWD_CHUNK; ++k) {
                if (k >= nk) break;
                mbar_wait(r.full + 8 * r.slot, r.parity);
                const uint32_t at = r.slots + r.slot * FWD_TILE_BYTES;
                const uint64_t dhi = tile_desc(at), dlo = tile_desc(at + FWD_N * 32);
                wgmma_fence();
                wgmma_tf32(tile, lo[k], dhi, k > 0);
                wgmma_tf32(tile, hi[k], dlo, true);
                wgmma_tf32(tile, hi[k], dhi, true);
                wgmma_commit();
                used[k] = r.slot;
                r.advance();
            }
            r.your_turn();
            wgmma_wait<0>();
            keep(tile);
#pragma unroll
            for (int k = 0; k < FWD_CHUNK; ++k) {
                keep(hi[k]);
                keep(lo[k]);
                if (k < nk) r.release(used[k], lead);
            }
#pragma unroll
            for (int i = 0; i < 64; ++i) sums[h][i] += tile[i];
        }
    }
}

// v0..v3 = (r0, f), (r0, f + 1), (r1, f), (r1, f + 1) into dst (row stride
// ld), the second column where f + 1 < width, as float2 where vec.
__device__ __forceinline__ void store_pairs(float* dst, int ld, int width, int f, int r0, int r1, int N, float v0,
                                            float v1, float v2, float v3, bool vec) {
    const bool two = f + 1 < width;
    if (vec && two) {
        if (r0 < N) *reinterpret_cast<float2*>(dst + (size_t)r0 * ld + f) = make_float2(v0, v1);
        if (r1 < N) *reinterpret_cast<float2*>(dst + (size_t)r1 * ld + f) = make_float2(v2, v3);
        return;
    }
    if (r0 < N) {
        dst[(size_t)r0 * ld + f] = v0;
        if (two) dst[(size_t)r0 * ld + f + 1] = v1;
    }
    if (r1 < N) {
        dst[(size_t)r1 * ld + f] = v2;
        if (two) dst[(size_t)r1 * ld + f + 1] = v3;
    }
}

// The outputs of one column block from its sums (bias included): v = sum,
// ReLU'd with RELU, for the block's width columns.  ACT: into the thread's
// fragment column (act points at the block's first k-block) for the next
// product.  STORE: to dst (the block's first column; row stride ld, rows r0,
// r1 < N).  NDOT: dots[e][k] += v . wdot[:, k] (the density or rgb logits
// over the thread's columns; the caller adds the other three lanes of the
// row).
template <bool RELU, bool ACT, bool STORE, int NDOT>
__device__ __forceinline__ void epilogue(const float (&sum)[64], int width, float4* act, int nct, float* dst, int ld,
                                         int r0, int r1, int N, const float* __restrict__ wdot, float (&dots)[2][3]) {
    const int t = threadIdx.x & 3;
    const bool vec = STORE && (ld & 1) == 0 && ((size_t)dst & 7) == 0;
#pragma unroll
    for (int j = 0; j < FWD_N / 8; ++j) {
        const int f = 8 * j + 2 * t;
        if (8 * j >= width) break;
        float v0 = sum[4 * j], v1 = sum[4 * j + 1], v2 = sum[4 * j + 2], v3 = sum[4 * j + 3];
        if (RELU) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
            v2 = fmaxf(v2, 0.0f);
            v3 = fmaxf(v3, 0.0f);
        }
        if (ACT) act[j * nct] = make_float4(v0, v2, v1, v3);
        if (STORE && f < width) store_pairs(dst, ld, width, f, r0, r1, N, v0, v1, v2, v3, vec);
#pragma unroll
        for (int k = 0; k < NDOT; ++k) {
            const float w0 = f < width ? __ldg(wdot + f * NDOT + k) : 0.0f;
            const float w1 = f + 1 < width ? __ldg(wdot + (f + 1) * NDOT + k) : 0.0f;
            dots[0][k] = fmaf(v1, w1, fmaf(v0, w0, dots[0][k]));
            dots[1][k] = fmaf(v3, w1, fmaf(v2, w0, dots[1][k]));
        }
    }
}

// The fragment column of src (N x width, row-major) for rows r0 and r1:
// k-block j holds (r0, f), (r1, f), (r0, f + 1), (r1, f + 1), f = 8j + 2t,
// zero past N and width.
__device__ __forceinline__ void load_frags(float4* dst, int nct, const float* __restrict__ src, int width, int nb,
                                           int r0, int r1, int N) {
    const int t = threadIdx.x & 3;
    for (int j = 0; j < nb; ++j) {
        const int f = 8 * j + 2 * t;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (r0 < N && f < width) v[0] = __ldg(src + (size_t)r0 * width + f);
        if (r1 < N && f < width) v[1] = __ldg(src + (size_t)r1 * width + f);
        if (r0 < N && f + 1 < width) v[2] = __ldg(src + (size_t)r0 * width + f + 1);
        if (r1 < N && f + 1 < width) v[3] = __ldg(src + (size_t)r1 * width + f + 1);
        dst[j * nct] = make_float4(v[0], v[1], v[2], v[3]);
    }
}

// One layer of H outputs from [A0 | A1] (NH column blocks) and its
// epilogue: the outputs replace the input only once the product is done.
template <int NH, bool RELU, bool ACT, bool STORE, int NDOT>
__device__ __forceinline__ void layer_nh(const float* bias, int H, const float4* a0, int nb0, const float4* a1,
                                         int nb1, float4* act, int nct, float* dst, int r0, int r1, int N,
                                         const float* wdot, float (&dots)[2][3], Ring& r, bool lead) {
    float s[NH][64];
    product<NH>(s, bias, H, a0, nb0, a1, nb1, nct, r, lead);
#pragma unroll
    for (int h = 0; h < NH; ++h)
        epilogue<RELU, ACT, STORE, NDOT>(s[h], min(FWD_N, H - FWD_N * h), act + (FWD_N / 8) * h * nct, nct,
                                         STORE ? dst + FWD_N * h : dst, H, r0, r1, N,
                                         NDOT ? wdot + FWD_N * h * NDOT : wdot, dots);
}

template <bool RELU, bool ACT, bool STORE, int NDOT>
__device__ __forceinline__ void layer(const float* bias, int H, const float4* a0, int nb0, const float4* a1, int nb1,
                                      float4* act, int nct, float* dst, int r0, int r1, int N,
                                      const float* wdot, float (&dots)[2][3], Ring& r, bool lead) {
    if (H > FWD_N) layer_nh<2, RELU, ACT, STORE, NDOT>(bias, H, a0, nb0, a1, nb1, act, nct, dst, r0, r1, N, wdot, dots, r, lead);
    else layer_nh<1, RELU, ACT, STORE, NDOT>(bias, H, a0, nb0, a1, nb1, act, nct, dst, r0, r1, N, wdot, dots, r, lead);
}

// One consumer warpgroup's chain over the block's row blocks.
template <bool HEAD, bool SAVE>
__device__ __forceinline__ void consume(const FwdParams& p, Ring& r, float4* act, float4* xs, float4* des) {
    const int tid = threadIdx.x, nct = p.nc * 128, rows = p.nc * 64;
    const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const bool lead = (tid & 127) == 0;
    const int N = p.N, H = p.H, L = p.L, nblocks = (N + rows - 1) / rows;
    float none[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    for (int rb = blockIdx.x; rb < nblocks; rb += gridDim.x) {
        const int r0 = rb * rows + wg * 64 + 16 * w + g, r1 = r0 + 8;
        load_frags(xs, nct, p.x, p.D, p.nbX, r0, r1, N);
        if (HEAD) load_frags(des, nct, p.de, p.Ddir, p.nbE, r0, r1, N);
        float dens[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
        for (int l = 0; l < L; ++l) {
            const float4* a0 = l == 0 ? xs : act;
            const int nb0 = l == 0 ? p.nbX : p.nbH, nb1 = l > 0 && ((p.skips >> l) & 1) ? p.nbX : 0;
            if (l < L - 1) {
                if constexpr (SAVE) layer<true, true, true, 0>(p.b[l], H, a0, nb0, xs, nb1, act, nct, p.ys[l], r0, r1, N, nullptr, none, r, lead);
                else layer<true, true, false, 0>(p.b[l], H, a0, nb0, xs, nb1, act, nct, nullptr, r0, r1, N, nullptr, none, r, lead);
            } else if (!HEAD) {
                layer<true, false, true, 0>(p.b[l], H, a0, nb0, xs, nb1, act, nct, p.out, r0, r1, N, nullptr, none, r, lead);
            } else {  // the trunk's output, and the density logit from it
                layer<true, true, SAVE, 1>(p.b[l], H, a0, nb0, xs, nb1, act, nct, p.ys[l], r0, r1, N, p.wd, dens, r, lead);
            }
        }
        if (!HEAD) continue;
        // il = y Wi + bi
        layer<false, true, SAVE, 0>(p.bi, H, act, p.nbH, xs, 0, act, nct, p.il, r0, r1, N, nullptr, none, r, lead);
        // h = relu(il Wc1a + d_embed Wc1b + bc1) and rgb = h wc2 (h is not kept)
        float rgb[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
        layer<true, false, SAVE, 3>(p.bc1, p.Hh, act, p.nbH, des, p.nbE, act, nct, p.hs, r0, r1, N, p.wc2, rgb, r,
                                    lead);
        float o[2][4] = {{dens[0][0], rgb[0][0], rgb[0][1], rgb[0][2]}, {dens[1][0], rgb[1][0], rgb[1][1], rgb[1][2]}};
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                o[e][k] += __shfl_xor_sync(0xffffffffu, o[e][k], 1);
                o[e][k] += __shfl_xor_sync(0xffffffffu, o[e][k], 2);
            }
        if (t == 0) {
            const float4 bias = make_float4(__ldg(p.bd), __ldg(p.bc2), __ldg(p.bc2 + 1), __ldg(p.bc2 + 2));
            if (r0 < N)
                *reinterpret_cast<float4*>(p.out + (size_t)r0 * 4) =
                    make_float4(o[0][0] + bias.x, o[0][1] + bias.y, o[0][2] + bias.z, o[0][3] + bias.w);
            if (r1 < N)
                *reinterpret_cast<float4*>(p.out + (size_t)r1 * 4) =
                    make_float4(o[1][0] + bias.x, o[1][1] + bias.y, o[1][2] + bias.z, o[1][3] + bias.w);
        }
    }
}

// The producer: one thread streams the packed tiles, for every row block
// the block takes, into the ring.
__device__ __forceinline__ void produce(const FwdParams& p, uint32_t slots, uint32_t full, uint32_t empty) {
    const int rows = p.nc * 64, nblocks = (p.N + rows - 1) / rows;
    int slot = 0;
    uint32_t parity = 0;
    for (int rb = blockIdx.x; rb < nblocks; rb += gridDim.x) {
        const char* src = reinterpret_cast<const char*>(p.packed);
        for (int i = 0; i < p.n_tiles; ++i, src += FWD_TILE_BYTES) {
            mbar_wait(empty + 8 * slot, parity ^ 1u);
            mbar_expect_tx(full + 8 * slot, FWD_TILE_BYTES);
            bulk_load(slots + slot * FWD_TILE_BYTES, src, FWD_TILE_BYTES, full + 8 * slot);
            if (++slot == p.slots) {
                slot = 0;
                parity ^= 1u;
            }
        }
    }
}

// Shared memory: the ring's slots, the activations (nbH k-blocks), x (nbX),
// d_embed (nbE, with the head), each a 16-byte slot per consumer thread per
// k-block, then the 2 x slots mbarriers.
__host__ __device__ inline size_t fwd_smem_bytes(int nc, int slots, int nbX, int nbH, int nbE) {
    return (size_t)slots * FWD_TILE_BYTES + (size_t)nc * 128 * 16 * (nbH + nbX + nbE) + 16 * FWD_MAX_SLOTS;
}

template <bool HEAD, bool SAVE>
__global__ void __launch_bounds__(FWD_THREADS, 1) fused_mlp_fwd_kernel(const FwdParams p) {
    extern __shared__ float4 smem4[];
    char* base = reinterpret_cast<char*>(smem4);
    const int nct = p.nc * 128;
    float4* act = reinterpret_cast<float4*>(base + (size_t)p.slots * FWD_TILE_BYTES);
    float4* xs = act + p.nbH * nct;
    float4* des = xs + p.nbX * nct;
    const uint32_t slots = smem_u32(base);
    const uint32_t full = smem_u32(des + p.nbE * nct), empty = full + 8 * FWD_MAX_SLOTS;
    if (threadIdx.x == 0) {
        for (int s = 0; s < p.slots; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, p.nc);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    // The producer warpgroup hands its registers to the consumers (the
    // launch gives every thread 65536 / 384 = 168): 24 + 2 x 240 per lane.
    if ((int)threadIdx.x >= nct) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
        if ((int)threadIdx.x == nct) produce(p, slots, full, empty);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
        Ring r = {slots, full, empty, p.slots, 0, 0u, (int)threadIdx.x >> 7, p.nc == 2};
        if (r.pair && r.wg == 1) bar_arrive(1, 256);  // warpgroup 0 issues first
        const int c = threadIdx.x;
        consume<HEAD, SAVE>(p, r, act + c, xs + c, des + c);
    }
}

// The forward's weight tiles, in the order the chain reads them.  Job j is
// one product: W0 (rows0 x cols, leading dimension cols) on the first nb0 =
// ceil(rows0 / 8) k-blocks, then W1 (rows1 x cols, may be empty) on the next
// nb1, for nh = ceil(cols / FWD_N) column blocks.  Its tiles come per chunk
// of FWD_CHUNK k-blocks, per column block, per k-block of the chunk, each
// 2 x FWD_N x 8 floats: the hi plane (each weight rounded to TF32 as
// split_tf32 rounds) then the lo plane (weight - hi), each in the wgmma
// layout of tile_desc, zero past the rows and columns, the 8 input features
// of k-block q in the order 8q + {0, 2, 4, 6, 1, 3, 5, 7} of the fragment
// permutation.
struct FwdPack {
    const float* src0;
    const float* src1;
    int rows0, rows1, cols, off;
};

struct FwdPackParams {
    int n_jobs, total;
    float* dst;
    FwdPack job[MAX_L + 2];
};

__global__ void fused_mlp_fwd_prep_kernel(const FwdPackParams pp) {
    const int tile = FWD_TILE_BYTES / 4, plane_size = tile / 2;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pp.total; i += gridDim.x * blockDim.x) {
        int j = 0;
        while (j + 1 < pp.n_jobs && pp.job[j + 1].off <= i) ++j;
        const FwdPack jb = pp.job[j];
        const int nb0 = (jb.rows0 + 7) / 8, nq = nb0 + (jb.rows1 + 7) / 8, nh = (jb.cols + FWD_N - 1) / FWD_N;
        const int e = i - jb.off, u = e / tile, rem = e - u * tile;
        // tile u -> (k-block q, column block h)
        const int c = u / (FWD_CHUNK * nh), nk = min(FWD_CHUNK, nq - c * FWD_CHUNK), v = u - c * FWD_CHUNK * nh;
        const int h = v / nk, q = c * FWD_CHUNK + v - h * nk;
        const int plane = rem / plane_size, pos = rem - plane * plane_size;
        const int n = FWD_N * h + (pos >> 6) * 8 + ((pos >> 2) & 7);
        const int f = 8 * (q < nb0 ? q : q - nb0) + 2 * (pos & 3) + ((pos >> 5) & 1);
        const float* src = q < nb0 ? jb.src0 : jb.src1;
        const int rows = q < nb0 ? jb.rows0 : jb.rows1;
        const float w = (n < jb.cols && f < rows) ? __ldg(src + (size_t)f * jb.cols + n) : 0.0f;
        uint32_t hi, lo;
        split_tf32(w, hi, lo);
        pp.dst[i] = __uint_as_float(plane ? lo : hi);
    }
}


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
// head, gil and gh) for the weight pass.  WIDE (D > TN): dx's x part over
// column tiles, in a build of its own, so that the loop leaves the register
// allocation of the narrower builds as it was (in every build, the loop or
// a call to it spilled: #13 5.6 % slower at D = 39 on the H100).  The wide
// head build spills ~640 bytes itself; not tuned.
template <bool HEAD, bool WIDE>
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
            } else if (!WIDE) {
                rev_product(acc, G, sg, H, p.wxP[l], D, ring);
                for_each_acc(acc, D, to_dx);
            } else {  // column tiles of TN outputs: rows n0.. of the packed W_x
                for (int n0 = 0; n0 < D; n0 += TN) {
                    const int nout = min(TN, D - n0);
                    rev_product(acc, G, sg, H, p.wxP[l] + (size_t)n0 * round_up(H, RKT), nout, ring);
                    for_each_acc(acc, nout, [&](int r, int c, float v) { to_dx(r, n0 + c, v); });
                }
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

// The widest input x the forward takes beside a hidden width H and (head)
// Ddir direction features: its x, activations and d_embed, one 16-byte slot
// per thread per k-block, with one consumer warpgroup and two ring slots,
// in the card's shared memory (fwd_smem_bytes).  552 at the NeRF widths (H
// 256, Ddir 27) on an H100; ops/fused_mlp_cuda.py's input_limit reads it
// through fused_mlp_input_limit.
int input_limit(int H, int Ddir, int head) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const long long avail = (long long)optin - fwd_smem_bytes(1, 2, 0, 0, 0);
    const long long nbX = avail / (128 * 16) - (H + 7) / 8 - (head ? (Ddir + 7) / 8 : 0);
    return nbX > 0 ? (int)(8 * nbX) : 0;
}

int shape_error(const int* dims, int head) {
    const int N = dims[0], D = dims[1], Ddir = dims[2], H = dims[3], Hh = dims[4], L = dims[5];
    if (N < 0 || D < 1 || H < 1 || H > TN || L < 1 || L > MAX_L) return -1;
    if (head && (Ddir < 1 || Ddir > TN || Hh < 1 || Hh > TN)) return -1;
    if ((unsigned)dims[6] & 1u) return -1;  // layer 0 has no hidden input to concatenate to
    if (D > input_limit(H, Ddir, head)) return -2;
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

FwdParams fwd_fill(const int* dims, int head) {
    FwdParams fp = {};
    fp.N = dims[0];
    fp.D = dims[1];
    fp.Ddir = head ? dims[2] : 0;
    fp.H = dims[3];
    fp.Hh = head ? dims[4] : 0;
    fp.L = dims[5];
    fp.skips = (unsigned)dims[6];
    fp.nbX = (fp.D + 7) / 8;
    fp.nbH = (fp.H + 7) / 8;
    fp.nbE = (fp.Ddir + 7) / 8;
    return fp;
}

// The forward's pack jobs, one per product in the order the chain runs
// them: layer 0 on x; each later layer on its hidden input and, at a skip,
// x; with the head Wi, then [Wc1a; Wc1b] on [il, d_embed].  w and the head
// weights may be null when only the size is wanted.  Returns the packed
// floats.
int fwd_pack_layout(FwdParams& fp, int head, const float* const* w, const float* wi, const float* wc1a,
                    const float* wc1b, FwdPackParams* pp) {
    const int H = fp.H;
    int n = 0, off = 0;
    auto job = [&](const float* w0, int rows0, const float* w1, int rows1, int cols) {
        pp->job[n++] = {w0, w1, rows0, rows1, cols, off};
        off += ((rows0 + 7) / 8 + (rows1 + 7) / 8) * ((cols + FWD_N - 1) / FWD_N) * (FWD_TILE_BYTES / 4);
    };
    for (int l = 0; l < fp.L; ++l) {
        const float* wl = w ? w[l] : nullptr;
        const bool skip = l > 0 && ((fp.skips >> l) & 1);
        job(wl, l == 0 ? fp.D : H, skip && wl ? wl + (size_t)H * H : nullptr, skip ? fp.D : 0, H);
    }
    if (head) {
        job(wi, H, nullptr, 0, H);
        job(wc1a, H, wc1b, fp.Ddir, fp.Hh);
    }
    pp->n_jobs = n;
    pp->total = off;
    fp.n_tiles = off / (FWD_TILE_BYTES / 4);
    return off;
}

// Consumer warpgroups and ring slots for the card's shared memory: two
// warpgroups where they fit with at least two slots, up to FWD_MAX_SLOTS
// (one where x and d_embed are so wide that two do not).
int fwd_config(FwdParams& fp, int head, size_t* bytes) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int nc = FWD_NC; nc >= 1; --nc)
        for (int slots = FWD_MAX_SLOTS; slots >= 2; --slots) {
            const size_t b = fwd_smem_bytes(nc, slots, fp.nbX, fp.nbH, head ? fp.nbE : 0);
            if (b <= (size_t)optin) {
                fp.nc = nc;
                fp.slots = slots;
                *bytes = b;
                return 0;
            }
        }
    return -2;
}

}  // namespace

extern "C" {

// The widest input x the kernels take beside H and Ddir (head) on this card.
int fused_mlp_input_limit(int H, int Ddir, int head) { return input_limit(H, Ddir, head); }

// Sizes in floats: what a saving forward stores (`saved`), the backward's
// scratch (masked gradients, packed weights, the splits' partials) and the
// forward's packed weight tiles (`packed`).
int fused_mlp_workspace(const int* dims, int head, long long* saved, long long* scratch, long long* packed) {
    int err = shape_error(dims, head);
    if (err) return err;
    Params p = fill(dims, head);
    PackParams pp;
    WParams wp = {};
    *saved = saved_floats(p, head);
    const int splits = plan_products(p, dims, head, wp);
    *scratch = grads_floats(p, head) + pack_layout(p, head, nullptr, &pp) + (long long)splits * wp.total;
    FwdParams fp = fwd_fill(dims, head);
    FwdPackParams fpp;
    *packed = fwd_pack_layout(fp, head, nullptr, nullptr, nullptr, nullptr, &fpp);
    return 0;
}

// ptrs: x, de, out, saved (0: serving, nothing saved), packed (the
// workspace's `packed` floats), w[0..L), b[0..L), wd, bd, wi, bi, wc1a,
// wc1b, bc1, wc2, bc2.  Two launches: the weights' packing, then the chain.
int fused_mlp_forward(const long long* ptrs, const int* dims, int head, long long stream) {
    int err = shape_error(dims, head);
    if (err) return err;
    FwdParams fp = fwd_fill(dims, head);
    if (fp.N == 0) return 0;
    fp.x = (const float*)ptrs[0];
    fp.de = (const float*)ptrs[1];
    fp.out = (float*)ptrs[2];
    float* saved = (float*)ptrs[3];
    float* packed = (float*)ptrs[4];
    const float* w[MAX_L];
    for (int l = 0; l < fp.L; ++l) {
        w[l] = (const float*)ptrs[5 + l];
        fp.b[l] = (const float*)ptrs[5 + fp.L + l];
    }
    const long long* q = ptrs + 5 + 2 * fp.L;  // wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2
    if (head) {
        fp.wd = (const float*)q[0]; fp.bd = (const float*)q[1]; fp.bi = (const float*)q[3];
        fp.bc1 = (const float*)q[6]; fp.wc2 = (const float*)q[7]; fp.bc2 = (const float*)q[8];
    }
    if (saved) {  // the layout of point_saved
        const long long NH = (long long)fp.N * fp.H;
        for (int l = 0; l < fp.L; ++l) fp.ys[l] = saved + l * NH;
        if (head) {
            fp.il = saved + fp.L * NH;
            fp.hs = fp.il + NH;
        }
    }
    FwdPackParams pp;
    fwd_pack_layout(fp, head, w, head ? (const float*)q[2] : nullptr, head ? (const float*)q[4] : nullptr,
                    head ? (const float*)q[5] : nullptr, &pp);
    pp.dst = packed;
    fp.packed = packed;
    size_t bytes = 0;
    err = fwd_config(fp, head, &bytes);
    if (err) return err;
    const void* kernel = head ? (saved ? (const void*)fused_mlp_fwd_kernel<true, true>
                                       : (const void*)fused_mlp_fwd_kernel<true, false>)
                              : (saved ? (const void*)fused_mlp_fwd_kernel<false, true>
                                       : (const void*)fused_mlp_fwd_kernel<false, false>);
    err = launch_smem(kernel, bytes);
    if (err) return err;
    cudaStream_t st = (cudaStream_t)stream;
    fused_mlp_fwd_prep_kernel<<<(pp.total + NT - 1) / NT, NT, 0, st>>>(pp);
    err = (int)cudaGetLastError();
    if (err) return err;
    // Persistent blocks, one per SM, each walking row blocks of nc * 64 rows.
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int rows = fp.nc * 64, blocks = (fp.N + rows - 1) / rows;
    const dim3 grid(blocks < sms ? blocks : sms), threads((fp.nc + 1) * 128);
    if (head && saved) fused_mlp_fwd_kernel<true, true><<<grid, threads, bytes, st>>>(fp);
    else if (head) fused_mlp_fwd_kernel<true, false><<<grid, threads, bytes, st>>>(fp);
    else if (saved) fused_mlp_fwd_kernel<false, true><<<grid, threads, bytes, st>>>(fp);
    else fused_mlp_fwd_kernel<false, false><<<grid, threads, bytes, st>>>(fp);
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
    const bool wide = p.D > TN;
    const void* rows = head ? (wide ? (const void*)fused_mlp_bwd_rows_kernel<true, true>
                                    : (const void*)fused_mlp_bwd_rows_kernel<true, false>)
                            : (wide ? (const void*)fused_mlp_bwd_rows_kernel<false, true>
                                    : (const void*)fused_mlp_bwd_rows_kernel<false, false>);
    err = launch_smem(rows, bytes);
    if (err) return err;
    const dim3 grid((p.N + RB - 1) / RB);
    if (head && wide) fused_mlp_bwd_rows_kernel<true, true><<<grid, NT, bytes, st>>>(p);
    else if (head) fused_mlp_bwd_rows_kernel<true, false><<<grid, NT, bytes, st>>>(p);
    else if (wide) fused_mlp_bwd_rows_kernel<false, true><<<grid, NT, bytes, st>>>(p);
    else fused_mlp_bwd_rows_kernel<false, false><<<grid, NT, bytes, st>>>(p);
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
