#!/usr/bin/env python3
"""Study the fine mesh rasterizer (#1), the pulsar blend backward (#8),
the points rasterizer (#5, with its select-only build #6), the hard mesh
rasterizer (#3) and the points backward (#7) on one CUDA card: each
against an earlier build of it, its parts timed apart, and the
end-to-end paths that run them.

    git show b30e36d:pytorch3d_tpu_torch/csrc/rasterize_fine.cu > build/fine_parent.cu
    python3 raster_study.py fine --source build/fine_parent.cu
    git show b30e36d:pytorch3d_tpu_torch/csrc/pulsar_grad.cu > build/pulsar_parent.cu
    python3 raster_study.py pulsar --source build/pulsar_parent.cu
    git show febf1cf:pytorch3d_tpu_torch/csrc/rasterize_points.cu > build/points_parent.cu
    python3 raster_study.py points --source build/points_parent.cu
    git show 3144b18:pytorch3d_tpu_torch/csrc/rasterize_hard.cu > build/hard_parent.cu
    python3 raster_study.py hard --source build/hard_parent.cu
    git show 3144b18:pytorch3d_tpu_torch/csrc/rasterize_points_grad.cu > build/points_grad_parent.cu
    python3 raster_study.py points-grad --source build/points_grad_parent.cu
    python3 raster_study.py e2e [--tree DIR] [--reps N] [--paths NAME ...]

`fine`: FILE is a `rasterize_fine.cu` without the box growth in its C
interface, such as b30e36d's, where every pixel of a tile tests every
face of the tile's list.  The script builds FILE and copies of the
package's source that each change one thing (`fine_variants`):

- `no_cull`: every warp walks every face of the chunk at every pixel;
- `hoist`: the per-face terms (edge vectors, area + eps, the segments'
  max(|v|^2, eps), v0z * v1z, the flags) computed once at staging and
  staged beside the vertices, where the package recomputes them in every
  test;
- `thread_stores`: each thread stores its own run of K slots, lanes
  K x 4 bytes apart, where the package's warps write their rectangle's
  slots through shared memory;
- `blocks_any`: `__launch_bounds__` asking for no number of blocks an SM
  (the package asks for three at K <= 8);
- `prec_div_false`: the package's source built with `--prec-div=false`
  (approximate divisions, so other bits: timing only, its differing ids
  counted).

At every setting of `chip_smoke.phase_fine_kernel` and at the render-fit
step's shape (8 views of ico_sphere(4) at 512^2, K=16), FILE's four
outputs (ids, z, bary, dists) and those of the package and of each
bit-exact copy must be equal bit for bit; the script exits non-zero
otherwise.  Then it times each build by the profiler's device time
(`chip_smoke.device_ms`) at the serving batch, the headline and the
render-fit shape, in the order FILE, package, copies, package, FILE, and
prints the tests each design makes (`chip_smoke.tile_candidates`,
`chip_smoke.fine_tests`).

`pulsar`: FILE is a `pulsar_grad.cu` without the flag array in its C
interface, such as b30e36d's, where every pixel of a tile walks the
tile's whole sphere list.  Copies of the package's source change pass 1's
`__launch_bounds__`: `blocks_any` asks for no number of blocks an SM,
`blocks3` for three at K <= 8 (the package asks for four there).  On the
inputs of chip_smoke.py's pulsar-fit step 0 (10^5 spheres at 1024^2,
K=5, C=3, its loss's cotangent) and of one request of 10^6 spheres (a
seeded random cotangent) it prints the package's largest difference from
FILE's result over each field's largest entry, whether two package
launches and each copy give the package's bits, the package's device
time by pass, and each build's device time (both passes) in the order
FILE, package, copies, package, FILE.

`points`: FILE is a `rasterize_points.cu` with the same C interface,
such as febf1cf's, where every pixel of a tile tests every point of the
tile's list.  The script builds FILE, the package's source (for its
ptxas figures; the runs use the package's own build) and copies of it
that each change one thing (`points_variants`):

- `no_cull`: every warp walks every point of the chunk at every pixel;
- `lane_box`: a lane whose pixel lies outside the point's box skips the
  point's test, where the package's lanes all test it;
- `walk2`: a warp loads and tests two points of its list before it
  inserts either, where the package takes one at a time;
- `thread_stores`: each thread stores its own run of K slots, lanes
  K x 4 bytes apart, where the package's warps write their rectangle's
  slots through shared memory;
- `wide_buckets`: K = 5 runs the K bucket of 8 and K = 10 that of 16
  (FILE's buckets), where the package has buckets of 5 and 10;
- `buckets_6_12`: K = 5 runs a bucket of 6 and K = 10 one of 12;
- `blocks3`, `blocks4`: `__launch_bounds__` asking for three or four
  blocks an SM at K <= 16 (the package asks for none);
- `double_buffer`: each chunk's points gathered with `cp.async` into a
  second buffer while the warps walk the chunk before it.

At every case of `chip_smoke.points_kernel_cases` and at the 10^6-point
row (#5), and at every case of `chip_smoke.select_kernel_cases` and at
one request of 10^6 spheres (#6), FILE's outputs (ids, zbuf and dists;
ids for #6) and those of the package and of each copy must be equal bit
for bit; the script exits non-zero otherwise.  Then it times each build
by the profiler's device time (`chip_smoke.device_ms`) at the
points-serving batch, points-bench and 10^6 points (#5) and at
pulsar-serving request 0 and 10^6 spheres (#6), in the order FILE,
package, copies, package, FILE, and prints the (pixel, point) tests each
design makes (`chip_smoke.tile_candidates` for FILE; for the package
the lanes its warps walk, each of which tests, and the pixel centres in
the points' boxes among them, `chip_smoke.points_tests`).

`hard`: FILE is a `rasterize_hard.cu` without the box growth in its C
interface, such as 3144b18's, where every pixel of a tile tests every
face of the tile's list.  The script builds FILE, the package's source
(for its ptxas figures; the runs use the package's own build) and a copy,
`shared_stores`, in which each warp writes its rectangle's id, z and bary
through shared memory (as #1 does) where the package's threads store
their own pixels.  At the
serving batch for each of chip_smoke's 8 azimuths, at
`chip_smoke.hard_cull_edge_batch` (the cull's edge cases, at 120x200 and
512^2) and at `chip_smoke.crossing_strip_faces` (faces crossing z = 0,
at 512^2 and 120x200), FILE's three outputs (ids, z, bary), the
package's and the copy's must be equal bit for bit; the script exits non-zero otherwise.
It prints the ids' agreement with the plain version and the tests each
design makes (`chip_smoke.tile_candidates` for FILE, `chip_smoke.hard_tests`
for the package), then times both by the profiler's device time at the
serving batch (azimuths 30 and 165), in the order FILE, package, copy,
package, FILE.

`points-grad`: FILE is a `rasterize_points_grad.cu` with the C interface
before the binning was passed in, such as 3144b18's (one thread per
(pixel, slot), atomic adds).  The script builds FILE, the package's
source (for its ptxas figures; the runs use the package's own build) and
copies of it that each change one thing (`points_grad_variants`):

- `splits1`, `splits6`: a tile's passes go to one block or to six (the
  package three);
- `chunk128`: pass 1 sums 128 list positions a pass (the package 256),
  its passes shared by six blocks;
- `loads8`: a warp loads 8 groups of 32 slot ids at once (the package 4),
  with a ring of 512 queued slots;
- `shared_atomic` (timing only): each lane adds its partials to the
  warp's row with a shared-memory atomic, without the warp sort and
  scan, so the order of the sums changes from run to run.

At the points-fit step 0 (its loss's cotangents), points-bench
(cotangents 1 at the filled slots, as its loss) and the points-serving
batch (seeded random cotangents) it prints the package's largest
difference from FILE's result over the largest |grad|, whether two
package launches give the same bits and are finite, whether two of
FILE's do, and whether each copy gives the package's bits (the splits
and loads copies must: they sum the same slots in the same order) or how
far it is off; then the device time of each, in the order FILE, package,
copies, package, FILE: FILE's kernel and its call's whole device work
(the zero fill included), the package's and each copy's two passes, the
package's call's whole device work (the pair CSR and the flag fill
included), and the pair CSR (`face_pair_rows`) alone.

`e2e`: with the tree's own chip_smoke.py and port package (this checkout,
or another commit unpacked with `git archive` into a directory
.gitignore lists, such as `build/parent`), the serving frame (the mesh
batch at one of chip_smoke's 8 azimuths), the render-fit step, the
pulsar-serving request, the pulsar-fit step, the points-serving frame
(the 8 requests in one render), the points-fit step and the mesh-gl
frame (`MeshRasterizerOpenGL` with `HardPhongShader` on the serving
batch): each the host-clock median of N after warm-up
(`chip_smoke.timed_ms`), printed as one JSON line; `--paths` times only the named ones, in the order given.  Host
times vary up to 2x between calls, so compare two trees only in one
call, in turns:

    for t in build/parent . . build/parent; do python3 raster_study.py e2e --tree $t; done

Copies are built into `build/raster_study/`; none of them is package
code.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "raster_study"
CSRC = REPO / "pytorch3d_tpu_torch" / "csrc"
E2E_PATHS = ("serving frame", "render-fit step", "pulsar-serving request", "pulsar-fit step", "points-serving frame",
             "points-fit step", "mesh-gl frame")

FINE_BOUNDS = "__global__ void __launch_bounds__(kThreads, KB <= 8 ? 3 : 1)\nrasterize_fine_kernel("
FINE_STORES_START = "  // Each warp writes its rectangle's slots through its buffer"
FINE_STORES_END = "\ntemplate <int KB, bool kIdsOnly>\nvoid launch("
THREAD_STORES = """  if (!live) return;
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
"""
FINE_NO_CULL = (
    ("!(face.flags & kZeroArea) && b.x <= b.y && b.z <= b.w", "!(face.flags & kZeroArea)"),
    ("const bool meets = b.x < r0 + kRectH && b.y >= r0 && b.z < c0 + kRectW && b.w >= c0;",
     "const bool meets = true;"),
    ("const bool in_box = row >= b.x && row <= b.y && col >= b.z && col <= b.w;", "const bool in_box = true;"),
)
FINE_HOIST = (
    ("constexpr int kStaged = 9;", "constexpr int kStaged = 21;"),
    ("  const float v[kStaged] = {f.v0x, f.v0y, f.v0z, f.v1x, f.v1y, f.v1z, f.v2x, f.v2y, f.v2z};",
     "  const float v[kStaged] = {f.v0x, f.v0y, f.v0z, f.v1x, f.v1y, f.v1z, f.v2x, f.v2y, f.v2z,\n"
     "                            f.d01x, f.d01y, f.d12x, f.d12y, f.d02x, f.d02y, f.area_eps, f.z01,\n"
     "                            f.l01, f.l12, f.l02, __uint_as_float(f.flags)};"),
    ("  face_terms(f);\n  return f;",
     "  f.d01x = s.f[9][j]; f.d01y = s.f[10][j]; f.d12x = s.f[11][j]; f.d12y = s.f[12][j];\n"
     "  f.d02x = s.f[13][j]; f.d02y = s.f[14][j]; f.area_eps = s.f[15][j]; f.z01 = s.f[16][j];\n"
     "  f.l01 = s.f[17][j]; f.l12 = s.f[18][j]; f.l02 = s.f[19][j]; f.flags = __float_as_uint(s.f[20][j]);\n"
     "  return f;"),
)
POINTS_BOUNDS = "__global__ void __launch_bounds__(kThreads)\nrasterize_points_kernel("
POINTS_STORES_START = "  // Each warp writes its rectangle's slots through its buffer"
POINTS_STORES_END = "\ntemplate <int KB, bool kIdsOnly>\nvoid launch("
POINTS_THREAD_STORES = """  if (!live) return;
  const size_t pix = (static_cast<size_t>(n) * H + row0 + tr) * W + col0 + tc;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k < K) {
      const size_t o = pix * K + k;
      const bool empty = bi[k] < 0;
      out_idx[o] = bi[k];
      if (kIdsOnly) continue;
      out_z[o] = empty ? -1.0f : bz[k];
      out_dist[o] = empty ? -1.0f : bd[k];
    }
  }
}
"""
POINTS_NO_CULL = (
    ("      const unsigned rows = axis_bits(s.cy, y, r2);", "      const unsigned rows = 0xffffu;"),
    ("      const unsigned cols = axis_bits(s.cx, x, r2);", "      const unsigned cols = 0xffffu;"),
)
POINTS_LANE_BOX = (
    ("  int id[kThreads];\n", "  int id[kThreads];\n  unsigned box[kThreads];\n"),
    ("      s.id[tid] = p;\n", "      s.id[tid] = p;\n      s.box[tid] = rows | (cols << 16);\n"),
    ("      if (d2 < q.z) insert(", "      if (((s.box[j] >> tr) & (s.box[j] >> (16 + tc)) & 1u) && d2 < q.z) insert("),
)
# Two points of the warp's list loaded and tested before either is inserted.
POINTS_WALK2 = (("""    for (int i = 0; i < count; ++i) {
      const int j = s.list[warp][i];""", """    int i = 0;
    for (; i + 1 < count; i += 2) {
      const int ja = s.list[warp][i], jb = s.list[warp][i + 1];
      const float4 qa = s.pt[ja], qb = s.pt[jb];
      const float dxa = px - qa.x, dya = py - qa.y, dxb = px - qb.x, dyb = py - qb.y;
      const float d2a = dxa * dxa + dya * dya, d2b = dxb * dxb + dyb * dyb;
      if (d2a < qa.z) insert(bz, bd, bi, qa.w, d2a, s.id[ja]);
      if (d2b < qb.z) insert(bz, bd, bi, qb.w, d2b, s.id[jb]);
    }
    for (; i < count; ++i) {
      const int j = s.list[warp][i];"""),)
POINTS_WIDE_BUCKETS = (("  else if (K <= 5) P3D_LAUNCH(5);\n", ""), ("  else if (K <= 10) P3D_LAUNCH(10);\n", ""))
POINTS_BUCKETS_6_12 = (("  else if (K <= 5) P3D_LAUNCH(5);", "  else if (K <= 6) P3D_LAUNCH(6);"),
                       ("  else if (K <= 10) P3D_LAUNCH(10);", "  else if (K <= 12) P3D_LAUNCH(12);"))
# The double-buffered gather: chunk c + 1's x, y, z and r go by cp.async
# into the other half of a second buffer while the warps walk chunk c.
POINTS_DOUBLE_BUFFER = (
    ("template <int KB, bool kIdsOnly>\n__global__",
     "__device__ __forceinline__ void cp_async4(float* dst, const float* src) {\n"
     "  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));\n"
     "  asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4;\\n\" :: \"r\"(d), \"l\"(src) : \"memory\");\n"
     "}\n\n"
     "template <int KB, bool kIdsOnly>\n__global__"),
    ("""  for (int base = begin; base < end; base += kThreads) {
    const int m = min(kThreads, end - base);
    __syncthreads();  // the previous chunk has been consumed
    if (tid < m) {
      const int p = tile_points[base + tid];
      const size_t g = first + p;
      const float x = points[3 * g + 0];
      const float y = points[3 * g + 1];
      const float r = radius[g];
      const float r2 = r * r;
      const unsigned rows = axis_bits(s.cy, y, r2);
      const unsigned cols = axis_bits(s.cx, x, r2);
      s.pt[tid] = make_float4(x, y, r2, points[3 * g + 2]);""",
     """  __shared__ float raw[2][4][kThreads];
  auto gather = [&](int from, int to) {
    if (from + tid < end) {
      const size_t g = first + tile_points[from + tid];
      cp_async4(&raw[to][0][tid], points + 3 * g + 0);
      cp_async4(&raw[to][1][tid], points + 3 * g + 1);
      cp_async4(&raw[to][2][tid], points + 3 * g + 2);
      cp_async4(&raw[to][3][tid], radius + g);
    }
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
  };
  if (begin < end) gather(begin, 0);
  for (int base = begin, half = 0; base < end; base += kThreads, half ^= 1) {
    const int m = min(kThreads, end - base);
    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
    __syncthreads();  // this chunk has landed; the previous chunk has been consumed
    if (base + kThreads < end) gather(base + kThreads, half ^ 1);
    if (tid < m) {
      const int p = tile_points[base + tid];
      const float x = raw[half][0][tid];
      const float y = raw[half][1][tid];
      const float r = raw[half][3][tid];
      const float r2 = r * r;
      const unsigned rows = axis_bits(s.cy, y, r2);
      const unsigned cols = axis_bits(s.cx, x, r2);
      s.pt[tid] = make_float4(x, y, r2, raw[half][2][tid]);"""),
)
PGRAD_SORT_START = "    // Bitonic sort of the keys (pos, lane) across the warp, ascending;"
PGRAD_SORT_END = "    __syncwarp();\n  };"
# Timing only: each lane adds its partials to the warp's row with a shared
# atomic, in an order that changes from run to run.
PGRAD_SHARED_ATOMIC = """    if (pos >= 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(&acc[pos * 3 + c], g[c]);
    }
"""
HARD_STORES_START = "  if (!live) return;\n  // interpolate_fragments(perspective_correct=True) for the winner."
HARD_STORES_END = "\n}\n\n}  // namespace"
# Each warp writes its rectangle's id, z and bary through a piece of
# shared memory, a pixel's values an odd stride apart, read back as runs
# of consecutive addresses (#1's stores).
HARD_SHARED_STORES = """  float z = -1.0f, b0 = -1.0f, b1 = -1.0f, b2 = -1.0f;
  if (best_id >= 0) {
    const float t0 = (w0b * z1b) * z2b;
    const float t1 = (z0b * w1b) * z2b;
    const float t2 = (z0b * z1b) * w2b;
    const float denom = fmaxf((t0 + t1) + t2, kEpsilon);
    b0 = t0 / denom;
    b1 = t1 / denom;
    b2 = t2 / denom;
    z = (b0 * z0b + b1 * z1b) + b2 * z2b;
  }
  __shared__ float s_buf[kWarps][32 * 3];
  float* buf = s_buf[warp];
  const size_t rect_base = (static_cast<size_t>(n) * H + row0) * W + col0;
  const int rows_live = min(kRectH, H - row0), cols_live = min(kRectW, W - col0);
  auto put = [&](float* out, int wd, float v0, float v1, float v2) {
    buf[lane * wd] = v0;
    if (wd == 3) {
      buf[lane * 3 + 1] = v1;
      buf[lane * 3 + 2] = v2;
    }
    __syncwarp();
    for (int e = lane; e < 32 * wd; e += 32) {
      const int p = e / wd, off = e - p * wd;
      const int r = p / kRectW, c = p - r * kRectW;
      if (r < rows_live && c < cols_live) out[(rect_base + static_cast<size_t>(r) * W + c) * wd + off] = buf[p * wd + off];
    }
    __syncwarp();
  };
  put(reinterpret_cast<float*>(out_idx), 1, __int_as_float(best_id), 0.0f, 0.0f);
  put(out_z, 1, z, 0.0f, 0.0f);
  put(out_bary, 3, b0, b1, b2);"""
PULSAR_BOUNDS = "__global__ void __launch_bounds__(kThreads, KB <= 8 ? 4 : 1)\npulsar_grad_tiles_kernel("


def substitute(text, pairs, what):
    """`text` with each (old, new) of `pairs` replaced; each old must occur once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"raster_study: the package's source has {text.count(old)} of {old!r} ({what})")
        text = text.replace(old, new)
    return text


def fine_variants(parent_text, text):
    """{name: (source text, extra nvcc flags, takes the box growth, bit-exact)}."""
    i = text.index(FINE_STORES_START) if FINE_STORES_START in text else -1
    j = text.find(FINE_STORES_END, i)
    if i < 0 or j < 0:
        raise SystemExit("raster_study: the package's fine kernel has no staged stores to take out")
    return {
        "parent": (parent_text, (), False, True),
        "no_cull": (substitute(text, FINE_NO_CULL, "no_cull"), (), True, True),
        "hoist": (substitute(text, FINE_HOIST, "hoist"), (), True, True),
        "thread_stores": (text[:i] + THREAD_STORES + text[j:], (), True, True),
        "blocks_any": (substitute(text, ((FINE_BOUNDS, FINE_BOUNDS.replace("KB <= 8 ? 3 : 1", "1")),), "bounds"),
                       (), True, True),
        "prec_div_false": (text, ("--prec-div=false",), True, False),
    }


def points_variants(text):
    """{name: source text} of the package's points kernel and its copies."""
    i = text.index(POINTS_STORES_START) if POINTS_STORES_START in text else -1
    j = text.find(POINTS_STORES_END, i)
    if i < 0 or j < 0:
        raise SystemExit("raster_study: the package's points kernel has no staged stores to take out")
    bounds = lambda b: substitute(text, ((POINTS_BOUNDS, POINTS_BOUNDS.replace("(kThreads)", b)),), "bounds")  # noqa: E731
    return {
        "package": text,
        "no_cull": substitute(text, POINTS_NO_CULL, "no_cull"),
        "lane_box": substitute(text, POINTS_LANE_BOX, "lane_box"),
        "walk2": substitute(text, POINTS_WALK2, "walk2"),
        "thread_stores": text[:i] + POINTS_THREAD_STORES + text[j:],
        "wide_buckets": substitute(text, POINTS_WIDE_BUCKETS, "wide_buckets"),
        "buckets_6_12": substitute(text, POINTS_BUCKETS_6_12, "buckets_6_12"),
        "blocks3": bounds("(kThreads, KB <= 16 ? 3 : 1)"),
        "blocks4": bounds("(kThreads, KB <= 16 ? 4 : 1)"),
        "double_buffer": substitute(text, POINTS_DOUBLE_BUFFER, "double_buffer"),
    }


def points_grad_variants(text):
    """{name: (source text, bit-exact with the package)} of the package's
    points backward and its copies."""
    i = text.index(PGRAD_SORT_START) if PGRAD_SORT_START in text else -1
    j = text.find(PGRAD_SORT_END, i)
    if i < 0 or j < 0:
        raise SystemExit("raster_study: the package's points backward has no warp sort to take out")
    sub = lambda pairs, what: substitute(text, pairs, what)  # noqa: E731
    splits = lambda n: (("constexpr int kSplits = 3;", f"constexpr int kSplits = {n};"),)  # noqa: E731
    chunk = lambda n: (("constexpr int kListChunk = 256;", f"constexpr int kListChunk = {n};"),)  # noqa: E731
    return {
        "package": (text, True),
        "splits1": (sub(splits(1), "splits1"), True),
        "splits6": (sub(splits(6), "splits6"), True),
        "chunk128": (sub(chunk(128) + splits(6), "chunk128"), False),
        "loads8": (sub((("constexpr int kLoads = 4;", "constexpr int kLoads = 8;"),
                        ("constexpr int kQueue = 256;", "constexpr int kQueue = 512;")), "loads8"), True),
        "shared_atomic": (text[:i] + PGRAD_SHARED_ATOMIC + text[j:], False),
    }


def build_all(kernel, sources):
    """{name: (library, nvcc output)} of {name: (text, extra flags)}, one nvcc each, all at once."""
    from pytorch3d_tpu_torch import _build

    with ThreadPoolExecutor(len(sources)) as pool:
        done = pool.map(lambda kv: _build.build_copy(kernel, kv[0], kv[1][0], OUT, kv[1][1]), sources.items())
        return dict(zip(sources, done))


def fine_settings(cs, device):
    """[(label, fv, valid, size, blur, K, persp, clip, cull)]: the fine-kernel
    phase's five and the render-fit step's shape."""
    import torch

    from pytorch3d_tpu_torch.utils import ico_sphere

    batch = cs.main_path_meshes(device)
    ico4 = ico_sphere(4, device=device)
    square, wide = (cs.IMAGE, cs.IMAGE), (cs.IMAGE * 3 // 4, cs.IMAGE)
    cams = cs.camera(30.0, device)
    out = []
    for label, meshes, size, blur, k, persp, clip, cull in (
        ("main path batch", batch, square, cs.BLUR, cs.K, True, True, False),
        ("headline ico4", ico4, square, cs.BLUR, cs.K, True, True, False),
        ("K=1 blur 0", ico4, square, 0.0, 1, True, False, False),
        ("cull_backfaces", ico4, square, cs.BLUR, cs.K, True, True, True),
        ("non-square 384x512", ico4, wide, cs.BLUR, cs.K, True, True, False),
    ):
        c = cams if size[0] == size[1] else cs.camera(30.0, device, aspect_ratio=size[1] / size[0])
        out.append((label, *cs.face_inputs(meshes, c, size), size, blur, k, persp, clip, cull))
    fit = cs.RenderFit(device)
    with torch.no_grad():
        fv, valid = cs.face_inputs(fit.mesh().extend(cs.FIT_VIEWS), fit.soft_renderer(cs.FIT_VIEWS)[1], square)
    out.append(("render-fit", fv, valid, square, cs.FIT_BLUR, cs.FIT_K, True, True, False))
    return out


def study_fine(cs, device, source):
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls

    parent_text = source.read_text()
    if "box_grow" in parent_text:
        raise SystemExit("raster_study: the source takes the box growth: not the design without the cull")
    sources = fine_variants(parent_text, (CSRC / "rasterize_fine.cu").read_text())
    built = build_all("rasterize_fine", {name: v[:2] for name, v in sources.items()})
    libs = {"package": (rc._library(), True, True)}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (lib, log) in built.items():
        grow = sources[name][2]
        lib.rasterize_fine.argtypes = [p] * 5 + [i] * 6 + [f] * (2 if grow else 1) + [i] * 3 + [p] * 5
        lib.rasterize_fine.restype = ctypes.c_int
        libs[name] = (lib, grow, sources[name][3])
        for kernel, figures in cs.ptxas_figures(log).items():
            if "ILi8ELb0E" in kernel or "ILi16ELb0E" in kernel:  # the K buckets of the timed shapes
                print(f"ptxas {name}: {kernel}: {figures}", flush=True)

    def runner(lib, grow_arg, fv, bins, size, blur, k, persp, clip):
        tile_faces, tile_start, n_ty, n_tx = bins
        N, F = fv.shape[:2]
        H, W = size
        ys, xs = rc.pixel_grid_ndc(H, W, device)
        outs = (torch.empty((N, H, W, k), dtype=torch.int32, device=device),
                torch.empty((N, H, W, k), device=device), torch.empty((N, H, W, k, 3), device=device),
                torch.empty((N, H, W, k), device=device))
        grow = (rc.box_grow(size, blur),) if grow_arg else ()

        def run():
            err = lib.rasterize_fine(
                fv.data_ptr(), tile_faces.data_ptr(), tile_start.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                N, F, H, W, n_ty, n_tx, float(blur), *grow, k, int(persp), int(clip),
                *(t.data_ptr() for t in outs), torch.cuda.current_stream().cuda_stream,
            )
            assert err == 0, err
            return outs

        return run

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    failed, timed = [], {}
    for label, fv, valid, size, blur, k, persp, clip, cull in fine_settings(cs, device):
        bins = rc.bin_faces(fv, _face_culls(fv, valid, cull), size, blur)
        want = [t.clone() for t in runner(*libs["parent"][:2], fv, bins, size, blur, k, persp, clip)()]
        notes = []
        for name, (lib, grow_arg, exact) in libs.items():
            if name == "parent":
                continue
            got = runner(lib, grow_arg, fv, bins, size, blur, k, persp, clip)()
            torch.cuda.synchronize()
            same = [torch.equal(bits(g), bits(w)) for g, w in zip(got, want)]
            if exact:
                notes.append(f"{name} {'equal' if all(same) else 'DIFFERS ' + str(same)}")
                if not all(same):
                    failed.append((label, name))
            else:
                notes.append(f"{name} ids differ at {int((got[0] != want[0]).sum())} slots")
        made, walked = cs.fine_tests(bins, cs.face_pixel_boxes(fv, size, blur, persp), *fv.shape[:2], size)
        print(f"bits [{label}] N={fv.shape[0]} F={fv.shape[1]} {size[0]}x{size[1]} K={k} blur={blur:g}"
              f" persp={persp} clip={clip} cull={cull}: against the parent's four outputs: {'; '.join(notes)};"
              f" tests: parent {cs.tile_candidates(bins[1], fv.shape[0], bins[2], bins[3], size) / 1e6:.3f} M,"
              f" package {made / 1e6:.3f} M in {walked / 1e6:.3f} M warp lanes", flush=True)
        if label in ("main path batch", "headline ico4", "render-fit"):
            timed[label] = (fv, bins, size, blur, k, persp, clip)
    if failed:
        print(f"raster_study: outputs differ from the parent's: {failed}", file=sys.stderr)
        return 1

    order = ["parent", "package", *[n for n in libs if n not in ("parent", "package")], "package", "parent"]
    for label, (fv, bins, size, blur, k, persp, clip) in timed.items():
        kernel = f"rasterize_fine_kernel<{cs.fine_bucket(k)}, false>"
        times = []
        for name in order:
            lib, grow_arg, _ = libs[name]
            ms = cs.device_ms(runner(lib, grow_arg, fv, bins, size, blur, k, persp, clip), kernel)
            times.append(f"{name} {ms:.4f}")
        print(f"times [{label}] device ms: {', '.join(times)}", flush=True)
    return 0


def study_pulsar(cs, device, source):
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc
    from pytorch3d_tpu_torch.renderer.points.pulsar.renderer import _blend_core

    kernels = ("pulsar_grad_tiles_kernel", "pulsar_grad_combine_kernel")
    text = source.read_text()
    if "flagged" in text:
        raise SystemExit("raster_study: the source takes the flag array: not the earlier design")
    package_text = (CSRC / "pulsar_grad.cu").read_text()
    bounds = lambda b: substitute(package_text, ((PULSAR_BOUNDS, PULSAR_BOUNDS.replace("KB <= 8 ? 4 : 1", b)),),  # noqa: E731
                                  "bounds")
    sources = {
        "parent": (text, ()),
        "package": (package_text, ()),  # built for its ptxas figures; the runs use the package's own build
        "blocks_any": (bounds("1"), ()),
        "blocks3": (bounds("KB <= 8 ? 3 : 1"), ()),
    }
    package = rpc._pulsar_grad_library()
    libs = {}
    for name, (lib, log) in build_all("pulsar_grad", sources).items():
        for kernel, figures in cs.ptxas_figures(log).items():
            if "tiles_kernelILi8E" in kernel:  # the K bucket of both cases
                print(f"ptxas {name}: {kernel}: {figures}", flush=True)
        lib.pulsar_grad.argtypes = package.pulsar_grad.argtypes
        lib.pulsar_grad.restype = ctypes.c_int
        libs[name] = lib
    parent = libs.pop("parent")
    del libs["package"]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent.pulsar_grad.argtypes = [p] * 12 + [i] * 8 + [f] * 4 + [p] * 3

    cases = [("pulsar-fit step 0", *cs.PulsarFit(device).blend_inputs())]
    big, big_ren = cs.pulsar_scene(device, cs.PULSAR_BIG), cs.pulsar_renderer(cs.PULSAR_BIG)
    with torch.no_grad():
        table, idx, bins = big_ren._prepare(big[0], big[1], big[2], cs.pulsar_cam(0.0, device), *cs.PULSAR_DEPTH)
    ct = torch.randn((cs.PULSAR_IMAGE, cs.PULSAR_IMAGE, 3), generator=torch.Generator(device=device).manual_seed(8),
                     device=device)
    cases.append((f"{cs.PULSAR_BIG} spheres, random cotangent", table.contiguous(), idx, bins, ct))

    args_ = (cs.PULSAR_GAMMA, *cs.PULSAR_DEPTH)
    library = rpc._pulsar_grad_library
    for label, t, ids, b, ct in cases:
        size = ids.shape[:2]
        H, W = size
        bg = torch.ones(3, device=device)
        with torch.no_grad():
            _, denom, lm, _, _ = _blend_core(t, ids, bg, *args_, 0.0, *size)
        tile_points, tile_start, n_ty, n_tx, slot_rows, sphere_start = b
        P, F = t.shape
        gslot = torch.empty((max(tile_points.numel(), 1), F), device=device)
        old = torch.empty((P, F), device=device)
        ys, xs = rpc.pulsar_pixel_grid(H, W, torch.float32, device)

        def run_parent():
            err = parent.pulsar_grad(
                t.data_ptr(), tile_points.data_ptr(), tile_start.data_ptr(), ids.data_ptr(), ct.data_ptr(),
                bg.data_ptr(), denom.data_ptr(), lm.data_ptr(), xs.data_ptr(), ys.data_ptr(), slot_rows.data_ptr(),
                sphere_start.data_ptr(), P, F - 5, H, W, n_ty, n_tx, ids.shape[2], tile_points.numel(),
                1.0 / cs.PULSAR_GAMMA, float(cs.PULSAR_DEPTH[0]), 1.0 / (cs.PULSAR_DEPTH[1] - cs.PULSAR_DEPTH[0]),
                0.0, gslot.data_ptr(), old.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
            assert err == 0, err

        def run_package(lib=package):
            rpc._pulsar_grad_library = lambda: lib
            try:
                return rpc.pulsar_blend_grads_cuda(t, ids, ct, denom, lm, bg, size, *args_, 0.0, b)
            finally:
                rpc._pulsar_grad_library = library

        run_parent()
        a, a2 = run_package(), run_package()
        copies = {name: torch.equal(run_package(lib).view(torch.int32), a.view(torch.int32))
                  for name, lib in libs.items()}
        torch.cuda.synchronize()
        scale = old.abs().amax(dim=0).clamp(min=1e-30)
        ratio = (a - old).abs().amax(dim=0) / scale
        same = torch.equal(a.view(torch.int32), a2.view(torch.int32))
        passes = cs.device_ms_by_kernel(run_package, kernels, iters=10)
        runs = [("parent", run_parent), ("package", run_package),
                *((name, lambda lib=lib: run_package(lib)) for name, lib in libs.items()),
                ("package", run_package), ("parent", run_parent)]
        times = [(name, cs.device_ms(fn, kernels, iters=10)) for name, fn in runs]
        print(f"[{label}] P={P} {H}x{W} K={ids.shape[2]} hits {int((ids >= 0).sum())} pairs {tile_points.numel()}"
              f" longest list {int(tile_start.diff().max())}: package vs parent per field (of the field's"
              f" max|grad|) {[float(f'{r:.3e}') for r in ratio]}; package twice bit-equal {same}, finite"
              f" {bool(torch.isfinite(a).all())}; copies bit-equal to the package {copies}; package by pass"
              f" {', '.join(f'{k} {v:.4f}' for k, v in passes.items())}; device ms:"
              f" {', '.join(f'{n} {ms:.4f}' for n, ms in times)}", flush=True)
    return 0


def points_settings(cs, device):
    """([(label, points, radius, valid, size, K, ids only)] checked bit for
    bit, {label: index into it} of the timed ones): #5 at
    `points_kernel_cases` and 10^6 points, #6 at `select_kernel_cases`
    and 10^6 spheres (clouds of one, (1, P, 3))."""
    out = [(label, pts, rad, valid, size, k, False) for label, pts, rad, valid, size, k in cs.points_kernel_cases(device)]
    big_label = f"{cs.BIG_POINTS} points at {cs.BIG_IMAGE}^2"
    big = cs.bench_points(device, cs.BIG_POINTS)
    out.append((big_label, big, *cs.uniform_radius(big, cs.BIG_RADIUS),
                (cs.BIG_IMAGE, cs.BIG_IMAGE), cs.BENCH_K, False))
    serving = cs.PulsarServing(device)
    selects = [(f"#6 {label}", p[None], r[None], v[None], size) for label, p, r, v, size in
               cs.select_kernel_cases(device, serving)]
    pos, _, rad = cs.pulsar_scene(device, cs.PULSAR_BIG)
    p, r, v = cs.pulsar_renderer(cs.PULSAR_BIG)._project_ndc(pos, rad, cs.pulsar_cam(0.0, device), *cs.PULSAR_DEPTH)
    selects.append((f"#6 {cs.PULSAR_BIG} spheres at {cs.PULSAR_IMAGE}^2", p.contiguous()[None], r.contiguous()[None],
                    v[None], (cs.PULSAR_IMAGE, cs.PULSAR_IMAGE)))
    out += [(*case, cs.PULSAR_TRACK, True) for case in selects]
    labels = [case[0] for case in out]
    timed = {name: labels.index(label) for name, label in (
        ("points-serving batch", "points-serving batch"), ("points-bench", "points-bench"),
        (f"{cs.BIG_POINTS} points", big_label),
        ("pulsar-serving request 0", selects[0][0]), (f"{cs.PULSAR_BIG} spheres", selects[-1][0]))}
    return out, timed


def study_points(cs, device, source):
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc

    parent_text = source.read_text()
    if "axis_bits" in parent_text:
        raise SystemExit("raster_study: the source has the pixel-box cull: not the design without it")
    sources = {"parent": parent_text, **points_variants((CSRC / "rasterize_points.cu").read_text())}
    built = build_all("rasterize_points", {name: (text, ()) for name, text in sources.items()})
    package = rpc._library()
    libs = {}
    for name, (lib, log) in built.items():
        for kernel, figures in cs.ptxas_figures(log).items():
            if any(f"ILi{b}ELb" in kernel for b in (5, 6, 8, 10, 12, 16)):  # the K buckets of the timed shapes
                print(f"ptxas {name}: {kernel}: {figures}", flush=True)
        for fn in ("rasterize_points", "select_points"):
            getattr(lib, fn).argtypes = getattr(package, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    libs["package"] = package  # the runs use the package's own build

    def runner(lib, pts, rad, bins, size, k, ids_only):
        tile_points, tile_start, n_ty, n_tx = bins[:4]
        N, P = pts.shape[:2]
        H, W = size
        ys, xs = rpc.pixel_grid_ndc(H, W, device)
        outs = tuple(torch.empty((N, H, W, k), dtype=dt, device=device)
                     for dt in ((torch.int32,) if ids_only else (torch.int32, torch.float32, torch.float32)))
        args = (pts.data_ptr(), rad.data_ptr(), tile_points.data_ptr(), tile_start.data_ptr(), xs.data_ptr(),
                ys.data_ptr(), N, P, H, W, n_ty, n_tx, k, *(t.data_ptr() for t in outs))

        def run():
            fn = lib.select_points if ids_only else lib.rasterize_points
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return outs

        return run

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    cases, timed = points_settings(cs, device)
    failed, inputs = [], []
    for label, pts, rad, valid, size, k, ids_only in cases:
        bins = rpc.bin_points(pts, rad, valid, size)
        inputs.append((pts, rad, bins, size, k, ids_only))
        want = [t.clone() for t in runner(libs["parent"], *inputs[-1])()]
        notes = []
        for name, lib in libs.items():
            if name == "parent":
                continue
            got = runner(lib, *inputs[-1])()
            torch.cuda.synchronize()
            same = all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
            notes.append(f"{name} {'equal' if same else 'DIFFERS'}")
            if not same:
                failed.append((label, name))
        made, walked = cs.points_tests(pts, rad, bins, size)
        print(f"bits [{label}] N={pts.shape[0]} P={pts.shape[1]} {size[0]}x{size[1]} K={k}"
              f" {'ids only' if ids_only else 'ids, zbuf, dists'}, filled {int((want[0] >= 0).sum())}: against the"
              f" parent: {'; '.join(notes)}; tests: parent"
              f" {cs.tile_candidates(bins[1], pts.shape[0], bins[2], bins[3], size) / 1e6:.3f} M, package"
              f" {walked / 1e6:.3f} M lanes walked, {made / 1e6:.3f} M of them in the points' boxes", flush=True)
    if failed:
        print(f"raster_study: outputs differ from the parent's: {failed}", file=sys.stderr)
        return 1

    order = ["parent", "package", *[n for n in libs if n not in ("parent", "package")], "package", "parent"]
    for label, i in timed.items():
        times = [f"{name} {cs.device_ms(runner(libs[name], *inputs[i]), 'rasterize_points_kernel'):.4f}"
                 for name in order]
        print(f"times [{label}] K={inputs[i][4]} device ms: {', '.join(times)}", flush=True)
    return 0


def hard_settings(cs, device):
    """[(label, fv, valid, size)] of `hard`: the serving batch at the 8
    azimuths, the cull's edge cases and faces crossing z = 0."""
    square, edge = (cs.IMAGE, cs.IMAGE), cs.CULL_EDGE_IMAGE
    meshes = cs.main_path_meshes(device)
    out = [(f"serving batch, azim {a:.0f}", *cs.face_inputs(meshes, cs.camera(a, device), square), square)
           for a in cs.AZIMUTHS]
    for size in (edge, square):
        out.append((f"cull edges {size[0]}x{size[1]}", *cs.hard_cull_edge_batch(device, size), size))
        out.append((f"faces crossing z = 0, {size[0]}x{size[1]}", *cs.crossing_strip_faces(device, size), size))
    return out


def study_hard(cs, device, source):
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls

    parent_text = source.read_text()
    if "box_grow" in parent_text:
        raise SystemExit("raster_study: the source takes the box growth: not the design without the cull")
    text = (CSRC / "rasterize_hard.cu").read_text()
    i = text.index(HARD_STORES_START) if HARD_STORES_START in text else -1
    j = text.find(HARD_STORES_END, i)
    if i < 0 or j < 0:
        raise SystemExit("raster_study: the package's hard kernel has no thread stores to replace")
    sources = {"parent": (parent_text, ()), "package": (text, ()),
               "shared_stores": (text[:i] + HARD_SHARED_STORES + text[j:], ())}
    built = build_all("rasterize_hard", sources)
    for name, (_, log) in built.items():
        for kernel, figures in cs.ptxas_figures(log).items():
            print(f"ptxas {name}: {kernel}: {figures}", flush=True)
    parent = built["parent"][0]
    p, i = ctypes.c_void_p, ctypes.c_int
    parent.rasterize_hard.argtypes = [p] * 5 + [i] * 6 + [p] * 4
    parent.rasterize_hard.restype = ctypes.c_int
    copy = built["shared_stores"][0]
    copy.rasterize_hard.argtypes = rc._hard_library().rasterize_hard.argtypes
    copy.rasterize_hard.restype = ctypes.c_int
    library = rc._hard_library

    def run_copy(fv, valid, size):
        rc._hard_library = lambda: copy
        try:
            return rc.rasterize_hard_cuda(fv, valid, size)
        finally:
            rc._hard_library = library

    def outputs(N, H, W):
        return (torch.empty((N, H, W, 1), dtype=torch.int32, device=device),
                torch.empty((N, H, W, 1), device=device), torch.empty((N, H, W, 1, 3), device=device))

    def run_parent(fv, bins, size):
        tile_faces, tile_start, n_ty, n_tx = bins
        N, F = fv.shape[:2]
        H, W = size
        ys, xs = rc.pixel_grid_ndc(H, W, device)
        outs = outputs(N, H, W)

        def run():
            err = parent.rasterize_hard(
                fv.data_ptr(), tile_faces.data_ptr(), tile_start.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                N, F, H, W, n_ty, n_tx, *(t.data_ptr() for t in outs), torch.cuda.current_stream().cuda_stream,
            )
            assert err == 0, err
            return outs

        return run

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    failed, timed = [], {}
    for label, fv, valid, size in hard_settings(cs, device):
        bins = rc.bin_faces(fv, _face_culls(fv, valid, False), size, 0.0)
        want = [t.clone() for t in run_parent(fv, bins, size)()]
        got = rc.rasterize_hard_cuda(fv, valid, size)
        other = run_copy(fv, valid, size)
        torch.cuda.synchronize()
        same = [torch.equal(bits(g), bits(w)) for g, w in zip(got, want)]
        same_copy = all(torch.equal(bits(g), bits(w)) for g, w in zip(other, want))
        if not (all(same) and same_copy):
            failed.append(label)
        plain = rc.rasterize_hard_plain(fv, valid, size)[0]
        made, walked = cs.hard_tests(fv, valid, size)
        print(f"bits [{label}] N={fv.shape[0]} F={fv.shape[1]} {size[0]}x{size[1]}: package against the parent's"
              f" ids, z, bary {'equal' if all(same) else 'DIFFER ' + str(same)}, shared_stores"
              f" {'equal' if same_copy else 'DIFFERS'}; ids equal to the plain version's"
              f" {float((got[0].long() == plain).float().mean()):.6f}, covered px {int((want[0] >= 0).sum())};"
              f" tests: parent {cs.tile_candidates(bins[1], fv.shape[0], bins[2], bins[3], size) / 1e6:.3f} M,"
              f" package {made / 1e6:.3f} M in {walked / 1e6:.3f} M warp lanes", flush=True)
        if label in ("serving batch, azim 30", "serving batch, azim 165"):
            timed[label] = (fv, valid, bins, size)
    if failed:
        print(f"raster_study: outputs differ from the parent's: {failed}", file=sys.stderr)
        return 1
    for label, (fv, valid, bins, size) in timed.items():
        runs = {"parent": run_parent(fv, bins, size), "package": lambda: rc.rasterize_hard_cuda(fv, valid, size),
                "shared_stores": lambda: run_copy(fv, valid, size)}
        times = [f"{name} {cs.device_ms(runs[name], 'rasterize_hard_kernel'):.4f}"
                 for name in ("parent", "package", "shared_stores", "package", "parent")]
        print(f"times [{label}] device ms: {', '.join(times)}", flush=True)
    return 0


def study_points_grad(cs, device, source):
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import face_pair_rows

    parent_text = source.read_text()
    if "tile_points" in parent_text:
        raise SystemExit("raster_study: the source takes the binning: not the design with atomic adds")
    variants = points_grad_variants((CSRC / "rasterize_points_grad.cu").read_text())
    sources = {"parent": (parent_text, ()), **{name: (text, ()) for name, (text, _) in variants.items()}}
    built = build_all("rasterize_points_grad", sources)
    for name, (_, log) in built.items():
        for kernel, figures in cs.ptxas_figures(log).items():
            print(f"ptxas {name}: {kernel}: {figures}", flush=True)
    parent = built.pop("parent")[0]
    p, i = ctypes.c_void_p, ctypes.c_int
    parent.rasterize_points_grad.argtypes = [p] * 6 + [i] * 5 + [p] * 2
    parent.rasterize_points_grad.restype = ctypes.c_int
    package = rpc._grad_library()
    copies = {}
    for name, (lib, _) in built.items():
        if name != "package":
            lib.rasterize_points_grad.argtypes = package.rasterize_points_grad.argtypes
            lib.rasterize_points_grad.restype = ctypes.c_int
            copies[name] = lib
    library = rpc._grad_library

    size = (cs.PTS_IMAGE, cs.PTS_IMAGE)
    cases = [("points-fit step 0", *cs.PointsFit(device).cotangents())]
    bench = cs.bench_points(device)
    rad, valid = cs.uniform_radius(bench, cs.BENCH_RADIUS)
    idx, _, _ = rpc.rasterize_points_cuda(bench, rad, valid, size, cs.BENCH_K)
    filled = (idx >= 0).float()
    cases.append(("points-bench", bench, idx, (filled, filled), rpc.bin_points(bench, rad, valid, size)))
    served = cs.served_points_ndc(device)
    rad, valid = cs.uniform_radius(served, cs.PTS_RADIUS)
    idx, zbuf, _ = rpc.rasterize_points_cuda(served, rad, valid, size, cs.PTS_K)
    gen = torch.Generator(device=device).manual_seed(3)
    cots = tuple(torch.randn(zbuf.shape, generator=gen, device=device) for _ in range(2))
    cases.append(("points-serving batch, random cotangents", served, idx, cots, rpc.bin_points(served, rad, valid, size)))

    for label, pts, idx, cots, bins in cases:
        N, P = pts.shape[:2]
        H, W = size
        ys, xs = rpc.pixel_grid_ndc(H, W, device)

        def run_parent():
            grad = torch.zeros((N, P, 3), device=device)
            err = parent.rasterize_points_grad(
                pts.data_ptr(), idx.data_ptr(), *(None if c is None else c.data_ptr() for c in cots),
                xs.data_ptr(), ys.data_ptr(), N, P, H, W, idx.shape[3], grad.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
            assert err == 0, err
            return grad

        def run_package(lib=None):
            if lib is not None:
                rpc._grad_library = lambda: lib
            try:
                return rpc.rasterize_points_grad_cuda(pts, idx, *cots, size, bins)
            finally:
                rpc._grad_library = library

        old, old2 = run_parent(), run_parent()
        a, a2 = run_package(), run_package()
        torch.cuda.synchronize()
        scale = old.abs().max().clamp(min=1e-30)
        same = torch.equal(a.view(torch.int32), a2.view(torch.int32))
        same_parent = torch.equal(old.view(torch.int32), old2.view(torch.int32))
        ratio = float((a - old).abs().max() / scale)
        notes, failed = [], []
        for name, lib in copies.items():
            b = run_package(lib)
            torch.cuda.synchronize()
            if torch.equal(b.view(torch.int32), a.view(torch.int32)):
                notes.append(f"{name} equal")
            else:
                notes.append(f"{name} off by {float((b - a).abs().max() / scale):.3e}")
                if variants[name][1]:
                    failed.append(name)
        longest, passes = cs.longest_list(bins, cs.POINTS_GRAD_LIST_CHUNK)
        print(f"[{label}] N={N} P={P} K={idx.shape[3]} filled {int((idx >= 0).sum())} pairs {bins[0].numel()}"
              f" longest list {longest} ({passes} pass(es)): package vs parent max|diff| {ratio:.3e} of max|grad|;"
              f" package twice bit-equal {same}, finite {bool(torch.isfinite(a).all())}; parent twice bit-equal"
              f" {same_parent}; copies against the package: {'; '.join(notes)}", flush=True)
        if failed or not (same and bool(torch.isfinite(a).all())):
            print(f"raster_study: the package's gradient is not deterministic or not finite, or copies {failed}"
                  f" differ, at {label}", file=sys.stderr)
            return 1
        times = []
        for name in ("parent", "package", *copies, "package", "parent"):
            if name == "parent":
                kernel = cs.device_ms(run_parent, "rasterize_points_grad_kernel")
                times.append(f"parent {kernel:.4f} (call {cs.call_device_ms(run_parent):.4f})")
            else:
                fn = (lambda lib=copies.get(name): run_package(lib))
                by = cs.device_ms_by_kernel(fn, cs.POINTS_GRAD_KERNELS)
                call = f"; call {cs.call_device_ms(fn):.4f}" if name == "package" else ""
                times.append(f"{name} {sum(by.values()):.4f} (passes {' + '.join(f'{v:.4f}' for v in by.values())}"
                             f"{call})")
        csr = cs.call_device_ms(lambda: face_pair_rows(bins[0], bins[1], N, P))
        print(f"times [{label}] device ms: {', '.join(times)}; pair CSR alone {csr:.4f}", flush=True)
    return 0


def study_e2e(cs, device, tree, reps, names):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    meshes = cs.main_path_meshes(device)
    renderers = [cs.renderer(cs.camera(a, device), device) for a in cs.AZIMUTHS]
    gl_renderers = [cs.gl_renderer(cs.camera(a, device), device) for a in cs.AZIMUTHS]
    fit, serving, pfit = cs.RenderFit(device), cs.PulsarServing(device), cs.PulsarFit(device)
    from pytorch3d_tpu_torch.renderer import AlphaCompositor

    cloud, cams = cs.colored_points_scene(device)
    clouds, points_render, points_fit = cloud.extend(cs.PTS_REQUESTS), cs.points_renderer(cams, AlphaCompositor()), \
        cs.PointsFit(device)

    def step(f):
        f.optimizer.zero_grad()
        f.forward().backward()
        f.optimizer.step()

    paths = {
        "serving frame": lambda i: renderers[i % len(renderers)](meshes),
        "render-fit step": lambda i: step(fit),
        "pulsar-serving request": lambda i: cs.pulsar_render(
            serving.renderer, serving.scene, cs.PULSAR_YAWS[i % len(cs.PULSAR_YAWS)], device),
        "pulsar-fit step": lambda i: step(pfit),
        "points-serving frame": lambda i: points_render(clouds),
        "points-fit step": lambda i: step(points_fit),
        "mesh-gl frame": lambda i: gl_renderers[i % len(gl_renderers)](meshes),
    }
    out = {"tree": tree}
    for name in names:
        fn = paths[name]
        with torch.set_grad_enabled(name.endswith("step")):
            for i in range(3):  # warm-up
                fn(i)
            ms = [cs.timed_ms(lambda: fn(i))[1] for i in range(reps)]
        out[name] = {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms)}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="study", required=True)
    sub.add_parser("fine").add_argument("--source", type=Path, required=True,
                                        help="a rasterize_fine.cu without the box growth")
    sub.add_parser("pulsar").add_argument("--source", type=Path, required=True,
                                          help="a pulsar_grad.cu without the flag array")
    sub.add_parser("points").add_argument("--source", type=Path, required=True,
                                          help="a rasterize_points.cu without the pixel-box cull")
    sub.add_parser("hard").add_argument("--source", type=Path, required=True,
                                        help="a rasterize_hard.cu without the box growth")
    sub.add_parser("points-grad").add_argument("--source", type=Path, required=True,
                                               help="a rasterize_points_grad.cu with atomic adds")
    e2e = sub.add_parser("e2e")
    e2e.add_argument("--tree", default=str(REPO))
    e2e.add_argument("--reps", type=int, default=16)
    e2e.add_argument("--paths", nargs="+", choices=E2E_PATHS, default=list(E2E_PATHS))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("raster_study: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() if args.study == "e2e" else REPO))
    import chip_smoke as cs

    device = torch.device("cuda")
    if args.study == "e2e":
        return study_e2e(cs, device, args.tree, args.reps, args.paths)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    studies = {"fine": study_fine, "pulsar": study_pulsar, "points": study_points, "hard": study_hard,
               "points-grad": study_points_grad}
    return studies[args.study](cs, device, args.source)


if __name__ == "__main__":
    sys.exit(main())
