#!/usr/bin/env python3
"""Time variants of the mesh rasterizer's backward (#4) at the
textured-mesh fit's shape, on one CUDA card.

    python3 grad_study.py --source FILE
    python3 grad_study.py --breakdown
    python3 grad_study.py --sync
    python3 grad_study.py --conditioning

`--source FILE`: FILE is a `rasterize_grad.cu` of the atomic design: one
thread per (pixel, slot), a warp at one slot depth, per-face shuffle sums,
9 fp32 atomics per (warp, face) into the gradient.  The one at commit
fde8c76 is such a file (`git show
fde8c76:pytorch3d_tpu_torch/csrc/rasterize_grad.cu`).  The script builds
FILE and three variants of it, each with one change:

- (a) the atomics replaced by plain stores of the same sums into a
  per-slot scratch (the leader lane's slot row): the atomics' cost;
- (b) thread t takes slot t, so a thread's pixel's K slots are adjacent
  and a warp's reads are contiguous (its lanes then hold different faces);
- (c) the same source built with `--prec-div=false`: approximate divisions.

`--breakdown`: copies of the package's own kernel, each with one part
taken out or one setting changed (timing only: the copies that leave out
a part give wrong sums): no `slot_grad` (its loads kept), no sort and
scan (a racy direct add instead), neither, 2 or 8 slot depths loaded at
once instead of 4, and `__launch_bounds__` of 2 or 4 blocks an SM
instead of 3; each beside the package's kernel, before and after.

`--sync`: the render-fit step (`chip_smoke.RenderFit`) with the
backward's error-flag read (`rasterize_cuda._raise_on_missing`, its one
host sync) and with that read left out, step by step in turn: what the
sync costs a training step.

`--conditioning`: ico_sphere(4) at 128^2, K=16, blur 2e-2 (tile lists
up to ~1000 faces), under each setting of perspective correction and
clipping, and chip_smoke.py's long-list cases: per face, against the
float64 plain version, the package's kernel, the kernel on a binning
that lists every face in every tile (its lists cut into passes at other
faces), the float32 plain version and the float32 plain version's own
per-slot partials summed in float64.  The kernel's two binnings differ
only in the order of the sum; the last column splits the float32 plain
version's error into its per-slot rounding and its sum.

Copies are built into `build/grad_study/` and timed by the profiler's
device time (`chip_smoke.device_ms`) on the render-fit step's own ids and
cotangents (`chip_smoke.RenderFit`: 8 views of ico_sphere(4) at 512^2,
K=16) and, for `--breakdown`, the headline loss's; `--source`'s FILE,
(b) and (c) are compared with the float64 plain version as
`chip_smoke.compare_grad` does.  None of the copies is package code.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "grad_study"

ATOMIC = "if (lane == leader) atomicAdd(grad + face * 9 + c, sum);"
STORE = "if (lane == leader) grad[(((warp / K) * 32 + leader) * K + k) * 9 + c] = sum;"
MAP_DEPTH = "  const int k = static_cast<int>(warp % K);\n  const long long pix = (warp / K) * 32 + lane;\n"
MAP_SLOT = "  const int k = static_cast<int>(t % K);\n  const long long pix = t / K;\n"


def variants(text):
    """{name: (source text, extra nvcc flags)}."""
    for needle in (ATOMIC, MAP_DEPTH):
        if needle not in text:
            raise SystemExit(f"grad_study: the source has no {needle!r}: not the atomic design")
    return {
        "parent": (text, ()),
        "a_stores": (text.replace(ATOMIC, STORE), ()),
        "b_slot_major": (text.replace(MAP_DEPTH, MAP_SLOT), ()),
        "c_prec_div_false": (text, ("--prec-div=false",)),
    }


GRAD_CALL = """          slot_grad(verts + static_cast<long long>(f) * 9, xs[col0 + (l & 15)], ys[row0 + (l >> 4)],
                    c.z, c.b0, c.b1, c.b2, c.d, perspective_correct, clip_barycentric_coords, g);"""
GRAD_LOADS = ("          g[0] = c.z + verts[static_cast<long long>(f) * 9]; g[1] = c.b0; g[2] = c.b1; g[3] = c.b2;"
              " g[4] = c.d + xs[col0 + (l & 15)] + ys[row0 + (l >> 4)];")
SORT_START = "    // Bitonic sort of the keys (pos, lane) across the warp, ascending;"
SORT_END = "    __syncwarp();\n  };"
DIRECT_ADD = "    if (pos >= 0) {\n      for (int c = 0; c < 9; ++c) acc[pos * 9 + c] += g[c];\n    }\n"
BOUNDS = "__global__ void __launch_bounds__(kThreads, 3)\nrasterize_grad_tiles_kernel("


def breakdown_variants(text):
    """{name: (source text, extra nvcc flags)} of the package's kernel."""
    for needle in (GRAD_CALL, SORT_START, SORT_END, BOUNDS, "constexpr int kDepths = 4;"):
        if needle not in text:
            raise SystemExit(f"grad_study: the package's kernel has no {needle!r}")
    i, j = text.index(SORT_START), text.index(SORT_END)
    no_sort = text[:i] + DIRECT_ADD + text[j:]
    depths8 = (text.replace("constexpr int kDepths = 4;", "constexpr int kDepths = 8;")
               .replace("constexpr int kQueue = 256;", "constexpr int kQueue = 512;")
               .replace("constexpr int kListChunk = 128;", "constexpr int kListChunk = 96;"))  # 48 KB of shared memory
    return {
        "no_slot_grad": (text.replace(GRAD_CALL, GRAD_LOADS), ()),
        "no_sort_scan": (no_sort, ()),
        "neither": (no_sort.replace(GRAD_CALL, GRAD_LOADS), ()),
        "depths2": (text.replace("constexpr int kDepths = 4;", "constexpr int kDepths = 2;"), ()),
        "depths8": (depths8, ()),
        "blocks2": (text.replace(BOUNDS, BOUNDS.replace("kThreads, 3", "kThreads, 2")), ()),
        "blocks4": (text.replace(BOUNDS, BOUNDS.replace("kThreads, 3", "kThreads, 4")), ()),
    }


def build(name, text, extra):
    from pytorch3d_tpu_torch import _build

    return _build.build_copy("rasterize_grad", name, text, OUT, extra)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--source", type=Path, help="a rasterize_grad.cu of the atomic design")
    mode.add_argument("--breakdown", action="store_true", help="copies of the package's kernel")
    mode.add_argument("--sync", action="store_true", help="the render-fit step with and without the flag read")
    mode.add_argument("--conditioning", action="store_true", help="per-face errors at a large blur")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("grad_study: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls, rasterize_grad_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    if args.sync:
        return sync_cost(cs, rc, device)
    if args.conditioning:
        return conditioning(cs, rc, device)
    if args.breakdown:
        sources = breakdown_variants((REPO / "pytorch3d_tpu_torch" / "csrc" / "rasterize_grad.cu").read_text())
    else:
        sources = variants(args.source.read_text())
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per variant, all at once
        built = dict(zip(sources, pool.map(lambda kv: build(kv[0], *kv[1]), sources.items())))
    for name, (_, text) in built.items():
        for kernel, figures in cs.ptxas_figures(text).items():
            print(f"ptxas {name}: {kernel}: {figures}", flush=True)

    if args.breakdown:
        return breakdown(cs, rc, device, built)

    # The render-fit step's ids and cotangents, as chip_smoke.phase_times takes them.
    fit = cs.RenderFit(device)
    size = (cs.IMAGE, cs.IMAGE)
    mesh = fit.mesh().extend(cs.FIT_VIEWS)
    soft, cams = fit.soft_renderer(cs.FIT_VIEWS)
    fragments = soft.rasterizer(mesh, cameras=cams)
    loss = fit.loss(soft.shader(fragments, mesh, cameras=cams), fit.mesh(), cs.FIT_VIEWS)
    cots = torch.autograd.grad(loss, [fragments.zbuf, fragments.bary_coords, fragments.dists])
    fv, valid = cs.face_inputs(mesh, cams, size)
    bins = rc.bin_faces(fv, _face_culls(fv, valid, False), size, cs.FIT_BLUR)  # the forward's binning
    N, F = fv.shape[:2]
    offsets = (torch.arange(N, device=device) * F)[:, None, None, None]
    idx = torch.where(fragments.pix_to_face >= 0, fragments.pix_to_face - offsets, -1).int().contiguous()
    cots = tuple(c.contiguous() for c in cots)
    H, W = size
    K = idx.shape[3]
    ys, xs = rc.pixel_grid_ndc(H, W, device)
    exact = rasterize_grad_plain(fv.double(), idx, *(c.double() for c in cots), size, True, True)
    want = rasterize_grad_plain(fv, idx, *cots, size, True, True)
    print(f"render-fit step: N={N} F={F} {H}x{W} K={K}, filled slots {int((idx >= 0).sum())}", flush=True)

    scratch = torch.empty((N * H * W * K * 9,), dtype=torch.float32, device=device)
    for name, (lib, _) in built.items():
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_grad.argtypes = [p] * 7 + [i] * 7 + [p, p]
        lib.rasterize_grad.restype = ctypes.c_int
        grad = torch.zeros((N, F, 3, 3), dtype=torch.float32, device=device)
        out = scratch if name == "a_stores" else grad

        def run():
            if name != "a_stores":
                grad.zero_()
            err = lib.rasterize_grad(
                fv.data_ptr(), idx.data_ptr(), *(c.data_ptr() for c in cots), xs.data_ptr(), ys.data_ptr(),
                N, F, H, W, K, 1, 1, out.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
            assert err == 0, err

        ms = cs.device_ms(run, "rasterize_grad_kernel")
        note = ""
        if name != "a_stores":
            run()
            torch.cuda.synchronize()
            _, ratio_exact = cs.grad_error(grad.double(), exact)
            _, ratio_plain = cs.grad_error(want.double(), exact)
            share, _ = cs.face_agreement(grad, want, exact)
            note = (f"; vs float64 {ratio_exact:.3e} of max|grad| (float32 plain {ratio_plain:.3e}),"
                    f" faces agreeing {share:.6f}")
        print(f"variant {name}: device time {ms:.4f} ms{note}", flush=True)

    ms = cs.device_ms(lambda: rc.rasterize_grad_cuda(fv, idx, *cots, size, bins, True, True), cs.GRAD_KERNELS)
    print(f"package kernel (rasterize_grad_cuda): device time {ms:.4f} ms", flush=True)
    return 0


def breakdown(cs, rc, device, built):
    """Each copy in the package wrapper's place, at the render-fit and
    headline shapes on the forward's binning (`chip_smoke.grad_path_inputs`),
    between two timings of the package's own kernel."""
    import torch

    size = (cs.IMAGE, cs.IMAGE)
    inputs = cs.grad_path_inputs(device, cs.RenderFit(device))
    package = rc._grad_library()
    libs = [("package", package)]
    for name, (lib, _) in built.items():
        lib.rasterize_grad.argtypes = package.rasterize_grad.argtypes
        lib.rasterize_grad.restype = ctypes.c_int
        libs.append((name, lib))
    libs.append(("package again", package))
    want = {}
    for name, lib in libs:
        rc._grad_library = lambda lib=lib: lib
        for label, fv, idx, c, persp, clip, bins in inputs:
            got = rc.rasterize_grad_cuda(fv, idx, *c, size, bins, persp, clip)
            want.setdefault(label, got)
            st = cs.device_ms_by_kernel(lambda: rc.rasterize_grad_cuda(fv, idx, *c, size, bins, persp, clip),
                                        cs.GRAD_KERNELS)
            print(f"breakdown {name} [{label}]: pass 1 {st[cs.GRAD_KERNELS[0]]:.4f} ms, pass 2"
                  f" {st[cs.GRAD_KERNELS[1]]:.4f} ms, total {sum(st.values()):.4f} ms; bits equal to the"
                  f" package's {torch.equal(got, want[label])}", flush=True)
    rc._grad_library = lambda: package
    return 0



def conditioning(cs, rc, device):
    """Per-face errors against float64 (see the module docstring)."""
    import importlib

    import torch

    rm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")
    cases = [(f"large blur persp={p} clip={c}", 4, 128, 2e-2, 16, p, c) for p in (False, True) for c in (False, True)]
    cases += [(label, *rest) for label, *rest in cs.LONG_LIST_CASES]
    for label, level, side, blur, k, persp, clip in cases:
        fv, idx, cots, bins = cs.ico_grad_inputs(device, level, side, blur, k, persp, clip)
        size = (side, side)
        N, F = fv.shape[:2]
        every = rc.bin_faces(fv, torch.ones((N, F), dtype=torch.bool, device=device), size, 100.0)
        kernel = rc.rasterize_grad_cuda(fv, idx, *cots, size, bins, persp, clip)
        kernel_every = rc.rasterize_grad_cuda(fv, idx, *cots, size, every, persp, clip)
        plain = rm.rasterize_grad_plain(fv, idx, *cots, size, persp, clip)
        exact = rm.rasterize_grad_plain(fv.double(), idx, *(c.double() for c in cots), size, persp, clip)
        # The float32 plain version's per-slot partials, summed in float64.
        ids = idx.long()
        flat = (ids.clamp(min=0) + (torch.arange(N, device=device) * F)[:, None, None, None]).reshape(-1)
        with torch.enable_grad():
            g = fv.reshape(N * F, 3, 3)[flat].reshape(*ids.shape, 3, 3).requires_grad_(True)
            outs = rm._fragments_from_gathered(g, ids, size, persp, clip)
            (parts,) = torch.autograd.grad(list(outs), g, list(cots))
        parts = torch.where((ids >= 0)[..., None, None], parts, 0.0).reshape(-1, 9).double()
        summed = torch.zeros((N * F, 9), dtype=torch.float64, device=device).index_add_(0, flat, parts)
        scale = exact.abs().reshape(-1, 9).amax(dim=1)
        touched = scale > 0
        tol = cs.GRAD_GATE * (scale + scale[touched].median())

        def over(x):  # faces whose error exceeds the face gate's tolerance, and the largest error / tol
            e = (x.double().reshape(-1, 9) - exact.reshape(-1, 9)).abs().amax(dim=1)[touched] / tol[touched]
            return int((e > 1).sum()), float(e.max())

        apart = float(((kernel - kernel_every).double().abs().reshape(-1, 9).amax(dim=1)[touched] / tol[touched]).max())
        shares = cs.face_agreement(kernel, plain, exact)
        print(f"conditioning [{label}, {side}^2 K={k} blur={blur:g}, longest list {cs.longest_list(bins)[0]}]:"
              f" {int(touched.sum())} faces touched; faces over the gate's tolerance (largest error / tolerance):"
              f" kernel {over(kernel)}, kernel on every-face lists {over(kernel_every)}, float32 plain {over(plain)},"
              f" its per-slot partials summed in float64 {over(summed)}; kernel's two binnings apart by"
              f" {apart:.3e} of the tolerance at most; face shares kernel {shares[0]:.6f}, float32 plain"
              f" {shares[1]:.6f} (gate {cs.GRAD_FACE_SHARE})", flush=True)
    return 0


def sync_cost(cs, rc, device, pairs=20, warmup=2):
    """Wall time of a render-fit step (zero_grad, forward, backward, Adam
    step, then a device sync) with the error-flag read and without it,
    alternating step by step (the fit's step time drifts as the mesh
    deforms): the median of each and of the paired differences over
    `pairs` pairs."""
    import time

    import torch

    fit = cs.RenderFit(device)
    package = rc._raise_on_missing
    ms = {True: [], False: []}
    losses = []
    for i in range(2 * (warmup + pairs)):
        read = i % 2 == 0
        rc._raise_on_missing = package if read else (lambda error, name: None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit.optimizer.zero_grad()
        loss = fit.forward()
        loss.backward()
        fit.optimizer.step()
        torch.cuda.synchronize()
        if i >= 2 * warmup:
            ms[read].append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    rc._raise_on_missing = package
    diffs = sorted(a - b for a, b in zip(ms[True], ms[False]))
    for read in (True, False):
        v = sorted(ms[read])
        print(f"sync [{'flag read' if read else 'no flag read'}]: render-fit step median {v[len(v) // 2]:.3f} ms"
              f" (min {v[0]:.3f}, max {v[-1]:.3f}) over {pairs} steps", flush=True)
    print(f"sync: paired difference (read - no read) median {diffs[len(diffs) // 2]:.3f} ms (min {diffs[0]:.3f},"
          f" max {diffs[-1]:.3f}); losses {losses[0]:.6f} -> {losses[-1]:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
