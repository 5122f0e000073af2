#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero without the
final result line:

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: every CUDA kernel of the port from `pytorch3d_tpu_torch/csrc/`;
3. kernel against plain: each kernel's wrapper on card tensors at the main
   path's shapes and at the headline settings, against its plain PyTorch
   version on the same inputs, within bench.py:_row_ok's tolerances (dists
   within 1e-6, tighter than there);
4. main path: `MeshRenderer(MeshRasterizer, SoftPhongShader)` renders a
   batch of two meshes of different face counts (ico_sphere(4) and a
   torus) at 512^2, K=8, blur 1e-4, for 8 camera azimuths, as a server
   answering 8 requests; the launch counts show the path went through the
   kernels, the images are checked against a `bin_size=0` (plain path)
   render, and a backward through the CUDA path must raise;
5. times, after warm-up, with CUDA events: each kernel, the binning, the
   plain version, a whole frame; then a torch.profiler breakdown of the
   8 frames by device kernel, with the device's idle share.

The last lines are a `{"kernels": [...]}` JSON line and then
`{"ok": true, "device": {...}}`.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet) for the bound.  The
# sheet's 67 TFLOP/s of fp32 counts an FMA as two operations; the kernels
# are built with --fmad=false, so each multiply and each add is an
# instruction of its own and issues at half that rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12 / 2

IMAGE = 512
K = 8
BLUR = 1e-4
FRAMES = 8
AZIMUTHS = [30.0 + 45.0 * i for i in range(FRAMES)]


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(*args) -> None:
    print(*args, flush=True)


# --------------------------------------------------------------------------- #
# Scene of the main path
# --------------------------------------------------------------------------- #


def main_path_meshes(device):
    """ico_sphere(4) (5120 faces) and torus(0.4, 1.2, 48, 96) (9216 faces)
    as one padded batch, with vertex colors."""
    from pytorch3d_tpu_torch.renderer import TexturesVertex
    from pytorch3d_tpu_torch.structures import Meshes
    from pytorch3d_tpu_torch.utils import ico_sphere, torus

    ico, tor = ico_sphere(4, device=device), torus(0.4, 1.2, 48, 96, device=device)
    verts = [ico.verts_list()[0], tor.verts_list()[0]]
    colors = [verts[0] * 0.5 + 0.5, verts[1] / 1.6 * 0.5 + 0.5]
    return Meshes.create(
        verts, [ico.faces_list()[0], tor.faces_list()[0]],
        textures=TexturesVertex.create(colors, device=device), device=device,
    )


def camera(azim, device, aspect_ratio=1.0):
    from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras, look_at_view_transform

    R, T = look_at_view_transform(2.7, 20.0, azim, device=device)
    return FoVPerspectiveCameras.create(R=R, T=T, aspect_ratio=aspect_ratio, device=device)


def renderer(cams, device, bin_size=None):
    from pytorch3d_tpu_torch.renderer import (
        MeshRasterizer, MeshRenderer, PointLights, RasterizationSettings, SoftPhongShader,
    )

    settings = RasterizationSettings(
        image_size=IMAGE, blur_radius=BLUR, faces_per_pixel=K, bin_size=bin_size
    )
    lights = PointLights.create(location=[[0, 0, -3]], device=device)
    return MeshRenderer(
        MeshRasterizer(cams, settings),
        SoftPhongShader(cameras=cams, lights=lights, device=device),
    )


def face_inputs(meshes, cams, image_size):
    """What MeshRasterizer hands the rasterizer: (N, F, 3, 3) NDC face verts
    and the (N, F) valid mask."""
    from pytorch3d_tpu_torch.renderer import MeshRasterizer

    ndc = MeshRasterizer(cams).transform(meshes)
    N, F = len(ndc), ndc.max_faces
    fv = ndc.verts_packed()[ndc.faces_packed()].reshape(N, F, 3, 3).contiguous()
    return fv, ndc.faces_packed_mask().reshape(N, F)


# --------------------------------------------------------------------------- #
# Kernel against plain
# --------------------------------------------------------------------------- #


def compare_fine(fv, valid, size, blur, k, persp, clip, cull):
    """The fine kernel against its plain version on the same inputs."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    got = rc.rasterize_fragments_cuda(fv, valid, size, blur, k, persp, clip, cull)
    torch.cuda.synchronize()
    want = rc.rasterize_fragments_plain(fv, valid, size, blur, k, persp, clip, cull)
    same = got[0].long() == want[0]
    err = {}
    for name, g, w in zip(("zbuf", "bary", "dists"), got[1:], want[1:]):
        m = same[..., None] if name == "bary" else same
        d = (g - w).abs()[m.expand_as(g)]
        err[name] = float(d.max()) if d.numel() else 0.0
    frac = float(same.float().mean())
    covered = int((want[0] >= 0).sum())
    return frac, err, covered


DISTS_ATOL = 1e-6


def row_ok(frac, err):
    # bench.py:_row_ok: ids equal on > 99.9 % of slots, |zbuf| < 5e-3 where
    # they agree; bary within 1e-4 there.  dists are held tighter: with blur
    # 1e-4 most filled slots hold |dist| < 1e-4, so 1e-4 would pass a kernel
    # that wrote 0 or the wrong sign.  The kernel and its plain version agree
    # to ~2e-9 on an H100; 1e-6, a hundredth of the main path's blur, leaves
    # room for rounding alone.
    return frac > 0.999 and err["zbuf"] < 5e-3 and err["bary"] <= 1e-4 and err["dists"] <= DISTS_ATOL


# --------------------------------------------------------------------------- #
# Timing and bounds
# --------------------------------------------------------------------------- #


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def fine_ops_per_candidate(persp, clip):
    """fp32 operations per (pixel, face) test of the fine kernel, counting
    only the per-pixel work (per-face terms amortize over the tile):
    3 edge functions (18), the inside test (3), pz (5), 3 segment distances
    and their min (56), the cover test (5), the signed distance (1) = 88;
    perspective correction +10, clipping +10.  A reciprocal counts as one
    operation, which understates its cost, so the bound stays a lower one."""
    return 88 + (10 if persp else 0) + (10 if clip else 0)


def fine_bound(fv, bins, size, k, persp, clip):
    """Least time for this run's work: max(bytes / HBM rate, ops / fp32 rate).

    Bytes: face verts, the tile lists and pixel coordinates read once; the
    four outputs (int32 id, z, 3 bary, dist = 24 B per slot) written once.
    Ops: the (pixel, face) tests these bins ask for, times the ops per test.
    """
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import TILE

    tile_faces, tile_start, n_ty, n_tx = bins
    N, F = fv.shape[:2]
    H, W = size
    TH, TW = TILE
    per_tile = (tile_start[1:] - tile_start[:-1]).cpu().double().reshape(N, n_ty, n_tx)
    rows = [min(TH, H - TH * t) for t in range(n_ty)]
    cols = [min(TW, W - TW * t) for t in range(n_tx)]
    pix = [[r * c for c in cols] for r in rows]  # live pixels of each tile
    candidates = float((per_tile * per_tile.new_tensor(pix)).sum())
    bytes_moved = (
        N * F * 36 + tile_faces.numel() * 4 + tile_start.numel() * 4 + (H + W) * 4
        + N * H * W * k * 24
    )
    ops = candidates * fine_ops_per_candidate(persp, clip)
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), candidates, bytes_moved


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, count {torch.cuda.device_count()})")
    log(card)
    return name, card


def phase_build():
    from pytorch3d_tpu_torch import _build
    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    seconds, text = _build.build("rasterize_fine")
    log(f"build: rasterize_fine {seconds:.2f} s")
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas rasterize_fine: {line.strip()}")
    rc._library()  # loads it and checks its tile against the binning's


def phase_kernels(device):
    """The fine kernel against its plain version at the main path's shapes
    and at the headline settings (bench.py:94-119)."""
    from pytorch3d_tpu_torch.utils import ico_sphere

    batch = main_path_meshes(device)
    ico4 = ico_sphere(4, device=device)
    cams = camera(30.0, device)
    settings = [
        # name, meshes, size, blur, K, persp, clip, cull
        ("main path batch", batch, (IMAGE, IMAGE), BLUR, K, True, True, False),
        ("headline ico4", ico4, (IMAGE, IMAGE), BLUR, K, True, True, False),
        ("K=1 blur 0", ico4, (IMAGE, IMAGE), 0.0, 1, True, False, False),
        ("cull_backfaces", ico4, (IMAGE, IMAGE), BLUR, K, True, True, True),
        ("non-square 384x512", ico4, (IMAGE * 3 // 4, IMAGE), BLUR, K, True, True, False),
    ]
    worst = 0.0
    failed = []
    for name, meshes, size, blur, k, persp, clip, cull in settings:
        cams_s = cams if size[0] == size[1] else camera(30.0, device, aspect_ratio=size[1] / size[0])
        fv, valid = face_inputs(meshes, cams_s, size)
        frac, err, covered = compare_fine(fv, valid, size, blur, k, persp, clip, cull)
        ok = row_ok(frac, err) and covered > 0
        worst = max(worst, *err.values())
        log(
            f"kernel rasterize_fine vs plain [{name}] {size[0]}x{size[1]} K={k} blur={blur}"
            f" cull={cull}: ids equal {frac:.6f}, covered slots {covered},"
            f" max|diff| zbuf {err['zbuf']:.3e} bary {err['bary']:.3e} dists {err['dists']:.3e}"
            f" -> {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failed.append(name)
    check(not failed, f"fine kernel disagrees with its plain version: {failed}")
    return worst


def phase_main_path(device):
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    meshes = main_path_meshes(device)
    cams = [camera(a, device) for a in AZIMUTHS]
    renderers = [renderer(c, device) for c in cams]
    torch.cuda.synchronize()

    rc.rasterize_fragments_cuda.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        images = [r(meshes) for r in renderers]
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = rc.rasterize_fragments_cuda.launches
    log(f"main path: {FRAMES} frames of N={len(meshes)} meshes at {IMAGE}^2 K={K}:"
        f" rasterize_fine launches {launches}, first pass {first_pass_s:.3f} s (first calls included)")
    check(launches == FRAMES, f"rasterize_fine launched {launches} times for {FRAMES} frames")

    for i, (img, c) in enumerate(zip(images, cams)):
        check(img.shape == (2, IMAGE, IMAGE, 4), f"frame {i}: image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"frame {i}: non-finite pixels")
        covered = (img[..., 3] > 0).sum(dim=(1, 2))
        check(bool((covered > 0).all()), f"frame {i}: an image covers no pixel ({covered.tolist()})")
        with torch.no_grad():
            plain = renderer(c, device, bin_size=0)(meshes)
        diff = (img - plain).abs().amax(dim=-1)
        frac = float((diff <= 1e-3).float().mean())
        log(f"  frame {i} azim {AZIMUTHS[i]:.0f}: covered px {covered.tolist()},"
            f" |image - bin_size=0 image| <= 1e-3 on {frac:.6f} of pixels (max {float(diff.max()):.3e})")
        check(frac >= 0.995, f"frame {i}: only {frac:.6f} of pixels match the plain render")

    # The CUDA path has no backward yet: it must raise, never fall back.
    verts = meshes.verts_padded().clone().requires_grad_(True)
    img = renderers[0](meshes.update_padded(verts))
    try:
        img.sum().backward()
    except NotImplementedError as e:
        log(f"  backward through the CUDA path raises NotImplementedError: {str(e)[:80]}...")
    else:
        raise PhaseError("backward through the CUDA path did not raise")
    return launches, meshes, renderers


def phase_times(device, meshes, renderers, launches, worst_err):
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls
    from pytorch3d_tpu_torch.utils import ico_sphere

    size = (IMAGE, IMAGE)
    out = {}
    for label, m in (("main path batch", meshes), ("headline ico4", ico_sphere(4, device=device))):
        fv, valid = face_inputs(m, camera(30.0, device), size)
        ok = _face_culls(fv, valid, False)
        bins = rc.bin_faces(fv, ok, size, BLUR)
        kernel = cuda_ms(lambda: rc._run_kernel(fv, bins, size, BLUR, K, True, True), iters=50, warmup=5)
        binning = cuda_ms(lambda: rc.bin_faces(fv, ok, size, BLUR), iters=20)
        with torch.no_grad():
            plain = cuda_ms(
                lambda: rc.rasterize_fragments_plain(fv, valid, size, BLUR, K, True, True, False),
                iters=3, warmup=1,
            )
        bound, bound_by, candidates, nbytes = fine_bound(fv, bins, size, K, True, True)
        out[label] = dict(kernel=kernel, binning=binning, plain=plain, bound=bound, bound_by=bound_by)
        log(f"times [{label}] N={fv.shape[0]} F={fv.shape[1]} {IMAGE}^2 K={K}: kernel {kernel:.4f} ms,"
            f" binning {binning:.4f} ms, plain version {plain:.2f} ms; bound {bound:.4f} ms by {bound_by}"
            f" (bytes {nbytes / 1e6:.1f} MB = {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms,"
            f" {candidates / 1e6:.2f} M candidate tests ="
            f" {candidates * fine_ops_per_candidate(True, True) / PEAK_FP32_OPS_PER_S * 1e3:.4f} ms,"
            f" {len(bins[0])} tile-face pairs)")

    with torch.no_grad():
        frame_ms = []
        for _ in range(2):  # warm-up
            [r(meshes) for r in renderers]
        torch.cuda.synchronize()
        for r in renderers:
            t0 = time.perf_counter()
            r(meshes)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
    frame_ms.sort()
    log(f"times [frame] whole frame (N=2 meshes, {IMAGE}^2, K={K}, SoftPhong): median"
        f" {frame_ms[len(frame_ms) // 2]:.3f} ms, min {frame_ms[0]:.3f} ms, max {frame_ms[-1]:.3f} ms;"
        f" rasterize_fine launches per frame {launches / FRAMES:g}")
    profile_frames(meshes, renderers)
    main = out["main path batch"]
    return [{
        "name": "rasterize_fine",
        "route": "cuda",
        "source": "pytorch3d_tpu_torch/csrc/rasterize_fine.cu",
        "replaces": "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:324",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": main["kernel"],
        "plain_ms": main["plain"],
        "bound_ms": main["bound"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }]


def profile_frames(meshes, renderers):
    """Where a frame's time goes: device time by kernel name over the 8
    frames (torch.profiler, CUPTI) and the device's idle share of the wall
    time of that window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in renderers:
            r(meshes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, memcpy, memset): the CPU-side op
    # rows carry the same device time again.
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for _, ms, _ in rows)
    if busy_ms == 0:
        log("profile [frame]: the profiler recorded no device time; device busy share not measured")
        return
    rows.sort(key=lambda r: -r[1])
    log(f"profile [frame] {len(renderers)} frames: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall"
        f" (idle share {1 - busy_ms / wall_ms:.3f}, profiler on)")
    for key, ms, count in rows[:12]:
        log(f"  {ms / len(renderers):9.4f} ms/frame  {count // len(renderers):4d} calls/frame  {key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not (REPO / "pytorch3d_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no pytorch3d_tpu_torch package beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    phase = "device"
    try:
        name, card = phase_device()
        device = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase = "build"
        phase_build()
        phase = "kernel against plain"
        worst = phase_kernels(device)
        phase = "main path"
        launches, meshes, renderers = phase_main_path(device)
        phase = "times"
        kernels = phase_times(device, meshes, renderers, launches, worst)
    except Exception as e:  # report which phase failed, then exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
