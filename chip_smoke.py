#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
GPU and check them.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero without the
final result line:

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: every CUDA kernel of the port from `pytorch3d_tpu_torch/csrc/`,
   one nvcc per source, all started together;
3. kernel against plain: each kernel's wrapper on card tensors at the
   paths' shapes, against its plain PyTorch version on the same inputs:
   the fine rasterizer within bench.py:_row_ok's tolerances (dists within
   1e-6, tighter than there); its backward against the plain version in
   float64, within 1e-4 of the largest gradient or no further off than
   1.5x the float32 plain version is (fp32 atomics add in a different order
   on every run, and the float32 gradient is ill-conditioned at sliver
   faces), and per face within 1e-4 of (the face's largest |g| + the median
   of that) on >= 99.7 % of the faces; KNN with ids equal on >= 99.99 % of
   queries and dists within
   1e-6 relative;
4. serving: `MeshRenderer(MeshRasterizer, SoftPhongShader)` renders a batch
   of two meshes of different face counts (ico_sphere(4) and a torus) at
   512^2, K=8, blur 1e-4, for 8 camera azimuths, as a server answering 8
   requests; images are checked against a `bin_size=0` (plain path) render;
5. training, three paths:
   - headline: bench.py:110-119's loss, forward and backward through the
     CUDA path at ico_sphere(4), 512^2, K=8, blur 1e-4; the vertex gradient
     against a `bin_size=0` forward and backward;
   - render-fit: examples/fit_textured_mesh.py at full size (ico_sphere(4)
     source, torus(0.4, 0.9, 48, 96) target, 8 views at 512^2, K=16),
     2 warm-up and 10 timed Adam steps; the loss must fall, and step 0's
     vertex gradient on 2 views is checked against `bin_size=0`;
   - chamfer-fit: examples/deform_source_mesh.py (ico_sphere(4), 5000
     samples), 50 Adam steps; the loss must fall, nothing may be NaN;
   every path runs with the launch counts set to 0 just before it and
   read just after, and must have launched each kernel it runs;
6. times, after warm-up, with CUDA events: each kernel, its plain version
   and its bound; the binning, a serving frame, a training step split into
   forward and backward; torch.profiler breakdowns of 8 serving frames and
   of render-fit steps by device kernel, with the device's idle share.

The last lines are a `{"kernels": [...]}` JSON line and then
`{"ok": true, "device": {...}}`.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet) for the bound.  The
# sheet's 67 TFLOP/s of fp32 counts an FMA as two operations; the kernels
# are built with --fmad=false, so each multiply and each add is an
# instruction of its own and issues at half that rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12 / 2

KERNELS = ("rasterize_fine", "rasterize_grad", "knn")

# Serving (PR 1's main path).
IMAGE = 512
K = 8
BLUR = 1e-4
FRAMES = 8
AZIMUTHS = [30.0 + 45.0 * i for i in range(FRAMES)]

# Training: examples/fit_textured_mesh.py at full size, and
# examples/deform_source_mesh.py.
FIT_VIEWS = 8
FIT_K = 16
FIT_BLUR = math.log(1.0 / 1e-4 - 1.0) * 1e-4
FIT_WARMUP = 2
FIT_STEPS = 10
FIT_CHECK_VIEWS = 2  # views of the bin_size=0 gradient check (bounds the plain path's time)
CHAMFER_STEPS = 50
CHAMFER_SAMPLES = 5000

GRAD_GATE = 1e-4  # max |g - g_ref| <= GRAD_GATE * max |g_ref|
# The backward kernel against the float64 plain version: within GRAD_GATE,
# or no further from it than this factor times the float32 plain version.
GRAD_PLAIN_FACTOR = 1.5
# Per face, against the float64 plain version: within GRAD_GATE of (the
# face's largest |g| + the median of that) on at least this share of the
# faces the slots touch.  Both the kernel and the float32 plain version
# leave a few ill-conditioned sliver faces outside; PERF.md records the
# shares this script reads.
GRAD_FACE_SHARE = 0.997
KNN_IDS_GATE = 0.9999  # share of queries whose K ids all agree
KNN_DISTS_RTOL = 1e-6


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(*args) -> None:
    print(*args, flush=True)


# --------------------------------------------------------------------------- #
# Launch counts
# --------------------------------------------------------------------------- #


def _counters():
    from pytorch3d_tpu_torch.ops import knn
    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    return {
        "rasterize_fine": rc.rasterize_fragments_cuda,
        "rasterize_grad": rc.rasterize_grad_cuda,
        "knn": knn.knn_points_cuda,
    }


def reset_counts() -> None:
    for wrapper in _counters().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in _counters().items()}


# --------------------------------------------------------------------------- #
# Scenes
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


def chamfer_clouds(device):
    """5000 points from the chamfer fit's source and target surfaces."""
    import torch

    from pytorch3d_tpu_torch.ops import sample_points_from_meshes
    from pytorch3d_tpu_torch.utils import ico_sphere, torus

    gen = torch.Generator(device=device).manual_seed(0)
    src = sample_points_from_meshes(ico_sphere(4, device=device), CHAMFER_SAMPLES, generator=gen)
    tgt = sample_points_from_meshes(torus(0.4, 0.9, 32, 64, device=device), CHAMFER_SAMPLES, generator=gen)
    return src.contiguous(), tgt.contiguous()


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
    # that wrote 0 or the wrong sign.  1e-6, a hundredth of the main path's
    # blur, leaves room for rounding alone.
    return frac > 0.999 and err["zbuf"] < 5e-3 and err["bary"] <= 1e-4 and err["dists"] <= DISTS_ATOL


def headline_cotangents(zbuf, dists):
    """Cotangents of bench.py:117-119's loss sum(sigmoid(-dists/1e-4))*1e-6
    + sum(zbuf)*1e-6 with respect to (zbuf, bary, dists); bary unused."""
    import torch

    s = torch.sigmoid(-dists / 1e-4)
    return torch.full_like(zbuf, 1e-6), None, (-(1e-6 / 1e-4) * s * (1.0 - s)).contiguous()


def grad_error(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, (err / scale if scale > 0 else math.inf)


def face_agreement(got, want, exact):
    """Per face against the float64 plain version `exact`: a face agrees
    where its 9 entries lie within GRAD_GATE * (its largest |exact| + the
    median of that over the touched faces).  The largest gradient of all is
    heavy-tailed (sliver faces), so a tolerance set from it alone can
    exceed ordinary faces' gradients.

    Returns the shares of the touched faces on which the kernel `got` and
    the float32 plain version `want` agree."""
    scale = exact.abs().reshape(-1, 9).amax(dim=1)
    touched = scale > 0
    tol = GRAD_GATE * (scale[touched] + scale[touched].median())
    shares = []
    for g in (got, want):
        err = (g.double() - exact).abs().reshape(-1, 9).amax(dim=1)[touched]
        shares.append(float((err <= tol).double().mean()))
    return tuple(shares)


def compare_grad(fv, valid, size, blur, k, persp, clip, cotangents):
    """The backward kernel against its plain version on the same ids and
    cotangents (seeded random, or the headline loss's).

    Returns (finite, max |g - g_plain|, the three ratios to the largest
    gradient: kernel vs plain, kernel vs the plain version in float64,
    plain vs the plain version in float64; `face_agreement`'s two shares;
    the filled slots).  The float64 plain version is the reference of the
    gate: where the float32 gradient is ill-conditioned (sums over
    Sum(bary) = 1 that cancel at sliver faces) the float32 plain version
    itself is off it by more than 1e-4 of the largest gradient.
    """
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import rasterize_grad_plain

    idx, zbuf, bary, dists = rc.rasterize_fragments_cuda(fv, valid, size, blur, k, persp, clip, False)
    if cotangents == "random":
        gen = torch.Generator(device=fv.device).manual_seed(0)
        cots = tuple(torch.randn(t.shape, generator=gen, device=fv.device) for t in (zbuf, bary, dists))
    else:
        cots = headline_cotangents(zbuf, dists)
    got = rc.rasterize_grad_cuda(fv, idx, *cots, size, persp, clip)
    torch.cuda.synchronize()
    want = rasterize_grad_plain(fv, idx, *cots, size, persp, clip)
    exact = rasterize_grad_plain(
        fv.double(), idx, *(None if c is None else c.double() for c in cots), size, persp, clip
    )
    err, ratio = grad_error(got, want)
    _, ratio_exact = grad_error(got.double(), exact)
    _, ratio_plain = grad_error(want.double(), exact)
    faces = face_agreement(got, want, exact)
    return bool(torch.isfinite(got).all()), err, (ratio, ratio_exact, ratio_plain), faces, int((idx >= 0).sum())


def compare_knn(p1, p2, lengths2, k, norm=2):
    """The KNN kernel against its plain version: share of queries whose K
    ids agree, and the largest dist difference (absolute and relative)
    where the ids agree."""
    import torch

    from pytorch3d_tpu_torch.ops import knn

    gd, gi = knn.knn_points_cuda(p1, p2, lengths2, k, norm)
    torch.cuda.synchronize()
    wd, wi = knn.knn_points_plain(p1, p2, lengths2, k, norm)
    same = gi == wi
    frac = float(same.all(dim=-1).float().mean())
    live = same & torch.isfinite(wd)
    diff = (gd - wd).abs()[live]
    rel = (diff / wd.abs()[live].clamp(min=1e-30)) if diff.numel() else diff
    both_empty = bool((torch.isinf(gd) == torch.isinf(wd)).all())
    return frac, (float(diff.max()) if diff.numel() else 0.0), (float(rel.max()) if rel.numel() else 0.0), both_empty


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
    perspective correction +10, clipping +10.  A division or reciprocal
    counts as one operation, which understates its cost, so the bound stays
    a lower one."""
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


def grad_ops_per_slot(persp, clip):
    """fp32 operations per filled slot of the backward kernel, counted from
    csrc/rasterize_grad.cu: the forward recompute (4 edge functions and the
    area 29, 3 divisions 3, the inside test 3, 3 segment distances 72 and
    their min 1), the reverse (pz and bary 9, area and edge functions 65,
    the sign and min routing 5, one segment's reverse 43) and 9 atomic adds
    = 239; perspective correction +52 (12 forward, 40 reverse), clipping
    +31 (9 forward, 22 reverse).  A division counts as one operation."""
    return 239 + (52 if persp else 0) + (31 if clip else 0)


def grad_bound(fv, idx, cots, persp, clip):
    """Least time for this run's backward: bytes (every slot's id read once,
    the cotangents given read once for the filled slots only, as empty
    slots add nothing; face verts read once, the gradient written once)
    against the operations of the filled slots."""
    slots = idx.numel()
    filled = int((idx >= 0).sum())
    cot_bytes_per_slot = sum(4 * (c.numel() // slots) for c in cots if c is not None)
    bytes_moved = slots * 4 + filled * cot_bytes_per_slot + 2 * fv.numel() * 4
    ops = filled * grad_ops_per_slot(persp, clip)
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), filled, bytes_moved


def knn_bound(p1, p2, k):
    """Least time for one KNN of full clouds: the clouds read once and the
    (dist, idx) results written once, against 3*D operations (norm 2:
    difference, square, add) per (query, database point) pair."""
    N, P1, D = p1.shape
    pairs = float(N * P1 * p2.shape[1])
    bytes_moved = (p1.numel() + p2.numel()) * 4 + N * P1 * k * 8
    ops = pairs * 3 * D
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), pairs


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
    from pytorch3d_tpu_torch.ops import knn
    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    log(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s wall")
    for name, (seconds, text) in built.items():
        log(f"build: {name} {seconds:.2f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    rc._library()  # loads it and checks its tile against the binning's
    rc._grad_library()
    knn._library()


def phase_fine_kernel(device):
    """The fine kernel against its plain version at the serving path's
    shapes and at the headline settings (bench.py:94-119)."""
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


def phase_grad_kernel(device):
    """The backward kernel against its plain version at the serving batch
    and the headline ico4, with seeded random cotangents and with the
    headline loss's."""
    from pytorch3d_tpu_torch.utils import ico_sphere

    size = (IMAGE, IMAGE)
    cams = camera(30.0, device)
    worst_err, worst_ratio, failed = 0.0, 0.0, []
    for label, meshes, persp, clip in (
        ("main path batch", main_path_meshes(device), True, True),
        ("headline ico4", ico_sphere(4, device=device), False, False),
    ):
        fv, valid = face_inputs(meshes, cams, size)
        for cotangents in ("random", "headline loss"):
            finite, err, (ratio, ratio_exact, ratio_plain), faces, filled = compare_grad(
                fv, valid, size, BLUR, K, persp, clip, cotangents
            )
            kernel_share, plain_share = faces
            ok = (finite and ratio_exact <= max(GRAD_GATE, GRAD_PLAIN_FACTOR * ratio_plain)
                  and kernel_share >= GRAD_FACE_SHARE)
            worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio_exact)
            log(f"kernel rasterize_grad vs plain [{label}, {cotangents} cotangents] N={fv.shape[0]}"
                f" F={fv.shape[1]} {IMAGE}^2 K={K} persp={persp} clip={clip}: filled slots {filled},"
                f" max|diff| {err:.3e} = {ratio:.3e} of max|grad|; vs the float64 plain version:"
                f" kernel {ratio_exact:.3e}, float32 plain version {ratio_plain:.3e} of max|grad|;"
                f" faces within {GRAD_GATE:g} of their own scale: kernel {kernel_share:.6f},"
                f" float32 plain version {plain_share:.6f} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{label}/{cotangents}")
    log(f"kernel rasterize_grad: worst ratio to the float64 plain version {worst_ratio:.3e}"
        f" (gate max({GRAD_GATE:g}, {GRAD_PLAIN_FACTOR:g} x the float32 plain version's), and"
        f" >= {GRAD_FACE_SHARE:g} of the faces within {GRAD_GATE:g} x (the face's largest |g|"
        f" + the median of that))")
    check(not failed, f"backward kernel disagrees with its plain version: {failed}")
    return worst_err


def phase_knn_kernel(device):
    """The KNN kernel against its plain version at the chamfer fit's clouds
    and at 16384 x 16384, K=16, with and without lengths2."""
    import torch

    src, tgt = chamfer_clouds(device)
    gen = torch.Generator(device=device).manual_seed(1)
    big1 = torch.rand((2, 16384, 3), generator=gen, device=device)
    big2 = torch.rand((2, 16384, 3), generator=gen, device=device)
    cases = [
        ("chamfer 5000x5000", src, tgt, None, 1),
        ("chamfer 5000x5000 reverse", tgt, src, None, 1),
        ("16384x16384 K=16", big1[:1].contiguous(), big2[:1].contiguous(), None, 16),
        ("16384x16384 K=16 lengths2 [16384, 9000]", big1, big2,
         torch.tensor([16384, 9000], device=device), 16),
    ]
    worst, failed = 0.0, []
    for label, p1, p2, l2, k in cases:
        frac, err, rel, both_empty = compare_knn(p1, p2, l2, k)
        ok = frac >= KNN_IDS_GATE and rel <= KNN_DISTS_RTOL and both_empty
        worst = max(worst, err)
        log(f"kernel knn vs plain [{label}] N={p1.shape[0]} K={k}: queries with equal ids {frac:.6f},"
            f" max|diff| dists {err:.3e} (relative {rel:.3e}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    check(not failed, f"KNN kernel disagrees with its plain version: {failed}")
    return worst


def phase_serving(device):
    import torch

    meshes = main_path_meshes(device)
    cams = [camera(a, device) for a in AZIMUTHS]
    renderers = [renderer(c, device) for c in cams]
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        images = [r(meshes) for r in renderers]
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"serving: {FRAMES} frames of N={len(meshes)} meshes at {IMAGE}^2 K={K}: launches {counts},"
        f" first pass {first_pass_s:.3f} s (first calls included)")
    check(counts["rasterize_fine"] == FRAMES, f"rasterize_fine launched {counts['rasterize_fine']} times for {FRAMES} frames")

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
    return counts, meshes, renderers


def phase_headline(device):
    """bench.py:110-119: the loss's forward and backward to the NDC verts
    of ico_sphere(4) through the CUDA path, against bin_size=0."""
    import torch

    from pytorch3d_tpu_torch.renderer import MeshRasterizer, RasterizationSettings
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import rasterize_meshes
    from pytorch3d_tpu_torch.utils import ico_sphere

    settings = RasterizationSettings(image_size=IMAGE, blur_radius=BLUR, faces_per_pixel=K)
    mesh_ndc = MeshRasterizer(camera(30.0, device), settings).transform(ico_sphere(4, device=device))
    verts_ndc = mesh_ndc.verts_padded()

    def fwd_bwd(bin_size=None):
        v = verts_ndc.clone().requires_grad_(True)
        _, zbuf, _, dists = rasterize_meshes(
            mesh_ndc.update_padded(v), image_size=IMAGE, blur_radius=BLUR, faces_per_pixel=K,
            bin_size=bin_size,
        )
        loss = torch.sum(torch.sigmoid(-dists / 1e-4)) * 1e-6 + torch.sum(zbuf) * 1e-6
        loss.backward()
        return loss.detach(), v.grad

    steps = 3
    reset_counts()
    for _ in range(steps):
        loss, grad = fwd_bwd()
    torch.cuda.synchronize()
    counts = read_counts()
    _, grad_plain = fwd_bwd(bin_size=0)
    err, ratio = grad_error(grad, grad_plain)
    log(f"headline: {steps} fwd+bwd steps (ico4, {IMAGE}^2, K={K}, blur {BLUR:g}): loss {float(loss):.6f},"
        f" launches {counts}; vertex grad vs bin_size=0: max|diff| {err:.3e} = {ratio:.3e} of max|grad|")
    check(bool(torch.isfinite(grad).all()), "headline: non-finite vertex gradient")
    check(counts["rasterize_fine"] == steps and counts["rasterize_grad"] == steps,
          f"headline: launches {counts} for {steps} steps (1 fine + 1 grad each)")
    check(ratio <= GRAD_GATE, f"headline: vertex gradient {ratio:.3e} of max|grad| off the bin_size=0 one")
    ms = cuda_ms(lambda: fwd_bwd(), iters=20, warmup=2)
    log(f"times [headline] fwd+bwd {ms:.4f} ms, {IMAGE * IMAGE / ms / 1e3:.2f} Mpix/s")
    return counts, ratio


class RenderFit:
    """examples/fit_textured_mesh.py with the port at full size: targets
    rendered with HardPhongShader (K=1), the source with SoftPhongShader
    (K=16, blur log(1/1e-4 - 1)*1e-4); loss = rgb MSE + silhouette MSE
    + 0.5 edge + 0.05 laplacian; Adam(5e-3) on deform and colors."""

    def __init__(self, device):
        import torch

        from pytorch3d_tpu_torch.renderer import (
            FoVPerspectiveCameras, HardPhongShader, MeshRasterizer, MeshRenderer, PointLights,
            RasterizationSettings, SoftPhongShader, TexturesVertex, look_at_view_transform,
        )
        from pytorch3d_tpu_torch.utils import ico_sphere, torus

        self.device = device
        target = torus(0.4, 0.9, 48, 96, device=device)
        tv = target.verts_padded()
        colors = (tv - tv.amin(dim=1, keepdim=True)) / (tv.amax(dim=1, keepdim=True) - tv.amin(dim=1, keepdim=True))
        target = target.replace(textures=TexturesVertex.create(colors, device=device))
        azims = torch.linspace(-180.0, 180.0, FIT_VIEWS + 1, device=device)[:-1]
        R, T = look_at_view_transform(dist=2.8, elev=25.0, azim=azims, device=device)
        self.R, self.T = R, T
        self.lights = PointLights.create(location=[[0.0, 2.0, -3.0]], device=device)
        self._classes = (FoVPerspectiveCameras, MeshRasterizer, MeshRenderer, RasterizationSettings,
                         SoftPhongShader, TexturesVertex)
        cams = FoVPerspectiveCameras.create(R=R, T=T, fov=60.0, device=device)
        hard = MeshRenderer(
            MeshRasterizer(cams, RasterizationSettings(image_size=IMAGE, faces_per_pixel=1)),
            HardPhongShader(cameras=cams, lights=self.lights, device=device),
        )
        with torch.no_grad():
            self.target_images = hard(target.extend(FIT_VIEWS), cameras=cams)[..., :3]
        self.target_sil = (self.target_images.sum(-1) < 2.95).float()
        self.src = ico_sphere(4, device=device)
        self.deform = torch.zeros_like(self.src.verts_padded(), requires_grad=True)
        self.colors = torch.full(self.src.verts_padded().shape, 0.5, device=device, requires_grad=True)
        self.optimizer = torch.optim.Adam([self.deform, self.colors], lr=5e-3)

    def soft_renderer(self, views, bin_size=None):
        FoV, Rasterizer, Renderer, Settings, SoftPhong, _ = self._classes
        cams = FoV.create(R=self.R[:views], T=self.T[:views], fov=60.0, device=self.device)
        settings = Settings(image_size=IMAGE, faces_per_pixel=FIT_K, blur_radius=FIT_BLUR, bin_size=bin_size)
        return Renderer(Rasterizer(cams, settings), SoftPhong(cameras=cams, lights=self.lights, device=self.device)), cams

    def mesh(self):
        import torch

        TexturesVertex = self._classes[-1]
        mesh = self.src.update_padded(self.src.verts_padded() + self.deform)
        return mesh.replace(textures=TexturesVertex.create(torch.sigmoid(4.0 * (self.colors - 0.5)), device=self.device))

    def loss(self, preds, mesh, views):
        import torch

        from pytorch3d_tpu_torch.loss import mesh_edge_loss, mesh_laplacian_smoothing

        return (
            torch.mean((preds[..., :3] - self.target_images[:views]) ** 2)
            + torch.mean((preds[..., 3] - self.target_sil[:views]) ** 2)
            + 0.5 * mesh_edge_loss(mesh) + 0.05 * mesh_laplacian_smoothing(mesh)
        )

    def forward(self, views=None, bin_size=None):
        views = views or FIT_VIEWS
        soft, cams = self.soft_renderer(views, bin_size)
        mesh = self.mesh()
        return self.loss(soft(mesh.extend(views), cameras=cams), mesh, views)


def phase_render_fit(device):
    import torch

    fit = RenderFit(device)
    # Step 0's vertex gradient on FIT_CHECK_VIEWS views, CUDA path against
    # bin_size=0 (the plain path), before any step is taken.
    grads = [torch.autograd.grad(fit.forward(FIT_CHECK_VIEWS, b), fit.deform)[0] for b in (None, 0)]
    err, ratio = grad_error(*grads)
    log(f"render-fit: step 0 vertex grad on {FIT_CHECK_VIEWS} views vs bin_size=0: max|diff| {err:.3e}"
        f" = {ratio:.3e} of max|grad|")
    check(bool(torch.isfinite(grads[0]).all()), "render-fit: non-finite vertex gradient")
    check(ratio <= GRAD_GATE, f"render-fit: vertex gradient {ratio:.3e} of max|grad| off the bin_size=0 one")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, fwd_ms, bwd_ms = [], [], []
    reset_counts()
    for _ in range(FIT_WARMUP + FIT_STEPS):
        t0 = time.perf_counter()
        fit.optimizer.zero_grad()
        loss = fit.forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        fit.optimizer.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses.append(loss.item())
        fwd_ms.append((t1 - t0) * 1e3)
        bwd_ms.append((t2 - t1) * 1e3)
    counts = read_counts()
    steps = FIT_WARMUP + FIT_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"render-fit: {steps} Adam steps, {FIT_VIEWS} views at {IMAGE}^2, K={FIT_K}: losses"
        f" {[round(v, 6) for v in losses]}; launches {counts}; peak memory {peak_gb:.2f} GB")
    check(all(math.isfinite(v) for v in losses), "render-fit: non-finite loss")
    check(losses[-1] < losses[0], f"render-fit: loss did not fall ({losses[0]:.6f} -> {losses[-1]:.6f})")
    check(counts["rasterize_fine"] == steps and counts["rasterize_grad"] == steps,
          f"render-fit: launches {counts} for {steps} steps (1 fine + 1 grad each)")
    check(bool(torch.isfinite(fit.deform).all() and torch.isfinite(fit.colors).all()), "render-fit: NaN parameters")
    timed_f, timed_b = sorted(fwd_ms[FIT_WARMUP:]), sorted(bwd_ms[FIT_WARMUP:])
    step = sorted(f + b for f, b in zip(fwd_ms[FIT_WARMUP:], bwd_ms[FIT_WARMUP:]))
    mid = FIT_STEPS // 2
    log(f"times [render-fit step] median of {FIT_STEPS}: step {step[mid]:.3f} ms (min {step[0]:.3f}, max"
        f" {step[-1]:.3f}); forward {timed_f[mid]:.3f} ms; backward + Adam {timed_b[mid]:.3f} ms")
    return counts, fit


def phase_chamfer_fit(device):
    """examples/deform_source_mesh.py: ico_sphere(4) deformed toward 5000
    points sampled from torus(0.4, 0.9, 32, 64); chamfer + 1.0 edge
    + 0.1 uniform laplacian + 0.01 normal consistency, Adam(1e-2)."""
    import torch

    from pytorch3d_tpu_torch.loss import (
        chamfer_distance, mesh_edge_loss, mesh_laplacian_smoothing, mesh_normal_consistency,
    )
    from pytorch3d_tpu_torch.ops import sample_points_from_meshes
    from pytorch3d_tpu_torch.utils import ico_sphere, torus

    gen = torch.Generator(device=device).manual_seed(0)
    src = ico_sphere(4, device=device)
    tgt_pts = sample_points_from_meshes(torus(0.4, 0.9, 32, 64, device=device), CHAMFER_SAMPLES, generator=gen)
    deform = torch.zeros_like(src.verts_padded(), requires_grad=True)
    optimizer = torch.optim.Adam([deform], lr=1e-2)
    losses, step_ms = [], []
    reset_counts()
    for _ in range(CHAMFER_STEPS):
        t0 = time.perf_counter()
        optimizer.zero_grad()
        mesh = src.update_padded(src.verts_padded() + deform)
        pts = sample_points_from_meshes(mesh, CHAMFER_SAMPLES, generator=gen)
        cd, _ = chamfer_distance(pts, tgt_pts)
        loss = (cd + 1.0 * mesh_edge_loss(mesh) + 0.1 * mesh_laplacian_smoothing(mesh, method="uniform")
                + 0.01 * mesh_normal_consistency(mesh))
        loss.backward()
        check(bool(torch.isfinite(deform.grad).all()), "chamfer-fit: NaN in the gradient")
        optimizer.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    counts = read_counts()
    log(f"chamfer-fit: {CHAMFER_STEPS} Adam steps, {CHAMFER_SAMPLES} samples: loss {losses[0]:.6f} ->"
        f" {losses[-1]:.6f} (every 10th: {[round(v, 6) for v in losses[::10]]}); launches {counts}")
    check(all(math.isfinite(v) for v in losses), "chamfer-fit: non-finite loss")
    check(losses[-1] < losses[0], f"chamfer-fit: loss did not fall ({losses[0]:.6f} -> {losses[-1]:.6f})")
    check(bool(torch.isfinite(deform).all()), "chamfer-fit: NaN in the deform")
    check(counts["knn"] == 2 * CHAMFER_STEPS, f"chamfer-fit: knn launched {counts['knn']} times for"
          f" {CHAMFER_STEPS} steps (2 each)")
    timed = sorted(step_ms[10:])
    log(f"times [chamfer-fit step] median of {len(timed)} (after 10): {timed[len(timed) // 2]:.3f} ms"
        f" (min {timed[0]:.3f}, max {timed[-1]:.3f})")
    return counts


def phase_times(device, meshes, renderers, fit):
    """Each kernel's time, its plain version's time and its bound at the
    shape of its path; the serving frame; profiles."""
    import torch

    from pytorch3d_tpu_torch.ops import knn
    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls, rasterize_grad_plain
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
        log(f"times [rasterize_fine, {label}] N={fv.shape[0]} F={fv.shape[1]} {IMAGE}^2 K={K}: kernel {kernel:.4f} ms,"
            f" binning {binning:.4f} ms, plain version {plain:.2f} ms; bound {bound:.4f} ms by {bound_by}"
            f" (bytes {nbytes / 1e6:.1f} MB = {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms,"
            f" {candidates / 1e6:.2f} M candidate tests ="
            f" {candidates * fine_ops_per_candidate(True, True) / PEAK_FP32_OPS_PER_S * 1e3:.4f} ms,"
            f" {len(bins[0])} tile-face pairs)")

    # The backward kernel on the render-fit step's own ids and cotangents,
    # and on the headline loss's.
    mesh = fit.mesh().extend(FIT_VIEWS)
    soft, cams = fit.soft_renderer(FIT_VIEWS)
    fragments = soft.rasterizer(mesh, cameras=cams)
    loss = fit.loss(soft.shader(fragments, mesh, cameras=cams), fit.mesh(), FIT_VIEWS)
    cots = torch.autograd.grad(loss, [fragments.zbuf, fragments.bary_coords, fragments.dists])
    fv_fit, _ = face_inputs(mesh, cams, size)
    F = fv_fit.shape[1]
    offsets = (torch.arange(FIT_VIEWS, device=device) * F)[:, None, None, None]
    idx_fit = torch.where(fragments.pix_to_face >= 0, fragments.pix_to_face - offsets, -1).int().contiguous()
    cots = tuple(c.contiguous() for c in cots)
    grads = {}
    fv_h, valid_h = face_inputs(ico_sphere(4, device=device), camera(30.0, device), size)
    idx_h, zbuf_h, _, dists_h = rc.rasterize_fragments_cuda(fv_h, valid_h, size, BLUR, K)
    for label, fv, idx, c, persp, clip in (
        (f"render-fit step: N={FIT_VIEWS} F={F} {IMAGE}^2 K={FIT_K}", fv_fit, idx_fit, cots, True, True),
        (f"headline: N=1 F={fv_h.shape[1]} {IMAGE}^2 K={K}", fv_h, idx_h, headline_cotangents(zbuf_h, dists_h), False, False),
    ):
        kernel = cuda_ms(lambda: rc.rasterize_grad_cuda(fv, idx, *c, size, persp, clip), iters=20, warmup=3)
        plain = cuda_ms(lambda: rasterize_grad_plain(fv, idx, *c, size, persp, clip), iters=2, warmup=1)
        bound, bound_by, filled, nbytes = grad_bound(fv, idx, c, persp, clip)
        grads[label] = dict(kernel=kernel, plain=plain, bound=bound, bound_by=bound_by)
        log(f"times [rasterize_grad, {label}] kernel {kernel:.4f} ms, plain version {plain:.2f} ms;"
            f" bound {bound:.4f} ms by {bound_by} (bytes {nbytes / 1e6:.1f} MB ="
            f" {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms, {filled / 1e6:.3f} M filled slots ="
            f" {filled * grad_ops_per_slot(persp, clip) / PEAK_FP32_OPS_PER_S * 1e3:.4f} ms)")
    torch.cuda.empty_cache()

    src, tgt = chamfer_clouds(device)
    gen = torch.Generator(device=device).manual_seed(1)
    big1 = torch.rand((1, 16384, 3), generator=gen, device=device)
    big2 = torch.rand((1, 16384, 3), generator=gen, device=device)
    knns = {}
    for label, p1, p2, k in (("chamfer 5000x5000 K=1", src, tgt, 1), ("16384x16384 K=16", big1, big2, 16)):
        kernel = cuda_ms(lambda: knn.knn_points_cuda(p1, p2, None, k), iters=50, warmup=5)
        plain = cuda_ms(lambda: knn.knn_points_plain(p1, p2, None, k), iters=3, warmup=1)
        # The yardstick is two library calls, cdist then topk; the port calls neither.
        library = cuda_ms(lambda: torch.topk(torch.cdist(p1, p2), k, dim=-1, largest=False), iters=20, warmup=3)
        bound, bound_by, pairs = knn_bound(p1, p2, k)
        knns[label] = dict(kernel=kernel, plain=plain, library=library, bound=bound, bound_by=bound_by)
        log(f"times [knn, {label}] kernel {kernel:.4f} ms, plain version {plain:.3f} ms,"
            f" library yardstick (torch.cdist + torch.topk, two calls) {library:.4f} ms;"
            f" bound {bound:.5f} ms by {bound_by} ({pairs / 1e6:.1f} M pairs)")

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
    log(f"times [serving frame] whole frame (N=2 meshes, {IMAGE}^2, K={K}, SoftPhong): median"
        f" {frame_ms[len(frame_ms) // 2]:.3f} ms, min {frame_ms[0]:.3f} ms, max {frame_ms[-1]:.3f} ms")
    with torch.no_grad():
        profile("serving frame", lambda: [r(meshes) for r in renderers], len(renderers))

    def fit_steps():
        for _ in range(3):
            fit.optimizer.zero_grad()
            fit.forward().backward()
            fit.optimizer.step()

    profile("render-fit step", fit_steps, 3)
    return out["main path batch"], grads[f"render-fit step: N={FIT_VIEWS} F={F} {IMAGE}^2 K={FIT_K}"], knns["chamfer 5000x5000 K=1"]


def profile(label, fn, units):
    """Where the time goes: device time by kernel name over `fn` (which
    runs `units` frames or steps; torch.profiler, CUPTI) and the device's
    idle share of the wall time of that window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        log(f"profile [{label}]: the profiler recorded no device time; device busy share not measured")
        return
    rows.sort(key=lambda r: -r[1])
    log(f"profile [{label}] {units} units: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall"
        f" (idle share {1 - busy_ms / wall_ms:.3f}, profiler on)")
    for key, ms, count in rows[:14]:
        log(f"  {ms / units:9.4f} ms/unit  {count / units:7.1f} calls/unit  {key[:90]}")


def kernel_rows(launches, errors, fine, grad, knn_t):
    rows = []
    for name, source, replaces, t, library in (
        ("rasterize_fine", "pytorch3d_tpu_torch/csrc/rasterize_fine.cu",
         "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:324", fine, None),
        ("rasterize_grad", "pytorch3d_tpu_torch/csrc/rasterize_grad.cu",
         "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:809", grad, None),
        ("knn", "pytorch3d_tpu_torch/csrc/knn.cu", "pytorch3d_tpu/ops/knn_pallas.py:36", knn_t, knn_t["library"]),
    ):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": t["kernel"],
            "plain_ms": t["plain"],
            "bound_ms": t["bound"],
            "bound_by": t["bound_by"],
            "library_ms": library,
        })
    return rows


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
        errors = {
            "rasterize_fine": phase_fine_kernel(device),
            "rasterize_grad": phase_grad_kernel(device),
            "knn": phase_knn_kernel(device),
        }
        launches = dict.fromkeys(KERNELS, 0)
        phase = "serving"
        counts, meshes, renderers = phase_serving(device)
        paths = {"serving": counts}
        phase = "training: headline"
        paths["headline"], _ = phase_headline(device)
        phase = "training: render-fit"
        paths["render-fit"], fit = phase_render_fit(device)
        phase = "training: chamfer-fit"
        paths["chamfer-fit"] = phase_chamfer_fit(device)
        for counts in paths.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        for kernel in KERNELS:
            check(launches[kernel] > 0, f"{kernel} was launched no time on the paths")
        log(f"launches by path: {paths}; summed {launches}")
        phase = "times"
        fine, grad, knn_t = phase_times(device, meshes, renderers, fit)
        kernels = kernel_rows(launches, errors, fine, grad, knn_t)
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
