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
   paths' shapes, against its plain PyTorch version on the same inputs
   (the fused MLP kernels #10-#13 as `compare_fused` says, at the
   nerf-trunk rows and at a training step's two field launches; #2, #3,
   #6 and #8 as `phase_topk_kernel`, `phase_hard_kernel`,
   `phase_select_kernel` and `compare_pulsar_grad` say, at the serving
   batch, pulsar-serving's request 0 and pulsar-fit's step 0):
   the fine rasterizer within bench.py:_row_ok's tolerances (dists within
   1e-6, tighter than there); #8 also bit-equal over two launches at
   pulsar-fit's step 0 and, in the times, at 10^6 spheres; its backward
   against the plain version in
   float64, within 1e-4 of the largest gradient or no further off than
   1.5x the float32 plain version is (the kernel sums per tile, then per
   face, in another order than the plain version, and the float32
   gradient is ill-conditioned at sliver faces), and per face within 1e-4
   of (the face's largest |g| + the median of that) on >= 99.7 % of the
   faces, and, at the render-fit and headline shapes, bit-equal over two
   launches; KNN with ids equal on >= 99.99 % of queries and dists within
   1e-6 relative, at the chamfer and points fits' clouds, 16384^2 at K=16,
   ties across the kernel's database ranges, a database shorter than a
   range and D = 8 at norm 1;
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
6. point rendering (examples/render_colored_points.py widened to a served
   batch): points-serving renders 30 000 torus points for 8 azimuths with
   FoVOrthographicCameras at 256^2, radius 0.006, K=10, through
   AlphaCompositor and NormWeightedCompositor (one points-kernel launch per
   render), checked against a `bin_size=0` render; points-bench
   (benchmarks/bm_points_knn_nerf.py's 100 000 points at 256^2, K=8)
   forward and backward; points-fit, Adam steps that fit 30 000 points
   sampled from ico_sphere(4) to the served scene (image MSE + 0.1
   chamfer), whose loss must fall and whose step-0 point gradient is
   checked against `bin_size=0`;
7. NeRF (the RadianceFieldRenderer defaults on tests/data/train_parity/
   cow.npz): nerf-trunk runs MLPWithInputSkips without a head forward and
   backward over one serving chunk's coarse points (#10, #11);
   nerf-serving renders the 8 test views as 128^2 frames in chunks of 4096
   rays (#12), one checked against `use_fused_kernel=False`; nerf-train
   checks step 0's gradients against `use_fused_kernel=False` and takes 22
   Adam steps of 1024 rays (#12, #13), whose loss must fall;
8. slice 5: serving-topk drives `rasterize_topk_cuda` (#2) on the
   serving batch; pulsar-serving renders benchmarks/exp_pulsar.py's
   100 000 spheres at 1024² for 8 yaws (#6), request 0 against the plain
   path, then one request of 1 000 000 spheres; pulsar-fit takes 22 Adam
   steps toward the yaw-0 render (#6, #8), whose loss must fall;
   pulsar-points renders the points-serving scene through
   `PulsarPointsRenderer` (#6) against the plain path; mesh-gl-serving
   renders the serving batch through `MeshRasterizerOpenGL` and
   `HardPhongShader` (#3) for the 8 azimuths against the same renderer
   with `rasterize_hard_plain` patched in for the kernel;
9. times, after warm-up, with CUDA events: each kernel, its plain version
   and its bound (the point kernels' launches are short, and #4 and #9 run
   two device kernels a call, so their time is the profiler's device time,
   beside the events'; #1 by the profiler's device time at the serving
   batch, the headline and the render-fit shape, with the (pixel, face)
   tests it makes beside those of its tile lists; #9 at the chamfer
   fit's, the points fit's and a
   K=16 shape, with the merge's share, #4 with pass 2's share); the binning, a serving
   frame, a training step split into forward and backward; torch.profiler
   breakdowns of 8 serving and 8 points-serving frames and of render-fit
   and points-fit steps by device kernel, with the device's idle share; the
   points kernel and its binning at 1 M points, 1024^2 (a timing-only row,
   with no plain check); the fused MLP kernels' device times beside their
   plain versions, the torch.addmm chain and their bounds, and profiles of
   a NeRF frame and training steps; #2, #3, #6 and #8 by the profiler's
   device time beside their plain versions and bounds (#8 also beside
   autograd of the plain blend), the pulsar request, the mesh-gl frame
   and profiles of both and of pulsar-fit steps.

The last lines are a `{"kernels": [...]}` JSON line and then
`{"ok": true, "device": {...}}`.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
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
# The fused MLP's products run on the tensor cores as three TF32 passes
# (a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, as accurate as float32), so the
# least time of float32-accurate products is their operations over a third of
# the sheet's dense TF32 rate of 495 TFLOP/s (700 W): 165 TFLOP/s, above the
# 67 TFLOP/s of fp32 FMA on the CUDA cores.
PEAK_TF32X3_OPS_PER_S = 495e12 / 3

KERNELS = ("rasterize_fine", "rasterize_grad", "knn", "rasterize_points", "rasterize_points_grad",
           "fused_mlp", "fused_mlp_grad", "nerf_field", "nerf_field_grad",
           "rasterize_topk", "rasterize_hard", "select_points", "pulsar_grad")
# The device kernels of #4 and #7 (pass 1, pass 2), whose device times make their times.
GRAD_KERNELS = ("rasterize_grad_tiles_kernel", "rasterize_grad_faces_kernel")
POINTS_GRAD_KERNELS = ("rasterize_points_grad_tiles_kernel", "rasterize_points_grad_points_kernel")
SOURCES = ("rasterize_fine", "rasterize_grad", "knn", "rasterize_points", "rasterize_points_grad", "fused_mlp",
           "rasterize_hard", "pulsar_grad")

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
# List positions whose sums one pass of the backward's pass 1 holds
# (csrc/rasterize_grad.cu's kListChunk): a longer tile list takes several
# passes, which the long-list cases of phase_grad_kernel drive.
GRAD_LIST_CHUNK = 128
POINTS_GRAD_LIST_CHUNK = 256  # kListChunk of csrc/rasterize_points_grad.cu
FINE_RECT = (4, 8)  # rows x columns of a warp's rectangle in csrc/rasterize_fine.cu and rasterize_points.cu
KNN_IDS_GATE = 0.9999  # share of queries whose K ids all agree
KNN_DISTS_RTOL = 1e-6

# Point rendering: examples/render_colored_points.py at its
# own sizes for a served batch of 8 requests; benchmarks/
# bm_points_knn_nerf.py:17-39's shape; the points fit.
PTS_IMAGE = 256
PTS_RADIUS = 0.006
PTS_K = 10
PTS_SAMPLES = 30_000
PTS_REQUESTS = 8
PTS_AZIMUTHS = [45.0 * i for i in range(PTS_REQUESTS)]
BENCH_POINTS = 100_000
BENCH_RADIUS = 0.01
BENCH_K = 8
PFIT_WARMUP = 2
PFIT_STEPS = 10
BIG_POINTS, BIG_IMAGE, BIG_RADIUS = 1_000_000, 1024, 0.003  # the timing-only row
POINT_IDS_GATE = 0.9999  # share of slots whose ids agree (expected: all)
# The points backward against the float64 plain version, per point: within
# POINT_GRAD_GATE of (the point's largest |g| + the median of that) on at
# least POINT_GRAD_SHARE of the touched points, and within POINT_GRAD_GATE
# of the largest gradient overall.
POINT_GRAD_GATE = 1e-5
POINT_GRAD_SHARE = 0.999

# NeRF: the RadianceFieldRenderer defaults (8 trunk layers of 256, the skip
# at layer 5, colour head 128, 6 and 4 harmonics, 64 + 64 points per ray) on
# tests/data/train_parity/cow.npz (48 views at 64^2, fov 60, depths
# 1.0-4.5, white background; 8 test views).  Serving renders each test
# view as a whole 128^2 frame in chunks of 4096 rays; training takes 1024
# rays of one training view per step (projects/nerf/configs/lego.yaml),
# Adam(5e-4).
NERF_DATA = REPO / "tests" / "data" / "train_parity" / "cow.npz"
NERF_FRAME = 128
NERF_CHUNK = 4096
NERF_RAYS = 1024
NERF_LR = 5e-4
NERF_WARMUP = 2
NERF_STEPS = 20  # after the warm-up
NERF_TIMED = 10  # steps of the forward / backward split
# A served frame against use_fused_kernel=False: rgb_fine within
# NERF_FRAME_TOL on >= NERF_FRAME_SHARE of the pixels (a last-bit change of
# the coarse weights can move an importance sample).
NERF_FRAME_TOL = 1e-4
NERF_FRAME_SHARE = 0.999
# The fine field's step-0 gradients end to end against use_fused_kernel=False
# (see phase_nerf_step0): 10x the largest gap read on an H100 at 700 W
# (1.08e-4).
NERF_FINE_GATE = 1e-3

# Pulsar: benchmarks/exp_pulsar.py:33-64's scene (100 000 spheres uniform in
# [-10, 10]^2 x [20, 40], radius 0.1, camera [0,0,0, 0,0,0, 5, 2]) at
# 1024^2, n_track 5, gamma 0.1, depths 1-45, served for 8 yaws evenly in
# [-0.2, 0.2] rad; one request at 1 000 000 spheres (the reference's
# regime); pulsar-fit takes 22 Adam steps toward the yaw-0 render.
PULSAR_SPHERES, PULSAR_BIG = 100_000, 1_000_000
PULSAR_IMAGE = 1024
PULSAR_TRACK = 5
PULSAR_GAMMA = 0.1
PULSAR_DEPTH = (1.0, 45.0)  # (min_depth, max_depth)
PULSAR_REQUESTS = 8
PULSAR_YAWS = [-0.2 + 0.4 * i / (PULSAR_REQUESTS - 1) for i in range(PULSAR_REQUESTS)]
PULSAR_FIT_STEPS = 22
PULSAR_FIT_TIMED = 10  # the last steps, whose median is the step time
PULSAR_FIT_LR = 1e-2
PULSAR_IMAGE_TOL, PULSAR_IMAGE_SHARE = 1e-5, 0.999  # images against the plain path
PULSAR_IDS_GATE = 0.9999  # #6: share of slots whose ids agree (expected: all)
# #8 against the float64 plain version: each field within PULSAR_GRAD_GATE
# of its largest entry, or no further off than PULSAR_GRAD_PLAIN_FACTOR x the
# float32 plain version.  The float32 blend gradient is ill-conditioned:
# dL/dw = ct . (col - I) / denom cancels where the front sphere's colour
# makes the image, so the float32 plain version itself sits further than
# PULSAR_GRAD_GATE off float64 (4.5e-5 of a field's largest entry at
# pulsar-serving on an H100); the kernel sums the same terms in another
# order.
# Per sphere, the share within PULSAR_GRAD_GATE of its own scale may fall
# PULSAR_GRAD_SHARE_MARGIN below the float32 plain version's: runs on an
# H100 read kernel 0.99760 / plain 0.99763 (serving), 0.99912 / 0.99907
# (fit step 0) and 0.62366 / 0.62361 (pulsar-points at gamma 1e-4), gaps
# of at most 7e-5.
PULSAR_GRAD_GATE = 1e-5
PULSAR_GRAD_PLAIN_FACTOR = 2.0
PULSAR_GRAD_SHARE_MARGIN = 1e-3
HARD_IDS_GATE = 0.999  # #3: share of pixels whose ids agree
# PulsarPointsRenderer's defaults, at which pulsar-points renders:
# gamma 1e-4, (znear, zfar) = (0.1, 100).
PULSAR_POINTS_GAMMA, PULSAR_POINTS_DEPTH = 1e-4, (0.1, 100.0)


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
    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm
    from pytorch3d_tpu_torch.ops import knn
    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc

    return {
        "rasterize_topk": rc.rasterize_topk_cuda,
        "rasterize_hard": rc.rasterize_hard_cuda,
        "select_points": rpc.select_points_cuda,
        "pulsar_grad": rpc.pulsar_blend_grads_cuda,
        "rasterize_fine": rc.rasterize_fragments_cuda,
        "rasterize_grad": rc.rasterize_grad_cuda,
        "knn": knn.knn_points_cuda,
        "rasterize_points": rpc.rasterize_points_cuda,
        "rasterize_points_grad": rpc.rasterize_points_grad_cuda,
        "fused_mlp": fm.fused_mlp_cuda,
        "fused_mlp_grad": fm.fused_mlp_grad_cuda,
        "nerf_field": fm.nerf_field_cuda,
        "nerf_field_grad": fm.nerf_field_grad_cuda,
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


def row_agreement(got, want, exact, width, gate):
    """Per row (a face's 9 entries, a point's 3) against the float64 plain
    version `exact`: a row agrees where its entries lie within gate * (its
    largest |exact| + the median of that over the touched rows).  The
    largest gradient of all is heavy-tailed (sliver faces), so a tolerance
    set from it alone can exceed ordinary rows' gradients.

    Returns the shares of the touched rows on which the kernel `got` and
    the float32 plain version `want` agree."""
    scale = exact.abs().reshape(-1, width).amax(dim=1)
    touched = scale > 0
    tol = gate * (scale[touched] + scale[touched].median())
    shares = []
    for g in (got, want):
        err = (g.double() - exact).abs().reshape(-1, width).amax(dim=1)[touched]
        shares.append(float((err <= tol).double().mean()))
    return tuple(shares)


def face_agreement(got, want, exact):
    """`row_agreement` per face (9 entries) at GRAD_GATE."""
    return row_agreement(got, want, exact, 9, GRAD_GATE)


def longest_list(bins, chunk=GRAD_LIST_CHUNK):
    """The longest tile list of a binning, and the passes pass 1 of a
    backward makes over it (`chunk` positions each: GRAD_LIST_CHUNK for
    #4 over `bin_faces`, POINTS_GRAD_LIST_CHUNK for #7 over `bin_points`)."""
    longest = int(bins[1].diff().max())
    return longest, max(1, -(-longest // chunk))


def compare_grad(fv, valid, size, blur, k, persp, clip, cotangents):
    """The backward kernel against its plain version on the same ids and
    cotangents (seeded random, or the headline loss's).

    Returns (finite, max |g - g_plain|, the three ratios to the largest
    gradient: kernel vs plain, kernel vs the plain version in float64,
    plain vs the plain version in float64; `face_agreement`'s two shares;
    the filled slots; the longest tile list).  The float64 plain version is the reference of the
    gate: where the float32 gradient is ill-conditioned (sums over
    Sum(bary) = 1 that cancel at sliver faces) the float32 plain version
    itself is off it by more than 1e-4 of the largest gradient.
    """
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls, rasterize_grad_plain

    idx, zbuf, bary, dists = rc.rasterize_fragments_cuda(fv, valid, size, blur, k, persp, clip, False)
    if cotangents == "random":
        gen = torch.Generator(device=fv.device).manual_seed(0)
        cots = tuple(torch.randn(t.shape, generator=gen, device=fv.device) for t in (zbuf, bary, dists))
    else:
        cots = headline_cotangents(zbuf, dists)
    bins = rc.bin_faces(fv, _face_culls(fv, valid, False), size, blur)  # the forward's binning
    got = rc.rasterize_grad_cuda(fv, idx, *cots, size, bins, persp, clip)
    torch.cuda.synchronize()
    want = rasterize_grad_plain(fv, idx, *cots, size, persp, clip)
    exact = rasterize_grad_plain(
        fv.double(), idx, *(None if c is None else c.double() for c in cots), size, persp, clip
    )
    err, ratio = grad_error(got, want)
    _, ratio_exact = grad_error(got.double(), exact)
    _, ratio_plain = grad_error(want.double(), exact)
    faces = face_agreement(got, want, exact)
    return (bool(torch.isfinite(got).all()), err, (ratio, ratio_exact, ratio_plain), faces, int((idx >= 0).sum()),
            longest_list(bins))


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


# The fused MLP kernels (#10-#13) against their plain versions.  Forward:
# within FUSED_FWD_GATE of the float32 plain version's largest |output|.
# Backward: every weight, bias and head gradient within FUSED_GRAD_GATE of
# its tensor's largest |value| against the float64 plain backward taken on
# the float32 forward's ReLU masks (the kernel sums in another order), and
# dx and d d_embed within that on >= FUSED_ROW_SHARE of the rows.  Against
# the float64 backward on its own masks, a pre-activation within float32
# noise of 0 flips a mask of every float32 evaluation alike (at the trunk
# path's 262 144 rows the float32 plain version is 2.4e-3 of the largest
# gradient off it on an H100), so there the kernel must be no further off
# than FUSED_PLAIN_FACTOR times the float32 plain version (or
# FUSED_GRAD_GATE).  The float32 forward is the kernel's saving forward,
# whose stored activations the backward kernel reads (masks y > 0): its
# tensor-core sums round otherwise than cuBLAS's float32 chain, so at these
# row counts a few dozen of the plain forward's ~5e8 pre-activations lie on
# the other side of 0 (about as many as float64 disagrees with either), and
# one flipped row moves a weight gradient by ~1 / sqrt(N) of its largest
# entry.  Both float32 evaluations flip alike but at different entries, so
# the plain backward on its own masks is no yardstick for the kernel's
# (max over tensors of one draw over another: fused_mask_study.py read it
# from 0.03 to 11 across 12 inputs on an NVIDIA H100 80GB HBM3 at 700 W, the
# kernel's masks no further from float64 than the plain forward's).  So the plain backward takes the kernel
# forward's masks, and the masks themselves are held apart: the kernel's
# forward may flip no more of them against float64 than FUSED_PLAIN_FACTOR
# times the float32 plain forward does, plus FUSED_FLIP_SLACK (counts of a
# few dozen vary by their square root from input to input).  The plain
# backward on its own masks is reported beside.
FUSED_FWD_GATE = 1e-5
FUSED_GRAD_GATE = 1e-4
FUSED_ROW_SHARE = 0.999
FUSED_PLAIN_FACTOR = 1.5
FUSED_FLIP_SLACK = 4
FUSED_GRAD_NAMES = ("wd", "bd", "wi", "bi", "wc1a", "wc1b", "bc1", "wc2", "bc2")


def saved_masks(saved, N, H, L, Hh=0):
    """The ReLU masks of a saving forward's (out, saved) as its backward
    reads them: y > 0 of each trunk layer's stored output (the trunk's last
    is out itself), then with a head (Hh) the colour layer's (the layout of
    point_saved in csrc/fused_mlp.cu)."""
    out, acts = saved
    NH = N * H
    ys = [acts[l * NH : (l + 1) * NH].view(N, H) for l in range(L if Hh else L - 1)]
    if not Hh:
        return [y > 0 for y in ys] + [out > 0]
    return [y > 0 for y in ys] + [acts[(L + 1) * NH : (L + 1) * NH + N * Hh].view(N, Hh) > 0]


def compare_fused(x, d_embed, weights, biases, head, skips, g):
    """Kernels #10/#11 (head None) or #12/#13 against the plain versions on
    the same inputs and output gradient g: the serving forward, and the
    backward on what the saving forward stored.

    Returns a dict: "fwd" (max |diff| over the plain version's largest
    |output|), "fwd_diff" (max |diff|), "same_bits" (the saving forward's
    output equals the serving one's), "grads" {name: (kernel vs float64 on
    the saving forward's masks, kernel vs float64, float32 plain on those
    masks vs float64, float32 plain on its own masks vs float64), each a
    max error over the reference's largest |value|}, "rows" {"dx"/"dde":
    share of rows within FUSED_GRAD_GATE of the float64 reference on those
    masks}, "worst" (the largest |diff| of any gradient there), "flips" (ReLU masks that disagree with float64's:
    the kernel's, the float32 plain forward's; and with each other)."""
    import torch

    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    f64 = lambda ts: [t.double() for t in ts]
    x64, ws64, bs64, g64 = x.double(), f64(weights), f64(biases), g.double()
    N, H, L = x.shape[0], weights[0].shape[1], len(weights)
    if head is None:
        got = fm.fused_mlp_cuda(x, weights, biases, skips)
        saved = fm.fused_mlp_cuda(x, weights, biases, skips, save=True)
        dx, dws, dbs = fm.fused_mlp_grad_cuda(x, weights, biases, skips, g, saved=saved)
        torch.cuda.synchronize()
        kernel = [dx, *dws, *dbs]
        want = fm.fused_mlp_plain(x, weights, biases, skips)
        masks = saved_masks(saved, N, H, L)
        plain_masks = fm.relu_masks(x, weights, biases, skips)
        exact_masks = fm.relu_masks(x64, ws64, bs64, skips)
        evals = [fm.fused_mlp_grad_plain(x, weights, biases, skips, g, masks),
                 fm.fused_mlp_grad_plain(x64, ws64, bs64, skips, g64, masks),
                 fm.fused_mlp_grad_plain(x64, ws64, bs64, skips, g64),
                 fm.fused_mlp_grad_plain(x, weights, biases, skips, g)]
        plain32, masked, exact, plain_own = ([e[0], *e[1], *e[2]] for e in evals)
        rows_names = ("dx",)
    else:
        got = fm.nerf_field_cuda(x, d_embed, weights, biases, head, skips)
        saved = fm.nerf_field_cuda(x, d_embed, weights, biases, head, skips, save=True)
        dx, dde, dws, dbs, dhead = fm.nerf_field_grad_cuda(x, d_embed, weights, biases, head, skips, g, saved=saved)
        torch.cuda.synchronize()
        kernel = [dx, dde, *dws, *dbs, *dhead]
        want = fm.fused_nerf_field_plain(x, d_embed, weights, biases, head, skips)
        masks = saved_masks(saved, N, H, L, head[4].shape[1])
        de64, head64 = d_embed.double(), f64(head)
        plain_masks = fm.relu_masks(x, weights, biases, skips, d_embed, head)
        exact_masks = fm.relu_masks(x64, ws64, bs64, skips, de64, head64)
        evals = [fm.fused_nerf_field_grad_plain(x, d_embed, weights, biases, head, skips, g, masks),
                 fm.fused_nerf_field_grad_plain(x64, de64, ws64, bs64, head64, skips, g64, masks),
                 fm.fused_nerf_field_grad_plain(x64, de64, ws64, bs64, head64, skips, g64),
                 fm.fused_nerf_field_grad_plain(x, d_embed, weights, biases, head, skips, g)]
        plain32, masked, exact, plain_own = ([e[0], e[1], *e[2], *e[3], *e[4]] for e in evals)
        rows_names = ("dx", "dde")
    fwd_diff = float((got - want).abs().max())
    names = [*rows_names, *(f"W{i}" for i in range(L)), *(f"b{i}" for i in range(L)),
             *(FUSED_GRAD_NAMES if head is not None else ())]

    def ratio(a, ref):
        return float((a.double() - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)

    def flips(a, b):
        return sum(int((u != v).sum()) for u, v in zip(a, b))

    out = {"fwd": fwd_diff / max(float(want.abs().max()), 1e-30), "fwd_diff": fwd_diff,
           "same_bits": torch.equal(got, saved[0]), "grads": {}, "rows": {}, "worst": 0.0,
           "flips": {"kernel vs float64": flips(masks, exact_masks), "float32 plain vs float64":
                     flips(plain_masks, exact_masks), "kernel vs float32 plain": flips(masks, plain_masks)}}
    for name, k, m, e, p, q in zip(names, kernel, masked, exact, plain32, plain_own):
        if name in rows_names:
            tol = FUSED_GRAD_GATE * float(m.abs().max())
            out["rows"][name] = float(((k.double() - m).abs().amax(dim=1) <= tol).double().mean())
        else:
            out["grads"][name] = (ratio(k, m), ratio(k, e), ratio(p, e), ratio(q, e))
            out["worst"] = max(out["worst"], float((k.double() - m).abs().max()))
    return out


def fused_backward_repeats(x, d_embed, weights, biases, head, skips, g):
    """Whether two backward launches on one saving forward's tensors give
    the same bits in every output (the design adds in a fixed order, with
    no atomics)."""
    import torch

    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    if head is None:
        saved = fm.fused_mlp_cuda(x, weights, biases, skips, save=True)
        runs = [fm.fused_mlp_grad_cuda(x, weights, biases, skips, g, saved=saved) for _ in range(2)]
    else:
        saved = fm.nerf_field_cuda(x, d_embed, weights, biases, head, skips, save=True)
        runs = [fm.nerf_field_grad_cuda(x, d_embed, weights, biases, head, skips, g, saved=saved) for _ in range(2)]

    def flat(out):
        return [t for part in out for t in (part if isinstance(part, (list, tuple)) else [part]) if t is not None]

    return all(torch.equal(a, b) for a, b in zip(flat(runs[0]), flat(runs[1])))


def fused_ok(result):
    grads_ok = all(
        masked <= FUSED_GRAD_GATE and exact <= max(FUSED_GRAD_GATE, FUSED_PLAIN_FACTOR * plain)
        for masked, exact, plain, _ in result["grads"].values()
    )
    flips = result["flips"]
    masks_ok = (flips["kernel vs float64"]
                <= FUSED_PLAIN_FACTOR * flips["float32 plain vs float64"] + FUSED_FLIP_SLACK)
    return (result["fwd"] <= FUSED_FWD_GATE and result["same_bits"] and grads_ok and masks_ok
            and all(s >= FUSED_ROW_SHARE for s in result["rows"].values()))


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


def device_ms_by_kernel(fn, kernels, iters=20, warmup=3, launches=1):
    """{name: device time per call} of the device kernels whose name
    contains each of `kernels`, from one torch.profiler (CUPTI) window in
    which each of them recorded `launches` launches per call of fn.  The
    profiler sometimes drops a launch's record (a 1.9 ms launch once read
    1.1 ms): a window with any other count is taken again, up to six
    windows, and then fails (KNN's two 0.02 ms launches a call lost a
    record in three windows running once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    opener = torch.zeros(1, device="cuda")
    for _ in range(6):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            # A window can lose its first launch's record (KNN's stage 1,
            # the first launch of its call, read 19 of 20 in every window):
            # open it with a launch that is not timed.
            opener.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        counts = {k: sum(e.count for e in events if k in e.key) for k in kernels}
        if all(n == iters * launches for n in counts.values()):
            return {k: sum(e.self_device_time_total for e in events if k in e.key) / 1e3 / iters for k in kernels}
        log(f"  profiler window of {iters} calls recorded {counts} launches, not {iters * launches} each: again")
    check(False, f"the profiler did not record every launch of {tuple(kernels)} in six windows")


def call_device_ms(fn, iters=20, warmup=3):
    """Device time per call of everything fn launches (kernels, copies and
    fills), from one torch.profiler (CUPTI) window: a wrapper's whole
    device work, torch ops around its kernels included."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def device_ms(fn, kernel, iters=20, warmup=3, launches=1):
    """Device time per call of the device kernels whose name contains
    `kernel` (or any of a tuple of names), each launched `launches` times
    per call, from torch.profiler (CUPTI); see device_ms_by_kernel.  For a
    launch of a few tens of microseconds, CUDA events around back-to-back
    wrapper calls measure the host's rate of issuing them (validation,
    pixel grid, ctypes) rather than the kernel."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    return sum(device_ms_by_kernel(fn, names, iters, warmup, launches).values())


def fine_ops_per_candidate(persp, clip):
    """fp32 operations per (pixel, face) test of the fine kernel, counting
    only the per-pixel work (per-face terms amortize over the tile):
    3 edge functions (18), the inside test (3), pz (5), 3 segment distances
    and their min (56), the cover test (5), the signed distance (1) = 88;
    perspective correction +10, clipping +10.  A division or reciprocal
    counts as one operation, which understates its cost, so the bound stays
    a lower one."""
    return 88 + (10 if persp else 0) + (10 if clip else 0)


def tile_candidates(tile_start, N, n_ty, n_tx, size):
    """The (pixel, item) tests that CSR tile lists ask for: each tile's list
    length times the tile's live pixels, summed."""
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import TILE

    H, W = size
    TH, TW = TILE
    per_tile = (tile_start[1:] - tile_start[:-1]).cpu().double().reshape(N, n_ty, n_tx)
    rows = [min(TH, H - TH * t) for t in range(n_ty)]
    cols = [min(TW, W - TW * t) for t in range(n_tx)]
    pix = [[r * c for c in cols] for r in rows]  # live pixels of each tile
    return float((per_tile * per_tile.new_tensor(pix)).sum())


def face_pixel_boxes(face_verts, image_size, blur_radius, perspective_correct):
    """(N * F, 4) int32 pixel boxes (first row, last row, first column,
    last column) of the fine kernel's cull for (N, F, 3, 3) `face_verts`.
    The kernel (csrc/rasterize_fine.cu) makes them for itself by the same
    float ops and comparisons; here they are the reference for
    `fine_tests` and the CPU tests: the pixels whose center lies in the
    face's `rasterize_cuda.face_boxes` box, found by a search over the
    pixel centers (first > last where none does, as where a bound is NaN:
    such a face covers nothing).  The binning's tiles hold them: it is the binning
    at one-pixel tiles without the binning's rounding slack.  Under
    perspective correction a face with a vertex at z < 0 can cover pixels
    far outside its box (the kernel's header says where), so its box is
    the whole image."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import face_boxes, pixel_grid_ndc

    H, W = image_size
    xmin, xmax, ymin, ymax = face_boxes(face_verts, image_size, blur_radius)
    ys, xs = pixel_grid_ndc(H, W, face_verts.device)
    bounds = []
    for lo, hi, centers in ((ymin, ymax, ys), (xmin, xmax, xs)):
        # Centers fall as the index grows: the first pixel inside is the
        # count of centers above hi, the last one below the count of those
        # at or above lo.
        n, rising = centers.numel(), centers.flip(0)
        bounds += [n - torch.searchsorted(rising, hi, right=True, out_int32=True),
                   (n - 1) - torch.searchsorted(rising, lo, out_int32=True)]
    boxes = torch.stack(bounds, dim=-1)
    if perspective_correct:
        behind = face_verts[..., 2].amin(-1) < 0
        boxes = torch.where(behind[..., None], boxes.new_tensor([0, H - 1, 0, W - 1]), boxes)
    return boxes.view(-1, 4)


def fine_tests(bins, boxes, N, F, size):
    """(the (pixel, face) tests the fine kernel makes, the lanes its warps
    walk): per (tile, face) pair of the binning, the tile's pixels inside
    the face's pixel box (`face_pixel_boxes`), and 32 lanes for each warp
    rectangle of the tile (FINE_RECT rows x columns) that the box meets."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import TILE

    tile_faces, tile_start, n_ty, n_tx = bins
    H, W = size
    TH, TW = TILE
    RH, RW = FINE_RECT
    tiles = tile_start.numel() - 1
    tile = torch.repeat_interleave(torch.arange(tiles, device=tile_faces.device), tile_start.diff().long())
    t = tile % (n_ty * n_tx)
    r0, c0 = (t // n_tx) * TH, (t % n_tx) * TW
    b = boxes.view(N, F, 4).long()[tile // (n_ty * n_tx), tile_faces.long()]
    rows = (torch.minimum(b[:, 1], (r0 + TH - 1).clamp(max=H - 1)) - torch.maximum(b[:, 0], r0) + 1).clamp(min=0)
    cols = (torch.minimum(b[:, 3], (c0 + TW - 1).clamp(max=W - 1)) - torch.maximum(b[:, 2], c0) + 1).clamp(min=0)
    lanes = 0
    for dr in range(0, TH, RH):
        for dc in range(0, TW, RW):
            meets = ((b[:, 0] <= b[:, 1]) & (b[:, 2] <= b[:, 3]) & (b[:, 0] < r0 + dr + RH)
                     & (b[:, 1] >= r0 + dr) & (b[:, 2] < c0 + dc + RW) & (b[:, 3] >= c0 + dc))
            lanes += 32 * int(meets.sum())
    return float((rows * cols).double().sum()), float(lanes)


def point_pixel_boxes(points, radius, image_size):
    """(N * P, 4) int32 pixel boxes (first row, last row, first column,
    last column) of the points kernel's cull for (N, P, 3) NDC `points`
    and (N, P) `radius`: on each axis the pixel centres c whose own test
    fl(c - v)^2 < fl(r * r) passes (first > last where none does).  The
    kernel (csrc/rasterize_points.cu) tests the 16 centres of each tile
    for itself; here a binary search finds the same run over the image.
    The centres fall as the index grows, so fl(c - v) does not rise and
    fl(d * d) does not fall as |d| grows: the passing centres are one run,
    from the count of leading centres with !(d <= 0 or d * d < r2) to one
    short of the count of those with d >= 0 or d * d < r2.  Those counts
    hold the centre at d == 0 where no centre can pass, r2 <= 0 or NaN:
    such a box is emptied."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import pixel_grid_ndc

    ys, xs = pixel_grid_ndc(*image_size, points.device)
    r2 = (radius * radius).reshape(-1)
    bounds = []
    for centres, v in ((ys, points[..., 1].reshape(-1)), (xs, points[..., 0].reshape(-1))):
        n = centres.numel()

        def leading(pred):
            pos = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
            step = 1 << (n.bit_length() - 1)
            while step:
                d = centres[(pos + step - 1).clamp(max=n - 1)] - v
                pos = torch.where((pos + step <= n) & pred(d), pos + step, pos)
                step >>= 1
            return pos

        bounds += [leading(lambda d: ~((d <= 0) | (d * d < r2))), leading(lambda d: (d >= 0) | (d * d < r2)) - 1]
    boxes = torch.stack(bounds, dim=-1)
    return torch.where((r2 > 0)[:, None], boxes, boxes.new_tensor([0, -1, 0, -1])).int()


def points_tests(points, radius, bins, size):
    """(the (pixel, point) pairs in the points' boxes, the lanes the
    points kernel's warps walk, each of which tests) over `bin_points`'
    binning: `fine_tests` with `point_pixel_boxes`."""
    N, P = points.shape[:2]
    return fine_tests(bins, point_pixel_boxes(points, radius, size), N, P, size)


def fine_bucket(k):
    """The K bucket of csrc/rasterize_fine.cu's template that runs K."""
    return next(b for b in (1, 2, 4, 8, 16, 32, 64) if k <= b)


def fine_bound(fv, valid, bins, size, blur, k, persp, clip):
    """Least time for this run's work: max(bytes / HBM rate, ops / fp32 rate).

    Bytes: face verts, the tile lists and pixel coordinates read once; the
    four outputs (int32 id, z, 3 bary, dist = 24 B per slot) written once.
    Ops: the (pixel, face) tests the function needs, `face_box_tests` (the
    pixel centres inside each face's blur-grown box), times the ops per
    test; the kernel makes `tile_candidates` tests, more than that.
    """
    tile_faces, tile_start, n_ty, n_tx = bins
    N, F = fv.shape[:2]
    H, W = size
    tests = face_box_tests(fv, valid, size, blur)
    bytes_moved = (
        N * F * 36 + tile_faces.numel() * 4 + tile_start.numel() * 4 + (H + W) * 4
        + N * H * W * k * 24
    )
    ops = tests * fine_ops_per_candidate(persp, clip)
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), tests, bytes_moved


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
    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc

    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        built = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    log(f"build: {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s wall")
    for name, (seconds, text) in built.items():
        log(f"build: {name} {seconds:.2f} s")
        for kernel, figures in ptxas_figures(text).items():
            log(f"  ptxas {name}: {kernel}: {figures}")
    rc._library()  # loads it and checks its tile against the binning's
    rc._grad_library()
    knn._library()
    rpc._library()  # checks its tile too
    rpc._grad_library()
    fm._library()
    rc._hard_library()
    rpc._pulsar_grad_library()


def ptxas_figures(text):
    """{kernel: "R registers, S bytes smem, spill stores / loads[, notes]"}
    from nvcc -Xptxas=-v output (mangled names shortened to their base name
    and template arguments).  Notes count ptxas's performance remarks on a
    kernel by code: C7510-C7515 serialize its wgmma, C7517 / C7519 add
    waits or fences around it."""
    import re

    def short(mangled):
        base = re.match(r"_Z(\d+)", mangled)
        if not base:
            return mangled
        n = int(base.group(1))
        body = mangled[len(base.group(0)):]
        name, rest = body[:n], body[n:]
        args = re.findall(r"Lb([01])E", rest)
        return name + (f"<{', '.join('true' if a == '1' else 'false' for a in args)}>" if args else "")

    out, current = {}, None
    for line in text.splitlines():
        note = re.search(r"\((C75\d\d)\).*function '(_Z\w+)'", line)
        if note:
            notes = out.setdefault(short(note.group(2)), {}).setdefault("notes", {})
            notes[note.group(1)] = notes.get(note.group(1), 0) + 1
            continue
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)'?", line)
        if m:
            current = short(m.group(1))
            out.setdefault(current, {})
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[current]["spill"] = f"{spill.group(1)} / {spill.group(2)} bytes spilled"
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[current]["registers"] = f"{regs.group(1)} registers"
            smem = re.search(r"(\d+) bytes smem", line)
            out[current]["smem"] = f"{smem.group(1) if smem else 0} bytes static smem"
    for v in out.values():
        if "notes" in v:
            v["notes"] = "ptxas notes " + ", ".join(f"{k} x{n}" for k, n in sorted(v["notes"].items()))
    return {k: ", ".join(v[f] for f in ("registers", "smem", "spill", "notes") if f in v) for k, v in out.items()}


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


def grad_path_inputs(device, fit):
    """The backward's inputs at its two path shapes, each with the forward's
    binning: the render-fit step's own cotangents (8 views of 512^2, K=16)
    and the headline loss's (ico4, K=8).

    Returns [(label, fv, idx, cotangents, persp, clip, bins)]; the ids are
    the fine kernel's on those bins (the render-fit ones equal the
    renderer's own, which is logged)."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls
    from pytorch3d_tpu_torch.utils import ico_sphere

    size = (IMAGE, IMAGE)
    mesh = fit.mesh().extend(FIT_VIEWS)
    soft, cams = fit.soft_renderer(FIT_VIEWS)
    fragments = soft.rasterizer(mesh, cameras=cams)
    loss = fit.loss(soft.shader(fragments, mesh, cameras=cams), fit.mesh(), FIT_VIEWS)
    cots = tuple(c.contiguous() for c in torch.autograd.grad(
        loss, [fragments.zbuf, fragments.bary_coords, fragments.dists]))
    fv_fit, valid_fit = face_inputs(mesh, cams, size)
    F = fv_fit.shape[1]
    bins_fit = rc.bin_faces(fv_fit, _face_culls(fv_fit, valid_fit, False), size, FIT_BLUR)
    idx_fit = rc._run_kernel(fv_fit, bins_fit, size, FIT_BLUR, FIT_K, True, True)[0]
    offsets = (torch.arange(FIT_VIEWS, device=device) * F)[:, None, None, None]
    renderer_ids = torch.where(fragments.pix_to_face >= 0, fragments.pix_to_face - offsets, -1)
    log(f"  render-fit backward inputs: the fine kernel's ids equal the renderer's on"
        f" {float((idx_fit == renderer_ids).float().mean()):.6f} of slots")
    fv_h, valid_h = face_inputs(ico_sphere(4, device=device), camera(30.0, device), size)
    bins_h = rc.bin_faces(fv_h, _face_culls(fv_h, valid_h, False), size, BLUR)
    idx_h, zbuf_h, _, dists_h = rc._run_kernel(fv_h, bins_h, size, BLUR, K, False, False)
    return [
        (f"render-fit step: N={FIT_VIEWS} F={F} {IMAGE}^2 K={FIT_K}", fv_fit, idx_fit, cots, True, True, bins_fit),
        (f"headline: N=1 F={fv_h.shape[1]} {IMAGE}^2 K={K}", fv_h, idx_h, headline_cotangents(zbuf_h, dists_h),
         False, False, bins_h),
    ]


def ico_grad_inputs(device, level, side, blur, k, persp, clip):
    """The backward's inputs for ico_sphere(level) at side^2 (camera at
    azimuth 30): (fv, idx, seeded random cotangents, the forward's
    binning)."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls
    from pytorch3d_tpu_torch.utils import ico_sphere

    size = (side, side)
    fv, valid = face_inputs(ico_sphere(level, device=device), camera(30.0, device), size)
    bins = rc.bin_faces(fv, _face_culls(fv, valid, False), size, blur)
    idx, zbuf, bary, dists = rc._run_kernel(fv, bins, size, blur, k, persp, clip)
    gen = torch.Generator(device=device).manual_seed(level)
    cots = tuple(torch.randn(t.shape, generator=gen, device=device) for t in (zbuf, bary, dists))
    return fv, idx, cots, bins


# Where tile lists run far past GRAD_LIST_CHUNK, so that pass 1 makes many
# passes over one tile: (label, ico level, image side, blur, K, persp, clip).
# The large blur runs without perspective correction and clipping (bench.py's
# settings): with them, at blur 2e-2, a few ill-conditioned faces put the
# float32 plain version itself at the face-share gate (grad_study.py
# --conditioning reads both).
LONG_LIST_CASES = (("dense mesh", 5, 64, BLUR, 8, True, True), ("large blur", 4, 128, 2e-2, 16, False, False))


def long_list_inputs(device):
    """[(label, fv, idx, cotangents, persp, clip, bins)] of LONG_LIST_CASES,
    as `grad_path_inputs` returns its shapes."""
    out = []
    for label, level, side, blur, k, persp, clip in LONG_LIST_CASES:
        fv, idx, cots, bins = ico_grad_inputs(device, level, side, blur, k, persp, clip)
        out.append((f"{label}: N=1 F={fv.shape[1]} {side}^2 K={k} blur={blur:g}", fv, idx, cots, persp, clip, bins))
    return out


def phase_grad_kernel(device):
    """The backward kernel against its plain version at the serving batch
    and the headline ico4, with seeded random cotangents and with the
    headline loss's; then, at the render-fit and headline shapes with their
    own cotangents and at two shapes whose tile lists take many passes,
    twice on the same inputs, which must give the same bits, and against
    float64.  Every case runs on the forward's own binning."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import rasterize_grad_plain
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
            finite, err, (ratio, ratio_exact, ratio_plain), faces, filled, (longest, passes) = compare_grad(
                fv, valid, size, BLUR, K, persp, clip, cotangents
            )
            kernel_share, plain_share = faces
            ok = (finite and ratio_exact <= max(GRAD_GATE, GRAD_PLAIN_FACTOR * ratio_plain)
                  and kernel_share >= GRAD_FACE_SHARE)
            worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio_exact)
            log(f"kernel rasterize_grad vs plain [{label}, {cotangents} cotangents] N={fv.shape[0]}"
                f" F={fv.shape[1]} {IMAGE}^2 K={K} persp={persp} clip={clip}: filled slots {filled},"
                f" longest tile list {longest} ({passes} pass(es) of pass 1),"
                f" max|diff| {err:.3e} = {ratio:.3e} of max|grad|; vs the float64 plain version:"
                f" kernel {ratio_exact:.3e}, float32 plain version {ratio_plain:.3e} of max|grad|;"
                f" faces within {GRAD_GATE:g} of their own scale: kernel {kernel_share:.6f},"
                f" float32 plain version {plain_share:.6f} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{label}/{cotangents}")
    # Deterministic: two launches on the same inputs give the same bits, at
    # both path shapes and where tile lists take many passes of pass 1.
    long_lists = long_list_inputs(device)
    for label, fv, idx, cots, persp, clip, bins in grad_path_inputs(device, RenderFit(device)) + long_lists:
        size_i = tuple(idx.shape[1:3])
        first = rc.rasterize_grad_cuda(fv, idx, *cots, size_i, bins, persp, clip)
        second = rc.rasterize_grad_cuda(fv, idx, *cots, size_i, bins, persp, clip)
        same = torch.equal(first.view(torch.int32), second.view(torch.int32))
        want = rasterize_grad_plain(fv, idx, *cots, size_i, persp, clip)
        exact = rasterize_grad_plain(fv.double(), idx, *(None if c is None else c.double() for c in cots),
                                     size_i, persp, clip)
        _, ratio_exact = grad_error(first.double(), exact)
        _, ratio_plain = grad_error(want.double(), exact)
        kernel_share, plain_share = face_agreement(first, want, exact)
        longest, passes = longest_list(bins)
        many = int((bins[1].diff() > GRAD_LIST_CHUNK).sum())
        ok = (same and bool(torch.isfinite(first).all())
              and ratio_exact <= max(GRAD_GATE, GRAD_PLAIN_FACTOR * ratio_plain) and kernel_share >= GRAD_FACE_SHARE)
        if any(label == case[0] for case in long_lists):  # the case must drive the many-pass path
            ok = ok and passes >= 3
        worst_ratio = max(worst_ratio, ratio_exact)
        log(f"kernel rasterize_grad [{label}, persp={persp} clip={clip}]: longest tile list {longest}"
            f" ({passes} pass(es) of pass 1; {many} of {bins[1].numel() - 1} tiles over {GRAD_LIST_CHUNK});"
            f" filled slots {int((idx >= 0).sum())}; two launches bit-equal {same}; vs the float64 plain version:"
            f" kernel {ratio_exact:.3e}, float32 plain version {ratio_plain:.3e} of max|grad|; faces within"
            f" {GRAD_GATE:g}: kernel {kernel_share:.6f}, float32 plain version {plain_share:.6f}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{label}/bit-equal twice")
    torch.cuda.empty_cache()
    log(f"kernel rasterize_grad: worst ratio to the float64 plain version {worst_ratio:.3e}"
        f" (gate max({GRAD_GATE:g}, {GRAD_PLAIN_FACTOR:g} x the float32 plain version's), and"
        f" >= {GRAD_FACE_SHARE:g} of the faces within {GRAD_GATE:g} x (the face's largest |g|"
        f" + the median of that))")
    check(not failed, f"backward kernel disagrees with its plain version: {failed}")
    return worst_err


def points_fit_clouds(pfit):
    """The points fit's two KNN calls' clouds: its 30 000 points and the
    served scene's 30 000, each way round."""
    src = pfit.cloud().points_padded().detach().contiguous()
    tgt = pfit.target.points_padded().contiguous()
    return src, tgt


def knn_cut(p1, p2, k):
    """(S, L) the wrapper plans for these clouds on this card."""
    from pytorch3d_tpu_torch.ops import knn

    return knn.kernel_ranges(p1.shape[0], p1.shape[1], p2.shape[1], k, p1.device)


def range_tie_clouds(device):
    """A database whose points repeat across range boundaries: point i + L
    is point i (L the planned range length), and half the queries sit on
    database points, so each of those has two points at distance 0 in
    neighbouring ranges and the lower id must win."""
    import torch

    from pytorch3d_tpu_torch.ops import knn

    N, P1, P2 = 1, 4096, 20_000
    S, L = knn.kernel_ranges(N, P1, P2, 4, device)
    gen = torch.Generator(device=device).manual_seed(2)
    p2 = torch.rand((N, P2, 3), generator=gen, device=device)
    p2[:, L:] = p2[:, : P2 - L].clone()
    p2 = p2.contiguous()
    p1 = torch.rand((N, P1, 3), generator=gen, device=device)
    pick = torch.randint(0, P2, (P1 // 2,), generator=gen, device=device)
    p1[:, : P1 // 2] = p2[:, pick]
    return p1.contiguous(), p2, S


def phase_knn_kernel(device, pfit):
    """The KNN kernel against its plain version at the chamfer fit's clouds,
    the points fit's clouds (30 000 x 30 000), 16384 x 16384 at K=16 with and
    without lengths2, ties across range boundaries, a database shorter than
    one range with K = P2, and D = 8 at norm 1."""
    import torch

    src, tgt = chamfer_clouds(device)
    psrc, ptgt = points_fit_clouds(pfit)
    gen = torch.Generator(device=device).manual_seed(1)
    big1 = torch.rand((2, 16384, 3), generator=gen, device=device)
    big2 = torch.rand((2, 16384, 3), generator=gen, device=device)
    tie1, tie2, tie_ranges = range_tie_clouds(device)
    check(tie_ranges > 1, f"the tie case cuts its database into {tie_ranges} range(s), not several")
    wide1 = torch.rand((1, 5000, 8), generator=gen, device=device)
    wide2 = torch.rand((1, 20_000, 8), generator=gen, device=device)
    cases = [
        # label, p1, p2, lengths2, K, norm
        ("chamfer 5000x5000", src, tgt, None, 1, 2),
        ("chamfer 5000x5000 reverse", tgt, src, None, 1, 2),
        ("points-fit 30000x30000", psrc, ptgt, None, 1, 2),
        ("points-fit 30000x30000 reverse", ptgt, psrc, None, 1, 2),
        ("16384x16384 K=16", big1[:1].contiguous(), big2[:1].contiguous(), None, 16, 2),
        ("16384x16384 K=16 lengths2 [16384, 9000]", big1, big2,
         torch.tensor([16384, 9000], device=device), 16, 2),
        ("ties across ranges K=1", tie1, tie2, None, 1, 2),
        ("ties across ranges K=4", tie1, tie2, None, 4, 2),
        ("P2=12 shorter than a range, K=P2", src, tgt[:, :12].contiguous(), None, 12, 2),
        ("D=8 norm 1 5000x20000 K=8", wide1, wide2, None, 8, 1),
    ]
    worst, failed = 0.0, []
    for label, p1, p2, l2, k, norm in cases:
        frac, err, rel, both_empty = compare_knn(p1, p2, l2, k, norm)
        ok = frac >= KNN_IDS_GATE and rel <= KNN_DISTS_RTOL and both_empty
        worst = max(worst, err)
        S, L = knn_cut(p1, p2, k)
        log(f"kernel knn vs plain [{label}] N={p1.shape[0]} K={k} norm={norm}: {S} range(s) of {L} points"
            f" ({1 if S == 1 else 2} launches a call); queries with equal ids {frac:.6f},"
            f" max|diff| dists {err:.3e} (relative {rel:.3e}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    check(not failed, f"KNN kernel disagrees with its plain version: {failed}")
    return worst


def knn_device_ms(p1, p2, k):
    """{stage: device time per call} of one knn_points_cuda call (profiler):
    stage 1 and, where the database is cut into several ranges, the merge."""
    from pytorch3d_tpu_torch.ops import knn

    S, _ = knn_cut(p1, p2, k)
    names = ("knn_ranges_kernel",) + (("knn_merge_kernel",) if S > 1 else ())
    return device_ms_by_kernel(lambda: knn.knn_points_cuda(p1, p2, None, k), names)


def knn_times(device, pfit):
    """#9 at its paths' shapes (the chamfer fit's 5000 x 5000, the points
    fit's 30 000 x 30 000, and 16384 x 16384 at K=16): device time split into
    stage 1 and merge, CUDA events over back-to-back calls, the plain
    version, the library yardstick and the bound."""
    import torch

    from pytorch3d_tpu_torch.ops import knn

    src, tgt = chamfer_clouds(device)
    psrc, ptgt = points_fit_clouds(pfit)
    gen = torch.Generator(device=device).manual_seed(1)
    big1 = torch.rand((1, 16384, 3), generator=gen, device=device)
    big2 = torch.rand((1, 16384, 3), generator=gen, device=device)
    knns = {}
    for label, p1, p2, k in (("chamfer 5000x5000 K=1", src, tgt, 1), ("points-fit 30000x30000 K=1", psrc, ptgt, 1),
                             ("16384x16384 K=16", big1, big2, 16)):
        stages = knn_device_ms(p1, p2, k)
        kernel = sum(stages.values())
        events = cuda_ms(lambda: knn.knn_points_cuda(p1, p2, None, k), iters=50, warmup=5)
        plain = cuda_ms(lambda: knn.knn_points_plain(p1, p2, None, k), iters=3, warmup=1)
        # The yardstick is two library calls, cdist then topk; the port calls neither.
        library = cuda_ms(lambda: torch.topk(torch.cdist(p1, p2), k, dim=-1, largest=False), iters=20, warmup=3)
        bound, bound_by, pairs = knn_bound(p1, p2, k)
        S, L = knn_cut(p1, p2, k)
        merge = stages.get("knn_merge_kernel", 0.0)
        knns[label] = dict(kernel=kernel, plain=plain, library=library, bound=bound, bound_by=bound_by)
        log(f"times [knn, {label}] kernel {kernel:.4f} ms (device time, profiler: {len(stages)} launches a call,"
            f" {S} range(s) of {L} points; stage 1 {stages['knn_ranges_kernel']:.4f} ms, merge {merge:.4f} ms ="
            f" {merge / kernel:.3f} of it; CUDA events over back-to-back wrapper calls {events:.4f} ms),"
            f" plain version {plain:.3f} ms, library yardstick (torch.cdist + torch.topk, two calls)"
            f" {library:.4f} ms; bound {bound:.5f} ms by {bound_by} ({pairs / 1e6:.1f} M pairs)")
    return knns


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


def phase_times(device, meshes, renderers, fit, pfit):
    """Each kernel's time, its plain version's time and its bound at the
    shape of its path; the serving frame; profiles."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls, rasterize_grad_plain
    from pytorch3d_tpu_torch.utils import ico_sphere

    size = (IMAGE, IMAGE)
    out = {}
    fit_mesh = fit.mesh().extend(FIT_VIEWS)
    shapes = (
        # label, meshes, cameras, blur, K; the plain version is timed at the first two
        ("main path batch", meshes, camera(30.0, device), BLUR, K),
        ("headline ico4", ico_sphere(4, device=device), camera(30.0, device), BLUR, K),
        ("render-fit", fit_mesh, fit.soft_renderer(FIT_VIEWS)[1], FIT_BLUR, FIT_K),
    )
    for label, m, cams, blur, k in shapes:
        with torch.no_grad():
            fv, valid = face_inputs(m, cams, size)
        ok = _face_culls(fv, valid, False)
        bins = rc.bin_faces(fv, ok, size, blur)
        kernel = device_ms(lambda: rc._run_kernel(fv, bins, size, blur, k, True, True),
                           f"rasterize_fine_kernel<{fine_bucket(k)}, false>", iters=20, warmup=5)
        events = cuda_ms(lambda: rc._run_kernel(fv, bins, size, blur, k, True, True), iters=50, warmup=5)
        binning = cuda_ms(lambda: rc.bin_faces(fv, ok, size, blur), iters=20)
        plain = None
        if label != "render-fit":
            with torch.no_grad():
                plain = cuda_ms(
                    lambda: rc.rasterize_fragments_plain(fv, valid, size, blur, k, True, True, False),
                    iters=3, warmup=1,
                )
        bound, bound_by, tests, nbytes = fine_bound(fv, valid, bins, size, blur, k, True, True)
        made, walked = fine_tests(bins, face_pixel_boxes(fv, size, blur, True), *fv.shape[:2], size)
        out[label] = dict(kernel=kernel, binning=binning, plain=plain, bound=bound, bound_by=bound_by)
        log(f"times [rasterize_fine, {label}] N={fv.shape[0]} F={fv.shape[1]} {IMAGE}^2 K={k} blur={blur:g}:"
            f" kernel {kernel:.4f} ms (device time, profiler; CUDA events over back-to-back wrapper calls"
            f" {events:.4f} ms), binning {binning:.4f} ms, plain version"
            f" {'not timed' if plain is None else f'{plain:.2f} ms'}; bound {bound:.4f} ms by {bound_by}"
            f" (bytes {nbytes / 1e6:.1f} MB = {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms,"
            f" {tests / 1e6:.3f} M box tests ="
            f" {tests * fine_ops_per_candidate(True, True) / PEAK_FP32_OPS_PER_S * 1e3:.4f} ms); tests made"
            f" {made / 1e6:.3f} M in {walked / 1e6:.3f} M warp lanes walked, against"
            f" {tile_candidates(bins[1], fv.shape[0], bins[2], bins[3], size) / 1e6:.3f} M (pixel, face) pairs of"
            f" the {len(bins[0])} tile-face pairs")

    # The backward kernel on the render-fit step's own ids and cotangents,
    # and on the headline loss's, on the forward's binning.
    grads = {}
    for label, fv, idx, c, persp, clip, bins in grad_path_inputs(device, fit):
        stages = device_ms_by_kernel(lambda: rc.rasterize_grad_cuda(fv, idx, *c, size, bins, persp, clip), GRAD_KERNELS)
        kernel = sum(stages.values())
        events = cuda_ms(lambda: rc.rasterize_grad_cuda(fv, idx, *c, size, bins, persp, clip), iters=20, warmup=3)
        plain = cuda_ms(lambda: rasterize_grad_plain(fv, idx, *c, size, persp, clip), iters=2, warmup=1)
        bound, bound_by, filled, nbytes = grad_bound(fv, idx, c, persp, clip)
        grads[label] = dict(kernel=kernel, plain=plain, bound=bound, bound_by=bound_by)
        tiles_ms, faces_ms = (stages[k] for k in GRAD_KERNELS)
        log(f"times [rasterize_grad, {label}] kernel {kernel:.4f} ms (device time, profiler: 2 launches a call,"
            f" {len(bins[0])} tile-face pairs; pass 1 {tiles_ms:.4f} ms, pass 2 {faces_ms:.4f} ms ="
            f" {faces_ms / kernel:.3f} of it; CUDA events over back-to-back wrapper calls, the pair CSR's"
            f" torch ops and the error flag's host sync included, {events:.4f} ms), plain version {plain:.2f} ms;"
            f" bound {bound:.4f} ms by {bound_by} (bytes {nbytes / 1e6:.1f} MB ="
            f" {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms, {filled / 1e6:.3f} M filled slots ="
            f" {filled * grad_ops_per_slot(persp, clip) / PEAK_FP32_OPS_PER_S * 1e3:.4f} ms)")
    torch.cuda.empty_cache()

    knns = knn_times(device, pfit)

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
    return out["main path batch"], next(iter(grads.values())), knns["chamfer 5000x5000 K=1"]


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


# --------------------------------------------------------------------------- #
# Point rendering
# --------------------------------------------------------------------------- #


def colored_points_scene(device):
    """examples/render_colored_points.py:29-38: 30 000 points sampled from
    torus(0.35, 1.0, 48, 96) with rgb from position, as one Pointclouds, and
    FoVOrthographicCameras at dist 3, elev 25, znear 0.01 for the 8
    requests' azimuths."""
    import torch

    from pytorch3d_tpu_torch.ops import sample_points_from_meshes
    from pytorch3d_tpu_torch.renderer import FoVOrthographicCameras, look_at_view_transform
    from pytorch3d_tpu_torch.structures import Pointclouds
    from pytorch3d_tpu_torch.utils import torus

    gen = torch.Generator(device=device).manual_seed(0)
    pts = sample_points_from_meshes(torus(0.35, 1.0, 48, 96, device=device), PTS_SAMPLES, generator=gen)[0]
    rgb = (pts - pts.amin(0)) / (pts.amax(0) - pts.amin(0))
    cloud = Pointclouds.create(pts[None], features=rgb[None], device=device)
    azim = torch.tensor(PTS_AZIMUTHS, device=device)
    R, T = look_at_view_transform(dist=3.0, elev=25.0, azim=azim, device=device)
    return cloud, FoVOrthographicCameras.create(R=R, T=T, znear=0.01, device=device)


def points_renderer(cams, compositor, bin_size=None):
    from pytorch3d_tpu_torch.renderer import PointsRasterizationSettings, PointsRasterizer, PointsRenderer

    settings = PointsRasterizationSettings(
        image_size=PTS_IMAGE, radius=PTS_RADIUS, points_per_pixel=PTS_K, bin_size=bin_size
    )
    return PointsRenderer(PointsRasterizer(cams, settings), compositor)


def bench_points(device, n=BENCH_POINTS):
    """benchmarks/bm_points_knn_nerf.py:17-39's inputs: xy uniform in
    [-0.9, 0.9], z in [1, 4], from np.random.RandomState(0); (1, n, 3)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(1.0, 4.0, (n, 1))], axis=1)
    return torch.tensor(pts[None], dtype=torch.float32, device=device)


def uniform_radius(points, r):
    """A radius r for every point and an all-true valid mask."""
    import torch

    shape = points.shape[:2]
    return torch.full(shape, r, device=points.device), torch.ones(shape, dtype=torch.bool, device=points.device)


def served_points_ndc(device):
    """What PointsRasterizer hands the rasterizer on the points-serving
    path: the cloud extended to the 8 requests, in NDC xy + view z."""
    from pytorch3d_tpu_torch.renderer import PointsRasterizer

    cloud, cams = colored_points_scene(device)
    return PointsRasterizer(cams).transform(cloud.extend(PTS_REQUESTS)).points_padded().contiguous()


def hetero_points(device):
    """Three clouds of 40 000, 25 000 and 5 000 live points (padding past
    the counts), per-point radius in [0.002, 0.03], some behind the camera."""
    import torch

    gen = torch.Generator(device=device).manual_seed(2)
    pts = torch.rand((3, 40_000, 3), generator=gen, device=device) * 2.4 - 1.2
    pts[..., 2] = pts[..., 2].abs() * 2.0 - 0.2
    radius = torch.rand((3, 40_000), generator=gen, device=device) * 0.028 + 0.002
    valid = torch.arange(40_000, device=device)[None] < torch.tensor([40_000, 25_000, 5_000], device=device)[:, None]
    return pts, radius, valid


CULL_EDGE_IMAGE = (120, 200)  # neither side a multiple of the 16-pixel tile


def cull_edge_points(size, seed, n):
    """Points on the edges of the points kernel's pixel-box cull for an
    (H, W) image, as numpy float32 (points (P, 3) NDC xy + view z, radius
    (P,)) and a bool valid mask (P,), from np.random.default_rng(seed), in
    a shuffled order, about n of each kind:
    - a centre on a pixel centre with x +- r or y +- r exactly on another
      pixel centre (the strict test fails there and the box ends there);
    - radius 0, and negative radii (a disc of |r|);
    - radii covering a whole tile (17 pixels) and several tiles (40);
    - centres on the borders of warp rectangles and tiles (between
      columns 7 | 8 and 15 | 16 of a tile, rows 3 | 4, 7 | 8 and 15 | 16);
    - centres off the image whose discs reach into it;
    z in quarter steps (ties in z meet the cull), 5 % behind the camera,
    5 % not valid."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import pixel_grid_ndc

    H, W = size
    ys, xs = (t.numpy() for t in pixel_grid_ndc(H, W, torch.device("cpu")))
    rng = np.random.default_rng(seed)
    pitch = np.float32(xs[0] - xs[1])
    u = lambda lo, hi, m=n: rng.uniform(lo, hi, m).astype(np.float32)  # noqa: E731
    parts = []
    for centres, other, m in ((xs, ys, W), (ys, xs, H)):  # exact ends along x, then along y
        c, k = rng.integers(0, m - 3, 8 * n), rng.integers(1, 4, 8 * n)
        r = (centres[c] - centres[c + k]).astype(np.float32)
        exact = (centres[c + k] - centres[c]) == -r  # fl(c' - v) is -r exactly: d * d == r * r
        on, rr = centres[c][exact][:n], (r * rng.choice(np.float32([-1.0, 1.0]), r.shape))[exact][:n]
        off = other[rng.integers(0, other.size, on.size)]
        parts.append((on, off, rr) if centres is xs else (off, on, rr))
    xr, yr = u(xs[-1], xs[0]), u(ys[-1], ys[0])
    parts.append((xr, yr, np.where(rng.random(n) < 0.5, 0.0, -u(0.5, 3.0) * pitch).astype(np.float32)))
    m = max(n // 8, 1)
    parts.append((u(xs[-1], xs[0], m), u(ys[-1], ys[0], m), np.where(rng.random(m) < 0.5, 17, 40) * pitch))
    cols = np.array([c for c in range(W - 1) if c % 16 in (7, 15)])
    rows = np.array([r for r in range(H - 1) if r % 16 in (3, 7, 15)])
    c, r = cols[rng.integers(0, cols.size, n)], rows[rng.integers(0, rows.size, n)]
    parts.append(((xs[c] + xs[c + 1]) / 2, (ys[r] + ys[r + 1]) / 2, u(0.4, 1.6) * pitch))
    side = rng.choice(np.float32([-1.0, 1.0]), n)
    parts.append((side * (xs[0] + u(0.0, 3.0) * pitch), u(ys[-1], ys[0]), u(1.0, 4.0) * pitch))
    x, y, r = (np.concatenate([p[i] for p in parts]).astype(np.float32) for i in range(3))
    P = x.size
    z = (rng.integers(2, 12, P) * 0.25).astype(np.float32)
    z[rng.random(P) < 0.05] *= -1.0
    order = rng.permutation(P)
    return np.stack([x, y, z], -1)[order], r[order], (rng.random(P) >= 0.05)[order]


def cull_edge_batch(device, size=CULL_EDGE_IMAGE, n=None):
    """Two clouds of `cull_edge_points` (seeds 0 and 1, n of each kind, by
    default one for 60 pixels; padded to one P with points that are not
    valid) as (N, P, 3), (N, P) and (N, P) tensors on `device`."""
    import numpy as np
    import torch

    n = n or max(size[0] * size[1] // 60, 20)
    clouds = [cull_edge_points(size, seed, n) for seed in (0, 1)]
    P = max(c[0].shape[0] for c in clouds)
    out = [np.zeros((2, P, 3), np.float32), np.zeros((2, P), np.float32), np.zeros((2, P), bool)]
    for i, cloud in enumerate(clouds):
        for o, a in zip(out, cloud):
            o[i, :a.shape[0]] = a
    return tuple(torch.tensor(a, device=device) for a in out)


def compare_points(points, radius, valid, size, k):
    """The points kernel against its plain version on the same inputs: the
    share of slots with equal ids, the largest |diff| of zbuf and of dists
    where they agree, and the filled slots."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc
    from pytorch3d_tpu_torch.renderer.points.rasterize_points import rasterize_points_plain

    got = rpc.rasterize_points_cuda(points, radius, valid, size, k)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = rasterize_points_plain(points, radius, valid, size, k)
    same = got[0].long() == want[0]
    errs = []
    for g, w in zip(got[1:], want[1:]):
        d = (g - w).abs()[same]
        errs.append(float(d.max()) if d.numel() else 0.0)
    return float(same.float().mean()), errs[0], errs[1], int((want[0] >= 0).sum())


def compare_points_grad(points, idx, cots, size, bins):
    """The points backward kernel against its plain version on the kernel's
    own ids, their binning and the cotangents (gz, gdists): finite, max
    |g - g_plain|, the kernel's and the float32 plain version's largest
    error against the float64 plain version over its largest |g|, and
    `row_agreement`'s two shares per point."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc
    from pytorch3d_tpu_torch.renderer.points.rasterize_points import rasterize_points_grad_plain

    got = rpc.rasterize_points_grad_cuda(points, idx, *cots, size, bins)
    torch.cuda.synchronize()
    want = rasterize_points_grad_plain(points, idx, *cots, size)
    exact = rasterize_points_grad_plain(points.double(), idx, *(None if c is None else c.double() for c in cots), size)
    err, _ = grad_error(got, want)
    _, ratio_exact = grad_error(got.double(), exact)
    _, ratio_plain = grad_error(want.double(), exact)
    shares = row_agreement(got, want, exact, 3, POINT_GRAD_GATE)
    return bool(torch.isfinite(got).all()), err, (ratio_exact, ratio_plain), shares


def points_grad_twice(points, idx, cots, size, bins, label):
    """#7 launched twice on the same inputs must give the same bits, all
    finite: the kernel sums in a fixed order, and a NaN row would mean a
    filled slot whose point is missing from its tile's list."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc

    a, b = (rpc.rasterize_points_grad_cuda(points, idx, *cots, size, bins) for _ in range(2))
    same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    finite = bool(torch.isfinite(a).all())
    longest, passes = longest_list(bins, POINTS_GRAD_LIST_CHUNK)
    log(f"kernel rasterize_points_grad twice [{label}] N={points.shape[0]} P={points.shape[1]}: bit-equal {same},"
        f" finite {finite}; {bins[0].numel()} tile-point pairs, longest list {longest} ({passes} pass(es) of"
        f" pass 1)")
    return same and finite


def points_grad_fault(points, idx, cots, size):
    """#7 over a binning whose lists hold no point (every valid flag off):
    every point that a filled slot holds with a nonzero cotangent must come
    out NaN, every other point 0, without a host sync in the wrapper."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc

    N, P = points.shape[:2]
    empty = rpc.bin_points(points, torch.ones((N, P), device=points.device),
                           torch.zeros((N, P), dtype=torch.bool, device=points.device), size)
    got = rpc.rasterize_points_grad_cuda(points, idx, *cots, size, empty)
    work = (idx >= 0) & functools.reduce(torch.logical_or, [c != 0 for c in cots if c is not None])
    flat = idx.long() + (torch.arange(N, device=idx.device) * P)[:, None, None, None]
    held = torch.zeros(N * P, dtype=torch.bool, device=idx.device)
    held[flat[work]] = True
    rows = got.reshape(N * P, 3)
    ok = bool(rows[held].isnan().all()) and bool((rows[~held] == 0).all()) and bool(held.any())
    log(f"kernel rasterize_points_grad over empty tile lists: {int(held.sum())} points held by filled slots NaN,"
        f" the rest 0 -> {'ok' if ok else 'FAIL'}")
    return ok


def point_grad_gate(got, ref):
    """A point gradient against a reference one (the bin_size=0 path): the
    largest error over the largest |ref|, and the share of touched points
    within POINT_GRAD_GATE of their own scale."""
    _, ratio = grad_error(got, ref)
    share, _ = row_agreement(got, ref, ref.double(), 3, POINT_GRAD_GATE)
    ok = bool(got.isfinite().all()) and ratio <= POINT_GRAD_GATE and share >= POINT_GRAD_SHARE
    return ok, ratio, share


# fp32 operations of csrc/rasterize_points.cu per (pixel, point) test: two
# differences, two products, their sum and the compare with r^2; and of
# the points backward per filled slot: two differences, two products by
# gd, two by -2 and three sums.
POINTS_OPS_PER_CANDIDATE = 6
POINTS_GRAD_OPS_PER_SLOT = 9


def points_box_tests(points, radius, valid, size):
    """The (pixel, point) tests the points forward needs: for each live
    point (valid, z >= 0), the pixel centres inside its box, centre +- |r|
    on each axis (the disc's test decides only there)."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import pixel_grid_ndc

    ys, xs = pixel_grid_ndc(*size, points.device)
    ys, xs = ys.flip(0).contiguous(), xs.flip(0).contiguous()  # ascending
    live = valid & (points[..., 2] >= 0)
    r = radius.abs()[live]
    x, y = points[..., 0][live], points[..., 1][live]

    def inside(centres, c):
        hi = torch.searchsorted(centres, (c + r).contiguous(), right=True)
        return hi - torch.searchsorted(centres, (c - r).contiguous(), right=False)

    return float((inside(xs, x) * inside(ys, y)).double().sum())


def points_fine_bound(points, radius, valid, size, k, filled):
    """Least time for this run's points forward: max(bytes / HBM rate,
    ops / fp32 rate).  Bytes: the inputs read once (x, y, z, r and the
    valid flag, 17 B per point) and the outputs (int32 id, z, dist = 12 B
    per slot) written once.  Ops: `points_box_tests`' tests, plus K compares
    per insertion, counting one insertion per filled slot (fewer than the
    kernel makes: a point pushed out by a nearer one was inserted too)."""
    N, P = points.shape[:2]
    H, W = size
    tests = points_box_tests(points, radius, valid, size)
    bytes_moved = N * P * 17 + N * H * W * k * 12
    ops = tests * POINTS_OPS_PER_CANDIDATE + filled * k
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), tests, bytes_moved


def points_grad_bound(points, idx, cots):
    """Least time for this run's points backward: every slot's id read once,
    the cotangents given read once at the filled slots (empty slots add
    nothing), x and y (8 B) read once for each point that a filled slot
    holds with a nonzero dists cotangent (z is never read) and the gradient
    written once; against the operations of the filled slots."""
    import torch

    N, P = points.shape[:2]
    filled = int((idx >= 0).sum())
    given = sum(1 for c in cots if c is not None)
    gd = cots[1]
    touched = 0
    if gd is not None:
        held = (idx >= 0) & (gd != 0)
        flat = idx.long() + (torch.arange(N, device=idx.device) * P)[:, None, None, None]
        touched = int(torch.unique(flat[held]).numel())
    bytes_moved = idx.numel() * 4 + filled * 4 * given + touched * 8 + points.numel() * 4
    ops = filled * POINTS_GRAD_OPS_PER_SLOT
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), filled, bytes_moved


class PointsFit:
    """The points-fit loop: Adam(1e-2) on a (P, 3) offset and a (P, 3)
    colour of 30 000 points sampled from ico_sphere(4), scaled to the
    torus's extent, with rgb features at 0.5, toward the points-serving
    scene (its 8 AlphaCompositor images and its cloud);
    loss = image MSE + 0.1 chamfer_distance on Pointclouds."""

    def __init__(self, device):
        import torch

        from pytorch3d_tpu_torch.ops import sample_points_from_meshes
        from pytorch3d_tpu_torch.renderer import AlphaCompositor
        from pytorch3d_tpu_torch.utils import ico_sphere

        self.device = device
        self.target, self.cams = colored_points_scene(device)
        with torch.no_grad():
            self.target_images = points_renderer(self.cams, AlphaCompositor())(self.target.extend(PTS_REQUESTS))
        gen = torch.Generator(device=device).manual_seed(1)
        sphere = sample_points_from_meshes(ico_sphere(4, device=device), PTS_SAMPLES, generator=gen)[0]
        tgt = self.target.points_padded()[0]
        lo, hi = tgt.amin(0), tgt.amax(0)
        self.source = sphere * (hi - lo) / 2.0 + (hi + lo) / 2.0
        self.offset = torch.zeros_like(self.source, requires_grad=True)
        self.colour = torch.full_like(self.source, 0.5, requires_grad=True)
        self.optimizer = torch.optim.Adam([self.offset, self.colour], lr=1e-2)

    def cloud(self):
        from pytorch3d_tpu_torch.structures import Pointclouds

        return Pointclouds.create((self.source + self.offset)[None], features=self.colour[None], device=self.device)

    def forward(self, bin_size=None, keep=None):
        """The loss; `keep`, a list, receives the rasterizer's fragments."""
        import torch

        from pytorch3d_tpu_torch.loss import chamfer_distance
        from pytorch3d_tpu_torch.renderer import AlphaCompositor

        render = points_renderer(self.cams, AlphaCompositor(), bin_size)
        if keep is not None:
            render.rasterizer.register_forward_hook(lambda _m, _i, fragments: keep.append(fragments))
        cloud = self.cloud()
        images = render(cloud.extend(PTS_REQUESTS))
        return torch.mean((images - self.target_images) ** 2) + 0.1 * chamfer_distance(cloud, self.target)[0]

    def cotangents(self):
        """The kernel's inputs and the loss's cotangents at the current
        parameters: (NDC points, local ids, (gz, gdists), the forward's
        `bin_points` binning); zbuf is unused."""
        import torch

        from pytorch3d_tpu_torch.renderer import PointsRasterizer
        from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc

        keep = []
        loss = self.forward(keep=keep)
        (gdists,) = torch.autograd.grad(loss, keep[0].dists)
        ndc = PointsRasterizer(self.cams).transform(self.cloud().extend(PTS_REQUESTS)).points_padded()
        P = ndc.shape[1]
        offsets = (torch.arange(PTS_REQUESTS, device=self.device) * P)[:, None, None, None]
        idx = torch.where(keep[0].idx >= 0, keep[0].idx - offsets, -1).int().contiguous()
        ndc = ndc.detach().contiguous()
        bins = rpc.bin_points(ndc, *uniform_radius(ndc, PTS_RADIUS), (PTS_IMAGE, PTS_IMAGE))
        return ndc, idx, (None, gdists.contiguous()), bins


def points_kernel_cases(device):
    """[(label, points, radius, valid, size, K)] of `phase_points_kernel`:
    points-bench, the points-serving batch, a hetero batch with per-point
    radius and counts, the K=1 and K=64 corners and the cull's edge cases
    (`cull_edge_batch`) at a 120x200 image."""
    bench, served = bench_points(device), served_points_ndc(device)
    size = (PTS_IMAGE, PTS_IMAGE)
    return [
        ("points-bench", bench, *uniform_radius(bench, BENCH_RADIUS), size, BENCH_K),
        ("points-serving batch", served, *uniform_radius(served, PTS_RADIUS), size, PTS_K),
        ("hetero batch, per-point radius, counts 40000/25000/5000", *hetero_points(device), (PTS_IMAGE, 192), 16),
        ("K=1 corner (points-bench)", bench, *uniform_radius(bench, BENCH_RADIUS), size, 1),
        ("K=64 corner (points-bench, radius 0.05)", bench, *uniform_radius(bench, 0.05), size, 64),
        ("cull edges: exact ends, radius 0 and < 0, tile-wide discs, rectangle and tile borders,"
         " off-image centres, z ties", *cull_edge_batch(device), CULL_EDGE_IMAGE, 8),
    ]


def phase_points_kernel(device):
    """The points kernel against its plain version at `points_kernel_cases`."""
    worst, failed = 0.0, []
    for label, pts, rad, valid, sz, k in points_kernel_cases(device):
        frac, zerr, derr, filled = compare_points(pts, rad, valid, sz, k)
        ok = frac >= POINT_IDS_GATE and zerr <= DISTS_ATOL and derr <= DISTS_ATOL and filled > 0
        worst = max(worst, zerr, derr)
        log(f"kernel rasterize_points vs plain [{label}] N={pts.shape[0]} P={pts.shape[1]} {sz[0]}x{sz[1]} K={k}:"
            f" slots with equal ids {frac:.6f}, filled slots {filled}, max|diff| zbuf {zerr:.3e} dists {derr:.3e}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    check(not failed, f"points kernel disagrees with its plain version: {failed}")
    return worst


def phase_points_grad_kernel(device, fit):
    """The points backward kernel against the float64 plain version on the
    kernel's own ids and their binning: seeded random cotangents at
    points-bench and the points-serving batch, and points-fit's step-0
    cotangents; at each, two launches must give the same bits."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc

    size = (PTS_IMAGE, PTS_IMAGE)
    gen = torch.Generator(device=device).manual_seed(3)
    cases = []
    for label, pts, r, k in (("points-bench", bench_points(device), BENCH_RADIUS, BENCH_K),
                             ("points-serving batch", served_points_ndc(device), PTS_RADIUS, PTS_K)):
        rad, valid = uniform_radius(pts, r)
        idx, zbuf, _ = rpc.rasterize_points_cuda(pts, rad, valid, size, k)
        cots = tuple(torch.randn(zbuf.shape, generator=gen, device=device) for _ in range(2))
        cases.append((f"{label}, random cotangents", pts, idx, cots, rpc.bin_points(pts, rad, valid, size)))
    cases.append(("points-fit step 0, its loss's cotangents", *fit.cotangents()))
    worst, failed = 0.0, []
    for label, pts, idx, cots, bins in cases:
        finite, err, (ratio_exact, ratio_plain), (kernel_share, plain_share) = compare_points_grad(
            pts, idx, cots, size, bins)
        twice = points_grad_twice(pts, idx, cots, size, bins, label)
        ok = finite and twice and ratio_exact <= POINT_GRAD_GATE and kernel_share >= POINT_GRAD_SHARE
        if label.startswith("points-serving"):
            ok = points_grad_fault(pts, idx, cots, size) and ok
        worst = max(worst, err)
        log(f"kernel rasterize_points_grad vs plain [{label}] N={pts.shape[0]} P={pts.shape[1]}"
            f" filled slots {int((idx >= 0).sum())}: max|diff| vs float32 plain {err:.3e}; vs the float64 plain"
            f" version: kernel {ratio_exact:.3e}, float32 plain version {ratio_plain:.3e} of max|grad|; points"
            f" within {POINT_GRAD_GATE:g} of their own scale: kernel {kernel_share:.6f}, float32 plain version"
            f" {plain_share:.6f} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    check(not failed, f"points backward kernel disagrees with its plain version or with itself: {failed}")
    return worst


def phase_points_serving(device):
    """The 8 requests rendered in one call per compositor, against a
    bin_size=0 render."""
    import torch

    from pytorch3d_tpu_torch.renderer import AlphaCompositor, NormWeightedCompositor

    cloud, cams = colored_points_scene(device)
    clouds = cloud.extend(PTS_REQUESTS)
    compositors = {"alpha": AlphaCompositor, "norm-weighted": NormWeightedCompositor}
    renderers = {name: points_renderer(cams, c()) for name, c in compositors.items()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        images = {name: r(clouds) for name, r in renderers.items()}
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"points-serving: {PTS_REQUESTS} requests of {PTS_SAMPLES} points at {PTS_IMAGE}^2, radius {PTS_RADIUS},"
        f" K={PTS_K}, rendered through {len(renderers)} compositors: launches {counts}, first pass"
        f" {first_pass_s:.3f} s (first calls included)")
    check(counts["rasterize_points"] == len(renderers) and counts["rasterize_points_grad"] == 0,
          f"points-serving: launches {counts} for {len(renderers)} renders (1 points kernel each)")
    for name, img in images.items():
        check(img.shape == (PTS_REQUESTS, PTS_IMAGE, PTS_IMAGE, 3), f"{name}: image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
        coverage = (img.sum(-1) > 0.05).float().mean(dim=(1, 2))
        with torch.no_grad():
            plain = points_renderer(cams, compositors[name](), bin_size=0)(clouds)
        diff = (img - plain).abs().amax(dim=-1)
        frac = float((diff <= 1e-5).float().mean())
        log(f"  {name}: coverage per request {[round(float(c), 4) for c in coverage]}, |image - bin_size=0 image|"
            f" <= 1e-5 on {frac:.6f} of pixels (max {float(diff.max()):.3e})")
        check(bool((coverage > 0.1).all()), f"{name}: coverage {coverage.tolist()} (the example asserts > 0.1)")
        check(frac >= 0.999, f"{name}: only {frac:.6f} of pixels match the bin_size=0 render")
    return counts, clouds, renderers["alpha"]


def phase_points_bench(device):
    """benchmarks/bm_points_knn_nerf.py:17-39's shape, forward and the
    backward of sum(zbuf*m) + sum(dists*m) (m = filled slots), against
    bin_size=0."""
    import torch

    from pytorch3d_tpu_torch.renderer import rasterize_points
    from pytorch3d_tpu_torch.structures import Pointclouds

    pts = bench_points(device)

    def fwd_bwd(bin_size=None):
        p = pts.clone().requires_grad_(True)
        idx, zbuf, dists = rasterize_points(
            Pointclouds.create(p, device=device), PTS_IMAGE, BENCH_RADIUS, BENCH_K, bin_size=bin_size
        )
        m = idx >= 0
        (torch.where(m, zbuf, 0.0).sum() + torch.where(m, dists, 0.0).sum()).backward()
        return p.grad

    steps = 3
    reset_counts()
    for _ in range(steps):
        grad = fwd_bwd()
    torch.cuda.synchronize()
    counts = read_counts()
    ok, ratio, share = point_grad_gate(grad, fwd_bwd(bin_size=0))
    log(f"points-bench: {steps} fwd+bwd steps ({BENCH_POINTS} points, {PTS_IMAGE}^2, radius {BENCH_RADIUS},"
        f" K={BENCH_K}): launches {counts}; point grad vs bin_size=0: max|diff| {ratio:.3e} of max|grad|, points"
        f" within {POINT_GRAD_GATE:g} of their own scale {share:.6f} -> {'ok' if ok else 'FAIL'}")
    check(counts["rasterize_points"] == steps and counts["rasterize_points_grad"] == steps,
          f"points-bench: launches {counts} for {steps} steps (1 forward + 1 backward each)")
    check(ok, "points-bench: the point gradient is off the bin_size=0 one")
    ms = cuda_ms(fwd_bwd, iters=20, warmup=2)
    log(f"times [points-bench] fwd+bwd {ms:.4f} ms, {BENCH_POINTS / ms / 1e3:.2f} Mpts/s")
    return counts, ms


def phase_points_fit(device, fit):
    import torch

    grads = [torch.autograd.grad(fit.forward(b), fit.offset)[0] for b in (None, 0)]
    ok, ratio, share = point_grad_gate(*grads)
    log(f"points-fit: step 0 point grad vs bin_size=0: max|diff| {ratio:.3e} of max|grad|, points within"
        f" {POINT_GRAD_GATE:g} of their own scale {share:.6f} -> {'ok' if ok else 'FAIL'}")
    check(ok, "points-fit: the step 0 point gradient is off the bin_size=0 one")

    torch.cuda.synchronize()
    losses, fwd_ms, bwd_ms = [], [], []
    reset_counts()
    for _ in range(PFIT_WARMUP + PFIT_STEPS):
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
    steps = PFIT_WARMUP + PFIT_STEPS
    log(f"points-fit: {steps} Adam steps, {PTS_SAMPLES} points, {PTS_REQUESTS} views at {PTS_IMAGE}^2, K={PTS_K}:"
        f" losses {[round(v, 6) for v in losses]}; launches {counts}")
    check(all(math.isfinite(v) for v in losses), "points-fit: non-finite loss")
    check(losses[-1] < losses[0], f"points-fit: loss did not fall ({losses[0]:.6f} -> {losses[-1]:.6f})")
    want = {"rasterize_points": steps, "rasterize_points_grad": steps, "knn": 2 * steps}
    check(all(counts[k] == n for k, n in want.items()), f"points-fit: launches {counts}, expected {want}")
    check(bool(torch.isfinite(fit.offset).all() and torch.isfinite(fit.colour).all()), "points-fit: NaN parameters")
    timed_f, timed_b = sorted(fwd_ms[PFIT_WARMUP:]), sorted(bwd_ms[PFIT_WARMUP:])
    step = sorted(f + b for f, b in zip(fwd_ms[PFIT_WARMUP:], bwd_ms[PFIT_WARMUP:]))
    mid = PFIT_STEPS // 2
    log(f"times [points-fit step] median of {PFIT_STEPS}: step {step[mid]:.3f} ms (min {step[0]:.3f}, max"
        f" {step[-1]:.3f}); forward {timed_f[mid]:.3f} ms; backward + Adam {timed_b[mid]:.3f} ms")
    return counts


def phase_points_times(device, clouds, renderer, fit):
    """The points kernels' times, their plain versions' and their bounds
    at the paths' shapes; the binning; the points-serving frame; a
    profile of points-fit steps; the 1 M-point timing-only row."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc
    from pytorch3d_tpu_torch.renderer.points.rasterize_points import (
        rasterize_points_grad_plain, rasterize_points_plain,
    )

    size = (PTS_IMAGE, PTS_IMAGE)
    fine = {}
    bench = bench_points(device)
    big = bench_points(device, BIG_POINTS)
    for label, pts, r, sz, k, plain_check in (
        ("points-serving batch", served_points_ndc(device), PTS_RADIUS, size, PTS_K, True),
        ("points-bench", bench, BENCH_RADIUS, size, BENCH_K, True),
        (f"timing only, no plain check: {BIG_POINTS} points", big, BIG_RADIUS, (BIG_IMAGE, BIG_IMAGE), BENCH_K, False),
    ):
        rad, valid = uniform_radius(pts, r)
        bins = rpc.bin_points(pts, rad, valid, sz)
        events = cuda_ms(lambda: rpc._run_kernel(pts, rad, bins, sz, k), iters=50, warmup=5)
        kernel = device_ms(lambda: rpc._run_kernel(pts, rad, bins, sz, k), "rasterize_points_kernel")
        binning = cuda_ms(lambda: rpc.bin_points(pts, rad, valid, sz), iters=20)
        plain = None
        if plain_check:
            with torch.no_grad():
                plain = cuda_ms(lambda: rasterize_points_plain(pts, rad, valid, sz, k), iters=2, warmup=1)
        filled = int((rpc._run_kernel(pts, rad, bins, sz, k)[0] >= 0).sum())
        bound, bound_by, tests, nbytes = points_fine_bound(pts, rad, valid, sz, k, filled)
        made, walked = points_tests(pts, rad, bins, sz)
        fine[label] = dict(kernel=kernel, binning=binning, plain=plain, bound=bound, bound_by=bound_by)
        log(f"times [rasterize_points, {label}] N={pts.shape[0]} P={pts.shape[1]} {sz[0]}^2 K={k} radius {r}:"
            f" kernel {kernel:.4f} ms (device time, profiler;"
            f" CUDA events over back-to-back wrapper calls {events:.4f} ms), binning {binning:.4f} ms, plain version"
            f" {'not run' if plain is None else f'{plain:.2f} ms'}; bound {bound:.5f} ms by {bound_by} (bytes"
            f" {nbytes / 1e6:.2f} MB = {nbytes / PEAK_BYTES_PER_S * 1e3:.5f} ms, {tests / 1e6:.3f} M tests in the"
            f" points' boxes, {filled} filled slots = {(tests * POINTS_OPS_PER_CANDIDATE + filled * k) / PEAK_FP32_OPS_PER_S * 1e3:.5f}"
            f" ms; the kernel's warps test {walked / 1e6:.3f} M (pixel, point) lanes, {made / 1e6:.3f} M of them"
            f" in the points' boxes, of {len(bins[0])} tile-point pairs, where every pixel of a tile would test"
            f" its whole list {tile_candidates(bins[1], pts.shape[0], bins[2], bins[3], sz) / 1e6:.3f} M)")

    grads = {}
    rad_b, valid_b = uniform_radius(bench, BENCH_RADIUS)
    idx_b, _, _ = rpc.rasterize_points_cuda(bench, rad_b, valid_b, size, BENCH_K)
    filled_b = (idx_b >= 0).float()  # the points-bench loss's cotangents: 1 at filled slots
    for label, pts, idx, cots, bins in (
        ("points-fit step", *fit.cotangents()),
        ("points-bench", bench, idx_b, (filled_b, filled_b), rpc.bin_points(bench, rad_b, valid_b, size)),
    ):
        call = lambda: rpc.rasterize_points_grad_cuda(pts, idx, *cots, size, bins)  # noqa: E731
        events = cuda_ms(call, iters=50, warmup=5)
        passes = device_ms_by_kernel(call, POINTS_GRAD_KERNELS)
        kernel = sum(passes.values())
        whole = call_device_ms(call)
        plain = cuda_ms(lambda: rasterize_points_grad_plain(pts, idx, *cots, size), iters=5, warmup=1)
        bound, bound_by, filled, nbytes = points_grad_bound(pts, idx, cots)
        grads[label] = dict(kernel=kernel, plain=plain, bound=bound, bound_by=bound_by)
        log(f"times [rasterize_points_grad, {label}] N={pts.shape[0]} P={pts.shape[1]} K={idx.shape[3]}: kernel"
            f" {kernel:.4f} ms (device time, profiler; {', '.join(f'{k} {v:.4f}' for k, v in passes.items())};"
            f" the wrapper's whole device work, pair CSR and flag fill included, {whole:.4f} ms;"
            f" CUDA events over back-to-back wrapper calls {events:.4f} ms; {bins[0].numel()} tile-point pairs),"
            f" plain version {plain:.3f} ms; bound {bound:.5f} ms by {bound_by} (bytes"
            f" {nbytes / 1e6:.2f} MB = {nbytes / PEAK_BYTES_PER_S * 1e3:.5f} ms, {filled / 1e6:.3f} M filled slots ="
            f" {filled * POINTS_GRAD_OPS_PER_SLOT / PEAK_FP32_OPS_PER_S * 1e3:.5f} ms)")

    with torch.no_grad():
        frame_ms = []
        for _ in range(2):  # warm-up
            renderer(clouds)
        torch.cuda.synchronize()
        for _ in range(8):
            t0 = time.perf_counter()
            renderer(clouds)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
    frame_ms.sort()
    log(f"times [points-serving frame] {PTS_REQUESTS} requests in one render ({PTS_SAMPLES} points, {PTS_IMAGE}^2,"
        f" K={PTS_K}, AlphaCompositor): median of 8 {frame_ms[4]:.3f} ms, min {frame_ms[0]:.3f} ms, max"
        f" {frame_ms[-1]:.3f} ms")
    with torch.no_grad():
        profile("points-serving frame", lambda: [renderer(clouds) for _ in range(8)], 8)

    def fit_steps():
        for _ in range(3):
            fit.optimizer.zero_grad()
            fit.forward().backward()
            fit.optimizer.step()

    profile("points-fit step", fit_steps, 3)
    return fine["points-serving batch"], grads["points-fit step"]


# --------------------------------------------------------------------------- #
# NeRF
# --------------------------------------------------------------------------- #


class NeRFScene:
    """The full-width RadianceFieldRenderer with seeded xavier weights (zero
    biases, as flax initialises them) and the cow.npz views."""

    def __init__(self, device):
        import numpy as np
        import torch

        from pytorch3d_tpu_torch.models import RadianceFieldRenderer
        from pytorch3d_tpu_torch.parallel import make_nerf_train_step

        data = np.load(NERF_DATA)
        self.device = device
        self.images = torch.tensor(data["images"].astype(np.float32), device=device)
        self.R = torch.tensor(data["R"], device=device)
        self.T = torch.tensor(data["T"], device=device)
        self.fov, self.znear, self.zfar = float(data["fov"]), float(data["znear"]), float(data["zfar"])
        self.test_idx = [int(i) for i in data["test_idx"]]
        self.train_idx = [i for i in range(len(self.images)) if i not in self.test_idx]
        self.model = RadianceFieldRenderer(
            image_width=NERF_FRAME, image_height=NERF_FRAME, n_pts_per_ray=64, n_pts_per_ray_fine=64,
            n_rays_per_image=NERF_RAYS, min_depth=self.znear, max_depth=self.zfar, bg_color=(1.0, 1.0, 1.0),
            device=device, generator=torch.Generator(device=device).manual_seed(0),
        )
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=NERF_LR)
        self.step = make_nerf_train_step(self.model, self.optimizer)
        self.generator = torch.Generator(device=device).manual_seed(1)

    def camera(self, i):
        from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras

        return FoVPerspectiveCameras.create(
            R=self.R[i : i + 1], T=self.T[i : i + 1], fov=self.fov, znear=self.znear, zfar=self.zfar,
            device=self.device,
        )

    def frame(self, i):
        """One served request: test view i rendered whole, chunk by chunk;
        (NERF_FRAME, NERF_FRAME, 3) rgb_fine."""
        import torch

        cams = self.camera(i)
        chunks = self.model._raysampler.get_n_chunks(NERF_CHUNK, 1)
        with torch.no_grad():
            rgb = [self.model(cams, training=False, chunksize=NERF_CHUNK, chunk_idx=c)[0]["rgb_fine"]
                   for c in range(chunks)]
        return torch.cat(rgb, dim=1).reshape(NERF_FRAME, NERF_FRAME, 3)

    def loss(self, view, draws):
        _, m = self.model(self.camera(view), image=self.images[view : view + 1], training=True, draws=draws)
        return m["mse_coarse"] + m["mse_fine"]

    def field_launches(self, view):
        """The coarse and fine field launches of one training step: for
        each, its inputs (x, d_embed), the field's weights and its output's
        gradient from the step's loss; no optimizer step is taken."""
        import torch

        captured, handles = [], []
        for field in (self.model._renderer_coarse_field, self.model._renderer_fine_field):
            def hook(module, args, kwargs, output, field=field):
                d_embed, _ = kwargs["head"]
                rec = {"x": args[0].detach().reshape(-1, args[0].shape[-1]).contiguous(),
                       "de": d_embed.detach().reshape(-1, d_embed.shape[-1]).contiguous(), "field": field}
                output.register_hook(lambda g: rec.__setitem__("g", g.reshape(-1, 4).contiguous()))
                captured.append(rec)

            handles.append(field.mlp_xyz.register_forward_hook(hook, with_kwargs=True))
        draws = self.model.make_draws(1, True, self.generator)
        self.loss(view, draws).backward()
        for h in handles:
            h.remove()
        self.optimizer.zero_grad(set_to_none=True)
        out = []
        for rec in captured:
            ws, bs = rec["field"].mlp_xyz.weights()
            out.append((rec["x"], rec["de"], [w.detach() for w in ws], [b.detach() for b in bs],
                        tuple(t.detach() for t in rec["field"].head_params()), rec["field"].mlp_xyz.input_skips,
                        rec["g"]))
        return out

    def serving_launches(self, view):
        """The coarse and fine field launches of one served chunk of test
        view `view` (4096 rays x 64 and x 128 points): for each, its inputs
        (x, d_embed), the field's weights and its skips."""
        import torch

        captured, handles = [], []
        for field in (self.model._renderer_coarse_field, self.model._renderer_fine_field):
            def hook(module, args, kwargs, output, field=field):
                d_embed, _ = kwargs["head"]
                captured.append((args[0].reshape(-1, args[0].shape[-1]).contiguous(),
                                 d_embed.reshape(-1, d_embed.shape[-1]).contiguous(), field))

            handles.append(field.mlp_xyz.register_forward_hook(hook, with_kwargs=True))
        with torch.no_grad():
            self.model(self.camera(view), training=False, chunksize=NERF_CHUNK, chunk_idx=0)
        for h in handles:
            h.remove()
        out = []
        for x, de, field in captured:
            ws, bs = field.mlp_xyz.weights()
            out.append((x, de, [w.detach() for w in ws], [b.detach() for b in bs],
                        tuple(t.detach() for t in field.head_params()), field.mlp_xyz.input_skips))
        return out

    def trunk_inputs(self):
        """What Implicitron's NeRF hands MLPWithInputSkips without a head:
        the embedded points of the first serving chunk of test view 0
        (4096 rays x 64 coarse points = 262 144 rows x 39)."""
        import torch

        from pytorch3d_tpu_torch.renderer.implicit import ray_bundle_to_ray_points

        field = self.model._renderer_coarse_field
        with torch.no_grad():
            bundle = self.model._raysampler(self.camera(self.test_idx[0]), chunksize=NERF_CHUNK, chunk_idx=0,
                                            training=False)
            x = field.harmonic_embedding_xyz(ray_bundle_to_ray_points(bundle))
        return x.reshape(-1, x.shape[-1]).contiguous(), field.mlp_xyz


def mlp_macs_per_row(D, H, L, skips, Ddir=0, Hh=0):
    """Multiply-adds per row of the trunk (and, with Hh, the NeRF head):
    each layer's input width times its output width."""
    macs = sum(((D if li == 0 else H) + (D if li in skips else 0)) * H for li in range(L))
    if Hh:
        macs += H * 1 + H * H + (H + Ddir) * Hh + Hh * 3
    return macs


def mlp_bound(N, D, H, L, skips, Ddir=0, Hh=0, backward=False):
    """Least time of the function's work at the three-pass TF32 rate and
    HBM rate.

    Forward: 2 FLOP per multiply-add; bytes: the inputs (x, d_embed) and
    the weights read once, the output written once.  Backward: the input
    gradient and the weight gradients, 2 multiply-adds per forward one
    (the forward's saved activations are read, not recomputed);
    bytes: the inputs, the output gradient and the weights read once, dx,
    d d_embed and the weight gradients written once."""
    macs = mlp_macs_per_row(D, H, L, skips, Ddir, Hh)
    n_weights = macs + L * H + ((H + 1 + Hh + 3) if Hh else 0)
    out = 4 if Hh else H
    ops = 2.0 * N * macs * (2 if backward else 1)
    words = N * (D + Ddir) + n_weights + N * out
    if backward:
        words += N * (D + Ddir) + n_weights
    t_bytes, t_ops = 4.0 * words / PEAK_BYTES_PER_S, ops / PEAK_TF32X3_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), ops


def addmm_chain(x, weights, biases, skips, d_embed=None, head=None):
    """The library yardstick of #10/#12: the layers as torch.addmm calls
    (cuBLAS, one per layer, bias fused) and in-place ReLUs; the port calls
    none of them."""
    import torch

    y = x
    for li, (w, b) in enumerate(zip(weights, biases)):
        if li in skips:
            y = torch.cat([y, x], dim=-1)
        y = torch.addmm(b, y, w).relu_()
    if head is None:
        return y
    wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2 = head
    il = torch.addmm(bi, y, wi)
    h = torch.addmm(bc1, torch.cat([il, d_embed], dim=-1), torch.cat([wc1a, wc1b], dim=0)).relu_()
    return torch.cat([torch.addmm(bd, y, wd), torch.addmm(bc2, h, wc2)], dim=-1)


def fused_report(label, result):
    grads, flips = result["grads"], result["flips"]
    worst = max(grads, key=lambda n: grads[n][0])
    worst_exact = max(grads, key=lambda n: grads[n][1])
    own = max(grads, key=lambda n: grads[n][1] / max(FUSED_GRAD_GATE, FUSED_PLAIN_FACTOR * grads[n][3]))
    ok = fused_ok(result)
    log(f"kernel vs plain [{label}]: forward max|diff| {result['fwd_diff']:.3e} = {result['fwd']:.3e} of max|out|"
        f" (saving forward: {'the same bits' if result['same_bits'] else 'DIFFERENT bits'}); ReLU masks off"
        f" {', '.join(f'{k} {v}' for k, v in flips.items())} (kernel at most"
        f" {FUSED_PLAIN_FACTOR * flips['float32 plain vs float64'] + FUSED_FLIP_SLACK:g});"
        f" backward vs the float64 plain version on the kernel forward's ReLU masks: worst {worst}"
        f" {grads[worst][0]:.3e} of its max|grad|, rows {{{', '.join(f'{k}: {v:.6f}' for k, v in result['rows'].items())}}};"
        f" vs the float64 plain version on its own masks: worst {worst_exact} kernel {grads[worst_exact][1]:.3e},"
        f" float32 plain version on the kernel's masks {grads[worst_exact][2]:.3e} -> {'ok' if ok else 'FAIL'};"
        f" float32 plain version on its own masks (not a gate): at {own} kernel {grads[own][1]:.3e} against"
        f" {grads[own][3]:.3e}")
    return ok


def phase_fused_kernels(device, scene):
    """#10/#11 at the trunk path's rows (one serving chunk's coarse points);
    #12/#13 at a training step's coarse and fine field launches, on the
    step's own inputs and its loss's output gradients."""
    import torch

    x, mlp = scene.trunk_inputs()
    ws, bs = (list(t.detach() for t in ts) for ts in mlp.weights())
    g = torch.randn((x.shape[0], mlp.hidden_dim), generator=torch.Generator(device=device).manual_seed(5),
                    device=device)
    failed, errors = [], {}
    result = compare_fused(x, None, ws, bs, None, mlp.input_skips, g)
    if not fused_report(f"fused_mlp + grad, trunk path N={x.shape[0]} D={x.shape[1]} H={mlp.hidden_dim}"
                        f" L={mlp.n_layers}", result):
        failed.append("trunk")
    repeats = fused_backward_repeats(x, None, ws, bs, None, mlp.input_skips, g)
    log(f"  two backward launches on the same saved tensors: {'equal bits' if repeats else 'DIFFERENT bits'}")
    if not repeats:
        failed.append("trunk repeat")
    errors["fused_mlp"], errors["fused_mlp_grad"] = result["fwd_diff"], result["worst"]
    errors["nerf_field"] = errors["nerf_field_grad"] = 0.0
    for name, (x, de, ws, bs, head, skips, g) in zip(("coarse", "fine"), scene.field_launches(scene.train_idx[0])):
        result = compare_fused(x, de, ws, bs, head, skips, g)
        if not fused_report(f"nerf_field + grad, training step's {name} launch N={x.shape[0]}", result):
            failed.append(name)
        repeats = fused_backward_repeats(x, de, ws, bs, head, skips, g)
        log(f"  two backward launches on the same saved tensors: {'equal bits' if repeats else 'DIFFERENT bits'}")
        if not repeats:
            failed.append(f"{name} repeat")
        errors["nerf_field"] = max(errors["nerf_field"], result["fwd_diff"])
        errors["nerf_field_grad"] = max(errors["nerf_field_grad"], result["worst"])
    del x, de, g
    torch.cuda.empty_cache()
    check(not failed, f"fused MLP kernels disagree with their plain versions: {failed}")
    return errors


def phase_nerf_trunk(device, scene):
    """The trunk path: MLPWithInputSkips without a head, as Implicitron's NeRF
    runs its xyz encoder, forward and backward over one serving chunk's
    coarse points (kernels #10 and #11)."""
    import torch

    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    x, mlp = scene.trunk_inputs()
    w = torch.randn((x.shape[0], mlp.hidden_dim), generator=torch.Generator(device=device).manual_seed(6),
                    device=device)
    reset_counts()
    recomputed = fm._backward.forwards_run
    feats = mlp(x, x)
    (feats * w).sum().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    recomputed = fm._backward.forwards_run - recomputed
    mlp.zero_grad(set_to_none=True)
    log(f"nerf-trunk: MLPWithInputSkips (no head) forward and backward at N={x.shape[0]}: launches {counts};"
        f" forwards the backward ran itself: {recomputed}")
    check(counts["fused_mlp"] == 1 and counts["fused_mlp_grad"] == 1, f"nerf-trunk: launches {counts}")
    check(recomputed == 0, "nerf-trunk: the backward recomputed the forward instead of reading its saved tensors")
    check(bool(torch.isfinite(feats).all()), "nerf-trunk: non-finite features")
    return counts


def phase_nerf_serving(device, scene):
    """The 8 test views of cow.npz, each a whole 128^2 frame in 4 chunks
    (2 #12 launches each); one frame against use_fused_kernel=False."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    frames, frame_ms = [], []
    for i in scene.test_idx:
        t0 = time.perf_counter()
        frames.append(scene.frame(i))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    chunks = scene.model._raysampler.get_n_chunks(NERF_CHUNK, 1)
    want = 2 * chunks * len(scene.test_idx)
    log(f"nerf-serving: {len(frames)} requests of {NERF_FRAME}^2 in {chunks} chunks of {NERF_CHUNK} rays: launches"
        f" {counts}; frame ms {[round(v, 3) for v in frame_ms]}")
    check(counts["nerf_field"] == want and counts["nerf_field_grad"] == 0,
          f"nerf-serving: launches {counts}, expected {want} nerf_field")
    for i, img in zip(scene.test_idx, frames):
        check(img.shape == (NERF_FRAME, NERF_FRAME, 3), f"view {i}: frame shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"view {i}: non-finite pixels")
    scene.model.use_fused_kernel = False
    try:
        plain = scene.frame(scene.test_idx[0])
    finally:
        scene.model.use_fused_kernel = True
    diff = (frames[0] - plain).abs().amax(dim=-1)
    share = float((diff <= NERF_FRAME_TOL).double().mean())
    log(f"  view {scene.test_idx[0]} vs use_fused_kernel=False: |rgb_fine diff| <= {NERF_FRAME_TOL:g} on {share:.6f}"
        f" of pixels (max {float(diff.max()):.3e}); rgb range [{float(frames[0].min()):.4f},"
        f" {float(frames[0].max()):.4f}]")
    check(share >= NERF_FRAME_SHARE, f"nerf-serving: only {share:.6f} of pixels match the plain render")
    timed = sorted(frame_ms)
    log(f"times [nerf-serving frame] median of the {len(timed)} requests: {timed[len(timed) // 2]:.3f} ms"
        f" (min {timed[0]:.3f}, max {timed[-1]:.3f})")
    return counts


def grad_ratios(a, b):
    """{name: max |a - b| over max |b|} of two gradient dicts."""
    return {n: float((a[n] - b[n]).abs().max() / b[n].abs().max().clamp(min=1e-30)) for n in a}


def phase_nerf_step0(device, scene):
    """Step 0's gradients of every parameter, the fused path against
    use_fused_kernel=False on the same draws.  The coarse field sees the same
    rays on both paths: within GRAD_GATE end to end.  The fine field sees
    depths that sample_pdf draws from the coarse weights, amplifying their
    last-bit differences by 1 / pdf (up to ~1e4 in near-empty bins): so its
    gradients are held within GRAD_GATE on one fine bundle shared by both
    paths (the fused path's), and within NERF_FINE_GATE end to end.  Two
    float32 paths differ at the ReLU masks that lie within rounding of 0,
    so on the shared bundle both are also held to the plain path run in
    float64: the fused one no further off than FUSED_PLAIN_FACTOR times the
    plain one (or GRAD_GATE)."""
    import copy

    import torch

    from pytorch3d_tpu_torch.models.nerf.utils import calc_mse, sample_images_at_mc_locs

    model = scene.model
    view = scene.train_idx[0]
    draws = model.make_draws(1, True, torch.Generator(device=device).manual_seed(7))
    fine = model._renderer_fine_field
    grads, shared, kept = [], [], []
    handle = fine.register_forward_hook(lambda module, args, out: kept.append(args[0]))
    try:
        for fused in (True, False):
            model.use_fused_kernel = fused
            model.zero_grad(set_to_none=True)
            scene.loss(view, draws).backward()
            grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    finally:
        handle.remove()
    bundle = kept[0]
    gt = sample_images_at_mc_locs(scene.images[view : view + 1], bundle.xys)

    def field_grads(field, bundle):
        field.zero_grad(set_to_none=True)
        rgb, w = model._raymarcher(*field(bundle))
        calc_mse(rgb + (1.0 - w.sum(dim=-1, keepdim=True)) * model.bg_color, gt).backward()
        return {n: p.grad.clone() for n, p in field.named_parameters()}

    for fused in (True, False):
        model.use_fused_kernel = fused
        shared.append(field_grads(fine, bundle))
    model.use_fused_kernel = True
    model.zero_grad(set_to_none=True)
    # float64 witness: the plain path in float64 on the same bundle
    ref = copy.deepcopy(fine).double()
    ref.use_fused_kernel = False
    exact = field_grads(ref, bundle.replace(**{k: getattr(bundle, k).double()
                                               for k in ("origins", "directions", "lengths", "xys")}))
    del ref
    end_to_end, on_shared = grad_ratios(*grads), grad_ratios(*shared)
    coarse = {n: v for n, v in end_to_end.items() if "coarse" in n}
    fine_e2e = {n: v for n, v in end_to_end.items() if "fine" in n}
    worst = {k: max(d, key=d.get) for k, d in (("coarse", coarse), ("shared", on_shared), ("fine", fine_e2e))}
    witness = [max(grad_ratios(gs, exact).values()) for gs in shared]
    log(f"nerf-train: step 0 gradients vs use_fused_kernel=False, worst of each tensor's max|grad|: coarse field"
        f" end to end {worst['coarse']} {coarse[worst['coarse']]:.3e}; fine field on one shared fine bundle"
        f" {worst['shared']} {on_shared[worst['shared']]:.3e} (against the plain path in float64 there: fused"
        f" {witness[0]:.3e}, plain {witness[1]:.3e}); fine field end to end {worst['fine']}"
        f" {fine_e2e[worst['fine']]:.3e}")
    check(all(math.isfinite(v) for v in [*end_to_end.values(), *on_shared.values()]),
          "nerf-train: non-finite step 0 gradients")
    check(coarse[worst["coarse"]] <= GRAD_GATE and on_shared[worst["shared"]] <= GRAD_GATE
          and fine_e2e[worst["fine"]] <= NERF_FINE_GATE, "nerf-train: step 0 gradients off the plain path's")
    check(witness[0] <= max(GRAD_GATE, FUSED_PLAIN_FACTOR * witness[1]),
          "nerf-train: the fused fine field is further from float64 than the plain path")


def phase_nerf_train(device, scene):
    """Adam steps through make_nerf_train_step on one training view each."""
    import numpy as np
    import torch

    model = scene.model

    order = np.random.RandomState(0).permutation(scene.train_idx)
    steps = NERF_WARMUP + NERF_STEPS
    views = [int(order[i % len(order)]) for i in range(steps + NERF_TIMED)]
    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    recomputed = fm._backward.forwards_run
    losses, step_ms = [], []
    for v in views[:steps]:
        t0 = time.perf_counter()
        metrics = scene.step(scene.camera(v), scene.images[v : v + 1], generator=scene.generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = read_counts()
    recomputed = fm._backward.forwards_run - recomputed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"nerf-train: {steps} Adam steps of {NERF_RAYS} rays (64 + 64 points) on one of {len(scene.train_idx)}"
        f" views each: losses {[round(v, 6) for v in losses]}; launches {counts}; peak memory {peak_gb:.2f} GB")
    check(all(math.isfinite(v) for v in losses), "nerf-train: non-finite loss")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"nerf-train: the mean of the last 5 losses {last:.6f} is not below the first 5's {first:.6f}")
    check(counts["nerf_field"] == 2 * steps and counts["nerf_field_grad"] == 2 * steps,
          f"nerf-train: launches {counts} for {steps} steps (2 field forwards and 2 backwards each)")
    check(recomputed == 0, f"nerf-train: the backward ran {recomputed} forwards instead of reading the saved tensors")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "nerf-train: non-finite weights")
    timed = sorted(step_ms[-NERF_TIMED:])
    fwd_ms, bwd_ms = [], []
    for v in views[steps:]:
        t0 = time.perf_counter()
        scene.optimizer.zero_grad(set_to_none=True)
        loss = scene.loss(v, model.make_draws(1, True, scene.generator))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        scene.optimizer.step()
        torch.cuda.synchronize()
        fwd_ms.append((t1 - t0) * 1e3)
        bwd_ms.append((time.perf_counter() - t1) * 1e3)
    fwd_ms.sort()
    bwd_ms.sort()
    mid = NERF_TIMED // 2
    log(f"times [nerf-train step] median of the last {NERF_TIMED} steps: {timed[mid]:.3f} ms (min {timed[0]:.3f},"
        f" max {timed[-1]:.3f}), peak memory {peak_gb:.3f} GB; split over {NERF_TIMED} more steps: forward {fwd_ms[mid]:.3f} ms, backward + Adam"
        f" {bwd_ms[mid]:.3f} ms; mean loss first 5 {first:.6f}, last 5 {last:.6f}")
    return counts


def phase_nerf_times(device, scene):
    """#10-#13: device time (profiler), plain and library times and bounds
    at the paths' shapes; profiles of a served frame and a training step."""
    import torch

    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    flag = {False: "false", True: "true"}
    # a forward launch is the weights' packing and the chain
    fwd_names = {h: (f"fused_mlp_fwd_kernel<{flag[h]}, false>", "fused_mlp_fwd_prep_kernel") for h in (False, True)}
    save_names = {h: (f"fused_mlp_fwd_kernel<{flag[h]}, true>", "fused_mlp_fwd_prep_kernel") for h in (False, True)}
    passes = {h: {"weight preparation": "fused_mlp_bwd_prep_kernel", "row pass": f"fused_mlp_bwd_rows_kernel<{flag[h]}>",
                  "weight pass": "fused_mlp_bwd_weights_kernel", "split sum": "fused_mlp_bwd_reduce_kernel"}
              for h in (False, True)}
    x, mlp = scene.trunk_inputs()
    ws, bs = (list(t.detach() for t in ts) for ts in mlp.weights())
    skips = mlp.input_skips
    g = torch.randn((x.shape[0], mlp.hidden_dim), device=device)
    cases = [("trunk path", x, None, ws, bs, None, skips, g)]
    for name, launch in zip(("coarse", "fine"), scene.field_launches(scene.train_idx[1])):
        cases.append((f"training step's {name} launch", *launch))
    rows = {}
    for label, x, de, ws, bs, head, skips, g in cases:
        h = head is not None
        N, D = x.shape
        H, L = ws[0].shape[1], len(ws)
        Ddir, Hh = (de.shape[1], head[4].shape[1]) if h else (0, 0)
        fwd = ((lambda save=False: fm.nerf_field_cuda(x, de, ws, bs, head, skips, save=save)) if h
               else (lambda save=False: fm.fused_mlp_cuda(x, ws, bs, skips, save=save)))
        saved = fwd(save=True)  # the backward reads what a training step's forward saved
        bwd = ((lambda: fm.nerf_field_grad_cuda(x, de, ws, bs, head, skips, g, saved=saved)) if h
               else (lambda: fm.fused_mlp_grad_cuda(x, ws, bs, skips, g, saved=saved)))
        plain_f = ((lambda: fm.fused_nerf_field_plain(x, de, ws, bs, head, skips)) if h
                   else (lambda: fm.fused_mlp_plain(x, ws, bs, skips)))
        plain_b = ((lambda: fm.fused_nerf_field_grad_plain(x, de, ws, bs, head, skips, g)) if h
                   else (lambda: fm.fused_mlp_grad_plain(x, ws, bs, skips, g)))
        events_f, events_b = cuda_ms(fwd, 10, 2), cuda_ms(bwd, 5, 1)
        kernel_f = device_ms(fwd, fwd_names[h], iters=10, warmup=2)
        kernel_fs = device_ms(lambda: fwd(save=True), save_names[h], iters=10, warmup=2)
        per_pass = dict(zip(passes[h], device_ms_by_kernel(bwd, tuple(passes[h].values()), 3, 1).values()))
        kernel_b = sum(per_pass.values())
        with torch.no_grad():
            p_f = cuda_ms(plain_f, 5, 1)
            lib_f = cuda_ms(lambda: addmm_chain(x, ws, bs, skips, de, head), 5, 1)
        p_b = cuda_ms(plain_b, 3, 1)
        params = [t.detach().requires_grad_(True) for t in (*ws, *bs, *(head or ()))]
        pw, pb, ph = params[:L], params[L : 2 * L], params[2 * L :] or None
        xr = x.detach().requires_grad_(True)
        out = addmm_chain(xr, pw, pb, skips, de, ph)
        lib_b = cuda_ms(lambda: torch.autograd.grad(out, [xr, *params], g, retain_graph=True), 3, 1)
        del out
        bound_f, by_f, ops_f = mlp_bound(N, D, H, L, skips, Ddir, Hh)
        bound_b, by_b, ops_b = mlp_bound(N, D, H, L, skips, Ddir, Hh, backward=True)
        log(f"times [{'nerf_field' if h else 'fused_mlp'}, {label}] N={N} D={D} H={H} L={L} Ddir={Ddir} Hh={Hh}:"
            f" forward {kernel_f:.4f} ms (device time, profiler;"
            f" events {events_f:.4f}), plain {p_f:.4f} ms, library (torch.addmm chain, {L + (5 if h else 0)} calls)"
            f" {lib_f:.4f} ms, bound {bound_f:.4f} ms by {by_f} ({ops_f / 1e9:.2f} GFLOP = "
            f"{ops_f / kernel_f / 1e9:.2f} TFLOP/s achieved, {bound_f / kernel_f:.3f} of the bound); backward {kernel_b:.4f} ms"
            f" (device time, profiler; events {events_b:.4f}), plain"
            f" {p_b:.4f} ms, library (autograd of the addmm chain) {lib_b:.4f} ms, bound {bound_b:.4f} ms by {by_b}"
            f" ({ops_b / 1e9:.2f} GFLOP = {ops_b / kernel_b / 1e9:.2f} TFLOP/s achieved)")
        log(f"  backward by pass (device ms): {', '.join(f'{k} {v:.4f}' for k, v in per_pass.items())};"
            f" the saving forward (a training step's, storing the activations) {kernel_fs:.4f} ms against"
            f" {kernel_f:.4f} without the stores")
        rows[label] = (
            dict(kernel=kernel_f, plain=p_f, library=lib_f, bound=bound_f, bound_by=by_f, saving=kernel_fs),
            dict(kernel=kernel_b, plain=p_b, library=lib_b, bound=bound_b, bound_by=by_b),
        )
        del x, de, g, params, xr, saved
        torch.cuda.empty_cache()

    for name, (x, de, ws, bs, head, skips) in zip(("coarse", "fine"), scene.serving_launches(scene.test_idx[1])):
        N, D = x.shape
        H, L, Ddir, Hh = ws[0].shape[1], len(ws), de.shape[1], head[4].shape[1]
        with torch.no_grad():
            fwd = lambda: fm.nerf_field_cuda(x, de, ws, bs, head, skips)
            events_f = cuda_ms(fwd, 10, 2)
            kernel_f = device_ms(fwd, fwd_names[True], iters=10, warmup=2)
            lib_f = cuda_ms(lambda: addmm_chain(x, ws, bs, skips, de, head), 5, 1)
        bound_f, by_f, ops_f = mlp_bound(N, D, H, L, skips, Ddir, Hh)
        log(f"times [nerf_field, serving {name} launch] N={N} D={D} H={H} L={L} Ddir={Ddir} Hh={Hh}: forward"
            f" {kernel_f:.4f} ms (device time, profiler; events {events_f:.4f}), library (torch.addmm chain,"
            f" {L + 5} calls) {lib_f:.4f} ms, bound {bound_f:.4f} ms by {by_f} ({ops_f / 1e9:.2f} GFLOP ="
            f" {ops_f / kernel_f / 1e9:.2f} TFLOP/s achieved, {bound_f / kernel_f:.3f} of the bound)")
        rows[f"serving {name} launch"] = (dict(kernel=kernel_f, library=lib_f, bound=bound_f, bound_by=by_f), None)
        del x, de
    launches = 2 * scene.model._raysampler.get_n_chunks(NERF_CHUNK, 1)
    serve = device_ms(lambda: scene.frame(scene.test_idx[1]), fwd_names[True], iters=2, warmup=1,
                      launches=launches) / launches
    fine_save, coarse_save = (rows[f"training step's {n} launch"][0]["saving"] for n in ("fine", "coarse"))
    log(f"times [nerf_field, serving launch] {serve:.4f} ms per launch (device time, profiler; {launches} a frame,"
        f" coarse and fine alike, no stores) against the training launches' {fine_save:.4f} (fine) and"
        f" {coarse_save:.4f} (coarse) with the stores")
    profile("nerf-serving frame", lambda: scene.frame(scene.test_idx[1]), 1)

    def train_steps():
        for v in scene.train_idx[2:5]:
            scene.step(scene.camera(v), scene.images[v : v + 1], generator=scene.generator)

    profile("nerf-train step", train_steps, 3)
    trunk = rows["trunk path"]
    fine = rows["training step's fine launch"]
    return trunk[0], trunk[1], fine[0], fine[1]

# --------------------------------------------------------------------------- #
# Pulsar and the hard rasterizer (#2, #3, #6, #8)
# --------------------------------------------------------------------------- #


def pulsar_scene(device, n):
    """benchmarks/exp_pulsar.py:33-47: n spheres uniform in [-10, 10]^2 x
    [20, 40], colours from the same RandomState(42), radius 0.1."""
    import numpy as np
    import torch

    rng = np.random.RandomState(42)
    pos = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n), rng.uniform(20, 40, n)], axis=-1)
    col = rng.rand(n, 3)
    return (torch.tensor(pos, dtype=torch.float32, device=device),
            torch.tensor(col, dtype=torch.float32, device=device),
            torch.full((n,), 0.1, dtype=torch.float32, device=device))


def pulsar_cam(yaw, device):
    """exp_pulsar.py:52's camera [0,0,0, 0,0,0, focal 5, sensor 2], turned
    by `yaw` radians about y (its ry)."""
    import torch

    return torch.tensor([0.0, 0.0, 0.0, 0.0, float(yaw), 0.0, 5.0, 2.0], device=device)


def pulsar_renderer(n):
    from pytorch3d_tpu_torch.renderer.points.pulsar import Renderer

    return Renderer(PULSAR_IMAGE, PULSAR_IMAGE, n, n_track=PULSAR_TRACK)


def pulsar_render(ren, scene, yaw, device, opacity=None):
    pos, col, rad = scene
    return ren(pos, col, rad, pulsar_cam(yaw, device), PULSAR_GAMMA, PULSAR_DEPTH[1],
               min_depth=PULSAR_DEPTH[0], opacity=opacity)


def plain_pulsar(renderer, ids=None):
    """The plain path of a pulsar `Renderer`: a copy of it whose select is
    the plain version (`rasterize_points_topk`) on the card, or returns ids
    that version gave already."""
    import copy

    from pytorch3d_tpu_torch.renderer.points.rasterize_points import rasterize_points_topk

    def select(pts_ndc, r_ndc, valid):
        if ids is not None:
            return ids, None
        size = (renderer._height, renderer._width)
        return rasterize_points_topk(pts_ndc.detach(), r_ndc.detach(), valid, size, renderer._n_track), None

    plain = copy.copy(renderer)
    plain._select = select
    return plain


def image_agreement(got, want, tol):
    """Share of pixels whose channels all lie within tol, and the largest
    difference."""
    diff = (got - want).abs().amax(dim=-1)
    return float((diff <= tol).float().mean()), float(diff.max())


def timed_ms(fn):
    """One call's wall time on the host clock, ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def box_pixel_tests(xmin, xmax, ymin, ymax, live, size):
    """The pixel centres inside each live NDC box, summed: the tests a
    selection over those boxes needs."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import pixel_grid_ndc

    ys, xs = pixel_grid_ndc(*size, xmin.device)
    ys, xs = ys.flip(0).contiguous(), xs.flip(0).contiguous()  # ascending

    def inside(centres, lo, hi):
        return (torch.searchsorted(centres, hi[live].contiguous(), right=True)
                - torch.searchsorted(centres, lo[live].contiguous(), right=False)).clamp(min=0)

    return float((inside(xs, xmin, xmax) * inside(ys, ymin, ymax)).double().sum())


def face_box_tests(fv, valid, size, blur):
    """The (pixel, face) tests a mesh selection needs: for each face the
    culls keep, the pixel centres inside its box grown by sqrt(blur)."""
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls

    grow = math.sqrt(blur) if blur > 0 else 0.0
    x, y = fv[..., 0], fv[..., 1]
    return box_pixel_tests(x.amin(-1) - grow, x.amax(-1) + grow, y.amin(-1) - grow, y.amax(-1) + grow,
                           _face_culls(fv, valid, False), size)


# fp32 operations per (pixel, face) test of csrc/rasterize_hard.cu, the
# per-face terms amortised over the tile: 3 edge functions (5 each), 3
# divisions, the inside test (3), pz (5), pz >= 0 and the compare (2),
# the zero-area test (1) = 29.
HARD_OPS_PER_CANDIDATE = 29


def bound_of(bytes_moved, ops):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def topk_bound(fv, valid, size, blur, k):
    """#2's least time: the face verts read once and the ids (4 B per slot)
    written once, against `face_box_tests` x the fine kernel's operations
    per test (perspective-corrected and clipped, as the serving batch)."""
    N, F = fv.shape[:2]
    tests = face_box_tests(fv, valid, size, blur)
    return (*bound_of(N * F * 36 + N * size[0] * size[1] * k * 4, tests * fine_ops_per_candidate(True, True)), tests)


def hard_bound(fv, valid, size):
    """#3's least time: the face verts read once and id, z and 3 bary
    (20 B per pixel) written once, against `face_box_tests` at blur 0 x
    HARD_OPS_PER_CANDIDATE."""
    N, F = fv.shape[:2]
    tests = face_box_tests(fv, valid, size, 0.0)
    return (*bound_of(N * F * 36 + N * size[0] * size[1] * 20, tests * HARD_OPS_PER_CANDIDATE), tests)


def hard_tests(fv, valid, size):
    """(the (pixel, face) tests #3 makes, the lanes its warps walk) over
    its blur-0 binning: `fine_tests` with `face_pixel_boxes` at blur 0
    without perspective correction (its inside test is screen-space)."""
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import bin_faces
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls

    bins = bin_faces(fv, _face_culls(fv, valid, False), size, 0.0)
    return fine_tests(bins, face_pixel_boxes(fv, size, 0.0, False), *fv.shape[:2], size)


def hard_cull_edge_faces(size, seed, n):
    """Faces on the edges of #3's pixel-box cull for an (H, W) image, as
    numpy float32 NDC face verts (F, 3, 3) (xy + view z) and a bool valid
    mask (F,), from np.random.default_rng(seed), about n of each kind, in a
    shuffled order:
    - a grown box's edge exactly on a pixel centre (the box holds it), on
      each side of each axis;
    - vertices on pixel centres, so that edges run through centres (the
      strict inside test fails there), each with its twin across the edge;
    - duplicates, one z each (ties: the lower id wins);
    - zero-area faces (collinear vertices) and faces within a pixel;
    - faces over several tiles, and small faces across warp-rectangle and
      tile borders (between columns 7 | 8 and 15 | 16, rows 3 | 4, 7 | 8
      and 15 | 16 of a tile);
    - faces reaching into the image from outside it;
    - faces with one or two vertices behind the camera (z < 0), and faces
      with a vertex far off the image (up to 1e4 in NDC, as a vertex near
      z = 0 projects);
    both windings, z in quarter steps, 5 % not valid."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import box_grow
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import pixel_grid_ndc

    H, W = size
    ys, xs = (t.numpy() for t in pixel_grid_ndc(H, W, torch.device("cpu")))
    rng = np.random.default_rng(seed)
    f32 = np.float32
    grow = f32(box_grow(size, 0.0))
    px, py = f32(xs[0] - xs[1]), f32(ys[0] - ys[1])
    u = lambda lo, hi, m=n: rng.uniform(lo, hi, m).astype(f32)  # noqa: E731
    inner = lambda m=n: (u(xs[-1], xs[0], m), u(ys[-1], ys[0], m))  # noqa: E731
    tris = []  # (m, 3, 2) xy

    def add(*corners):
        tris.append(np.stack([np.stack(c, -1) for c in corners], 1).astype(f32))

    for axis, centres, pitch in ((0, xs, px), (1, ys, py)):  # a grown box's edge on a centre
        for side in (-1.0, 1.0):  # -1: the low bound v - grow, +1: the high bound v + grow
            c = centres[rng.integers(0, centres.size, 8 * n)]
            v = (c - f32(side) * grow).astype(f32)
            v = v[(v + f32(side) * grow).astype(f32) == c][:n]
            m = v.size
            a, b = -side * u(0.5, 5.0, m) * pitch, -side * u(0.5, 5.0, m) * pitch
            o = (ys if axis == 0 else xs)[rng.integers(0, H if axis == 0 else W, m)]
            d = u(-3.0, 3.0, m) * (py if axis == 0 else px)
            along = (v, v + a, v + b)
            across = (o, o + d, o - d + u(-1.0, 1.0, m) * (py if axis == 0 else px))
            add(*((p, q) if axis == 0 else (q, p) for p, q in zip(along, across)))
    c, r = rng.integers(2, W - 6, n), rng.integers(2, H - 6, n)  # vertices on centres, twins across an edge
    dc, dr = rng.integers(1, 4, n), rng.integers(1, 4, n)
    a, b, t = (xs[c], ys[r]), (xs[c + dc], ys[r]), (xs[c], ys[r + dr])
    add(a, b, t)
    add(b, t, (xs[c + dc], ys[r + dr]))
    x, y = inner()  # duplicates
    e = u(1.0, 6.0) * px
    dup = [(x, y), (x + e, y + u(-1.0, 1.0) * py), (x + u(-1.0, 1.0) * px, y + e)]
    add(*dup)
    add(*dup)
    x, y = inner()  # zero area, within a pixel
    e = u(0.5, 4.0) * px
    add((x, y), (x + e, y + e), (x + e / 2, y + e / 2))
    add((x, y), (x + u(0.05, 0.3) * px, y), (x, y + u(0.05, 0.3) * py))
    m = max(n // 4, 1)
    x, y = inner(m)  # over several tiles
    e = u(17.0, 45.0, m) * px
    add((x, y), (x + e, y + u(-0.5, 0.5, m) * e), (x + u(-0.5, 0.5, m) * e, y - e))
    cols = np.array([q for q in range(W - 1) if q % 16 in (7, 15)])
    rows = np.array([q for q in range(H - 1) if q % 16 in (3, 7, 15)])
    cc, rr = cols[rng.integers(0, cols.size, n)], rows[rng.integers(0, rows.size, n)]
    x, y = (xs[cc] + xs[cc + 1]) / 2, (ys[rr] + ys[rr + 1]) / 2
    e = u(0.4, 2.0) * px
    add((x - e, y - e), (x + e, y), (x, y + e))
    side = rng.choice(f32([-1.0, 1.0]), n)  # from outside the image
    x0 = side * (xs[0] + u(0.0, 4.0) * px)
    y0 = u(ys[-1], ys[0])
    add((x0, y0), (x0 - side * u(1.0, 6.0) * px, y0 + u(-3.0, 3.0) * py), (x0 + side * u(1.0, 6.0) * px, y0 - 2 * py))
    x, y = inner()  # a vertex far off the image
    far = rng.choice(f32([-1.0, 1.0]), (n, 2)) * (10.0 ** u(2.0, 4.0, (n, 2)))
    add((x, y), (x + u(1.0, 8.0) * px, y + u(-2.0, 2.0) * py), (far[:, 0], far[:, 1]))
    xy = np.concatenate(tris)
    F = xy.shape[0]
    flip = rng.random(F) < 0.5  # both windings
    xy[flip] = xy[flip][:, [0, 2, 1]]
    z = (rng.integers(2, 12, (F, 1)) * 0.25).astype(f32).repeat(3, 1)
    tilt = rng.random(F) < 0.5
    z[tilt] = (rng.integers(2, 12, (int(tilt.sum()), 3)) * 0.25).astype(f32)
    behind = rng.random(F) < 0.1  # one or two vertices at z < 0
    z[behind, 0] *= -1.0
    z[behind & (rng.random(F) < 0.5), 1] *= -1.0
    fv = np.concatenate([xy, z[..., None]], -1).astype(f32)
    order = rng.permutation(F)
    return fv[order], (rng.random(F) >= 0.05)[order]


def hard_cull_edge_batch(device, size=CULL_EDGE_IMAGE, n=None):
    """Two images of `hard_cull_edge_faces` (seeds 0 and 1, n of each kind,
    by default one for 400 pixels; padded to one F with faces that are not
    valid) as (N, F, 3, 3) and (N, F) tensors on `device`."""
    import numpy as np
    import torch

    n = n or max(size[0] * size[1] // 400, 12)
    images = [hard_cull_edge_faces(size, seed, n) for seed in (0, 1)]
    F = max(fv.shape[0] for fv, _ in images)
    fv, valid = np.zeros((2, F, 3, 3), np.float32), np.zeros((2, F), bool)
    for i, (f, v) in enumerate(images):
        fv[i, :f.shape[0]], valid[i, :v.shape[0]] = f, v
    return torch.tensor(fv, device=device), torch.tensor(valid, device=device)


def crossing_strip_faces(device, size, n=16, seed=0):
    """(1, 2n, 3, 3) NDC face verts and valid mask of a seeded strip of
    large faces on a floor below a camera at the origin looking along +z
    (an (H, W) FoVPerspectiveCameras): n faces with two vertices behind the
    camera (z < 0) and n with one, each crossing z = 0."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras
    from pytorch3d_tpu_torch.structures import Meshes

    rng = np.random.default_rng(seed)
    x = np.linspace(-2.0, 2.0, n + 1)
    front = np.stack([x, np.full(n + 1, -0.6), np.full(n + 1, 2.0)], -1)
    back = np.stack([x, np.full(n + 1, -0.6), np.full(n + 1, -2.0)], -1)
    verts = (np.concatenate([front, back]) + rng.uniform(-0.2, 0.2, (2 * n + 2, 3))).astype(np.float32)
    faces = np.array([(i, n + 1 + i, n + 2 + i) for i in range(n)] + [(i, i + 1, n + 2 + i) for i in range(n)])
    mesh = Meshes.create([torch.tensor(verts, device=device)], [torch.tensor(faces, device=device)], device=device)
    cams = FoVPerspectiveCameras.create(R=torch.eye(3, device=device)[None], T=torch.zeros((1, 3), device=device),
                                        aspect_ratio=size[1] / size[0], device=device)
    return face_inputs(mesh, cams, size)


def select_bound(pts, rad, valid, size, k, filled):
    """#6's least time: x, y, z, r and the valid flag (17 B per sphere) read
    once and the ids (4 B per slot) written once, against the pixel centres
    in the spheres' boxes x POINTS_OPS_PER_CANDIDATE plus K compares per
    filled slot (as #5's bound)."""
    tests = points_box_tests(pts[None], rad[None], valid[None], size)
    P = pts.shape[0]
    ops = tests * POINTS_OPS_PER_CANDIDATE + filled * k
    return (*bound_of(P * 17 + size[0] * size[1] * k * 4, ops), tests)


def pulsar_grad_bound(table, idx):
    """#8's least time: the ids, the cotangent, denom, logit_max, the
    background colour and the table read once, d(table) written once,
    against the function's fp32 operations on this run's hits: per filled
    hit zn 5, the logit less lm 3, exp 1, dx dy d2 5, u 3, clos, w0 and w
    4, dL/dw's background term and product 4 C and its scale 1, the band
    and its product 3, the x, y, r and S products 4, the colour products
    2 C and the 4 + C sums (33 + 7 C); per ordered pair of filled hits on
    one pixel, dL/dw's pairwise term 3 C; per pixel w_bg, 1 / denom and
    ct / denom (3 + C)."""
    H, W, K = idx.shape
    P, F = table.shape
    C = F - 5
    n = (idx >= 0).sum(-1).double()
    hits, pairs = int(n.sum()), int((n * (n - 1)).sum())
    bytes_moved = H * W * (4 * K + 4 * C + 8) + 4 * C + 2 * P * F * 4
    ops = hits * (33 + 7 * C) + pairs * 3 * C + H * W * (3 + C)
    return (*bound_of(bytes_moved, ops), hits)


def compare_pulsar_grad(table, idx, bins, ct, label, gamma=PULSAR_GAMMA, depth=PULSAR_DEPTH):
    """#8 against the plain version evaluated in float64 on the kernel's
    ids (the blend's environment recomputed in float64), at `gamma` and
    `depth` (min_depth, max_depth).  Each field of d(table) must lie within
    PULSAR_GRAD_GATE of its largest |entry| or no further off than
    PULSAR_GRAD_PLAIN_FACTOR x the float32 plain version, and the share of
    spheres within PULSAR_GRAD_GATE of their own scale (`row_agreement`)
    must be no lower than the float32 plain version's less
    PULSAR_GRAD_SHARE_MARGIN.  Returns (ok, worst ratio, the float32 plain
    version's worst ratio, max |diff| against the float32 plain version)."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc
    from pytorch3d_tpu_torch.renderer.points.pulsar.renderer import _blend_core

    size = idx.shape[:2]
    bg = torch.ones(table.shape[1] - 5, device=table.device)
    args = (gamma, depth[0], depth[1])
    _, denom, lm, _, _ = _blend_core(table, idx, bg, *args, 0.0, *size)
    got = rpc.pulsar_blend_grads_cuda(table, idx, ct, denom, lm, bg, size, *args, 0.0, bins)
    torch.cuda.synchronize()
    plain = rpc.pulsar_blend_grads_plain(table, idx, ct, denom, lm, bg, size, *args, 0.0)
    t64, bg64 = table.double(), bg.double()
    _, denom64, lm64, _, _ = _blend_core(t64, idx, bg64, *args, 0.0, *size)
    exact = rpc.pulsar_blend_grads_plain(t64, idx, ct.double(), denom64, lm64, bg64, size, *args, 0.0)
    scale = exact.abs().amax(dim=0).clamp(min=1e-300)
    ratio = (got.double() - exact).abs().amax(dim=0) / scale
    ratio_plain = (plain.double() - exact).abs().amax(dim=0) / scale
    fields_ok = bool((ratio <= torch.clamp(PULSAR_GRAD_PLAIN_FACTOR * ratio_plain, min=PULSAR_GRAD_GATE)).all())
    kernel_share, plain_share = row_agreement(got, plain, exact, table.shape[1], PULSAR_GRAD_GATE)
    err = float((got - plain).abs().max())
    ok = bool(torch.isfinite(got).all()) and fields_ok and kernel_share >= plain_share - PULSAR_GRAD_SHARE_MARGIN
    log(f"kernel pulsar_grad vs plain [{label}] P={table.shape[0]} {size[0]}^2 K={idx.shape[2]} gamma {gamma:g} hits"
        f" {int((idx >= 0).sum())} pairs {bins[0].numel()}: per field (x y z r o col) vs the float64 plain"
        f" version, of the field's max|grad|: kernel {[float(f'{r:.3e}') for r in ratio]}, float32 plain version"
        f" {[float(f'{r:.3e}') for r in ratio_plain]}; spheres within {PULSAR_GRAD_GATE:g} of their own scale:"
        f" kernel {kernel_share:.6f}, float32 plain version {plain_share:.6f}; max|diff| vs float32 plain"
        f" {err:.3e} -> {'ok' if ok else 'FAIL'}")
    return ok, float(ratio.max()), float(ratio_plain.max()), err


def pulsar_grad_twice(table, idx, bins, ct, label, gamma=PULSAR_GAMMA, depth=PULSAR_DEPTH):
    """#8 launched twice on the same inputs must give the same bits, all
    finite: the kernel sums in a fixed order, and a NaN row would mean a
    hit whose sphere is missing from its tile's list."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc
    from pytorch3d_tpu_torch.renderer.points.pulsar.renderer import _blend_core

    size = idx.shape[:2]
    bg = torch.ones(table.shape[1] - 5, device=table.device)
    args = (gamma, depth[0], depth[1])
    with torch.no_grad():
        _, denom, lm, _, _ = _blend_core(table, idx, bg, *args, 0.0, *size)
    a, b = (rpc.pulsar_blend_grads_cuda(table, idx, ct, denom, lm, bg, size, *args, 0.0, bins) for _ in range(2))
    same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    finite = bool(torch.isfinite(a).all())
    log(f"kernel pulsar_grad twice [{label}] P={table.shape[0]} {size[0]}^2 K={idx.shape[2]}: bit-equal {same},"
        f" finite {finite}")
    check(same and finite, f"pulsar_grad [{label}]: two launches differ or give non-finite rows")


class PulsarServing:
    """The pulsar-serving scene: 100 000 spheres, 1024^2, n_track 5, gamma
    0.1, depths 1-45, eight yaws; the plain selection of request 0, made
    once (the plain select takes seconds at this size)."""

    def __init__(self, device):
        self.device = device
        self.scene = pulsar_scene(device, PULSAR_SPHERES)
        self.renderer = pulsar_renderer(PULSAR_SPHERES)
        self.plain_ids = None
        self.plain_select_ms = None

    def inputs(self, yaw):
        """(table, idx, bins) of one request, as the renderer's forward
        makes them."""
        pos, col, rad = self.scene
        return self.renderer._prepare(pos, col, rad, pulsar_cam(yaw, self.device), *PULSAR_DEPTH)


class PulsarFit:
    """pulsar-fit: the pulsar-serving scene's render at yaw 0 is the
    target; start from positions jittered by a seeded normal (sigma 0.05),
    colours 0.5, radii x 0.8 and opacity 1; Adam(PULSAR_FIT_LR) on all four
    for image MSE."""

    def __init__(self, device):
        import numpy as np
        import torch

        self.device = device
        pos, col, rad = pulsar_scene(device, PULSAR_SPHERES)
        self.renderer = pulsar_renderer(PULSAR_SPHERES)
        with torch.no_grad():
            self.target = pulsar_render(self.renderer, (pos, col, rad), 0.0, device)
        jitter = np.random.RandomState(7).normal(0.0, 0.05, tuple(pos.shape))
        self.pos = (pos + torch.tensor(jitter, dtype=torch.float32, device=device)).requires_grad_(True)
        self.col = torch.full_like(col, 0.5).requires_grad_(True)
        self.rad = (rad * 0.8).requires_grad_(True)
        self.opa = torch.ones_like(rad).requires_grad_(True)
        self.optimizer = torch.optim.Adam([self.pos, self.col, self.rad, self.opa], lr=PULSAR_FIT_LR)

    def forward(self):
        import torch

        image = pulsar_render(self.renderer, (self.pos, self.col, self.rad), 0.0, self.device, opacity=self.opa)
        return torch.mean((image - self.target) ** 2)

    def blend_inputs(self):
        """#8's inputs at the current parameters: (table, idx, bins, the
        loss's cotangent of the image)."""
        import torch

        from pytorch3d_tpu_torch.renderer.points.pulsar.renderer import _blend_core

        with torch.no_grad():
            table, idx, bins = self.renderer._prepare(
                self.pos, self.col, self.rad, pulsar_cam(0.0, self.device), PULSAR_DEPTH[0], PULSAR_DEPTH[1], self.opa
            )
            image = _blend_core(table, idx, torch.ones(3, device=self.device), PULSAR_GAMMA, *PULSAR_DEPTH, 0.0,
                                PULSAR_IMAGE, PULSAR_IMAGE)[0]
            ct = 2.0 * (image - self.target) / image.numel()
        return table.contiguous(), idx, bins, ct.contiguous()


def phase_topk_kernel(device):
    """#2 at the serving batch: its ids against #1's pix_to_face (bit for
    bit) and against the plain version (`row_ok`'s share).  Returns the
    share of slots off the plain version and the plain version's ms."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import rasterize_topk

    size = (IMAGE, IMAGE)
    fv, valid = face_inputs(main_path_meshes(device), camera(30.0, device), size)
    fine = rc.rasterize_fragments_cuda(fv, valid, size, BLUR, K, True, True)[0]
    got = torch.stack([rc.rasterize_topk_cuda(fv[n], valid[n], size, BLUR, K, True, True) for n in range(len(fv))])
    want, plain_ms = timed_ms(lambda: torch.stack([
        rasterize_topk(fv[n], valid[n], size, BLUR, K, True, True) for n in range(len(fv))
    ]))
    bit_equal = bool(torch.equal(got, fine))
    frac = float((got.long() == want).float().mean())
    ok = bit_equal and frac > 0.999 and bool((got >= 0).any())
    log(f"kernel rasterize_topk vs plain [serving batch] N={fv.shape[0]} F={fv.shape[1]} {IMAGE}^2 K={K}"
        f" blur={BLUR}: ids bit-equal to rasterize_fine's {bit_equal}; slots equal to the plain version's"
        f" {frac:.6f} -> {'ok' if ok else 'FAIL'}")
    check(ok, "rasterize_topk kernel disagrees with rasterize_fine or its plain version")
    return 1.0 - frac, plain_ms


def phase_hard_kernel(device):
    """#3 at the serving batch for the 8 azimuths against
    `rasterize_hard_plain`: ids on >= HARD_IDS_GATE of pixels, zbuf within
    1e-5 and bary within 1e-4 where they agree, -1 in every empty pixel.
    Returns the largest zbuf/bary difference and the plain version's ms
    (azimuth 30)."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    size = (IMAGE, IMAGE)
    meshes = main_path_meshes(device)
    worst, failed, plain_ms = 0.0, [], None
    for azim in AZIMUTHS:
        fv, valid = face_inputs(meshes, camera(azim, device), size)
        got = rc.rasterize_hard_cuda(fv, valid, size)
        (want, ms) = timed_ms(lambda: rc.rasterize_hard_plain(fv, valid, size))
        plain_ms = plain_ms or ms
        same = got[0].long() == want[0]
        frac = float(same.float().mean())
        zerr = float((got[1] - want[1]).abs()[same].max())
        berr = float((got[2] - want[2]).abs()[same[..., None].expand_as(got[2])].max())
        empty = got[0] < 0
        fills = bool((got[1][empty] == -1).all() and (got[2][empty[..., None].expand_as(got[2])] == -1).all())
        ok = frac >= HARD_IDS_GATE and zerr <= 1e-5 and berr <= 1e-4 and fills and bool((~empty).any())
        worst = max(worst, zerr, berr)
        log(f"kernel rasterize_hard vs plain [serving batch, azim {azim:.0f}] N={fv.shape[0]} F={fv.shape[1]}"
            f" {IMAGE}^2: ids equal {frac:.6f}, covered px {int((~empty).sum())}, max|diff| zbuf {zerr:.3e}"
            f" bary {berr:.3e}, empty fills -1 {fills} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(azim)
    check(not failed, f"rasterize_hard kernel disagrees with its plain version at azimuths {failed}")
    return worst, plain_ms


def select_kernel_cases(device, serving):
    """[(label, points, radius, valid, size)] of `phase_select_kernel`:
    request 0 of pulsar-serving as its renderer projects it, 20 000
    spheres across z = 0 and both depth bounds, and cloud 0 of
    `cull_edge_batch`."""
    import torch

    pos, _, rad = serving.scene
    pts, r, valid = serving.renderer._project_ndc(pos, rad, pulsar_cam(PULSAR_YAWS[0], device), *PULSAR_DEPTH)
    gen = torch.Generator(device=device).manual_seed(5)
    mixed = torch.cat([torch.rand((20_000, 2), generator=gen, device=device) * 2.2 - 1.1,
                       torch.rand((20_000, 1), generator=gen, device=device) * 4.5 - 0.5], -1)
    mixed_r = torch.rand(20_000, generator=gen, device=device) * 0.02 + 0.002
    mixed_valid = (mixed[:, 2] > 0.5) & (mixed[:, 2] < 3.5)
    edge = [t[0].contiguous() for t in cull_edge_batch(device)]
    return [
        (f"pulsar-serving request 0, P={PULSAR_SPHERES}", pts.contiguous(), r.contiguous(), valid,
         (PULSAR_IMAGE, PULSAR_IMAGE)),
        ("20 000 spheres across z = 0 and the depth bounds 0.5 / 3.5, 512^2", mixed, mixed_r, mixed_valid,
         (512, 512)),
        (f"cull edges (cull_edge_points, seed 0), {CULL_EDGE_IMAGE[0]}x{CULL_EDGE_IMAGE[1]}", *edge, CULL_EDGE_IMAGE),
    ]


def phase_select_kernel(device, serving):
    """#6 on request 0 of pulsar-serving against the plain selection
    (>= PULSAR_IDS_GATE of slots; expected: all) and against #5 on the
    same binning (equal), and on an NDC scene with spheres on both sides
    of both depth bounds and of z = 0, and on the cull's edge cases.
    Keeps request 0's plain ids for the pulsar-serving path.  Returns the
    share of slots off the plain version."""
    import torch

    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc
    from pytorch3d_tpu_torch.renderer.points.rasterize_points import rasterize_points_topk

    worst, failed = 0.0, []
    for label, p, rr, v, sz in select_kernel_cases(device, serving):
        bins = rpc.bin_points_for_pulsar(p, rr, v, sz)
        got = rpc.select_points_cuda(p, rr, v, sz, PULSAR_TRACK, bins)
        five = rpc._run_kernel(p[None], rr[None], bins[:4], sz, PULSAR_TRACK)[0][0]
        want, ms = timed_ms(lambda: rasterize_points_topk(p, rr, v, sz, PULSAR_TRACK))
        if serving.plain_ids is None:
            serving.plain_ids, serving.plain_select_ms = want.int(), ms
        frac = float((got.long() == want).float().mean())
        same5 = bool(torch.equal(got, five))
        ok = frac >= PULSAR_IDS_GATE and same5 and bool((got >= 0).any())
        worst = max(worst, 1.0 - frac)
        log(f"kernel select_points vs plain [{label}] K={PULSAR_TRACK}: slots equal {frac:.6f}, filled"
            f" {int((got >= 0).sum())}, equal to rasterize_points' ids on the same binning {same5}; plain"
            f" {ms:.1f} ms -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    check(not failed, f"select_points kernel disagrees: {failed}")
    return worst


def pulsar_points_inputs(device):
    """#8's inputs for cloud 0 of the pulsar-points scene as
    PulsarPointsRenderer makes them at its defaults (PULSAR_POINTS_GAMMA
    and PULSAR_POINTS_DEPTH, where the TPU body's split exp overflows):
    (table, idx, bins, a seeded random cotangent)."""
    import torch

    from pytorch3d_tpu_torch.renderer import PointsRasterizationSettings, PointsRasterizer, PulsarPointsRenderer

    cloud, cams = colored_points_scene(device)
    settings = PointsRasterizationSettings(image_size=PTS_IMAGE, radius=PTS_RADIUS, points_per_pixel=PTS_K)
    pp = PulsarPointsRenderer(PointsRasterizer(cams, settings))
    depth = PULSAR_POINTS_DEPTH
    pts, col = cloud.points_padded()[0], cloud.features_padded()[0]
    rad = torch.full((pts.shape[0],), PTS_RADIUS, device=device)
    with torch.no_grad():
        table, idx, bins = pp.renderer._prepare(pts, col, rad, pp._cam_params(cams, 0, depth[0]), *depth)
    gen = torch.Generator(device=device).manual_seed(9)
    ct = torch.randn((PTS_IMAGE, PTS_IMAGE, 3), generator=gen, device=device)
    return table.contiguous(), idx, bins, ct


def phase_pulsar_grad_kernel(device, serving, fit):
    """#8 on request 0 of pulsar-serving with a seeded random cotangent, on
    step 0 of pulsar-fit with its loss's cotangent, and on cloud 0 of
    pulsar-points at PulsarPointsRenderer's gamma (1e-4)."""
    import torch

    table, idx, bins = serving.inputs(PULSAR_YAWS[0])
    gen = torch.Generator(device=device).manual_seed(6)
    ct = torch.randn((PULSAR_IMAGE, PULSAR_IMAGE, 3), generator=gen, device=device)
    fit_inputs = fit.blend_inputs()
    pulsar_grad_twice(*fit_inputs, "pulsar-fit step 0")
    results = [
        compare_pulsar_grad(table.contiguous(), idx, bins, ct, "pulsar-serving request 0, random cotangent"),
        compare_pulsar_grad(*fit_inputs, "pulsar-fit step 0, its loss's cotangent"),
        compare_pulsar_grad(*pulsar_points_inputs(device), "pulsar-points cloud 0, random cotangent",
                            PULSAR_POINTS_GAMMA, PULSAR_POINTS_DEPTH),
    ]
    check(all(r[0] for r in results), "pulsar_grad kernel disagrees with the float64 plain version")
    return max(r[3] for r in results)


def phase_pulsar_serving(device, serving):
    """The 8 requests, one #6 launch each; request 0 against the plain path
    (the plain selection's ids from the kernel phase); then one request at
    1 000 000 spheres, checked finite with its coverage logged (its plain
    selection, ~10x request 0's, does not fit the run)."""
    import torch

    ren = serving.renderer
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        images = [pulsar_render(ren, serving.scene, yaw, device) for yaw in PULSAR_YAWS]
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["select_points"] == PULSAR_REQUESTS and counts["pulsar_grad"] == 0,
          f"pulsar-serving: launches {counts} for {PULSAR_REQUESTS} requests (1 select each)")
    coverage = [float((img.sum(-1) < 2.9).float().mean()) for img in images]
    for i, img in enumerate(images):
        check(img.shape == (PULSAR_IMAGE, PULSAR_IMAGE, 3), f"request {i}: image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"request {i}: non-finite pixels")
    check(min(coverage) > 0.1, f"pulsar-serving: coverage {coverage}")
    with torch.no_grad():
        plain = pulsar_render(plain_pulsar(ren, serving.plain_ids), serving.scene, PULSAR_YAWS[0], device)
    frac, worst = image_agreement(images[0], plain, PULSAR_IMAGE_TOL)
    log(f"pulsar-serving: {PULSAR_REQUESTS} requests of {PULSAR_SPHERES} spheres at {PULSAR_IMAGE}^2,"
        f" n_track {PULSAR_TRACK}, gamma {PULSAR_GAMMA}, yaws {[round(y, 4) for y in PULSAR_YAWS]}: launches"
        f" {counts}; coverage {[round(c, 4) for c in coverage]}; request 0 against the plain path: |diff| <="
        f" {PULSAR_IMAGE_TOL:g} on {frac:.6f} of pixels (max {worst:.3e})")
    check(frac >= PULSAR_IMAGE_SHARE, f"pulsar-serving: only {frac:.6f} of pixels match the plain path")

    big = pulsar_scene(device, PULSAR_BIG)
    big_ren = pulsar_renderer(PULSAR_BIG)
    reset_counts()
    with torch.no_grad():
        img, ms = timed_ms(lambda: pulsar_render(big_ren, big, 0.0, device))
    big_counts = read_counts()
    cov = float((img.sum(-1) < 2.9).float().mean())
    log(f"pulsar-serving at {PULSAR_BIG} spheres, {PULSAR_IMAGE}^2: launches {big_counts}, first request"
        f" {ms:.1f} ms, coverage {cov:.4f}; finite {bool(torch.isfinite(img).all())}; not compared with the"
        f" plain path (its selection would take ~10x request 0's {serving.plain_select_ms:.0f} ms)")
    check(bool(torch.isfinite(img).all()) and cov > 0.1, "pulsar-serving at 1 M spheres: non-finite or empty")
    counts["select_points"] += big_counts["select_points"]
    return counts, big, big_ren


def phase_pulsar_fit(device, fit):
    """PULSAR_FIT_STEPS Adam steps; the loss must fall and stay finite;
    one #6 and one #8 per step; the step's time split."""
    import torch

    losses, fwd_ms, bwd_ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(PULSAR_FIT_STEPS):
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"pulsar-fit: {PULSAR_FIT_STEPS} Adam({PULSAR_FIT_LR:g}) steps, {PULSAR_SPHERES} spheres at {PULSAR_IMAGE}^2:"
        f" losses {[round(v, 8) for v in losses]}; launches {counts}")
    check(all(math.isfinite(v) for v in losses), "pulsar-fit: non-finite loss")
    check(losses[-1] < losses[0], f"pulsar-fit: loss did not fall ({losses[0]:.8f} -> {losses[-1]:.8f})")
    want = {"select_points": PULSAR_FIT_STEPS, "pulsar_grad": PULSAR_FIT_STEPS}
    check(all(counts[k] == n for k, n in want.items()), f"pulsar-fit: launches {counts}, expected {want}")
    check(all(bool(torch.isfinite(t).all()) for t in (fit.pos, fit.col, fit.rad, fit.opa)), "pulsar-fit: NaN parameters")
    last = slice(PULSAR_FIT_STEPS - PULSAR_FIT_TIMED, None)
    step = sorted(f + b for f, b in zip(fwd_ms[last], bwd_ms[last]))
    mid = PULSAR_FIT_TIMED // 2
    log(f"times [pulsar-fit step] median of the last {PULSAR_FIT_TIMED}: step {step[mid]:.3f} ms (min {step[0]:.3f},"
        f" max {step[-1]:.3f}); forward {sorted(fwd_ms[last])[mid]:.3f} ms; backward + Adam"
        f" {sorted(bwd_ms[last])[mid]:.3f} ms; peak memory {peak_gb:.2f} GB")
    return counts


def phase_pulsar_points(device):
    """PulsarPointsRenderer on the points-serving scene (30 000 points,
    256^2, radius 0.006) with its 8 FoVOrthographicCameras, one #6 launch
    per cloud, against the same renderer on the plain path."""
    import torch

    from pytorch3d_tpu_torch.renderer import PointsRasterizationSettings, PointsRasterizer, PulsarPointsRenderer

    cloud, cams = colored_points_scene(device)
    clouds = cloud.extend(PTS_REQUESTS)
    settings = PointsRasterizationSettings(image_size=PTS_IMAGE, radius=PTS_RADIUS, points_per_pixel=PTS_K)
    pulsar = PulsarPointsRenderer(PointsRasterizer(cams, settings))
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        images, ms = timed_ms(lambda: pulsar(clouds))
    counts = read_counts()
    check(counts["select_points"] == PTS_REQUESTS, f"pulsar-points: launches {counts} for {PTS_REQUESTS} clouds")
    check(images.shape == (PTS_REQUESTS, PTS_IMAGE, PTS_IMAGE, 3) and bool(torch.isfinite(images).all()),
          f"pulsar-points: image shape {tuple(images.shape)} or non-finite pixels")
    coverage = (images.sum(-1) < 2.9).float().mean(dim=(1, 2))
    plain_renderer = PulsarPointsRenderer(PointsRasterizer(cams, settings))
    plain_renderer.renderer = plain_pulsar(plain_renderer.renderer)
    with torch.no_grad():
        plain = plain_renderer(clouds)
    frac, worst = image_agreement(images, plain, PULSAR_IMAGE_TOL)
    log(f"pulsar-points: {PTS_REQUESTS} clouds of {PTS_SAMPLES} points at {PTS_IMAGE}^2, radius {PTS_RADIUS}:"
        f" launches {counts}, first call {ms:.1f} ms; coverage {[round(float(c), 4) for c in coverage]};"
        f" against the plain path |diff| <= {PULSAR_IMAGE_TOL:g} on {frac:.6f} of pixels (max {worst:.3e})")
    check(bool((coverage > 0.02).all()), f"pulsar-points: coverage {coverage.tolist()}")
    check(frac >= PULSAR_IMAGE_SHARE, f"pulsar-points: only {frac:.6f} of pixels match the plain path")
    return counts, pulsar, clouds


def gl_renderer(cams, device):
    from pytorch3d_tpu_torch.renderer import (
        HardPhongShader, MeshRasterizerOpenGL, MeshRenderer, PointLights, RasterizationSettings,
    )

    settings = RasterizationSettings(image_size=IMAGE, faces_per_pixel=1)
    lights = PointLights.create(location=[[0, 0, -3]], device=device)
    return MeshRenderer(MeshRasterizerOpenGL(cams, settings), HardPhongShader(cameras=cams, lights=lights, device=device))


def plain_gl():
    """The plain path of `MeshRasterizerOpenGL`: within the block, the
    hard kernel's wrapper is its plain version `rasterize_hard_plain`."""
    from unittest import mock

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    return mock.patch.object(rc, "rasterize_hard_cuda", rc.rasterize_hard_plain)


def phase_mesh_gl_serving(device):
    """MeshRenderer(MeshRasterizerOpenGL, HardPhongShader) on the serving
    batch at the 8 azimuths, one #3 launch per frame, each frame against
    the same renderer on the plain path (`plain_gl`)."""
    import torch

    meshes = main_path_meshes(device)
    cams = [camera(a, device) for a in AZIMUTHS]
    renderers = [gl_renderer(c, device) for c in cams]
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        images = [r(meshes) for r in renderers]
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["rasterize_hard"] == FRAMES and counts["rasterize_fine"] == 0,
          f"mesh-gl-serving: launches {counts} for {FRAMES} frames (1 hard raster each)")
    for i, (img, c) in enumerate(zip(images, cams)):
        check(img.shape == (2, IMAGE, IMAGE, 4) and bool(torch.isfinite(img).all()),
              f"mesh-gl frame {i}: shape {tuple(img.shape)} or non-finite pixels")
        with torch.no_grad(), plain_gl():
            plain = renderers[i](meshes)
        frac, worst = image_agreement(img, plain, 1e-3)
        covered = (img[..., 3] > 0).sum(dim=(1, 2))
        log(f"  mesh-gl frame {i} azim {AZIMUTHS[i]:.0f}: covered px {covered.tolist()}, |image - plain path"
            f" image| <= 1e-3 on {frac:.6f} of pixels (max {worst:.3e})")
        check(bool((covered > 0).all()), f"mesh-gl frame {i}: an image covers no pixel")
        check(frac >= 0.995, f"mesh-gl frame {i}: only {frac:.6f} of pixels match the plain path")
    log(f"mesh-gl-serving: {FRAMES} frames of N={len(meshes)} meshes at {IMAGE}^2: launches {counts}")
    return counts, meshes, renderers


def phase_serving_topk(device):
    """`rasterize_topk_cuda` driven at the serving batch, one launch per
    image."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    size = (IMAGE, IMAGE)
    fv, valid = face_inputs(main_path_meshes(device), camera(30.0, device), size)
    torch.cuda.synchronize()
    reset_counts()
    ids = [rc.rasterize_topk_cuda(fv[n], valid[n], size, BLUR, K, True, True) for n in range(len(fv))]
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["rasterize_topk"] == len(fv), f"serving-topk: launches {counts} for {len(fv)} images")
    check(all(bool((i >= 0).any()) for i in ids), "serving-topk: an image selects no face")
    log(f"serving-topk: rasterize_topk_cuda on the serving batch ({len(fv)} images, {IMAGE}^2, K={K}):"
        f" launches {counts}")
    return counts


def phase_slice5_times(device, serving, fit, topk_plain_ms, hard_plain_ms, state):
    """#2, #3, #6 and #8: device time (profiler) at their paths' shapes,
    beside their plain versions (timed once in the kernel phase, or here),
    bounds and, for #8, autograd of the plain blend; the pulsar-serving
    request and the mesh-gl frame; profiles of a pulsar request, a
    pulsar-fit step and a mesh-gl frame."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as rpc
    from pytorch3d_tpu_torch.renderer.points.pulsar.renderer import _blend_core

    rows = {}
    size = (IMAGE, IMAGE)
    fv, valid = face_inputs(main_path_meshes(device), camera(30.0, device), size)

    def topk():
        for n in range(len(fv)):
            rc.rasterize_topk_cuda(fv[n], valid[n], size, BLUR, K, True, True)

    kernel = device_ms(topk, "rasterize_fine_kernel<8, true>", iters=10, launches=len(fv))
    bound, by, tests = topk_bound(fv, valid, size, BLUR, K)
    rows["rasterize_topk"] = dict(kernel=kernel, plain=topk_plain_ms, bound=bound, bound_by=by, library=None)
    log(f"times [rasterize_topk, serving batch] N={len(fv)} F={fv.shape[1]} {IMAGE}^2 K={K}: kernel {kernel:.4f} ms"
        f" (device time, profiler; both images), plain {topk_plain_ms:.2f} ms; bound {bound:.5f} ms by {by}"
        f" ({tests / 1e6:.3f} M box tests)")

    kernel = device_ms(lambda: rc.rasterize_hard_cuda(fv, valid, size), "rasterize_hard_kernel", iters=10)
    bound, by, tests = hard_bound(fv, valid, size)
    made, walked = hard_tests(fv, valid, size)
    rows["rasterize_hard"] = dict(kernel=kernel, plain=hard_plain_ms, bound=bound, bound_by=by, library=None)
    log(f"times [rasterize_hard, serving batch] N={len(fv)} F={fv.shape[1]} {IMAGE}^2: kernel {kernel:.4f} ms"
        f" (device time, profiler), plain {hard_plain_ms:.2f} ms; bound {bound:.5f} ms by {by}"
        f" ({tests / 1e6:.3f} M box tests; the kernel's warps walk {walked / 1e6:.3f} M lanes, {made / 1e6:.3f} M"
        f" of them in the faces' pixel boxes)")

    psize = (PULSAR_IMAGE, PULSAR_IMAGE)
    table, idx, bins = serving.inputs(PULSAR_YAWS[0])
    pts, rad, v = (t.contiguous() for t in serving.renderer._project_ndc(
        serving.scene[0], serving.scene[2], pulsar_cam(PULSAR_YAWS[0], device), *PULSAR_DEPTH))
    kernel = device_ms(lambda: rpc.select_points_cuda(pts, rad, v, psize, PULSAR_TRACK, bins), "rasterize_points_kernel",
                       iters=10)
    binning = cuda_ms(lambda: rpc.bin_points_for_pulsar(pts, rad, v, psize), iters=10)
    filled = int((idx >= 0).sum())
    bound, by, tests = select_bound(pts, rad, v, psize, PULSAR_TRACK, filled)
    rows["select_points"] = dict(kernel=kernel, plain=serving.plain_select_ms, bound=bound, bound_by=by, library=None)
    log(f"times [select_points, pulsar-serving request 0] P={PULSAR_SPHERES} {PULSAR_IMAGE}^2 K={PULSAR_TRACK}:"
        f" kernel {kernel:.4f} ms (device time, profiler), binning {binning:.4f} ms, plain"
        f" {serving.plain_select_ms:.1f} ms; bound {bound:.5f} ms by {by} ({tests / 1e6:.3f} M box tests,"
        f" {filled} filled slots, {bins[0].numel()} tile-sphere pairs)")
    big, big_ren = state["big"]
    bpts, brad, bv = (t.contiguous() for t in big_ren._project_ndc(big[0], big[2], pulsar_cam(0.0, device), *PULSAR_DEPTH))
    bbins = rpc.bin_points_for_pulsar(bpts, brad, bv, psize)
    bk = device_ms(lambda: rpc.select_points_cuda(bpts, brad, bv, psize, PULSAR_TRACK, bbins),
                   "rasterize_points_kernel", iters=5)
    bbinning = cuda_ms(lambda: rpc.bin_points_for_pulsar(bpts, brad, bv, psize), iters=3)
    log(f"times [select_points, {PULSAR_BIG} spheres (timing only)] kernel {bk:.4f} ms (device time, profiler), binning {bbinning:.4f} ms,"
        f" {bbins[0].numel()} tile-sphere pairs")
    with torch.no_grad():
        btable, bidx, bbins = big_ren._prepare(big[0], big[1], big[2], pulsar_cam(0.0, device), *PULSAR_DEPTH)
        bones = torch.ones(3, device=device)
        benv = _blend_core(btable, bidx, bones, PULSAR_GAMMA, *PULSAR_DEPTH, 0.0, *psize)[1:3]
    bct = torch.randn((*psize, 3), generator=torch.Generator(device=device).manual_seed(8), device=device)
    pulsar_grad_twice(btable.contiguous(), bidx, bbins, bct, f"{PULSAR_BIG} spheres, random cotangent")
    bk = device_ms(lambda: rpc.pulsar_blend_grads_cuda(btable, bidx, bct, *benv, bones, psize, PULSAR_GAMMA,
                                                       *PULSAR_DEPTH, 0.0, bbins),
                   ("pulsar_grad_tiles_kernel", "pulsar_grad_combine_kernel"), iters=5)
    bbound, bby, bhits = pulsar_grad_bound(btable, bidx)
    log(f"times [pulsar_grad, {PULSAR_BIG} spheres (timing only, random cotangent)] kernel {bk:.4f} ms (device time, profiler; both"
        f" passes); bound {bbound:.5f} ms by {bby} ({bhits} filled hits, {bbins[0].numel()} tile-sphere pairs)")
    del btable, bidx, bbins, benv, bct

    bg = torch.ones(3, device=device)
    args = (PULSAR_GAMMA, *PULSAR_DEPTH)
    cases = [("pulsar-fit step", *fit.blend_inputs())]
    gen = torch.Generator(device=device).manual_seed(6)
    cases.append(("pulsar-serving request 0, random cotangent", table.contiguous(), idx, bins,
                  torch.randn((*psize, 3), generator=gen, device=device)))
    grads = {}
    for label, t, i, b, ct in cases:
        _, denom, lm, _, _ = _blend_core(t, i, bg, *args, 0.0, *psize)
        kernel = device_ms(lambda: rpc.pulsar_blend_grads_cuda(t, i, ct, denom, lm, bg, psize, *args, 0.0, b),
                           ("pulsar_grad_tiles_kernel", "pulsar_grad_combine_kernel"), iters=10)
        plain = cuda_ms(lambda: rpc.pulsar_blend_grads_plain(t, i, ct, denom, lm, bg, psize, *args, 0.0), iters=3, warmup=1)
        tg = t.detach().requires_grad_(True)
        out = _blend_core(tg, i, bg, *args, 0.0, *psize)[0]
        library = cuda_ms(lambda: torch.autograd.grad(out, tg, ct, retain_graph=True), iters=3, warmup=1)
        del out
        bound, by, hits = pulsar_grad_bound(t, i)
        grads[label] = dict(kernel=kernel, plain=plain, bound=bound, bound_by=by, library=library)
        log(f"times [pulsar_grad, {label}] P={t.shape[0]} {PULSAR_IMAGE}^2 K={i.shape[2]}: kernel {kernel:.4f} ms"
            f" (device time, profiler; both passes), plain {plain:.3f} ms, library (autograd of the plain blend)"
            f" {library:.3f} ms; bound {bound:.5f} ms by {by} ({hits} filled hits, {b[0].numel()} tile-sphere pairs)")
    rows["pulsar_grad"] = grads["pulsar-fit step"]

    with torch.no_grad():
        req_ms = sorted(timed_ms(lambda: pulsar_render(serving.renderer, serving.scene, y, device))[1]
                        for y in PULSAR_YAWS)
        log(f"times [pulsar-serving request] median of {PULSAR_REQUESTS} {req_ms[PULSAR_REQUESTS // 2]:.3f} ms"
            f" (min {req_ms[0]:.3f}, max {req_ms[-1]:.3f})")
        profile("pulsar-serving request", lambda: [pulsar_render(serving.renderer, serving.scene, y, device)
                                                   for y in PULSAR_YAWS[:4]], 4)
        meshes, renderers = state["mesh"]
        frame_ms = sorted(timed_ms(lambda: r(meshes))[1] for r in renderers)
        log(f"times [mesh-gl-serving frame] N=2 meshes, {IMAGE}^2, HardPhong: median {frame_ms[FRAMES // 2]:.3f} ms,"
            f" min {frame_ms[0]:.3f} ms, max {frame_ms[-1]:.3f} ms")
        profile("mesh-gl-serving frame", lambda: [r(meshes) for r in renderers], FRAMES)
        pulsar_points, clouds = state["points"]
        pp_ms = sorted(timed_ms(lambda: pulsar_points(clouds))[1] for _ in range(5))
        log(f"times [pulsar-points frame] {PTS_REQUESTS} clouds in one call: median of 5 {pp_ms[2]:.3f} ms")

    def fit_steps():
        for _ in range(3):
            fit.optimizer.zero_grad()
            fit.forward().backward()
            fit.optimizer.step()

    profile("pulsar-fit step", fit_steps, 3)
    return rows


def kernel_rows(launches, errors, fine, grad, knn_t, points, points_grad, mlp, mlp_grad, field, field_grad, slice5):
    rows = []
    fused = "pytorch3d_tpu_torch/csrc/fused_mlp.cu"
    for name, source, replaces, t, library in (
        ("rasterize_fine", "pytorch3d_tpu_torch/csrc/rasterize_fine.cu",
         "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:324", fine, None),
        ("rasterize_grad", "pytorch3d_tpu_torch/csrc/rasterize_grad.cu",
         "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:809", grad, None),
        ("knn", "pytorch3d_tpu_torch/csrc/knn.cu", "pytorch3d_tpu/ops/knn_pallas.py:36", knn_t, knn_t["library"]),
        ("rasterize_points", "pytorch3d_tpu_torch/csrc/rasterize_points.cu",
         "pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:285", points, None),
        ("rasterize_points_grad", "pytorch3d_tpu_torch/csrc/rasterize_points_grad.cu",
         "pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:365", points_grad, None),
        ("fused_mlp", fused, "pytorch3d_tpu/ops/fused_mlp_pallas.py:70", mlp, mlp["library"]),
        ("fused_mlp_grad", fused, "pytorch3d_tpu/ops/fused_mlp_pallas.py:79", mlp_grad, mlp_grad["library"]),
        ("nerf_field", fused, "pytorch3d_tpu/ops/fused_mlp_pallas.py:328", field, field["library"]),
        ("nerf_field_grad", fused, "pytorch3d_tpu/ops/fused_mlp_pallas.py:341", field_grad, field_grad["library"]),
        ("rasterize_topk", "pytorch3d_tpu_torch/csrc/rasterize_fine.cu",
         "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:601", slice5["rasterize_topk"], None),
        ("rasterize_hard", "pytorch3d_tpu_torch/csrc/rasterize_hard.cu",
         "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:635", slice5["rasterize_hard"], None),
        ("select_points", "pytorch3d_tpu_torch/csrc/rasterize_points.cu",
         "pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:791", slice5["select_points"], None),
        ("pulsar_grad", "pytorch3d_tpu_torch/csrc/pulsar_grad.cu",
         "pytorch3d_tpu/renderer/points/rasterize_points_pallas.py:618", slice5["pulsar_grad"],
         slice5["pulsar_grad"]["library"]),
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
        pfit = PointsFit(device)
        nerf = NeRFScene(device)
        serving5, fit5 = PulsarServing(device), PulsarFit(device)
        topk_err, topk_plain_ms = phase_topk_kernel(device)
        hard_err, hard_plain_ms = phase_hard_kernel(device)
        errors = {
            "rasterize_fine": phase_fine_kernel(device),
            "rasterize_grad": phase_grad_kernel(device),
            "knn": phase_knn_kernel(device, pfit),
            "rasterize_points": phase_points_kernel(device),
            "rasterize_points_grad": phase_points_grad_kernel(device, pfit),
            **phase_fused_kernels(device, nerf),
            "rasterize_topk": topk_err,
            "rasterize_hard": hard_err,
            "select_points": phase_select_kernel(device, serving5),
            "pulsar_grad": phase_pulsar_grad_kernel(device, serving5, fit5),
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
        phase = "points-serving"
        paths["points-serving"], clouds, points_render = phase_points_serving(device)
        phase = "points-bench"
        paths["points-bench"], _ = phase_points_bench(device)
        phase = "training: points-fit"
        paths["points-fit"] = phase_points_fit(device, pfit)
        phase = "nerf-trunk"
        paths["nerf-trunk"] = phase_nerf_trunk(device, nerf)
        phase = "nerf-serving"
        paths["nerf-serving"] = phase_nerf_serving(device, nerf)
        phase = "training: nerf-train"
        phase_nerf_step0(device, nerf)
        paths["nerf-train"] = phase_nerf_train(device, nerf)
        phase = "serving-topk"
        paths["serving-topk"] = phase_serving_topk(device)
        phase = "pulsar-serving"
        paths["pulsar-serving"], big, big_ren = phase_pulsar_serving(device, serving5)
        phase = "training: pulsar-fit"
        paths["pulsar-fit"] = phase_pulsar_fit(device, fit5)
        phase = "pulsar-points"
        paths["pulsar-points"], pulsar_points, pulsar_clouds = phase_pulsar_points(device)
        phase = "mesh-gl-serving"
        paths["mesh-gl-serving"], gl_meshes, gl_renderers = phase_mesh_gl_serving(device)
        for counts in paths.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        for kernel in KERNELS:
            check(launches[kernel] > 0, f"{kernel} was launched no time on the paths")
        log(f"launches by path: {paths}; summed {launches}")
        phase = "times"
        fine, grad, knn_t = phase_times(device, meshes, renderers, fit, pfit)
        points_t, points_grad_t = phase_points_times(device, clouds, points_render, pfit)
        nerf_t = phase_nerf_times(device, nerf)
        slice5 = phase_slice5_times(device, serving5, fit5, topk_plain_ms, hard_plain_ms, {
            "big": (big, big_ren), "mesh": (gl_meshes, gl_renderers), "points": (pulsar_points, pulsar_clouds),
        })
        kernels = kernel_rows(launches, errors, fine, grad, knn_t, points_t, points_grad_t, *nerf_t, slice5)
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
