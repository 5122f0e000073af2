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
   and profiles of both and of pulsar-fit steps; the band builds of #1 and
   #4 at band-raster's splits (slice 15) by the profiler's device time.
10. slice 12, after the times: the rest of the mesh path through #1 and
    #4 (PyTorch3D's tutorial render_textured_meshes.ipynb with
    ico_sphere(4) in cow.obj's place): mesh-uv-serving renders 20 views
    at 512^2 (blur 0, K=1, SoftPhongShader) of the sphere with per-corner
    UVs into a seeded 1024^2 map, then with a seeded R=8 TexturesAtlas,
    the first 2 views of each against the plain route (ids > 99.9 %, images 1e-3 on >= 99.5 %);
    mesh-uv-fit takes 20 Adam steps of the 1024^2 map and a vertex offset
    at render-fit's settings toward hard renders of the true map (falling
    loss; step 0's map gradient within 1e-4 and vertex gradient within
    #4's gate of the plain route's on 2 views); mesh-clip rasterizes
    ico_sphere(4) with `z_clip_value=0.1` from tests/test_clip.py's camera
    inside it and one grazing its wall, forward and backward (ids, zbuf,
    bary and the NDC vertex gradient against the plain route, ids < F,
    depths beyond the plane, cut faces covering pixels, #4 on the clipped
    table bit-equal twice and against float64); mesh-shaders holds
    HardFlat, SoftGouraud, the two depth shaders and SplatterPhong (with
    its vertex gradient) against the plain route on 2 views; each logs
    its frame or step times and a profile with the device's idle share.
11. slice 13, after slice 12: joined scenes, SE(3), camera indexing and
    conversions, fisheye and point normals through #1, #3, #4, #6 and #9:
    joined-scene-serving renders PyTorch3D's joined spheres
    (`join_meshes_as_scene`) at 512^2, K=1, to 8 azimuths whose cameras are
    joined by `join_cameras_as_batch`, under HardPhong, HardGouraud and
    HardFlat (#1) and SplatterPhong through `MeshRasterizerOpenGL` (#3);
    fisheye-serving renders ico_sphere(5) through the golden's
    `FishEyeCameras` from two views under the same three shaders (#1);
    pose-fit takes 20 Adam steps of a per-view se(3) log on render-fit's 8
    views built by `cameras_from_opencv_projection` (#1, #4), then drives
    one pulsar request through `pulsar_from_opencv_projection` (#6); normals
    runs `Pointclouds.estimate_normals` on points-serving's 8 clouds at K=16
    (#9) and at the default K=50 (the plain KNN on the card).  Each against
    the plain route (2 views or clouds), with the gates its docstring names.
12. slice 14, after slice 13: volumes and the implicit renderer through
    #12 and #13: volume-fit takes 20 Adam steps of PyTorch3D's
    fit_textured_volume tutorial (a 128^3 grid through VolumeRenderer at
    64^2, 150 points, 10 of cow.npz's views a step; step 0's image and
    gradients against float64); implicit-nerf drives the full-width
    NeuralRadianceField through ImplicitRenderer as the
    fit_simple_neural_radiance_field tutorial does (12 Adam steps of 6 x 750
    Monte Carlo rays, #12 saving and #13, step 0's gradients against the
    plain field and float64), then serves the 8 test views at 64^2 (#12),
    one mask-weighted grid-subsampling request and one n_rays_total
    request, each against use_fused_kernel=False; nerf-remat runs the NeRF
    training step with remat=True beside remat=False (bit-equal gradients,
    #12 launched by both builds, peak memory); points-to-volume splats
    points-serving's 30 000 points into 128^3 in both modes (against
    float64) and renders each volume at 256^2 for 8 azimuths;
    point-mesh-distance runs the face and edge distances and
    mesh_face_areas_normals at chamfer-fit's shapes against float64.
13. slice 15, after slice 14: the row-band rasterizer and the parallel
    package, then ICP, EPnP, camera alignment, farthest point sampling and
    ball query: band-raster runs the headline in 4 bands of 128 rows, and
    480^2 in 4 bands of 120, through `rasterize_fragments_band_cuda` (the
    band builds of #1 and #4), each band equal to the bit to the full
    image's rows; sharded-raster runs `sharded_silhouette_loss_and_grad`
    in a world-1 NCCL group here and in 2 gloo ranks spawned on the card;
    sharded-nerf takes 10 steps of the NeRF step on a (1, 2) mesh of
    spawned gloo ranks (#12, #13 on both), step 0 against the
    single-device step; alignment-ops runs ICP through #9 on
    points-serving's 8 clouds against the plain KNN route, farthest point
    sampling, ball query, EPnP and camera alignment against float64.
14. slice 16, after slice 15: mesh-ops runs cubify (4 x 32^3), marching
    cubes (a 64^3 sphere SDF), box3d_overlap (10^4 pairs), SubdivideMeshes,
    vert_align (Mesh R-CNN's 4-level pyramid), GraphConv (128 channels) and
    Taubin smoothing on the card against the same calls on the CPU;
    nerf-trainer runs the flagship's trainer at full width as a user does
    (`train_nerf.main`: 2 epochs on the rendered-sphere dataset through #1,
    #12 and #13, a falling loss, then a resume that must hold the saved
    weights, Adam state and Stats to the bit and run epoch 2 alone), then
    `test_nerf` (the trained model's PSNR above its init's on every test
    frame, a frame against use_fused_kernel=False, the 40-frame export
    trajectory through #12 and its video where PIL is installed).
15. slice 17, after slice 16: mesh and point cloud IO and Implicitron's
    frame loading through #1 and #5: mesh-io writes mesh-uv-serving's
    sphere and 1024^2 map with `save_obj` (OBJ + MTL + PNG), loads it on
    the card with `load_objs_as_meshes` as TexturesUV and as TexturesAtlas
    (verts within 6 decimals, faces and UV indices equal, the map within
    1/255) and serves the tutorial's 20 views at 512^2 through #1 (2
    against the plain route); the same mesh through `IO` as binary and
    ASCII PLY, OFF with vertex colours and GLB, each rasterized against its
    plain route; an ico_sphere(7) OBJ through the native parser (which must
    have built) and the Python scanner, equal; points-serving's cloud
    through binary PLY, served for the 8 azimuths through #5 with both
    compositors (ids and zbuf equal to the in-memory cloud's, images within
    1/255).  implicitron-data builds `RenderedMeshDatasetMapProvider` from a
    `get_default_args` dict with that OBJ as `data_file` (40 views through
    #1, 2 against the plain route), writes its frames as a CO3D-style tree
    and rebuilds them with `GenericFrameDataBuilder(box_crop=True)` at
    256^2, and subsamples a PLY of the scene with `load_pointcloud`, both on
    the card against the CPU within 1e-6.  Files go to temporary
    directories that the phases remove.
16. slice 18, after slice 17: Implicitron's GenericModel at
    repro_base.yaml's size (400^2, 8 x 256 trunk with the skip at 5, 64 +
    64 points, harmonics 10 / 4) on the provider's ico sphere rendered at
    400^2.  implicitron-serving serves 4 EVALUATION frames of the full grid
    in 2 chunks of 102 400 rays (#12's serving build) and holds them to
    use_fused_kernel=False under nerf-serving's limits; implicitron-train
    holds step 0's objective and every gradient to the plain route on the
    same draws (float64 witnesses on each pass's shared bundle), then takes
    20 Adam steps (#12's saving build and #13) whose objective must fall;
    implicitron-sharded runs `make_sharded_generic_train_step` 5 steps in a
    world-1 NCCL group and on 2 gloo ranks spawned on the card, against the
    same steps taken in one process; model-dbir runs `ModelDBIR` at its
    defaults on 8 views with #1's zbuf as depth, through #5 against the
    plain rasterizer (ids, zbuf, masks and depths equal, images within
    1/255).
17. slice 19, after slice 18: Implicitron's view-pooled models at the
    repro configs' widths on the provider's sphere at 400^2 (rendered
    anew, #1), batches of 10 frames that are also the source views.
    implicitron-wce-serving serves repro_multiseq_nerf_wce (resnet34
    features, angle-weighted mean and std, a 256-wide sequence code: the
    trunk's input D = 455) from 10 source views, 400^2 in 10 chunks of
    16 000 rays through #12, against use_fused_kernel=False;
    implicitron-wce-train trains repro_singleseq_nerf_wce (D = 327) 10 Adam
    steps of 10 x 1024 rays through #12 / #13, step 0 held to the plain
    route and its float64 witness; flyaround runs `render_flyaround` with
    8 poses of the serving model into a GIF; nerformer serves and trains
    repro_singleseq_nerformer (5 x 800 rays a step: 10 ran out of memory),
    step 0 held against float64 copies of the extractor and the
    functions; fused-wide holds #10-#13 at D = 327, 455 and 512 against
    the plain versions and checks the refusal past the input limit.

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
BAND_KERNELS = ("rasterize_fine_band", "rasterize_grad_band")  # #1 and #4 over a band of rows (slice 15)
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
        "rasterize_fine_band": rc.rasterize_fragments_band_cuda,
        "rasterize_grad_band": rc.rasterize_grad_band_cuda,
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


def headline_loss(zbuf, dists):
    """bench.py:117-119's loss."""
    import torch

    return torch.sum(torch.sigmoid(-dists / 1e-4)) * 1e-6 + torch.sum(zbuf) * 1e-6


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
        loss = headline_loss(zbuf, dists)
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
    return {key: (ms / units, count / units) for key, ms, count in rows}


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

        from pytorch3d_tpu_torch.parallel import make_nerf_train_step

        data = np.load(NERF_DATA)
        self.device = device
        self.images = torch.tensor(data["images"].astype(np.float32), device=device)
        self.R = torch.tensor(data["R"], device=device)
        self.T = torch.tensor(data["T"], device=device)
        self.fov, self.znear, self.zfar = float(data["fov"]), float(data["znear"]), float(data["zfar"])
        self.test_idx = [int(i) for i in data["test_idx"]]
        self.train_idx = [i for i in range(len(self.images)) if i not in self.test_idx]
        self.model = nerf_model(device, 0)
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
    passes = {h: {"weight preparation": "fused_mlp_bwd_prep_kernel", "row pass": f"fused_mlp_bwd_rows_kernel<{flag[h]},",
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


# --------------------------------------------------------------------------- #
# Slice 12: UV and atlas textures, near-plane clipping, the other shaders
# --------------------------------------------------------------------------- #

# PyTorch3D's tutorial docs/tutorials/render_textured_meshes.ipynb, with a
# seeded ico_sphere(4) (5120 faces) in cow.obj's place (5856 faces, a 1024^2
# map): 20 views at 512^2, blur 0, K=1, a PointLights at (0, 0, -3).
UV_VIEWS = 20
UV_MAP = 1024
UV_ATLAS_R = 8
UV_CHECK_VIEWS = 2  # views of the plain-route comparisons (the plain rasterizer takes seconds a view)
UV_FRAMES = 5  # timed serving frames after the first
UV_FIT_STEPS = 20
UV_FIT_TIMED = 10  # the last steps, whose median is the step time
MAP_GRAD_GATE = 1e-4  # max |g - g_plain| <= MAP_GRAD_GATE * max |g_plain| for the map's gradient
# tests/test_clip.py::test_render_from_inside's camera, inside the sphere;
# a second view grazes the wall (from 0.03 inside it, looking along it),
# where faces cross the near plane in view
CLIP_DIST = 0.5
CLIP_GRAZE = ((0.0, 0.0, 0.97), (0.0, 1.0, 0.97), (0.0, 0.0, 1.0))  # eye, at, up
CLIP_ZNEAR = 0.05
CLIP_Z = 0.1
CLIP_K = 8
DEPTH_TOL = 5e-3


def sphere_uvs(verts, faces):
    """Per-corner UVs of a unit sphere: (F*3, 2) verts_uvs and (F, 3)
    faces_uvs (so Vuv = 3F and faces_uvs != faces).  u is the longitude,
    unwrapped inside each face so that no face straddles the seam; v the
    latitude."""
    import torch

    fv = verts[faces]  # (F, 3, 3)
    u = torch.atan2(fv[..., 0], fv[..., 2]) / (2 * math.pi) + 0.5
    u = torch.where(u - u[:, :1] > 0.5, u - 1.0, torch.where(u - u[:, :1] < -0.5, u + 1.0, u))
    v = torch.asin(fv[..., 1].clamp(-1.0, 1.0)) / math.pi + 0.5
    uvs = torch.stack([u, v], dim=-1).reshape(-1, 2)
    return uvs, torch.arange(uvs.shape[0], device=verts.device).reshape(-1, 3)


def uv_map(device, size=UV_MAP, seed=0):
    """A seeded (1, size, size, 3) map in [0, 1]: smooth bands plus noise."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.linspace(0.0, 1.0, size, device=device)
    y, x = torch.meshgrid(t, t, indexing="ij")
    phase = torch.rand(3, generator=gen, device=device) * 2 * math.pi
    freq = torch.tensor([3.0, 5.0, 7.0], device=device)
    smooth = 0.5 + 0.3 * torch.sin(2 * math.pi * freq * x[..., None] + phase) * torch.cos(
        2 * math.pi * (freq - 1.0) * y[..., None])
    noise = (torch.rand((size, size, 3), generator=gen, device=device) - 0.5) * 0.2
    return (smooth + noise).clamp(0.0, 1.0)[None]


def uv_textures(mesh, maps):
    """TexturesUV of `maps` over the sphere's per-corner UVs."""
    from pytorch3d_tpu_torch.renderer import TexturesUV

    uvs, faces_uvs = sphere_uvs(mesh.verts_padded()[0], mesh.faces_padded()[0])
    return TexturesUV.create(maps, faces_uvs[None], uvs[None], device=mesh.device)


def atlas_textures(mesh, seed=1):
    """TexturesAtlas of seeded per-face R x R texels."""
    import torch

    from pytorch3d_tpu_torch.renderer import TexturesAtlas

    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    atlas = torch.rand((1, mesh.max_faces, UV_ATLAS_R, UV_ATLAS_R, 3), generator=gen, device=mesh.device)
    return TexturesAtlas.create(atlas, device=mesh.device)


def tutorial_cameras(device, views=UV_VIEWS):
    """The tutorial's batch: elev linspace(0, 180), azim linspace(-180, 180),
    dist 2.7; the first `views` of its UV_VIEWS."""
    import torch

    from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras, look_at_view_transform

    elev = torch.linspace(0.0, 180.0, UV_VIEWS, device=device)
    azim = torch.linspace(-180.0, 180.0, UV_VIEWS, device=device)
    R, T = look_at_view_transform(dist=2.7, elev=elev, azim=azim, device=device)
    return FoVPerspectiveCameras.create(R=R[:views], T=T[:views], device=device)


def tutorial_renderer(cams, device, shader=None, bin_size=None):
    """MeshRendererWithFragments(MeshRasterizer(512^2, blur 0, K=1), shader
    (SoftPhongShader with the tutorial's light unless given))."""
    from pytorch3d_tpu_torch.renderer import (
        MeshRasterizer, MeshRendererWithFragments, PointLights, RasterizationSettings, SoftPhongShader,
    )

    settings = RasterizationSettings(image_size=IMAGE, blur_radius=0.0, faces_per_pixel=1, bin_size=bin_size)
    if shader is None:
        lights = PointLights.create(location=[[0.0, 0.0, -3.0]], device=device)
        shader = SoftPhongShader(cameras=cams, lights=lights, device=device)
    return MeshRendererWithFragments(MeshRasterizer(cams, settings), shader)


def host_frames(fn, frames):
    """Sorted host ms of `frames` calls of fn, each ending in a synchronize."""
    return sorted(timed_ms(fn)[1] for _ in range(frames))


def phase_mesh_uv_serving(device):
    """The tutorial's batch: 20 views of the UV-textured sphere (1024^2
    map) in one MeshRenderer call, then again with TexturesAtlas (R = 8);
    the first 2 views of each against the plain route (ids, images);
    frame times and a profile."""
    import torch

    from pytorch3d_tpu_torch.utils import ico_sphere

    mesh = ico_sphere(4, device=device)
    cams = tutorial_cameras(device)
    cams_check = tutorial_cameras(device, UV_CHECK_VIEWS)
    counts = dict.fromkeys(KERNELS, 0)
    textures = {"uv": uv_textures(mesh, uv_map(device)), "atlas": atlas_textures(mesh)}
    for label, tex in textures.items():
        meshes = mesh.replace(textures=tex).extend(UV_VIEWS)
        ren = tutorial_renderer(cams, device)
        torch.cuda.synchronize()
        reset_counts()
        with torch.no_grad():
            images, frags = ren(meshes)
        torch.cuda.synchronize()
        run = read_counts()
        check(run["rasterize_fine"] == 1, f"mesh-uv-serving [{label}]: launches {run} for one batch of {UV_VIEWS}")
        check(images.shape == (UV_VIEWS, IMAGE, IMAGE, 4) and bool(torch.isfinite(images).all()),
              f"mesh-uv-serving [{label}]: image shape {tuple(images.shape)} or non-finite pixels")
        covered = (images[..., 3] > 0).sum(dim=(1, 2))
        check(bool((covered > 0).all()), f"mesh-uv-serving [{label}]: a view covers no pixel ({covered.tolist()})")
        with torch.no_grad():
            plain, plain_frags = tutorial_renderer(cams_check, device, bin_size=0)(meshes[list(range(UV_CHECK_VIEWS))])
        ids = float((frags.pix_to_face[:UV_CHECK_VIEWS] == plain_frags.pix_to_face).float().mean())
        frac, worst = image_agreement(images[:UV_CHECK_VIEWS], plain, 1e-3)
        log(f"mesh-uv-serving [{label}]: {UV_VIEWS} views at {IMAGE}^2 K=1 blur 0 (map {UV_MAP}^2"
            f"{f', atlas R={UV_ATLAS_R}' if label == 'atlas' else ''}): launches {run}; covered px per view"
            f" {covered.min().item()}..{covered.max().item()}; views 0-{UV_CHECK_VIEWS - 1} against the plain route:"
            f" ids equal {ids:.6f}, |image - plain| <= 1e-3 on {frac:.6f} of pixels (max {worst:.3e})")
        check(ids > 0.999, f"mesh-uv-serving [{label}]: ids equal on only {ids:.6f} of pixels")
        check(frac >= 0.995, f"mesh-uv-serving [{label}]: only {frac:.6f} of pixels match the plain route")
        for k in counts:
            counts[k] += run[k]
        with torch.no_grad():
            ms = host_frames(lambda: ren(meshes), UV_FRAMES)
            log(f"times [mesh-uv-serving frame, {label}] {UV_VIEWS} views: median {ms[len(ms) // 2]:.3f} ms"
                f" (min {ms[0]:.3f}, max {ms[-1]:.3f}; {ms[len(ms) // 2] / UV_VIEWS:.3f} ms a view)")
            profile(f"mesh-uv-serving frame, {label}", lambda: ren(meshes), 1)
        del images, frags, plain, plain_frags
        torch.cuda.empty_cache()
    return counts, mesh, textures["uv"]


class UVFit:
    """RenderFit's settings (8 views at 512^2, K=16, blur log(1/1e-4 - 1) *
    1e-4) with a UV-textured source: the targets are the sphere with the
    true map rendered by HardPhongShader (K=1); Adam(5e-3) fits the 1024^2
    map, started at 0.5, and a vertex offset, under RenderFit's loss."""

    def __init__(self, device):
        import torch

        from pytorch3d_tpu_torch.renderer import (
            FoVPerspectiveCameras, HardPhongShader, MeshRasterizer, MeshRenderer, PointLights,
            RasterizationSettings, look_at_view_transform,
        )
        from pytorch3d_tpu_torch.utils import ico_sphere

        self.device = device
        self.src = ico_sphere(4, device=device)
        self.uvs, self.faces_uvs = sphere_uvs(self.src.verts_padded()[0], self.src.faces_padded()[0])
        azims = torch.linspace(-180.0, 180.0, FIT_VIEWS + 1, device=device)[:-1]
        self.R, self.T = look_at_view_transform(dist=2.8, elev=25.0, azim=azims, device=device)
        self.lights = PointLights.create(location=[[0.0, 2.0, -3.0]], device=device)
        cams = FoVPerspectiveCameras.create(R=self.R, T=self.T, fov=60.0, device=device)
        hard = MeshRenderer(
            MeshRasterizer(cams, RasterizationSettings(image_size=IMAGE, faces_per_pixel=1)),
            HardPhongShader(cameras=cams, lights=self.lights, device=device),
        )
        target = self.src.replace(textures=uv_textures(self.src, uv_map(device))).extend(FIT_VIEWS)
        with torch.no_grad():
            out = hard(target)
        self.target_images, self.target_sil = out[..., :3], out[..., 3]
        self.map = torch.full((1, UV_MAP, UV_MAP, 3), 0.5, device=device, requires_grad=True)
        self.deform = torch.zeros_like(self.src.verts_padded(), requires_grad=True)
        self.optimizer = torch.optim.Adam([self.map, self.deform], lr=5e-3)

    def mesh(self):
        from pytorch3d_tpu_torch.renderer import TexturesUV

        tex = TexturesUV.create(self.map, self.faces_uvs[None], self.uvs[None], device=self.device)
        return self.src.update_padded(self.src.verts_padded() + self.deform).replace(textures=tex)

    loss = RenderFit.loss

    def forward(self, views=None, bin_size=None):
        from pytorch3d_tpu_torch.renderer import (
            FoVPerspectiveCameras, MeshRasterizer, MeshRenderer, RasterizationSettings, SoftPhongShader,
        )

        views = views or FIT_VIEWS
        cams = FoVPerspectiveCameras.create(R=self.R[:views], T=self.T[:views], fov=60.0, device=self.device)
        settings = RasterizationSettings(image_size=IMAGE, faces_per_pixel=FIT_K, blur_radius=FIT_BLUR, bin_size=bin_size)
        soft = MeshRenderer(MeshRasterizer(cams, settings),
                            SoftPhongShader(cameras=cams, lights=self.lights, device=self.device))
        mesh = self.mesh()
        return self.loss(soft(mesh.extend(views)), mesh, views)

    def step(self):
        self.optimizer.zero_grad()
        loss = self.forward()
        loss.backward()
        self.optimizer.step()
        return loss


def phase_mesh_uv_fit(device):
    """UVFit: step 0's map and vertex gradients on 2 views against the
    plain route, then 20 Adam steps whose loss must fall."""
    import torch

    fit = UVFit(device)
    grads = [torch.autograd.grad(fit.forward(FIT_CHECK_VIEWS, b), [fit.map, fit.deform]) for b in (None, 0)]
    (map_cuda, verts_cuda), (map_plain, verts_plain) = grads
    map_err, map_ratio = grad_error(map_cuda, map_plain)
    v_err, v_ratio = grad_error(verts_cuda, verts_plain)
    log(f"mesh-uv-fit: step 0 gradients on {FIT_CHECK_VIEWS} views vs the plain route: map max|diff| {map_err:.3e}"
        f" = {map_ratio:.3e} of max|grad| ({int((map_plain != 0).sum())} texels touched), verts max|diff|"
        f" {v_err:.3e} = {v_ratio:.3e} of max|grad|")
    check(all(bool(torch.isfinite(g).all()) for g in (map_cuda, verts_cuda)), "mesh-uv-fit: non-finite gradient")
    check(map_ratio <= MAP_GRAD_GATE, f"mesh-uv-fit: map gradient {map_ratio:.3e} of max|grad| off the plain route's")
    check(v_ratio <= GRAD_GATE, f"mesh-uv-fit: vertex gradient {v_ratio:.3e} of max|grad| off the plain route's")
    del grads, map_cuda, verts_cuda, map_plain, verts_plain
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms = [], []
    for _ in range(UV_FIT_STEPS):
        t0 = time.perf_counter()
        loss = fit.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"mesh-uv-fit: {UV_FIT_STEPS} Adam steps, {FIT_VIEWS} views at {IMAGE}^2, K={FIT_K}, map {UV_MAP}^2:"
        f" losses {[round(v, 6) for v in losses]}; launches {counts}; peak memory {peak_gb:.2f} GB")
    check(all(math.isfinite(v) for v in losses), "mesh-uv-fit: non-finite loss")
    check(losses[-1] < losses[0], f"mesh-uv-fit: loss did not fall ({losses[0]:.6f} -> {losses[-1]:.6f})")
    check(counts["rasterize_fine"] == UV_FIT_STEPS and counts["rasterize_grad"] == UV_FIT_STEPS,
          f"mesh-uv-fit: launches {counts} for {UV_FIT_STEPS} steps (1 fine + 1 grad each)")
    check(bool(torch.isfinite(fit.map).all() and torch.isfinite(fit.deform).all()), "mesh-uv-fit: NaN parameters")
    timed = sorted(step_ms[-UV_FIT_TIMED:])
    log(f"times [mesh-uv-fit step] median of the last {UV_FIT_TIMED}: {timed[len(timed) // 2]:.3f} ms"
        f" (min {timed[0]:.3f}, max {timed[-1]:.3f})")

    def steps():
        for _ in range(3):
            fit.step()

    profile("mesh-uv-fit step", steps, 3)
    del fit
    torch.cuda.empty_cache()
    return counts


def clip_scene(device):
    """ico_sphere(4) in NDC (view z) from two cameras inside it:
    tests/test_clip.py's and one grazing the wall (CLIP_GRAZE): (meshes in
    NDC, their (2, F, 3, 3) face verts, valid mask)."""
    import torch

    from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras, MeshRasterizer, look_at_view_transform
    from pytorch3d_tpu_torch.utils import ico_sphere

    R0, T0 = look_at_view_transform(dist=CLIP_DIST, device=device)
    eye, at, up = ([p] for p in CLIP_GRAZE)
    R1, T1 = look_at_view_transform(eye=eye, at=at, up=up, device=device)
    cams = FoVPerspectiveCameras.create(R=torch.cat([R0, R1]), T=torch.cat([T0, T1]), znear=CLIP_ZNEAR, device=device)
    ndc = MeshRasterizer(cams).transform(ico_sphere(4, device=device).extend(2))
    N, F = len(ndc), ndc.max_faces
    fv = ndc.verts_packed()[ndc.faces_packed()].reshape(N, F, 3, 3).contiguous()
    return ndc, fv, ndc.faces_packed_mask().reshape(N, F)


def phase_mesh_clip(device):
    """rasterize_meshes(z_clip_value=0.1) from two cameras inside
    ico_sphere(4) (`clip_scene`), 512^2, K=8, blur 1e-4, perspective-correct,
    forward and backward: #1 on the (2, 2F) clipped table, #4 back through
    the clip's autograd.  Against
    the plain route: ids, zbuf, bary and the NDC vertex gradient (a vertex
    lies on the camera plane: its world position projects to infinity, so
    the gradient is taken at the rasterizer's input, as the headline's
    is); every id < F, every depth beyond the plane; then #4 on the
    clipped table against float64 and twice, bit for bit."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.clip import clip_faces
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import (
        _face_culls, rasterize_grad_plain, rasterize_meshes,
    )

    ndc, fv, valid = clip_scene(device)
    F = ndc.max_faces
    size = (IMAGE, IMAGE)
    gen = torch.Generator(device=device).manual_seed(12)
    bary_weights = torch.rand((len(ndc), IMAGE, IMAGE, CLIP_K, 3), generator=gen, device=device)

    def fwd_bwd(bin_size=None):
        v = ndc.verts_padded().detach().clone().requires_grad_(True)
        pix, zbuf, bary, dists = rasterize_meshes(
            ndc.update_padded(v), image_size=IMAGE, blur_radius=BLUR, faces_per_pixel=CLIP_K, bin_size=bin_size,
            perspective_correct=True, clip_barycentric_coords=True, z_clip_value=CLIP_Z,
        )
        filled = pix >= 0
        loss = 1e-6 * (torch.where(filled, zbuf, 0.0).sum() + (torch.sigmoid(-dists / 1e-4) * filled).sum()
                       + torch.where(filled[..., None], bary * bary_weights, 0.0).sum())
        loss.backward()
        return pix, zbuf.detach(), bary.detach(), dists.detach(), v.grad

    torch.cuda.synchronize()
    reset_counts()
    pix, zbuf, bary, dists, grad = fwd_bwd()
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["rasterize_fine"] == 1 and counts["rasterize_grad"] == 1,
          f"mesh-clip: launches {counts} for one forward and backward")
    ppix, pzbuf, pbary, pdists, pgrad = fwd_bwd(0)
    same = pix == ppix
    filled = pix >= 0
    err = {name: float((g - w).abs()[(same[..., None] if name == "bary" else same).expand_as(g)].max())
           for name, g, w in (("zbuf", zbuf, pzbuf), ("bary", bary, pbary), ("dists", dists, pdists))}
    ids = float(same.float().mean())
    g_err, g_ratio = grad_error(grad, pgrad)
    cut = (fv[..., 2] < CLIP_Z).any(dim=-1).reshape(-1)  # (N*F,) the faces the plane cuts or drops
    n_clip = cut.reshape(len(ndc), F).sum(dim=1).tolist()
    from_cut = (filled & cut[pix.clamp(min=0)]).sum(dim=(1, 2, 3)).tolist()  # covered slots of cut faces
    zmin = float(zbuf[filled].min())
    log(f"mesh-clip: cameras inside ico_sphere(4) (F={F}; faces with a vertex before z={CLIP_Z:g}: {n_clip} by view;"
        f" non-finite NDC verts {int((~torch.isfinite(ndc.verts_padded())).any(-1).sum())}), {IMAGE}^2 K={CLIP_K}"
        f" blur {BLUR:g}: launches {counts}; covered slots {int(filled.sum())}, of cut faces {from_cut} by view;"
        f" largest local id {int((pix - torch.arange(len(ndc), device=device)[:, None, None, None] * F).max())} (F={F}),"
        f" nearest depth {zmin:.6f}; vs the plain route: ids equal {ids:.6f}, where equal"
        f" max|diff| zbuf {err['zbuf']:.3e} bary {err['bary']:.3e} dists {err['dists']:.3e}; NDC vertex grad"
        f" max|diff| {g_err:.3e} = {g_ratio:.3e} of max|grad|")
    check(ids > 0.999 and err["zbuf"] < 5e-3 and err["bary"] <= 1e-4,
          f"mesh-clip: ids {ids:.6f}, zbuf {err['zbuf']:.3e}, bary {err['bary']:.3e} against the plain route")
    local = torch.where(filled, pix - torch.arange(len(ndc), device=device)[:, None, None, None] * F, -1)
    check(int(filled.sum()) > 0 and int(local.max()) < F, f"mesh-clip: local ids reach {int(local.max())} with F={F}")
    check(from_cut[-1] > 0, "mesh-clip: no covered slot comes from a face the plane cuts")
    check(zmin >= CLIP_Z - 1e-4, f"mesh-clip: a covered depth {zmin:.6f} lies before the plane z={CLIP_Z:g}")
    check(bool(torch.isfinite(grad).all()), "mesh-clip: non-finite vertex gradient")
    check(g_ratio <= GRAD_GATE, f"mesh-clip: vertex gradient {g_ratio:.3e} of max|grad| off the plain route's")

    # #4 on the clipped table itself, on the forward's binning
    clipped = clip_faces(fv, valid, CLIP_Z)
    cfv, cvalid = clipped.face_verts.contiguous(), clipped.valid
    bins = rc.bin_faces(cfv, _face_culls(cfv, cvalid, False), size, BLUR)
    idx, czbuf, cbary, cdists = rc._run_kernel(cfv, bins, size, BLUR, CLIP_K, True, True)
    cots = tuple(torch.randn(t.shape, generator=gen, device=device) for t in (czbuf, cbary, cdists))
    first = rc.rasterize_grad_cuda(cfv, idx, *cots, size, bins, True, True)
    second = rc.rasterize_grad_cuda(cfv, idx, *cots, size, bins, True, True)
    bit_equal = torch.equal(first.view(torch.int32), second.view(torch.int32))
    want = rasterize_grad_plain(cfv, idx, *cots, size, True, True)
    exact = rasterize_grad_plain(cfv.double(), idx, *(c.double() for c in cots), size, True, True)
    _, ratio_exact = grad_error(first.double(), exact)
    _, ratio_plain = grad_error(want.double(), exact)
    kernel_share, plain_share = face_agreement(first, want, exact)
    ok = (bit_equal and bool(torch.isfinite(first).all())
          and ratio_exact <= max(GRAD_GATE, GRAD_PLAIN_FACTOR * ratio_plain) and kernel_share >= GRAD_FACE_SHARE)
    log(f"kernel rasterize_grad [mesh-clip table: N={cfv.shape[0]} 2F={cfv.shape[1]} ({int(cvalid.sum())} valid) {IMAGE}^2"
        f" K={CLIP_K}]: longest tile list {longest_list(bins)[0]}; two launches bit-equal {bit_equal}; vs the float64"
        f" plain version: kernel {ratio_exact:.3e}, float32 plain version {ratio_plain:.3e} of max|grad|; faces within"
        f" {GRAD_GATE:g}: kernel {kernel_share:.6f}, float32 plain version {plain_share:.6f} -> {'ok' if ok else 'FAIL'}")
    check(ok, "mesh-clip: #4 on the clipped table is not bit-equal twice or disagrees with its plain version")

    def step():
        fwd_bwd()

    ms = host_frames(step, 5)
    log(f"times [mesh-clip fwd+bwd] median of 5: {ms[2]:.3f} ms (min {ms[0]:.3f}, max {ms[-1]:.3f})")
    profile("mesh-clip fwd+bwd", step, 1)
    return counts


def phase_mesh_shaders(device, mesh, uv_tex):
    """The other shaders on mesh-uv-serving's first 2 views, each against
    the plain route: HardFlatShader with DirectionalLights, SoftGouraudShader
    with AmbientLights (vertex colours: Gouraud shades TexturesVertex),
    HardDepthShader and SoftDepthShader (depth within 5e-3), and
    SplatterPhongShader (sigma 0.5 pixels), whose vertex gradient must be
    finite and within #4's gate of the plain route's."""
    import torch

    from pytorch3d_tpu_torch.renderer import (
        AmbientLights, BlendParams, DirectionalLights, HardDepthShader, HardFlatShader, PointLights,
        SoftDepthShader, SoftGouraudShader, SplatterPhongShader, TexturesVertex,
    )

    cams = tutorial_cameras(device, UV_CHECK_VIEWS)
    views = list(range(UV_CHECK_VIEWS))
    uv_mesh = mesh.replace(textures=uv_tex).extend(UV_VIEWS)[views]
    vc_mesh = mesh.replace(textures=TexturesVertex.create(mesh.verts_padded() * 0.5 + 0.5, device=device))
    vc_mesh = vc_mesh.extend(UV_CHECK_VIEWS)
    shaders = (
        ("HardFlatShader + DirectionalLights", uv_mesh, 1e-3,
         HardFlatShader(cameras=cams, lights=DirectionalLights.create(direction=[[0.0, 0.5, -1.0]], device=device),
                        device=device)),
        ("SoftGouraudShader + AmbientLights", vc_mesh, 1e-3,
         SoftGouraudShader(cameras=cams, lights=AmbientLights.create(device=device), device=device)),
        ("HardDepthShader", uv_mesh, DEPTH_TOL, HardDepthShader(cameras=cams, device=device)),
        ("SoftDepthShader", uv_mesh, DEPTH_TOL, SoftDepthShader(cameras=cams, device=device)),
    )
    torch.cuda.synchronize()
    reset_counts()
    for label, m, tol, shader in shaders:
        with torch.no_grad():
            got, _ = tutorial_renderer(cams, device, shader)(m)
            want, _ = tutorial_renderer(cams, device, shader, bin_size=0)(m)
        frac, worst = image_agreement(got, want, tol)
        log(f"mesh-shaders [{label}]: {tuple(got.shape)}, |out - plain| <= {tol:g} on {frac:.6f} of pixels"
            f" (max {worst:.3e})")
        check(bool(torch.isfinite(got).all()) and frac >= 0.995,
              f"mesh-shaders [{label}]: only {frac:.6f} of pixels within {tol:g} of the plain route")

    lights = PointLights.create(location=[[0.0, 0.0, -3.0]], device=device)
    splatter = SplatterPhongShader(cameras=cams, lights=lights, blend_params=BlendParams(sigma=0.5), device=device)
    gen = torch.Generator(device=device).manual_seed(13)
    weights = torch.rand((UV_CHECK_VIEWS, IMAGE, IMAGE, 4), generator=gen, device=device)

    def splat(bin_size=None):
        offset = torch.zeros_like(uv_mesh.verts_padded(), requires_grad=True)
        img, _ = tutorial_renderer(cams, device, splatter, bin_size)(uv_mesh.update_padded(uv_mesh.verts_padded() + offset))
        (img * weights).sum().backward()
        return img.detach(), offset.grad

    img, grad = splat()
    counts = read_counts()
    plain_img, plain_grad = splat(0)
    frac, worst = image_agreement(img, plain_img, 1e-3)
    g_err, g_ratio = grad_error(grad, plain_grad)
    log(f"mesh-shaders [SplatterPhongShader, sigma 0.5]: |image - plain| <= 1e-3 on {frac:.6f} of pixels (max"
        f" {worst:.3e}); vertex grad max|diff| {g_err:.3e} = {g_ratio:.3e} of max|grad|; launches {counts}")
    check(frac >= 0.995, f"mesh-shaders [SplatterPhongShader]: only {frac:.6f} of pixels match the plain route")
    check(bool(torch.isfinite(grad).all()), "mesh-shaders [SplatterPhongShader]: non-finite vertex gradient")
    check(g_ratio <= GRAD_GATE, f"mesh-shaders [SplatterPhongShader]: vertex gradient {g_ratio:.3e} of max|grad| off")
    check(counts["rasterize_fine"] == len(shaders) + 1 and counts["rasterize_grad"] == 1,
          f"mesh-shaders: launches {counts} ({len(shaders) + 1} fine, 1 grad)")
    return counts


# --------------------------------------------------------------------------- #
# Slice 13: joined scenes, SO(3)/SE(3), camera indexing and conversions,
# fisheye, point normals
# --------------------------------------------------------------------------- #

JOINED_VIEWS = 8
JOINED_AZIMUTHS = [45.0 * i for i in range(JOINED_VIEWS)]
CHECK_VIEWS = 2  # views of the plain-route comparisons (the plain rasterizer takes seconds a view)
JOINED_LIGHT = (0.0, 0.0, 2.0)
# PyTorch3D's tests/test_render_meshes.py test_simple_sphere FishEye branch
# (tests/test_reference_goldens.py:57-103).
FISHEYE_PARAMS = dict(
    radial_params=((-1.0, -2.0, -3.0, 0.0, 0.0, 1.0),),
    tangential_params=((0.7002747019, -0.4005228974),),
    thin_prism_params=((-1.000134884, -1.000084822, -1.0009420014, -1.0001276838),),
)
# unproject(transform(x)) = x, relative to the point's distance from the
# camera, as tests/test_torch_cameras_more.py holds it: the radial polynomial
# alone to 1e-6 within 20 degrees of the axis; with the golden's tangential
# and thin-prism terms (beyond what 4 fixed-point steps undo) to 5e-5 within 2.
FISHEYE_ROUND_TRIP = (("radial only", 20.0, 1e-6), ("full", 2.0, 5e-5))
POSE_FOV = 60.0  # degrees: fx = fy = (IMAGE / 2) / tan 30 degrees, 443.4 pixels at 512^2
POSE_PERTURB = 0.05  # |rotation log| (rad) and |translation log| of each view's start
POSE_STEPS = 20
POSE_TIMED = 10  # the last steps, whose median is the step time
POSE_LR = 1e-2
POSE_RADIUS = 0.01  # the pulsar request's sphere radius (world units)
NORMALS_K = 16
NORMALS_DEFAULT_K = 50  # PyTorch3D's default: the plain KNN on the card (#9 takes K <= 16)
NORMALS_COS = 1e-5  # |cos| >= 1 - NORMALS_COS between the #9 and plain-KNN routes' normals
NORMALS_SHARE = 0.9999
NORMALS_F64_GAP = 1e-3  # float64 check on points whose two smallest eigenvalues differ by > 1e-3 of the largest
NORMALS_F64_COS, NORMALS_F64_SHARE = 1e-4, 0.999


def joined_spheres(device):
    """tests/test_joined_spheres_goldens.py:45-63 (PyTorch3D's
    tests/test_render_meshes.py:1171): ico_sphere(3) x0.25 shifted +1.2 in x
    and ico_sphere(4) shifted -0.3, joined by join_meshes_as_scene, white
    vertex colours; also the two parts."""
    import torch

    from pytorch3d_tpu_torch.renderer import TexturesVertex
    from pytorch3d_tpu_torch.structures import Meshes, join_meshes_as_scene
    from pytorch3d_tpu_torch.utils import ico_sphere

    parts = []
    for level, scale, off in ((3, 0.25, 1.2), (4, 1.0, -0.3)):
        sph = ico_sphere(level, device=device)
        v = sph.verts_padded()[0] * scale + torch.tensor([off, 0.0, 0.0], device=device)
        parts.append(Meshes.create([v], [sph.faces_padded()[0]], device=device))
    scene = join_meshes_as_scene(parts)
    return scene.replace(textures=TexturesVertex.create(torch.ones_like(scene.verts_padded()), device=device)), parts


def joined_cameras(device, views=JOINED_VIEWS):
    """One FoVPerspectiveCameras per azimuth (dist 2.7, elev 0), joined by
    join_cameras_as_batch."""
    from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras, join_cameras_as_batch, look_at_view_transform

    cams = []
    for azim in JOINED_AZIMUTHS[:views]:
        R, T = look_at_view_transform(2.7, 0.0, azim, device=device)
        cams.append(FoVPerspectiveCameras.create(R=R, T=T, device=device))
    return join_cameras_as_batch(cams)


def golden_shader(shader_cls, cams, device):
    """The goldens' shader: a light at (0, 0, 2), default materials,
    BlendParams(0.5, 1e-4, black)."""
    from pytorch3d_tpu_torch.renderer import BlendParams, Materials, PointLights

    return shader_cls(
        cameras=cams, lights=PointLights.create(location=[JOINED_LIGHT], device=device),
        materials=Materials.create(device=device), blend_params=BlendParams(0.5, 1e-4, (0.0, 0.0, 0.0)),
        device=device,
    )


def golden_settings(bin_size=None, perspective_correct=None):
    from pytorch3d_tpu_torch.renderer import RasterizationSettings

    return RasterizationSettings(image_size=IMAGE, blur_radius=0.0, faces_per_pixel=1, bin_size=bin_size,
                                 perspective_correct=perspective_correct)


def served_against_plain(label, renderer, meshes, plain_frags, check_cams):
    """A served batch and its first views (those of `check_cams`) shaded on
    the plain route's fragments: ids equal on > 99.9 % of pixels, images
    within 1e-3 on >= 99.5 %.  (Two served calls need not agree to the bit:
    the vertex normals' `index_add` is atomic on the card.)"""
    import torch

    check_views = len(check_cams)
    with torch.no_grad():
        frags = renderer.rasterizer(meshes)
        images = renderer.shader(frags, meshes)
        plain = renderer.shader(plain_frags, meshes[list(range(check_views))], cameras=check_cams)
    ids = float((frags.pix_to_face[:check_views] == plain_frags.pix_to_face).float().mean())
    frac, worst = image_agreement(images[:check_views], plain, 1e-3)
    covered = (images[..., 3] > 0).sum(dim=(1, 2))
    log(f"  {label}: {tuple(images.shape)}, covered px per view {covered.min().item()}..{covered.max().item()};"
        f" views 0-{check_views - 1} against the plain route: ids equal {ids:.6f}, |image - plain| <= 1e-3 on"
        f" {frac:.6f} of pixels (max {worst:.3e})")
    check(bool(torch.isfinite(images).all()) and bool((covered > 0).all()), f"{label}: non-finite or empty views")
    check(ids > 0.999, f"{label}: ids equal on only {ids:.6f} of pixels")
    check(frac >= 0.995, f"{label}: only {frac:.6f} of pixels match the plain route")
    return images, frags


def phase_joined_scene_serving(device):
    """PyTorch3D's joined spheres (`joined_spheres`) at 512^2, blur 0, K=1,
    served to 8 azimuths (cameras joined by join_cameras_as_batch) in one call
    per shader: HardPhong, HardGouraud and HardFlat through MeshRasterizer
    (#1) and SplatterPhong through MeshRasterizerOpenGL (#3).  Gates: the
    scene's packed verts and faces equal a hand-built concatenation;
    join_meshes_as_batch([scene] * 8) equals scene.extend(8); each shader
    against the plain route on 2 views; cameras[i] renders view i with the
    batch's ids, its HardFlat image within 1e-6 (HardPhong's within 1e-5:
    the vertex normals' index_add is atomic on the card)."""
    import torch
    import torch.nn.functional as F

    from pytorch3d_tpu_torch.renderer import (
        HardFlatShader, HardGouraudShader, HardPhongShader, MeshRasterizer, MeshRasterizerOpenGL, MeshRenderer,
        SplatterPhongShader,
    )
    from pytorch3d_tpu_torch.structures import join_meshes_as_batch

    scene, parts = joined_spheres(device)
    V = max(p.max_verts for p in parts)
    want_verts = torch.cat([F.pad(p.verts_padded()[0], (0, 0, 0, V - p.max_verts)) for p in parts])
    want_faces = torch.cat([p.faces_padded()[0] + i * V for i, p in enumerate(parts)])
    nf = int(scene.num_faces_per_mesh()[0])
    check(torch.equal(scene.verts_packed(), want_verts) and torch.equal(scene.faces_packed()[:nf], want_faces)
          and nf == want_faces.shape[0] and bool((scene.faces_packed()[nf:] == -1).all()),
          "joined-scene: the scene's packed verts / faces differ from the hand-built concatenation")
    batch, extended = join_meshes_as_batch([scene] * JOINED_VIEWS), scene.extend(JOINED_VIEWS)
    check(all(torch.equal(getattr(batch, f)(), getattr(extended, f)()) for f in
              ("verts_padded", "faces_padded", "num_verts_per_mesh", "num_faces_per_mesh"))
          and torch.equal(batch.textures.verts_features_padded(), extended.textures.verts_features_padded()),
          "joined-scene: join_meshes_as_batch([scene] * 8) differs from scene.extend(8)")
    cams = joined_cameras(device)
    meshes = scene.extend(JOINED_VIEWS)
    shaders = (("HardPhongShader", HardPhongShader), ("HardGouraudShader", HardGouraudShader),
               ("HardFlatShader", HardFlatShader))
    renderers = {label: MeshRenderer(MeshRasterizer(cams, golden_settings()), golden_shader(cls, cams, device))
                 for label, cls in shaders}
    gl = MeshRenderer(MeshRasterizerOpenGL(cams, golden_settings(perspective_correct=True)),
                      golden_shader(SplatterPhongShader, cams, device))
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        served = {label: r(meshes) for label, r in renderers.items()}
        served["SplatterPhongShader"] = gl(meshes)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"joined-scene-serving: {nf} faces (ico_sphere(3) + ico_sphere(4)), {JOINED_VIEWS} views at {IMAGE}^2,"
        f" K=1: launches {counts}")
    check(counts["rasterize_fine"] == len(shaders) and counts["rasterize_hard"] == 1,
          f"joined-scene-serving: launches {counts} ({len(shaders)} fine, 1 hard)")
    check_cams = cams[list(range(CHECK_VIEWS))]
    check_meshes = meshes[list(range(CHECK_VIEWS))]
    with torch.no_grad():
        plain_frags = MeshRasterizer(check_cams, golden_settings(bin_size=0))(check_meshes)
    for label, r in renderers.items():
        served_against_plain(f"joined-scene [{label}]", r, meshes, plain_frags, check_cams)
    with torch.no_grad(), plain_gl():
        plain = MeshRenderer(MeshRasterizerOpenGL(check_cams, golden_settings(perspective_correct=True)),
                             golden_shader(SplatterPhongShader, check_cams, device))(check_meshes)
    frac, worst = image_agreement(served["SplatterPhongShader"][:CHECK_VIEWS], plain, 1e-3)
    log(f"  joined-scene [SplatterPhongShader, MeshRasterizerOpenGL]: against the plain route |image - plain| <= 1e-3"
        f" on {frac:.6f} of pixels (max {worst:.3e})")
    check(frac >= 0.995, f"joined-scene [SplatterPhongShader]: only {frac:.6f} of pixels match the plain route")
    # cameras[i] alone renders view i of the batch: HardFlat's image (face
    # normals) within 1e-6; HardPhong's within 1e-5, its vertex normals
    # being an atomic index_add on the card (two batch calls differ as much).
    phong = renderers["HardPhongShader"]
    with torch.no_grad():
        frags = phong.rasterizer(meshes)
        for i in (0, JOINED_VIEWS - 3):
            local = torch.where(frags.pix_to_face[i] >= 0, frags.pix_to_face[i] - i * meshes.max_faces, -1)
            for label, tol in (("HardFlatShader", 1e-6), ("HardPhongShader", 1e-5)):
                one = MeshRenderer(MeshRasterizer(cams[i], golden_settings()),
                                   golden_shader(dict(shaders)[label], cams[i], device))
                one_frags = one.rasterizer(scene)
                diff = float((one.shader(one_frags, scene)[0] - served[label][i]).abs().max())
                ids_same = torch.equal(one_frags.pix_to_face[0], local)
                log(f"  joined-scene: cameras[{i}] alone [{label}]: ids equal the batch's view {i} {ids_same},"
                    f" max|image - batch| {diff:.3e} (gate {tol:g})")
                check(ids_same and diff <= tol, f"joined-scene: cameras[{i}] does not render view {i} as the batch")
    with torch.no_grad():
        ms = host_frames(lambda: phong(meshes), FRAMES)
        log(f"times [joined-scene-serving frame, HardPhong] {JOINED_VIEWS} views: median {ms[FRAMES // 2]:.3f} ms"
            f" (min {ms[0]:.3f}, max {ms[-1]:.3f})")
        gl_ms = host_frames(lambda: gl(meshes), FRAMES)
        log(f"times [joined-scene-serving frame, SplatterPhong + MeshRasterizerOpenGL] {JOINED_VIEWS} views: median"
            f" {gl_ms[FRAMES // 2]:.3f} ms (min {gl_ms[0]:.3f}, max {gl_ms[-1]:.3f})")
        profile("joined-scene-serving frame, HardPhong", lambda: phong(meshes), 1)
    return counts, scene


def fisheye_cameras(device, use_tangential=True, use_thin_prism=True):
    """The golden's FishEyeCameras (world coordinates) at its two views:
    (2.7, 0, 0) and the elevated (2.7, 45, 45)."""
    import torch

    from pytorch3d_tpu_torch.renderer import FishEyeCameras, look_at_view_transform

    R0, T0 = look_at_view_transform(2.7, 0.0, 0.0, device=device)
    R1, T1 = look_at_view_transform(dist=2.7, elev=45.0, azim=45.0, device=device)
    return FishEyeCameras.create(R=torch.cat([R0, R1]), T=torch.cat([T0, T1]), world_coordinates=True,
                                 use_tangential=use_tangential, use_thin_prism=use_thin_prism, device=device,
                                 **FISHEYE_PARAMS)


def fisheye_round_trip(cams, max_deg, n=4096, seed=13):
    """max over both views of |unproject(transform(x)) - x| / |x - eye| for
    seeded world points at view depth 1.7-3.7 within max_deg of the axis."""
    import torch

    gen = torch.Generator(device=cams.device).manual_seed(seed)
    N = len(cams)
    ang = math.radians(max_deg) * torch.rand((N, n), generator=gen, device=cams.device).sqrt()
    phi = 2.0 * math.pi * torch.rand((N, n), generator=gen, device=cams.device)
    z = 1.7 + 2.0 * torch.rand((N, n), generator=gen, device=cams.device)
    view = torch.stack([torch.tan(ang) * torch.cos(phi) * z, torch.tan(ang) * torch.sin(phi) * z, z], dim=-1)
    w2v = cams.get_world_to_view_transform()
    world = w2v.inverse().transform_points(view)
    proj = cams.transform_points(world)
    back = cams.unproject_points(torch.cat([proj[..., :2], view[..., 2:]], dim=-1))
    dist = (world - cams.get_camera_center()[:, None]).norm(dim=-1)
    return float(((back - world).abs().amax(dim=-1) / dist).max())


def phase_fisheye_serving(device):
    """PyTorch3D's test_simple_sphere FishEye branch: ico_sphere(5) (20 480
    faces), white, at 512^2, blur 0, K=1, the golden's radial, tangential and
    thin-prism parameters, the plain and the elevated view in one batch,
    under HardPhong, HardGouraud and HardFlat, all through #1 (MeshRasterizer's
    non-linear branch: transform_points, then an identity NDC transform).
    Gates: each against the plain route on both views; unproject(transform(x))
    = x on the card as tests/test_torch_cameras_more.py holds it."""
    import torch

    from pytorch3d_tpu_torch.renderer import (
        HardFlatShader, HardGouraudShader, HardPhongShader, MeshRasterizer, MeshRenderer, TexturesVertex,
    )
    from pytorch3d_tpu_torch.utils import ico_sphere

    mesh = ico_sphere(5, device=device)
    mesh = mesh.replace(textures=TexturesVertex.create(torch.ones_like(mesh.verts_padded()), device=device))
    cams = fisheye_cameras(device)
    meshes = mesh.extend(len(cams))
    shaders = (("HardPhongShader", HardPhongShader), ("HardGouraudShader", HardGouraudShader),
               ("HardFlatShader", HardFlatShader))
    renderers = {label: MeshRenderer(MeshRasterizer(cams, golden_settings()), golden_shader(cls, cams, device))
                 for label, cls in shaders}
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        for r in renderers.values():
            r(meshes)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"fisheye-serving: ico_sphere(5) ({mesh.max_faces} faces), {len(cams)} views at {IMAGE}^2, K=1: launches"
        f" {counts}")
    check(counts["rasterize_fine"] == len(shaders), f"fisheye-serving: launches {counts} ({len(shaders)} fine)")
    with torch.no_grad():
        plain_frags = MeshRasterizer(cams, golden_settings(bin_size=0))(meshes)
    for label, r in renderers.items():
        served_against_plain(f"fisheye [{label}]", r, meshes, plain_frags, cams)
    for label, max_deg, tol in FISHEYE_ROUND_TRIP:
        flags = dict(use_tangential=False, use_thin_prism=False) if label == "radial only" else {}
        err = fisheye_round_trip(fisheye_cameras(device, **flags), max_deg)
        log(f"  fisheye [{label}]: unproject(transform(x)) within {max_deg:g} degrees of the axis: max|diff| / |x - eye|"
            f" {err:.3e} (gate {tol:g})")
        check(err <= tol, f"fisheye [{label}]: round trip {err:.3e} above {tol:g}")
    phong = renderers["HardPhongShader"]
    with torch.no_grad():
        ms = host_frames(lambda: phong(meshes), FRAMES)
        log(f"times [fisheye-serving frame, HardPhong] {len(cams)} views: median {ms[FRAMES // 2]:.3f} ms (min"
            f" {ms[0]:.3f}, max {ms[-1]:.3f})")
        profile("fisheye-serving frame, HardPhong", lambda: phong(meshes), 1)
    return counts


def opencv_views(device):
    """Render-fit's 8 views (dist 2.8, elev 25, 8 azimuths) as OpenCV
    (R, tvec, K, image_size): fx = fy = 256 / tan 30 degrees, c = (256, 256)
    at 512^2."""
    import torch

    from pytorch3d_tpu_torch.renderer import look_at_view_transform

    azims = torch.linspace(-180.0, 180.0, FIT_VIEWS + 1, device=device)[:-1]
    R, T = look_at_view_transform(dist=2.8, elev=25.0, azim=azims, device=device)
    flip = torch.tensor([-1.0, -1.0, 1.0], device=device)
    R_cv, t_cv = (R * flip).transpose(1, 2), T * flip
    f = IMAGE / 2 / math.tan(math.radians(POSE_FOV / 2))
    K_cv = torch.tensor([[f, 0.0, IMAGE / 2], [0.0, f, IMAGE / 2], [0.0, 0.0, 1.0]], device=device).expand(FIT_VIEWS, 3, 3)
    size = torch.tensor([[IMAGE, IMAGE]], dtype=torch.float32, device=device).expand(FIT_VIEWS, 2)
    return R_cv, t_cv, K_cv, size


class PoseFit:
    """Camera pose refinement by gradient through the renderer: the joined
    scene, render-fit's settings (8 views of 512^2, K=16, blur log(1/1e-4 -
    1) * 1e-4, SoftPhongShader, a light at (0, 2, -3)) with PerspectiveCameras
    from cameras_from_opencv_projection; targets rendered at the true poses;
    each view starts perturbed by a seeded se(3) log of 0.05 rad and 0.05
    units; Adam fits a per-view (8, 6) log, started at zero and composed with
    the start through se3_exp_map, under rgb + silhouette MSE."""

    def __init__(self, device, scene):
        import torch

        from pytorch3d_tpu_torch.renderer import cameras_from_opencv_projection
        from pytorch3d_tpu_torch.transforms import Rotate, Translate, se3_exp_map

        self.device, self.scene = device, scene
        self.opencv = opencv_views(device)
        self.cams = cameras_from_opencv_projection(*self.opencv)
        gen = torch.Generator(device=device).manual_seed(14)
        d = torch.randn((FIT_VIEWS, 2, 3), generator=gen, device=device)
        delta = (POSE_PERTURB * d / d.norm(dim=-1, keepdim=True)).reshape(FIT_VIEWS, 6)
        self.M_true = Rotate(self.cams.R, device=device).compose(Translate(self.cams.T, device=device)).get_matrix()
        self.M_start = self.M_true @ se3_exp_map(delta)
        with torch.no_grad():
            target = self.renderer(self.cams)(scene.extend(FIT_VIEWS))
        self.target_rgb, self.target_sil = target[..., :3], target[..., 3]
        self.log = torch.zeros((FIT_VIEWS, 6), device=device, requires_grad=True)
        self.optimizer = torch.optim.Adam([self.log], lr=POSE_LR)

    def renderer(self, cams, bin_size=None):
        from pytorch3d_tpu_torch.renderer import (
            MeshRasterizer, MeshRenderer, PointLights, RasterizationSettings, SoftPhongShader,
        )

        settings = RasterizationSettings(image_size=IMAGE, blur_radius=FIT_BLUR, faces_per_pixel=FIT_K,
                                         bin_size=bin_size)
        lights = PointLights.create(location=[[0.0, 2.0, -3.0]], device=self.device)
        return MeshRenderer(MeshRasterizer(cams, settings), SoftPhongShader(cameras=cams, lights=lights,
                                                                            device=self.device))

    def cameras(self, views=FIT_VIEWS):
        from pytorch3d_tpu_torch.transforms import se3_exp_map

        M = self.M_start[:views] @ se3_exp_map(self.log[:views])
        return self.cams[list(range(views))].replace(R=M[:, :3, :3], T=M[:, 3, :3])

    def forward(self, views=FIT_VIEWS, bin_size=None):
        import torch

        images = self.renderer(self.cameras(views), bin_size)(self.scene.extend(views))
        return (torch.mean((images[..., :3] - self.target_rgb[:views]) ** 2)
                + torch.mean((images[..., 3] - self.target_sil[:views]) ** 2))

    def rotation_error(self):
        """Mean so3_relative_angle (degrees) between the fitted and the true
        rotations."""
        import torch

        from pytorch3d_tpu_torch.transforms import so3_relative_angle

        with torch.no_grad():
            return float(so3_relative_angle(self.cameras().R, self.cams.R).mean()) * 180.0 / math.pi


def phase_pose_fit(device, scene):
    """`PoseFit` on the joined scene: the OpenCV round trip (1e-5), step 0's
    gradient with respect to the log on 2 views against the plain route
    (1e-4 of its largest, the backward through #4), 20 Adam steps (a finite,
    falling loss; rotation error at steps 0 and 20), then one pulsar request
    of points-serving's 30 000-point cloud at 512^2 through the camera of view
    0 converted by pulsar_from_opencv_projection (#6), ids against the plain
    select."""
    import torch

    from pytorch3d_tpu_torch.renderer import opencv_from_cameras_projection
    from pytorch3d_tpu_torch.renderer.points.pulsar import Renderer
    from pytorch3d_tpu_torch.utils import pulsar_from_opencv_projection

    fit = PoseFit(device, scene)
    back = opencv_from_cameras_projection(fit.cams, fit.opencv[3])
    trip = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(back, fit.opencv[:3]))
    log(f"pose-fit: OpenCV (R, tvec, K) -> PerspectiveCameras -> OpenCV: max|diff| / max|x| {trip:.3e}")
    check(trip <= 1e-5, f"pose-fit: the OpenCV round trip is off by {trip:.3e}")
    grads = [torch.autograd.grad(fit.forward(CHECK_VIEWS, b), fit.log)[0][:CHECK_VIEWS] for b in (None, 0)]
    err, ratio = grad_error(*grads)
    log(f"pose-fit: step 0 gradient of the (views, 6) log on {CHECK_VIEWS} views vs the plain route: max|diff|"
        f" {err:.3e} = {ratio:.3e} of max|grad| ({grads[1].abs().max().item():.3e})")
    check(bool(torch.isfinite(grads[0]).all()), "pose-fit: non-finite gradient")
    check(ratio <= GRAD_GATE, f"pose-fit: gradient {ratio:.3e} of max|grad| off the plain route's")

    angle0 = fit.rotation_error()
    torch.cuda.synchronize()
    reset_counts()
    losses, step_ms = [], []
    for _ in range(POSE_STEPS):
        t0 = time.perf_counter()
        fit.optimizer.zero_grad()
        loss = fit.forward()
        loss.backward()
        fit.optimizer.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    counts = read_counts()
    angle = fit.rotation_error()
    log(f"pose-fit: {POSE_STEPS} Adam({POSE_LR:g}) steps, {FIT_VIEWS} views at {IMAGE}^2, K={FIT_K}: losses"
        f" {[round(v, 6) for v in losses]}; mean rotation error to the truth {angle0:.4f} deg at step 0,"
        f" {angle:.4f} deg at step {POSE_STEPS}; launches {counts}")
    check(all(math.isfinite(v) for v in losses), "pose-fit: non-finite loss")
    check(losses[-1] < losses[0], f"pose-fit: loss did not fall ({losses[0]:.6f} -> {losses[-1]:.6f})")
    check(counts["rasterize_fine"] == POSE_STEPS and counts["rasterize_grad"] == POSE_STEPS,
          f"pose-fit: launches {counts} for {POSE_STEPS} steps (1 fine + 1 grad each)")
    timed = sorted(step_ms[-POSE_TIMED:])
    log(f"times [pose-fit step] median of the last {POSE_TIMED}: {timed[POSE_TIMED // 2]:.3f} ms (min {timed[0]:.3f},"
        f" max {timed[-1]:.3f})")

    def step():
        fit.optimizer.zero_grad()
        fit.forward().backward()
        fit.optimizer.step()

    profile("pose-fit step", step, 1)

    # One pulsar request through view 0's camera.
    cloud, _ = colored_points_scene(device)
    pos, col = cloud.points_padded()[0].contiguous(), cloud.features_padded()[0].contiguous()
    rad = torch.full((pos.shape[0],), POSE_RADIUS, device=device)
    R_cv, t_cv, K_cv, size = fit.opencv
    cam = pulsar_from_opencv_projection(R_cv[:1], t_cv[:1], K_cv[:1], size[:1])[0]
    ren = Renderer(IMAGE, IMAGE, pos.shape[0], n_track=PULSAR_TRACK)

    def request(r):
        return r(pos, col, rad, cam, PULSAR_GAMMA, 10.0, min_depth=0.5, return_forward_info=True)

    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        image, info = request(ren)
    torch.cuda.synchronize()
    pulsar_counts = read_counts()
    with torch.no_grad():
        plain_image, plain_info = request(plain_pulsar(ren))
    ids = float((info["closest_ids"] == plain_info["closest_ids"]).float().mean())
    hit = float((info["closest_ids"][..., 0] >= 0).float().mean())
    frac, worst = image_agreement(image, plain_image, PULSAR_IMAGE_TOL)
    log(f"pose-fit pulsar request: camera {[round(v, 4) for v in cam.tolist()]} (pulsar_from_opencv_projection of"
        f" view 0), {pos.shape[0]} spheres of radius {POSE_RADIUS} at {IMAGE}^2: launches {pulsar_counts}; pixels hit"
        f" {hit:.4f}; ids equal to the plain select's on {ids:.6f} of slots; |image - plain| <= {PULSAR_IMAGE_TOL:g}"
        f" on {frac:.6f} of pixels (max {worst:.3e})")
    check(pulsar_counts["select_points"] == 1, f"pose-fit pulsar request: launches {pulsar_counts}")
    check(hit > 0.01 and bool(torch.isfinite(image).all()), f"pose-fit pulsar request: {hit:.4f} of pixels hit")
    check(ids >= PULSAR_IDS_GATE, f"pose-fit pulsar request: ids equal on only {ids:.6f} of slots")
    check(frac >= PULSAR_IMAGE_SHARE, f"pose-fit pulsar request: only {frac:.6f} of pixels match the plain path")
    for k, v in pulsar_counts.items():
        counts[k] += v
    return counts


def plain_knn():
    """Within the block, the KNN kernel's wrapper is its plain version."""
    from unittest import mock

    from pytorch3d_tpu_torch.ops import knn

    return mock.patch.object(knn, "knn_points_cuda", knn.knn_points_plain)


def float64_normals(points, lengths, k):
    """The smallest eigenvector of float64 covariances of the plain KNN's
    neighbourhoods (torch.linalg.eigh), and the eigenvalues."""
    import torch

    from pytorch3d_tpu_torch.ops import knn_points

    with plain_knn():
        nn = knn_points(points, points, lengths1=lengths, lengths2=lengths, K=k, return_nn=True).knn.double()
    centered = nn - nn.mean(dim=2, keepdim=True)
    cov = (centered[..., :, None] * centered[..., None, :]).sum(dim=2) / k
    evals, evecs = torch.linalg.eigh(cov)
    return evecs[..., 0], evals


def phase_normals(device):
    """Pointclouds.estimate_normals on points-serving's batch of 8 clouds of
    30 000 points at neighborhood_size=16 (#9), then on one cloud at
    PyTorch3D's default of 50 (the plain KNN on the card, as JAX takes XLA
    above 16).  Gates: the #9 route's normals against the plain-KNN route's
    (on 2 clouds) |cos| >= 1 - 1e-5 on >= 99.99 % of points; against float64
    eigh of float64 covariances where the two smallest eigenvalues differ by
    > 1e-3 of the largest, |cos| >= 1 - 1e-4 on >= 99.9 % of them."""
    import torch

    cloud, _ = colored_points_scene(device)
    clouds = cloud.extend(PTS_REQUESTS)
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        normals = clouds.estimate_normals(neighborhood_size=NORMALS_K)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["knn"] == 1, f"normals: launches {counts} for one estimate_normals at K={NORMALS_K}")
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        default = clouds[0].estimate_normals()
    torch.cuda.synchronize()
    default_counts = read_counts()
    check(default_counts["knn"] == 0, f"normals at K={NORMALS_DEFAULT_K}: launches {default_counts} (plain KNN)")
    with torch.no_grad(), plain_knn():
        plain = clouds[list(range(CHECK_VIEWS))].estimate_normals(neighborhood_size=NORMALS_K)
        plain50 = clouds[0].estimate_normals()
    cos = (normals[:CHECK_VIEWS] * plain).sum(-1).abs()
    share = float((cos >= 1 - NORMALS_COS).float().mean())
    cos50 = (default * plain50).sum(-1).abs()
    share50 = float((cos50 >= 1 - NORMALS_COS).float().mean())
    with torch.no_grad():
        n64, evals = float64_normals(clouds.points_padded()[:1], clouds.num_points_per_cloud()[:1], NORMALS_K)
    sep = (evals[..., 1] - evals[..., 0]) > NORMALS_F64_GAP * evals[..., 2]
    cos64 = (normals[:1].double() * n64).sum(-1).abs()[sep]
    share64 = float((cos64 >= 1 - NORMALS_F64_COS).float().mean())
    log(f"normals: {PTS_REQUESTS} clouds of {clouds.max_points} points at K={NORMALS_K}: launches {counts}; against"
        f" the plain-KNN route (clouds 0-{CHECK_VIEWS - 1}): |cos| >= 1 - {NORMALS_COS:g} on {share:.6f} (min |cos|"
        f" {float(cos.min()):.8f}); K={NORMALS_DEFAULT_K} (plain KNN on the card, launches {default_counts}) against"
        f" the same under the patch: {share50:.6f}; against float64 eigh on cloud 0 ({int(sep.sum())} of"
        f" {sep.numel()} points with the two smallest eigenvalues > {NORMALS_F64_GAP:g} of the largest apart): |cos|"
        f" >= 1 - {NORMALS_F64_COS:g} on {share64:.6f}, 1 - |cos| median {float((1 - cos64).median()):.3e},"
        f" max {float((1 - cos64).max()):.3e}")
    check(bool(torch.isfinite(normals).all()) and bool(torch.isfinite(default).all()), "normals: non-finite normals")
    check(share >= NORMALS_SHARE and share50 >= NORMALS_SHARE,
          f"normals: #9's normals agree with the plain KNN's on only {share:.6f} / {share50:.6f}")
    check(share64 >= NORMALS_F64_SHARE, f"normals: only {share64:.6f} within {NORMALS_F64_COS:g} of float64")

    # #9 at this path's shape, by CUDA events: a 12 ms call dwarfs the
    # wrapper's host time, and a CUDA-only profiler window after the slice's
    # CPU + CUDA profiles can drop records.
    from pytorch3d_tpu_torch.ops import knn

    pts = clouds.points_padded().contiguous()
    knn_ms = cuda_ms(lambda: knn.knn_points_cuda(pts, pts, None, NORMALS_K), 10)
    bound, bound_by, pairs = knn_bound(pts, pts, NORMALS_K)
    log(f"kernel knn [normals: N={len(clouds)} P={clouds.max_points} K={NORMALS_K}, {pairs:.3e} pairs]: {knn_ms:.4f} ms"
        f" (CUDA events, both stages); bound {bound:.4f} ms ({bound_by}): {knn_ms / bound:.2f}x")

    def run():
        clouds.estimate_normals(neighborhood_size=NORMALS_K)

    with torch.no_grad():
        ms = host_frames(run, FRAMES)
        log(f"times [normals, {PTS_REQUESTS} clouds, K={NORMALS_K}]: median {ms[FRAMES // 2]:.3f} ms (min {ms[0]:.3f},"
            f" max {ms[-1]:.3f})")
        ms50 = host_frames(lambda: clouds[0].estimate_normals(), 3)
        log(f"times [normals, 1 cloud, K={NORMALS_DEFAULT_K}, plain KNN]: median {ms50[1]:.3f} ms (min {ms50[0]:.3f},"
            f" max {ms50[-1]:.3f})")
        profile(f"normals, K={NORMALS_K}", run, 1)
    return counts


# --------------------------------------------------------------------------- #
# Slice 14: volumes and the implicit renderer, run through #12 and #13
# --------------------------------------------------------------------------- #

VOL_GRID = 128  # fit_textured_volume: a 128^3 grid, 1 density + 3 colour channels
VOL_EXTENT = 3.0  # world extent of the grid (voxel size 3 / 128)
VOL_IMAGE = 64  # the tutorial renders 128^2 views; cow.npz holds 64^2 ones
VOL_POINTS = 150
VOL_DEPTH = (0.1, 3.0)
VOL_BATCH = 10  # views a step
VOL_LR = 0.1
VOL_STEPS = 20
VOL_IMAGE_GATE = 1e-5  # step 0's image: max |float32 - float64|
VOL_GRAD_GATE = 1e-4  # step 0's gradients: max |float32 - float64| <= gate * max |float64|
INR_RAYS = 750  # fit_simple_neural_radiance_field: MC rays per image, points per ray
INR_POINTS = 128
INR_DEPTH = (0.1, 3.0)
INR_BATCH = 6
INR_LR = 1e-3
INR_STEPS = 12
INR_SUBSAMPLE = 1024  # rays of the grid-subsampling request
INR_TOTAL = 4096  # rays of the n_rays_total request
P2V_GRID = 128
P2V_IMAGE = 256
P2V_POINTS = 128
P2V_DEPTH = (1.5, 4.5)
# The splat against float64: max |diff| <= gate * max |float64|.  A float32
# voxel coordinate in [0, 127] is off by up to ~4e-6, and so is each corner
# weight; a voxel sums tens of them.
P2V_VALUE_GATE = 1e-4
P2V_GRAD_GATE = 1e-4  # its gradients, and the rescaled colours (absolute) where ...
P2V_RESCALED_DENSITY = 0.5  # ... the density is at least this: a colour over a density of a few tiny
# corner weights divides their float32 rounding by that density
PMD_VALUE_GATE = 1e-5  # the distances, areas and normals against float64, relative
PMD_GRAD_GATE = 1e-4  # gradient rows within gate * max |float64 gradient| ...
PMD_ROW_SHARE = 0.999  # ... on at least this share of the rows (a near tie may pick another face in float32)


def huber(x, y, scaling=0.1):
    """The tutorials' smooth L1 of x - y."""
    return ((1 + (x - y) ** 2 / scaling**2).clamp(min=1e-4).sqrt() - 1) * scaling


def cow_views(device):
    """cow.npz's 64^2 views (white background) with their cameras: (images,
    silhouettes (non-white), cameras(indices), train ids, test ids)."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras

    data = np.load(NERF_DATA)
    images = torch.tensor(data["images"].astype(np.float32), device=device)
    sil = (images < 0.99).any(dim=-1).to(images.dtype)
    R, T = torch.tensor(data["R"], device=device), torch.tensor(data["T"], device=device)
    fov, znear, zfar = float(data["fov"]), float(data["znear"]), float(data["zfar"])
    test = [int(i) for i in data["test_idx"]]
    train = [i for i in range(len(images)) if i not in test]

    def cameras(ids):
        ids = torch.as_tensor(ids, device=device)
        return FoVPerspectiveCameras.create(R=R[ids], T=T[ids], fov=fov, znear=znear, zfar=zfar, device=device)

    return images, sil, cameras, train, test


def max_ratio(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp(min=1e-30))


def row_share(got, want, gate):
    """Share of rows (the last axis's vectors) within gate * max |want|."""
    err = (got.double() - want.double()).abs().reshape(-1, got.shape[-1]).amax(dim=-1)
    return float((err <= gate * want.double().abs().max()).double().mean())


class VolumeFit:
    """PyTorch3D's fit_textured_volume tutorial on cow.npz: log-densities
    (start -4) and colour logits (start 0) of a 128^3 grid through sigmoids,
    rendered by VolumeRenderer(NDCMultinomialRaysampler(64^2, 150 points,
    depth 0.1-3.0), EmissionAbsorptionRaymarcher()), Adam at lr 0.1 on 10
    training views a step; the render is composited over the views' white
    background, and its opacity fits their non-white silhouettes."""

    def __init__(self, device):
        import torch

        from pytorch3d_tpu_torch.renderer import EmissionAbsorptionRaymarcher, NDCMultinomialRaysampler, VolumeRenderer

        self.device = device
        self.images, self.sil, self.cameras, self.train, _ = cow_views(device)
        self.log_densities = torch.full((1, VOL_GRID, VOL_GRID, VOL_GRID), -4.0, device=device, requires_grad=True)
        self.log_colors = torch.zeros((3, VOL_GRID, VOL_GRID, VOL_GRID), device=device, requires_grad=True)
        self.renderer = VolumeRenderer(
            NDCMultinomialRaysampler(image_width=VOL_IMAGE, image_height=VOL_IMAGE, n_pts_per_ray=VOL_POINTS,
                                     min_depth=VOL_DEPTH[0], max_depth=VOL_DEPTH[1]),
            EmissionAbsorptionRaymarcher(),
        )
        self.optimizer = torch.optim.Adam([self.log_densities, self.log_colors], lr=VOL_LR)
        self.generator = torch.Generator().manual_seed(0)

    def volumes(self, B, log_densities=None, log_colors=None):
        import torch

        from pytorch3d_tpu_torch.structures import Volumes

        ld = self.log_densities if log_densities is None else log_densities
        lc = self.log_colors if log_colors is None else log_colors
        dens, cols = torch.sigmoid(ld), torch.sigmoid(lc)
        return Volumes.create(dens[None].expand(B, *dens.shape), cols[None].expand(B, *cols.shape),
                              voxel_size=VOL_EXTENT / VOL_GRID, device=self.device, dtype=ld.dtype)

    def loss(self, images, views):
        rgb = images[..., :3] + (1.0 - images[..., 3:])  # over white
        return huber(rgb, self.images[views]).mean() + huber(images[..., 3], self.sil[views]).mean()

    def views(self):
        import torch

        pick = torch.randperm(len(self.train), generator=self.generator)[:VOL_BATCH]
        return [self.train[int(i)] for i in pick]

    def step(self, views):
        self.optimizer.zero_grad(set_to_none=True)
        images, _ = self.renderer(cameras=self.cameras(views), volumes=self.volumes(len(views)))
        loss = self.loss(images, views)
        loss.backward()
        self.optimizer.step()
        return loss.item()


def phase_volume_fit(device, card):
    """Step 0's image and gradients against the same step in float64 (the
    float32 step's rays, the volume, sampling, marching and loss in
    float64), then VOL_STEPS Adam steps whose loss must fall."""
    import torch

    from pytorch3d_tpu_torch.renderer import VolumeSampler

    fit = VolumeFit(device)
    views = fit.views()
    reset_counts()
    images, bundle = fit.renderer(cameras=fit.cameras(views), volumes=fit.volumes(len(views)))
    fit.loss(images, views).backward()
    ld64 = fit.log_densities.detach().double().requires_grad_(True)
    lc64 = fit.log_colors.detach().double().requires_grad_(True)
    bundle64 = bundle.replace(**{k: getattr(bundle, k).double() for k in ("origins", "directions", "lengths", "xys")})
    volumes64 = fit.volumes(len(views), ld64, lc64)
    dens64, feats64 = VolumeSampler(volumes64)(bundle64)
    images64 = fit.renderer._renderer.raymarcher(rays_densities=dens64, rays_features=feats64)
    fit.loss(images64, views).backward()
    image_err = float((images.detach().double() - images64.detach()).abs().max())
    grad_err = {"densities": max_ratio(fit.log_densities.grad, ld64.grad), "colours": max_ratio(fit.log_colors.grad,
                                                                                                lc64.grad)}
    log(f"volume-fit: step 0 ({len(views)} views of {VOL_IMAGE}^2, {VOL_POINTS} points, a {VOL_GRID}^3 grid) against"
        f" float64: image max|diff| {image_err:.3e} (gate {VOL_IMAGE_GATE:g}); gradients {grad_err} of each max|grad|"
        f" (gate {VOL_GRAD_GATE:g})")
    check(image_err <= VOL_IMAGE_GATE, f"volume-fit: step 0's image is {image_err:.3e} off float64")
    check(all(v <= VOL_GRAD_GATE for v in grad_err.values()), f"volume-fit: step 0's gradients off float64: {grad_err}")
    del images, images64, bundle, bundle64, volumes64, dens64, feats64, ld64, lc64
    fit.optimizer.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(VOL_STEPS):
        views = fit.views()
        loss, ms = timed_ms(lambda: fit.step(views))
        losses.append(loss)
        step_ms.append(ms)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    timed = sorted(step_ms[-10:])
    log(f"volume-fit: {VOL_STEPS} Adam steps: losses {[round(v, 5) for v in losses]}; launches {counts} (no kernel on"
        f" this path); peak memory {peak:.2f} GB")
    log(f"times [volume-fit step, {card}] median of the last 10: {timed[5]:.3f} ms (min {timed[0]:.3f}, max"
        f" {timed[-1]:.3f})")
    check(all(math.isfinite(v) for v in losses), "volume-fit: non-finite loss")
    check(last < first, f"volume-fit: the mean of the last 5 losses {last:.6f} is not below the first 5's {first:.6f}")
    profile("volume-fit step", lambda: fit.step(fit.views()), 1)
    del fit
    torch.cuda.empty_cache()
    return counts


class ImplicitNeRF:
    """PyTorch3D's fit_simple_neural_radiance_field renderers driving the
    port's NeuralRadianceField at RadianceFieldRenderer's defaults (8 x 256,
    skip at 5; the heads in #12): ImplicitRenderer(MonteCarloRaysampler(750
    rays, 128 points, depth 0.1-3.0)) for training on 6 views a step (Adam,
    lr 1e-3), ImplicitRenderer(NDCMultinomialRaysampler(64^2, 128 points))
    for serving; both with EmissionAbsorptionRaymarcher, composited over
    cow.npz's white background."""

    def __init__(self, device):
        import torch

        from pytorch3d_tpu_torch.models import NeuralRadianceField
        from pytorch3d_tpu_torch.renderer import (
            EmissionAbsorptionRaymarcher,
            ImplicitRenderer,
            MonteCarloRaysampler,
            NDCMultinomialRaysampler,
        )

        self.device = device
        self.images, self.sil, self.cameras, self.train, self.test = cow_views(device)
        self.field = NeuralRadianceField(device=device, generator=torch.Generator(device=device).manual_seed(0))
        marcher = EmissionAbsorptionRaymarcher()
        self.train_renderer = ImplicitRenderer(
            MonteCarloRaysampler(-1.0, 1.0, -1.0, 1.0, INR_RAYS, INR_POINTS, INR_DEPTH[0], INR_DEPTH[1]), marcher
        )
        grid = dict(image_width=64, image_height=64, n_pts_per_ray=INR_POINTS, min_depth=INR_DEPTH[0],
                    max_depth=INR_DEPTH[1])
        self.serve_renderer = ImplicitRenderer(NDCMultinomialRaysampler(**grid), marcher)
        self.subsample_renderer = ImplicitRenderer(NDCMultinomialRaysampler(**grid, n_rays_per_image=INR_SUBSAMPLE),
                                                   marcher)
        self.total_renderer = ImplicitRenderer(NDCMultinomialRaysampler(**grid, n_rays_total=INR_TOTAL), marcher)
        self.optimizer = torch.optim.Adam(self.field.parameters(), lr=INR_LR)
        self.order = torch.Generator().manual_seed(1)
        self.generator = torch.Generator(device=device).manual_seed(2)

    def views(self):
        import torch

        pick = torch.randperm(len(self.train), generator=self.order)[:INR_BATCH]
        return [self.train[int(i)] for i in pick]

    def loss(self, views, generator, field=None):
        """(loss, ray bundle) of a training render of `views`."""
        from pytorch3d_tpu_torch.models.nerf.utils import sample_images_at_mc_locs

        images, bundle = self.train_renderer(cameras=self.cameras(views), volumetric_function=field or self.field,
                                             generator=generator)
        rgb = images[..., :3] + (1.0 - images[..., 3:])
        target = sample_images_at_mc_locs(self.images[views], bundle.xys)
        return huber(rgb, target).mean(), bundle

    def step(self, views):
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.loss(views, self.generator)
        loss.backward()
        self.optimizer.step()
        return loss.item()

    def request(self, renderer, views, **kwargs):
        """An rgb render (composited over white) without autograd."""
        import torch

        with torch.no_grad():
            images, bundle = renderer(cameras=self.cameras(views), volumetric_function=self.field, **kwargs)
        return images[..., :3] + (1.0 - images[..., 3:]), bundle

    def plain(self, fn):
        self.field.use_fused_kernel = False
        try:
            return fn()
        finally:
            self.field.use_fused_kernel = True


def pixel_share(got, want):
    diff = (got - want).abs().amax(dim=-1)
    return float((diff <= NERF_FRAME_TOL).double().mean()), float(diff.max())


def phase_implicit_nerf(device, card):
    """Step 0's gradients against use_fused_kernel=False on the same rays
    (GRAD_GATE of each tensor's largest) and both against the plain field in
    float64 on those rays; INR_STEPS Adam steps through #12 (saving) and #13;
    then the 8 test views served at 64^2 through #12, one request through
    grid subsampling and one through n_rays_total, each against
    use_fused_kernel=False at the NeRF frame's gates."""
    import copy

    import torch

    nerf = ImplicitNeRF(device)
    views = nerf.views()
    grads, bundles = [], []
    for fused in (True, False):
        nerf.field.use_fused_kernel = fused
        nerf.field.zero_grad(set_to_none=True)
        loss, bundle = nerf.loss(views, torch.Generator(device=device).manual_seed(3))
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in nerf.field.named_parameters()})
        bundles.append(bundle)
    nerf.field.use_fused_kernel = True
    check(torch.equal(bundles[0].xys, bundles[1].xys), "implicit-nerf: the two step-0 runs drew different rays")
    from pytorch3d_tpu_torch.models.nerf.utils import sample_images_at_mc_locs

    ref = copy.deepcopy(nerf.field).double()
    ref.use_fused_kernel = False
    bundle64 = bundles[0].replace(**{k: getattr(bundles[0], k).double()
                                     for k in ("origins", "directions", "lengths", "xys")})
    images64 = nerf.train_renderer.raymarcher(*ref(bundle64))
    target = sample_images_at_mc_locs(nerf.images[views].double(), bundle64.xys)
    huber(images64[..., :3] + (1.0 - images64[..., 3:]), target).mean().backward()
    exact = {n: p.grad for n, p in ref.named_parameters()}
    fused_vs_plain = grad_ratios(grads[0], grads[1])
    witness = [max(grad_ratios(g, exact).values()) for g in grads]
    worst = max(fused_vs_plain, key=fused_vs_plain.get)
    log(f"implicit-nerf: step 0 ({INR_BATCH} views x {INR_RAYS} rays x {INR_POINTS} points) gradients, fused against"
        f" use_fused_kernel=False: worst {worst} {fused_vs_plain[worst]:.3e} of its max|grad| (gate {GRAD_GATE:g});"
        f" against the plain field in float64: fused {witness[0]:.3e}, plain {witness[1]:.3e}")
    check(all(math.isfinite(v) for v in fused_vs_plain.values()), "implicit-nerf: non-finite step 0 gradients")
    check(fused_vs_plain[worst] <= GRAD_GATE, "implicit-nerf: step 0 gradients off the plain field's")
    check(witness[0] <= max(GRAD_GATE, FUSED_PLAIN_FACTOR * witness[1]),
          "implicit-nerf: the fused field is further from float64 than the plain one")
    del ref, images64, exact, grads, bundles, bundle64
    nerf.field.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    recomputed = fm._backward.forwards_run
    losses, step_ms = [], []
    for _ in range(INR_STEPS):
        views = nerf.views()
        loss, ms = timed_ms(lambda: nerf.step(views))
        losses.append(loss)
        step_ms.append(ms)
    train_counts = read_counts()
    recomputed = fm._backward.forwards_run - recomputed
    peak = torch.cuda.max_memory_allocated() / 1e9
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    timed = sorted(step_ms[2:])
    log(f"implicit-nerf: {INR_STEPS} Adam steps: losses {[round(v, 5) for v in losses]}; launches {train_counts};"
        f" forwards the backward ran itself: {recomputed}; peak memory {peak:.2f} GB")
    log(f"times [implicit-nerf step, {card}] median of the last {len(timed)}: {timed[len(timed) // 2]:.3f} ms"
        f" (min {timed[0]:.3f}, max {timed[-1]:.3f})")
    check(all(math.isfinite(v) for v in losses), "implicit-nerf: non-finite loss")
    check(last < first, f"implicit-nerf: the mean of the last 3 losses {last:.6f} is not below the first 3's {first:.6f}")
    check(train_counts["nerf_field"] == INR_STEPS and train_counts["nerf_field_grad"] == INR_STEPS,
          f"implicit-nerf: launches {train_counts} for {INR_STEPS} steps (one field forward and backward each)")
    check(recomputed == 0, "implicit-nerf: the backward recomputed the forward instead of reading its saved tensors")

    torch.cuda.synchronize()
    reset_counts()
    frames, frame_ms = [], []
    for i in nerf.test:
        (rgb, _), ms = timed_ms(lambda: nerf.request(nerf.serve_renderer, [i]))
        frames.append(rgb)
        frame_ms.append(ms)
    mask = nerf.sil[nerf.test[:1]]
    gen = lambda: torch.Generator(device=device).manual_seed(4)  # noqa: E731
    sub, sub_bundle = nerf.request(nerf.subsample_renderer, nerf.test[:1], mask=mask, generator=gen())
    total, total_bundle = nerf.request(nerf.total_renderer, nerf.test, generator=gen())
    serve_counts = read_counts()
    want = len(nerf.test) + 2
    log(f"implicit-nerf serving: {len(frames)} requests of 64^2 x {INR_POINTS} points, one of {INR_SUBSAMPLE} rays"
        f" subsampled by the silhouette, one of {INR_TOTAL} rays over the {len(nerf.test)} cameras (n_rays_total):"
        f" launches {serve_counts}")
    check(serve_counts["nerf_field"] == want and serve_counts["nerf_field_grad"] == 0,
          f"implicit-nerf serving: launches {serve_counts}, expected {want} nerf_field")
    check(sub.shape == (1, INR_SUBSAMPLE, 3) and total.shape == (INR_TOTAL, 1, 3), "implicit-nerf: request shapes")
    # NDC x, y of the 64^2 grid run from 1 - 1/64 down by 2/64 per column / row
    col, row = (((1.0 - 1.0 / 64) - sub_bundle.xys[0]) * 32).round().long().unbind(-1)
    on = float(nerf.sil[nerf.test[0]][row, col].mean())
    log(f"  the subsampled rays on the silhouette: {on:.6f}")
    check(on == 1.0, f"implicit-nerf: {1 - on:.6f} of the mask-weighted rays lie off the mask")
    check(int(total_bundle.camera_counts.sum()) == INR_TOTAL, "implicit-nerf: n_rays_total camera counts")
    plain = nerf.plain(lambda: (
        nerf.request(nerf.serve_renderer, nerf.test[:1])[0],
        nerf.request(nerf.subsample_renderer, nerf.test[:1], mask=mask, generator=gen())[0],
        nerf.request(nerf.total_renderer, nerf.test, generator=gen())[0],
    ))
    for name, got, ref in (("frame", frames[0], plain[0]), ("subsample", sub, plain[1]), ("n_rays_total", total,
                                                                                          plain[2])):
        share, worst = pixel_share(got, ref)
        log(f"  {name} vs use_fused_kernel=False: |rgb diff| <= {NERF_FRAME_TOL:g} on {share:.6f} (max {worst:.3e})")
        check(bool(torch.isfinite(got).all()), f"implicit-nerf: non-finite {name}")
        check(share >= NERF_FRAME_SHARE, f"implicit-nerf: only {share:.6f} of the {name}'s rays match the plain field")
    timed = sorted(frame_ms)
    log(f"times [implicit-nerf frame, {card}] median of {len(timed)}: {timed[len(timed) // 2]:.3f} ms (min"
        f" {timed[0]:.3f}, max {timed[-1]:.3f})")
    profile("implicit-nerf frame", lambda: nerf.request(nerf.serve_renderer, nerf.test[:1]), 1)
    profile("implicit-nerf step", lambda: nerf.step(nerf.views()), 1)
    del nerf
    torch.cuda.empty_cache()
    return {k: train_counts[k] + serve_counts[k] for k in train_counts}


class RecordedSaves:
    """While open, records the `save` flag of every #12 launch (False: the
    serving build, True: the saving build) by wrapping the wrappers' shared
    `_forward`; the launch counts are the wrappers' own, untouched."""

    def __enter__(self):
        from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

        self.fm, self.original, self.saves = fm, fm._forward, []

        def recording(what, x, d_embed, weights, biases, head, skips, save=False):
            if what == "nerf_field_cuda":
                self.saves.append(save)
            return self.original(what, x, d_embed, weights, biases, head, skips, save)

        fm._forward = recording
        return self.saves

    def __exit__(self, *exc):
        self.fm._forward = self.original
        return False


def phase_nerf_remat(device, scene, card):
    """chip_smoke's NeRF training step (the full-width RadianceFieldRenderer,
    1024 rays, 64 + 64 points) with remat=True beside remat=False on the
    same weights and draws: the gradients equal to the bit, #12 launched
    twice per field call under remat (serving build in the forward, saving
    build in the backward), peak memory of both."""
    import torch

    from pytorch3d_tpu_torch.models import RadianceFieldRenderer
    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    base = scene.model
    remat = RadianceFieldRenderer(
        image_width=NERF_FRAME, image_height=NERF_FRAME, n_pts_per_ray=64, n_pts_per_ray_fine=64,
        n_rays_per_image=NERF_RAYS, min_depth=scene.znear, max_depth=scene.zfar, bg_color=(1.0, 1.0, 1.0),
        remat=True, device=device,
    )
    remat.load_state_dict(base.state_dict())
    view = scene.train_idx[0]
    draws = base.make_draws(1, True, torch.Generator(device=device).manual_seed(8))
    grads, peaks, counts, saves = {}, {}, {}, {}
    for name, model in (("remat=False", base), ("remat=True", remat)):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        reset_counts()
        recomputed = fm._backward.forwards_run
        with RecordedSaves() as flags:
            _, m = model(scene.camera(view), image=scene.images[view : view + 1], training=True, draws=draws)
            (m["mse_coarse"] + m["mse_fine"]).backward()
            torch.cuda.synchronize()
        counts[name] = read_counts()
        check(fm._backward.forwards_run == recomputed, f"nerf-remat: {name}: the backward ran a forward of its own")
        saves[name] = list(flags)
        peaks[name] = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()}
    base.zero_grad(set_to_none=True)
    equal = all(torch.equal(grads["remat=True"][n], grads["remat=False"][n]) for n in grads["remat=False"])
    ratios = grad_ratios(grads["remat=True"], grads["remat=False"])
    worst = max(ratios, key=ratios.get)
    log(f"nerf-remat: one training step: launches {counts}; #12 save flags in call order {saves}; peak memory above"
        f" the weights and optimizer state: remat=False {peaks['remat=False']:.3f} GB, remat=True"
        f" {peaks['remat=True']:.3f} GB ({card}); gradients {'equal to the bit' if equal else 'NOT bit-equal'}"
        f" (worst {worst} {ratios[worst]:.3e} of its max|grad|)")
    check(counts["remat=False"]["nerf_field"] == 2 and counts["remat=False"]["nerf_field_grad"] == 2,
          f"nerf-remat: remat=False launches {counts['remat=False']}")
    check(counts["remat=True"]["nerf_field"] == 4 and counts["remat=True"]["nerf_field_grad"] == 2,
          f"nerf-remat: remat=True launches {counts['remat=True']}")
    check(saves["remat=True"] == [False, False, True, True] and saves["remat=False"] == [True, True],
          f"nerf-remat: builds {saves}")
    check(equal or ratios[worst] <= GRAD_GATE, f"nerf-remat: remat gradients off: {worst} {ratios[worst]:.3e}")
    del remat
    torch.cuda.empty_cache()
    return {k: counts["remat=False"][k] + counts["remat=True"][k] for k in counts["remat=False"]}


def phase_points_to_volume(device, card):
    """points-serving's 30 000 coloured torus points splatted into a 128^3
    grid (extent 3) in both modes: the densities, the weighted colour sums
    and their gradients to the points and colours against float64 (and the
    rescaled colours where the density is at least P2V_RESCALED_DENSITY);
    then add_pointclouds_to_volumes' volume in each mode rendered by
    VolumeRenderer at 256^2, 128 points, for the 8 azimuths (perspective
    cameras at points-serving's distance and elevation)."""
    import torch

    from pytorch3d_tpu_torch.ops import add_points_features_to_volume_densities_features
    from pytorch3d_tpu_torch.renderer import (
        EmissionAbsorptionRaymarcher,
        FoVPerspectiveCameras,
        NDCMultinomialRaysampler,
        VolumeRenderer,
        look_at_view_transform,
    )
    from pytorch3d_tpu_torch.structures import Volumes

    cloud, _ = colored_points_scene(device)
    pts, rgb = cloud.points_padded(), cloud.features_padded()
    empty = Volumes.create(torch.zeros((1, 1, P2V_GRID, P2V_GRID, P2V_GRID), device=device),
                           torch.zeros((1, 3, P2V_GRID, P2V_GRID, P2V_GRID), device=device),
                           voxel_size=VOL_EXTENT / P2V_GRID, device=device)
    R, T = look_at_view_transform(dist=3.0, elev=25.0, azim=torch.tensor(PTS_AZIMUTHS, device=device), device=device)
    cams = FoVPerspectiveCameras.create(R=R, T=T, znear=0.1, device=device)
    renderer = VolumeRenderer(
        NDCMultinomialRaysampler(image_width=P2V_IMAGE, image_height=P2V_IMAGE, n_pts_per_ray=P2V_POINTS,
                                 min_depth=P2V_DEPTH[0], max_depth=P2V_DEPTH[1]),
        EmissionAbsorptionRaymarcher(),
    )
    gen = torch.Generator(device=device).manual_seed(9)
    cot = [torch.randn((1, c, P2V_GRID, P2V_GRID, P2V_GRID), generator=gen, device=device) for c in (3, 1)]
    # Both runs splat the same local coordinates (the float32 transform's):
    # the float64 run checks the splat's arithmetic, not the transform's.
    local = empty.world_to_local_coords(pts).detach()
    reset_counts()
    for mode in ("trilinear", "nearest"):
        results = {}
        for dtype in (torch.float32, torch.float64):
            p = local.to(dtype).detach().requires_grad_(True)
            f = rgb.to(dtype).detach().requires_grad_(True)
            grid = empty.to(dtype=dtype)
            args = (p, f, grid.densities(), grid.features())
            raw, dens = add_points_features_to_volume_densities_features(*args, mode=mode, rescale_features=False)
            torch.autograd.backward([raw, dens], [c.to(dtype) for c in cot])
            with torch.no_grad():
                rescaled = add_points_features_to_volume_densities_features(*args, mode=mode)[0]
            zero = torch.zeros_like(p)  # nearest: the points get no gradient
            results[dtype] = (dens.detach(), raw.detach(), rescaled, f.grad, zero if p.grad is None else p.grad)
        (d32, r32, s32, gf32, gp32), (d64, r64, s64, gf64, gp64) = results[torch.float32], results[torch.float64]
        dense = (d64 >= P2V_RESCALED_DENSITY).expand_as(s64)
        errs = {"densities": max_ratio(d32, d64), "weighted colour sums": max_ratio(r32, r64),
                "d colours": max_ratio(gf32, gf64), "d points": max_ratio(gp32, gp64),
                "rescaled colours": float((s32.double() - s64)[dense].abs().max())}
        log(f"points-to-volume [{mode}]: {pts.shape[1]} points into {P2V_GRID}^3 against float64 on the same local"
            f" coordinates, max|diff| over each max: {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (the"
            f" rescaled colours absolute, on the {int(dense[:, 0].sum())} voxels of density >= "
            f"{P2V_RESCALED_DENSITY:g}; gates {P2V_VALUE_GATE:g} values, {P2V_GRAD_GATE:g} gradients and rescaled)")
        check(errs["densities"] <= P2V_VALUE_GATE and errs["weighted colour sums"] <= P2V_VALUE_GATE,
              f"points-to-volume [{mode}]: the splat is off float64: {errs}")
        check(max(errs["d colours"], errs["d points"], errs["rescaled colours"]) <= P2V_GRAD_GATE,
              f"points-to-volume [{mode}]: off float64: {errs}")
        del results, d32, r32, s32, gf32, gp32, d64, r64, s64, gf64, gp64
    torch.cuda.empty_cache()
    from pytorch3d_tpu_torch.ops import add_pointclouds_to_volumes

    for mode in ("trilinear", "nearest"):
        with torch.no_grad():
            volume, splat_ms = timed_ms(lambda: add_pointclouds_to_volumes(cloud, empty, mode=mode))
            batch = volume.replace(_densities=volume.densities().expand(len(cams), -1, -1, -1, -1),
                                   _features=volume.features().expand(len(cams), -1, -1, -1, -1))
            (images, _), render_ms = timed_ms(lambda: renderer(cameras=cams, volumes=batch))
            render_again = sorted(timed_ms(lambda: renderer(cameras=cams, volumes=batch))[1] for _ in range(3))
        opacity = images[..., 3]
        log(f"points-to-volume [{mode}]: occupied voxels {int((volume.densities() > 0).sum())}; render of"
            f" {len(cams)} views at {P2V_IMAGE}^2 x {P2V_POINTS} points: opacity max {float(opacity.max()):.4f}, covered"
            f" pixels {float((opacity > 0.01).double().mean()):.4f}")
        log(f"times [points-to-volume {mode}, {card}] splat {splat_ms:.3f} ms (first call), render of {len(cams)}"
            f" views median {render_again[1]:.3f} ms (first {render_ms:.3f})")
        check(images.shape == (len(cams), P2V_IMAGE, P2V_IMAGE, 4) and bool(torch.isfinite(images).all()),
              f"points-to-volume [{mode}]: render shape {tuple(images.shape)} or non-finite pixels")
        check(float((opacity > 0.01).double().mean()) > 0.01, f"points-to-volume [{mode}]: the render is empty")
    profile("points-to-volume render", lambda: renderer(cameras=cams, volumes=batch), 1)
    del images, batch, volume
    torch.cuda.empty_cache()
    return read_counts()


def phase_point_mesh_distance(device, card):
    """chamfer-fit's shapes (examples/deform_source_mesh.py): ico_sphere(4)
    against 5000 points sampled from the target torus; point_mesh_face_distance,
    point_mesh_edge_distance and mesh_face_areas_normals forward and
    backward against float64."""
    import torch

    from pytorch3d_tpu_torch.loss import point_mesh_edge_distance, point_mesh_face_distance
    from pytorch3d_tpu_torch.ops import mesh_face_areas_normals
    from pytorch3d_tpu_torch.structures import Pointclouds
    from pytorch3d_tpu_torch.utils import ico_sphere

    mesh = ico_sphere(4, device=device)
    _, target = chamfer_clouds(device)
    verts, faces = mesh.verts_padded()[0], mesh.faces_padded()[0]
    cloud = Pointclouds.create(target, device=device)
    reset_counts()
    for name, fn in (("face", point_mesh_face_distance), ("edge", point_mesh_edge_distance)):
        results = {}
        for dtype in (torch.float32, torch.float64):
            v = verts.detach().to(dtype).requires_grad_(True)
            p = target.detach().to(dtype).requires_grad_(True)
            loss, ms = timed_ms(lambda: fn(mesh.update_padded(v[None]), cloud.update_padded(p)))
            _, back_ms = timed_ms(loss.backward)
            results[dtype] = (loss.detach(), v.grad, p.grad, ms, back_ms)
            del loss
            torch.cuda.empty_cache()
        (l32, gv32, gp32, ms, back_ms), (l64, gv64, gp64, _, _) = results[torch.float32], results[torch.float64]
        value = float((l32.double() - l64).abs() / l64.abs())
        shares = {"verts": row_share(gv32, gv64, PMD_GRAD_GATE), "points": row_share(gp32, gp64, PMD_GRAD_GATE)}
        log(f"point-mesh-distance [{name}]: {len(target[0])} points, {len(faces)} faces: value {float(l32):.6e},"
            f" {value:.3e} off float64 (gate {PMD_VALUE_GATE:g}); gradient rows within {PMD_GRAD_GATE:g} of the"
            f" largest: {shares} (gate {PMD_ROW_SHARE}); max off {max_ratio(gv32, gv64):.3e} (verts),"
            f" {max_ratio(gp32, gp64):.3e} (points)")
        log(f"times [point_mesh_{name}_distance, {card}] forward {ms:.3f} ms, backward {back_ms:.3f} ms (float32,"
            f" the first call)")
        check(value <= PMD_VALUE_GATE, f"point-mesh-distance [{name}]: {value:.3e} off float64")
        check(all(s >= PMD_ROW_SHARE for s in shares.values()), f"point-mesh-distance [{name}]: gradients {shares}")
        del results, gv32, gp32, gv64, gp64
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(10)
    wa = torch.randn(len(faces), generator=gen, device=device, dtype=torch.float64)
    wn = torch.randn((len(faces), 3), generator=gen, device=device, dtype=torch.float64)
    results = {}
    for dtype in (torch.float32, torch.float64):
        v = verts.detach().to(dtype).requires_grad_(True)
        areas, normals = mesh_face_areas_normals(v, faces)
        ((areas * wa.to(dtype)).sum() + (normals * wn.to(dtype)).sum()).backward()
        results[dtype] = (areas.detach(), normals.detach(), v.grad)
    errs = [max_ratio(a, b) for a, b in zip(results[torch.float32], results[torch.float64])]
    log(f"mesh_face_areas_normals: {len(faces)} faces against float64: areas {errs[0]:.3e}, normals {errs[1]:.3e},"
        f" vertex gradient {errs[2]:.3e} of each max (gate {PMD_VALUE_GATE:g})")
    check(max(errs) <= PMD_VALUE_GATE, f"mesh_face_areas_normals off float64: {errs}")
    return read_counts()


# --------------------------------------------------------------------------- #
# Slice 15: the row-band rasterizer, the parallel package, ICP, EPnP, camera
# alignment, farthest point sampling and ball query
# --------------------------------------------------------------------------- #

BAND_SPLITS = ((IMAGE, 4), (480, 4))  # (image side, bands): 4 x 128 rows of the headline, and 4 x 120
# The summed band gradients against the full image's #4, as the JAX package
# holds its 8-device dry run (__graft_entry__.py:148-149, :206-207).
BAND_GRAD_ATOL = 1e-7
BAND_GRAD_RTOL = 1e-4
SHARD_LOSS_RTOL = 1e-5
SHARD_RANKS = 2  # gloo ranks spawned on the one card (NCCL takes one rank a card)
SHARD_NERF_STEPS = 10
# Step 0 of the sharded NeRF step against the single-device step on the same
# draws: tests/test_parallel.py:69-77's tolerances.
SHARD_NERF_LOSS_RTOL = 1e-5
SHARD_NERF_RTOL = 1e-4
SHARD_NERF_ATOL = 1e-6
ICP_ITERATIONS = 20
ICP_ANGLE = 0.1  # radians of each cloud's rotation
FPS_K = 1024
FPS_GATE = 1e-5  # each pick's float64 distance to the earlier picks within this of the farthest, relative
BALL_K = 64
BALL_RADIUS = 0.1
BALL_SHARE = 0.9999  # slots whose ids agree with float64 (a point within rounding of the radius may flip)
ALIGN_GATE = 1e-4  # camera alignment: max |float32 - float64| <= gate * max |float64|
# EPnP's float32 against float64: its 12-column system sums ~5000 points'
# constraints in float32 (a CPU rehearsal of this phase read 2.2e-4).
EPNP_GATE = 1e-3
ALIGN_TRUTH = 1e-3  # EPnP's and the camera alignment's R, T against the transform the inputs were made with


def band_box_tests(fv, valid, size, blur, row0, rows):
    """`face_box_tests` over the pixel rows [row0, row0 + rows) only."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls, pixel_grid_ndc

    grow = math.sqrt(blur) if blur > 0 else 0.0
    x, y = fv[..., 0], fv[..., 1]
    live = _face_culls(fv, valid, False)
    ys, xs = pixel_grid_ndc(*size, fv.device)
    ys, xs = ys[row0 : row0 + rows].flip(0).contiguous(), xs.flip(0).contiguous()  # ascending

    def inside(centres, lo, hi):
        return (torch.searchsorted(centres, hi[live].contiguous(), right=True)
                - torch.searchsorted(centres, lo[live].contiguous(), right=False)).clamp(min=0)

    return float((inside(xs, x.amin(-1) - grow, x.amax(-1) + grow)
                  * inside(ys, y.amin(-1) - grow, y.amax(-1) + grow)).double().sum())


def band_bound(fv, valid, bins, size, row0, rows, blur, k):
    """#1's least time over a band: the face verts, its tile lists and the
    pixel coordinates read once, its slots (24 B) written once, against its
    rows' box tests x the fine kernel's operations per test."""
    N, F = fv.shape[:2]
    tests = band_box_tests(fv, valid, size, blur, row0, rows)
    nbytes = N * F * 36 + bins[0].numel() * 4 + bins[1].numel() * 4 + (size[0] + size[1]) * 4
    nbytes += N * rows * size[1] * k * 24
    return (*bound_of(nbytes, tests * fine_ops_per_candidate(False, False)), tests)


def phase_band_raster(device, card):
    """bench.py's headline (ico_sphere(4), 512^2, K=8, blur 1e-4, azimuth 30,
    elevation 20, dist 2.7) rasterized in 4 bands of 128 rows through
    `rasterize_fragments_band_cuda`, forward and the headline loss's backward
    (the band builds of #1 and #4); then 480^2 in 4 bands of 120 rows, off
    the 16-row tile grid.  Gates: each band's four outputs equal to the bit
    to those rows of `rasterize_fragments_cuda` on the full image, and to
    the plain band version (ids equal, values within the #1 gate); the
    bands' gradients, summed in band order, within atol 1e-7 / rtol 1e-4 of
    the full image's #4 and within #4's gate of the float64 plain version;
    two band backward launches bit-equal."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls, rasterize_grad_plain
    from pytorch3d_tpu_torch.utils import ico_sphere

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    paths, fine_err, grad_err = {}, 0.0, 0.0
    for side, n in BAND_SPLITS:
        size, h = (side, side), side // n
        with torch.no_grad():
            fv, valid = face_inputs(ico_sphere(4, device=device), camera(30.0, device), size)
        # The path: n bands through the entry point, the headline loss's
        # backward after each (its gradient accumulates in band order).
        torch.cuda.synchronize()
        reset_counts()
        v = fv.clone().requires_grad_(True)
        bands = []
        for b in range(n):
            out = rc.rasterize_fragments_band_cuda(v, valid, b * h, h, size, BLUR, K)
            headline_loss(out[1], out[3]).backward()
            bands.append([t.detach() for t in out])
        torch.cuda.synchronize()
        counts = read_counts()
        paths[f"band-raster {side}"] = counts
        check(counts["rasterize_fine_band"] == n and counts["rasterize_grad_band"] == n
              and counts["rasterize_fine"] == 0 and counts["rasterize_grad"] == 0,
              f"band-raster {side}: launches {counts} for {n} bands (1 band forward + 1 band backward each)")
        summed = v.grad
        w = fv.clone().requires_grad_(True)
        full = rc.rasterize_fragments_cuda(w, valid, size, BLUR, K)
        headline_loss(full[1], full[3]).backward()
        full = [t.detach() for t in full]
        same = [all(torch.equal(bits(bands[b][i]), bits(full[i][:, b * h : (b + 1) * h])) for b in range(n))
                for i in range(4)]
        plain_ok = True
        for b in range(n):
            with torch.no_grad():
                plain = rc.rasterize_fragments_band_plain(fv, valid, b * h, h, size, BLUR, K)
            ids = torch.equal(bands[b][0].long(), plain[0])
            err = {name: float((g - p).abs().max()) for name, g, p in zip(("zbuf", "bary", "dists"), bands[b][1:],
                                                                          plain[1:])}
            fine_err = max(fine_err, *err.values())
            plain_ok = plain_ok and ids and row_ok(1.0, err)
        close = torch.allclose(summed, w.grad, atol=BAND_GRAD_ATOL, rtol=BAND_GRAD_RTOL)
        grad_err = max(grad_err, float((summed - w.grad).abs().max()))
        cots = headline_cotangents(full[1], full[3])
        want = rasterize_grad_plain(fv, full[0], *cots, size)
        exact = rasterize_grad_plain(fv.double(), full[0], *(None if c is None else c.double() for c in cots), size)
        _, ratio_exact = grad_error(summed.double(), exact)
        _, ratio_plain = grad_error(want.double(), exact)
        kernel_share, plain_share = face_agreement(summed, want, exact)
        twice = True
        for b in range(n):
            bins = rc.bin_faces(fv, _face_culls(fv, valid, False), size, BLUR, (b * h, h))
            rows = slice(b * h, (b + 1) * h)
            cb = [None if c is None else c[:, rows].contiguous() for c in cots]
            first = rc.rasterize_grad_band_cuda(fv, full[0][:, rows].contiguous(), *cb, b * h, size, bins)
            second = rc.rasterize_grad_band_cuda(fv, full[0][:, rows].contiguous(), *cb, b * h, size, bins)
            twice = twice and torch.equal(bits(first), bits(second))
        ok = (all(same) and plain_ok and close and twice and bool(torch.isfinite(summed).all())
              and ratio_exact <= max(GRAD_GATE, GRAD_PLAIN_FACTOR * ratio_plain) and kernel_share >= GRAD_FACE_SHARE)
        log(f"band-raster [{side}^2 in {n} bands of {h} rows, ico4 F={fv.shape[1]} K={K} blur {BLUR:g}]: launches"
            f" {counts}; bands equal to the bit to the full image's rows (ids, zbuf, bary, dists) {same}; against"
            f" the plain band version: ids equal and values within the #1 gate {plain_ok}; summed band gradients"
            f" vs the full image's #4: max|diff| {float((summed - w.grad).abs().max()):.3e} (atol {BAND_GRAD_ATOL:g},"
            f" rtol {BAND_GRAD_RTOL:g}: {close}); vs float64 plain: {ratio_exact:.3e} of max|grad| (float32 plain"
            f" {ratio_plain:.3e}), faces within {GRAD_GATE:g}: {kernel_share:.6f} (plain {plain_share:.6f});"
            f" two band backward launches bit-equal {twice} -> {'ok' if ok else 'FAIL'}")
        check(ok, f"band-raster {side}: the bands disagree (see the line above)")

        frame = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                for b in range(n):
                    rc.rasterize_fragments_band_cuda(fv, valid, b * h, h, size, BLUR, K)
            torch.cuda.synchronize()
            frame.append((time.perf_counter() - t0) * 1e3)
        frame.sort()
        log(f"times [band-raster frame {side}^2, {card}] {n} band forwards through the entry point, binning"
            f" included: median {frame[len(frame) // 2]:.3f} ms (min {frame[0]:.3f}, max {frame[-1]:.3f})")
        del full, bands, summed, w, v
        torch.cuda.empty_cache()
    return paths, {"rasterize_fine_band": fine_err, "rasterize_grad_band": grad_err}


def band_times(device, card):
    """The band builds of #1 and #4 at band-raster's splits: each band's
    device time (profiler), its bound, the plain band versions' times.  Run
    with the other kernels' times: after slice 12-14's profiles the
    profiler drops #1's records in every window."""
    import torch

    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc
    from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls, rasterize_grad_plain
    from pytorch3d_tpu_torch.utils import ico_sphere

    out = {}
    for side, n in BAND_SPLITS:
        size, h = (side, side), side // n
        with torch.no_grad():
            fv, valid = face_inputs(ico_sphere(4, device=device), camera(30.0, device), size)
            full = rc.rasterize_fragments_cuda(fv, valid, size, BLUR, K)
        cots = headline_cotangents(full[1], full[3])
        fine_ms, grad_ms, bounds, grad_bounds = [], [], [], []
        for b in range(n):
            row_band, rows = (b * h, h), slice(b * h, (b + 1) * h)
            bins = rc.bin_faces(fv, _face_culls(fv, valid, False), size, BLUR, row_band)
            fine_ms.append(device_ms(lambda: rc._run_kernel(fv, bins, size, BLUR, K, False, False, row_band,
                                                            rc.rasterize_fragments_band_cuda),
                                     f"rasterize_fine_kernel<{fine_bucket(K)}, false>", iters=20, warmup=5))
            idx_b = full[0][:, rows].contiguous()
            cb = [None if c is None else c[:, rows].contiguous() for c in cots]
            stages = device_ms_by_kernel(lambda: rc.rasterize_grad_band_cuda(fv, idx_b, *cb, b * h, size, bins),
                                         GRAD_KERNELS)
            grad_ms.append(sum(stages.values()))
            bounds.append(band_bound(fv, valid, bins, size, b * h, h, BLUR, K))
            grad_bounds.append(grad_bound(fv, idx_b, cb, False, False))
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: rc.rasterize_fragments_band_plain(fv, valid, 0, h, size, BLUR, K), iters=2,
                               warmup=1)
        grad_plain_ms = cuda_ms(lambda: rasterize_grad_plain(fv, full[0][:, :h], *(None if c is None else c[:, :h]
                                                                                  for c in cots), size), iters=2,
                                warmup=1)
        log(f"times [band-raster {side}^2 in {n} bands, {card}] #1 band build per band"
            f" {[round(t, 4) for t in fine_ms]} ms (device time; bounds {[round(x[0], 5) for x in bounds]} ms by"
            f" {bounds[0][1]}, box tests {[round(x[2] / 1e6, 3) for x in bounds]} M); #4 band build per band"
            f" {[round(t, 4) for t in grad_ms]} ms (both passes; bounds {[round(x[0], 5) for x in grad_bounds]} ms by"
            f" {grad_bounds[0][1]}); plain band {plain_ms:.2f} ms, plain band backward {grad_plain_ms:.2f} ms (band 0)")
        out[side] = {
            "fine": dict(kernel=sum(fine_ms) / n, plain=plain_ms, bound=sum(x[0] for x in bounds) / n,
                         bound_by=bounds[0][1]),
            "grad": dict(kernel=sum(grad_ms) / n, plain=grad_plain_ms, bound=sum(x[0] for x in grad_bounds) / n,
                         bound_by=grad_bounds[0][1]),
        }
        del full
        torch.cuda.empty_cache()
    return out[IMAGE]


def headline_faces(device, size=(IMAGE, IMAGE)):
    """The headline's (F, 3, 3) NDC faces and (F,) mask."""
    import torch

    from pytorch3d_tpu_torch.utils import ico_sphere

    with torch.no_grad():
        fv, valid = face_inputs(ico_sphere(4, device=device), camera(30.0, device), size)
    return fv[0].contiguous(), valid[0].contiguous()


def sharded_raster_rank(rank, world, fv_np, valid_np):
    """One rank of the spawned group: the sharded rasterizer and silhouette
    loss on a (1, world) mesh, on the card; numpy results and the rank's
    launch counts."""
    import torch

    from pytorch3d_tpu_torch.parallel import get_device_mesh, rasterize_fragments_shard_map
    from pytorch3d_tpu_torch.parallel import sharded_silhouette_loss_and_grad

    device = torch.device("cuda")
    fv, valid = torch.tensor(fv_np, device=device), torch.tensor(valid_np, device=device)
    mesh = get_device_mesh((1, world))
    reset_counts()
    frags = rasterize_fragments_shard_map(fv, valid, (IMAGE, IMAGE), mesh, blur_radius=BLUR, faces_per_pixel=K)
    loss, grad = sharded_silhouette_loss_and_grad(fv, valid, (IMAGE, IMAGE), mesh, blur_radius=BLUR,
                                                  faces_per_pixel=K)
    torch.cuda.synchronize()
    counts = read_counts()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        sharded_silhouette_loss_and_grad(fv, valid, (IMAGE, IMAGE), mesh, blur_radius=BLUR, faces_per_pixel=K)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"frags": [t.cpu().numpy() for t in frags], "loss": float(loss), "grad": grad.cpu().numpy(),
            "counts": counts, "ms": sorted(ms)[2], "device": torch.cuda.get_device_name(0)}


def phase_sharded_raster(device, card):
    """`sharded_silhouette_loss_and_grad` and `rasterize_fragments_shard_map`
    at the headline (ico_sphere(4), 512^2, K=8, blur 1e-4) in a world-1 NCCL
    group in this process, then in a 2-rank gloo group spawned on the one
    card (NCCL takes one rank a card).  Gates: the loss within rtol 1e-5 and
    the gradient within atol 1e-7 / rtol 1e-4 between the two; the
    fragments equal to the bit to the full image's on every rank; both
    groups launch the band builds of #1 and #4."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pytorch3d_tpu_torch.parallel import get_device_mesh, rasterize_fragments_shard_map
    from pytorch3d_tpu_torch.parallel import sharded_silhouette_loss_and_grad
    from torch_parallel_ranks import free_port, run_ranks
    from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as rc

    size = (IMAGE, IMAGE)
    fv, valid = headline_faces(device)
    with torch.no_grad():
        full = [t[0] for t in rc.rasterize_fragments_cuda(fv[None], valid[None], size, BLUR, K)]
    bits = lambda t: t.view(np.int32) if t.dtype == np.float32 else t  # noqa: E731
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        mesh = get_device_mesh((1, 1))
        torch.cuda.synchronize()
        reset_counts()
        frags = rasterize_fragments_shard_map(fv, valid, size, mesh, blur_radius=BLUR, faces_per_pixel=K)
        loss1, grad1 = sharded_silhouette_loss_and_grad(fv, valid, size, mesh, blur_radius=BLUR, faces_per_pixel=K)
        torch.cuda.synchronize()
        counts = read_counts()
        one = []
        for _ in range(5):
            t0 = time.perf_counter()
            sharded_silhouette_loss_and_grad(fv, valid, size, mesh, blur_radius=BLUR, faces_per_pixel=K)
            torch.cuda.synchronize()
            one.append((time.perf_counter() - t0) * 1e3)
        one_ms = sorted(one)[2]
    finally:
        dist.destroy_process_group()
    same1 = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                            b.view(torch.int32) if b.dtype == torch.float32 else b) for a, b in zip(frags, full))
    check(counts["rasterize_fine_band"] == 2 and counts["rasterize_grad_band"] == 1,
          f"sharded-raster: launches {counts} in the world-1 group (2 band forwards, 1 band backward)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = run_ranks(sharded_raster_rank, SHARD_RANKS, "gloo", (fv.cpu().numpy(), valid.cpu().numpy()))
    spawn_s = time.perf_counter() - t0
    full_np = [t.cpu().numpy() for t in full]
    g1 = grad1.cpu().numpy()
    ok = same1 and float(grad1.abs().max()) > 0
    for r, out in enumerate(outs):
        same = all(np.array_equal(bits(a), bits(b)) for a, b in zip(out["frags"], full_np))
        loss_ok = abs(out["loss"] - float(loss1)) <= SHARD_LOSS_RTOL * abs(float(loss1))
        grad_ok = bool(np.allclose(out["grad"], g1, atol=BAND_GRAD_ATOL, rtol=BAND_GRAD_RTOL))
        launched = out["counts"]["rasterize_fine_band"] == 2 and out["counts"]["rasterize_grad_band"] == 1
        log(f"sharded-raster [rank {r} of {SHARD_RANKS}, gloo on {out['device']}]: fragments equal to the bit to the"
            f" full image {same}; loss {out['loss']:.8f} vs world-1 {float(loss1):.8f} (rtol {SHARD_LOSS_RTOL:g}:"
            f" {loss_ok}); gradient max|diff| {float(np.abs(out['grad'] - g1).max()):.3e} (atol {BAND_GRAD_ATOL:g},"
            f" rtol {BAND_GRAD_RTOL:g}: {grad_ok}); launches {out['counts']}")
        ok = ok and same and loss_ok and grad_ok and launched
    log(f"sharded-raster [world-1 NCCL group]: fragments equal to the bit to the full image {same1}; loss"
        f" {float(loss1):.8f}, max|grad| {float(grad1.abs().max()):.3e}; launches {counts}")
    log(f"times [sharded-raster, {card}] world-1 group: loss and gradient median {one_ms:.3f} ms;"
        f" {SHARD_RANKS}-rank gloo group on one card: loss and gradient median {[round(o['ms'], 3) for o in outs]} ms"
        f" a rank; spawning the group and its first calls {spawn_s:.1f} s")
    check(ok, "sharded-raster: the sharded rasterizer disagrees (see the lines above)")
    return {"sharded-raster": counts}


def nerf_model(device, seed):
    """The full-width RadianceFieldRenderer on cow.npz's depths with seeded
    xavier weights (zero biases, as flax initialises them)."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.models import RadianceFieldRenderer

    data = np.load(NERF_DATA)
    return RadianceFieldRenderer(
        image_width=NERF_FRAME, image_height=NERF_FRAME, n_pts_per_ray=64, n_pts_per_ray_fine=64,
        n_rays_per_image=NERF_RAYS, min_depth=float(data["znear"]), max_depth=float(data["zfar"]),
        bg_color=(1.0, 1.0, 1.0), device=device, generator=torch.Generator(device=device).manual_seed(seed),
    )


def sharded_nerf_rank(rank, world, state, views, draws):
    """One rank of the spawned group: SHARD_NERF_STEPS sharded NeRF steps on
    a (1, world) mesh; after each, whether every rank holds the same
    parameters (an all_gather of the flat parameters, compared bit for bit)."""
    import torch
    import torch.distributed as dist

    from pytorch3d_tpu_torch.parallel import get_device_mesh, make_nerf_train_step

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = NeRFScene(device)
    model = scene.model
    if rank == 0:  # the others take rank 0's weights from the step's broadcast
        model.load_state_dict({k: torch.tensor(v, device=device) for k, v in state.items()})
    step = make_nerf_train_step(model, torch.optim.Adam(model.parameters(), lr=NERF_LR),
                                mesh=get_device_mesh((1, world)))
    losses, equal, ms, first = [], [], [], None
    reset_counts()
    for i, v in enumerate(views):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(scene.camera(v), scene.images[v : v + 1],
                       draws={k: torch.tensor(a, device=device) for k, a in draws[i].items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat)
        equal.append(all(torch.equal(parts[0].view(torch.int32), p.view(torch.int32)) for p in parts))
        if i == 0 and rank == 0:
            first = {k: t.detach().cpu().numpy() for k, t in model.state_dict().items()}
    counts = {k: n for k, n in read_counts().items() if k in ("nerf_field", "nerf_field_grad")}
    return {"losses": losses, "equal": equal, "ms": ms, "first": first, "counts": counts}


def phase_sharded_nerf(device, card):
    """The NeRF step of PR 4 (`RadianceFieldRenderer` defaults: 8 x 256,
    64 + 64 points, 1024 rays, cow.npz) sharded over a (1, 2) mesh of gloo
    ranks spawned on the one card, SHARD_NERF_STEPS Adam steps on the same
    views and draws.  Gates: step 0 against the single-device step on the
    same draws (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6); the
    ranks' parameters equal to the bit after every step; a falling loss;
    #12 and #13 launched on both ranks (2 each a step)."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.parallel import make_nerf_train_step
    from torch_parallel_ranks import run_ranks

    scene = NeRFScene(device)
    order = np.random.RandomState(15).permutation(scene.train_idx)
    views = [int(order[i]) for i in range(SHARD_NERF_STEPS)]
    model = nerf_model(device, 5)
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(16)
    draws = [{k: t.cpu().numpy() for k, t in model.make_draws(1, True, gen).items()} for _ in views]
    step = make_nerf_train_step(model, torch.optim.Adam(model.parameters(), lr=NERF_LR))
    single = step(scene.camera(views[0]), scene.images[views[0] : views[0] + 1],
                  draws={k: torch.tensor(a, device=device) for k, a in draws[0].items()})
    single_loss = float(single["loss"])
    single_params = {k: t.detach().cpu().numpy() for k, t in model.state_dict().items()}
    del model, step, scene
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = run_ranks(sharded_nerf_rank, SHARD_RANKS, "gloo", (state, views, draws))
    spawn_s = time.perf_counter() - t0
    losses = outs[0]["losses"]
    loss_ok = abs(losses[0] - single_loss) <= SHARD_NERF_LOSS_RTOL * abs(single_loss)
    worst, failing = 0.0, []
    for k, want in single_params.items():
        got = outs[0]["first"][k]
        worst = max(worst, float(np.abs(got - want).max()))
        if not np.allclose(got, want, rtol=SHARD_NERF_RTOL, atol=SHARD_NERF_ATOL):
            failing.append(k)
    equal = all(all(o["equal"]) for o in outs)
    same_losses = all(o["losses"] == losses for o in outs)
    launched = all(o["counts"] == {"nerf_field": 2 * SHARD_NERF_STEPS, "nerf_field_grad": 2 * SHARD_NERF_STEPS}
                   for o in outs)
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    log(f"sharded-nerf [(1, {SHARD_RANKS}) mesh of gloo ranks on one card, {NERF_RAYS} rays a step,"
        f" {NERF_RAYS // SHARD_RANKS} a rank]: step 0 loss {losses[0]:.8f} vs the single-device step {single_loss:.8f} (rtol"
        f" {SHARD_NERF_LOSS_RTOL:g}: {loss_ok}); parameters after step 0 max|diff| {worst:.3e}, tensors outside"
        f" rtol {SHARD_NERF_RTOL:g} / atol {SHARD_NERF_ATOL:g}: {failing}; ranks' parameters equal to the bit after"
        f" every step {equal} ({[o['equal'] for o in outs]}), the same losses {same_losses}; losses"
        f" {[round(v, 6) for v in losses]}; launches per rank {[o['counts'] for o in outs]}")
    step_ms = sorted(outs[0]["ms"][2:])
    log(f"times [sharded-nerf step, {card}] median of steps 3-{SHARD_NERF_STEPS} on rank 0"
        f" {step_ms[len(step_ms) // 2]:.3f} ms (ranks' steps {[[round(t, 2) for t in o['ms']] for o in outs]});"
        f" spawning the group and its steps {spawn_s:.1f} s")
    check(loss_ok and not failing, "sharded-nerf: step 0 differs from the single-device step")
    check(equal and same_losses, "sharded-nerf: the ranks' parameters or losses differ")
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"sharded-nerf: the loss did not fall (first 3 {first:.6f}, last 3 {last:.6f})")
    check(launched, f"sharded-nerf: launches {[o['counts'] for o in outs]}, not #12 and #13 twice a step on each rank")
    return {f"sharded-nerf rank {r}": o["counts"] for r, o in enumerate(outs)}


class Float64Cameras:
    """A float64 witness of a camera batch for the alignment: R, T and the
    centres (x_cam = x R + T, so the centre is -T R^T) in float64 (the
    port's cameras compute their centres through float32 transforms)."""

    def __init__(self, R, T):
        self.R, self.T = R.double(), T.double()

    def get_camera_center(self):
        return -(self.T[:, None] @ self.R.transpose(1, 2))[:, 0]

    def replace(self, R, T):
        return Float64Cameras(R, T)


def random_rotations_from(gen, n, angle, device):
    """n rotations of `angle` radians about seeded random axes (row-vector
    convention, Rodrigues)."""
    import torch

    axis = torch.randn((n, 3), generator=gen, device=device)
    axis = axis / axis.norm(dim=-1, keepdim=True)
    k = torch.zeros((n, 3, 3), device=device)
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    k = k - k.transpose(1, 2)
    eye = torch.eye(3, device=device).expand(n, 3, 3)
    return eye + math.sin(angle) * k + (1.0 - math.cos(angle)) * k @ k


def phase_alignment_ops(device, card):
    """points-serving's 30 000-point cloud as 8 clouds: ICP
    (`iterative_closest_point`, estimate_scale) to seeded rotated (0.1 rad),
    scaled and shifted copies through #9, against the plain KNN route (the
    same bits); `sample_farthest_points` takes K=1024 of each cloud (each
    pick, in float64, the farthest point from the earlier picks to 1e-5);
    `ball_query` K=64 within 0.1 of those centres against float64 (ids on
    >= 99.99 % of slots); `efficient_pnp` on pose-fit's 8 OpenCV cameras'
    projections of the joined scene's vertices, and
    `corresponding_cameras_alignment` (both modes) of those cameras to a
    similarity-transformed copy, against float64 (1e-4 of the largest) and
    the transforms the inputs were made with (1e-3)."""
    import torch

    from pytorch3d_tpu_torch.ops import (
        ball_query, corresponding_cameras_alignment, efficient_pnp, iterative_closest_point, knn_points,
        sample_farthest_points,
    )
    from pytorch3d_tpu_torch.renderer import cameras_from_opencv_projection

    cloud, _ = colored_points_scene(device)
    X = cloud.points_padded().expand(PTS_REQUESTS, -1, -1).contiguous()
    gen = torch.Generator(device=device).manual_seed(17)
    R_true = random_rotations_from(gen, PTS_REQUESTS, ICP_ANGLE, device)
    s_true = 0.9 + 0.2 * torch.rand(PTS_REQUESTS, generator=gen, device=device)
    T_true = 0.1 * torch.randn((PTS_REQUESTS, 3), generator=gen, device=device)
    Y = (s_true[:, None, None] * X @ R_true + T_true[:, None]).contiguous()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sol = iterative_closest_point(X, Y, estimate_scale=True, max_iterations=ICP_ITERATIONS)
    torch.cuda.synchronize()
    icp_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    iterations = len(sol.t_history)
    check(counts["knn"] == iterations, f"alignment-ops: ICP launches {counts} for {iterations} iterations")
    with plain_knn():
        ref = iterative_closest_point(X, Y, estimate_scale=True, max_iterations=ICP_ITERATIONS)
    same = (sol.converged == ref.converged and len(ref.t_history) == iterations
            and all(torch.equal(a, b) for a, b in zip(sol.RTs, ref.RTs)) and torch.equal(sol.Xt, ref.Xt))
    icp_err = max(float((a - b).abs().max()) for a, b in zip(sol.RTs, ref.RTs))
    # CUDA events over back-to-back calls: a call lasts milliseconds, far
    # above the wrapper's host time.
    knn_ms = cuda_ms(lambda: knn_points(X, Y, K=1), iters=20, warmup=3)
    log(f"alignment-ops [ICP, {PTS_REQUESTS} clouds of {X.shape[1]} points, estimate_scale]: {iterations} iterations,"
        f" converged {sol.converged}, rmse {[f'{float(v):.2e}' for v in sol.rmse]}; off the true R by"
        f" {float((sol.RTs.R - R_true).abs().max()):.2e}, s by {float((sol.RTs.s - s_true).abs().max()):.2e};"
        f" #9 route equal to the bit to the plain KNN route {same} (max|diff| {icp_err:.1e}); launches {counts}")
    log(f"times [ICP, {card}] {icp_ms:.1f} ms for {iterations} iterations ({icp_ms / iterations:.2f} ms an iteration,"
        f" first call); #9 at {PTS_REQUESTS} x {X.shape[1]}^2, K=1: {knn_ms:.4f} ms (CUDA events over back-to-back"
        f" calls)")
    check(same, "alignment-ops: ICP through #9 differs from the plain KNN route")

    t0 = time.perf_counter()
    centres, picked = sample_farthest_points(X, K=FPS_K)
    torch.cuda.synchronize()
    fps_ms = (time.perf_counter() - t0) * 1e3
    X64 = X.double()
    batch = torch.arange(PTS_REQUESTS, device=device)
    min_d = torch.full(X.shape[:2], math.inf, dtype=torch.float64, device=device)
    fps_worst = 0.0
    for k in range(FPS_K):
        if k > 0:
            d = min_d[batch, picked[:, k]]
            fps_worst = max(fps_worst, float(((min_d.amax(dim=1) - d) / min_d.amax(dim=1)).max()))
        min_d = torch.minimum(min_d, ((X64 - X64[batch, picked[:, k]][:, None]) ** 2).sum(-1))
    log(f"alignment-ops [sample_farthest_points, K={FPS_K}]: each pick's float64 distance to the earlier picks"
        f" within {fps_worst:.2e} of the farthest, relative (gate {FPS_GATE:g}); {fps_ms:.1f} ms")
    check(fps_worst <= FPS_GATE, f"alignment-ops: farthest point sampling off by {fps_worst:.2e}")

    t0 = time.perf_counter()
    bq = ball_query(centres, X, K=BALL_K, radius=BALL_RADIUS)
    torch.cuda.synchronize()
    ball_ms = (time.perf_counter() - t0) * 1e3
    bq64 = ball_query(centres.double(), X64, K=BALL_K, radius=BALL_RADIUS)
    share = float((bq.idx == bq64.idx).double().mean())
    both = (bq.idx == bq64.idx) & (bq.idx >= 0)
    ball_err = float((bq.dists.double() - bq64.dists)[both].abs().max())
    log(f"alignment-ops [ball_query, K={BALL_K}, radius {BALL_RADIUS:g}, {FPS_K} centres a cloud]: ids equal to"
        f" float64's on {share:.6f} of the slots (gate {BALL_SHARE}), filled {float((bq.idx >= 0).double().mean()):.4f};"
        f" distances {ball_err:.2e} off; {ball_ms:.1f} ms")
    check(share >= BALL_SHARE and ball_err <= 1e-6, "alignment-ops: ball query off float64")
    del bq, bq64, X64, min_d
    torch.cuda.empty_cache()

    scene, _ = joined_spheres(device)
    cams = cameras_from_opencv_projection(*opencv_views(device))
    x = scene.verts_padded()[0].expand(FIT_VIEWS, -1, -1).contiguous()
    x_cam = x @ cams.R + cams.T[:, None]
    y = x_cam[..., :2] / x_cam[..., 2:]
    pnp = efficient_pnp(x, y)
    pnp64 = efficient_pnp(x.double(), y.double())
    pnp_errs = {n: max_ratio(getattr(pnp, n), getattr(pnp64, n)) for n in ("R", "T", "x_cam")}
    truth = max(float((pnp.R - cams.R).abs().max()), float((pnp.T - cams.T).abs().max()) / float(cams.T.abs().max()))
    log(f"alignment-ops [efficient_pnp, {FIT_VIEWS} views of {x.shape[1]} vertices]: off float64, of each max:"
        f" {', '.join(f'{k} {v:.2e}' for k, v in pnp_errs.items())} (gate {EPNP_GATE:g}); off the cameras' pose by"
        f" {truth:.2e} (gate {ALIGN_TRUTH:g}); reprojection error {float(pnp.err_2d.max()):.2e}")
    check(max(pnp_errs.values()) <= EPNP_GATE and truth <= ALIGN_TRUTH, "alignment-ops: EPnP off")

    Ra = random_rotations_from(gen, 1, 0.7, device)[0]
    Ta, sa = torch.tensor([0.3, -0.2, 0.5], device=device), 1.3
    # x' = sa x Ra + Ta: camera (R, T) sees it as (Ra^T R, sa T - Ta Ra^T R).
    R_tgt = Ra.T[None] @ cams.R
    T_tgt = sa * cams.T - torch.einsum("i,nij->nj", Ta @ Ra.T, cams.R)
    tgt = cams.replace(R=R_tgt, T=T_tgt)
    for mode in ("extrinsics", "centers"):
        got = corresponding_cameras_alignment(cams, tgt, estimate_scale=True, mode=mode)
        got64 = corresponding_cameras_alignment(Float64Cameras(cams.R, cams.T), Float64Cameras(R_tgt, T_tgt),
                                                estimate_scale=True, mode=mode)
        err = max(max_ratio(got.R, got64.R), max_ratio(got.T, got64.T))
        truth = max(max_ratio(got.R, R_tgt), max_ratio(got.T, T_tgt))
        log(f"alignment-ops [corresponding_cameras_alignment, {mode}]: {err:.2e} of each max off float64 (gate"
            f" {ALIGN_GATE:g}), {truth:.2e} off the target cameras (gate {ALIGN_TRUTH:g})")
        check(err <= ALIGN_GATE and truth <= ALIGN_TRUTH, f"alignment-ops: camera alignment ({mode}) off")
    return {"alignment-ops": counts}



MESH_OPS_CUBIFY = (4, 32)  # grids, side
MESH_OPS_MC = 64  # marching cubes: a 64^3 sphere SDF
MESH_OPS_BOXES = 100  # box3d_overlap: 100 x 100 = 10^4 pairs
MESH_OPS_PYRAMID = ((256, 56), (512, 28), (1024, 14), (2048, 7))  # Mesh R-CNN's ResNet-50 stages (C, side)
MESH_OPS_CHANNELS = 128  # GraphConv's width in Mesh R-CNN's refinement
MESH_OPS_EXACT = 1e-6  # cubify, subdivision: the card against the CPU (the same float32 operations)
MESH_OPS_GATE = 1e-5  # marching cubes, box IoU, vert align, GraphConv, Taubin: max |card - CPU|
NERF_TRAINER_ARGS = ["--image_size", "128", "--hidden", "256", "--layers", "8", "--n_rays", "1024", "--n_pts", "64"]
NERF_TRAINER_EPOCHS = 2


def _boxes_from(gen, n, device):
    """n seeded oriented boxes (PyTorch3D's corner order) of sides 0.5-1.5
    about centres in [-1, 1]^3."""
    import torch

    unit = torch.tensor([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                        dtype=torch.float32, device=device)
    R = random_rotations_from(gen, n, math.pi, device)
    size = 0.5 + torch.rand((n, 1, 3), generator=gen, device=device)
    centre = torch.rand((n, 1, 3), generator=gen, device=device) * 2 - 1
    return ((unit - 0.5) * size) @ R + centre


def phase_mesh_ops(device, card):
    """Slice 16's mesh and box ops at sizes their users run, on the card,
    each against the same call on the CPU (the same code on another device;
    no kernel runs here): cubify of 4 seeded 32^3 occupancies, marching
    cubes of a 64^3 sphere SDF, box3d_overlap of 100 x 100 = 10^4 seeded box
    pairs, SubdivideMeshes of ico_sphere(4) with per-vertex features,
    vert_align of the headline mesh's NDC vertices against Mesh R-CNN's
    4-level ResNet-50 feature pyramid (256 x 56^2 ... 2048 x 7^2),
    GraphConv at 128 channels over ico_sphere(4)'s edges, and 10 Taubin
    iterations of a noisy ico_sphere(4).  Faces equal, values within
    MESH_OPS_EXACT or MESH_OPS_GATE."""
    import torch

    from pytorch3d_tpu_torch.ops import (
        GraphConv, SubdivideMeshes, box3d_overlap, cubify, marching_cubes, taubin_smoothing, vert_align,
    )
    from pytorch3d_tpu_torch.renderer import MeshRasterizer
    from pytorch3d_tpu_torch.utils import ico_sphere

    cpu = torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(16)
    times = {}

    def run(name, fn, *args):
        """fn on the card (timed with CUDA events over 3 calls after one)
        and on the CPU copies of `args`."""
        out = fn(*args)
        times[name] = cuda_ms(lambda: fn(*args), iters=3, warmup=0)
        return out, fn(*[a.to(cpu) for a in args])

    def worst(a, b):
        return float((a.cpu() - b).abs().max()) if a.numel() else 0.0

    torch.cuda.synchronize()
    reset_counts()
    n, side = MESH_OPS_CUBIFY
    vox = torch.rand((n, side, side, side), generator=gen, device=device)
    got, want = run("cubify", lambda v: cubify(v, 0.7), vox)
    same = torch.equal(got.faces_padded().cpu(), want.faces_padded()) and torch.equal(
        got.num_verts_per_mesh().cpu(), want.num_verts_per_mesh())
    err = worst(got.verts_padded(), want.verts_padded())
    log(f"mesh-ops [cubify, {n} x {side}^3, thresh 0.7]: {got.num_faces_per_mesh().tolist()} faces, faces equal to the"
        f" CPU's {same}, vertices {err:.1e} off (gate {MESH_OPS_EXACT:g})")
    check(same and err <= MESH_OPS_EXACT, "mesh-ops: cubify on the card differs from the CPU")

    g = torch.linspace(-1.0, 1.0, MESH_OPS_MC, device=device)
    z, y, x = torch.meshgrid(g, g, g, indexing="ij")
    sdf = (torch.sqrt(x * x + y * y + z * z) - 0.6)[None]
    (gv, gf), (wv, wf) = run("marching_cubes", lambda v: marching_cubes(v, 0.0), sdf)
    same, err = torch.equal(gf[0].cpu(), wf[0]), worst(gv[0], wv[0])
    radius = float(gv[0].norm(dim=-1).mean())  # local coordinates are the SDF grid's [-1, 1]
    log(f"mesh-ops [marching_cubes, {MESH_OPS_MC}^3 sphere SDF]: {gv[0].shape[0]} vertices, {gf[0].shape[0]} faces,"
        f" faces equal to the CPU's {same}, vertices {err:.1e} off (gate {MESH_OPS_GATE:g}); mean |v| {radius:.4f}"
        f" (the sphere's 0.6)")
    check(same and err <= MESH_OPS_GATE and abs(radius - 0.6) < 0.01, "mesh-ops: marching cubes off")

    b1, b2 = _boxes_from(gen, MESH_OPS_BOXES, device), _boxes_from(gen, MESH_OPS_BOXES, device)
    (gvol, giou), (wvol, wiou) = run("box3d_overlap", box3d_overlap, b1, b2)
    err = max(worst(gvol, wvol), worst(giou, wiou))
    log(f"mesh-ops [box3d_overlap, {MESH_OPS_BOXES} x {MESH_OPS_BOXES} pairs]: {float((giou > 0).double().mean()):.3f}"
        f" of the pairs overlap, max IoU {float(giou.max()):.4f}; volume and IoU {err:.1e} off the CPU's"
        f" (gate {MESH_OPS_GATE:g})")
    check(err <= MESH_OPS_GATE and bool(torch.isfinite(giou).all()), "mesh-ops: box IoU off")

    ico = ico_sphere(4, device=device)
    feats = torch.rand((ico.verts_packed().shape[0], 16), generator=gen, device=device)
    got, want = run("SubdivideMeshes", lambda m, f: SubdivideMeshes()(m, f), ico, feats)
    same = torch.equal(got[0].faces_padded().cpu(), want[0].faces_padded())
    err = max(worst(got[0].verts_padded(), want[0].verts_padded()), worst(got[1], want[1]))
    log(f"mesh-ops [SubdivideMeshes, ico_sphere(4) + 16 features]: {int(got[0].num_verts_per_mesh())} vertices,"
        f" {int(got[0].num_faces_per_mesh())} faces, faces equal to the CPU's {same}, vertices and features"
        f" {err:.1e} off (gate {MESH_OPS_EXACT:g})")
    check(same and err <= MESH_OPS_EXACT, "mesh-ops: subdivision on the card differs from the CPU")

    ndc = MeshRasterizer(camera(30.0, device)).transform(ico).verts_padded()
    pyramid = [torch.randn((1, c, s, s), generator=gen, device=device) for c, s in MESH_OPS_PYRAMID]
    got, want = run("vert_align", lambda *f: vert_align(list(f[:-1]), f[-1]), *pyramid, ndc)
    err = worst(got, want)
    log(f"mesh-ops [vert_align, {ndc.shape[1]} vertices x {got.shape[-1]} channels of 4 levels]: {err:.1e} off the"
        f" CPU's (gate {MESH_OPS_GATE:g})")
    check(err <= MESH_OPS_GATE, "mesh-ops: vert_align off")

    conv = GraphConv(MESH_OPS_CHANNELS, MESH_OPS_CHANNELS, device=device, generator=gen)
    conv_cpu = GraphConv(MESH_OPS_CHANNELS, MESH_OPS_CHANNELS, device=cpu)
    conv_cpu.load_state_dict({k: v.cpu() for k, v in conv.state_dict().items()})
    x = torch.randn((ico.verts_packed().shape[0], MESH_OPS_CHANNELS), generator=gen, device=device)
    edges = ico.edges_packed()
    with torch.no_grad():
        got = conv(x, edges)
        times["GraphConv"] = cuda_ms(lambda: conv(x, edges), iters=3, warmup=0)
        err = worst(got, conv_cpu(x.cpu(), edges.cpu())) / max(float(got.abs().max()), 1e-30)
    log(f"mesh-ops [GraphConv {MESH_OPS_CHANNELS} -> {MESH_OPS_CHANNELS}, {int(ico.num_edges())} edges]: {err:.1e} of"
        f" the largest off the CPU's (gate {MESH_OPS_GATE:g})")
    check(err <= MESH_OPS_GATE, "mesh-ops: GraphConv off")

    noisy = ico.offset_verts(0.02 * torch.randn(ico.verts_packed().shape, generator=gen, device=device))
    got, want = run("taubin_smoothing", taubin_smoothing, noisy)
    err = worst(got.verts_padded(), want.verts_padded())
    moved = float((got.verts_padded() - noisy.verts_padded()).abs().max())
    log(f"mesh-ops [taubin_smoothing, ico_sphere(4), 10 iterations]: {err:.1e} off the CPU's (gate"
        f" {MESH_OPS_GATE:g}); moved the vertices by up to {moved:.3e}")
    check(err <= MESH_OPS_GATE and moved > 1e-3, "mesh-ops: Taubin smoothing off")
    counts = read_counts()
    log(f"times [mesh-ops, {card}] ms a call (CUDA events, mean of 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return {"mesh-ops": counts}


def _state_equal(a, b):
    """Nested state dicts (tensors, numbers, lists) equal to the bit."""
    import torch

    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


def phase_nerf_trainer(device, card):
    """The flagship's trainer at full width (8 x 256, 64 + 64 points, 1024
    rays at 128^2) through its entry points, as a user runs it
    (`python -m pytorch3d_tpu_torch.projects.nerf.train_nerf ...`):
    `train_nerf.main` for 2 epochs on the rendered-sphere dataset (40 views
    rendered through #1; every step runs #12 and #13), whose mean train
    loss must fall; `main` again with no epoch left, which must hold the
    saved weights, Adam state and Stats to the bit, and with `--epochs 3`,
    which must resume at epoch 2 and run it alone; `test_nerf`'s evaluation
    (each test frame's PSNR above the untrained init's on the same frame,
    one frame against use_fused_kernel=False at nerf-serving's gate) and
    the 40-frame trajectory of its export (#12; finite frames in [0, 1];
    the video written where PIL is there)."""
    import importlib.util
    import shutil

    import torch

    from pytorch3d_tpu_torch.implicitron.tools import model_io
    from pytorch3d_tpu_torch.projects.nerf import test_nerf, train_nerf

    t_phase = time.perf_counter()
    exp_dir = REPO / "build" / "nerf_trainer"
    shutil.rmtree(exp_dir, ignore_errors=True)
    argv = NERF_TRAINER_ARGS + ["--exp_dir", str(exp_dir)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run = train_nerf.main(argv + ["--epochs", str(NERF_TRAINER_EPOCHS)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    steps = len(run.stats.stats["train"]["loss"].history[-1])
    losses = run.stats.stats["train"]["loss"].get_epoch_averages()
    step_ms = run.stats.stats["train"]["sec/it"].val * 1e3  # the last epoch's time over its steps
    log(f"nerf-trainer [train_nerf.main, {' '.join(NERF_TRAINER_ARGS)} --epochs {NERF_TRAINER_EPOCHS}]: {steps} steps"
        f" an epoch, mean loss by epoch {[round(v, 5) for v in losses]}, val psnr_fine {run.val_psnr}; launches"
        f" {counts}; {train_s:.1f} s")
    check(counts["rasterize_fine"] > 0, "nerf-trainer: the dataset render launched no #1")
    check(counts["nerf_field"] >= 2 * steps * NERF_TRAINER_EPOCHS
          and counts["nerf_field_grad"] == 2 * steps * NERF_TRAINER_EPOCHS,
          f"nerf-trainer: launches {counts} for {steps * NERF_TRAINER_EPOCHS} steps")
    check(all(math.isfinite(v) for v in losses) and losses[1] < losses[0], f"nerf-trainer: loss {losses} did not fall")

    last = model_io.find_last_checkpoint(str(exp_dir))
    saved_model, saved_opt, saved_stats = model_io.load_model(last, map_location=device)
    loaded = train_nerf.main(argv + ["--epochs", str(NERF_TRAINER_EPOCHS)])
    exact = (loaded.start_epoch == NERF_TRAINER_EPOCHS and not loaded.val_psnr
             and _state_equal(loaded.model.state_dict(), saved_model)
             and _state_equal(loaded.model.state_dict(), run.model.state_dict())
             and _state_equal(loaded.optimizer.state_dict(), saved_opt)
             and _state_equal(loaded.optimizer.state_dict(), run.optimizer.state_dict())
             and loaded.stats.state_dict() == saved_stats.state_dict() == run.stats.state_dict())
    more = train_nerf.main(argv + ["--epochs", str(NERF_TRAINER_EPOCHS + 1)])
    history = more.stats.state_dict()["histories"]["train"]["loss"]
    resumed = (more.start_epoch == NERF_TRAINER_EPOCHS and len(more.val_psnr) == 1
               and history[:NERF_TRAINER_EPOCHS] == saved_stats.state_dict()["histories"]["train"]["loss"])
    log(f"nerf-trainer [resume from {Path(last).name}]: weights, Adam state and Stats equal to the saved ones bit for"
        f" bit {exact}; --epochs {NERF_TRAINER_EPOCHS + 1} started at epoch {more.start_epoch} and ran"
        f" {len(more.val_psnr)} epoch (mean loss {more.stats.stats['train']['loss'].get_epoch_averages()[-1]:.5f})")
    check(exact, "nerf-trainer: the resumed state differs from the saved one")
    check(resumed, "nerf-trainer: --epochs 3 did not resume at epoch 2 alone")
    del run, loaded

    args = test_nerf.parser().parse_args(argv)
    _, _, test = test_nerf.get_nerf_datasets("rendered_sphere", (args.image_size,) * 2, device=device)
    averages = test_nerf.main(argv + ["--mode", "evaluation"])
    trained, init = more.model, train_nerf.build_model(args, device)
    per_frame = {}
    for name, model in (("trained", trained), ("init", init)):
        stats = test_nerf.evaluate(model, test)
        per_frame[name] = {k: stats.stats["test"][k].history[0] for k in ("psnr_coarse", "psnr_fine")}
    beats = all(a > b for a, b in zip(per_frame["trained"]["psnr_fine"], per_frame["init"]["psnr_fine"]))
    log(f"nerf-trainer [test_nerf evaluation, {len(test)} test frames]: {averages}; per-frame psnr_fine trained"
        f" {[round(v, 3) for v in per_frame['trained']['psnr_fine']]} against the init's"
        f" {[round(v, 3) for v in per_frame['init']['psnr_fine']]} (coarse"
        f" {[round(v, 3) for v in per_frame['trained']['psnr_coarse']]} against"
        f" {[round(v, 3) for v in per_frame['init']['psnr_coarse']]})")
    check(beats, "nerf-trainer: the trained model does not beat its init on every test frame")

    frame = test[0]
    rgb, frame_ms = timed_ms(lambda: test_nerf.render_full(trained, frame.camera)[0])
    trained.use_fused_kernel = False
    try:
        plain = test_nerf.render_full(trained, frame.camera)[0]
    finally:
        trained.use_fused_kernel = True
    diff = (rgb - plain).abs().amax(dim=-1)
    share = float((diff <= NERF_FRAME_TOL).double().mean())
    log(f"nerf-trainer [test frame 0 vs use_fused_kernel=False]: |rgb_fine diff| <= {NERF_FRAME_TOL:g} on {share:.6f}"
        f" of pixels (max {float(diff.max()):.3e})")
    check(share >= NERF_FRAME_SHARE, f"nerf-trainer: only {share:.6f} of pixels match the plain render")

    train, _, _ = test_nerf.get_nerf_datasets("rendered_sphere", (args.image_size,) * 2, device=device)
    reset_counts()
    frames = test_nerf.trajectory_frames(trained, train, args)
    torch.cuda.synchronize()
    video_counts = read_counts()
    stack = torch.stack(frames)
    ok = bool(torch.isfinite(stack).all()) and float(stack.min()) >= 0.0 and float(stack.max()) <= 1.0
    log(f"nerf-trainer [export_video trajectory]: {len(frames)} frames of {tuple(frames[0].shape)}, range"
        f" [{float(stack.min()):.4f}, {float(stack.max()):.4f}], launches {video_counts}")
    check(ok and video_counts["nerf_field"] == 2 * args.n_frames, "nerf-trainer: trajectory frames off")
    if importlib.util.find_spec("PIL") is not None:
        path = test_nerf.main(argv + ["--mode", "export_video"])
        log(f"nerf-trainer [export_video]: wrote {Path(path).relative_to(REPO)} ({Path(path).stat().st_size} bytes)")
        check(Path(path).is_file(), "nerf-trainer: no video written")
    else:
        log("nerf-trainer [export_video]: PIL is not installed on this machine, so the video was not written;"
            " the frames above were rendered and checked")
    for kernel, n in video_counts.items():
        counts[kernel] += n
    log(f"times [nerf-trainer, {card}] step {step_ms:.3f} ms (epoch {NERF_TRAINER_EPOCHS - 1}'s wall time over its"
        f" {steps} steps, Stats' sec/it), full {args.image_size}^2 test frame {frame_ms:.3f} ms (host clock), the"
        f" first train_nerf.main {train_s:.1f} s, phase {time.perf_counter() - t_phase:.1f} s")
    return {"nerf-trainer": counts}

# Slice 17: mesh and point cloud IO, Implicitron's frame loading.
IO_VERTS_GATE = 5e-7 + 6e-8  # a vertex written with 6 decimals: half a unit of the last one and a float32 ulp at 1
# A map or colours through 8 bits: (c * 255) truncated to uint8, then / 255, is off by less than 1/255; the
# float32 difference of a texel off by 1/255 - 1e-8 can round to float32(1/255), above float64's 1/255.
IO_MAP_GATE = 1.0 / 255.0 + 1e-7
IO_IMAGE_GATE = 1.0 / 255.0 + 1e-6  # a blend of such colours with weights summing to <= 1, and its float32 rounding
IO_NATIVE_LEVEL = 7  # ico_sphere(7): 163 842 verts, 327 680 faces, for the two OBJ parsers
IO_CHECK_VIEWS = 2  # views of each loaded format rendered against the plain route
DATA_CHECK_VIEWS = 2  # the provider's views held against the plain route
DATA_IDS_SHARE = 0.999
DATA_RGB_GATE = 1e-4  # HardPhong's atomic vertex normals move a pixel by ~3e-6 between renders
DATA_IMAGE = 256  # GenericFrameDataBuilder's image_height / image_width
DATA_CLOUD_POINTS = 20_000  # the scene's point cloud, subsampled to half by load_pointcloud
DATA_CPU_GATE = 1e-6  # the frame builder and load_pointcloud on the card against device="cpu"


def _phase_clock():
    """A CUDA event recorded now; `_phase_ms(start)` reads the phase's
    milliseconds on the card's clock."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start


def _phase_ms(start):
    import torch

    stop = torch.cuda.Event(enable_timing=True)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _fragments_against_plain(label, mesh, cams):
    """MeshRasterizer's fragments of `mesh` at 512^2, K=1 through #1 against
    the plain route (bin_size=0): the share of equal ids and the largest
    zbuf difference where they agree."""
    import torch

    from pytorch3d_tpu_torch.renderer import MeshRasterizer, RasterizationSettings

    with torch.no_grad():
        frags = MeshRasterizer(cams, RasterizationSettings(image_size=IMAGE, faces_per_pixel=1))(mesh)
        plain = MeshRasterizer(cams, RasterizationSettings(image_size=IMAGE, faces_per_pixel=1, bin_size=0))(mesh)
    same = frags.pix_to_face == plain.pix_to_face
    ids = float(same.float().mean())
    hit = same & (plain.pix_to_face >= 0)
    zerr = float((frags.zbuf - plain.zbuf).abs()[hit].max()) if bool(hit.any()) else 0.0
    covered = int((frags.pix_to_face >= 0).sum())
    check(covered > 0, f"{label}: the loaded mesh covers no pixel")
    return ids, zerr, covered


def phase_mesh_io(device, card):
    """PyTorch3D's render_textured_meshes tutorial from files:
    mesh-uv-serving's ico_sphere(4) with its per-corner UVs and seeded
    1024^2 map written by `save_obj` (OBJ + MTL + PNG), loaded on the card
    by `load_objs_as_meshes` as TexturesUV and as TexturesAtlas (R = 8),
    checked against the source and served as 20 views at 512^2 through #1,
    2 of them against a bin_size=0 render of the loaded mesh; the same mesh
    through `IO().save_mesh` / `load_mesh` as binary and ASCII PLY, OFF with
    vertex colours and GLB, each rasterized against its plain route; an
    ico_sphere(7) OBJ through the native parser and the Python scanner; and
    points-serving's torus cloud through binary PLY and `IO().load_pointcloud`,
    served for the 8 azimuths through #5 with both compositors against the
    in-memory cloud's render.  Files go to a temporary directory."""
    import shutil
    import tempfile

    import torch

    from pytorch3d_tpu_torch.io import IO, fast_io, load_obj, load_objs_as_meshes, save_obj
    from pytorch3d_tpu_torch.renderer import AlphaCompositor, NormWeightedCompositor, TexturesVertex
    from pytorch3d_tpu_torch.utils import ico_sphere

    start = _phase_clock()
    tmp = Path(tempfile.mkdtemp(prefix="mesh_io_"))
    counts = dict.fromkeys(KERNELS, 0)
    times = {}
    try:
        mesh = ico_sphere(4, device=device)
        verts, faces = mesh.verts_padded()[0], mesh.faces_padded()[0]
        uvs, faces_uvs = sphere_uvs(verts, faces)
        source_map = uv_map(device)[0]
        path = tmp / "sphere.obj"
        t0 = time.perf_counter()
        save_obj(path, verts, faces, verts_uvs=uvs, faces_uvs=faces_uvs, texture_map=source_map)
        times["save_obj"] = (time.perf_counter() - t0) * 1e3
        log(f"mesh-io [save_obj]: {sorted(p.name for p in tmp.iterdir())}, {path.stat().st_size} bytes of OBJ,"
            f" {times['save_obj']:.1f} ms")

        cams = tutorial_cameras(device)
        cams_check = tutorial_cameras(device, UV_CHECK_VIEWS)
        loaded = {}
        for label, atlas in (("uv", False), ("atlas", True)):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            m = load_objs_as_meshes([path], device=device, create_texture_atlas=atlas, texture_atlas_size=UV_ATLAS_R)
            load_ms = (time.perf_counter() - t0) * 1e3
            batch = m.extend(UV_VIEWS)
            with torch.no_grad():
                images, frags = tutorial_renderer(cams, device)(batch)
            torch.cuda.synchronize()
            run = read_counts()
            loaded[label] = m
            check(m.verts_padded().device.type == "cuda" and m.faces_padded().device.type == "cuda",
                  f"mesh-io [{label}]: the loaded mesh is not on the card")
            verr = float((m.verts_padded()[0] - verts).abs().max())
            faces_equal = bool(torch.equal(m.faces_padded()[0], faces))
            if atlas:
                tex = m.textures.atlas_padded()
                tex_ok = tex.shape == (1, faces.shape[0], UV_ATLAS_R, UV_ATLAS_R, 3) and tex.device.type == "cuda"
                tex_note = f"atlas {tuple(tex.shape)} in [{float(tex.min()):.4f}, {float(tex.max()):.4f}]"
            else:
                tex = m.textures
                map_err = float((tex.maps_padded()[0] - source_map).abs().max())
                uv_err = float((tex.verts_uvs_padded()[0] - uvs).abs().max())
                tex_ok = (bool(torch.equal(tex.faces_uvs_padded()[0], faces_uvs)) and uv_err <= IO_VERTS_GATE
                          and map_err <= IO_MAP_GATE)
                tex_note = f"faces_uvs equal, uvs {uv_err:.3e} off, map {map_err:.3e} off (gate {IO_MAP_GATE:.3e})"
            with torch.no_grad():
                plain, plain_frags = tutorial_renderer(cams_check, device, bin_size=0)(batch[list(range(UV_CHECK_VIEWS))])
            ids = float((frags.pix_to_face[:UV_CHECK_VIEWS] == plain_frags.pix_to_face).float().mean())
            frac, worst = image_agreement(images[:UV_CHECK_VIEWS], plain, 1e-3)
            log(f"mesh-io [load_objs_as_meshes, {label}]: load {load_ms:.1f} ms; verts {verr:.3e} off (gate"
                f" {IO_VERTS_GATE:.2e}), faces equal {faces_equal}, {tex_note}; {UV_VIEWS} views at {IMAGE}^2 K=1:"
                f" launches {run}; views 0-{UV_CHECK_VIEWS - 1} against the plain route: ids equal {ids:.6f},"
                f" |image - plain| <= 1e-3 on {frac:.6f} of pixels (max {worst:.3e})")
            check(verr <= IO_VERTS_GATE and faces_equal and tex_ok, f"mesh-io [{label}]: the loaded mesh is off")
            check(run["rasterize_fine"] == 1, f"mesh-io [{label}]: launches {run} for one batch of {UV_VIEWS}")
            check(bool(torch.isfinite(images).all()) and bool(((images[..., 3] > 0).sum(dim=(1, 2)) > 0).all()),
                  f"mesh-io [{label}]: non-finite pixels or an empty view")
            check(ids > 0.999 and frac >= 0.995, f"mesh-io [{label}]: the render differs from the plain route")
            for k in counts:
                counts[k] += run[k]
            with torch.no_grad():
                ren = tutorial_renderer(cams, device)
                ms = host_frames(lambda: ren(batch), UV_FRAMES)
                times[f"frame {label}"] = ms[len(ms) // 2]
                times[f"#1 {label}"] = device_ms(lambda: ren.rasterizer(batch), "rasterize_fine_kernel", iters=10)
            log(f"times [mesh-io frame, {label}, {card}] {UV_VIEWS} views: median {ms[len(ms) // 2]:.3f} ms (min"
                f" {ms[0]:.3f}, max {ms[-1]:.3f}); #1 {times[f'#1 {label}']:.4f} ms device time")
            del images, frags, plain, plain_frags

        src = loaded["uv"]
        colors = verts * 0.5 + 0.5
        coloured = src.replace(textures=TexturesVertex.create(colors[None], device=device))
        pio = IO()
        for label, suffix, binary, data in (("binary PLY", ".ply", True, src), ("ASCII PLY", ".ply", False, src),
                                            ("OFF with vertex colours", ".off", True, coloured),
                                            ("GLB", ".glb", True, src)):
            fpath = tmp / f"sphere_{label.split()[0].lower()}{suffix}"
            t0 = time.perf_counter()
            pio.save_mesh(data, fpath, binary=binary)
            save_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = pio.load_mesh(fpath, device=device)
            load_ms = (time.perf_counter() - t0) * 1e3
            check(m.verts_padded().device.type == "cuda", f"mesh-io [{label}]: the loaded mesh is not on the card")
            verr = float((m.verts_padded()[0] - data.verts_padded()[0]).abs().max())  # against what was saved
            faces_equal = bool(torch.equal(m.faces_padded()[0], faces))
            exact = binary and suffix != ".off"
            cerr = None
            if suffix == ".off":
                cerr = float((m.textures.verts_features_padded()[0] - colors).abs().max())
            reset_counts()
            ids, zerr, covered = _fragments_against_plain(f"mesh-io [{label}]", m.extend(IO_CHECK_VIEWS),
                                                          cams_check)
            torch.cuda.synchronize()
            run = read_counts()
            log(f"mesh-io [IO {label}]: save {save_ms:.1f} ms ({fpath.stat().st_size} bytes), load {load_ms:.1f} ms;"
                f" faces equal {faces_equal}, verts {verr:.3e} off ({'exact' if exact else f'gate {IO_VERTS_GATE:.2e}'})"
                f"{'' if cerr is None else f', colours {cerr:.3e} off'}; {IO_CHECK_VIEWS} views through #1 (launches"
                f" {run['rasterize_fine']}): ids equal to the plain route on {ids:.6f} of {covered} covered pixels,"
                f" zbuf {zerr:.3e} off")
            check(faces_equal and verr <= (0.0 if exact else IO_VERTS_GATE), f"mesh-io [{label}]: geometry off")
            check(cerr is None or cerr <= IO_VERTS_GATE, f"mesh-io [{label}]: colours off")
            check(run["rasterize_fine"] == 1 and ids > 0.999 and zerr <= 1e-6, f"mesh-io [{label}]: render off")
            for k in counts:
                counts[k] += run[k]

        t0 = time.perf_counter()
        native = fast_io.native_available()
        times["native build"] = (time.perf_counter() - t0) * 1e3
        check(native, "mesh-io: the native OBJ parser did not build or load (g++)")
        big = ico_sphere(IO_NATIVE_LEVEL, device=device)
        big_path = tmp / f"ico{IO_NATIVE_LEVEL}.obj"
        save_obj(big_path, big.verts_padded()[0], big.faces_padded()[0])
        parsed = {}
        for label in ("native", "python"):
            saved = fast_io.fast_parse_obj
            if label == "python":
                fast_io.fast_parse_obj = lambda text: None
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v, f, _ = load_obj(big_path, device=device)
                torch.cuda.synchronize()
                times[f"parse {label}"] = (time.perf_counter() - t0) * 1e3
            finally:
                fast_io.fast_parse_obj = saved
            parsed[label] = (v, f)
        # Which parser ran shows in the output: on a geometry-only file the
        # native parser gives no materials_idx, the Python scanner one of -1s.
        check(parsed["native"][1].materials_idx is None and parsed["python"][1].materials_idx is not None,
              "mesh-io: the two OBJ parses did not go through the native parser and the Python scanner")
        parsed = {k: (v, f.verts_idx) for k, (v, f) in parsed.items()}
        same = (torch.equal(parsed["native"][0], parsed["python"][0])
                and torch.equal(parsed["native"][1], parsed["python"][1]))
        verr = float((parsed["native"][0] - big.verts_padded()[0]).abs().max())
        log(f"mesh-io [OBJ parsers, ico_sphere({IO_NATIVE_LEVEL}): {tuple(parsed['native'][0].shape)} verts,"
            f" {tuple(parsed['native'][1].shape)} faces, {big_path.stat().st_size} bytes]: native library"
            f" {fast_io.library_path().relative_to(REPO)} ({times['native build']:.0f} ms to build or load), native"
            f" {times['parse native']:.1f} ms, Python scanner {times['parse python']:.1f} ms (host clock, load_obj onto"
            f" the card); equal {same}; verts {verr:.3e} off the source")
        check(same and verr <= IO_VERTS_GATE, "mesh-io: the native parser and the Python scanner disagree")
        del big, parsed

        cloud, pcams = colored_points_scene(device)
        ply = tmp / "torus_cloud.ply"
        pio.save_pointcloud(cloud, ply)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded_cloud = pio.load_pointcloud(ply, device=device)
        load_ms = (time.perf_counter() - t0) * 1e3
        pts_equal = bool(torch.equal(loaded_cloud.points_padded(), cloud.points_padded()))
        col_err = float((loaded_cloud.features_padded() - cloud.features_padded()).abs().max())
        log(f"mesh-io [IO point cloud]: {PTS_SAMPLES} points as binary PLY ({ply.stat().st_size} bytes), load"
            f" {load_ms:.1f} ms onto {loaded_cloud.points_padded().device}; points equal {pts_equal}, colours"
            f" {col_err:.3e} off (gate {IO_MAP_GATE:.3e})")
        check(loaded_cloud.points_padded().device.type == "cuda" and pts_equal and col_err <= IO_MAP_GATE,
              "mesh-io: the loaded point cloud is off")
        clouds, ref_clouds = loaded_cloud.extend(PTS_REQUESTS), cloud.extend(PTS_REQUESTS)
        compositors = {"alpha": AlphaCompositor, "norm-weighted": NormWeightedCompositor}
        renderers = {name: points_renderer(pcams, c()) for name, c in compositors.items()}
        torch.cuda.synchronize()
        reset_counts()
        with torch.no_grad():
            images = {name: r(clouds) for name, r in renderers.items()}
        torch.cuda.synchronize()
        run = read_counts()
        check(run["rasterize_points"] == len(renderers), f"mesh-io [points]: launches {run}")
        for k in counts:
            counts[k] += run[k]
        with torch.no_grad():
            frags = renderers["alpha"].rasterizer(clouds)
            ref_frags = renderers["alpha"].rasterizer(ref_clouds)
            exact = bool(torch.equal(frags.idx, ref_frags.idx)) and bool(torch.equal(frags.zbuf, ref_frags.zbuf))
            for name, r in renderers.items():
                ref = r(ref_clouds)
                err = float((images[name] - ref).abs().max())
                log(f"mesh-io [points, {name}]: {PTS_REQUESTS} requests of the loaded cloud through #5: ids and zbuf"
                    f" equal to the in-memory cloud's {exact}; |image - in-memory image| max {err:.3e} (gate"
                    f" {IO_IMAGE_GATE:.3e})")
                check(exact and err <= IO_IMAGE_GATE and bool(torch.isfinite(images[name]).all()),
                      f"mesh-io [points, {name}]: the loaded cloud renders off")
            rasterizer = renderers["alpha"].rasterizer
            times["#5 cloud"] = device_ms(lambda: rasterizer(clouds), "rasterize_points_kernel", iters=10)
            ms = host_frames(lambda: renderers["alpha"](clouds), UV_FRAMES)
            times["points frame"] = ms[len(ms) // 2]
        log(f"times [mesh-io points, {card}] {PTS_REQUESTS} requests (alpha): median {times['points frame']:.3f} ms;"
            f" #5 {times['#5 cloud']:.4f} ms device time")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    times["phase"] = _phase_ms(start)
    log(f"times [mesh-io, {card}] phase {times['phase'] / 1e3:.1f} s (CUDA events); launches {counts}")
    return {"mesh-io": counts}


def phase_implicitron_data(device, card):
    """Implicitron's frame loading on the card: `RenderedMeshDatasetMapProvider`
    built from a `get_default_args` dict with `data_file` the textured
    sphere OBJ of mesh-io, rendering its 40 views at 128^2 through #1 (2 of
    them against the plain route); its frames written as a CO3D-style tree
    (PNG images and masks, 16-bit depths from a K=1 rasterization, a jgzip
    of FrameAnnotations), rebuilt on the card by
    `GenericFrameDataBuilder(box_crop=True)` at 256^2, and a PLY of the
    scene subsampled by `load_pointcloud`, both against the same calls on
    the CPU.  The builder's image pipeline (PNG decoding, crop, resize) runs
    on the host in numpy on both sides, so its gate checks that every tensor
    lands on the card and the camera arithmetic done there, not the image
    computation; the cloud's subsampling (a sort of the scores) runs on the
    card."""
    import dataclasses
    import shutil
    import tempfile
    from typing import List

    import numpy as np
    import torch
    from PIL import Image

    from pytorch3d_tpu_torch.implicitron.dataset import GenericFrameDataBuilder, RenderedMeshDatasetMapProvider
    from pytorch3d_tpu_torch.implicitron.dataset import types as dtypes
    from pytorch3d_tpu_torch.implicitron.dataset import utils as dutils
    from pytorch3d_tpu_torch.implicitron.tools.config import get_default_args
    from pytorch3d_tpu_torch.io import load_objs_as_meshes, save_obj, save_ply
    from pytorch3d_tpu_torch.ops import sample_points_from_meshes
    from pytorch3d_tpu_torch.renderer import (
        HardPhongShader, MeshRasterizer, MeshRenderer, PointLights, RasterizationSettings, join_cameras_as_batch,
    )
    from pytorch3d_tpu_torch.utils import ico_sphere

    start = _phase_clock()
    tmp = Path(tempfile.mkdtemp(prefix="implicitron_data_"))
    try:
        mesh = ico_sphere(4, device=device)
        verts, faces = mesh.verts_padded()[0], mesh.faces_padded()[0]
        uvs, faces_uvs = sphere_uvs(verts, faces)
        obj = tmp / "sphere.obj"
        save_obj(obj, verts, faces, verts_uvs=uvs, faces_uvs=faces_uvs, texture_map=uv_map(device)[0])
        args = get_default_args(RenderedMeshDatasetMapProvider)
        args.update(data_file=str(obj), device=device)
        provider = RenderedMeshDatasetMapProvider(**args)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dataset = provider.get_dataset_map()
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        frames = dataset["train"] + dataset["test"]
        n, res = len(frames), provider.resolution
        log(f"implicitron-data [RenderedMeshDatasetMapProvider(data_file=sphere.obj), {n} views at {res}^2]: load and"
            f" render {build_ms:.1f} ms, launches {counts}; splits {[len(dataset[k]) for k in ('train', 'val', 'test')]}")
        check(n == args["num_views"] and counts["rasterize_fine"] == 1, f"implicitron-data: {n} frames, launches {counts}")
        check(frames[0].image_rgb.device.type == "cuda", "implicitron-data: the frames are not on the card")

        cams = join_cameras_as_batch([f.camera for f in frames])
        loaded = load_objs_as_meshes([obj], device=device)
        check_cams = join_cameras_as_batch([f.camera for f in frames[:DATA_CHECK_VIEWS]])
        settings = dict(image_size=res, faces_per_pixel=1)
        lights = PointLights.create(location=[[0.0, 0.0, -3.0]], device=device)
        with torch.no_grad():
            ids = MeshRasterizer(check_cams, RasterizationSettings(**settings))(
                loaded.extend(DATA_CHECK_VIEWS)).pix_to_face
            plain_ren = MeshRenderer(MeshRasterizer(check_cams, RasterizationSettings(**settings, bin_size=0)),
                                     HardPhongShader(cameras=check_cams, lights=lights, device=device))
            plain_ids = plain_ren.rasterizer(loaded.extend(DATA_CHECK_VIEWS)).pix_to_face
            plain = plain_ren(loaded.extend(DATA_CHECK_VIEWS))[..., :3]
        same = (ids == plain_ids)[..., 0]
        share = float(same.float().mean())
        got = torch.cat([f.image_rgb for f in frames[:DATA_CHECK_VIEWS]])
        rgb_err = float((got - plain).abs().amax(dim=-1)[same].max())
        log(f"implicitron-data [views 0-{DATA_CHECK_VIEWS - 1} against the plain route]: ids equal on {share:.6f} of"
            f" pixels, |rgb - plain| max {rgb_err:.3e} where they agree (gate {DATA_RGB_GATE:g})")
        check(share >= DATA_IDS_SHARE and rgb_err <= DATA_RGB_GATE, "implicitron-data: the provider's render is off")

        with torch.no_grad():
            zbuf = MeshRasterizer(cams, RasterizationSettings(**settings))(loaded.extend(n)).zbuf[..., 0]
        focal = 1.0 / math.tan(math.radians(30.0))  # FoVPerspectiveCameras' default fov of 60 degrees
        annotations = []
        for sub in ("images", "masks", "depths"):
            (tmp / "sphere_seq" / sub).mkdir(parents=True)
        for i, f in enumerate(frames):
            names = {k: f"sphere_seq/{k}/frame{i:06d}.png" for k in ("images", "masks", "depths")}
            rgb = (f.image_rgb[0].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
            Image.fromarray(rgb).save(tmp / names["images"])
            Image.fromarray((f.fg_probability[0, ..., 0] * 255).to(torch.uint8).cpu().numpy()).save(tmp / names["masks"])
            depth_mm = (zbuf[i].clamp(min=0) * 1000).round().to(torch.int32).cpu().numpy().astype(np.uint16)
            Image.fromarray(depth_mm).save(tmp / names["depths"])
            annotations.append(dtypes.FrameAnnotation(
                sequence_name="sphere_seq", frame_number=i, frame_timestamp=float(i),
                image=dtypes.ImageAnnotation(path=names["images"], size=(res, res)),
                depth=dtypes.DepthAnnotation(path=names["depths"], scale_adjustment=1e-3),
                mask=dtypes.MaskAnnotation(path=names["masks"]),
                viewpoint=dtypes.ViewpointAnnotation(
                    R=tuple(map(tuple, f.camera.R[0].tolist())), T=tuple(f.camera.T[0].tolist()),
                    focal_length=(focal, focal), principal_point=(0.0, 0.0)),
                meta={"frame_type": "train_known"},
            ))
        dtypes.dump_dataclass_jgzip(str(tmp / "frame_annotations.jgz"), annotations)
        annotations = dtypes.load_dataclass_jgzip(str(tmp / "frame_annotations.jgz"), List[dtypes.FrameAnnotation])
        kw = dict(dataset_root=str(tmp), box_crop=True, image_height=DATA_IMAGE, image_width=DATA_IMAGE)
        built = {}
        for label, dev in (("card", device), ("cpu", torch.device("cpu"))):
            builder = GenericFrameDataBuilder(device=dev, **kw)
            t0 = time.perf_counter()
            built[label] = [builder.build(a, {"sequence_name": "sphere_seq", "category": "sphere"})
                            for a in annotations]
            torch.cuda.synchronize()
            log(f"implicitron-data [GenericFrameDataBuilder(box_crop=True) at {DATA_IMAGE}^2 on {dev}]:"
                f" {len(annotations)} frames in {(time.perf_counter() - t0) * 1e3:.1f} ms")
        worst = 0.0
        for fc, fh in zip(built["card"], built["cpu"]):
            for field in dataclasses.fields(fc):
                a, b = getattr(fc, field.name), getattr(fh, field.name)
                if torch.is_tensor(a):
                    check(a.device.type == "cuda" and a.dtype == b.dtype, f"implicitron-data: {field.name} off the card")
                    worst = max(worst, float((a.cpu().double() - b.double()).abs().max()))
                elif field.name == "camera":
                    check(a.device.type == "cuda", "implicitron-data: the camera is not on the card")
                    for attr in ("R", "T", "focal_length", "principal_point"):
                        worst = max(worst, float((getattr(a, attr).cpu() - getattr(b, attr)).abs().max()))
                else:
                    check(a == b, f"implicitron-data: {field.name} {a} against {b}")
        f0 = built["card"][0]
        log(f"implicitron-data [frames on the card against device='cpu', placement and camera arithmetic; the"
            f" image pipeline runs on the host on both]: max |difference| {worst:.3e} over every"
            f" tensor and camera (gate {DATA_CPU_GATE:g}); frame 0 crop {f0.crop_bbox_xywh.tolist()}, image"
            f" {tuple(f0.image_rgb.shape)}, mask_crop mean {float(f0.mask_crop.mean()):.4f}")
        check(worst <= DATA_CPU_GATE, "implicitron-data: the builder on the card differs from the CPU")

        gen = torch.Generator(device=device).manual_seed(0)
        pts = sample_points_from_meshes(loaded, DATA_CLOUD_POINTS, generator=gen)[0]
        ply = tmp / "sphere_seq" / "pointcloud.ply"
        save_ply(ply, pts, colors=pts * 0.5 + 0.5)
        scores = torch.rand((1, DATA_CLOUD_POINTS), generator=torch.Generator().manual_seed(1))
        card_cloud = dutils.load_pointcloud(ply, DATA_CLOUD_POINTS // 2, device=device, scores=scores)
        cpu_cloud = dutils.load_pointcloud(ply, DATA_CLOUD_POINTS // 2, device="cpu", scores=scores)
        perr = max(float((card_cloud.points_padded().cpu() - cpu_cloud.points_padded()).abs().max()),
                   float((card_cloud.features_padded().cpu() - cpu_cloud.features_padded()).abs().max()))
        log(f"implicitron-data [load_pointcloud, {DATA_CLOUD_POINTS} points to {DATA_CLOUD_POINTS // 2}]:"
            f" {tuple(card_cloud.points_padded().shape)} on {card_cloud.points_padded().device}, {perr:.3e} off the CPU")
        check(card_cloud.points_padded().device.type == "cuda" and perr <= DATA_CPU_GATE,
              "implicitron-data: load_pointcloud on the card differs from the CPU")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"times [implicitron-data, {card}] provider {build_ms:.1f} ms (host clock), phase"
        f" {_phase_ms(start) / 1e3:.1f} s (CUDA events)")
    return {"implicitron-data": counts}


# Slice 18: Implicitron's GenericModel on its NeRF path, its sharded step, ModelDBIR.
# repro_base.yaml's model (projects/implicitron_trainer/configs/repro_base.yaml:19-37): 400^2, two passes of
# 64 + 64 points (the fine pass takes 128: the coarse samples are appended), harmonics 10 / 4, an 8 x 256
# trunk with the skip at 5 and a direction head of 128, 1024 rays a step drawn from the mask, scene extent 8.
IMPLICITRON_RES = 400
IMPLICITRON_MODEL = dict(
    render_image_width=IMPLICITRON_RES, render_image_height=IMPLICITRON_RES, num_passes=2, chunk_size_grid=102400,
    raysampler_args=dict(n_rays_per_image_sampled_from_mask=1024, scene_extent=8.0, n_pts_per_ray_training=64,
                         n_pts_per_ray_evaluation=64),
    renderer_args=dict(n_pts_per_ray_fine_training=64, n_pts_per_ray_fine_evaluation=64),
    implicit_function_args=dict(n_harmonic_functions_xyz=10, n_harmonic_functions_dir=4, n_hidden_neurons_xyz=256,
                                n_hidden_neurons_dir=128, n_layers_xyz=8, append_xyz=(5,)),
)
IMPLICITRON_FRAMES = 4  # served EVALUATION frames: the provider's test views
# The plain route's chunks: its layer-by-layer chain holds (rows, 256) float32 activations, 12.5 GiB each at
# chunk_size_grid's 102 400 rays x 128 fine points (it ran out of the card's 80 GB); a ray's render does not
# depend on its chunk.
IMPLICITRON_PLAIN_CHUNK = 20480
IMPLICITRON_STEPS = 20  # Adam steps of the trainer's loop
IMPLICITRON_LR = 5e-4
IMPLICITRON_SHARD_STEPS = 5
IMPLICITRON_LOSS_RTOL = 1e-4  # step 0's objective, fused against plain: the fine pass's depths move by rounding / pdf
DBIR_VIEWS = 8
DBIR_IMAGE_GATE = 1.0 / 255.0


class ImplicitronScene:
    """The provider's ico sphere at 400^2 (40 views: 36 to train on, 4 to
    serve) and repro_base's GenericModel with weights from a seed."""

    def __init__(self, device):
        from pytorch3d_tpu_torch.implicitron.dataset import RenderedMeshDatasetMapProvider

        self.device = device
        self.provider = RenderedMeshDatasetMapProvider(resolution=IMPLICITRON_RES, device=device)
        dataset = self.provider.get_dataset_map()
        self.train, self.test = dataset["train"], dataset["test"]

    def model(self, seed, cfg=IMPLICITRON_MODEL):
        import torch

        from pytorch3d_tpu_torch.implicitron.models import GenericModel

        return GenericModel(**cfg, device=self.device, generator=torch.Generator(device=self.device).manual_seed(seed))

    @staticmethod
    def batch(frame):
        return dict(image_rgb=frame.image_rgb, camera=frame.camera, fg_probability=frame.fg_probability)


def set_fused(model, fused):
    """use_fused_kernel on every MLPWithInputSkips of `model`."""
    from pytorch3d_tpu_torch.models.nerf.implicit_function import MLPWithInputSkips

    for m in model.modules():
        if isinstance(m, MLPWithInputSkips):
            m.use_fused_kernel = fused


def phase_implicitron_serving(device, scene, card):
    """IMPLICITRON_FRAMES EVALUATION frames of the full 400^2 grid, each in 2
    chunks of chunk_size_grid rays (#12's serving build: 10.24 M coarse and
    20.48 M fine rows a frame), against the same model with
    use_fused_kernel=False under nerf-serving's limits (in chunks of
    IMPLICITRON_PLAIN_CHUNK rays); the frame time and #12's launches and
    device time."""
    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

    model = scene.model(0)
    frames = scene.test[:IMPLICITRON_FRAMES]

    def render(frame):
        with torch.no_grad():
            return model(**scene.batch(frame), evaluation_mode=EvaluationMode.EVALUATION)["images_render"]

    render(frames[0])  # the first call's allocations
    torch.cuda.synchronize()
    reset_counts()
    images, frame_ms = [], []
    for f in frames:
        t0 = time.perf_counter()
        images.append(render(f))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    chunks = -(-IMPLICITRON_RES**2 // IMPLICITRON_MODEL["chunk_size_grid"])
    want = 2 * chunks * len(frames)
    log(f"implicitron-serving [GenericModel, repro_base.yaml at {IMPLICITRON_RES}^2, {len(frames)} frames in {chunks}"
        f" chunks]: launches {counts}; frame ms {[round(v, 3) for v in frame_ms]}")
    check(counts["nerf_field"] == want and counts["nerf_field_grad"] == 0,
          f"implicitron-serving: launches {counts}, expected {want} nerf_field")
    for i, img in enumerate(images):
        check(img.shape == (1, IMPLICITRON_RES, IMPLICITRON_RES, 3) and bool(torch.isfinite(img).all()),
              f"implicitron-serving: frame {i} of shape {tuple(img.shape)} or not finite")
    set_fused(model, False)
    model.chunk_size_grid = IMPLICITRON_PLAIN_CHUNK
    try:
        shares = []
        for f, img in zip(frames, images):
            diff = (img - render(f)).abs().amax(dim=-1)
            shares.append((float((diff <= NERF_FRAME_TOL).double().mean()), float(diff.max())))
    finally:
        set_fused(model, True)
        model.chunk_size_grid = IMPLICITRON_MODEL["chunk_size_grid"]
    log(f"  against use_fused_kernel=False: (share of pixels within {NERF_FRAME_TOL:g}, max) per frame"
        f" {[(round(s, 6), f'{m:.3e}') for s, m in shares]}; rgb range [{float(images[0].min()):.4f},"
        f" {float(images[0].max()):.4f}]")
    check(all(s >= NERF_FRAME_SHARE for s, _ in shares), "implicitron-serving: frames off the plain route's")
    fwd = ("fused_mlp_fwd_kernel<true, false>", "fused_mlp_fwd_prep_kernel")
    kernel = device_ms(lambda: render(frames[1]), fwd, iters=2, warmup=1, launches=2 * chunks)
    timed = sorted(frame_ms)
    log(f"times [implicitron-serving frame, {card}] median of {len(timed)}: {timed[len(timed) // 2]:.3f} ms"
        f" (min {timed[0]:.3f}, max {timed[-1]:.3f}); #12 {kernel:.3f} ms a frame (device time, profiler; "
        f"{2 * chunks} launches, {kernel / (2 * chunks):.3f} a launch)")
    profile("implicitron-serving frame", lambda: render(frames[1]), 1)
    del model
    torch.cuda.empty_cache()
    return counts


def implicitron_step0(model, batch, image, seed):
    """Step 0 of GenericModel `model` on `batch`, the fused route against
    use_fused_kernel=False with one generator seed: (the two objectives,
    {parameter: max |fused - plain| / max |plain|} of the gradients end to
    end, {"coarse", "fine": (the worst parameter, its fused-vs-plain ratio,
    [fused, plain] worst ratio against the plain route in float64, the
    points)} on each pass's bundle shared by both routes (the fused
    route's), where the pass's loss is its rgb mse against `image`, the
    model's masked target).  Leaves the model on the fused route."""
    import copy

    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode
    from pytorch3d_tpu_torch.renderer.utils import ndc_grid_sample

    fns = {"coarse": model.implicit_function_0, "fine": model.implicit_function_1}
    kept, grads, objectives = {}, [], []

    def keeper(key):
        def hook(module, args, kwargs, out):  # the fused route's bundle and inputs: the first call's
            kept.setdefault(key, (kwargs["ray_bundle"], fixed_inputs(kwargs)))

        return hook

    handles = [fn.register_forward_hook(keeper(k), with_kwargs=True) for k, fn in fns.items()]
    try:
        for fused in (True, False):
            set_fused(model, fused)
            model.zero_grad(set_to_none=True)
            preds = model(**batch, evaluation_mode=EvaluationMode.TRAINING,
                          generator=torch.Generator(device=image.device).manual_seed(seed))
            preds["objective"].backward()
            objectives.append(float(preds["objective"].detach()))
            grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    finally:
        for h in handles:
            h.remove()
    marcher = model._renderer._raymarcher

    def pass_grads(fn, b, inputs, dtype=None):
        gt = ndc_grid_sample(image.to(b.lengths.dtype).movedim(-1, 1), b.xys).movedim(1, -1)
        fn.zero_grad(set_to_none=True)
        out = marcher(*fn(ray_bundle=b, **inputs(dtype)), ray_lengths=b.lengths)
        ((out.features - gt) ** 2).mean().backward()
        return {n: p.grad.clone() for n, p in fn.named_parameters()}

    shared = {}
    for key, fn in fns.items():
        b, inputs = kept[key]
        routes = []
        for fused in (True, False):
            set_fused(model, fused)
            routes.append(pass_grads(fn, b, inputs))
        ref = copy.deepcopy(fn).double()
        set_fused(ref, False)
        exact = pass_grads(ref, b.replace(**{k: getattr(b, k).double()
                                             for k in ("origins", "directions", "lengths", "xys")}),
                           inputs, torch.float64)
        del ref
        on_shared = grad_ratios(*routes)
        worst = max(on_shared, key=on_shared.get)
        shared[key] = (worst, on_shared[worst], [max(grad_ratios(g, exact).values()) for g in routes],
                       b.lengths.numel())
    set_fused(model, True)
    model.zero_grad(set_to_none=True)
    return objectives, grad_ratios(*grads), shared


class _PoolAt32:
    """A function's fun_viewpool with the points projected in float32, as
    the cameras are; `fixed`: its features detached and cast to `dtype`
    (a pass's inputs held while its own gradients are compared)."""

    def __init__(self, pool, fixed=False, dtype=None):
        self.pool, self.fixed, self.dtype, self.per_view = pool, fixed, dtype, getattr(pool, "per_view", False)

    def __call__(self, pts):
        out = self.pool(pts.float())
        if not self.fixed:
            return out
        return out.detach() if self.dtype is None else out.detach().to(self.dtype)


def fixed_inputs(kwargs):
    """dtype -> the implicit function's inputs besides its bundle (pooled
    features, the global code, the cameras) held fixed, in `dtype` where
    given."""
    pool, code, camera = kwargs.get("fun_viewpool"), kwargs.get("global_code"), kwargs.get("camera")

    def inputs(dtype=None):
        out = {}
        if pool is not None:
            out["fun_viewpool"] = _PoolAt32(pool, fixed=True, dtype=dtype)
            out["camera"] = camera
        if code is not None:
            out["global_code"] = code.detach() if dtype is None else code.detach().to(dtype)
        return out

    return inputs


def phase_implicitron_step0(device, scene, model):
    """Step 0's objective and every parameter's gradient, the fused route
    against use_fused_kernel=False on the same draws (one generator seed;
    `implicitron_step0`).  The coarse function sees the same bundle on
    both routes; the fine one sees depths that sample_pdf draws from the
    coarse weights, so it is held end to end within NERF_FINE_GATE and,
    like the coarse one, on one bundle shared by both routes (the fused
    route's), where each pass's loss (its rgb mse) is also taken by the
    plain route in float64.  On a shared bundle: the fused route no
    further from float64 than FUSED_PLAIN_FACTOR times the plain one (or
    GRAD_GATE), and the two float32 routes within GRAD_GATE of each other
    or within the sum of their distances from float64 that the witness
    allows.  At this configuration both float32 routes sit ~4e-4 of the
    largest gradient from float64 (ReLU masks within rounding of 0 at 10
    harmonics), above GRAD_GATE, so the witness decides."""
    frame = scene.train[0]
    image = frame.image_rgb * (frame.fg_probability >= 0.5)  # the model's masked target, bg_color 0
    objectives, end_to_end, shared = implicitron_step0(model, scene.batch(frame), image, 7)
    fine_e2e = {n: v for n, v in end_to_end.items() if n.startswith("implicit_function_1")}
    worst_fine = max(fine_e2e, key=fine_e2e.get)
    loss_off = abs(objectives[0] - objectives[1]) / abs(objectives[1])
    log(f"implicitron-train: step 0 objective {objectives[0]:.8f} against the plain route's {objectives[1]:.8f}"
        f" (relative {loss_off:.3e}); gradients, worst of each tensor's max|grad|, fused against plain on the"
        f" shared bundles: " + "; ".join(
            f"{k} function ({n} points) {w} {d:.3e} (against the plain route in float64: fused {wit[0]:.3e},"
            f" plain {wit[1]:.3e})" for k, (w, d, wit, n) in shared.items())
        + f"; fine function end to end {worst_fine} {fine_e2e[worst_fine]:.3e}")
    check(all(math.isfinite(v) for v in end_to_end.values()), "implicitron-train: non-finite step 0 gradients")
    check(loss_off <= IMPLICITRON_LOSS_RTOL, "implicitron-train: step 0's objective off the plain route's")
    check(fine_e2e[worst_fine] <= NERF_FINE_GATE, "implicitron-train: step 0's fine gradients off the plain route's")
    for k, (_, d, (fused_off, plain_off), _) in shared.items():
        check(fused_off <= max(GRAD_GATE, FUSED_PLAIN_FACTOR * plain_off),
              f"implicitron-train: the fused {k} function is further from float64 than the plain route")
        check(d <= max(GRAD_GATE, (1 + FUSED_PLAIN_FACTOR) * plain_off),
              f"implicitron-train: step 0's {k} gradients off the plain route's")


def phase_implicitron_train(device, scene, card):
    """IMPLICITRON_STEPS Adam steps at lr 5e-4, one training frame a step,
    as projects/implicitron_trainer/experiment.py:228-249 steps (objective,
    backward, update): #12's saving build and #13 on 65 536 coarse and
    131 072 fine rows a step.  Step 0 against the plain route first
    (`phase_implicitron_step0`); the objective must fall."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode
    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    model = scene.model(1)
    phase_implicitron_step0(device, scene, model)
    opt = torch.optim.Adam(model.parameters(), lr=IMPLICITRON_LR)
    gen = torch.Generator(device=device).manual_seed(2)
    order = np.random.RandomState(18).permutation(len(scene.train))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    recomputed = fm._backward.forwards_run
    objectives, step_ms = [], []
    for i in range(IMPLICITRON_STEPS):
        frame = scene.train[int(order[i % len(order)])]
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        preds = model(**scene.batch(frame), evaluation_mode=EvaluationMode.TRAINING, generator=gen)
        preds["objective"].backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        objectives.append(float(preds["objective"].detach()))
    counts = read_counts()
    recomputed = fm._backward.forwards_run - recomputed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first, last = sum(objectives[:5]) / 5, sum(objectives[-5:]) / 5
    log(f"implicitron-train: {IMPLICITRON_STEPS} Adam steps of 1024 rays (64 + 128 points): objectives"
        f" {[round(v, 6) for v in objectives]}; launches {counts}; peak memory {peak_gb:.2f} GB")
    check(all(math.isfinite(v) for v in objectives), "implicitron-train: non-finite objective")
    check(last < first, f"implicitron-train: the mean of the last 5 objectives {last:.6f} is not below the first"
                        f" 5's {first:.6f}")
    check(counts["nerf_field"] == 2 * IMPLICITRON_STEPS and counts["nerf_field_grad"] == 2 * IMPLICITRON_STEPS,
          f"implicitron-train: launches {counts} for {IMPLICITRON_STEPS} steps (2 forwards and 2 backwards each)")
    check(recomputed == 0, f"implicitron-train: the backward ran {recomputed} forwards instead of the saved ones")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "implicitron-train: non-finite weights")
    timed = sorted(step_ms[2:])
    log(f"times [implicitron-train step, {card}] median of steps 3-{IMPLICITRON_STEPS}: {timed[len(timed) // 2]:.3f} ms"
        f" (min {timed[0]:.3f}, max {timed[-1]:.3f}), peak memory {peak_gb:.3f} GB; mean objective first 5"
        f" {first:.6f}, last 5 {last:.6f}")

    def steps():
        for i in range(3):
            opt.zero_grad(set_to_none=True)
            model(**scene.batch(scene.train[i]), evaluation_mode=EvaluationMode.TRAINING,
                  generator=gen)["objective"].backward()
            opt.step()

    profile("implicitron-train step", steps, 3)
    del model, opt
    torch.cuda.empty_cache()
    return counts


def implicitron_frames_numpy(scene, n):
    """The first n training frames as numpy (image, mask, R, T) for spawned
    ranks, which rebuild the cameras with the provider's defaults."""
    return [{"image_rgb": f.image_rgb.cpu().numpy(), "fg_probability": f.fg_probability.cpu().numpy(),
             "R": f.camera.R.cpu().numpy(), "T": f.camera.T.cpu().numpy()} for f in scene.train[:n]]


def implicitron_batch(frame, device):
    import torch

    from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras

    return {"image_rgb": torch.tensor(frame["image_rgb"], device=device),
            "fg_probability": torch.tensor(frame["fg_probability"], device=device),
            "camera": FoVPerspectiveCameras.create(R=torch.tensor(frame["R"], device=device),
                                                   T=torch.tensor(frame["T"], device=device), device=device)}


def implicitron_reference_steps(model, batches, world, device):
    """The sharded step taken in one process: each rank's gradient (its own
    generator, `rank_seed(step, rank)`) summed, divided by `world`, one Adam
    step; the objectives averaged alike."""
    import torch

    from pytorch3d_tpu_torch.parallel import rank_seed

    opt = torch.optim.Adam(model.parameters(), lr=IMPLICITRON_LR)
    losses = []
    for s, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for r in range(world):
            objective = model(**batch, generator=torch.Generator(device=device).manual_seed(rank_seed(s, r)))
            objective["objective"].backward()
            total = total + float(objective["objective"].detach())
        for p in model.parameters():
            p.grad.div_(world)
        opt.step()
        losses.append(total / world)
    return losses


def sharded_implicitron_rank(rank, world, state, frames):
    """One rank of the spawned group: `make_sharded_generic_train_step` on a
    (1, world) mesh for len(frames) steps (rank 0's weights; the others'
    from another seed until the step's broadcast); the losses, whether the
    ranks hold the same parameters after every step, rank 0's final state
    and the launches."""
    import torch
    import torch.distributed as dist

    from pytorch3d_tpu_torch.implicitron.models import GenericModel
    from pytorch3d_tpu_torch.parallel import get_device_mesh, make_sharded_generic_train_step

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GenericModel(**IMPLICITRON_MODEL, device=device,
                         generator=torch.Generator(device=device).manual_seed(100 + rank))
    if rank == 0:
        model.load_state_dict({k: torch.tensor(v, device=device) for k, v in state.items()})
    step = make_sharded_generic_train_step(model, torch.optim.Adam(model.parameters(), lr=IMPLICITRON_LR),
                                           get_device_mesh((1, world)))
    reset_counts()
    losses, equal, ms = [], [], []
    for s, frame in enumerate(frames):
        batch = implicitron_batch(frame, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch, s)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat)
        equal.append(all(torch.equal(parts[0].view(torch.int32), p.view(torch.int32)) for p in parts))
    counts = {k: n for k, n in read_counts().items() if k in ("nerf_field", "nerf_field_grad")}
    final = {k: t.detach().cpu().numpy() for k, t in model.state_dict().items()} if rank == 0 else None
    return {"losses": losses, "equal": equal, "ms": ms, "final": final, "counts": counts}


def _states_close(got, want):
    """(max |diff| over every tensor, the tensors outside rtol / atol)."""
    import numpy as np

    worst, failing = 0.0, []
    for k, w in want.items():
        g = got[k]
        worst = max(worst, float(np.abs(g - w).max()))
        if not np.allclose(g, w, rtol=SHARD_NERF_RTOL, atol=SHARD_NERF_ATOL):
            failing.append(k)
    return worst, failing


def phase_implicitron_sharded(device, scene, card):
    """`make_sharded_generic_train_step` for IMPLICITRON_SHARD_STEPS steps
    against the same steps taken in one process from the same weights and
    seeds (`implicitron_reference_steps`): in a world-1 NCCL group in this
    process, then on SHARD_RANKS gloo ranks spawned on the one card.  Gates:
    the losses within SHARD_NERF_LOSS_RTOL, the final parameters within
    SHARD_NERF_RTOL / SHARD_NERF_ATOL, the ranks' parameters equal to the
    bit after every step, #12 and #13 twice a step on every rank."""
    import torch
    import torch.distributed as dist

    from pytorch3d_tpu_torch.parallel import get_device_mesh, make_sharded_generic_train_step
    from torch_parallel_ranks import free_port, run_ranks

    frames = implicitron_frames_numpy(scene, IMPLICITRON_SHARD_STEPS)
    batches = [implicitron_batch(f, device) for f in frames]
    base = scene.model(3)
    state = {k: v.detach().cpu().numpy() for k, v in base.state_dict().items()}
    del base
    want_counts = {"nerf_field": 2 * IMPLICITRON_SHARD_STEPS, "nerf_field_grad": 2 * IMPLICITRON_SHARD_STEPS}
    out = {}
    for world in (1, SHARD_RANKS):
        ref = scene.model(3)
        ref_losses = implicitron_reference_steps(ref, batches, world, device)
        ref_state = {k: v.detach().cpu().numpy() for k, v in ref.state_dict().items()}
        del ref
        t0 = time.perf_counter()
        if world == 1:
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
            try:
                model = scene.model(3)
                step = make_sharded_generic_train_step(
                    model, torch.optim.Adam(model.parameters(), lr=IMPLICITRON_LR), get_device_mesh((1, 1)))
                reset_counts()
                losses = [float(step(b, s)) for s, b in enumerate(batches)]
                counts = {k: n for k, n in read_counts().items() if k in want_counts}
                outs = [{"losses": losses, "equal": [True], "final": {k: v.detach().cpu().numpy()
                                                                      for k, v in model.state_dict().items()},
                         "counts": counts}]
                del model, step
            finally:
                dist.destroy_process_group()
            label = "world-1 NCCL group"
        else:
            outs = run_ranks(sharded_implicitron_rank, world, "gloo", (state, frames))
            label = f"{world} gloo ranks on one card"
        run_s = time.perf_counter() - t0
        losses = outs[0]["losses"]
        loss_ok = all(abs(a - b) <= SHARD_NERF_LOSS_RTOL * abs(b) for a, b in zip(losses, ref_losses))
        worst, failing = _states_close(outs[0]["final"], ref_state)
        equal = all(all(o["equal"]) for o in outs) and all(o["losses"] == losses for o in outs)
        launched = all(o["counts"] == want_counts for o in outs)
        log(f"implicitron-sharded [{label}, (1, {world}) mesh, 1024 rays a rank]: losses"
            f" {[round(v, 8) for v in losses]} against one process's {[round(v, 8) for v in ref_losses]}"
            f" (rtol {SHARD_NERF_LOSS_RTOL:g}: {loss_ok}); final parameters max|diff| {worst:.3e}, tensors outside"
            f" rtol {SHARD_NERF_RTOL:g} / atol {SHARD_NERF_ATOL:g}: {failing}; ranks equal after every step"
            f" {equal}; launches per rank {[o['counts'] for o in outs]}; {run_s:.1f} s")
        if world > 1:
            step_ms = sorted(outs[0]["ms"][1:])
            log(f"times [implicitron-sharded step, {card}] median of steps 2-{IMPLICITRON_SHARD_STEPS} on rank 0"
                f" {step_ms[len(step_ms) // 2]:.3f} ms (gloo copies the gradients through the host)")
        check(loss_ok and not failing, f"implicitron-sharded: the {label} differs from the one-process steps")
        check(equal, f"implicitron-sharded: the {label}'s ranks differ")
        check(launched, f"implicitron-sharded: launches {[o['counts'] for o in outs]} in the {label}")
        out.update({f"implicitron-sharded {label} rank {r}": o["counts"] for r, o in enumerate(outs)})
    torch.cuda.empty_cache()
    return out


def phase_model_dbir(device, scene, card):
    """ModelDBIR at its defaults (256^2, 100 000 points, radius 0.01, 4 a
    pixel) on DBIR_VIEWS of the provider's 400^2 views (1.28 M unprojected
    points, a subsample of the same uniform scores on both routes), with
    #1's zbuf of the provider's mesh as their depth (-1, behind the camera,
    off the sphere): through #5 against bin_size=0 (the plain rasterizer).
    Gates: one #5 launch; ids and zbuf equal, masks and depths equal,
    images within 1/255."""
    import torch

    from pytorch3d_tpu_torch.implicitron.models import ModelDBIR
    from pytorch3d_tpu_torch.renderer import (
        MeshRasterizer, PointsRasterizationSettings, PointsRasterizer, RasterizationSettings, join_cameras_as_batch,
    )
    from pytorch3d_tpu_torch.utils import ico_sphere

    frames = scene.train[:DBIR_VIEWS]
    cams = join_cameras_as_batch([f.camera for f in frames])
    images = torch.cat([f.image_rgb for f in frames])
    mesh = ico_sphere(3, device=device).extend(DBIR_VIEWS)
    depth = MeshRasterizer(cams, RasterizationSettings(image_size=IMPLICITRON_RES, faces_per_pixel=1))(mesh).zbuf
    scores = torch.rand((1, DBIR_VIEWS * IMPLICITRON_RES**2), generator=torch.Generator(device=device).manual_seed(4),
                        device=device)
    model, plain = ModelDBIR(), ModelDBIR(bin_size=0)
    kw = dict(camera=cams, image_rgb=images, depth_map=depth, scores=scores)
    model(**kw)  # the first call's allocations
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = model(**kw)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    want = plain(**kw)
    cloud = out["point_cloud"]
    settings = dict(image_size=(model.render_image_height, model.render_image_width), radius=0.01, points_per_pixel=4)
    got_f = PointsRasterizer(cams[0], PointsRasterizationSettings(**settings))(cloud)
    want_f = PointsRasterizer(cams[0], PointsRasterizationSettings(**settings, bin_size=0))(cloud)
    ids_equal = torch.equal(got_f.idx, want_f.idx) and torch.equal(got_f.zbuf, want_f.zbuf)
    img_err = float((out["images_render"] - want["images_render"]).abs().max())
    covered = float(out["masks_render"].mean())
    log(f"model-dbir [ModelDBIR defaults, {DBIR_VIEWS} views of {IMPLICITRON_RES}^2 ->"
        f" {cloud.points_padded().shape[1]} points, {settings['image_size'][0]}^2]: launches {counts}; ids and zbuf"
        f" equal to the plain route {ids_equal}; masks equal {torch.equal(out['masks_render'], want['masks_render'])},"
        f" depths equal {torch.equal(out['depths_render'], want['depths_render'])}, images max|diff| {img_err:.3e};"
        f" covered {covered:.4f}")
    check(counts["rasterize_points"] == 1, f"model-dbir: launches {counts}, not one #5")
    check(out["images_render"].shape == (1, 256, 256, 3) and bool(torch.isfinite(out["images_render"]).all()),
          "model-dbir: render of the wrong shape or not finite")
    check(ids_equal and torch.equal(out["masks_render"], want["masks_render"])
          and torch.equal(out["depths_render"], want["depths_render"]) and img_err <= DBIR_IMAGE_GATE,
          "model-dbir: the render is off the plain route's")
    check(0.01 < covered < 0.99, f"model-dbir: {covered:.4f} of the pixels covered")
    kernel = device_ms(lambda: model(**kw), "rasterize_points_kernel", iters=5, warmup=1)
    log(f"times [model-dbir call, {card}] {call_ms:.3f} ms (host clock: unprojection, subsample, #5, compositing);"
        f" #5 {kernel:.4f} ms (device time, profiler)")
    return counts


# Slice 19: #10-#13 at the view-conditioned NeRF's input widths (repro_singleseq_nerf_wce: 63 harmonic features +
# 264 pooled = 327; repro_multiseq_nerf_wce: 63 + a 256-wide code + 136 pooled = 455) and at 512, past the 256 of
# one column tile; the trunk and head at repro_base's widths.
WIDE_INPUTS = (327, 455, 512)
WIDE_ROWS = 131_072
WIDE_MODEL = dict(H=256, L=8, skips=(5,), Ddir=27, Hh=128)


def fused_wide_inputs(device, N, D, H, L, skips, Ddir=0, Hh=0, seed=0):
    """Seeded xavier-uniform weights, small random biases and inputs in
    [-1, 1] (the range of harmonic embeddings and of the pooled, l2-normed
    features); with Ddir, the 9 head tensors too: (x, d_embed, weights,
    biases, head)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(i, o):
        lim = (6.0 / (i + o)) ** 0.5
        return (torch.rand((i, o), generator=gen, device=device) * 2 - 1) * lim, \
            torch.randn((o,), generator=gen, device=device) * 0.05

    x = torch.rand((N, D), generator=gen, device=device) * 2 - 1
    ws, bs = zip(*[dense((D if li == 0 else H) + (D if li in skips else 0), H) for li in range(L)])
    if not Ddir:
        return x, None, list(ws), list(bs), None
    de = torch.rand((N, Ddir), generator=gen, device=device) * 2 - 1
    wd, bd = dense(H, 1)
    wi, bi = dense(H, H)
    wc1, bc1 = dense(H + Ddir, Hh)
    wc2, bc2 = dense(Hh, 3)
    return x, de, list(ws), list(bs), (wd, bd, wi, bi, wc1[:H].contiguous(), wc1[H:].contiguous(), bc1, wc2, bc2)


def phase_fused_wide(device, card):
    """#10-#13 at input widths past one 256-column tile (WIDE_INPUTS, N =
    WIDE_ROWS, WIDE_MODEL's trunk and head): each against its plain version
    under compare_fused's rules (the saving forward's masks, the mask-flip
    rule against float64), every call a launch of the kernel (none takes
    the plain route), two backward calls equal to the bit; device times
    beside the bound, the plain version's and the torch.addmm chain's.
    Past `input_limit` (D 513 beside Ddir 256) every wrapper raises before
    it launches.  Returns ({kernel: largest error}, {D: times})."""
    import torch

    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    m = WIDE_MODEL
    flag = {False: "false", True: "true"}
    errors = dict.fromkeys(("fused_mlp", "fused_mlp_grad", "nerf_field", "nerf_field_grad"), 0.0)
    failed, times = [], {}
    for D in WIDE_INPUTS:
        for head_on in (False, True):
            Ddir, Hh = (m["Ddir"], m["Hh"]) if head_on else (0, 0)
            x, de, ws, bs, head = fused_wide_inputs(device, WIDE_ROWS, D, m["H"], m["L"], m["skips"], Ddir, Hh,
                                                    seed=D)
            g = torch.randn((WIDE_ROWS, 4 if head_on else m["H"]), device=device,
                            generator=torch.Generator(device=device).manual_seed(D + 1))
            fwd_w, bwd_w = (fm.nerf_field_cuda, fm.nerf_field_grad_cuda) if head_on else (fm.fused_mlp_cuda,
                                                                                        fm.fused_mlp_grad_cuda)
            before = (fwd_w.launches, bwd_w.launches)
            result = compare_fused(x, de, ws, bs, head, m["skips"], g)
            launched = (fwd_w.launches - before[0], bwd_w.launches - before[1])
            name = "nerf_field" if head_on else "fused_mlp"
            if not fused_report(f"{name} + grad, D={D} N={WIDE_ROWS} H={m['H']} L={m['L']} Ddir={Ddir} Hh={Hh}",
                                result) or launched != (2, 1):
                failed.append(f"{name} D={D}")
            repeats = fused_backward_repeats(x, de, ws, bs, head, m["skips"], g)
            log(f"  launches {launched} (2 forwards, 1 backward: none on the plain route); two backward launches"
                f" on the same saved tensors: {'equal bits' if repeats else 'DIFFERENT bits'}")
            if not repeats:
                failed.append(f"{name} D={D} repeat")
            errors[name] = max(errors[name], result["fwd_diff"])
            errors[f"{name}_grad"] = max(errors[f"{name}_grad"], result["worst"])
            fwd = ((lambda: fm.nerf_field_cuda(x, de, ws, bs, head, m["skips"])) if head_on
                   else (lambda: fm.fused_mlp_cuda(x, ws, bs, m["skips"])))
            saved = ((fm.nerf_field_cuda(x, de, ws, bs, head, m["skips"], save=True)) if head_on
                     else fm.fused_mlp_cuda(x, ws, bs, m["skips"], save=True))
            bwd = ((lambda: fm.nerf_field_grad_cuda(x, de, ws, bs, head, m["skips"], g, saved=saved)) if head_on
                   else (lambda: fm.fused_mlp_grad_cuda(x, ws, bs, m["skips"], g, saved=saved)))
            kernel_f = device_ms(fwd, (f"fused_mlp_fwd_kernel<{flag[head_on]}, false>", "fused_mlp_fwd_prep_kernel"),
                                 iters=5, warmup=1)
            kernel_b = sum(device_ms_by_kernel(bwd, ("fused_mlp_bwd_prep_kernel",
                                                     f"fused_mlp_bwd_rows_kernel<{flag[head_on]},",
                                                     "fused_mlp_bwd_weights_kernel", "fused_mlp_bwd_reduce_kernel"),
                                               3, 1).values())
            with torch.no_grad():
                plain_f = cuda_ms((lambda: fm.fused_nerf_field_plain(x, de, ws, bs, head, m["skips"])) if head_on
                                  else (lambda: fm.fused_mlp_plain(x, ws, bs, m["skips"])), 3, 1)
                lib_f = cuda_ms(lambda: addmm_chain(x, ws, bs, m["skips"], de, head), 3, 1)
            plain_b = cuda_ms((lambda: fm.fused_nerf_field_grad_plain(x, de, ws, bs, head, m["skips"], g)) if head_on
                              else (lambda: fm.fused_mlp_grad_plain(x, ws, bs, m["skips"], g)), 3, 1)
            params = [t.detach().requires_grad_(True) for t in (*ws, *bs, *(head or ()))]
            L = m["L"]
            xr = x.detach().requires_grad_(True)
            out = addmm_chain(xr, params[:L], params[L : 2 * L], m["skips"], de, params[2 * L :] or None)
            lib_b = cuda_ms(lambda: torch.autograd.grad(out, [xr, *params], g, retain_graph=True), 3, 1)
            bound_f, by_f, ops_f = mlp_bound(WIDE_ROWS, D, m["H"], L, m["skips"], Ddir, Hh)
            bound_b, by_b, _ = mlp_bound(WIDE_ROWS, D, m["H"], L, m["skips"], Ddir, Hh, backward=True)
            log(f"times [{name}, D={D}, {card}] N={WIDE_ROWS}: {mlp_macs_per_row(D, m['H'], L, m['skips'], Ddir, Hh)}"
                f" multiply-adds a row; forward {kernel_f:.4f} ms (device time, profiler), plain {plain_f:.4f} ms,"
                f" library (torch.addmm chain) {lib_f:.4f} ms, bound {bound_f:.4f} ms by {by_f}"
                f" ({ops_f / kernel_f / 1e9:.2f} TFLOP/s, {bound_f / kernel_f:.3f} of the bound); backward"
                f" {kernel_b:.4f} ms (device time), plain {plain_b:.4f} ms, library (autograd of the addmm chain)"
                f" {lib_b:.4f} ms, bound {bound_b:.4f} ms by {by_b}")
            times[(name, D)] = dict(fwd=kernel_f, bwd=kernel_b, plain_f=plain_f, plain_b=plain_b, lib_f=lib_f,
                                    lib_b=lib_b, bound_f=bound_f, bound_b=bound_b)
            del x, de, g, saved, out, params, xr, result
            torch.cuda.empty_cache()
    # one past the limit: D 513 beside a 256-wide d_embed (limit 328) refused before any launch
    D = fm.input_limit(WIDE_MODEL["H"], 256) + 1
    x, de, ws, bs, head = fused_wide_inputs(device, 256, max(D, 513), m["H"], 2, (1,), 256, 64)
    g4 = torch.zeros((256, 4), device=device)
    before = read_counts()
    refused = 0
    for call in (lambda: fm.nerf_field_cuda(x, de, ws, bs, head, (1,)),
                 lambda: fm.nerf_field_grad_cuda(x, de, ws, bs, head, (1,), g4),
                 lambda: fm.fused_nerf_field(x, de, ws, bs, head, (1,))):
        try:
            call()
        except ValueError:
            refused += 1
    xt, _, wt, bt, _ = fused_wide_inputs(device, 256, fm.input_limit(m["H"]) + 1, m["H"], 2, (1,))
    for call in (lambda: fm.fused_mlp_cuda(xt, wt, bt, (1,)),
                 lambda: fm.fused_mlp_grad_cuda(xt, wt, bt, (1,), torch.zeros((256, m["H"]), device=device))):
        try:
            call()
        except ValueError:
            refused += 1
    log(f"fused-wide: past the shared-memory limit (D {x.shape[1]} beside Ddir 256, limit"
        f" {fm.input_limit(m['H'], 256)}; the trunk at D {xt.shape[1]}, limit {fm.input_limit(m['H'])}):"
        f" {refused} of 5 calls refused, launches {read_counts() == before and 'unchanged' or 'CHANGED'}")
    check(refused == 5 and read_counts() == before, "fused-wide: a wrapper took an input past its limit")
    check(not failed, f"fused-wide: kernels disagree with their plain versions: {failed}")
    return errors, times


# Slice 19: Implicitron's view-pooled models at the repro configs' widths on the provider's sphere at 400^2
# (CO3D is not in the repository).  A batch is 10 frames of the one sequence, which are also the source views
# (upstream PyTorch3D's repro_base.yaml batch; the JAX copy of that file leaves it out); a served request renders
# one test camera from 10 source views (`source_views`).
VIEWS_PER_BATCH = 10
# Served frames and training steps are cut so that these phases add ~90 s (a view-pooled 400^2 frame takes
# ~5.9 s, most of it the pooling's gathers); the widths are the configs'.
WCE_FRAMES = 1  # timed served frames after the plain route's
WCE_STEPS = 6
NERFORMER_STEPS = 6
NERFORMER_IMAGES = 5  # a step of 10 x 800 rays ran out of the card's 80 GB: the batch halved, not the widths
FLYAROUND_POSES = 2
# repro_multiseq_nerf_wce.yaml (its base repro_multiseq_base.yaml and repro_base.yaml): D = 63 + 256 + 136 = 455
WCE_MULTISEQ = dict(
    IMPLICITRON_MODEL, chunk_size_grid=16000, view_pooler_enabled=True,
    view_pooler_args=dict(feature_aggregator_class_type="AngleWeightedReductionFeatureAggregator"),
    image_feature_extractor_args=dict(stages=(1, 2, 3, 4), proj_dim=16),
    global_encoder_class_type="SequenceAutodecoder", global_encoder_args=dict(encoding_dim=256, n_instances=1500),
)
# repro_singleseq_nerf_wce.yaml = repro_singleseq_base + repro_feat_extractor_normed + repro_singleseq_nerf:
# D = 63 + (4 x 32 + 1 + 3) x 2 = 327
WCE_SINGLESEQ = dict(
    IMPLICITRON_MODEL, view_pooler_enabled=True,
    image_feature_extractor_args=dict(arch="resnet34", pretrained=True, stages=(1, 2, 3, 4), normalize_image=True,
                                      image_rescale=0.375, first_max_pool=True, l2_norm=True, proj_dim=32,
                                      add_images=True, add_masks=True),
)
# repro_singleseq_nerformer.yaml: 800 rays, 32 + 16 points, an 80-wide transformer of 2 layers (the skip at 1,
# the width halved each layer, 4 heads), angle-weighted identity pooling kept per view, proj_dim 16
NERFORMER_MODEL = dict(
    IMPLICITRON_MODEL, chunk_size_grid=16000,
    raysampler_args=dict(IMPLICITRON_MODEL["raysampler_args"], n_rays_per_image_sampled_from_mask=800,
                         n_pts_per_ray_training=32, n_pts_per_ray_evaluation=32),
    renderer_args=dict(n_pts_per_ray_fine_training=16, n_pts_per_ray_fine_evaluation=16),
    implicit_function_class_type="NeRFormerImplicitFunction",
    implicit_function_args=dict(IMPLICITRON_MODEL["implicit_function_args"], n_hidden_neurons_xyz=80, n_layers_xyz=2,
                                append_xyz=(1,)),
    view_pooler_enabled=True,
    view_pooler_args=dict(feature_aggregator_class_type="AngleWeightedIdentityFeatureAggregator"),
    image_feature_extractor_args=dict(stages=(1, 2, 3, 4), proj_dim=16),
)
NERFORMER_LOSS_RTOL = 1e-5  # step 0's two pass losses, float32 against float64
# Every gradient, float32 against float64 on the float32 extractor's ReLU masks and max-pool picks (full widths on
# the CPU: 0.8-5e-4 over 3 seeds; on the card 6e-5); against float64 on its own choices, within this or
# FUSED_PLAIN_FACTOR times what the flipped choices alone move (one float32 forward flipped a tie that moved
# layer3's weight gradients 5.65e-3, the same with cuDNN off or on)
NERFORMER_GRAD_GATE = 5e-3
GRAD_FLOOR = 1e-3  # a tensor's gradient is held against at least this share of the model's largest gradient
WITNESS_IMAGES = 2  # images of a float64 witness chunk (the gradient is a sum over rays)


def frames_batch(frames):
    """The FrameData list as one batch: images, masks and joined cameras."""
    import torch

    from pytorch3d_tpu_torch.renderer.camera_utils import join_cameras_as_batch

    return dict(image_rgb=torch.cat([f.image_rgb for f in frames]),
                fg_probability=torch.cat([f.fg_probability for f in frames]),
                camera=join_cameras_as_batch([f.camera for f in frames]))


def source_frames(scene):
    """VIEWS_PER_BATCH training frames spread around the ring."""
    import numpy as np

    idx = np.linspace(0, len(scene.train) - 1, VIEWS_PER_BATCH).round().astype(int)
    return [scene.train[int(i)] for i in idx]


def grad_ratios_floored(a, b, floor=GRAD_FLOOR):
    """{name: max |a - b| / max(max |b|, floor x the largest |b| of all)}:
    a tensor whose gradient is zero up to rounding (attention's key bias:
    the softmax ignores a shift common to every key) against its
    neighbours' scale."""
    top = max(float(v.abs().max()) for v in b.values())
    return {n: float((a[n].double() - b[n].double()).abs().max()) / max(float(b[n].abs().max()), floor * top, 1e-300)
            for n in b}


def phase_wce_serving(device, card):
    """repro_multiseq_nerf_wce at full size: the provider's 40 views at
    400^2 rendered through #1 (in this path's count), then served requests
    of one test camera from 10 source views, 400^2 in 10 chunks of 16 000
    rays, 64 + 64 points: #12's serving build at D = 455, 10.24 M coarse and
    20.48 M fine rows a frame.  The frame against use_fused_kernel=False on
    the card under nerf-serving's limits; frame time, #12's launches,
    device time and bound.  Returns (counts, scene, model)."""
    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts()
    t0 = time.perf_counter()
    scene = ImplicitronScene(device)
    build_ms = (time.perf_counter() - t0) * 1e3
    model = scene.model(19, WCE_MULTISEQ)
    D = model.implicit_function_0.xyz_encoder.layer0.kernel.shape[0]
    check(D == 455, f"implicitron-wce-serving: the trunk's input is {D} wide, not 455")
    source = frames_batch(source_frames(scene))

    def request(frame):
        with torch.no_grad():
            return model(camera=frame.camera, sequence_name=[frame.sequence_name], source_views=source,
                         evaluation_mode=EvaluationMode.EVALUATION)["images_render"]

    frames = scene.test[:WCE_FRAMES]
    set_fused(model, False)
    try:
        plain = request(frames[0])  # the reference, and the first call's allocations
    finally:
        set_fused(model, True)
    torch.cuda.synchronize()
    images, frame_ms = [], []
    for f in frames:
        t0 = time.perf_counter()
        images.append(request(f))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    chunks = -(-IMPLICITRON_RES**2 // WCE_MULTISEQ["chunk_size_grid"])
    want = 2 * chunks * len(frames)
    log(f"implicitron-wce-serving [repro_multiseq_nerf_wce at {IMPLICITRON_RES}^2, D={D}, {VIEWS_PER_BATCH} source"
        f" views, {len(frames)} frames after the plain route's in {chunks} chunks]: launches {counts}; provider"
        f" {build_ms:.1f} ms; frame ms {[round(v, 3) for v in frame_ms]}")
    check(counts["nerf_field"] == want and counts["nerf_field_grad"] == 0 and counts["rasterize_fine"] > 0,
          f"implicitron-wce-serving: launches {counts}, expected {want} nerf_field and the provider's #1")
    for i, img in enumerate(images):
        check(img.shape == (1, IMPLICITRON_RES, IMPLICITRON_RES, 3) and bool(torch.isfinite(img).all()),
              f"implicitron-wce-serving: frame {i} of shape {tuple(img.shape)} or not finite")
    diff = (images[0] - plain).abs().amax(dim=-1)
    share = float((diff <= NERF_FRAME_TOL).double().mean())
    log(f"  against use_fused_kernel=False: share of pixels within {NERF_FRAME_TOL:g} {share:.6f}, max"
        f" {float(diff.max()):.3e}; rgb range [{float(images[0].min()):.4f}, {float(images[0].max()):.4f}]")
    check(share >= NERF_FRAME_SHARE, "implicitron-wce-serving: the frame is off the plain route's")
    rows_ms = profile("implicitron-wce-serving frame", lambda: request(frames[-1]), 1)
    fwd = [v for k, v in rows_ms.items() if "fused_mlp_fwd_kernel<true, false>" in k or "fused_mlp_fwd_prep" in k]
    check(all(n == 2 * chunks for _, n in fwd) and len(fwd) == 2,
          f"implicitron-wce-serving: the profile recorded {fwd} #12 launches, not {2 * chunks} of each")
    kernel = sum(ms for ms, _ in fwd)
    m = WIDE_MODEL
    rows = IMPLICITRON_RES**2 * WCE_MULTISEQ["raysampler_args"]["n_pts_per_ray_evaluation"]
    bound = sum(mlp_bound(n, D, m["H"], m["L"], m["skips"], m["Ddir"], m["Hh"])[0] for n in (rows, 2 * rows))
    timed = sorted(frame_ms)
    log(f"times [implicitron-wce-serving frame, {card}] median of {len(timed)}: {timed[len(timed) // 2]:.3f} ms (min"
        f" {timed[0]:.3f}, max {timed[-1]:.3f}); #12 {kernel:.3f} ms a frame (device time, profiler; {2 * chunks}"
        f" launches, {kernel / (2 * chunks):.3f} a launch), bound {bound:.3f} ms by operations"
        f" ({bound / kernel:.3f} of it)")
    return counts, scene, model


def phase_wce_train(device, scene, card):
    """repro_singleseq_nerf_wce at full size (D = 327): batches of 10
    frames, 1024 rays an image, 64 + 128 points (655 360 coarse and
    1 310 720 fine rows a step through #12's saving build and #13).  Step 0
    against the plain route on the same drawn rays through
    `implicitron_step0`'s float64 witness: the objective, every gradient
    end to end (the fine function's and the ResNet's within
    NERF_FINE_GATE: both take the fine pass, whose depths move with the
    coarse weights' last bits), each pass on its shared bundle; then
    WCE_STEPS Adam steps at lr 5e-4 whose objective must fall."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode
    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    model = scene.model(20, WCE_SINGLESEQ)
    D = model.implicit_function_0.xyz_encoder.layer0.kernel.shape[0]
    check(D == 327, f"implicitron-wce-train: the trunk's input is {D} wide, not 327")
    order = np.random.RandomState(19).permutation(len(scene.train))
    batches = [frames_batch([scene.train[int(i)] for i in np.roll(order, -VIEWS_PER_BATCH * k)[:VIEWS_PER_BATCH]])
               for k in range(3)]
    b0 = batches[0]
    image = b0["image_rgb"] * (b0["fg_probability"] >= 0.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    objectives, end_to_end, shared = implicitron_step0(model, b0, image, 7)
    step0_s = time.perf_counter() - t0
    loss_off = abs(objectives[0] - objectives[1]) / abs(objectives[1])
    late = {n: v for n, v in end_to_end.items()
            if n.startswith(("implicit_function_1", "_image_feature_extractor"))}
    worst_late = max(late, key=late.get)
    log(f"implicitron-wce-train [repro_singleseq_nerf_wce, D={D}, {VIEWS_PER_BATCH} images x 1024 rays]: step 0"
        f" objective {objectives[0]:.8f} against the plain route's {objectives[1]:.8f} (relative {loss_off:.3e});"
        f" gradients fused against plain on the shared bundles: " + "; ".join(
            f"{k} function ({n} points) {w} {d:.3e} (against the plain route in float64: fused {wit[0]:.3e},"
            f" plain {wit[1]:.3e})" for k, (w, d, wit, n) in shared.items())
        + f"; end to end, the fine function's and the ResNet's worst {worst_late} {late[worst_late]:.3e}, the"
        f" coarse function's worst {max(v for n, v in end_to_end.items() if n.startswith('implicit_function_0')):.3e};"
        f" {step0_s:.1f} s, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(all(math.isfinite(v) for v in end_to_end.values()), "implicitron-wce-train: non-finite step 0 gradients")
    check(loss_off <= IMPLICITRON_LOSS_RTOL, "implicitron-wce-train: step 0's objective off the plain route's")
    check(late[worst_late] <= NERF_FINE_GATE,
          "implicitron-wce-train: step 0's fine-function or ResNet gradients off the plain route's")
    for k, (_, d, (fused_off, plain_off), _) in shared.items():
        check(fused_off <= max(GRAD_GATE, FUSED_PLAIN_FACTOR * plain_off),
              f"implicitron-wce-train: the fused {k} function is further from float64 than the plain route")
        check(d <= max(GRAD_GATE, (1 + FUSED_PLAIN_FACTOR) * plain_off),
              f"implicitron-wce-train: step 0's {k} gradients off the plain route's")
    opt = torch.optim.Adam(model.parameters(), lr=IMPLICITRON_LR)
    gen = torch.Generator(device=device).manual_seed(21)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    recomputed = fm._backward.forwards_run
    objectives, step_ms = [], []
    for i in range(WCE_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        preds = model(**batches[i % len(batches)], evaluation_mode=EvaluationMode.TRAINING, generator=gen)
        preds["objective"].backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        objectives.append(float(preds["objective"].detach()))
    counts = read_counts()
    recomputed = fm._backward.forwards_run - recomputed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first, last = sum(objectives[:3]) / 3, sum(objectives[-3:]) / 3
    log(f"implicitron-wce-train: {WCE_STEPS} Adam steps: objectives {[round(v, 6) for v in objectives]}; launches"
        f" {counts}; peak memory {peak_gb:.2f} GB")
    check(all(math.isfinite(v) for v in objectives), "implicitron-wce-train: non-finite objective")
    check(last < first, f"implicitron-wce-train: the mean of the last 3 objectives {last:.6f} is not below the"
                        f" first 3's {first:.6f}")
    check(counts["nerf_field"] == 2 * WCE_STEPS and counts["nerf_field_grad"] == 2 * WCE_STEPS,
          f"implicitron-wce-train: launches {counts} for {WCE_STEPS} steps (2 forwards and 2 backwards each)")
    check(recomputed == 0, f"implicitron-wce-train: the backward ran {recomputed} forwards instead of the saved ones")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "implicitron-wce-train: non-finite weights")
    timed = sorted(step_ms[2:])
    log(f"times [implicitron-wce-train step, {card}] median of steps 3-{WCE_STEPS}: {timed[len(timed) // 2]:.3f} ms"
        f" (min {timed[0]:.3f}, max {timed[-1]:.3f}), peak memory {peak_gb:.3f} GB; mean objective first 3"
        f" {first:.6f}, last 3 {last:.6f}")

    def step():
        opt.zero_grad(set_to_none=True)
        model(**batches[0], evaluation_mode=EvaluationMode.TRAINING, generator=gen)["objective"].backward()
        opt.step()

    profile("implicitron-wce-train step", step, 1)
    del model, opt
    torch.cuda.empty_cache()
    return counts


class _Decisions:
    """The feature extractor's discrete choices, its ReLU masks and max-pool
    picks, recorded in one pass and replayed in another: float64 on the
    float32 forward's choices, the rule compare_fused holds #11 / #13 by.
    A float32 forward on one side of a near tie routes a gradient that
    float64 routes elsewhere; `flips` counts the choices that differ."""

    def __init__(self):
        self.masks, self.picks, self.flips = [], [], 0

    def around(self, replay):
        import contextlib

        import torch
        import torch.nn.functional as F

        relu, pool = torch.relu, F.max_pool2d
        at = {"relu": 0, "pool": 0}

        def relu_(x):
            if not replay:
                self.masks.append(x.detach() > 0)
                return relu(x)
            m = self.masks[at["relu"]]
            at["relu"] += 1
            self.flips += int((m != (x.detach() > 0)).sum())
            return x * m.to(x.dtype)

        def pool_(x, kernel_size, stride=None, padding=0):
            out, idx = pool(x, kernel_size, stride=stride, padding=padding, return_indices=True)
            if not replay:
                self.picks.append(idx)
                return out
            pick = self.picks[at["pool"]]
            at["pool"] += 1
            self.flips += int((pick != idx).sum())
            return x.flatten(2).gather(2, pick.flatten(2)).view_as(out)

        @contextlib.contextmanager
        def patched():
            torch.relu, F.max_pool2d = relu_, pool_
            try:
                yield
            finally:
                torch.relu, F.max_pool2d = relu, pool

        return patched()


def pooled_witness(model, batch, image, seed):
    """Step 0 of a view-pooled GenericModel held against itself in float64:
    the float32 step on `batch` (generator seed) keeps each pass's bundle;
    then, for the extractor and the implicit functions in float32 and for
    float64 copies of them (twice: on the float32 extractor's ReLU masks and
    max-pool picks, `_Decisions`, and on their own), the passes' rgb mse
    against `image` (the model's masked target) on those bundles,
    WITNESS_IMAGES images at a time (the points projected in float32, as the
    cameras are), gradients summed.  All run cuDNN's deterministic
    algorithms without TF32 (`cudnn.flags` turns TF32 on unless told not
    to).  Returns (the step's objective, the witness losses (float32,
    float64), and {parameter: ratio, floored} for float32 against float64 on
    float32's choices, float32 against float64 on its own, and float64 on
    float32's choices against float64 on its own (what the flips alone
    move), and the number of flipped choices)."""
    import copy

    import torch

    from pytorch3d_tpu_torch.implicitron.models.generic_model import _ViewPool
    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode
    from pytorch3d_tpu_torch.renderer.utils import ndc_grid_sample

    fns = {"coarse": model.implicit_function_0, "fine": model.implicit_function_1}
    kept, seen = {}, {}

    def keeper(key):
        def hook(module, args, kwargs, out):
            kept.setdefault(key, kwargs["ray_bundle"])

        return hook

    def extractor_inputs(module, args, kwargs, out):
        seen.setdefault("inputs", (args[0].detach(), kwargs["masks"].detach()))

    ext = model._image_feature_extractor
    handles = [fn.register_forward_hook(keeper(k), with_kwargs=True) for k, fn in fns.items()]
    handles.append(ext.register_forward_hook(extractor_inputs, with_kwargs=True))
    try:
        model.zero_grad(set_to_none=True)
        preds = model(**batch, evaluation_mode=EvaluationMode.TRAINING,
                      generator=torch.Generator(device=image.device).manual_seed(seed))
        preds["objective"].backward()
        objective = float(preds["objective"].detach())
        del preds
    finally:
        for h in handles:
            h.remove()
    img, masks = seen["inputs"]
    marcher = model._renderer._raymarcher
    per_view = model._needs_per_view()
    decisions = _Decisions()
    losses, grads = [], []
    for dtype, replay in ((torch.float32, False), (torch.float64, True), (torch.float64, None)):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            ext_d = ext if dtype == torch.float32 else copy.deepcopy(ext).double()
            fns_d = {k: fn if dtype == torch.float32 else copy.deepcopy(fn).double() for k, fn in fns.items()}
            for mod in (ext_d, *fns_d.values()):
                mod.zero_grad(set_to_none=True)
            if replay is None:
                feats = ext_d(img.to(dtype), masks=masks.to(dtype))
            else:
                with decisions.around(replay):
                    feats = ext_d(img.to(dtype), masks=masks.to(dtype))
            pool = _PoolAt32(_ViewPool(model._view_pooler, feats, batch["camera"], per_view))
            total = 0.0
            for key, fn in fns_d.items():
                b = kept[key]
                B, count = b.origins.shape[0], b.xys[..., 0].numel() * 3
                for i0 in range(0, B, WITNESS_IMAGES):
                    sub = b.replace(**{k: getattr(b, k)[i0 : i0 + WITNESS_IMAGES].to(dtype)
                                       for k in ("origins", "directions", "lengths", "xys")})
                    target = image[i0 : i0 + WITNESS_IMAGES].to(dtype).movedim(-1, 1)
                    gt = ndc_grid_sample(target, sub.xys).movedim(1, -1)
                    out = marcher(*fn(ray_bundle=sub, fun_viewpool=pool, camera=batch["camera"]),
                                  ray_lengths=sub.lengths)
                    loss = ((out.features - gt) ** 2).sum() / count
                    loss.backward(retain_graph=True)
                    total += float(loss.detach())
            losses.append(total)
            named = {f"_image_feature_extractor.{n}": p.grad for n, p in ext_d.named_parameters()}
            for i, (key, fn) in enumerate(fns_d.items()):
                named.update({f"implicit_function_{i}.{n}": p.grad for n, p in fn.named_parameters()})
            grads.append({n: g.detach().clone() for n, g in named.items()})
        del feats, pool, ext_d, fns_d
        torch.cuda.empty_cache()
    model.zero_grad(set_to_none=True)
    g32, g64_choices, g64 = grads
    return (objective, (losses[0], losses[2]), grad_ratios_floored(g32, g64_choices), grad_ratios_floored(g32, g64),
            grad_ratios_floored(g64_choices, g64), decisions.flips)


def phase_nerformer(device, scene, card):
    """repro_singleseq_nerformer at full size: one served request (400^2 in
    10 chunks of 16 000 rays, 32 + 16 points, from 10 source views, their
    features kept per view), step 0 held against the same model in float64
    (`pooled_witness`: the two pass losses within NERFORMER_LOSS_RTOL, every
    gradient, the ResNet's included, within NERFORMER_GRAD_GATE), then
    NERFORMER_STEPS Adam steps at lr 5e-4 on batches of NERFORMER_IMAGES
    images x 800 rays (the source views too) whose objective must fall.
    NeRFormer runs no kernel: its trunk is plain PyTorch, as it is XLA code
    in JAX."""
    import numpy as np
    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

    model = scene.model(22, NERFORMER_MODEL)
    source = frames_batch(source_frames(scene))
    frame = scene.test[0]
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        img = model(camera=frame.camera, source_views=source,
                    evaluation_mode=EvaluationMode.EVALUATION)["images_render"]
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    serve_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"nerformer [repro_singleseq_nerformer at {IMPLICITRON_RES}^2, 80 hidden, 2 layers, factor 2, 4 heads,"
        f" {VIEWS_PER_BATCH} source views]: frame {frame_ms:.3f} ms (with its allocations); peak memory"
        f" {serve_gb:.2f} GB; rgb range [{float(img.min()):.4f}, {float(img.max()):.4f}]")
    check(img.shape == (1, IMPLICITRON_RES, IMPLICITRON_RES, 3) and bool(torch.isfinite(img).all()),
          f"nerformer: the frame of shape {tuple(img.shape)} or not finite")
    order = np.random.RandomState(20).permutation(len(scene.train))
    batches = [frames_batch([scene.train[int(i)] for i in np.roll(order, -NERFORMER_IMAGES * k)[:NERFORMER_IMAGES]])
               for k in range(3)]
    b0 = batches[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    objective, (loss32, loss64), ratios, own, flipped, flips = pooled_witness(
        model, b0, b0["image_rgb"] * (b0["fg_probability"] >= 0.5), 8)
    loss_off = abs(loss32 - loss64) / abs(loss64)
    worst = max(ratios, key=ratios.get)
    worst_ext = max((n for n in ratios if n.startswith("_image_feature_extractor")), key=ratios.get)
    allowed = {n: max(NERFORMER_GRAD_GATE, FUSED_PLAIN_FACTOR * flipped[n]) for n in own}
    worst_own = max(own, key=lambda n: own[n] / allowed[n])
    log(f"nerformer: step 0 objective {objective:.8f}; the witness's pass losses float32 {loss32:.10f}, float64"
        f" {loss64:.10f} (relative {loss_off:.3e}); gradients float32 against float64 (floored at {GRAD_FLOOR:g} of"
        f" the largest; cuDNN deterministic, no TF32) on the float32 extractor's ReLU masks and max-pool picks:"
        f" worst {worst} {ratios[worst]:.3e} (gate {NERFORMER_GRAD_GATE:g}), the ResNet's worst {worst_ext}"
        f" {ratios[worst_ext]:.3e}; {flips} choices flipped against float64's own, which alone move"
        f" {max(flipped, key=flipped.get)} {max(flipped.values()):.3e}; float32 against float64 on its own"
        f" choices: worst against its gate {worst_own} {own[worst_own]:.3e} (gate {allowed[worst_own]:.3e});"
        f" {time.perf_counter() - t0:.1f} s, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(loss_off <= NERFORMER_LOSS_RTOL and abs(loss32 - objective) <= NERFORMER_LOSS_RTOL * abs(objective),
          "nerformer: step 0's losses off float64 or the witness off the step's objective")
    check(ratios[worst] <= NERFORMER_GRAD_GATE, "nerformer: step 0's gradients off float64 on float32's choices")
    check(own[worst_own] <= allowed[worst_own],
          "nerformer: step 0's gradients off float64 by more than the flipped choices explain")
    opt = torch.optim.Adam(model.parameters(), lr=IMPLICITRON_LR)
    gen = torch.Generator(device=device).manual_seed(23)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    objectives, step_ms = [], []
    for i in range(NERFORMER_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        preds = model(**batches[i % len(batches)], evaluation_mode=EvaluationMode.TRAINING, generator=gen)
        preds["objective"].backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        objectives.append(float(preds["objective"].detach()))
        del preds
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first, last = sum(objectives[:3]) / 3, sum(objectives[-3:]) / 3
    timed = sorted(step_ms[2:])
    log(f"nerformer: {NERFORMER_STEPS} Adam steps of {NERFORMER_IMAGES} x 800 rays: objectives"
        f" {[round(v, 6) for v in objectives]}; launches {counts}; torch.cuda.max_memory_allocated()"
        f" {torch.cuda.max_memory_allocated()} bytes")
    log(f"times [nerformer, {card}] frame {frame_ms:.3f} ms; step median of steps 3-{NERFORMER_STEPS}"
        f" {timed[len(timed) // 2]:.3f} ms (min {timed[0]:.3f}, max {timed[-1]:.3f}), peak memory {peak_gb:.3f} GB")
    check(all(math.isfinite(v) for v in objectives), "nerformer: non-finite objective")
    check(last < first, f"nerformer: the mean of the last 3 objectives {last:.6f} is not below the first 3's"
                        f" {first:.6f}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "nerformer: non-finite weights")

    def step():
        opt.zero_grad(set_to_none=True)
        model(**batches[0], evaluation_mode=EvaluationMode.TRAINING, generator=gen)["objective"].backward()
        opt.step()

    profile("nerformer step", step, 1)
    del model, opt
    torch.cuda.empty_cache()
    return counts


class _Sequence:
    """The provider's training frames as a dataset of one sequence."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]

    def sequence_indices_in_order(self, name):
        return [i for i, f in enumerate(self.frames) if f.sequence_name == name]


def phase_flyaround(device, scene, model, card):
    """`render_flyaround` of the WCE serving model: FLYAROUND_POSES poses of
    the circle fitted to the sequence's cameras, each 400^2 from 10 source
    views (#12 at D = 455), written through `VideoWriter` into a temporary
    directory that the phase removes."""
    import shutil
    import tempfile

    import torch
    from PIL import Image

    from pytorch3d_tpu_torch.implicitron.models.visualization.render_flyaround import render_flyaround

    tmp = tempfile.mkdtemp(prefix="chip_smoke_flyaround")
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = render_flyaround(_Sequence(scene.train), scene.train[0].sequence_name, model,
                                f"{tmp}/flyaround.gif", n_flyaround_poses=FLYAROUND_POSES,
                                n_source_views=VIEWS_PER_BATCH, fps=4)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        with Image.open(path) as gif:
            n_frames, size = gif.n_frames, gif.size
        chunks = -(-IMPLICITRON_RES**2 // WCE_MULTISEQ["chunk_size_grid"])
        log(f"flyaround [render_flyaround, {FLYAROUND_POSES} poses of implicitron-wce-serving's model]: {path}"
            f" {n_frames} frames of {size}, launches {counts}; {seconds:.2f} s ({1e3 * seconds / FLYAROUND_POSES:.1f}"
            f" ms a pose, {card})")
        check(n_frames == FLYAROUND_POSES and size == (IMPLICITRON_RES, IMPLICITRON_RES),
              f"flyaround: {n_frames} frames of {size} written")
        check(counts["nerf_field"] == 2 * chunks * FLYAROUND_POSES, f"flyaround: launches {counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def kernel_rows(launches, errors, fine, grad, knn_t, points, points_grad, mlp, mlp_grad, field, field_grad, slice5,
                band):
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
        ("rasterize_fine_band", "pytorch3d_tpu_torch/csrc/rasterize_fine.cu",
         "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:1313", band["fine"], None),
        ("rasterize_grad_band", "pytorch3d_tpu_torch/csrc/rasterize_grad.cu",
         "pytorch3d_tpu/renderer/mesh/rasterize_pallas.py:1346", band["grad"], None),
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


# --------------------------------------------------------------------------- #
# Slice 20: Implicitron's voxel-grid (TensoRF) and IDR / SDF models
# --------------------------------------------------------------------------- #

# TensoRF's configs/lego.txt with its opt.py defaults: N_voxel_init 128^3 growing to N_voxel_final 300^3 at the 5
# steps of upsamp_list (the exp of a linspace of the log voxel counts: sides 128, 152, 180, 213, 253, 300), the VM
# decomposition with n_lamb_sigma 16 x 3 (density, no basis) and n_lamb_sh 48 x 3 through a basis to
# data_dim_color 27, fea2denseAct softplus with density_shift -10, shadingMode MLP_Fea (featureC 128, fea_pe 2,
# view_pe 2), batch_size 4096 rays, lr_init 0.02 for the grids and lr_basis 1e-3 for the basis and the MLP, the alpha
# mask updated (here: the scaffold computed and the volume cropped) at the first upsampling.  An epoch here is
# TENSORF_STEPS steps.  Cut: 512 points a ray in training and evaluation (TensoRF samples ~1039 at 300^3 and keeps
# those its alpha mask passes; the port evaluates every point, as the JAX package does, and masks them).
TENSORF_SIDES = tuple(int(round(128 * (300 / 128) ** (k / 5))) for k in range(6))
TENSORF_CHANGES = {k: [side] * 3 for k, side in enumerate(TENSORF_SIDES)}
TENSORF_EXTENT = 3.0  # TensoRF's blender aabb [-1.5, 1.5]^3 around the provider's unit sphere
TENSORF_STEPS = 2  # Adam steps an epoch, through all six resolutions
TENSORF_FRAMES = 4  # x 1024 rays: TensoRF's batch of 4096
TENSORF_POINTS = 512
TENSORF_LR_GRID, TENSORF_LR_NET = 0.02, 1e-3
TENSORF_SPHERE = 1.05  # the density's occupied region at the start (the sphere's radius 1 and a margin)
TENSORF_MODEL = dict(
    render_image_width=IMPLICITRON_RES, render_image_height=IMPLICITRON_RES, num_passes=1, chunk_size_grid=16000,
    raysampler_args=dict(n_rays_per_image_sampled_from_mask=1024, scene_extent=TENSORF_EXTENT / 2,
                         n_pts_per_ray_training=TENSORF_POINTS, n_pts_per_ray_evaluation=TENSORF_POINTS),
    implicit_function_class_type="VoxelGridImplicitFunction",
    implicit_function_args=dict(
        voxel_grid_density_args=dict(voxel_grid_class_type="VMFactorizedVoxelGrid", extents=(TENSORF_EXTENT,) * 3,
                                     voxel_grid_args=dict(n_components=48, basis_matrix=False,
                                                          resolution_changes=TENSORF_CHANGES)),
        voxel_grid_color_args=dict(voxel_grid_class_type="VMFactorizedVoxelGrid", extents=(TENSORF_EXTENT,) * 3,
                                   voxel_grid_args=dict(n_components=144, n_features=27,
                                                        resolution_changes=TENSORF_CHANGES)),
        decoder_density_args=dict(shift=-10.0, operation="softplus"), density_activation="identity",
        harmonic_embedder_xyz_color_args=dict(n_harmonic_functions=2, append_input=True),
        harmonic_embedder_dir_color_args=dict(n_harmonic_functions=2, append_input=True),
        decoder_color_args=dict(network_args=dict(n_layers=3, hidden_dim=128, output_dim=3, input_skips=(),
                                                  last_activation="sigmoid")),
        scaffold_calculating_epochs=(1,), volume_cropping_epochs=(1,),
    ),
)
VOXEL_EPOCH_GATE = 1e-6  # apply_epoch on the card against the CPU: max |card - cpu| <= gate * max(max |cpu|, 1)
VOXEL_LOSS_RTOL = 1e-5  # a pass's rgb mse, float32 against float64 on the same bundle and scaffold mask
VOXEL_GRAD_GATE = 1e-4  # every gradient, float32 against float64 (floored at GRAD_FLOOR of the largest)
VOXEL_FRAME_GATE = 1e-5  # a served chunk's colours, float32 against float64 on float32's scaffold mask
VOXEL_WITNESS_RAYS = 4000  # of the served frame's first chunk, held against float64
# repro_multiseq_idr_ad.yaml as written (its base repro_multiseq_base.yaml and repro_base.yaml): IDR 8 x 512 with
# the skip at 6, 6 harmonics, bias 0.6, weight norm and geometric init, the SDF renderer with n_steps 32, a
# 256-wide SequenceAutodecoder (20 000 instances), 1024 rays an image, chunks of 102 400 rays; the loss weights
# are IDR's (rgb 1, the mask's BCE 1, eikonal 0.1).
IDR_MODEL = dict(
    render_image_width=IMPLICITRON_RES, render_image_height=IMPLICITRON_RES, num_passes=1, chunk_size_grid=102400,
    raysampler_args=IMPLICITRON_MODEL["raysampler_args"],
    renderer_class_type="SignedDistanceFunctionRenderer", renderer_args=dict(ray_tracer_args=dict(n_steps=32)),
    implicit_function_class_type="IdrFeatureField",
    implicit_function_args=dict(n_harmonic_functions_xyz=6, bias=0.6, d_in=3, d_out=1, dims=(512,) * 8,
                                geometric_init=True, pooled_feature_dim=0, skip_in=(6,), weight_norm=True),
    global_encoder_class_type="SequenceAutodecoder", global_encoder_args=dict(encoding_dim=256, n_instances=20000),
    loss_weights={"loss_rgb_mse": 1.0, "loss_mask_bce": 1.0, "loss_eikonal": 0.1},
)
# repro_singleseq_idr.yaml's colouring network: RayNormalColoringNetwork at its defaults (4 x 512, mode idr)
IDR_RGB_MODEL = dict(IDR_MODEL, renderer_args=dict(ray_tracer_args=dict(n_steps=32),
                                                   ray_normal_coloring_network_args={}))
IDR_IMAGES = 10  # x 1024 rays a step
IDR_STEPS = 6
IDR_RGB_STEPS = 2
IDR_LOSS_RTOL = 1e-5  # step 0's objective, float32 against float64 on float32's hits, depths and picks
IDR_GRAD_GATE = 1e-4  # every gradient (the eikonal's and the normals' second-order terms included), the same way
# (floored at GRAD_FLOOR of the largest)
IDR_FRAME_GATE = 1e-5  # a served chunk's colours and masks, the same way


def _tensorf_density_start(fn, radius):
    """The density grid's first component in each plane and line set to the
    occupancy of a ball-bounded region (5 inside the plane's disc, 1 inside
    the line's span), the rest left at TensoRF's random start: 4.5e-5
    (softplus(-10)) in empty space, 0.0067-5 inside, as a partly trained
    field would be, so that the scaffold and the crop find the object
    where a field at random has no occupied voxel to find."""
    import torch

    grid = fn.voxel_grid_density
    res = TENSORF_SIDES[0]
    axis = torch.linspace(-TENSORF_EXTENT / 2, TENSORF_EXTENT / 2, res, device=grid.extents.device)
    disc = ((axis[:, None] ** 2 + axis[None, :] ** 2) <= radius**2).float() * 5.0
    span = (axis.abs() <= radius).float()
    with torch.no_grad():
        for plane, line in (("xy", "z"), ("xz", "y"), ("yz", "x")):
            getattr(grid, f"matrix_components_{plane}")[0, 0] = disc
            getattr(grid, f"vector_components_{line}")[0, 0] = span


def _tensorf_optimizer(model):
    import torch

    grids = [p for n, p in model.named_parameters() if "voxel_grid" in n and not n.endswith("basis_matrix")]
    rest = [p for n, p in model.named_parameters() if not ("voxel_grid" in n and not n.endswith("basis_matrix"))]
    return torch.optim.Adam([{"params": grids, "lr": TENSORF_LR_GRID}, {"params": rest, "lr": TENSORF_LR_NET}])


def _middle_rays(bundle, rays):
    """The `rays` rays in the middle of a bundle's (B, n, ...) rays."""
    start = (bundle.lengths.shape[1] - rays) // 2
    return bundle.replace(**{k: getattr(bundle, k)[:, start:start + rays]
                             for k in ("origins", "directions", "lengths", "xys")})


def _capture_calls(module, store, limit=1):
    """A forward hook keeping the first `limit` calls' kwargs."""
    def hook(mod, args, kwargs, out):
        if len(store) < limit:
            store.append(kwargs)

    return module.register_forward_hook(hook, with_kwargs=True)


def _sampling_ms(fn, bundle, iters=3):
    """Median device ms (CUDA events) of the two grids' sampling (corner
    gathers and their blend) at a bundle's points."""
    import torch

    from pytorch3d_tpu_torch.renderer.implicit.utils import ray_bundle_to_ray_points

    times = []
    with torch.no_grad():
        points = ray_bundle_to_ray_points(bundle)
        for _ in range(iters + 1):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn.voxel_grid_density(points)
            fn.voxel_grid_color(points)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
    return sorted(times[1:])[iters // 2]


def voxel_pass(fn, bundle, gt, marcher, mask=None):
    """A pass's rgb mse on `bundle` against `gt` (the target at its rays) and
    the function's gradients; with `mask`, the function's outputs times it
    instead of its own scaffold mask."""
    from pytorch3d_tpu_torch.renderer.implicit.utils import ray_bundle_to_ray_points

    fn.zero_grad(set_to_none=True)
    if mask is None:
        densities, colors = fn(ray_bundle=bundle)
    else:
        points = ray_bundle_to_ray_points(bundle)
        densities = fn._get_density(points) * mask
        colors = fn._get_color(points, bundle.directions) * mask
    out = marcher(densities, colors, ray_lengths=bundle.lengths)
    loss = ((out.features - gt) ** 2).mean()
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in fn.named_parameters()}, out.features.detach()


def voxel_witness(model, bundle, image):
    """The pass on `bundle` in float32 against a float64 copy of the function
    on float32's scaffold mask: (loss32, loss64, {name: gradient ratio},
    scaffold mask flips of float64's own)."""
    import copy

    import torch

    from pytorch3d_tpu_torch.renderer.implicit.utils import ray_bundle_to_ray_points
    from pytorch3d_tpu_torch.renderer.utils import ndc_grid_sample

    fn, marcher = model.implicit_function_0, model._renderer._raymarcher
    gt = ndc_grid_sample(image.movedim(-1, 1), bundle.xys).movedim(1, -1)
    loss32, g32, _ = voxel_pass(fn, bundle, gt, marcher)
    with torch.no_grad():
        mask32 = fn._scaffold_mask(ray_bundle_to_ray_points(bundle))
    ref = copy.deepcopy(fn).double()
    b64 = bundle.replace(**{k: getattr(bundle, k).double() for k in ("origins", "directions", "lengths", "xys")})
    loss64, g64, _ = voxel_pass(ref, b64, gt.double(), marcher, mask32.double())
    with torch.no_grad():
        flips = int((ref._scaffold_mask(ray_bundle_to_ray_points(b64)) != mask32.double()).sum())
    del ref
    fn.zero_grad(set_to_none=True)
    return loss32, loss64, grad_ratios_floored(g32, g64), flips


def phase_voxel_grid(device, scene, card):
    """TensoRF's VM model (`TENSORF_MODEL`) in `repro_base`'s GenericModel
    with 1 pass, on the provider's sphere at 400^2 (one sequence: CO3D and
    the Blender scenes are not in the repository): TENSORF_STEPS Adam steps
    an epoch through the six resolutions (128^3 to 300^3), the scaffold
    computed and the volume cropped at the first change, each
    `apply_epoch_callbacks` on the card held against the same transform of
    the same state on the CPU; the optimizer rebuilt at each change; the
    objective must fall.  Step 0 and the first step at 300^3 (scaffold on)
    held against float64 (`voxel_witness`); then one 400^2 frame served at
    300^3 in chunks of 16 000 rays, one chunk held against float64.  Cut:
    512 points a ray (TensoRF: ~1039 at 300^3, alpha-masked).  Plain
    PyTorch: no kernel of the port (the frames come through #1)."""
    import copy

    import numpy as np
    import torch

    from pytorch3d_tpu_torch.implicitron.models import GenericModel
    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode
    from pytorch3d_tpu_torch.implicitron.models.utils import load_state_dict_resized
    from pytorch3d_tpu_torch.renderer.implicit.utils import ray_bundle_to_ray_points

    model = scene.model(30, TENSORF_MODEL)
    fn = model.implicit_function_0
    _tensorf_density_start(fn, TENSORF_SPHERE)
    cpu_model = GenericModel(**TENSORF_MODEL, device="cpu")
    order = np.random.RandomState(30).permutation(len(scene.train))
    batches = [frames_batch([scene.train[int(i)] for i in np.roll(order, -TENSORF_FRAMES * k)[:TENSORF_FRAMES]])
               for k in range(len(scene.train) // TENSORF_FRAMES)]
    gen = torch.Generator(device=device).manual_seed(31)
    subscribed = model.epoch_subscriptions()
    check(subscribed == (1, 2, 3, 4, 5), f"voxel-grid: epochs {subscribed}")
    opt = _tensorf_optimizer(model)
    objectives, step_ms, epoch_notes, witnesses = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = 0
    for epoch in range(len(TENSORF_SIDES)):
        if epoch in subscribed:
            state = model.state_dict()
            cpu_state = {k: v.cpu() for k, v in state.items()}
            t0 = time.perf_counter()
            new_state, changed = model.apply_epoch_callbacks(state, epoch)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            want, want_changed = cpu_model.apply_epoch_callbacks(cpu_state, epoch)
            worst, worst_name = 0.0, None
            for name, value in want.items():
                got = new_state[name].cpu()
                check(got.shape == value.shape, f"voxel-grid: epoch {epoch}'s {name} {tuple(got.shape)} on the card,"
                                                f" {tuple(value.shape)} on the CPU")
                off = float((got - value).abs().max()) / max(float(value.abs().max()), 1.0)
                if off >= worst:
                    worst, worst_name = off, name
            check(changed == want_changed and worst <= VOXEL_EPOCH_GATE,
                  f"voxel-grid: epoch {epoch}'s apply_epoch on the card off the CPU's: {worst_name} {worst:.3e}")
            load_state_dict_resized(model, new_state)
            if changed:
                opt = _tensorf_optimizer(model)
            epoch_notes.append(f"epoch {epoch}: {card_ms:.1f} ms, changed {changed}, against the CPU {worst:.3e}"
                               f" ({worst_name})")
        for _ in range(TENSORF_STEPS):
            batch = batches[step % len(batches)]
            if step == 0 or (epoch == len(TENSORF_SIDES) - 1 and len(witnesses) == 1):
                kept = []
                handle = _capture_calls(fn, kept)
                preds = model(**batch, evaluation_mode=EvaluationMode.TRAINING,
                              generator=torch.Generator(device=device).manual_seed(32 + step))
                handle.remove()
                image = batch["image_rgb"] * (batch["fg_probability"] >= 0.5)
                witnesses.append((epoch, float(preds["objective"].detach())) + voxel_witness(
                    model, kept[0]["ray_bundle"], image))
                del preds
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            preds = model(**batch, evaluation_mode=EvaluationMode.TRAINING, generator=gen)
            preds["objective"].backward()
            opt.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            objectives.append(float(preds["objective"].detach()))
            del preds
            step += 1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sides = [fn.voxel_grid_color.matrix_components_xy.shape[-1], fn.voxel_grid_density.vector_components_z.shape[-1]]
    extents = fn.voxel_grid_density.extents.tolist()
    occupied = float(fn.voxel_grid_scaffold.voxel_grid.mean())
    log(f"voxel-grid [TensoRF VM 48 / 144 components, 27-feature basis, MLP 2 x 128, {TENSORF_SIDES[0]}^3 ->"
        f" {TENSORF_SIDES[-1]}^3, {TENSORF_FRAMES} x 1024 rays x {TENSORF_POINTS} points]: "
        + "; ".join(epoch_notes) + f"; the last grids {sides}, the cropped extents {[round(e, 5) for e in extents]},"
        f" scaffold occupancy {occupied:.4f}")
    log(f"voxel-grid: objectives {[round(v, 6) for v in objectives]}; torch.cuda.max_memory_allocated()"
        f" {torch.cuda.max_memory_allocated()} bytes")
    check(sides == [TENSORF_SIDES[-1]] * 2, f"voxel-grid: the grids end at {sides}")
    check(0.0 < occupied < 1.0 and max(extents) < TENSORF_EXTENT, "voxel-grid: the scaffold or the crop is empty")
    check(all(math.isfinite(v) for v in objectives), "voxel-grid: non-finite objective")
    first, last = sum(objectives[:2]) / 2, sum(objectives[-2:]) / 2
    check(last < first, f"voxel-grid: the mean of the last 2 objectives {last:.6f} is not below the first 2's"
                        f" {first:.6f}")
    for epoch, objective, loss32, loss64, ratios, flips in witnesses:
        worst = max(ratios, key=ratios.get)
        off = abs(loss32 - loss64) / abs(loss64)
        log(f"voxel-grid: epoch {epoch}'s first step, objective {objective:.8f}; the pass's rgb mse float32"
            f" {loss32:.10f}, float64 {loss64:.10f} (relative {off:.3e}); gradients float32 against float64 on"
            f" float32's scaffold mask: worst {worst} {ratios[worst]:.3e} (gate {VOXEL_GRAD_GATE:g}); {flips} mask"
            f" entries flip in float64")
        check(off <= VOXEL_LOSS_RTOL and ratios[worst] <= VOXEL_GRAD_GATE,
              f"voxel-grid: epoch {epoch}'s step off float64")
    check(len(witnesses) == 2, "voxel-grid: the 300^3 step was not witnessed")

    frame = scene.test[0]
    batch = scene.batch(frame)
    chunks = -(-IMPLICITRON_RES**2 // TENSORF_MODEL["chunk_size_grid"])
    kept = []
    handle = _capture_calls(fn, kept, limit=chunks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        img = model(**batch, evaluation_mode=EvaluationMode.EVALUATION)["images_render"]
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    handle.remove()
    serve_gb = torch.cuda.max_memory_allocated() / 1e9
    check(img.shape == (1, IMPLICITRON_RES, IMPLICITRON_RES, 3) and bool(torch.isfinite(img).all()),
          f"voxel-grid: the frame of shape {tuple(img.shape)} or not finite")
    middle = kept[chunks // 2]["ray_bundle"]  # a band of rows through the image's centre
    chunk = _middle_rays(middle, VOXEL_WITNESS_RAYS)
    marcher = model._renderer._raymarcher
    ref = copy.deepcopy(fn).double()
    c64 = chunk.replace(**{k: getattr(chunk, k).double() for k in ("origins", "directions", "lengths", "xys")})
    with torch.no_grad():
        mask32 = fn._scaffold_mask(ray_bundle_to_ray_points(chunk))
        f32 = marcher(*fn(ray_bundle=chunk), ray_lengths=chunk.lengths).features
        pts64 = ray_bundle_to_ray_points(c64)
        flips = int((ref._scaffold_mask(pts64) != mask32.double()).sum())
        occupied = float(mask32.mean())
        f64 = marcher(ref._get_density(pts64) * mask32.double(), ref._get_color(pts64, c64.directions)
                      * mask32.double(), ray_lengths=c64.lengths).features
    del ref, pts64
    frame_off = float((f32.double() - f64).abs().max())
    def serve():
        with torch.no_grad():
            model(**batch, evaluation_mode=EvaluationMode.EVALUATION)

    profile("voxel-grid frame", serve, 1)
    sampling = chunks * _sampling_ms(fn, middle)
    timed = sorted(step_ms[2:])
    log(f"voxel-grid: {chunk.lengths.shape[1]} rays (x {TENSORF_POINTS} points) through the frame's centre against"
        f" float64 on float32's scaffold mask ({occupied:.4f} of the points in it): max |colour| difference"
        f" {frame_off:.3e} (gate {VOXEL_FRAME_GATE:g}); {flips} mask entries flip; rgb range"
        f" [{float(img.min()):.4f}, {float(img.max()):.4f}]")
    log(f"times [voxel-grid, {card}] frame at {TENSORF_SIDES[-1]}^3 {frame_ms:.3f} ms (with its allocations; the"
        f" grids' sampling, corner gathers and blend, {sampling:.3f} ms of it: {chunks} chunks' CUDA-event time);"
        f" step median of steps"
        f" 3-{len(step_ms)} {timed[len(timed) // 2]:.3f} ms (min {timed[0]:.3f}, max {timed[-1]:.3f}); peak memory"
        f" training {peak_gb:.3f} GB, serving {serve_gb:.3f} GB")
    check(frame_off <= VOXEL_FRAME_GATE and occupied > 0, "voxel-grid: the served chunk off float64, or empty")

    def one_step():
        opt.zero_grad(set_to_none=True)
        model(**batches[0], evaluation_mode=EvaluationMode.TRAINING, generator=gen)["objective"].backward()
        opt.step()

    profile("voxel-grid step", one_step, 1)
    del model, opt, cpu_model
    torch.cuda.empty_cache()
    return read_counts()


class _Rows:
    """A forward hook on an implicit function counting the points it
    evaluates (rows of its output)."""

    def __init__(self, fn):
        self.rows = 0
        self.handle = fn.register_forward_hook(self)

    def __call__(self, module, args, out):
        self.rows += out.numel() // out.shape[-1]


def sdf_objective(model, call, image, fg, traced=None):
    """GenericModel's objective from its SDF renderer's inputs `call` ((the
    bundle,), {object_mask, eikonal_points, ...}) against the model's
    preprocessed `image` and `fg`; `traced` (a list) records the tracer's
    (inputs, outputs)."""
    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

    renderer, fn = model._renderer, model.implicit_function_0
    if traced is not None:
        def recording(*args):
            traced.append((args, type(renderer).trace(renderer, *args)))
            return traced[-1][1]

        renderer.trace = recording
    try:
        (bundle,), kw = call
        rendered = renderer(bundle, implicit_functions=[fn], evaluation_mode=EvaluationMode.TRAINING,
                            object_mask=kw["object_mask"], eikonal_points=kw["eikonal_points"])
    finally:
        if traced is not None:
            del renderer.trace
    results = {}
    model._view_metrics(results, rendered, image_rgb=image, depth_map=None, fg_probability=fg, xys=bundle.xys,
                        camera_ids=None)
    model._reg_metrics(results, model=model, raymarched=rendered)
    return sum(w * results[k] for k, w in model.loss_weights.items() if k in results and w != 0.0)


def _double(x):
    import torch

    return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x


def _bundle64(bundle):
    return bundle.replace(**{k: getattr(bundle, k).double() for k in ("origins", "directions", "lengths", "xys")})


def sdf_witness(model, batch, eikonal, seed):
    """Step 0 of the SDF GenericModel in float32 against a float64 copy on
    float32's hits, depths and picks (its tracer's outputs): (the model's
    objective, the witness's float32 objective, float64's, {name: gradient
    ratio}, rays whose hit flips in float64's own trace, rays)."""
    import copy

    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

    calls = []
    handle = model._renderer.register_forward_pre_hook(
        lambda m, args, kw: calls.append((args, kw)) if not calls else None, with_kwargs=True)
    preds = model(**batch, evaluation_mode=EvaluationMode.TRAINING,
                  generator=torch.Generator(device=eikonal.device).manual_seed(seed), draws={"eikonal": eikonal})
    handle.remove()
    objective = float(preds["objective"].detach())
    del preds
    image, fg, _ = model._preprocess_input(batch["image_rgb"], batch["fg_probability"], None)
    traced = []
    model.zero_grad(set_to_none=True)
    loss32 = sdf_objective(model, calls[0], image, fg, traced)
    loss32.backward()
    g32 = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    ref = copy.deepcopy(model).double()
    (fn_args, out32), = traced
    ref._renderer.trace = lambda *args: tuple(_double(t) for t in out32)
    (bundle,), kw = calls[0]
    call64 = ((_bundle64(bundle),), {k: _double(v) for k, v in kw.items()})
    loss64 = sdf_objective(ref, call64, image.double(), fg.double())
    loss64.backward()
    g64 = {n: p.grad for n, p in ref.named_parameters() if p.grad is not None}
    del ref._renderer.trace
    _, origins, mask, dirs = fn_args
    with torch.no_grad():
        hits64 = ref._renderer.trace(ref.implicit_function_0, origins.double(), mask, dirs.double())[1]
    flips = int((hits64 != out32[1]).sum())
    check(sorted(g32) == sorted(g64), "idr: the float64 copy's gradients name other tensors")
    del ref
    return (objective, float(loss32.detach()), float(loss64.detach()), grad_ratios_floored(g32, g64), flips,
            out32[1].numel())


def sdf_frame_witness(model, call, rays):
    """The `rays` rays in the middle of a served chunk rendered in float32 and
    by a float64 copy on float32's trace: (max colour difference, max mask
    difference, the rays that hit)."""
    import copy

    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

    (bundle,), kw = call
    start = (bundle.lengths.shape[1] - rays) // 2
    bundle = _middle_rays(bundle, rays)
    mask = kw.get("object_mask")
    mask = None if mask is None else mask[:, start:start + rays]
    renderer, traced = model._renderer, []

    def recording(*args):
        traced.append(type(renderer).trace(renderer, *args))
        return traced[-1]

    renderer.trace = recording
    try:
        with torch.no_grad():
            out32 = renderer(bundle, implicit_functions=[model.implicit_function_0],
                             evaluation_mode=EvaluationMode.EVALUATION, object_mask=mask)
    finally:
        del renderer.trace
    ref = copy.deepcopy(model).double()
    ref._renderer.trace = lambda *args: tuple(_double(t) for t in traced[0])
    with torch.no_grad():
        out64 = ref._renderer(_bundle64(bundle), implicit_functions=[ref.implicit_function_0],
                              evaluation_mode=EvaluationMode.EVALUATION, object_mask=mask)
    del ref
    return (float((out32.features.double() - out64.features).abs().max()),
            float((out32.masks.double() - out64.masks).abs().max()), int(traced[0][1].sum()))


def _idr_steps(model, batches, steps, gen, lr):
    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    objectives, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        preds = model(**batches[i % len(batches)], evaluation_mode=EvaluationMode.TRAINING, generator=gen)
        preds["objective"].backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        objectives.append(float(preds["objective"].detach()))
        del preds
    return opt, objectives, step_ms


def _idr_frame(model, frame, count=None):
    """One served 400^2 frame: (image, ms, the renderer's first call)."""
    import torch

    from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

    calls = []
    handle = model._renderer.register_forward_pre_hook(
        lambda m, args, kw: calls.append((args, kw)) if not calls else None, with_kwargs=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        img = model(image_rgb=frame.image_rgb, camera=frame.camera, fg_probability=frame.fg_probability,
                    sequence_name=[frame.sequence_name], evaluation_mode=EvaluationMode.EVALUATION)["images_render"]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    handle.remove()
    return img, ms, calls[0]


def phase_idr(device, scene, card):
    """repro_multiseq_idr_ad as written (`IDR_MODEL`) on the provider's
    sphere at 400^2: step 0 held against float64 on float32's trace
    (`sdf_witness`: the objective and every gradient, the eikonal's and the
    normals' second-order terms included; the rays whose hit flips in
    float64's own trace counted), IDR_STEPS Adam steps at repro_base's lr
    5e-4 on IDR_IMAGES images x 1024 rays whose objective must fall, one
    400^2 frame served in chunks of 102 400 rays with one chunk held against
    float64; then the colouring network at its defaults
    (`IDR_RGB_MODEL`: 4 x 512, mode idr): IDR_RGB_STEPS steps and a served
    frame.  Plain PyTorch: no kernel of the port."""
    import numpy as np
    import torch

    reset_counts()
    model = scene.model(40, IDR_MODEL)
    order = np.random.RandomState(40).permutation(len(scene.train))
    batches = []
    for k in range(len(scene.train) // IDR_IMAGES):
        frames = [scene.train[int(i)] for i in np.roll(order, -IDR_IMAGES * k)[:IDR_IMAGES]]
        batches.append(dict(frames_batch(frames), sequence_name=[f.sequence_name for f in frames]))
    n_rays = IDR_IMAGES * IDR_MODEL["raysampler_args"]["n_rays_per_image_sampled_from_mask"]
    eikonal = torch.rand((n_rays // 2, 3), generator=torch.Generator(device=device).manual_seed(41),
                         device=device) * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    objective, loss32, loss64, ratios, flips, rays = sdf_witness(model, batches[0], eikonal, 42)
    witness_s = time.perf_counter() - t0
    worst = max(ratios, key=ratios.get)
    loss_off = abs(loss32 - loss64) / abs(loss64)
    log(f"idr [repro_multiseq_idr_ad: IDR 8 x 512, skip 6, 6 harmonics, bias 0.6, weight norm, geometric init; the SDF"
        f" renderer with n_steps 32; a 256-wide SequenceAutodecoder; {IDR_IMAGES} x 1024 rays]: step 0 objective"
        f" {objective:.8f}; the witness float32 {loss32:.10f}, float64 on float32's trace {loss64:.10f} (relative"
        f" {loss_off:.3e}); gradients float32 against float64: worst {worst} {ratios[worst]:.3e} (gate"
        f" {IDR_GRAD_GATE:g}); {flips} of {rays} rays flip their hit in float64's own trace; {witness_s:.1f} s")
    check(abs(loss32 - objective) <= 1e-6 * abs(objective), "idr: the witness's objective is not the step's")
    check(loss_off <= IDR_LOSS_RTOL and ratios[worst] <= IDR_GRAD_GATE, "idr: step 0 off float64")
    gen = torch.Generator(device=device).manual_seed(43)
    torch.cuda.reset_peak_memory_stats()
    rows = _Rows(model.implicit_function_0)
    opt, objectives, step_ms = _idr_steps(model, batches, IDR_STEPS, gen, IMPLICITRON_LR)
    rows.handle.remove()
    train_per_ray = rows.rows / (IDR_STEPS * n_rays)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first, last = sum(objectives[:3]) / 3, sum(objectives[-3:]) / 3
    log(f"idr: {IDR_STEPS} Adam steps: objectives {[round(v, 6) for v in objectives]}; {train_per_ray:.1f} SDF"
        f" evaluations a ray a step; torch.cuda.max_memory_allocated() {torch.cuda.max_memory_allocated()} bytes")
    check(all(math.isfinite(v) for v in objectives), "idr: non-finite objective")
    check(last < first, f"idr: the mean of the last 3 objectives {last:.6f} is not below the first 3's {first:.6f}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "idr: non-finite weights")
    frame = scene.test[0]
    torch.cuda.reset_peak_memory_stats()
    rows = _Rows(model.implicit_function_0)
    img, frame_ms, call = _idr_frame(model, frame)
    rows.handle.remove()
    serve_gb = torch.cuda.max_memory_allocated() / 1e9
    frame_per_ray = rows.rows / IMPLICITRON_RES**2
    check(img.shape == (1, IMPLICITRON_RES, IMPLICITRON_RES, 3) and bool(torch.isfinite(img).all()),
          f"idr: the frame of shape {tuple(img.shape)} or not finite")
    colour_off, mask_off, hits = sdf_frame_witness(model, call, VOXEL_WITNESS_RAYS)
    timed = sorted(step_ms[2:])
    log(f"idr: {VOXEL_WITNESS_RAYS} rays in the middle of the first chunk ({hits} hit) against float64 on float32's"
        f" trace: colours"
        f" {colour_off:.3e}, masks {mask_off:.3e} (gate {IDR_FRAME_GATE:g}); rgb range [{float(img.min()):.4f},"
        f" {float(img.max()):.4f}]")
    log(f"times [idr, {card}] step median of steps 3-{IDR_STEPS} {timed[len(timed) // 2]:.3f} ms (min {timed[0]:.3f},"
        f" max {timed[-1]:.3f}); frame {frame_ms:.3f} ms ({frame_per_ray:.1f} SDF evaluations a ray); peak memory"
        f" training {peak_gb:.3f} GB, serving {serve_gb:.3f} GB")
    check(colour_off <= IDR_FRAME_GATE and mask_off <= IDR_FRAME_GATE and hits > 0,
          "idr: the served chunk off float64, or no ray of it hits")

    def one_step():
        from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode

        opt.zero_grad(set_to_none=True)
        model(**batches[0], evaluation_mode=EvaluationMode.TRAINING, generator=gen)["objective"].backward()
        opt.step()

    profile("idr step", one_step, 1)
    del model, opt
    torch.cuda.empty_cache()

    model = scene.model(44, IDR_RGB_MODEL)
    net = model._renderer.rgb_network
    check(net.n_layers == 5 and net.linear0.kernel.shape[1] == 512, "idr: the colouring network is not 4 x 512")
    torch.cuda.reset_peak_memory_stats()
    opt, objectives, step_ms = _idr_steps(model, batches, IDR_RGB_STEPS, gen, IMPLICITRON_LR)
    img, frame_ms, _ = _idr_frame(model, frame)
    log(f"times [idr with RayNormalColoringNetwork 4 x 512, {card}] {IDR_RGB_STEPS} steps"
        f" {[round(v, 3) for v in step_ms]} ms (objectives {[round(v, 6) for v in objectives]}); frame"
        f" {frame_ms:.3f} ms; peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    check(all(math.isfinite(v) for v in objectives) and bool(torch.isfinite(img).all()),
          "idr: the colouring network's steps or frame are not finite")
    profile("idr frame with the colouring network", lambda: _idr_frame(model, frame), 1)
    del model, opt
    torch.cuda.empty_cache()
    return read_counts()


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
    sys.path.append(str(REPO / "tests"))  # torch_parallel_ranks: the spawned groups of ranks
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
        launches = dict.fromkeys(KERNELS + BAND_KERNELS, 0)
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
        band_t = band_times(device, card)
        # Slice 12's paths run after the times: their profiles (CPU and CUDA
        # activity) ahead of the times' CUDA-only windows made the profiler
        # drop one #1 record in every window at the headline shape.
        slice12 = {}
        phase = "mesh-uv-serving"
        slice12["mesh-uv-serving"], uv_mesh, uv_tex = phase_mesh_uv_serving(device)
        phase = "training: mesh-uv-fit"
        slice12["mesh-uv-fit"] = phase_mesh_uv_fit(device)
        phase = "mesh-clip"
        slice12["mesh-clip"] = phase_mesh_clip(device)
        phase = "mesh-shaders"
        slice12["mesh-shaders"] = phase_mesh_shaders(device, uv_mesh, uv_tex)
        for counts in slice12.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        log(f"launches by path (slice 12): {slice12}; summed over every path {launches}")
        slice13 = {}
        phase = "joined-scene-serving"
        slice13["joined-scene-serving"], joined = phase_joined_scene_serving(device)
        phase = "fisheye-serving"
        slice13["fisheye-serving"] = phase_fisheye_serving(device)
        phase = "training: pose-fit"
        slice13["pose-fit"] = phase_pose_fit(device, joined)
        phase = "normals"
        slice13["normals"] = phase_normals(device)
        for counts in slice13.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        log(f"launches by path (slice 13): {slice13}; summed over every path {launches}")
        slice14 = {}
        phase = "training: volume-fit"
        slice14["volume-fit"] = phase_volume_fit(device, card)
        phase = "training: implicit-nerf"
        slice14["implicit-nerf"] = phase_implicit_nerf(device, card)
        phase = "training: nerf-remat"
        slice14["nerf-remat"] = phase_nerf_remat(device, nerf, card)
        phase = "points-to-volume"
        slice14["points-to-volume"] = phase_points_to_volume(device, card)
        phase = "point-mesh-distance"
        slice14["point-mesh-distance"] = phase_point_mesh_distance(device, card)
        for counts in slice14.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        log(f"launches by path (slice 14): {slice14}; summed over every path {launches}")
        slice15 = {}
        phase = "band-raster"
        band_paths, band_errors = phase_band_raster(device, card)
        slice15.update(band_paths)
        errors.update(band_errors)
        phase = "sharded-raster"
        slice15.update(phase_sharded_raster(device, card))
        phase = "training: sharded-nerf"
        slice15.update(phase_sharded_nerf(device, card))
        phase = "alignment-ops"
        slice15.update(phase_alignment_ops(device, card))
        for counts in slice15.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        for kernel in BAND_KERNELS:
            check(launches[kernel] > 0, f"{kernel} was launched no time on the paths")
        log(f"launches by path (slice 15): {slice15}; summed over every path {launches}")
        slice16 = {}
        phase = "mesh-ops"
        slice16.update(phase_mesh_ops(device, card))
        phase = "training: nerf-trainer"
        slice16.update(phase_nerf_trainer(device, card))
        for counts in slice16.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        for kernel in ("rasterize_fine", "nerf_field", "nerf_field_grad"):
            check(slice16["nerf-trainer"][kernel] > 0, f"{kernel} was launched no time by the trainer")
        log(f"launches by path (slice 16): {slice16}; summed over every path {launches}")
        slice17 = {}
        phase = "mesh-io"
        slice17.update(phase_mesh_io(device, card))
        phase = "implicitron-data"
        slice17.update(phase_implicitron_data(device, card))
        for counts in slice17.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        for kernel in ("rasterize_fine", "rasterize_points"):
            check(slice17["mesh-io"][kernel] > 0, f"{kernel} was launched no time on the loaded data")
        check(slice17["implicitron-data"]["rasterize_fine"] > 0, "the provider's render launched no #1")
        log(f"launches by path (slice 17): {slice17}; summed over every path {launches}")
        slice18 = {}
        phase = "implicitron-serving"
        scene18 = ImplicitronScene(device)
        slice18["implicitron-serving"] = phase_implicitron_serving(device, scene18, card)
        phase = "training: implicitron-train"
        slice18["implicitron-train"] = phase_implicitron_train(device, scene18, card)
        phase = "training: implicitron-sharded"
        slice18.update(phase_implicitron_sharded(device, scene18, card))
        phase = "model-dbir"
        slice18["model-dbir"] = phase_model_dbir(device, scene18, card)
        for counts in slice18.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        for path in ("implicitron-serving", "implicitron-train"):
            check(slice18[path]["nerf_field"] > 0, f"{path} launched no #12")
        check(slice18["implicitron-train"]["nerf_field_grad"] > 0, "implicitron-train launched no #13")
        check(slice18["model-dbir"]["rasterize_points"] > 0, "model-dbir launched no #5")
        log(f"launches by path (slice 18): {slice18}; summed over every path {launches}")
        slice19, seconds19, t19 = {}, {}, time.perf_counter()
        phase = "implicitron-wce-serving"
        slice19["implicitron-wce-serving"], scene19, wce_model = phase_wce_serving(device, card)
        seconds19[phase], t19 = time.perf_counter() - t19, time.perf_counter()
        phase = "training: implicitron-wce-train"
        slice19["implicitron-wce-train"] = phase_wce_train(device, scene19, card)
        seconds19[phase], t19 = time.perf_counter() - t19, time.perf_counter()
        phase = "flyaround"
        slice19["flyaround"] = phase_flyaround(device, scene19, wce_model, card)
        del wce_model
        torch.cuda.empty_cache()
        seconds19[phase], t19 = time.perf_counter() - t19, time.perf_counter()
        phase = "nerformer"
        slice19["nerformer"] = phase_nerformer(device, scene19, card)
        del scene19
        seconds19[phase], t19 = time.perf_counter() - t19, time.perf_counter()
        for counts in slice19.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        check(slice19["implicitron-wce-serving"]["rasterize_fine"] > 0, "the provider's render launched no #1")
        for path in ("implicitron-wce-serving", "implicitron-wce-train", "flyaround"):
            check(slice19[path]["nerf_field"] > 0, f"{path} launched no #12")
        check(slice19["implicitron-wce-train"]["nerf_field_grad"] > 0, "implicitron-wce-train launched no #13")
        log(f"launches by path (slice 19): {slice19}; summed over every path {launches}")
        phase = "fused-wide"
        wide_errors, _ = phase_fused_wide(device, card)
        seconds19[phase] = time.perf_counter() - t19
        log(f"slice 19's phases, seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds19.items())};"
            f" {sum(seconds19.values()):.1f} in all")
        for kernel, err in wide_errors.items():
            errors[kernel] = max(errors[kernel], err)
        slice20, seconds20, t20 = {}, {}, time.perf_counter()
        phase = "training: voxel-grid"
        reset_counts()
        scene20 = ImplicitronScene(device)
        slice20["voxel-grid"] = phase_voxel_grid(device, scene20, card)
        seconds20[phase], t20 = time.perf_counter() - t20, time.perf_counter()
        phase = "training: idr"
        slice20["idr"] = phase_idr(device, scene20, card)
        del scene20
        seconds20[phase] = time.perf_counter() - t20
        for counts in slice20.values():
            for kernel, n in counts.items():
                launches[kernel] += n
        check(slice20["voxel-grid"]["rasterize_fine"] > 0, "the provider's render launched no #1")
        log(f"launches by path (slice 20): {slice20}; summed over every path {launches}")
        log(f"slice 20's phases, seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds20.items())};"
            f" {sum(seconds20.values()):.1f} in all")
        kernels = kernel_rows(launches, errors, fine, grad, knn_t, points_t, points_grad_t, *nerf_t, slice5, band_t)
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
