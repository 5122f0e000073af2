"""Implicitron's frame loading: the config system, the annotation types, the
dataset utilities, the frame builders and the rendered-mesh provider with a
mesh file, the port against the JAX package on the CPU, on files each test
writes from seeded numpy data.

Tolerances:
- config: `get_default_args`, `remove_unused_components` and the members
  `run_auto_creation` builds equal to the JAX package's on the same class
  trees (defined once for each package);
- types: a jgzip written by either package loads in the other, equal;
- dataset utils: the bbox helpers, `resize_image` and the PNG loaders equal
  bit for bit (the same numpy and PIL calls); the camera adjustments within
  1e-6 (float64 host arithmetic, float32 cameras);
- the frame builder: every FrameData field and the camera within 1e-6;
- the provider with `data_file=`: face ids equal; over the covered
  pixels' RGB values, at most 9 % more than 1.5e-6 off JAX's jitted
  provider and none more than 2.5e-5.  The projected verts differ by an
  ulp, which moves the barycentrics of these small faces by up to ~5e-6,
  and the random 16^2 map (texel steps up to 1 over 1/16 of uv) turns that
  into ~1e-5 of colour.  JAX's own eager provider reads 8.43 % above
  1.5e-6 and a max of 2.11e-5 against its jitted one, the port 2.77 % and
  1.80e-5 (this file's `__main__` prints both); the limits are set just
  above JAX's own spread.
"""

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu import renderer as jr
from pytorch3d_tpu.implicitron.dataset import frame_data as jframe_data
from pytorch3d_tpu.implicitron.dataset import rendered_mesh_dataset_map_provider as jprovider
from pytorch3d_tpu.implicitron.dataset import types as jtypes
from pytorch3d_tpu.implicitron.dataset import utils as jdu
from pytorch3d_tpu.implicitron.tools import config as jconfig
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu_torch import renderer as tr
from pytorch3d_tpu_torch.implicitron.dataset import GenericFrameDataBuilder, RenderedMeshDatasetMapProvider
from pytorch3d_tpu_torch.implicitron.dataset import frame_data as tframe_data
from pytorch3d_tpu_torch.implicitron.dataset import types as ttypes
from pytorch3d_tpu_torch.implicitron.dataset import utils as tdu
from pytorch3d_tpu_torch.implicitron.tools import config as tconfig
from pytorch3d_tpu_torch.io import load_objs_as_meshes, save_obj, save_ply
from pytorch3d_tpu_torch.utils import ico_sphere

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools


@pytest.fixture(autouse=True)
def _two_threads():
    """Beside other test processes, torch's full thread pool makes small
    tensors' ops far slower; two threads keep them near their time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------- #
# Config
# --------------------------------------------------------------------------- #


def _tree(cfg):
    """One class tree on the config module `cfg`: a replaceable member with
    two registered implementations, a nested Configurable with a tweak, an
    Optional member with `_enabled`, mutable and `field` defaults."""

    class Encoder(cfg.ReplaceableBase):
        pass

    @cfg.registry.register
    class EncoderA(Encoder):
        width: int = 3
        scales: list = [1, 2]

    @cfg.registry.register
    class EncoderB(Encoder):
        depth: int = 2
        labels: dict = dataclasses.field(default_factory=lambda: {"x": 1})

    class Leaf(cfg.Configurable):
        alpha: float = 0.5
        tag: str = "leaf"

    class Mid(cfg.Configurable):
        leaf: Leaf
        beta: int = 7

        def __post_init__(self):
            cfg.run_auto_creation(self)

    def mid_tweak_args(type_, args):
        args["beta"] = 9

    class Root(cfg.Configurable):
        encoder: Encoder
        encoder_class_type: str = "EncoderA"
        mid: Mid
        extra: Optional[Leaf]
        gamma: float = 1.0

        def __post_init__(self):
            cfg.run_auto_creation(self)

    Root.mid_tweak_args = staticmethod(mid_tweak_args)
    return Root, Encoder


@pytest.fixture(scope="module")
def trees():
    return _tree(tconfig), _tree(jconfig)


def _members(root):
    return {
        "encoder": (type(root.encoder).__name__, dataclasses.asdict(root.encoder) if root.encoder else None),
        "mid": (root.mid.beta, root.mid.leaf.alpha, root.mid.leaf.tag),
        "extra": None if root.extra is None else (root.extra.alpha, root.extra.tag),
        "gamma": root.gamma,
    }


def test_config_default_args_match_jax(trees):
    (troot, tenc), (jroot, jenc) = trees
    tcfg, jcfg = tconfig.get_default_args(troot), jconfig.get_default_args(jroot)
    assert tcfg == jcfg
    assert tcfg["mid_args"]["beta"] == 9 and tcfg["extra_enabled"] is False
    assert tconfig.get_default_args(tenc) == jconfig.get_default_args(jenc)

    def fn(a, b=2, c="x"):
        return a

    assert tconfig.get_default_args(fn) == jconfig.get_default_args(fn) == {"b": 2, "c": "x"}
    assert tconfig.get_default_args(None) == jconfig.get_default_args(None) == {}


@pytest.mark.parametrize("edit", ["defaults", "impl_b", "enabled"])
def test_config_run_auto_creation_matches_jax(trees, edit):
    (troot, _), (jroot, _) = trees
    built = []
    for cfg_mod, root in ((tconfig, troot), (jconfig, jroot)):
        cfg = cfg_mod.get_default_args(root)
        if edit == "impl_b":
            cfg["encoder_class_type"] = "EncoderB"
            cfg["encoder_EncoderB_args"]["depth"] = 5
            cfg["mid_args"]["leaf_args"]["alpha"] = 0.25
        elif edit == "enabled":
            cfg["extra_enabled"] = True
            cfg["extra_args"]["tag"] = "extra"
            cfg["encoder_class_type"] = ""
        built.append(_members(root(**cfg)))
    assert built[0] == built[1]


def test_config_remove_unused_components_and_registry_match_jax(trees):
    (troot, tenc), (jroot, jenc) = trees
    tcfg, jcfg = tconfig.get_default_args(troot), jconfig.get_default_args(jroot)
    tcfg["encoder_class_type"] = jcfg["encoder_class_type"] = "EncoderB"
    tconfig.remove_unused_components(tcfg)
    jconfig.remove_unused_components(jcfg)
    assert tcfg == jcfg and "encoder_EncoderA_args" not in tcfg
    assert [c.__name__ for c in tconfig.registry.get_all(tenc)] == [c.__name__ for c in jconfig.registry.get_all(jenc)]
    with pytest.raises(ValueError, match="has not been registered as a Encoder") as terr:
        tconfig.registry.get(tenc, "Nope")
    with pytest.raises(ValueError) as jerr:
        jconfig.registry.get(jenc, "Nope")
    assert str(terr.value) == str(jerr.value)
    assert tconfig.get_default_args_field(troot).default_factory() == tconfig.get_default_args(troot)


def test_config_torch_module_configurable():
    class Head(tconfig.Configurable, torch.nn.Module):
        width: int = 4

        def __post_init__(self):
            self.linear = torch.nn.Linear(self.width, 2)
            self.scale = torch.nn.Parameter(torch.full((2,), 2.0))

        def forward(self, x):
            return self.linear(x) * self.scale

    class Net(tconfig.Configurable, torch.nn.Module):
        head: Head
        extra: Optional[Head]
        bias: float = 0.5

        def __post_init__(self):
            tconfig.run_auto_creation(self)
            self.offset = torch.nn.Parameter(torch.tensor(self.bias))

        def forward(self, x):
            return self.head(x) + self.offset

    cfg = tconfig.get_default_args(Net)
    assert cfg == {"head_args": {"width": 4}, "head": None, "extra_args": {"width": 4}, "extra": None,
                   "extra_enabled": False, "bias": 0.5}
    cfg["head_args"]["width"] = 3
    net = Net(**cfg)
    assert isinstance(net.head, Head) and net.extra is None and net.head.width == 3
    assert sorted(net.state_dict()) == ["head.linear.bias", "head.linear.weight", "head.scale", "offset"]
    assert sum(p.numel() for p in net.parameters()) == 3 * 2 + 2 + 2 + 1
    net = net.to(torch.float64)
    assert all(p.dtype == torch.float64 for p in net.parameters())
    x = torch.ones(5, 3, dtype=torch.float64)
    out = net(x)
    out.sum().backward()
    assert out.shape == (5, 2) and net.head.scale.grad is not None
    again = Net(**cfg).to(torch.float64)
    again.load_state_dict(net.state_dict())
    torch.testing.assert_close(again(x), out, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# Types
# --------------------------------------------------------------------------- #


def _annotations(types):
    frames = [
        types.FrameAnnotation(
            sequence_name="seq", frame_number=i, frame_timestamp=0.5 * i,
            image=types.ImageAnnotation(path=f"seq/images/frame{i:06d}.png", size=(40, 48)),
            depth=types.DepthAnnotation(path=f"seq/depths/frame{i:06d}.png", scale_adjustment=0.25,
                                        mask_path=None if i else "seq/depth_masks/a.png"),
            mask=types.MaskAnnotation(path=f"seq/masks/frame{i:06d}.png", mass=12.5 * i,
                                      bounding_box_xywh=(1.0, 2.0, 3.0, 4.0)),
            viewpoint=types.ViewpointAnnotation(
                R=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)), T=(0.1, 0.2, 2.5 + i),
                focal_length=(1.6, 1.7), principal_point=(0.01, -0.02)),
            meta={"frame_type": "train_known"} if i else None,
        )
        for i in range(2)
    ]
    seqs = [types.SequenceAnnotation(sequence_name="seq", category="chair",
                                     point_cloud=types.PointCloudAnnotation(path="seq/pc.ply", quality_score=0.7),
                                     viewpoint_quality_score=0.9)]
    return frames, seqs


def test_types_jgzip_loads_across(tmp_path):
    from typing import List

    for write, read, w_types, r_types in ((jtypes, ttypes, jtypes, ttypes), (ttypes, jtypes, ttypes, jtypes)):
        frames, seqs = _annotations(w_types)
        write.dump_dataclass_jgzip(str(tmp_path / "frames.jgz"), frames)
        write.dump_dataclass_jgzip(str(tmp_path / "seqs.jgz"), seqs)
        got_f = read.load_dataclass_jgzip(str(tmp_path / "frames.jgz"), List[r_types.FrameAnnotation])
        got_s = read.load_dataclass_jgzip(str(tmp_path / "seqs.jgz"), List[r_types.SequenceAnnotation])
        assert [type(f) for f in got_f] == [r_types.FrameAnnotation] * 2
        assert isinstance(got_f[1].viewpoint, r_types.ViewpointAnnotation)
        assert [dataclasses.asdict(f) for f in got_f] == [dataclasses.asdict(f) for f in frames]
        assert [dataclasses.asdict(s) for s in got_s] == [dataclasses.asdict(s) for s in seqs]


# --------------------------------------------------------------------------- #
# Dataset utils
# --------------------------------------------------------------------------- #


def _blob_mask(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    return np.clip(1.2 - ((y - cy) ** 2 / (0.2 * h) ** 2 + (x - cx) ** 2 / (0.25 * w) ** 2), 0, 1).astype(np.float32)


def test_bbox_helpers_match_jax():
    for seed in range(3):
        mask = _blob_mask(40, 48, seed)
        for thr in (0.4, 0.9):
            assert tdu.get_bbox_from_mask(mask, thr) == jdu.get_bbox_from_mask(mask, thr)
        box = np.asarray(jdu.get_bbox_from_mask(mask, 0.4), np.float64)
        for ctx in (0.0, 0.3):
            np.testing.assert_array_equal(tdu.get_clamp_bbox(box, ctx), jdu.get_clamp_bbox(box, ctx))
        xyxy = jdu.get_clamp_bbox(box, 0.3)
        np.testing.assert_array_equal(tdu.clamp_box_to_image_bounds_and_round(xyxy, (40, 48)),
                                      jdu.clamp_box_to_image_bounds_and_round(xyxy, (40, 48)))
        np.testing.assert_array_equal(tdu.bbox_xyxy_to_xywh(xyxy), jdu.bbox_xyxy_to_xywh(xyxy))
        np.testing.assert_array_equal(tdu.bbox_xywh_to_xyxy(box, 2), jdu.bbox_xywh_to_xyxy(box, 2))
        np.testing.assert_array_equal(tdu.rescale_bbox(box, (40, 48), (20, 30)), jdu.rescale_bbox(box, (40, 48), (20, 30)))
        np.testing.assert_array_equal(tdu.crop_around_box(mask[..., None], xyxy), jdu.crop_around_box(mask[..., None], xyxy))
    with pytest.raises(ValueError, match="squashed image"):
        tdu.get_clamp_bbox(np.asarray([0.0, 0.0, 1.0, 5.0]))
    types = ["train_known", "test_unseen", "train_unseen", "test_known"]
    np.testing.assert_array_equal(tdu.is_train_frame(types), jdu.is_train_frame(types))
    np.testing.assert_array_equal(tdu.is_known_frame(types), jdu.is_known_frame(types))
    assert [tdu.is_known_frame_scalar(t) for t in types] == [jdu.is_known_frame_scalar(t) for t in types]


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("size", [(32, 32), (24, 40)])
def test_resize_image_matches_jax(mode, size):
    image = np.random.default_rng(5).random((37, 29, 3)).astype(np.float32)
    got, want = tdu.resize_image(image, *size, mode=mode), jdu.resize_image(image, *size, mode=mode)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def test_camera_adjustments_match_jax():
    fl, pp = np.asarray([[1.7, 1.5]], np.float32), np.asarray([[0.05, -0.1]], np.float32)
    tcam = tr.PerspectiveCameras.create(focal_length=fl, principal_point=pp, device="cpu")
    jcam = jr.PerspectiveCameras.create(focal_length=jnp.asarray(fl), principal_point=jnp.asarray(pp))
    crop = np.asarray([5, 3, 30, 26])
    for tfn, jfn, args in (
        (tdu.adjust_camera_to_bbox_crop, jdu.adjust_camera_to_bbox_crop, ((48, 40), crop)),
        (tdu.adjust_camera_to_bbox_crop_, jdu.adjust_camera_to_bbox_crop_, ((48, 40), crop)),
        (tdu.adjust_camera_to_image_scale, jdu.adjust_camera_to_image_scale, ((30, 26), (32, 32))),
        (tdu.adjust_camera_to_image_scale_, jdu.adjust_camera_to_image_scale_, ((48, 40), (24, 32))),
    ):
        t, j = tfn(tcam, *args), jfn(jcam, *args)
        assert isinstance(t, tr.PerspectiveCameras) and t.focal_length.device.type == "cpu"
        np.testing.assert_allclose(_np(t.focal_length), np.asarray(j.focal_length), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(t.principal_point), np.asarray(j.principal_point), rtol=0, atol=1e-6)


def test_png_loaders_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(6)
    Image.fromarray((rng.random((10, 12, 4)) * 255).astype(np.uint8), "RGBA").save(tmp_path / "rgba.png")
    Image.fromarray((rng.random((10, 12)) * 255).astype(np.uint8)).save(tmp_path / "mask.png")
    depth = rng.uniform(0.5, 4.0, (10, 12)).astype(np.float16)
    depth[0, 0] = np.inf
    Image.fromarray(depth.view(np.uint16)).save(tmp_path / "depth.png")
    Image.fromarray(rng.random((10, 12)) > 0.5).save(tmp_path / "bits.png")
    for got, want in (
        (tdu.load_image(str(tmp_path / "rgba.png")), jdu.load_image(str(tmp_path / "rgba.png"))),
        (tdu.load_image(str(tmp_path / "rgba.png"), try_read_alpha=True),
         jdu.load_image(str(tmp_path / "rgba.png"), try_read_alpha=True)),
        (tdu.load_mask(str(tmp_path / "mask.png")), jdu.load_mask(str(tmp_path / "mask.png"))),
        (tdu.load_16big_png_depth(str(tmp_path / "depth.png")), jdu.load_16big_png_depth(str(tmp_path / "depth.png"))),
        (tdu.load_depth(str(tmp_path / "depth.png"), 0.5), jdu.load_depth(str(tmp_path / "depth.png"), 0.5)),
        (tdu.load_1bit_png_mask(str(tmp_path / "bits.png")), jdu.load_1bit_png_mask(str(tmp_path / "bits.png"))),
        (tdu.load_depth_mask(str(tmp_path / "bits.png")), jdu.load_depth_mask(str(tmp_path / "bits.png"))),
    ):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unsupported depth file name"):
        tdu.load_depth(str(tmp_path / "depth.exr"), 1.0)
    t = tdu.safe_as_tensor(np.arange(3), torch.float32, device="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu" and tdu.safe_as_tensor(None, torch.float32) is None


def test_load_pointcloud_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    pts, col = rng.random((50, 3)).astype(np.float32), rng.random((50, 3)).astype(np.float32)
    save_ply(tmp_path / "pc.ply", pts, colors=col)
    j = jdu.load_pointcloud(str(tmp_path / "pc.ply"), max_points=20)
    scores = torch.tensor(np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (1, 50))))  # JAX's draw
    t = tdu.load_pointcloud(tmp_path / "pc.ply", max_points=20, device="cpu", scores=scores)
    np.testing.assert_array_equal(_np(t.points_padded()), np.asarray(j.points_padded()))
    np.testing.assert_array_equal(_np(t.features_padded()), np.asarray(j.features_padded()))
    whole = tdu.load_pointcloud(tmp_path / "pc.ply", device="cpu")
    assert whole.points_padded().shape == (1, 50, 3) and isinstance(j, JPointclouds)


# --------------------------------------------------------------------------- #
# The frame builder
# --------------------------------------------------------------------------- #


def _co3d_tree(root, n=3, h=48, w=40):
    """A CO3D-style sequence: images, masks, 16-bit depths and viewpoints
    of n frames, as FrameAnnotation dicts with paths under `root`."""
    from PIL import Image

    rng = np.random.default_rng(8)
    entries = []
    for sub in ("images", "masks", "depths"):
        os.makedirs(root / "seq" / sub, exist_ok=True)
    for i in range(n):
        names = {k: f"seq/{k}/frame{i:06d}.png" for k in ("images", "masks", "depths")}
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(root / names["images"])
        Image.fromarray((_blob_mask(h, w, 10 + i) * 255).astype(np.uint8)).save(root / names["masks"])
        Image.fromarray(rng.integers(0, 4000, (h, w)).astype(np.uint16)).save(root / names["depths"])
        angle = 0.3 * i
        R = [[np.cos(angle), 0.0, np.sin(angle)], [0.0, 1.0, 0.0], [-np.sin(angle), 0.0, np.cos(angle)]]
        entries.append({
            "sequence_name": "seq", "frame_number": i, "frame_timestamp": 0.1 * i,
            "image": {"path": names["images"], "size": [h, w]},
            "mask": {"path": names["masks"]},
            "depth": {"path": names["depths"], "scale_adjustment": 0.001},
            "viewpoint": {"R": R, "T": [0.1 * i, -0.2, 3.0], "focal_length": [1.8, 1.9 + 0.1 * i],
                          "principal_point": [0.02 * i, -0.03]},
            "meta": {"frame_type": "train_known" if i else "test_known"},
        })
    return entries


@pytest.mark.parametrize("box_crop", [False, True])
def test_frame_builder_matches_jax(tmp_path, box_crop):
    entries = _co3d_tree(tmp_path)
    kw = dict(dataset_root=str(tmp_path), image_height=32, image_width=32, box_crop=box_crop)
    tb = GenericFrameDataBuilder(device="cpu", **kw)
    jb = jframe_data.GenericFrameDataBuilder(**kw)
    seq = {"sequence_name": "seq", "category": "chair"}
    for entry in entries:
        t, j = tb.build(entry, seq), jb.build(entry, seq)
        for f in dataclasses.fields(jframe_data.FrameData):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if f.name == "camera":
                for attr in ("R", "T", "focal_length", "principal_point"):
                    np.testing.assert_allclose(_np(getattr(tv, attr)), np.asarray(getattr(jv, attr)), rtol=0, atol=1e-6)
                assert isinstance(tv, tr.PerspectiveCameras) and tv.device.type == "cpu"
            elif isinstance(jv, jax.Array):
                assert torch.is_tensor(tv) and tv.device.type == "cpu" and _np(tv).dtype == np.asarray(jv).dtype
                np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=0, atol=1e-6)
            else:
                assert tv == jv, f.name
        assert t.image_rgb.shape == (1, 32, 32, 3) and (t.crop_bbox_xywh is not None) == box_crop
    assert isinstance(tframe_data.FrameDataBuilder(device="cpu", **kw), tframe_data.FrameDataBuilderBase)
    dc = ttypes.FrameAnnotation(sequence_name="seq", frame_number=0, frame_timestamp=0.0,
                                image=ttypes.ImageAnnotation(path=entries[0]["image"]["path"], size=(48, 40)))
    assert tb.build(dc).image_rgb.shape == (1, 32, 32, 3)


# --------------------------------------------------------------------------- #
# The rendered-mesh provider with a mesh file
# --------------------------------------------------------------------------- #


PROVIDER_VIEWS, PROVIDER_SIZE = 4, 32


def _textured_sphere_obj(dirpath):
    """A seeded ico_sphere(2) with a random UV per face corner and a random
    16^2 texture map, saved as OBJ + MTL + PNG; returns the OBJ's path."""
    sphere = ico_sphere(2, device="cpu")
    verts, faces = sphere.verts_padded()[0], sphere.faces_padded()[0]
    rng = np.random.default_rng(9)
    uvs = torch.tensor(rng.random((faces.shape[0] * 3, 2)).astype(np.float32))
    save_obj(os.path.join(dirpath, "sphere.obj"), verts, faces, verts_uvs=uvs,
             faces_uvs=torch.arange(faces.shape[0] * 3).reshape(-1, 3),
             texture_map=torch.tensor(rng.random((16, 16, 3)).astype(np.float32)))
    return os.path.join(dirpath, "sphere.obj")


def _jax_provider(path, jit=True):
    """JAX's provider on `path`, jitted or eager, with its mesh loaded outside
    the trace: the mesh and each view's (image_rgb, R, T)."""
    from unittest import mock

    from pytorch3d_tpu import io as jio

    jmesh = jio.load_objs_as_meshes([path])

    def build():
        provider = jprovider.RenderedMeshDatasetMapProvider(
            num_views=PROVIDER_VIEWS, resolution=PROVIDER_SIZE, data_file=path)
        return [(f.image_rgb, f.camera.R, f.camera.T) for f in provider._build()]

    with mock.patch.object(jio, "load_objs_as_meshes", lambda files: jmesh):
        return jmesh, (jax.jit(build)() if jit else build())


def _jax_ids(jmesh, jframes):
    cams = jr.FoVPerspectiveCameras.create(R=jnp.concatenate([f[1] for f in jframes]),
                                           T=jnp.concatenate([f[2] for f in jframes]))
    settings = jr.RasterizationSettings(image_size=PROVIDER_SIZE, faces_per_pixel=1)
    return np.asarray(jax.jit(lambda c: jr.MeshRasterizer(c, settings)(jmesh.extend(PROVIDER_VIEWS)).pix_to_face)(cams))


def _rgb_spread(a, b, covered):
    """Over the covered pixels' RGB values: the share of |a - b| above
    1.5e-6 and its max."""
    diff = np.abs(a - b)[covered]
    return float((diff > 1.5e-6).mean()), float(diff.max())


def test_rendered_mesh_provider_data_file_matches_jax(tmp_path):
    path = _textured_sphere_obj(tmp_path)
    jmesh, jframes = _jax_provider(path)
    jids = _jax_ids(jmesh, jframes)
    args = tconfig.get_default_args(RenderedMeshDatasetMapProvider)
    args.update(num_views=PROVIDER_VIEWS, resolution=PROVIDER_SIZE, data_file=path, device="cpu")
    provider = RenderedMeshDatasetMapProvider(**args)
    tframes = provider.get_dataset_map()["train"] + provider.get_dataset_map()["test"]
    tcams = tr.join_cameras_as_batch([f.camera for f in tframes])
    tmesh = load_objs_as_meshes([path], device="cpu")
    settings = tr.RasterizationSettings(image_size=PROVIDER_SIZE, faces_per_pixel=1)
    tids = tr.MeshRasterizer(tcams, settings)(tmesh.extend(PROVIDER_VIEWS)).pix_to_face
    covered = jids[..., 0] >= 0
    assert (_np(tids) == jids).all() and covered.mean() > 0.2
    jimg = np.concatenate([np.asarray(f[0]) for f in jframes])
    timg = np.concatenate([_np(f.image_rgb) for f in tframes])
    assert timg.shape == (PROVIDER_VIEWS, PROVIDER_SIZE, PROVIDER_SIZE, 3)
    share, worst = _rgb_spread(timg, jimg, covered)
    assert share <= 0.09 and worst <= 2.5e-5, (share, worst)
    assert timg.std() > 0.05  # the texture shows, not a flat colour


if __name__ == "__main__":
    # The reading behind the provider test's RGB limits: JAX's eager provider
    # against its jitted one, and the port against the jitted one, on the
    # test's OBJ.  Run from the repo root:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_implicitron_data.py
    import tempfile

    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as d:
        path = _textured_sphere_obj(d)
        jmesh, jitted = _jax_provider(path)
        _, eager = _jax_provider(path, jit=False)
        provider = RenderedMeshDatasetMapProvider(num_views=PROVIDER_VIEWS, resolution=PROVIDER_SIZE,
                                                  data_file=path, device="cpu")
        port = provider._build()
        covered = _jax_ids(jmesh, jitted)[..., 0] >= 0
        jimg = np.concatenate([np.asarray(f[0]) for f in jitted])
        for name, img in (("JAX eager", np.concatenate([np.asarray(f[0]) for f in eager])),
                          ("port", np.concatenate([_np(f.image_rgb) for f in port]))):
            share, worst = _rgb_spread(img, jimg, covered)
            print(f"{name} against JAX jitted over {int(covered.sum()) * 3} covered RGB values:"
                  f" {share:.4%} above 1.5e-6, max {worst:.3e}")
