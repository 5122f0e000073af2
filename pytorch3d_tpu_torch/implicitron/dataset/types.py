"""CO3D annotation dataclasses and their typed JSON (de)serialization
(port of pytorch3d_tpu/implicitron/dataset/types.py, plain Python): the
same classes and JSON keys, so a file written by either package loads in the
other.  The recursive loader rebuilds nested dataclasses, Optionals and
List / Tuple / Dict containers from plain JSON values.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import typing
from typing import Any, Dict, IO, List, Optional, Tuple, Type, TypeVar

TF3 = Tuple[float, float, float]
_X = TypeVar("_X")


@dataclasses.dataclass
class ImageAnnotation:
    path: str
    size: Tuple[int, int]  # (H, W)


@dataclasses.dataclass
class DepthAnnotation:
    path: str
    scale_adjustment: float
    mask_path: Optional[str] = None


@dataclasses.dataclass
class MaskAnnotation:
    path: str
    mass: Optional[float] = None
    bounding_box_xywh: Optional[Tuple[float, float, float, float]] = None


@dataclasses.dataclass
class ViewpointAnnotation:
    R: Tuple[TF3, TF3, TF3]
    T: TF3
    focal_length: Tuple[float, float]
    principal_point: Tuple[float, float]
    intrinsics_format: str = "ndc_norm_image_bounds"


@dataclasses.dataclass
class FrameAnnotation:
    """Per-frame annotation loaded from JSON."""

    sequence_name: str
    frame_number: int
    frame_timestamp: float
    image: ImageAnnotation
    depth: Optional[DepthAnnotation] = None
    mask: Optional[MaskAnnotation] = None
    viewpoint: Optional[ViewpointAnnotation] = None
    meta: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class PointCloudAnnotation:
    path: str
    quality_score: float
    n_points: Optional[int] = None


@dataclasses.dataclass
class VideoAnnotation:
    path: str
    length: float


@dataclasses.dataclass
class SequenceAnnotation:
    sequence_name: str
    category: str
    video: Optional[VideoAnnotation] = None
    point_cloud: Optional[PointCloudAnnotation] = None
    viewpoint_quality_score: Optional[float] = None


# --------------------------------------------------------------------------- #
# typed (de)serialization
# --------------------------------------------------------------------------- #


def _asdict_rec(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _asdict_rec(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [_asdict_rec(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _asdict_rec(v) for k, v in obj.items()}
    return obj


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _from_plain(value, tp):
    tp, optional = _unwrap_optional(tp)
    if value is None:
        return None
    if dataclasses.is_dataclass(tp):
        # resolve string annotations (PEP 563) to real types
        hints = typing.get_type_hints(tp)
        kwargs = {}
        for f in dataclasses.fields(tp):
            if isinstance(value, dict) and f.name in value:
                kwargs[f.name] = _from_plain(
                    value[f.name], hints.get(f.name, Any)
                )
        return tp(**kwargs)
    origin = typing.get_origin(tp)
    if origin in (list, List):
        (item_t,) = typing.get_args(tp) or (Any,)
        return [_from_plain(v, item_t) for v in value]
    if origin in (tuple, Tuple):
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_from_plain(v, args[0]) for v in value)
        if args:
            return tuple(_from_plain(v, t) for v, t in zip(value, args))
        return tuple(value)
    if origin in (dict, Dict):
        kt, vt = typing.get_args(tp) or (Any, Any)
        return {k: _from_plain(v, vt) for k, v in value.items()}
    if isinstance(tp, str):
        # string annotations (from __future__ annotations): resolve the
        # few we use here
        resolved = globals().get(tp)
        if resolved is not None:
            return _from_plain(value, resolved)
        return value
    return value


def dump_dataclass(obj: Any, f: IO, binary: bool = False) -> None:
    """JSON-dump a (list of) dataclass(es) to an open file."""
    text = json.dumps(_asdict_rec(obj))
    if binary:
        f.write(text.encode("utf8"))
    else:
        f.write(text)


def load_dataclass(f: IO, cls: Type[_X], binary: bool = False) -> _X:
    """Typed JSON load: reconstructs the (possibly List[...]-typed)
    dataclass structure `cls`."""
    data = f.read()
    if binary:
        data = data.decode("utf8")
    return _from_plain(json.loads(data), cls)


def dump_dataclass_jgzip(outfile: str, obj: Any) -> None:
    """Gzipped-json dump."""
    with gzip.open(outfile, "wb") as f:
        dump_dataclass(obj, f, binary=True)


def load_dataclass_jgzip(outfile, cls):
    """Gzipped-json typed load."""
    with gzip.open(outfile, "rb") as f:
        return load_dataclass(f, cls, binary=True)
