"""ctypes bindings to the port's native OBJ parser (`csrc/fast_io.cpp`;
port of pytorch3d_tpu/io/fast_io.py).

The source is compiled with g++ on first use into `build/host/` at the root
of the checkout, named by a hash of the source, the flags, the compiler's
version, the machine and its C library (as `_build.py` names the kernels),
so an edited source or another host builds its own library and an unchanged
one is reused; nothing is written into the package.  Where g++ is missing or the
build fails, `fast_parse_obj` returns None and `load_obj` takes the
pure-Python scanner, which is also the oracle in the tests.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .._build import BUILD_DIR as _KERNEL_DIR
from .._build import CSRC_DIR

SOURCE = CSRC_DIR / "fast_io.cpp"
BUILD_DIR = _KERNEL_DIR.parent / "host"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


@functools.lru_cache(maxsize=None)
def _toolchain() -> str:
    """The compiler's version, the machine and its C library: what the
    binary depends on besides its source and flags."""
    gxx = shutil.which("g++")
    version = ""
    if gxx is not None:
        try:
            version = subprocess.run([gxx, "-dumpfullversion"], capture_output=True, text=True, timeout=30).stdout
        except (subprocess.SubprocessError, OSError):
            pass
    return " ".join((version.strip(), platform.machine(), *platform.libc_ver()))


def library_path() -> Path:
    key = SOURCE.read_bytes() + " ".join((*GXX_FLAGS, _toolchain())).encode()
    return BUILD_DIR / f"libfast_io-{hashlib.sha1(key).hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The built library's path (built first if needed), or None where g++
    is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp], check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        for fn in ("obj_num_verts", "obj_num_faces", "obj_num_uvs", "obj_num_normals"):
            getattr(lib, fn).restype = ctypes.c_size_t
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("obj_has_face_uvs", "obj_has_face_normals", "obj_error"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.obj_error_line.restype = ctypes.c_long
        lib.obj_error_line.argtypes = [ctypes.c_void_p]
        for fn, ct in (
            ("obj_copy_verts", ctypes.c_float),
            ("obj_copy_uvs", ctypes.c_float),
            ("obj_copy_normals", ctypes.c_float),
            ("obj_copy_faces", ctypes.c_int32),
            ("obj_copy_face_uvs", ctypes.c_int32),
            ("obj_copy_face_normals", ctypes.c_int32),
        ):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.POINTER(ct)]
        lib.obj_free.restype = None
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native parser built and loaded."""
    return _get_lib() is not None


# Error code -> message, with the Python scanner's phrasing, so callers can
# match on substrings whichever parser ran.
_OBJ_ERRORS = {
    1: "Vertex does not have 3 values. Line: %d",
    2: "Texture does not have 2 values. Line: %d",
    3: "Normal does not have 3 values. Line: %d",
    4: "Face vertices can only have 3 properties. Line: %d",
    5: "Vertex properties are inconsistent. Line: %d",
}


def _copy(lib, fn, h, shape, dtype, ctype):
    out = np.empty(shape, dtype)
    getattr(lib, fn)(h, out.ctypes.data_as(ctypes.POINTER(ctype)))
    return out


def fast_parse_obj(text: bytes):
    """Parse OBJ text natively.

    Returns dict(verts (V, 3) float32, faces (F, 3) int32, uvs, normals,
    faces_uv, faces_n) as numpy arrays (None entries where absent), or None
    if the native library is unavailable.  Raises ValueError on malformed
    input with the Python scanner's message phrasing.
    """
    lib = _get_lib()
    if lib is None:
        return None
    h = lib.obj_parse(text, len(text))
    try:
        err = lib.obj_error(h)
        if err:
            msg = _OBJ_ERRORS.get(err, "Malformed OBJ. Line: %d")
            raise ValueError(msg % lib.obj_error_line(h))
        nv, nf = lib.obj_num_verts(h), lib.obj_num_faces(h)
        nuv, nn = lib.obj_num_uvs(h), lib.obj_num_normals(h)
        f32, i32 = ctypes.c_float, ctypes.c_int32
        verts = _copy(lib, "obj_copy_verts", h, (nv, 3), np.float32, f32) if nv else np.empty((0, 3), np.float32)
        faces = _copy(lib, "obj_copy_faces", h, (nf, 3), np.int32, i32) if nf else np.empty((0, 3), np.int32)
        uvs = _copy(lib, "obj_copy_uvs", h, (nuv, 2), np.float32, f32) if nuv else None
        normals = _copy(lib, "obj_copy_normals", h, (nn, 3), np.float32, f32) if nn else None
        faces_uv = _copy(lib, "obj_copy_face_uvs", h, (nf, 3), np.int32, i32) if lib.obj_has_face_uvs(h) else None
        faces_n = _copy(lib, "obj_copy_face_normals", h, (nf, 3), np.int32, i32) if lib.obj_has_face_normals(h) else None
        return {"verts": verts, "faces": faces, "uvs": uvs, "normals": normals, "faces_uv": faces_uv, "faces_n": faces_n}
    finally:
        lib.obj_free(h)
