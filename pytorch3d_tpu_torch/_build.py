"""Build the port's CUDA kernels from `csrc/` at first use.

A kernel source `csrc/<name>.cu` is compiled by `nvcc` into its own shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds).  Libraries go to `build/kernels/` at the root of
the checkout, named by a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# Per source, whether nvcc may fuse a*b+c into one FMA.  The rasterizers and
# KNN build with --fmad=false: every a*b+c stays a rounded multiply and a
# rounded add, as the plain PyTorch version computes it, so coverage at
# pixels on an edge, z ties and neighbour ranks break the same way on both.
# The fused MLP selects nothing: its sums run in another order than the
# plain version's anyway, so it builds with FMA, which doubles its fp32 peak.
FMAD = {"fused_mlp": True}


def nvcc_flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + ("--fmad=true" if FMAD.get(name, False) else "--fmad=false",)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin); the port's CUDA"
            " kernels are built from source at first use"
        )
    return path


def library_path(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(source.read_bytes() + " ".join(nvcc_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(source: Path, out: Path, flags) -> Tuple[float, str]:
    """nvcc `source` into the shared library `out`: the seconds it took and
    nvcc's output (ptxas registers and spills).  Raises RuntimeError with
    that output if nvcc fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(out), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {source.name}: nvcc exited {proc.returncode}\n{proc.stdout}")
    return time.perf_counter() - t0, proc.stdout


def build(name: str) -> Tuple[float, str]:
    """Compile `csrc/<name>.cu` unless its library is built already.

    Returns the seconds the build took (0.0 where the library existed) and
    nvcc's output.  Raises RuntimeError with that output if nvcc fails.
    """
    out = library_path(name)
    if out.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        result = _compile(CSRC_DIR / f"{name}.cu", Path(tmp), nvcc_flags(name))
    except RuntimeError:
        os.unlink(tmp)
        raise
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return result


def build_copy(name: str, label: str, text: str, out_dir: Path, extra: Tuple[str, ...] = ()):
    """Build `text`, a changed copy of `csrc/<name>.cu`, with that source's
    flags and `extra` into `out_dir/lib<label>.so` (the study scripts' copies
    of a kernel); returns the loaded library and nvcc's output."""
    out_dir.mkdir(parents=True, exist_ok=True)
    source = out_dir / f"{label}.cu"
    source.write_text(text)
    lib = out_dir / f"lib{label}.so"
    _, log = _compile(source, lib, nvcc_flags(name) + tuple(extra))
    return ctypes.CDLL(str(lib)), log


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
