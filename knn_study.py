#!/usr/bin/env python3
"""Sweep how many ranges the KNN kernel (#9) cuts its database into, or
time its D = 3 build against the runtime-D loop, on one CUDA card.

    python3 knn_study.py
    python3 knn_study.py --runtime-d

`knn_ranges` (pytorch3d_tpu_torch/ops/knn.py) grows the number of ranges S
until the grid holds `WAVES[K bucket]` blocks per SM, each range at least
`MIN_RANGE` points long.  This script sets WAVES to 1, 2, 4, 8, 16 and 32
blocks an SM for every bucket in turn and times `knn_points_cuda` by the
profiler's device time (`chip_smoke.knn_device_ms`: stage 1 and the
merge) at the paths' shapes: the chamfer fit's 5000 x 5000 and the points
fit's 30 000 x 30 000 at K=1 (`chip_smoke.chamfer_clouds`,
`chip_smoke.points_fit_clouds`), and 16384 x 16384 uniform points at K=4, 8
and 16.  Each result is checked against `knn_points_plain` (ids and
distances equal).  The package's own choice is printed last.

`--runtime-d`: `csrc/knn.cu` instantiates its kernels for D = 3 beside the
loop to a runtime D <= 8.  This builds a copy without the D = 3
instantiation into `build/knn_study/` and times it in the package's place
at the same shapes (all D = 3), in the order package, copy, copy, package.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
D3_BRANCH = """  if (D == 3) {
    if (l1) P3D_LAUNCH(3, true);
    P3D_LAUNCH(3, false);
  }
"""


def runtime_d_library():
    """A build of csrc/knn.cu without its D = 3 instantiation."""
    from pytorch3d_tpu_torch import _build

    text = (REPO / "pytorch3d_tpu_torch" / "csrc" / "knn.cu").read_text()
    if D3_BRANCH not in text:
        raise SystemExit("knn_study: csrc/knn.cu has no D = 3 branch to take out")
    return _build.build_copy("knn", "knn_runtime_d", text.replace(D3_BRANCH, ""), REPO / "build" / "knn_study")[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runtime-d", action="store_true", help="the D = 3 build against the runtime-D loop")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("knn_study: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from pytorch3d_tpu_torch.ops import knn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    device = torch.device("cuda")
    src, tgt = cs.chamfer_clouds(device)
    psrc, ptgt = cs.points_fit_clouds(cs.PointsFit(device))
    gen = torch.Generator(device=device).manual_seed(1)
    big1 = torch.rand((1, 16384, 3), generator=gen, device=device)
    big2 = torch.rand((1, 16384, 3), generator=gen, device=device)
    shapes = [("chamfer 5000x5000 K=1", src, tgt, 1), ("points-fit 30000x30000 K=1", psrc, ptgt, 1),
              ("16384x16384 K=4", big1, big2, 4), ("16384x16384 K=8", big1, big2, 8),
              ("16384x16384 K=16", big1, big2, 16)]
    want = {label: knn.knn_points_plain(p1, p2, None, k) for label, p1, p2, k in shapes}
    if args.runtime_d:
        package = knn._library()
        copy = runtime_d_library()
        copy.knn_points.argtypes = package.knn_points.argtypes
        copy.knn_points.restype = ctypes.c_int
        for name, lib in (("package (D = 3 build)", package), ("runtime D", copy), ("runtime D", copy),
                          ("package (D = 3 build)", package)):
            knn._library = lambda lib=lib: lib
            row = []
            for label, p1, p2, k in shapes:
                d, i = knn.knn_points_cuda(p1, p2, None, k)
                same = torch.equal(i, want[label][1]) and torch.equal(d, want[label][0])
                stages = cs.knn_device_ms(p1, p2, k)
                row.append(f"[{label}] {sum(stages.values()):.4f} ms equal to plain {same}")
            print(f"{name}: " + "; ".join(row), flush=True)
        knn._library = lambda: package
        return 0
    package = dict(knn.WAVES)
    for waves in (1, 2, 4, 8, 16, 32, None):
        knn.WAVES = package if waves is None else dict.fromkeys(package, waves)
        row = []
        for label, p1, p2, k in shapes:
            d, i = knn.knn_points_cuda(p1, p2, None, k)
            same = torch.equal(i, want[label][1]) and torch.equal(d, want[label][0])
            stages = cs.knn_device_ms(p1, p2, k)
            S, L = cs.knn_cut(p1, p2, k)
            row.append(f"[{label}] S={S} L={L} {sum(stages.values()):.4f} ms (merge"
                       f" {stages.get('knn_merge_kernel', 0.0):.4f}) equal to plain {same}")
        print(f"waves {'package ' + str(package) if waves is None else waves}: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
