"""Device time of the fused NeRF field (#12 forward, #13 backward) in two
checkouts, in turns in one call, on one NVIDIA card.

The row pass of #13 has a build of its own for inputs wider than 256
features (`fused_mlp_bwd_rows_kernel<HEAD, WIDE>` in csrc/fused_mlp.cu);
this script reads whether the narrow builds still time as an earlier
commit's, at the NeRF field's widths (8 trunk layers of 256 with the skip
at 5, a colour head of 128 fed 27 direction features) and N = 131 072 rows
(nerf-train's fine launch), at each input width asked for.

    python3 fused_wide_study.py --trees build/parent . . build/parent [--widths 39 455]

Each tree (a checkout, or an earlier commit unpacked with `git archive`)
runs in a process of its own, builds its own kernels and prints one line
per width: #12's and #13's device time (torch.profiler), #13's row and
weight passes apart.
"""

import argparse
import subprocess
import sys
from pathlib import Path

CODE = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
N, H, L, skips, Ddir, Hh = 131072, 256, 8, (5,), 27, 128
rows_pass = "fused_mlp_bwd_rows_kernel<true"  # <true> before the WIDE builds, <true, WIDE> after
names = ("fused_mlp_bwd_prep_kernel", rows_pass, "fused_mlp_bwd_weights_kernel", "fused_mlp_bwd_reduce_kernel")
for D in map(int, sys.argv[2:]):
    gen = torch.Generator(device=dev).manual_seed(1)

    def dense(i, o):
        lim = (6.0 / (i + o)) ** 0.5
        return ((torch.rand((i, o), generator=gen, device=dev) * 2 - 1) * lim,
                torch.randn((o,), generator=gen, device=dev) * 0.05)

    x = torch.rand((N, D), generator=gen, device=dev) * 2 - 1
    de = torch.rand((N, Ddir), generator=gen, device=dev) * 2 - 1
    ws, bs = map(list, zip(*[dense((D if l == 0 else H) + (D if l in skips else 0), H) for l in range(L)]))
    wd, bd = dense(H, 1)
    wi, bi = dense(H, H)
    wc1, bc1 = dense(H + Ddir, Hh)
    wc2, bc2 = dense(Hh, 3)
    head = (wd, bd, wi, bi, wc1[:H].contiguous(), wc1[H:].contiguous(), bc1, wc2, bc2)
    g = torch.randn((N, 4), generator=gen, device=dev)
    saved = fm.nerf_field_cuda(x, de, ws, bs, head, skips, save=True)
    fwd = cs.device_ms(lambda: fm.nerf_field_cuda(x, de, ws, bs, head, skips),
                       ("fused_mlp_fwd_kernel<true, false>", "fused_mlp_fwd_prep_kernel"), iters=20, warmup=3)
    bwd = cs.device_ms_by_kernel(lambda: fm.nerf_field_grad_cuda(x, de, ws, bs, head, skips, g, saved=saved),
                                 names, 10, 2)
    print(f"RESULT {sys.argv[1]} D={D}: #12 {fwd:.4f} ms; #13 {sum(bwd.values()):.4f} ms"
          f" (rows {bwd[rows_pass]:.4f}, weights {bwd[names[2]]:.4f})", flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."], help="checkouts, run in this order")
    ap.add_argument("--widths", type=int, nargs="+", default=[39], help="input widths D")
    args = ap.parse_args()
    failed = False
    for tree in args.trees:
        run = subprocess.run([sys.executable, "-c", CODE, tree, *map(str, args.widths)],
                             cwd=Path(tree).resolve(), capture_output=True, text=True)
        lines = [line for line in run.stdout.splitlines() if line.startswith("RESULT")]
        if run.returncode or len(lines) != len(args.widths):
            print(f"{tree} failed:\n{run.stderr[-3000:]}", flush=True)
            failed = True
        for line in lines:
            print(line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
