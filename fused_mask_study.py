"""The fused MLP kernels (#10-#13) against float64 over several inputs, on
one NVIDIA card.

chip_smoke.py holds the fused kernels to their plain versions on one set of
inputs per path.  Any float32 forward puts the ReLU pre-activations that lie
within its rounding of 0 on one side or the other: each float32 forward (the
kernel's, the float32 plain version's) disagrees with float64 at a few dozen
of the trunk path's 5.4e8 masks, and each such flip moves a weight gradient
by about one row's share.  This script reads, for the trunk path at several
test views and for a training step's coarse and fine launches at several
training views:
- the masks each float32 forward flips against float64 and against the
  other;
- per gradient tensor, how far from float64 (on float64's own masks) the
  kernel's backward is, and the float32 plain backward on its own masks
  and on the kernel forward's masks, each over the reference's largest
  entry;
and the NeRF step-0 fine-field reading of chip_smoke.py's nerf-train phase
(the fused path against use_fused_kernel=False on one shared fine bundle) at
several draw seeds, with each path's distance from the plain path run in
float64 beside it.

    python3 fused_mask_study.py [--tree DIR] [--views N] [--draw-seeds S ...]

--tree runs another checkout's chip_smoke.py and port package (an earlier
commit unpacked with `git archive`, say), so that two versions can be read
in one call.  Prints one JSON object per reading.
"""

import argparse
import json
import sys
from pathlib import Path


def saved_masks(saved, N, H, L, Hh=0):
    """y > 0 of a saving forward's stored layer outputs (the trunk's last
    is out itself without a head), then with a head the colour layer's."""
    out, acts = saved
    NH = N * H
    ys = [acts[l * NH : (l + 1) * NH].view(N, H) for l in range(L if Hh else L - 1)]
    if not Hh:
        return [y > 0 for y in ys] + [out > 0]
    return [y > 0 for y in ys] + [acts[(L + 1) * NH : (L + 1) * NH + N * Hh].view(N, Hh) > 0]


def study(fm, gate, factor, x, de, ws, bs, head, skips, g):
    """One case's flips and per-tensor distances from float64 (see the
    module docstring).  `parent_gate` and `gate` are the largest share of
    its limit max(gate, factor * plain) that any weight or bias gradient of
    the kernel takes, with the float32 plain backward on its own masks and
    on the kernel forward's; `worst` is the tensor with the largest share
    of the first.  `reverse` is the first with the roles swapped: the plain
    backward on its own masks held to the kernel's."""
    import torch

    f64 = lambda ts: [t.double() for t in ts]
    N, H, L = x.shape[0], ws[0].shape[1], len(ws)
    x64, ws64, bs64, g64 = x.double(), f64(ws), f64(bs), g.double()
    if head is None:
        saved = fm.fused_mlp_cuda(x, ws, bs, skips, save=True)
        dx, dws, dbs = fm.fused_mlp_grad_cuda(x, ws, bs, skips, g, saved=saved)
        kernel = [dx, *dws, *dbs]
        km = saved_masks(saved, N, H, L)
        pm, em = fm.relu_masks(x, ws, bs, skips), fm.relu_masks(x64, ws64, bs64, skips)
        grad = lambda masks: fm.fused_mlp_grad_plain(x, ws, bs, skips, g, masks)
        flat = lambda e: [e[0], *e[1], *e[2]]
        exact = flat(fm.fused_mlp_grad_plain(x64, ws64, bs64, skips, g64))
        names = ["dx", *(f"W{i}" for i in range(L)), *(f"b{i}" for i in range(L))]
    else:
        saved = fm.nerf_field_cuda(x, de, ws, bs, head, skips, save=True)
        dx, dde, dws, dbs, dhead = fm.nerf_field_grad_cuda(x, de, ws, bs, head, skips, g, saved=saved)
        kernel = [dx, dde, *dws, *dbs, *dhead]
        km = saved_masks(saved, N, H, L, head[4].shape[1])
        de64, head64 = de.double(), f64(head)
        pm = fm.relu_masks(x, ws, bs, skips, de, head)
        em = fm.relu_masks(x64, ws64, bs64, skips, de64, head64)
        grad = lambda masks: fm.fused_nerf_field_grad_plain(x, de, ws, bs, head, skips, g, masks)
        flat = lambda e: [e[0], e[1], *e[2], *e[3], *e[4]]
        exact = flat(fm.fused_nerf_field_grad_plain(x64, de64, ws64, bs64, head64, skips, g64))
        names = ["dx", "dde", *(f"W{i}" for i in range(L)), *(f"b{i}" for i in range(L)),
                 "wd", "bd", "wi", "bi", "wc1a", "wc1b", "bc1", "wc2", "bc2"]
    torch.cuda.synchronize()
    plain_own, plain_kernel = flat(grad(None)), flat(grad(km))

    def ratio(a, ref):
        return float((a.double() - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)

    def flips(a, b):
        return sum(int((u != v).sum()) for u, v in zip(a, b))

    # dx and d d_embed are judged by rows in chip_smoke (one flipped unit
    # moves its row's entry by O(1)), the other tensors by their largest entry
    rows = {n: (ratio(k, e), ratio(p, e), ratio(q, e))
            for n, k, p, q, e in zip(names, kernel, plain_own, plain_kernel, exact) if n not in ("dx", "dde")}
    share = lambda i: max(r[0] / max(gate, factor * r[i]) for r in rows.values())
    worst = max(rows, key=lambda n: rows[n][0] / max(gate, factor * rows[n][1]))
    return {"flips": {"kernel vs float64": flips(km, em), "float32 plain vs float64": flips(pm, em),
                      "kernel vs float32 plain": flips(km, pm)},
            "worst": worst, "kernel": rows[worst][0], "plain own masks": rows[worst][1],
            "plain kernel masks": rows[worst][2], "parent_gate": share(1), "gate": share(2),
            "reverse": max(r[1] / max(gate, factor * r[0]) for r in rows.values())}


def step0_shared(cs, scene, seed):
    """The fine field's gradients on one shared fine bundle for step 0 with
    draws from `seed` (chip_smoke's phase_nerf_step0 with another draw
    seed): {"fused vs plain": the worst tensor's max |diff| over its max
    |grad|, the fused path against use_fused_kernel=False; "fused vs
    float64" and "plain vs float64": each against the plain path run in
    float64 on the same bundle}, each as (tensor, value)."""
    import copy

    import torch

    from pytorch3d_tpu_torch.models.nerf.utils import calc_mse, sample_images_at_mc_locs

    model, view, device = scene.model, scene.train_idx[0], scene.device
    draws = model.make_draws(1, True, torch.Generator(device=device).manual_seed(seed))
    fine, kept = model._renderer_fine_field, []
    handle = fine.register_forward_hook(lambda module, args, out: kept.append(args[0]))
    model.use_fused_kernel = True
    scene.loss(view, draws)
    handle.remove()
    bundle = kept[0]
    gt = sample_images_at_mc_locs(scene.images[view : view + 1], bundle.xys)

    def grads(field, bundle):
        field.zero_grad(set_to_none=True)
        rgb, w = model._raymarcher(*field(bundle))
        calc_mse(rgb + (1.0 - w.sum(dim=-1, keepdim=True)) * model.bg_color, gt).backward()
        return {n: p.grad.clone() for n, p in field.named_parameters()}

    fused = grads(fine, bundle)
    model.use_fused_kernel = False
    plain = grads(fine, bundle)
    model.use_fused_kernel = True
    model.zero_grad(set_to_none=True)
    ref = copy.deepcopy(fine).double()
    ref.use_fused_kernel = False
    exact = grads(ref, bundle.replace(**{k: getattr(bundle, k).double()
                                         for k in ("origins", "directions", "lengths", "xys")}))

    def worst(a, b):
        r = cs.grad_ratios(a, b)
        n = max(r, key=r.get)
        return n, r[n]

    return {"fused vs plain": worst(fused, plain), "fused vs float64": worst(fused, exact),
            "plain vs float64": worst(plain, exact)}


def trunk_inputs(scene, view):
    """chip_smoke's trunk path inputs (one serving chunk's coarse points) at
    test view `view`."""
    import torch

    from pytorch3d_tpu_torch.renderer.implicit import ray_bundle_to_ray_points

    field = scene.model._renderer_coarse_field
    with torch.no_grad():
        bundle = scene.model._raysampler(scene.camera(view), chunksize=4096, chunk_idx=0, training=False)
        x = field.harmonic_embedding_xyz(ray_bundle_to_ray_points(bundle))
    return x.reshape(-1, x.shape[-1]).contiguous(), field.mlp_xyz


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                    help="checkout whose chip_smoke.py and pytorch3d_tpu_torch to run")
    ap.add_argument("--views", type=int, default=4, help="test views (trunk) and training views (launches)")
    ap.add_argument("--draw-seeds", type=int, nargs="*", default=[7, 8, 9, 10, 11])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("fused_mask_study.py: no CUDA device")
    import chip_smoke as cs
    from pytorch3d_tpu_torch.ops import fused_mlp_cuda as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    scene = cs.NeRFScene(device)
    emit = lambda rec: print(json.dumps({"tree": args.tree, **rec}), flush=True)
    for seed in args.draw_seeds:
        emit({"reading": "nerf step 0, fine field on a shared bundle", "draw_seed": seed,
              **step0_shared(cs, scene, seed)})
    for i in range(args.views):
        x, mlp = trunk_inputs(scene, scene.test_idx[i])
        ws, bs = (list(t.detach() for t in ts) for ts in mlp.weights())
        g = torch.randn((x.shape[0], mlp.hidden_dim), generator=torch.Generator(device=device).manual_seed(5 + i),
                        device=device)
        emit({"reading": "trunk path", "view": scene.test_idx[i], "N": x.shape[0],
              **study(fm, cs.FUSED_GRAD_GATE, cs.FUSED_PLAIN_FACTOR, x, None, ws, bs, None, mlp.input_skips, g)})
        del x, g
        for name, (x, de, ws, bs, head, skips, g) in zip(("coarse", "fine"), scene.field_launches(scene.train_idx[i])):
            emit({"reading": f"training step's {name} launch", "view": scene.train_idx[i], "N": x.shape[0],
                  **study(fm, cs.FUSED_GRAD_GATE, cs.FUSED_PLAIN_FACTOR, x, de, ws, bs, head, skips, g)})
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
