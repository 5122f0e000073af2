"""The NeRFormer step-0 witness of `chip_smoke.py` under several cuDNN
settings, on one NVIDIA card: what moves a float32 gradient of the
view-pooled model away from float64.

repro_singleseq_nerformer's model at full width (seed 22) and the batch of
the nerformer phase (5 of the provider's 400^2 frames) go through
`chip_smoke.pooled_witness` once per setting: cuDNN's deterministic
algorithms without TF32 (what the phase runs), its other algorithms without
TF32, TF32 (what `torch.backends.cudnn.flags` turns on unless told not
to), and PyTorch's own convolutions (cuDNN off).  Each prints, floored at
`GRAD_FLOOR` of the largest gradient, the worst gradients of float32
against float64 on the float32 extractor's ReLU masks and max-pool picks,
against float64 on its own choices, and what the flipped choices alone
move in float64, with the number of flips.

    python3 witness_study.py
"""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SETTINGS = (
    ("cuDNN deterministic, no TF32", dict(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)),
    ("cuDNN nondeterministic, no TF32", dict(enabled=True, benchmark=False, deterministic=False, allow_tf32=False)),
    ("cuDNN with TF32", dict(enabled=True, benchmark=False, deterministic=False, allow_tf32=True)),
    ("cuDNN off", dict(enabled=False)),
)


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("witness_study: no CUDA device", file=sys.stderr)
        return 1
    _, card = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    scene = cs.ImplicitronScene(torch.device("cuda"))
    model = scene.model(22, cs.NERFORMER_MODEL)
    order = np.random.RandomState(20).permutation(len(scene.train))
    batch = cs.frames_batch([scene.train[int(i)] for i in order[: cs.NERFORMER_IMAGES]])
    image = batch["image_rgb"] * (batch["fg_probability"] >= 0.5)
    flags = torch.backends.cudnn.flags

    def top(ratios):
        return ", ".join(f"{n} {ratios[n]:.3e}" for n in sorted(ratios, key=ratios.get, reverse=True)[:3])

    for label, setting in SETTINGS:
        torch.backends.cudnn.flags = lambda *args, _s=setting, **kwargs: flags(**_s)
        t0 = time.perf_counter()
        try:
            _, (loss32, loss64), choices, own, flipped, flips = cs.pooled_witness(model, batch, image, 8)
        finally:
            torch.backends.cudnn.flags = flags
        print(f"witness [{label}, {card}]: loss relative {abs(loss32 - loss64) / abs(loss64):.3e}; {flips} flips;"
              f" on float32's choices: {top(choices)}; on its own: {top(own)}; the flips alone: {top(flipped)};"
              f" {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
