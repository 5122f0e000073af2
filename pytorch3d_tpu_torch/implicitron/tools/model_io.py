"""Checkpoint save and load (port of pytorch3d_tpu/implicitron/tools/model_io.py).

A checkpoint is one `torch.save` file of `{"model": state_dict,
"optimizer": state_dict}` (where the JAX package writes an orbax
directory of its parameter and optimizer pytrees) at the same path,
`<exp_dir>/model_epoch_%08d`, so the naming helpers are the JAX
package's; the stats go beside it as gzipped JSON (`Stats.save`).
`torch.load` gives back the saved tensors bit for bit.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Any, Mapping, Optional, Tuple

import torch


def get_checkpoint(exp_dir: str, epoch: int) -> str:
    """The checkpoint path of `epoch`, as `safe_save_model` names it."""
    return os.path.join(exp_dir, "model_epoch_%08d" % epoch)


def find_last_checkpoint(exp_dir: str, any_path: bool = False, all_checkpoints: bool = False):
    """The latest checkpoint in `exp_dir` (None if there is none), or all
    of them in epoch order with `all_checkpoints`."""
    fls = sorted(glob.glob(os.path.join(glob.escape(exp_dir), "model_epoch_" + "[0-9]" * 8)))
    if len(fls) == 0:
        return None
    if all_checkpoints:
        return fls
    return fls[-1]


def parse_epoch_from_model_path(model_path: str) -> int:
    return int(re.findall(r"\d{8}", model_path)[-1])


def _remove(path: str) -> None:
    """Remove a checkpoint, a file here (a directory where the JAX package
    wrote it)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.isfile(path):
        os.remove(path)


def safe_save_model(
    model_state: Mapping[str, torch.Tensor],
    optimizer_state: Optional[Mapping[str, Any]],
    stats,
    exp_dir: str,
    epoch: int,
) -> str:
    """Save the model's and optimizer's state dicts, then the stats, as
    epoch `epoch` of `exp_dir`: written to a temporary path first and
    renamed, so an interrupted save leaves no half-written checkpoint."""
    os.makedirs(exp_dir, exist_ok=True)
    path = get_checkpoint(exp_dir, epoch)
    tmp = path + "_tmp"
    _remove(tmp)
    torch.save({"model": model_state, "optimizer": optimizer_state}, tmp)
    _remove(path)
    os.replace(tmp, path)
    if stats is not None:
        # The stats' name must be get_stats_path's: the loaders look it up.
        stats.save(get_stats_path(path))
    return path


def load_model(path: str, map_location=None) -> Tuple[Any, Any, Optional[Any]]:
    """(model state_dict, optimizer state_dict, Stats or None) saved by
    `safe_save_model` (or `save_model`: its optimizer state may be None)."""
    data = torch.load(path, map_location=map_location, weights_only=True)
    stats = load_stats(get_stats_path(path))
    return data["model"], data.get("optimizer"), stats


def purge_epoch(exp_dir: str, epoch: int) -> None:
    path = get_checkpoint(exp_dir, epoch)
    _remove(path)
    for f in (get_stats_path(path), path + "_stats.json"):
        if os.path.isfile(f):
            os.remove(f)


def get_model_path(fl) -> str:
    """The model file of a checkpoint stem: the stem itself."""
    return os.path.splitext(str(fl))[0]


def get_optimizer_path(fl) -> str:
    """The optimizer path of a checkpoint stem."""
    return "%s_opt" % os.path.splitext(str(fl))[0]


def get_stats_path(fl, eval_results: bool = False) -> str:
    """The stats (jgz) path of a checkpoint stem; with `eval_results`, the
    experiment's stats_test file."""
    fl = os.path.splitext(str(fl))[0]
    if eval_results:
        for postfix in ("_2", ""):
            flstats = os.path.join(os.path.dirname(fl), f"stats_test{postfix}.jgz")
            if os.path.isfile(flstats):
                return flstats
        return flstats
    return "%s_stats.jgz" % fl


def save_stats(stats, fl, cfg=None) -> str:
    """Save a Stats object beside a checkpoint stem."""
    flstats = get_stats_path(fl)
    stats.save(flstats)
    return flstats


def load_stats(flstats):
    """Load a Stats object, or None if the file is absent."""
    from .stats import Stats

    if not os.path.isfile(flstats):
        return None
    return Stats.load(flstats)


def save_model(model_state, stats, fl, optimizer_state=None, cfg=None):
    """Save the model's state dict (and the optimizer's, where given) and
    the stats under a checkpoint stem.  Returns (flstats, flmodel)."""
    flstats = get_stats_path(fl)
    flmodel = get_model_path(fl)
    torch.save({"model": model_state, "optimizer": optimizer_state}, flmodel)
    if stats is not None:
        stats.save(flstats)
    return flstats, flmodel
