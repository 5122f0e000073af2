"""Training statistics (port of pytorch3d_tpu/implicitron/tools/stats.py):
plain Python, the JAX package's code.  `state_dict`, `save` and `load` write
and read the same JSON keys, so a stats file from either package loads in
the other.  `plot_stats` plots through visdom when given a connection and
writes a matplotlib PNG only when a plot file is named.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class AverageMeter:
    """Running average with a per-epoch history of the values."""

    def __init__(self) -> None:
        self.history: List[List[float]] = []
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: int = 1, epoch: int = 0) -> None:
        while len(self.history) <= epoch:
            self.history.append([])
        self.history[epoch].append(val / n)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def get_epoch_averages(self, epoch: int = -1):
        if len(self.history) == 0:
            return None
        if epoch == -1:
            return [
                (sum(h) / max(len(h), 1)) if len(h) > 0 else float("nan")
                for h in self.history
            ]
        h = self.history[epoch]
        return sum(h) / max(len(h), 1) if len(h) > 0 else float("nan")

    def fill_undefined(self, max_epoch=None):
        pass


class Stats:
    """Per-epoch statistics of named values, per stat set ("train", "val", ...)."""

    def __init__(
        self,
        log_vars: List[str],
        verbose: bool = False,
        epoch: int = -1,
        plot_file: Optional[str] = None,
    ) -> None:
        self.log_vars = log_vars
        self.verbose = verbose
        self.plot_file = plot_file
        self.hard_reset(epoch=epoch)

    def hard_reset(self, epoch: int = -1) -> None:
        self.epoch = epoch
        self.stats: Dict[str, Dict[str, AverageMeter]] = {}
        self.it: Dict[str, int] = {}
        self._epoch_start = None

    def new_epoch(self) -> None:
        self.epoch += 1
        self.it = {k: 0 for k in self.it}
        for stat_set in self.stats.values():
            for meter in stat_set.values():
                meter.reset()
        self._epoch_start = time.time()

    def update(self, preds: Dict, stat_set: str = "train") -> None:
        if stat_set not in self.stats:
            self.stats[stat_set] = {}
            self.it[stat_set] = 0
        self.it[stat_set] += 1
        epoch = max(self.epoch, 0)
        for k in self.log_vars:
            if k == "sec/it":
                if self._epoch_start is not None:
                    val = (time.time() - self._epoch_start) / max(
                        self.it[stat_set], 1
                    )
                else:
                    val = 0.0
            elif k in preds:
                v = preds[k]
                try:
                    val = float(v)
                except (TypeError, ValueError):
                    continue
            else:
                continue
            if k not in self.stats[stat_set]:
                self.stats[stat_set][k] = AverageMeter()
            self.stats[stat_set][k].update(val, epoch=epoch)

    def get_status_string(self, stat_set: str = "train", max_it=None) -> str:
        it = self.it.get(stat_set, 0)
        parts = [f"[{stat_set}] epoch {self.epoch} it {it}"]
        if max_it:
            parts[0] += f"/{max_it}"
        for k, meter in self.stats.get(stat_set, {}).items():
            parts.append(f"{k}: {meter.avg:.5f}")
        return " | ".join(parts)

    def print(self, stat_set: str = "train", max_it=None) -> None:
        print(self.get_status_string(stat_set, max_it))

    def plot_stats(
        self,
        viz=None,
        plot_file: Optional[str] = None,
        visdom_env: Optional[str] = None,
    ) -> None:
        """Plot per-epoch averages of every log_var across stat sets.  With a
        visdom connection `viz` plots there; writes a matplotlib PNG when
        `plot_file` (or self.plot_file) is set, and needs matplotlib only
        then."""
        plot_file = plot_file or self.plot_file
        novisdom = viz is None or not getattr(viz, "check_connection", lambda: False)()
        histories = {
            ss: {
                k: m.get_epoch_averages()
                for k, m in d.items()
            }
            for ss, d in self.stats.items()
        }
        if not novisdom:
            for stat, per_set in self._stat_series(histories).items():
                for ss, ys in per_set.items():
                    viz.line(
                        ys,
                        X=list(range(len(ys))),
                        env=visdom_env or "main",
                        win=f"stat_plot_{stat}",
                        name=ss,
                        update="replace",
                        opts={"title": stat, "legend": list(per_set)},
                    )
        if plot_file:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            series = self._stat_series(histories)
            n = max(len(series), 1)
            fig, axes = plt.subplots(
                n, 1, figsize=(6, 2.2 * n), squeeze=False
            )
            for ax, (stat, per_set) in zip(axes[:, 0], series.items()):
                for ss, ys in per_set.items():
                    ax.plot(ys, label=ss)
                ax.set_title(stat, fontsize=8)
                ax.legend(fontsize=6)
                ax.grid(True, alpha=0.3)
            fig.tight_layout()
            fig.savefig(plot_file, dpi=110)
            plt.close(fig)

    def _stat_series(self, histories):
        out: Dict[str, Dict[str, list]] = {}
        for ss, d in histories.items():
            for k, ys in d.items():
                if ys is None:
                    continue
                ys = [y for y in ys if y is not None]
                if ys:
                    out.setdefault(k, {})[ss] = ys
        return out

    # serialization (pickle-free; JSON of histories)
    def state_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "log_vars": self.log_vars,
            "histories": {
                ss: {k: m.history for k, m in d.items()}
                for ss, d in self.stats.items()
            },
        }

    def load_state_dict(self, state: Dict) -> None:
        self.epoch = state["epoch"]
        self.log_vars = state["log_vars"]
        self.stats = {}
        self.it = {}
        for ss, d in state["histories"].items():
            self.stats[ss] = {}
            self.it[ss] = 0
            for k, hist in d.items():
                m = AverageMeter()
                m.history = hist
                self.stats[ss][k] = m

    def save(self, path: str) -> None:
        """JSON dump; gzipped when the path ends with .jgz (PyTorch3D's stats
        archive format)."""
        if str(path).endswith(".jgz"):
            import gzip

            with gzip.open(path, "wt") as f:
                json.dump(self.state_dict(), f)
        else:
            with open(path, "w") as f:
                json.dump(self.state_dict(), f)

    @classmethod
    def load(cls, path: str) -> "Stats":
        if str(path).endswith(".jgz"):
            import gzip

            with gzip.open(path, "rt") as f:
                state = json.load(f)
        else:
            with open(path) as f:
                state = json.load(f)
        stats = cls(log_vars=state["log_vars"])
        stats.load_state_dict(state)
        return stats


class StatsJSONEncoder(json.JSONEncoder):
    """JSON encoder that writes Stats and AverageMeter objects."""

    def default(self, o):
        if isinstance(o, (AverageMeter, Stats)):
            return self.encode(o.__dict__)
        raise TypeError(
            f"Object of type {o.__class__.__name__} is not JSON serializable"
        )
