"""Loss tracking: running means -> CSV (copy of soft_intro_vae_tpu/utils/tracker.py).

Capability parity with the style variant's LossTracker
(reference style_soft_intro_vae/tracker.py:63-147): named running-mean
accumulators, ``register_means(epoch)`` appends a row and rewrites log.csv.
``plot()`` is a no-op returning None without matplotlib (the card's machine
has none). Call ``update`` with already-fetched (host) metrics to avoid
per-iteration device syncs.
"""

from __future__ import annotations

import csv
import os
from collections import OrderedDict
from typing import Dict, List, Mapping


class RunningMean:
    __slots__ = ("_sum", "_n")

    def __init__(self):
        self._sum = 0.0
        self._n = 0

    def add(self, v: float):
        self._sum += float(v)
        self._n += 1

    def mean(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def reset(self):
        self._sum, self._n = 0.0, 0


class LossTracker:
    def __init__(self, output_dir: str = ".", filename: str = "log.csv"):
        self.output_dir = output_dir
        self.filename = filename
        self.means: "OrderedDict[str, RunningMean]" = OrderedDict()
        self.history: Dict[str, List[float]] = OrderedDict()
        self.epochs: List[int] = []
        os.makedirs(output_dir, exist_ok=True)

    def update(self, metrics: Mapping[str, float]):
        for k, v in metrics.items():
            self.means.setdefault(k, RunningMean()).add(float(v))

    def register_means(self, epoch: int):
        self.epochs.append(epoch)
        for k, rm in self.means.items():
            # sparse metrics (e.g. FID every N epochs) record nan, not a
            # fabricated 0.0, on epochs where nothing was accumulated
            self.history.setdefault(k, []).append(rm.mean() if rm._n else float("nan"))
            rm.reset()
        # pad series that appeared late
        for k, series in self.history.items():
            while len(series) < len(self.epochs):
                series.insert(0, float("nan"))
        self._write_csv()

    def _write_csv(self):
        path = os.path.join(self.output_dir, self.filename)
        keys = list(self.history.keys())
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["epoch"] + keys)
            for i, ep in enumerate(self.epochs):
                w.writerow([ep] + [self.history[k][i] for k in keys])

    def mean(self, key: str) -> float:
        return self.means[key].mean() if key in self.means else float("nan")

    def plot(self, filename: str = "plot.png"):
        """The loss curves as one figure; the path, or None without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # matplotlib is optional
            return None
        fig, ax = plt.subplots(figsize=(10, 6))
        for k, series in self.history.items():
            ax.plot(self.epochs, series, label=k)
        ax.legend()
        ax.set_xlabel("epoch")
        path = os.path.join(self.output_dir, filename)
        fig.savefig(path)
        plt.close(fig)
        return path

    def save_pickle(self, filename: str = "train_graphs_data.pickle") -> str:
        """End-of-run loss-curve pickle (reference train_soft_intro_vae.py:695-697)."""
        import pickle

        path = os.path.join(self.output_dir, filename)
        with open(path, "wb") as fp:
            pickle.dump(self.history, fp)
        return path

    def state_dict(self) -> dict:
        return {"epochs": self.epochs, "history": self.history}

    def load_state_dict(self, sd: dict):
        self.epochs = list(sd.get("epochs", []))
        self.history = OrderedDict((k, list(v)) for k, v in sd.get("history", {}).items())
