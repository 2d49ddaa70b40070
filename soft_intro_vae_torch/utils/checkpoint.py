"""Checkpoints of the 3D trainer (port of utils/checkpoint.py).

One ``torch.save`` file per checkpoint, named as the JAX trainer names them
(``model_epoch_{E}_iter_{I}{tag}.ckpt``, with the ``last_checkpoint``
pointer beside them and the reference's find-latest-epoch fallback,
train_soft_intro_vae_3d.py:444-449). The payload is

    {"model": state_dict in reference names, "opt_e", "opt_d",
     "epoch", "step", "lr_e", "lr_d", "rng": generator state}

so the ``model`` entry loads into the reference's nets, and into the JAX
package through its ``load_reference_3d_checkpoint``.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from soft_intro_vae_torch.train.state import TrainState


class Checkpointer:
    POINTER = "last_checkpoint"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, epoch: int, iteration: int, tag: str = "") -> str:
        name = f"model_epoch_{epoch}_iter_{iteration}{tag}.ckpt"
        return os.path.join(self.directory, name)

    def save(self, state: TrainState, epoch: int, iteration: int = 0, tag: str = "") -> str:
        path = self._path(epoch, iteration, tag)
        payload = {
            "model": state.model.state_dict(),
            "opt_e": state.opt_e.state_dict(),
            "opt_d": state.opt_d.state_dict(),
            "epoch": epoch,
            "step": state.step,
            "lr_e": state.lr_e,
            "lr_d": state.lr_d,
            "rng": state.generator.get_state(),
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.directory, self.POINTER), "w") as f:
            f.write(os.path.basename(path))
        return path

    def latest_path(self) -> Optional[str]:
        ptr = os.path.join(self.directory, self.POINTER)
        if os.path.exists(ptr):
            with open(ptr) as f:
                path = os.path.join(self.directory, f.read().strip())
            if os.path.exists(path):
                return path
        # fall back to scanning epoch-numbered files (3D find_latest_epoch)
        best, best_key = None, (-1, -1)
        pat = re.compile(r"model_epoch_(\d+)_iter_(\d+).*\.ckpt$")
        if os.path.isdir(self.directory):
            for name in os.listdir(self.directory):
                m = pat.search(name)
                if m:
                    key = (int(m.group(1)), int(m.group(2)))
                    if key > best_key:
                        best, best_key = os.path.join(self.directory, name), key
        return best

    def load_latest(self, state: TrainState) -> Optional[Tuple[TrainState, int]]:
        """Restore the latest checkpoint into ``state`` in place; returns
        (state, epoch), or None when there is none."""
        path = self.latest_path()
        if path is None:
            return None
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.opt_e.load_state_dict(payload["opt_e"])
        state.opt_d.load_state_dict(payload["opt_d"])
        state.generator.set_state(payload["rng"])
        state.step = int(payload["step"])
        state.set_lr(float(payload["lr_e"]), float(payload["lr_d"]))
        return state, int(payload["epoch"])
