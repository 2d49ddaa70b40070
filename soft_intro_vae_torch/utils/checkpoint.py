"""Checkpoints of the port's trainers (port of utils/checkpoint.py).

One ``torch.save`` file per checkpoint, named as the JAX trainers name them
(``{prefix}model_epoch_{E}_iter_{I}{tag}.ckpt``), with the ``last_checkpoint``
pointer beside them and the reference's find-latest-epoch fallback
(train_soft_intro_vae_3d.py:444-449). The payload is the train state's
``state_dict()`` plus ``epoch`` and ``iteration``:

  * 3D, image and bootstrap (``train.state.TrainState``): {"model":
    state_dict in reference names, "opt_e", "opt_d", "step", "lr_e", "lr_d",
    "rng"}, so the ``model`` entry loads into the reference's nets, and into
    the JAX package through its ``load_reference_3d_checkpoint`` /
    ``load_reference_image_checkpoint`` (a bootstrap model's
    ``target_decoder.`` entries included); the image trainer names its files
    ``{dataset}_soft_intro_betas_{beta_kl}_{beta_neg}_{beta_rec}_model_...``;
  * style (``train.style_step.StyleTrainState``): {"nets", "ema", "opt_e",
    "opt_d", "step", "lr", "ema_beta", "rng"}.

``aux`` is JSON-serialisable host-side training state (tracker history,
LODs seen, whether the epoch completed) written to a ``.aux.json`` sidecar,
as the JAX Checkpointer writes it (the reference Checkpointer's auxiliary
dict, checkpointer.py:23-36). Saves are synchronous: the state lives on the
device, and copying it to the host is most of a save's work.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Tuple

import torch


class Checkpointer:
    POINTER = "last_checkpoint"

    def __init__(self, directory: str, prefix: str = ""):
        self.directory = directory
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)

    def _path(self, epoch: int, iteration: int, tag: str = "") -> str:
        name = f"{self.prefix}model_epoch_{epoch}_iter_{iteration}{tag}.ckpt"
        return os.path.join(self.directory, name)

    def save(self, state: Any, epoch: int, iteration: int = 0, tag: str = "",
             aux: Optional[dict] = None) -> str:
        path = self._path(epoch, iteration, tag)
        payload = {**state.state_dict(), "epoch": epoch, "iteration": iteration}
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if aux is not None:
            with open(path + ".aux.json.tmp", "w") as f:
                json.dump(aux, f)
            os.replace(path + ".aux.json.tmp", path + ".aux.json")
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

    def load_latest(self, state: Any) -> Optional[Tuple[Any, int]]:
        """Restore the latest checkpoint into ``state`` in place; returns
        (state, epoch), or None when there is none."""
        path = self.latest_path()
        if path is None:
            return None
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state.load_state_dict(payload)
        return state, int(payload["epoch"])

    def latest_aux(self) -> Optional[dict]:
        path = self.latest_path()
        if path is None or not os.path.exists(path + ".aux.json"):
            return None
        with open(path + ".aux.json") as f:
            return json.load(f)


def load_pretrained(path: str, state: Any) -> int:
    """Restore ``path`` into ``state`` in place; returns its epoch.

    ``path`` is either a port checkpoint (the train state's payload, written
    by ``Checkpointer.save``) or a reference ``.pth`` ({"epoch", "model"},
    train_soft_intro_vae.py:321-329), whose ``model`` state_dict in the
    reference's names loads strictly into ``state.model``.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "opt_e" in payload:
        state.load_state_dict(payload)
    else:
        state.model.load_state_dict(payload.get("model", payload), strict=True)
    return int(payload.get("epoch", 0))
