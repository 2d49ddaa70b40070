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
dict, checkpointer.py:23-36).

``save(..., async_save=True)`` writes on a thread, as the JAX Checkpointer
does (soft_intro_vae_tpu/utils/checkpoint.py:102-150): before ``save``
returns, the state is copied to host memory and ``aux`` is deep-copied, so
the file holds the state at the call even when the trainer updates its
tensors in place afterwards (a CUDA graph's replay does). The copy is a
synchronous ``.to("cpu")`` of every tensor, never a ``non_blocking`` copy
into pinned memory, which the next replay could overtake. Every save first
waits for the one in flight, so two saves never race on the pointer file;
``wait()`` drains the last one, and the trainers call it before they return.
A file of an async save holds the same tensors as a synchronous save's, not
the same bytes: ``torch.save`` writes a serialization id of its own into
every archive.

In a process group only rank 0 writes (the JAX package's
utils/checkpoint.py:119 and ``multihost.is_primary``); every rank loads, and
a checkpoint written under N ranks resumes under M: the state is the same
on every rank.
"""

from __future__ import annotations

import copy
import json
import os
import re
import threading
from typing import Any, Optional, Tuple

import torch

from soft_intro_vae_torch.parallel.multihost import is_primary


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` (dicts, lists, tuples, tensors, scalars) whose
    tensors are new CPU tensors, copied synchronously; containers keep their
    types, so the file is a synchronous save's."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):  # OrderedDict state_dicts keep their type and _metadata
        out = type(tree)((k, to_host(v)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = copy.deepcopy(tree._metadata)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return copy.deepcopy(tree)


class Checkpointer:
    POINTER = "last_checkpoint"

    def __init__(self, directory: str, prefix: str = ""):
        self.directory = directory
        self.prefix = prefix
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if is_primary():
            os.makedirs(directory, exist_ok=True)

    def _path(self, epoch: int, iteration: int, tag: str = "") -> str:
        name = f"{self.prefix}model_epoch_{epoch}_iter_{iteration}{tag}.ckpt"
        return os.path.join(self.directory, name)

    def save(self, state: Any, epoch: int, iteration: int = 0, tag: str = "",
             aux: Optional[dict] = None, async_save: bool = False) -> str:
        """Write ``state`` (and ``aux``) as checkpoint ``epoch``/``iteration``;
        with ``async_save`` on a thread, from a host snapshot (module doc)."""
        path = self._path(epoch, iteration, tag)
        if not is_primary():
            return path
        self.wait()
        payload = {**state.state_dict(), "epoch": epoch, "iteration": iteration}
        if async_save:
            payload, aux = to_host(payload), copy.deepcopy(aux)
            self._thread = threading.Thread(target=self._write_in_thread,
                                            args=(path, payload, aux), daemon=True)
            self._thread.start()
        else:
            self._write(path, payload, aux)
        return path

    def _write(self, path: str, payload: dict, aux: Optional[dict]) -> None:
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if aux is not None:
            with open(path + ".aux.json.tmp", "w") as f:
                json.dump(aux, f)
            os.replace(path + ".aux.json.tmp", path + ".aux.json")
        with open(os.path.join(self.directory, self.POINTER), "w") as f:
            f.write(os.path.basename(path))

    def _write_in_thread(self, path: str, payload: dict, aux: Optional[dict]) -> None:
        try:
            self._write(path, payload, aux)
        except Exception as e:  # raised again by wait(), in the caller's thread
            self._error = e

    def wait(self) -> None:
        """Block until the save in flight is written; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an async checkpoint save failed") from err

    def latest_path(self) -> Optional[str]:
        self.wait()  # the pointer of a save in flight is not written yet
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
