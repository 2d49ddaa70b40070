"""Checkpoints of the port's trainers (port of utils/checkpoint.py).

One ``torch.save`` file per checkpoint, named as the JAX trainers name them
(``{prefix}model_epoch_{E}_iter_{I}{tag}.ckpt``), with the ``last_checkpoint``
pointer beside them and the reference's find-latest-epoch fallback
(train_soft_intro_vae_3d.py:444-449). The payload is the train state's
``state_dict()`` plus ``epoch``, ``iteration`` and ``extra``:

  * 3D, image and bootstrap (``train.state.TrainState``): {"model":
    state_dict in reference names, "opt_e", "opt_d", "step", "lr_e", "lr_d",
    "rng"}, so the ``model`` entry loads into the reference's nets, and into
    the JAX package through its ``load_reference_3d_checkpoint`` /
    ``load_reference_image_checkpoint`` (a bootstrap model's
    ``target_decoder.`` entries included); the image trainer names its files
    ``{dataset}_soft_intro_betas_{beta_kl}_{beta_neg}_{beta_rec}_model_...``;
  * style (``train.style_step.StyleTrainState``): {"nets", "ema", "opt_e",
    "opt_d", "step", "lr", "ema_beta", "rng"}.

``save_checkpoint``/``load_checkpoint`` (JAX utils/checkpoint.py:59-84) are
the one serialization path: they write and read any state with
``state_dict()``/``load_state_dict()`` (the trainers' states, a module, an
optimizer), with ``epoch``, ``iteration`` and ``extra`` (a dict of plain
values) beside the state's entries, atomically (a ``.tmp`` file, then
``os.replace``); ``Checkpointer`` and ``load_pretrained`` go through them.
The JAX payload nests the state under ``state``; here its entries stay at
the top level, where a reference ``.pth`` keeps ``model``. Files without
``iteration`` or ``extra`` (a reference ``.pth``) load with 0 and {}.

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

Every reader (``load_checkpoint``, ``Checkpointer.load_latest``,
``load_pretrained``, and through them the trainers' ``resume`` and
``pretrained``, eval_3d and figures) also takes the JAX package's files:
flax msgpack of its whole train state (utils/flax_msgpack.py), carried into
the target state by utils/from_jax.py ``checkpoint_payload_from_jax``. The
format is told by the file's first bytes, a torch zip archive or a msgpack
map; a file in neither raises, and so does a JAX tree that does not match
the target (nothing is loaded then). The names, the pointer file and the
``.aux.json`` sidecar are the same in both packages, so a JAX run's
directory resumes as it is. Writing the JAX format is left out: the JAX
package reads the port's files (its utils/torch_compat.py).
"""

from __future__ import annotations

import copy
import json
import os
import re
import threading
from typing import Any, Optional, Tuple

import torch

from soft_intro_vae_torch.models.lreq import LreqConv2d, LreqConvTranspose2d, LreqDense
from soft_intro_vae_torch.parallel.multihost import is_primary
from soft_intro_vae_torch.utils import flax_msgpack
from soft_intro_vae_torch.utils.from_jax import checkpoint_payload_from_jax


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


_META = ("epoch", "iteration", "extra")


def _payload(state: Any, epoch: int, iteration: int, extra: Optional[dict]) -> dict:
    entries = state.state_dict()
    clash = set(entries) & set(_META)
    if clash:
        raise ValueError(f"the state's entries {sorted(clash)} clash with the checkpoint's own")
    return {**entries, "epoch": epoch, "iteration": iteration, "extra": dict(extra or {})}


def _write_payload(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


# torch.save's formats: a zip archive, and before torch 1.6 a pickle stream of
# protocol 2 (PROTO 2 opens it)
TORCH_MAGIC = (b"PK\x03\x04", b"\x80\x02")


def _read_payload(path: str, state: Any) -> dict:
    """The payload of the file at ``path`` for ``state``: a torch file as
    ``torch.save`` wrote it, or a JAX package's checkpoint (flax msgpack,
    whose first byte opens a map) carried into ``state``'s form
    (utils/from_jax.py ``checkpoint_payload_from_jax``). The format is told
    by the first bytes; a file in neither raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(TORCH_MAGIC):
        return torch.load(path, map_location="cpu", weights_only=True)
    if not flax_msgpack.is_msgpack_map(head):
        raise ValueError(f"{path} is neither a torch checkpoint (a zip archive, "
                         f"{TORCH_MAGIC[0]!r}, or torch's legacy pickle, {TORCH_MAGIC[1]!r}) "
                         f"nor a JAX package's (flax msgpack, a map: 0x81-0x8f, 0xde, 0xdf); "
                         f"it starts with {head!r}")
    try:
        return checkpoint_payload_from_jax(flax_msgpack.load(path), state)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _restore(payload: dict, target_state: Any) -> Tuple[Any, int, int]:
    target_state.load_state_dict({k: v for k, v in payload.items() if k not in _META})
    return target_state, int(payload.get("epoch", 0)), int(payload.get("iteration", 0))


def save_checkpoint(path: str, state: Any, *, epoch: int = 0, iteration: int = 0,
                    extra: Optional[dict] = None) -> str:
    """Write ``state`` (anything with ``state_dict()``) to ``path``; returns it."""
    _write_payload(path, _payload(state, epoch, iteration, extra))
    return path


def load_checkpoint(path: str, target_state: Any) -> Tuple[Any, int, int]:
    """Restore ``path`` into ``target_state`` in place (``load_state_dict``);
    returns (state, epoch, iteration)."""
    return _restore(_read_payload(path, target_state), target_state)


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
        payload = _payload(state, epoch, iteration, None)
        if async_save:
            payload, aux = to_host(payload), copy.deepcopy(aux)
            self._thread = threading.Thread(target=self._write_in_thread,
                                            args=(path, payload, aux), daemon=True)
            self._thread.start()
        else:
            self._write(path, payload, aux)
        return path

    def _write(self, path: str, payload: dict, aux: Optional[dict]) -> None:
        _write_payload(path, payload)
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
        state, epoch, _ = load_checkpoint(path, state)
        return state, epoch

    def latest_aux(self) -> Optional[dict]:
        path = self.latest_path()
        if path is None or not os.path.exists(path + ".aux.json"):
            return None
        with open(path + ".aux.json") as f:
            return json.load(f)


# the port's StyleNets subnets and the reference's names for them
_REFERENCE_STYLE_NETS = (("encoder", "discriminator"), ("decoder", "generator"),
                         ("mapping_tl", "mapping_tl"), ("mapping_fl", "mapping_fl"))


def style_state_dict_from_reference(models: dict, nets: torch.nn.Module,
                                    twin: str = "") -> dict:
    """A reference style checkpoint's ``models`` (checkpointer.py:45-66) -> a
    state_dict of the port's ``StyleNets``: ``discriminator``, ``generator``,
    ``mapping_tl`` and ``mapping_fl`` (with ``twin="_s"`` their EMA twins)
    under ``encoder.``, ``decoder.``, ``mapping_tl.``, ``mapping_fl.``, and
    ``dlatent_avg``. The reference stores lreq weights in implicit mode, the
    stored tensor being the effective weight (lreq.py:70-75), and the port's
    layers hold the raw one: each weight is divided by its layer's ``std`` and
    each lreq linear's bias by its ``lrmul``, as the JAX package's converters
    do (soft_intro_vae_tpu/utils/torch_compat.py:218-321)."""
    sd = {f"{ours}.{k}": v for ours, ref in _REFERENCE_STYLE_NETS
          for k, v in models[ref + twin].items()}
    sd.update({f"dlatent_avg.{k}": v for k, v in models["dlatent_avg"].items()})
    for name, layer in nets.named_modules():
        if isinstance(layer, (LreqDense, LreqConv2d, LreqConvTranspose2d)):
            sd[name + ".weight"] = sd[name + ".weight"] / layer.std
            if isinstance(layer, LreqDense) and layer.bias is not None:
                sd[name + ".bias"] = sd[name + ".bias"] / layer.lrmul
    return sd


def load_pretrained(path: str, state: Any) -> int:
    """Restore ``path`` into ``state`` in place; returns its epoch (0 where
    the file has none).

    ``path`` is a port checkpoint (the train state's payload, written by
    ``Checkpointer.save``), a reference ``.pth`` ({"epoch", "model"},
    train_soft_intro_vae.py:321-329, or a bare 3D ``model.state_dict()``),
    whose ``model`` state_dict in the reference's names loads strictly into
    ``state.model``, or a reference style checkpoint ({"models": ...}), whose
    nets load into a style state's ``nets`` and its EMA twins (``*_s``, else
    the online nets) into ``ema``.
    """
    payload = _read_payload(path, state)
    if "opt_e" in payload:
        return _restore(payload, state)[1]
    if "models" in payload:
        models = payload["models"]
        state.nets.load_state_dict(style_state_dict_from_reference(models, state.nets))
        twin = "_s" if "generator_s" in models else ""
        state.ema.load_state_dict(style_state_dict_from_reference(models, state.ema, twin))
    else:
        state.model.load_state_dict(payload.get("model", payload), strict=True)
    return int(payload.get("epoch", 0))
