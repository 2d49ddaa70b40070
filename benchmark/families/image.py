"""The image recipe's cells: the trainer's epoch loop over an in-memory set.

Set-up builds what ``train/image.py`` builds (``build_image_training`` with
its ``intro_step``, ``device_put_fn``) over an ``ArrayDataset`` of uint8
images made from the data seed, and loads the benchmark's weights. The loop
is the trainer's (train/image.py:291-324): each epoch the dataset's shuffled
batches, this rank's rows, through ``device_prefetch`` two batches ahead,
one call a batch (``scan_steps`` 1: one graph replay), a NaN check every
``nan_check_iter`` steps.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from benchmark.core import data, weights
from benchmark.core.timing import step_span
from benchmark.families.common import TrainingCell, match_rows
from benchmark.reference.common import Draws, Precision
from benchmark.reference.image_ref import ImageNets, ImageReference, init_rules


class ImageCell(TrainingCell):
    program_attrs = ("state", "step_fn", "dataset")

    def leaf_shapes(self):
        with torch.device("meta"):
            nets = ImageNets(self.cfg)
        leaves = dict(nets.named_parameters())
        leaves.update(nets.named_buffers())
        return {k: (tuple(t.shape), t.dtype) for k, t in leaves.items()}, init_rules(nets)

    def make_weights(self) -> Dict[str, torch.Tensor]:
        shapes, rules = self.leaf_shapes()
        return weights.make(shapes, rules, self.seeds["weights"], self.device)

    compute_dtype = torch.float32

    def meta_step(self, hook=None) -> None:
        """One reference step on the meta device (FLOP counts)."""
        m = self.cfg["model"]
        x = torch.empty(self.batch, m["image_size"], m["image_size"], m["cdim"],
                        dtype=torch.uint8, device="meta")
        ImageReference(self.cfg, "meta").step(x, Draws(None, "meta"))

    def records(self) -> np.ndarray:
        m, d = self.cfg["model"], self.cfg["data"]
        return data.image_set(d["seed"], self.cell["records"], m["image_size"], m["cdim"])

    # --------------------------------------------------------------- program --
    def setup(self) -> None:
        from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec
        from soft_intro_vae_torch.train.image import ImageConfig, build_image_training

        m, t = self.cfg["model"], self.cfg["train"]
        spec = ImageSpec(m["dataset"], m["image_size"], tuple(m["channels"]), m["cdim"])
        icfg = ImageConfig(dataset=m["dataset"], z_dim=m["z_dim"], lr_e=t["lr_e"], lr_d=t["lr_d"],
                           batch_size=self.batch, beta_kl=t["beta_kl"], beta_rec=t["beta_rec"],
                           beta_neg=t["beta_neg"], gamma_r=t["gamma_r"],
                           seed=self.seeds["shuffle"] % (2 ** 31), scan_steps=t["scan_steps"],
                           compute_dtype=t["compute_dtype"],
                           matmul_precision=t["matmul_precision"], device=str(self.device),
                           verbose=False)
        self.icfg = icfg
        self.dataset = ArrayDataset(self.records(), seed=self.seeds["shuffle"])
        state, _, self.step_fn = build_image_training(icfg, spec)
        weights.load_into(state.model, self.make_weights())
        state.generator.manual_seed(self.seeds["draws"])
        self.state = state
        self._start()

    def _loop(self) -> Iterator:
        from soft_intro_vae_torch.data.prefetch import device_prefetch, device_put_fn
        from soft_intro_vae_torch.parallel.mesh import current_world, host_local_batch_size

        world = current_world()
        mine = world.rows(host_local_batch_size(self.batch, world))
        put_fn = device_put_fn(self.state.device)
        every = self.icfg.nan_check_iter
        cur_iter, epoch = 0, 0
        while True:
            host = self.dataset.epoch(self.batch, drop_last=True, epoch_index=epoch, rows=mine)
            fed = device_prefetch(self.spans.producer(host), size=2, put_fn=put_fn)
            try:
                it = iter(fed)
                while True:
                    with self.spans.wait():
                        x = next(it, None)
                    if x is None:
                        break
                    with step_span():
                        self.state, mets = self.step_fn(self.state, x)
                    if every and cur_iter % every == 0:
                        if not bool(torch.isfinite(torch.stack(list(mets.values()))).all()):
                            raise SystemError("loss is NaN")
                    cur_iter += 1
                    yield x, mets
            finally:
                fed.close()
            epoch += 1

    # the program's state, as the base class reads it
    def _nets(self):
        return self.state.model

    def _ema(self):
        return None

    def _encoder_params(self):
        return [(k, p) for k, p in self.state.model.named_parameters() if k.startswith("encoder.")]

    def _moments(self):
        """torch Adam's m and v of every parameter, by name (none before its
        first step)."""
        out = {}
        for prefix, opt in (("encoder.", self.state.opt_e), ("decoder.", self.state.opt_d)):
            names = [n for n, _ in self.state.model.named_parameters() if n.startswith(prefix)]
            params = [p for g in opt.param_groups for p in g["params"]]
            for k, p in zip(names, params):
                st = opt.state.get(p, {})
                if "exp_avg" in st:
                    out[k] = {"m": st["exp_avg"], "v": st["exp_avg_sq"]}
        return out

    def _gradient(self, before):
        """The last step's gradient norms of the E and D phases' leaves, from
        torch Adam's m = b1 m' + (1 - b1) g (``before``: m', nought before the
        first step)."""
        now = self._moments()
        out = []
        for prefix, opt in (("encoder.", self.state.opt_e), ("decoder.", self.state.opt_d)):
            b1 = opt.param_groups[0]["betas"][0]
            grads = {}
            for k, _ in self.state.model.named_parameters():
                if not k.startswith(prefix):
                    continue
                if k not in now:
                    grads[k] = 0.0
                    continue
                m = now[k]["m"].double()
                if k in before:
                    m = m - b1 * before[k]["m"].to(m.device, torch.float64)
                grads[k] = float(m.norm()) / (1.0 - b1)
            out.append(grads)
        return out

    # ----------------------------------------------------------------- check --
    def check_feed(self):
        recs = self.records()
        matched, wrong = [], 0
        for stage in self.stages():
            if stage.start == stage.stop:
                continue
            idx, bad = match_rows(torch.cat(self.batches[stage]).numpy(), recs, flips=False)
            matched += np.split(idx, stage.stop - stage.start)
            wrong += bad
        return recs, matched, wrong

    def make_reference(self, prec: Precision) -> ImageReference:
        return ImageReference(self.cfg, self.device, prec)

    def reference_input(self, recs: np.ndarray, idx: np.ndarray, half: bool) -> torch.Tensor:
        rows = recs[idx[:, 0]]
        if half:
            rows = rows[: rows.shape[0] // 2]
        return torch.from_numpy(rows).to(self.device)

    @staticmethod
    def encoder_names(names):
        return [n for n in names if n.startswith("encoder.")]


Cell = ImageCell
