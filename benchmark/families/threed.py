"""The 3D point-cloud recipe's cells: the trainer's epoch loop over a
device-resident set of clouds.

Set-up builds what ``train/threed.py`` builds (``build_3d_training`` with
its ``intro_step``; ``num_vae`` 0, so no vanilla step runs) over clouds made
from the data seed and kept on the device as the trainer keeps its set, and
loads the benchmark's weights. The loop is the trainer's training loop
(train/threed.py ``train_soft_intro_vae_3d``): each epoch from the first,
``epoch_batches`` (the epoch's permutation, this rank's rows of each batch
gathered on the device, each selection a ``feed.gather`` span), one
``intro_step`` call a batch (``scan_steps`` 1: one graph replay), a NaN
check every ``nan_check_iter`` steps of the epoch, and at the epoch's end
the one fetch of its step metrics to the host (``_epoch_means``). The LR
stays the recipe's: a window ends long before the first milestone (epoch
350). Left out of the loop is the rest of the trainer's end-of-epoch work:
the validation JSD every ``valid_frequency`` epochs (``calc_jsd_valid``,
measured apart: PERF.md §7) and the checkpoints it and ``save_frequency``
write.

The checked rows: each row of a checked batch must be, bit for bit, the
cloud the epoch's permutation puts there (``np.random.default_rng((seed +
2, epoch))``, the trainer's rule), and no cloud may repeat within a stage.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from benchmark.core import weights
from benchmark.core.timing import step_span
from benchmark.families.common import match_rows
from benchmark.families.image import ImageCell
from benchmark.reference.common import Draws, Precision
from benchmark.reference.threed_ref import ThreeDNets, ThreeDReference, init_rules


def clouds(seed: int, count: int, n_points: int) -> np.ndarray:
    """``count`` clouds of ``n_points`` points uniform in [-0.5, 0.5)^3,
    (count, n_points, 3) float32, from one generator."""
    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    return rng.random((count, n_points, 3), dtype=np.float32) - np.float32(0.5)


class MetaReference(ThreeDReference):
    """The reference step with a chamfer of no matmul: a sum over both
    clouds, of their shapes and on the gradient's path, in place of the
    published form's three ``bmm``s."""

    def rec_loss(self, preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
        if self.hook is not None:
            self.hook("chamfer", (gts.shape[0], gts.shape[1], preds.shape[1]))
        return preds.sum(dim=(1, 2)) + gts.sum(dim=(1, 2))


class ThreeDCell(ImageCell):
    program_attrs = ("state", "step_fn", "train_dev")

    def leaf_shapes(self):
        with torch.device("meta"):
            nets = ThreeDNets(self.cfg)
        leaves = dict(nets.named_parameters())
        leaves.update(nets.named_buffers())
        return {k: (tuple(t.shape), t.dtype) for k, t in leaves.items()}, init_rules(nets)

    def meta_step(self, hook=None) -> None:
        """One reference step on the meta device (FLOP counts; ``hook`` is
        told of each chamfer call). The chamfer's three ``bmm``s are left
        out of the count: the program searches in its own kernel, whose work
        ``kernels.chamfer_roofline`` counts."""
        x = torch.empty(self.batch, self.cfg["n_points"], 3, device="meta")
        MetaReference(self.cfg, "meta", Precision(), hook).step(x, Draws(None, "meta"))

    def records(self) -> np.ndarray:
        return clouds(self.cfg["data"]["seed"], self.cell["records"], self.cfg["n_points"])

    def data_seed(self) -> int:
        """The trainer's shuffle seed (train/threed.py: ``max(seed, 0) + 2``)."""
        return max(self.tcfg.seed, 0) + 2

    # --------------------------------------------------------------- program --
    def setup(self) -> None:
        # epoch_batches first: a program without it cannot run the cell
        from soft_intro_vae_torch.train.threed import (  # noqa: F401
            ThreeDConfig, build_3d_training, epoch_batches)

        c, m, opt = self.cfg, self.cfg["model"], self.cfg["optimizer"]
        tcfg = ThreeDConfig(
            n_points=c["n_points"], batch_size=self.batch, max_epochs=c["max_epochs"],
            beta_rec=c["beta_rec"], beta_kl=c["beta_kl"], beta_neg=float(c["beta_neg"]),
            gamma_r=c["gamma_r"], num_vae=c["num_vae"], z_size=c["z_size"],
            prior_std=c["prior_std"], lr_e=opt["E"]["hyperparams"]["lr"],
            lr_d=opt["D"]["hyperparams"]["lr"], seed=self.seeds["shuffle"] % (2 ** 31),
            apply_random_rotation="rotate" in c["transforms"],
            reconstruction_loss=c["reconstruction_loss"], verbose=False, resume=False,
            device=str(self.device), chamfer_impl=c["program"]["chamfer_impl"],
            conv_channels=tuple(m["conv_channels"]), hidden=tuple(m["hidden"]),
            matmul_precision=c["program"]["matmul_precision"])
        self.tcfg = tcfg
        state, _, self.step_fn = build_3d_training(tcfg, scan_steps=c["program"]["scan_steps"])
        weights.load_into(state.model, self.make_weights())
        state.generator.manual_seed(self.seeds["draws"])
        self.state = state
        self.clouds = self.records()
        self.train_dev = torch.from_numpy(self.clouds).to(state.device)
        self._start()

    def _loop(self) -> Iterator:
        from soft_intro_vae_torch.parallel.mesh import current_world, host_local_batch_size
        from soft_intro_vae_torch.train.threed import _epoch_means, epoch_batches

        world = current_world()
        mine = world.rows(host_local_batch_size(self.batch, world))
        every = self.tcfg.nan_check_iter
        epoch = 1
        while True:
            batches = epoch_batches(self.clouds, self.train_dev, epoch, data_seed=self.data_seed(),
                                    batch_size=self.batch, rows=mine,
                                    rotate=self.tcfg.apply_random_rotation)
            device_metrics = []
            for i, x in enumerate(batches, 1):
                with step_span():
                    self.state, mets = self.step_fn(self.state, x)
                device_metrics.append(mets)
                if every and i % every == 0:
                    if not bool(torch.isfinite(torch.stack(list(mets.values()))).all()):
                        raise SystemError("loss is NaN")
                yield x, mets
            _epoch_means(device_metrics)
            epoch += 1

    # ----------------------------------------------------------------- check --
    def expected_rows(self, step: int) -> np.ndarray:
        """The records the trainer's rule puts in step ``step`` (from 0)."""
        from soft_intro_vae_torch.parallel.mesh import current_world, host_local_batch_size

        n = self.cell["records"]
        per_epoch = n // self.batch
        epoch, at = 1 + step // per_epoch, (step % per_epoch) * self.batch
        perm = np.random.default_rng((self.data_seed(), epoch)).permutation(n)
        world = current_world()
        return perm[at:at + self.batch][world.rows(host_local_batch_size(self.batch, world))]

    def check_feed(self):
        recs = self.records()
        matched, wrong = [], 0
        for stage in self.stages():
            if stage.start == stage.stop:
                continue
            rows = torch.cat(self.batches[stage]).numpy()
            expected = np.concatenate([self.expected_rows(s)
                                       for s in range(stage.start, stage.stop)])
            idx, bad = match_rows(rows, recs, flips=False)
            matched += np.split(idx, stage.stop - stage.start)
            wrong += bad + int(((idx[:, 0] >= 0) & (idx[:, 0] != expected)).sum())
        return recs, matched, wrong

    def make_reference(self, prec: Precision) -> ThreeDReference:
        return ThreeDReference(self.cfg, self.device, prec)


Cell = ThreeDCell
