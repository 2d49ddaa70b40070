"""The style recipe's cells: the trainer's epoch loop at one LOD, from shards.

Set-up builds what ``train/style.py`` builds (``build_style_training``,
``make_style_dataset``, ``_Feed``, the LOD's intro step wrapped by
``one_step``) and loads the benchmark's weights into the nets and their EMA
twin. The loop is the trainer's (train/style.py:600-630): each epoch
``rank_batches`` of the streaming reader through ``device_prefetch`` two
batches ahead with ``_Feed.put``, one ``one_step`` call a batch, a NaN check
every ``nan_check_iter`` steps, a new feed each epoch. The LR, EMA beta and
``beta_neg`` are the LOD's.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List

import numpy as np
import torch

from benchmark.core import data, weights
from benchmark.core.timing import Spans, step_span
from benchmark.families.common import TrainingCell, match_rows
from benchmark.reference.common import Draws, Precision
from benchmark.reference.style_ref import StyleNets, StyleReference, init_rule


class StyleCell(TrainingCell):
    program_attrs = ("state", "step_fn", "feed", "model", "dataset")
    kl_metric = "real_kl"

    def __init__(self, cfg: dict, cell: dict, seed: int, spans: Spans, device="cuda"):
        super().__init__(cfg, cell, seed, spans, device)
        self.lod = cell["lod"]
        self.res = 2 ** (self.lod + 2)

    # ---------------------------------------------------------------- shapes --
    def leaf_shapes(self):
        with torch.device("meta"):
            nets = StyleNets(self.cfg)
        leaves = dict(nets.named_parameters())
        leaves.update(nets.named_buffers())
        return {k: (tuple(t.shape), t.dtype) for k, t in leaves.items()}

    def make_weights(self) -> Dict[str, torch.Tensor]:
        shapes = self.leaf_shapes()
        rules = {k: init_rule(k, s) for k, (s, _) in shapes.items()}
        return weights.make(shapes, rules, self.seeds["weights"], self.device)

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16}.get(self.cfg["train"]["COMPUTE_DTYPE"], torch.float32)

    def meta_step(self, hook=None) -> None:
        """One reference step on the meta device, the conv path in the
        configuration's compute type (FLOP and byte counts)."""
        ref = StyleReference(self.cfg, self.lod, self.batch, "meta",
                             Precision("fp32", self.compute_dtype), hook)
        channels = self.cfg["model"].get("CHANNELS", 3)
        ref.step(torch.empty(self.batch, channels, self.res, self.res, device="meta"),
                 Draws(None, "meta"))

    def shard_pattern(self) -> str:
        d = self.cfg["data"]
        return data.shard_set(d["seed"], self.cell["records"], d["level"], d["parts"])

    def records(self) -> np.ndarray:
        """Every record at this LOD's resolution, as the reader should give it."""
        d = self.cfg["data"]
        full = data.images(d["seed"], self.cell["records"], 2 ** d["level"])
        return full if full.shape[1] == self.res else data.box_downscale(full, self.res)

    # --------------------------------------------------------------- program --
    def setup(self) -> None:
        from soft_intro_vae_torch.train.style import (
            StyleConfig, _Feed, build_style_training, make_style_dataset)
        from soft_intro_vae_torch.train.style_step import StyleStepConfig, build_style_steps
        from soft_intro_vae_torch.train.graph import one_step

        m, t, d = self.cfg["model"], self.cfg["train"], self.cfg["data"]
        lod = self.lod
        scfg = StyleConfig(
            name="bench", dataset_path=self.shard_pattern(), dataset_size=self.cell["records"],
            part_count=d["parts"], max_resolution_level=d["level"],
            layer_count=m["LAYER_COUNT"], start_channel_count=m["START_CHANNEL_COUNT"],
            max_channel_count=m["MAX_CHANNEL_COUNT"], latent_space_size=m["LATENT_SPACE_SIZE"],
            dlatent_avg_beta=m["DLATENT_AVG_BETA"], style_mixing_prob=m["STYLE_MIXING_PROB"],
            mapping_layers=m["MAPPING_LAYERS"], beta_kl=m["BETA_KL"], beta_rec=m["BETA_REC"],
            beta_neg=tuple(m["BETA_NEG"]), scale=m["SCALE"],
            base_learning_rate=t["BASE_LEARNING_RATE"], adam_beta2=t["ADAM_BETA_1"],
            learning_rates=tuple(t["LEARNING_RATES"]), compute_dtype=t["COMPUTE_DTYPE"],
            seed=self.seeds["shuffle"], device=str(self.device), buffer_size_mb=d["buffer_mb"],
            verbose=False, resume=False)
        self.scfg = scfg
        self.dataset = make_style_dataset(scfg)
        self.model, state = build_style_training(scfg)
        w = self.make_weights()
        weights.load_into(state.nets, w)
        weights.load_into(state.ema, w)
        del w
        state.generator.manual_seed(self.seeds["draws"])
        state.set_lr(t["LEARNING_RATES"][min(lod, len(t["LEARNING_RATES"]) - 1)])
        state.set_ema_beta(0.5 ** (self.batch / 10000.0))
        self.state = state
        beta_neg = float(m["BETA_NEG"][min(lod, len(m["BETA_NEG"]) - 1)])
        step_cfg = StyleStepConfig(latent_size=m["LATENT_SPACE_SIZE"], beta_rec=m["BETA_REC"],
                                   beta_kl=m["BETA_KL"], beta_neg=beta_neg,
                                   gamma_r=t["GAMMA_R"], scale=m["SCALE"])
        self.step_fn = one_step(build_style_steps(self.model, step_cfg, lod, False)[1])
        self.feed = _Feed(state.device)
        self._start()

    def _loop(self) -> Iterator:
        """The trainer's epoch loop, one step a ``next``."""
        from soft_intro_vae_torch.data.prefetch import device_prefetch
        from soft_intro_vae_torch.parallel.mesh import current_world
        from soft_intro_vae_torch.train.style import rank_batches

        world = current_world()
        every = self.scfg.nan_check_iter
        epoch = 0
        while True:
            def produce(epoch=epoch):
                for raw in rank_batches(self.dataset, self.res, self.batch, epoch, world):
                    yield raw, 1.0, False

            steps = 0
            with contextlib.closing(device_prefetch(self.spans.producer(produce()), size=2,
                                                    put_fn=self.feed.put)) as fed:
                it = iter(fed)
                while True:
                    with self.spans.wait():
                        item = next(it, None)
                    if item is None:
                        break
                    x, blend, _ = item
                    with step_span():
                        self.state, mets = self.step_fn(self.state, x, blend)
                    steps += 1
                    if every and steps % every == 0:
                        if not bool(torch.isfinite(torch.stack(list(mets.values()))).all()):
                            raise SystemError("loss is NaN")
                    yield x, mets
            if steps == 0:
                raise ValueError(f"epoch {epoch}: no batch of {self.batch} in "
                                 f"{self.cell['records']} records")
            epoch += 1

    # the program's state, as the base class reads it
    def _nets(self):
        return self.state.nets

    def _ema(self):
        return self.state.ema

    def _encoder_params(self):
        return [(k, p) for k, p in self.state.nets.named_parameters()
                if k.startswith(("encoder.", "mapping_tl."))]

    def _moments(self):
        """LREQAdam's v of every parameter, by name."""
        nets = self.state.nets
        out = {}
        for params, opt in ((nets.params_e(), self.state.opt_e), (nets.params_d(), self.state.opt_d)):
            out.update({k: {"v": v} for k, v in zip(_names(nets, params), opt.nu)})
        return out

    def _gradient(self, before):
        """The last step's gradient norms of the E and D phases' leaves, from
        LREQAdam's v = b2 v' + (1 - b2) g^2 (``before``: v', nought before the
        first step)."""
        b2 = self.cfg["train"]["ADAM_BETA_1"]
        nets = self.state.nets
        now = self._moments()
        out = []
        for params in (nets.params_e(), nets.params_d()):
            grads = {}
            for k in _names(nets, params):
                g2 = now[k]["v"].double()
                if k in before:
                    g2 = g2 - b2 * before[k]["v"].to(g2.device, torch.float64)
                grads[k] = float((g2.sum() / (1.0 - b2)).clamp_min(0.0).sqrt())
            out.append(grads)
        return out

    # ----------------------------------------------------------------- check --
    def check_feed(self):
        """The checked batches as records: (records, [(B, 2) index, flipped] a
        batch, rows wrong)."""
        recs = self.records()
        lut = torch.arange(256, dtype=torch.float32) / 127.5 - 1.0
        matched, wrong = [], 0
        for stage in self.stages():
            if stage.start == stage.stop:
                continue
            x = torch.cat(self.batches[stage])
            u8 = ((x + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8)
            wrong += int((lut[u8.long()] != x).flatten(1).any(dim=1).sum())
            idx, bad = match_rows(u8.permute(0, 2, 3, 1).numpy(), recs,
                                  flips=bool(self.cfg["data"]["flip"]))
            matched += np.split(idx, stage.stop - stage.start)
            wrong += bad
        return recs, matched, wrong

    def make_reference(self, prec: Precision) -> StyleReference:
        return StyleReference(self.cfg, self.lod, self.batch, self.device, prec)

    def reference_input(self, recs: np.ndarray, idx: np.ndarray, half: bool) -> torch.Tensor:
        """The reference's own copy of a checked batch: the records, flipped as
        the program's rows were, x / 127.5 - 1, NCHW."""
        rows = np.stack([recs[j][:, ::-1] if f else recs[j] for j, f in idx])
        if half:
            rows = rows[: rows.shape[0] // 2]
        x = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        return (x.float() / 127.5 - 1.0).permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def encoder_names(names):
        return [n for n in names if n.startswith(("encoder.", "mapping_tl."))]


def _names(module: torch.nn.Module, params) -> List[str]:
    ids = {id(p): n for n, p in module.named_parameters()}
    return [ids[id(p)] for p in params]


Cell = StyleCell
