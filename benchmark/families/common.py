"""What the trainer families share: derived seeds, the run's step stream,
host snapshots of the program's state, and the readings both sides give the
checks (benchmark/core/checks.py).

Two stages of the program's warm-up are checked. The start: its first
``START_STEPS`` steps, from the benchmark's weights, which on the card are
the graph's eager warm-up steps (train/graph.py ``WARMUP_STEPS``). The
replays: the ``REPLAY_STEPS`` steps after the later of the two, the first
replays of the captured graph, the path every window step takes. The
reference follows the start from the same weights, and the replays from the
program's own state before them (parameters, buffers, EMA twin, optimizer
moments), with the draws it would make next and the same batches.

A family subclass builds the program in ``setup`` (ending in
``self._start()``), and gives the reference its weights
(``make_weights``), its nets (``make_reference``) and each checked batch
(``reference_input``), and reads the program's optimizer moments
(``_moments``) and a step's gradient from them (``_gradient``).
"""

from __future__ import annotations

import gc
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from benchmark.core import checks
from benchmark.core.timing import Spans
from benchmark.reference.common import Draws, Precision

START_STEPS = 3
REPLAY_STEPS = 3
LOSSES = ("loss_e", "loss_d", "kl")  # a step's readings: its losses, the E phase's real KL


def derived_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use (weights, draws, shuffle) of a run's seed."""
    words = np.random.SeedSequence([int(seed), *what.encode()]).generate_state(2, np.uint32)
    return int((int(words[0]) << 31) ^ int(words[1]))


def host_copy(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().to("cpu", copy=True) for k, t in named}


def leaves(module: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """A module's parameters and buffers by name."""
    return list(module.named_parameters()) + list(module.named_buffers())


def change_norms(after: Mapping[str, torch.Tensor], before: Mapping[str, torch.Tensor],
                 names: Iterable[str]) -> checks.Norms:
    """||after - before|| per leaf, in float64, on ``before``'s device."""
    out = {}
    for k in names:
        b = before[k]
        out[k] = float((after[k].detach().to(b.device, torch.float64) - b.double()).norm())
    return out


class Readings:
    """One side's readings of one checked stage: each step's losses and the
    E phase's KL of the real batch (a forward of the encoder before any
    update), the stage's first gradient norms of the E phase's leaves and of the D
    phase's, each leaf's change over the stage (and the EMA twin's), and the
    encoder after the stage's first E update."""

    def __init__(self):
        self.losses: List[Dict[str, float]] = []
        self.grad_e: checks.Norms = {}
        self.grad_d: checks.Norms = {}
        self.change: checks.Norms = {}
        self.ema: checks.Norms = {}
        self.encoder_after: Dict[str, torch.Tensor] = {}

    def as_dict(self) -> dict:
        out = {"losses": self.losses, "grad_e": self.grad_e, "grad_d": self.grad_d,
               "change": self.change}
        if self.ema:
            out["ema"] = self.ema
        return out


def match_rows(rows: np.ndarray, records: np.ndarray, flips: bool) -> Tuple[np.ndarray, int]:
    """Each row of ``rows`` (N, H, W, C) uint8 as the index of the record it
    is (and whether flipped left-right): returns ((N, 2) [index, flipped],
    the count of rows that are no record or repeat an earlier one's)."""
    key = {}
    for i, r in enumerate(records):
        key.setdefault(r[0].tobytes(), []).append((i, 0))
        if flips:
            key.setdefault(r[0, ::-1].tobytes(), []).append((i, 1))
    out = np.full((rows.shape[0], 2), -1, np.int64)
    wrong, seen = 0, set()
    for j, row in enumerate(rows):
        hit = None
        for i, f in key.get(row[0].tobytes(), ()):
            cand = records[i][:, ::-1] if f else records[i]
            if np.array_equal(cand, row):
                hit = (i, f)
                break
        if hit is None or hit[0] in seen:
            wrong += 1
            continue
        seen.add(hit[0])
        out[j] = hit
    return out, wrong


class TrainingCell:
    """One training cell's program, its step stream, and its reference."""

    program_attrs: Tuple[str, ...] = ("state", "step_fn")
    kl_metric = "kl_real"  # the program's metric of the E phase's real KL

    def __init__(self, cfg: dict, cell: dict, seed: int, spans: Spans, device="cuda"):
        self.cfg, self.cell, self.spans = cfg, cell, spans
        self.device = torch.device(device)
        self.batch = cell["batch"]
        self.seeds = {k: derived_seed(seed, k) for k in ("weights", "draws", "shuffle")}
        from soft_intro_vae_torch.train.graph import WARMUP_STEPS
        self.replay_from = max(START_STEPS, WARMUP_STEPS)  # steps before the first replay
        self.readings = Readings()          # the start
        self.replay = Readings()            # the first replays
        self.batches: List[torch.Tensor] = []   # host copies of the checked steps' batches
        self.params_after: Dict[str, torch.Tensor] = {}
        self.ema_after: Dict[str, torch.Tensor] = {}
        self.before_replay: dict = {}       # the program's state before its first replay
        self.replay_after: Dict[str, Dict[str, torch.Tensor]] = {}
        self.metrics: List[Dict[str, torch.Tensor]] = []
        self._stream: Optional[Iterator] = None

    # ------------------------------------------------------ the step stream --
    def _start(self) -> None:
        """Take the warm-up steps, the checked ones read as they come."""
        self._stream = self._loop()
        last = self.replay_from + REPLAY_STEPS
        for i in range(max(self.cell["warmup_steps"], last)):
            x, mets = next(self._stream)
            if i < last:
                self._snapshot(i + 1, x, mets)

    def steps(self) -> Iterator[None]:
        for _, mets in self._stream:
            self.metrics.append(mets)
            yield

    def run_steps(self, n: int) -> None:
        for _ in range(n):
            next(self._stream)

    @torch.no_grad()
    def _snapshot(self, i: int, x: torch.Tensor, mets: dict) -> None:
        """Read step ``i`` (from 1) of the warm-up."""
        self.batches.append(x.detach().to("cpu", copy=True))
        losses = dict({k: float(mets[k]) for k in ("loss_e", "loss_d")},
                      kl=float(mets[self.kl_metric]))
        if i <= START_STEPS:
            self.readings.losses.append(losses)
        if i == 1:
            self.readings.grad_e, self.readings.grad_d = self._gradient({})
            self.readings.encoder_after = host_copy(self._encoder_params())
        if i == START_STEPS:
            self.params_after = host_copy(self._nets().named_parameters())
            if self._ema() is not None:
                self.ema_after = host_copy(self._ema().named_parameters())
        if i == self.replay_from:
            ema = self._ema()
            self.before_replay = {
                "leaves": host_copy(leaves(self._nets())),
                "ema": None if ema is None else host_copy(leaves(ema)),
                "moments": {k: host_copy(m.items()) for k, m in self._moments().items()}}
        if i > self.replay_from:
            self.replay.losses.append(losses)
        if i == self.replay_from + 1:
            self.replay.grad_e, self.replay.grad_d = self._gradient(self.before_replay["moments"])
        if i == self.replay_from + REPLAY_STEPS:
            self.replay_after["params"] = host_copy(self._nets().named_parameters())
            if self._ema() is not None:
                self.replay_after["ema"] = host_copy(self._ema().named_parameters())

    def close(self) -> None:
        """Stop the feed and free the program's state and graphs."""
        if self._stream is not None:
            self._stream.close()
        self._stream = None
        for k in self.program_attrs:
            self.__dict__.pop(k, None)
        self.metrics = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def failed_steps(self, count: int) -> int:
        if not self.metrics[:count]:
            return 0
        rows = torch.stack([torch.stack(list(m.values())) for m in self.metrics[:count]])
        return int((~torch.isfinite(rows)).any(dim=1).sum())

    # ----------------------------------------------------------------- check --
    def stages(self) -> List[slice]:
        """The checked batches by stage: the start, the steps between it and
        the first replay (none while the graph warms up in three steps), the
        replays. Rows may not repeat within a stage."""
        return [slice(0, START_STEPS), slice(START_STEPS, self.replay_from),
                slice(self.replay_from, self.replay_from + REPLAY_STEPS)]

    def program_readings(self) -> Tuple[Readings, Readings]:
        w = self.make_weights()
        names = list(self.params_after)
        self.readings.change = change_norms(self.params_after, w, names)
        if self.ema_after:
            self.readings.ema = change_norms(self.ema_after, w, names)
        before = self.before_replay
        self.replay.change = change_norms(self.replay_after["params"], before["leaves"], names)
        if "ema" in self.replay_after:
            self.replay.ema = change_norms(self.replay_after["ema"], before["ema"], names)
        return self.readings, self.replay

    def reference(self, recs: np.ndarray, matched, prec: Precision = Precision(),
                  half: bool = False) -> Tuple[Readings, Readings]:
        """The reference's steps on the records the program was fed (``half``:
        the first half of each batch): the start from the benchmark's weights,
        then the replays from the program's state before them."""
        w = self.make_weights()
        ref = self.make_reference(prec)
        ref.load(w)
        draws = Draws(self.seeds["draws"], self.device)
        names = [n for n, _ in ref.nets.named_parameters()]
        start, replay = Readings(), Readings()
        with prec.context():
            for i, idx in enumerate(matched[:self.replay_from]):
                res = ref.step(self.reference_input(recs, idx, half), draws)
                if i < START_STEPS:
                    start.losses.append({k: float(res[k]) for k in LOSSES})
                if i == 0:
                    start.grad_e, start.grad_d = self._split(checks.norms(res["grads"]), names)
                    start.encoder_after = host_copy(
                        (k, t) for k, t in ref.nets.named_parameters() if k in start.grad_e)
                if i == START_STEPS - 1:
                    start.change = change_norms(dict(ref.nets.named_parameters()), w, names)
                    if getattr(ref, "ema", None):
                        start.ema = change_norms(ref.ema, w, names)
                del res
            del w
            before = self.before_replay
            ref.load_state(before, self.replay_from)
            for i, idx in enumerate(matched[self.replay_from:]):
                res = ref.step(self.reference_input(recs, idx, half), draws)
                replay.losses.append({k: float(res[k]) for k in LOSSES})
                if i == 0:
                    replay.grad_e, replay.grad_d = self._split(checks.norms(res["grads"]), names)
                del res
        replay.change = change_norms(dict(ref.nets.named_parameters()), before["leaves"], names)
        if getattr(ref, "ema", None):
            replay.ema = change_norms(ref.ema, before["ema"], names)
        del ref
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return start, replay

    def _split(self, grads: checks.Norms, names) -> Tuple[checks.Norms, checks.Norms]:
        """Gradient norms by phase: the E phase's leaves, the D phase's."""
        enc = set(self.encoder_names(names))
        return ({k: grads[k] for k in names if k in enc},
                {k: grads[k] for k in names if k not in enc})

    def d_phase(self, recs: np.ndarray, matched,
                encoder_after: Dict[str, torch.Tensor]) -> checks.Norms:
        """The reference's first D phase, on the whole first batch, from another
        side's encoder after its first E update: the D leaves' gradient norms."""
        w = self.make_weights()
        ref = self.make_reference(Precision())
        ref.load(w)
        with Precision().context():
            res = ref.step(self.reference_input(recs, matched[0], False),
                           Draws(self.seeds["draws"], self.device),
                           encoder_after={k: t.to(self.device) for k, t in encoder_after.items()})
        names = [n for n, _ in ref.nets.named_parameters()]
        grads = self._split(checks.norms(res["grads"]), names)[1]
        del ref, res
        return grads

    def numbers(self, side: Tuple[Readings, Readings], ref: Tuple[Readings, Readings], recs,
                matched, wrong: int) -> Dict[str, float]:
        """Every number a cell may compare, ``side`` (the program, or a
        control or fault in its place) against the reference, stage by stage."""
        ref_d = self.d_phase(recs, matched, side[0].encoder_after)
        out = checks.numbers(side[0].as_dict(), ref[0].as_dict(), ref_d, wrong)
        out.update(checks.replay_numbers(side[1].as_dict(), ref[1].as_dict()))
        return out
