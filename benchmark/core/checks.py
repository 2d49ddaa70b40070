"""The numbers that decide ``correct`` for a training cell.

Two stages of the program's warm-up, taken in set-up through the window's
own call and feed (benchmark/families/common.py). The start, the program's
first three steps (on the card the graph's eager warm-ups), against the
reference's three steps from the same weights, batches and draws:

* ``feed_rows_wrong``: rows of the checked batches (both stages) that are
  not a record of the data set (decoded, downscaled, flipped or not,
  normalised), or repeat one within the stage: exact, limit 0;
* ``loss1_e_gap``: the relative gap of the first step's E loss, before any
  update; ``loss1_d_gap`` and ``loss_gap`` the D loss's and every step's;
  ``kl1_gap`` the first step's KL of the real batch (the encoder's forward
  alone, no exponential of it as in the E loss);
* ``grad_e_gap``: the first gradient of the E phase (before any update),
  leaf by leaf (the program's read from its optimizer's state after step 1):
  the widest gap of a leaf's norm against the reference's, over the larger
  of that leaf's and the median leaf's norm; ``grad_d_gap`` the same for the
  D phase, whose reference starts from the side's own encoder after its
  first E update (that update's sign-like steps turn rounding into changes
  of a whole learning rate, which no two precisions share);
* ``change_gap``: each leaf's change over the three steps, leaving out
  leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone); ``ema_gap`` the EMA twin's;
* ``*_median_gap``: the median leaf's gap in place of the widest (over the
  leaves with a reference gradient); ``grad_*_norm_gap`` the relative gap of
  the phase's whole gradient norm;
* ``grad_*_share_median_gap``: the median leaf's gap of its share of the
  phase's whole gradient norm (``shares``): an error of a factor common to
  every leaf (the loss's exponential terms weigh the whole backward pass)
  cancels, and what is left is each leaf's own rounding.

The replays, the next three steps (the first replays of the captured graph,
as every window step is), against the reference's three steps from the
program's own state before them (``replay_numbers``):

* ``replay_loss_e_gap``: the first replay's E loss, before any update;
  ``replay_kl_gap`` its KL of the real batch; ``replay_loss_gap`` every
  loss of the three;
* ``replay_grad_e_gap``, ``replay_grad_e_median_gap`` and
  ``replay_grad_e_share_median_gap``: the first replay's E gradient (the
  program's from its optimizer's moments before and after it), by the
  widest and the median leaf, and by the median leaf's share;
* ``replay_change_gap``, ``replay_change_median_gap`` and
  ``replay_ema_median_gap``: each leaf's change over the three replays,
  leaving out leaves whose reference gradient is nought to rounding.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Optional, Sequence

import torch

Norms = Dict[str, float]
NOUGHT = 1e-3  # of the median leaf's gradient norm: a leaf that moves by round-off


def norms(tensors: Mapping[str, Optional[torch.Tensor]]) -> Norms:
    """Float64 norm of each leaf (0 for a leaf with no tensor)."""
    return {k: (0.0 if t is None else float(t.detach().double().norm())) for k, t in tensors.items()}


def leaf_gaps(prog: Norms, ref: Norms, leaves: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """|prog - ref| / max(ref, median ref over the leaves), leaf by leaf."""
    keys = list(ref if leaves is None else leaves)
    if set(keys) - set(prog):
        raise ValueError(f"the program has no value for {sorted(set(keys) - set(prog))[:4]}")
    live = [ref[k] for k in keys if ref[k] > 0]
    if not live:
        return {k: 0.0 for k in keys}
    med = statistics.median(live)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def worst_leaf_gap(prog: Norms, ref: Norms, leaves: Optional[Sequence[str]] = None) -> float:
    """The widest leaf gap: over the larger of the leaf's and the median leaf's norm."""
    return max(leaf_gaps(prog, ref, leaves).values(), default=0.0)


def median_leaf_gap(prog: Norms, ref: Norms, leaves: Optional[Sequence[str]] = None) -> float:
    """The median leaf's gap: steady where a few small leaves swing."""
    gaps = leaf_gaps(prog, ref, leaves)
    return statistics.median(gaps.values()) if gaps else 0.0


def worst_leaves(prog: Norms, ref: Norms, leaves=None, n: int = 3) -> List[List]:
    gaps = leaf_gaps(prog, ref, leaves)
    top = sorted(gaps, key=lambda k: -gaps[k])[:n]
    return [[k, gaps[k], prog[k], ref[k]] for k in top]


def whole_gap(prog: Norms, ref: Norms) -> float:
    """The relative gap of the whole phase's norm, over every leaf at once."""
    whole = math.sqrt(sum(v * v for v in ref.values()))
    side = math.sqrt(sum(prog[k] ** 2 for k in ref))
    return abs(side - whole) / whole if whole > 0 else 0.0


def shares(norms_: Norms) -> Norms:
    """Each leaf's norm over the whole phase's (the root of the sum of squares)."""
    whole = math.sqrt(sum(v * v for v in norms_.values()))
    return {k: (v / whole if whole > 0 else 0.0) for k, v in norms_.items()}


def share_median_gap(prog: Norms, ref: Norms) -> float:
    """The median leaf's gap of its share of the phase's norm (over the leaves
    with a reference gradient)."""
    live = [k for k, v in ref.items() if v > 0]
    return median_leaf_gap(shares(prog), shares(ref), live)


def moved_leaves(ref_grads: Norms) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the median leaf's."""
    live = [v for v in ref_grads.values() if v > 0]
    if not live:
        return []
    floor = NOUGHT * statistics.median(live)
    return [k for k, v in ref_grads.items() if v >= floor]


def loss_gap(prog: Sequence[Mapping[str, float]], ref: Sequence[Mapping[str, float]],
             keys=("loss_e", "loss_d")) -> float:
    gap = 0.0
    for p, r in zip(prog, ref):
        for k in keys:
            if not (math.isfinite(p[k]) and math.isfinite(r[k])):
                return math.inf
            gap = max(gap, abs(p[k] - r[k]) / max(abs(r[k]), 1e-30))
    return gap


def numbers(side: dict, ref: dict, ref_d: Norms, feed_wrong: int) -> Dict[str, float]:
    """Every number the cells may compare: ``side`` (the program, or a control
    or fault in its place) against ``ref``, each ``{"losses": [{loss_e,
    loss_d}] * 3, "grad_e": Norms, "grad_d": Norms, "change": Norms, "ema":
    Norms (optional)}``; ``ref_d`` the reference's first D phase from the
    side's own encoder after its first E update. A cell's ``limits`` name the
    numbers it compares."""
    moved = moved_leaves(dict(ref["grad_e"], **ref["grad_d"]))
    out = {"feed_rows_wrong": float(feed_wrong),
           "loss1_e_gap": loss_gap(side["losses"][:1], ref["losses"][:1], ("loss_e",)),
           "loss1_d_gap": loss_gap(side["losses"][:1], ref["losses"][:1], ("loss_d",)),
           "loss_gap": loss_gap(side["losses"], ref["losses"]),
           "kl1_gap": loss_gap(side["losses"][:1], ref["losses"][:1], ("kl",))}
    for phase, theirs in (("e", ref["grad_e"]), ("d", ref_d)):
        live = [k for k, v in theirs.items() if v > 0]
        out[f"grad_{phase}_gap"] = worst_leaf_gap(side[f"grad_{phase}"], theirs)
        out[f"grad_{phase}_median_gap"] = median_leaf_gap(side[f"grad_{phase}"], theirs, live)
        out[f"grad_{phase}_norm_gap"] = whole_gap(side[f"grad_{phase}"], theirs)
        out[f"grad_{phase}_share_median_gap"] = share_median_gap(side[f"grad_{phase}"], theirs)
    for key in ("change", "ema"):
        if key in ref:
            out[f"{key}_gap"] = worst_leaf_gap(side[key], ref[key], moved)
            out[f"{key}_median_gap"] = median_leaf_gap(side[key], ref[key], moved)
    return out


def replay_numbers(side: dict, ref: dict) -> Dict[str, float]:
    """The replays' numbers (module doc), ``side`` against ``ref`` as in
    ``numbers``, both from the program's state before the first replay."""
    moved = moved_leaves(dict(ref["grad_e"], **ref["grad_d"]))
    live = [k for k, v in ref["grad_e"].items() if v > 0]
    out = {"replay_loss_e_gap": loss_gap(side["losses"][:1], ref["losses"][:1], ("loss_e",)),
           "replay_kl_gap": loss_gap(side["losses"][:1], ref["losses"][:1], ("kl",)),
           "replay_loss_gap": loss_gap(side["losses"], ref["losses"]),
           "replay_grad_e_gap": worst_leaf_gap(side["grad_e"], ref["grad_e"]),
           "replay_grad_e_median_gap": median_leaf_gap(side["grad_e"], ref["grad_e"], live),
           "replay_grad_e_share_median_gap": share_median_gap(side["grad_e"], ref["grad_e"])}
    for key in ("change", "ema"):
        if key in ref:
            out[f"replay_{key}_gap"] = worst_leaf_gap(side[key], ref[key], moved)
            out[f"replay_{key}_median_gap"] = median_leaf_gap(side[key], ref[key], moved)
    return out


def look(side: dict, ref: dict, ref_d: Norms) -> Dict[str, List]:
    """The worst leaves of each number, for the record."""
    moved = moved_leaves(dict(ref["grad_e"], **ref["grad_d"]))
    return {"grad_e": worst_leaves(side["grad_e"], ref["grad_e"]),
            "grad_d": worst_leaves(side["grad_d"], ref_d),
            "change": worst_leaves(side["change"], ref["change"], moved)}


def judge(values: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(k in values and values[k] <= limits[k] for k in limits)
