"""The reference against the program's step at a tiny size on the CPU, and a
whole run driven here (the look for a card skipped) with the timed path
broken underneath: each fault a training cell can have on one card must turn
``correct`` false, also where it breaks only the steps after the first three
(on the card the graph's replays, which every window step is)."""

import copy
import time

import pytest
import torch

from benchmark.core import harness
from benchmark.families.common import START_STEPS

from .conftest import tiny_image, tiny_style

SEED = 2 ** 33 + 5


def run(cfg, cell, trace=0, workload="image-cifar10.b32", seconds=0.5):
    args = harness.parse(["--workload", workload, "--seed", str(SEED), "--seconds", str(seconds),
                          "--trace", str(trace)])
    return harness.run_cell(args, harness.manifest(), cfg, cell, time.perf_counter(), "cpu",
                            harness.peaks("H100"))


def test_image_run_is_correct_and_tight(data_dir):
    cfg, cell = tiny_image()
    res = run(cfg, cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["feed_rows_wrong"]["value"] == 0
    for k in ("loss1_e_gap", "grad_d_gap", "change_median_gap", "replay_loss_gap",
              "replay_change_median_gap"):
        assert res["checks"][k]["value"] < 1e-5
    assert {"setup_s", "train_samples_per_s", "step_ms_p90", "peak_mem_gib"} <= set(res["metrics"])


def test_style_run_is_correct_with_a_traced_stretch(data_dir):
    cfg, cell = tiny_style()
    res = run(cfg, cell, trace=1, workload="style-ffhq256.lod6-b32", seconds=3)
    assert res["correct"], res["checks"]
    assert res["checks"]["feed_rows_wrong"]["value"] == 0
    assert {"feed.wait_share", "feed.host_ms_per_batch", "step.mfu",
            "device.idle_share"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_style_first_step_against_the_program(data_dir):
    """The first step's losses, where the program and the reference still see
    the same weights: within 2e-3 (the program's fused norm folds a constant
    plane's normalisation into one affine, off by rounding times 1e4)."""
    from benchmark.core.checks import loss_gap
    from benchmark.core.timing import Spans

    cfg, cell = tiny_style()
    fam = harness.family_class("style")(cfg, dict(cell, warmup_steps=3), SEED, Spans(), "cpu")
    fam.setup()
    fam.close()
    recs, matched, wrong = fam.check_feed()
    assert wrong == 0
    ref = fam.reference(recs, matched)
    assert loss_gap(fam.readings.losses[:1], ref[0].losses[:1]) < 2e-3


def _unchanged(step):
    def run_step(state, x, *args):
        nets = state.nets if hasattr(state, "nets") else state.model
        kept = {k: v.detach().clone() for k, v in nets.state_dict().items()}
        state, m = step(state, x, *args)
        nets.load_state_dict(kept)
        return state, m
    return run_step


def _half(step):
    def run_step(state, x, *args):
        return step(state, x[: x.shape[0] // 2], *args)
    return run_step


def _altered_feed(prefetch):
    def fed(*a, **kw):
        for item in prefetch(*a, **kw):
            x = item[0] if isinstance(item, tuple) else item
            x[0] = (x[0] + 1) if x.dtype == torch.uint8 else x[0] * 0.5
            yield item
    return fed


def _after_start(wrap):
    """``wrap`` from the step after the start on: the replays' fault."""
    def apply(step):
        broken, calls = wrap(step), [0]

        def run_step(state, x, *args):
            calls[0] += 1
            return (step if calls[0] <= START_STEPS else broken)(state, x, *args)
        return run_step
    return apply


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half,
          "state_unchanged_in_replays": _after_start(_unchanged),
          "half_batch_in_replays": _after_start(_half)}


@pytest.mark.parametrize("family", ["image", "style"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer",
                                   "state_unchanged_in_replays", "half_batch_in_replays"])
def test_a_broken_timed_path_is_not_correct(family, fault, data_dir, monkeypatch):
    import soft_intro_vae_torch.data.prefetch as prefetch
    import soft_intro_vae_torch.train.graph as graph
    import soft_intro_vae_torch.train.step as step

    if fault == "altered_answer":
        monkeypatch.setattr(prefetch, "device_prefetch", _altered_feed(prefetch.device_prefetch))
    else:
        wrap = FAULTS[fault]
        for mod in (graph, step):
            real = mod.one_step
            monkeypatch.setattr(mod, "one_step", lambda s, real=real, wrap=wrap: real(wrap(s)))
    cfg, cell = tiny_image() if family == "image" else tiny_style()
    res = run(copy.deepcopy(cfg), cell,
              workload="image-cifar10.b32" if family == "image" else "style-ffhq256.lod6-b32")
    assert not res["correct"], res["checks"]
