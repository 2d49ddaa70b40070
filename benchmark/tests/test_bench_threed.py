"""The 3D family on the CPU at a tiny size (64 points, PointNet widths (8, 16,
16, 16, 32), MLP widths (8, 16, 32, 64), z 8, batch 4, 64 clouds): a whole
run is correct and tight; each fault of the timed path turns ``correct``
false, also where it breaks only the steps after the first three (on the
card the graph's replays); the chamfer roofline's count at the published
size; ``feed.gather_share`` on a hand-made ring."""

import copy
import dataclasses
import time

import pytest
import torch

from benchmark.core import harness
from benchmark.core.timing import Spans, Trace

from .test_bench_program_spans import _run as _spans_run, ring  # noqa: F401
from .test_bench_reference import _after_start, _unchanged

SEED = 2 ** 33 + 25
WORKLOAD = "threed-hp.b32"


def tiny_threed():
    cfg = copy.deepcopy(harness.load_json(harness.HERE, "configs", "threed-hp.json"))
    cfg.update(n_points=64, z_size=8)
    cfg["model"].update(conv_channels=[8, 16, 16, 16, 32], hidden=[8, 16, 32, 64])
    cell = {"batch": 4, "records": 64, "warmup_steps": 6, "trace_steps": 2,
            "limits": {"feed_rows_wrong": 0, "loss1_e_gap": 1e-4, "grad_e_median_gap": 2e-3,
                       "grad_d_share_median_gap": 2e-3, "change_median_gap": 1e-3, "replay_loss_e_gap": 1e-4,
                       "replay_change_median_gap": 1e-3}}
    return cfg, cell


def run(cfg, cell, trace=0, seconds=0.5):
    args = harness.parse(["--workload", WORKLOAD, "--seed", str(SEED), "--seconds", str(seconds),
                          "--trace", str(trace)])
    return harness.run_cell(args, harness.manifest(), cfg, cell, time.perf_counter(), "cpu",
                            harness.peaks("H100"))


def test_threed_run_is_correct_and_tight():
    """Every number at most a fifth of its limit. The gradient's limit is the
    widest: at 4 x 64 points one nearest point that flips between near-ties
    (the reference's published bmm form against the program's differences)
    moves a leaf's gradient norm by up to 4e-4 (1e-7 without a flip)."""
    cfg, cell = tiny_threed()
    res = run(cfg, cell, trace=1, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["feed_rows_wrong"]["value"] == 0
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"] / 5, (k, v)
    assert {"step.mfu", "device.idle_share", "feed.gather_share"} <= set(res["metrics"])
    assert 0 < res["metrics"]["feed.gather_share"]["value"] < 100


def _foreign_row(batches):
    def fed(*a, **kw):
        for x in batches(*a, **kw):
            x = x.clone()
            x[0] = x[0] * 0.5   # a cloud that is no record
            yield x
    return fed


def _wide_prior(build):
    def built(cfg, *a, **kw):
        return build(dataclasses.replace(cfg, prior_std=1.0), *a, **kw)
    return built


def _one_direction(preds, gts, impl="auto"):
    """Chamfer with the sum over ``gts`` of their nearest ``preds`` alone."""
    from soft_intro_vae_torch.ops.chamfer import pairwise_sqdist

    return pairwise_sqdist(gts.float(), preds.float()).min(dim=2)[0].sum(dim=1)


def _no_kl_in_loss_d(kl_divergence):
    """``kl_divergence`` with the D phase's two KL terms (the fourth and
    fifth of the intro step's five calls) made nought: ``loss_d`` without
    its KL, the E phase as it was."""
    calls = [0]

    def kl(*a, **kw):
        calls[0] += 1
        out = kl_divergence(*a, **kw)
        return out * 0.0 if calls[0] % 5 in (4, 0) else out
    return kl


def _one_direction_in_replays(step_module):
    real = step_module.chamfer_distance
    calls = [0]

    def chamfer(preds, gts, impl="auto"):
        calls[0] += 1   # six calls a step
        return (real if calls[0] <= 6 * 3 else _one_direction)(preds, gts, impl)
    return chamfer


@pytest.mark.parametrize("fault", ["foreign_row", "prior_std_1", "one_chamfer_direction",
                                   "one_chamfer_direction_in_replays",
                                   "state_unchanged_in_replays", "no_kl_in_loss_d"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    import soft_intro_vae_torch.train.graph as graph
    import soft_intro_vae_torch.train.step as step
    import soft_intro_vae_torch.train.threed as threed

    if fault == "foreign_row":
        monkeypatch.setattr(threed, "epoch_batches", _foreign_row(threed.epoch_batches))
    elif fault == "prior_std_1":
        monkeypatch.setattr(threed, "build_3d_training", _wide_prior(threed.build_3d_training))
    elif fault == "one_chamfer_direction":
        monkeypatch.setattr(step, "chamfer_distance", _one_direction)
    elif fault == "one_chamfer_direction_in_replays":
        monkeypatch.setattr(step, "chamfer_distance", _one_direction_in_replays(step))
    elif fault == "no_kl_in_loss_d":
        monkeypatch.setattr(step, "kl_divergence", _no_kl_in_loss_d(step.kl_divergence))
    else:
        wrap = _after_start(_unchanged)
        for mod in (graph, step):
            real = mod.one_step
            monkeypatch.setattr(mod, "one_step", lambda s, real=real: real(wrap(s)))
    cfg, cell = tiny_threed()
    res = run(cfg, cell)
    assert not res["correct"], res["checks"]
    if fault == "foreign_row":
        assert res["checks"]["feed_rows_wrong"]["value"] > 0
    if fault.endswith("_in_replays"):   # the start is right, the replays are not
        assert res["checks"]["loss1_e_gap"]["value"] < 1e-4
    if fault == "no_kl_in_loss_d":     # the E phase is right, the D phase is not
        assert res["checks"]["loss1_e_gap"]["value"] < 1e-4
        assert res["checks"]["grad_e_median_gap"]["value"] < 2e-3
        d = res["checks"]["grad_d_share_median_gap"]
        assert d["value"] > d["limit"], d


def test_chamfer_roofline_counts_six_calls_at_the_published_size():
    cr = harness._load("metrics", "kernels.chamfer_roofline")
    cfg = harness.load_json(harness.HERE, "configs", "threed-hp.json")
    cell = harness.load_json(harness.HERE, "workloads", f"{WORKLOAD}.json")
    fam = harness.family_class("threed")(cfg, cell, 1, Spans(), "cpu")
    calls = cr.step_calls(fam)
    assert calls == {(32, 2048, 2048): 6}
    assert 32 * 2048 * 2048 == 134_217_728
    assert cr.step_ops(calls) == 6 * 134_217_728 * 8
    # the bound: 0.1923 ms a step at half of 67 TFLOP/s
    assert cr.step_ops(calls) / (67e12 / 2) * 1e3 == pytest.approx(0.19231, abs=1e-5)


def test_mfu_counts_the_nets_and_no_chamfer_matmul():
    """step.mfu's step is the reference's less exactly the published
    chamfer's ``bmm``s, forward and backward: the program searches in its
    own kernel, which ``kernels.chamfer_roofline`` counts."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from benchmark.reference.common import Draws, Precision
    from benchmark.reference.threed_ref import ThreeDReference

    mfu = harness._load("metrics", "step.mfu")
    cfg = harness.load_json(harness.HERE, "configs", "threed-hp.json")
    cell = harness.load_json(harness.HERE, "workloads", f"{WORKLOAD}.json")
    fam = harness.family_class("threed")(cfg, cell, 1, Spans(), "cpu")

    class ByOp(mfu.FlopsByType):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = sum(self.flops.values())
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = func._overloadpacket.__name__
            ops[name] = ops.get(name, 0) + sum(self.flops.values()) - before
            return out

    ops = {}
    with ByOp() as whole:
        x = torch.empty(32, cfg["n_points"], 3, device="meta")
        ThreeDReference(cfg, "meta", Precision()).step(x, Draws(None, "meta"))
    counted = sum(mfu.step_flops(fam).values())
    assert ops["bmm"] > 0 and isinstance(whole, TorchDispatchMode)
    assert counted == sum(whole.flops.values()) - ops["bmm"]
    # the nets' convolutions (405.05 GFLOP) and matmuls (8.55) at the
    # published size
    assert counted == 413_601_366_016


def test_chamfer_roofline_on_a_hand_made_trace():
    cr = harness._load("metrics", "kernels.chamfer_roofline")
    cfg, cell = tiny_threed()
    fam = harness.family_class("threed")(cfg, cell, 1, Spans(), "cpu")
    ops = cr.step_ops(cr.step_calls(fam))
    assert ops == 6 * 4 * 64 * 64 * 8
    tr = Trace()
    tr.steps = 2
    secs = 2 * 4 * ops / 1e9    # the kernel takes 4 x its bound over two steps
    name = "nearest_pair_kernel(float const*, float const*, float*, long*, float*, long*, int)"
    tr.ops = [(name, 0.0, secs / 2 * 1e6), (name, 10.0, secs / 2 * 1e6), ("other", 20.0, 1e6)]
    got = cr.read(harness.Run(trace=tr, fam=fam, peaks={"fp32": 2e9}))
    assert got == pytest.approx(25.0)
    tr.ops = [("other", 0.0, 5.0)]
    assert cr.read(harness.Run(trace=tr, fam=fam, peaks={"fp32": 2e9})) is None
    assert cr.read(harness.Run(trace=None, fam=fam)) is None


def test_gather_share_sums_the_gathers_inside_the_window(ring):  # noqa: F811
    ring("feed.gather", 99.5, 100.5)       # half inside
    ring("feed.gather", 104.0, 104.25)
    ring("graph.replay", 104.25, 105.0)    # not a gather
    ring("feed.gather", 109.9, 110.3)      # 0.1 s inside
    got = harness.load_reader("feed.gather_share")(_spans_run())
    assert got == pytest.approx(100.0 * 0.85 / 10.0)
    ring.ring.records.clear()
    ring("graph.replay", 101.0, 102.0)
    assert harness.load_reader("feed.gather_share")(_spans_run()) is None
