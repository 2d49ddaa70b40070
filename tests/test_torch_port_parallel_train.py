"""The port's trainers under two gloo ranks against one rank, on the CPU.

``parallel/verify.py training_probe`` runs each trainer at a tiny width in
2 ranks (global batch 4, two rows a rank) and in 1, from the same seed:
  * image: ``train_soft_intro_vae``, one vanilla and one intro epoch on 8
    uint8 images (channels (8, 16), 16x16, z 8);
  * 3D: ``train_soft_intro_vae_3d``, two epochs on 16 synthetic clouds of 64
    points, the valid JSD scored by rank 0 each epoch;
  * style: ``train_style_soft_intro_vae``, four epochs over LOD 0 and 1 with
    a LOD switch and a blended epoch; the 2-rank config's LOD_2_BATCH_1GPU
    table would take batch 8 at LOD 1, its 2GPU table batch 4, so only the
    2GPU table's pick lands on the 1-rank run (1GPU table batch 4).
The 3D and style runs train at learning rate 0: their first Adam steps move
every weight by about lr * sign(g), also where g is rounding noise (the
style decoder's first block bias before an instance norm, the 3D chamfer's
near-ties), and at the recipes' rates the 2- and 1-rank runs drift apart by
up to 12% (3D expELBO) and 22% (style fake_kl) over these epochs; the
one-step probes hold the gradients (tests/test_torch_port_parallel_*.py).
At rate 0 every other part of the trainer still runs: rows, draws, BN and
dlatent_avg statistics, the LOD switch and the blend.
Held: the ranks' final weights and buffers bit-equal; the last epoch's
metrics within rel 1e-4 of the 1-rank run's; only rank 0 writes: its
output directory holds the run's files (for the image trainer exactly one
checkpoint and one log.csv) and rank 1's is never created.
"""

import glob
import os

import numpy as np
import pytest

from soft_intro_vae_torch.parallel.launch import run_ranks, write_inputs
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

STYLE = dict(layer_count=3, start_channel_count=8, max_channel_count=32, latent_space_size=16,
             mapping_layers=3, use_synthetic=True, synthetic_n=8, epochs_per_lod=2,
             train_epochs=4, num_vae=1, learning_rates=[0.0], verbose=False, resume=False,
             seed=3)
CONFIGS = {
    "image": dict(dataset="cifar10", z_dim=8, batch_size=4, num_epochs=2, num_vae=1,
                  beta_neg=16.0, seed=0, verbose=False),
    "3d": dict(n_points=64, batch_size=4, max_epochs=2, z_size=8, beta_neg=16.0, seed=0,
               valid_frequency=1, save_frequency=1, use_synthetic=True, synthetic_n=16,
               verbose=False, lr_e=0.0, lr_d=0.0),
    "style": STYLE,
}
OUT_KEY = {"image": "result_dir", "3d": "results_dir", "style": "output_dir"}
TABLES = {2: {"1GPU": [4, 8, 4], "2GPU": [4, 4, 4]}, 1: {"1GPU": [4, 4, 4]}}


def _run(tmp_path, variant, world):
    cfg = dict(CONFIGS[variant])
    cfg[OUT_KEY[variant]] = str(tmp_path / f"w{world}_rank{{rank}}")
    if variant == "style":
        cfg["lod_2_batch_tables"] = TABLES[world]
    inputs = None
    if variant == "image":
        images = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
        inputs = write_inputs(str(tmp_path / f"in{world}.npz"), {"run": dict(images=images)})
    job = [dict(name="run", probe="training_probe", kwargs=dict(variant=variant, config=cfg))]
    return run_ranks(world, job, str(tmp_path), inputs=inputs)


@pytest.mark.parametrize("variant", ["image", "3d", "style"])
def test_two_ranks_train_as_one(tmp_path, variant):
    two = _run(tmp_path, variant, 2)
    (one,) = _run(tmp_path, variant, 1)
    states = [k for k in one if k.startswith("run/state/")]
    assert states and set(two[0]) == set(one)
    for k in two[0]:
        np.testing.assert_array_equal(two[0][k], two[1][k], err_msg=f"rank skew in {k}")
    for k in one:
        if k.startswith("run/metric/"):
            assert float(two[0][k]) == pytest.approx(float(one[k]), rel=1e-4, abs=1e-6), k
    assert not (tmp_path / "w2_rank1").exists()
    ours = str(tmp_path / "w2_rank0")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(tmp_path / "w1_rank0"))
    if variant == "image":
        assert len(glob.glob(f"{ours}/saves/*.ckpt")) == 1
        assert len(glob.glob(f"{ours}/**/log.csv", recursive=True)) == 1
