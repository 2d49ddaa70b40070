"""The port's ``toy`` subcommand on the CPU: the reference 2D main.py's flags
and defaults (as the JAX package's CLI has them), a short run at the
recipe's own width (3 hidden layers of 256) that appends the results line,
and the CUDA default that raises without a GPU."""

import dataclasses

import pytest
import torch

from soft_intro_vae_tpu.cli.main import build_parser as jax_build_parser
from soft_intro_vae_torch.cli import main as cli
from soft_intro_vae_torch.train import toy as toy_trainer
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def test_toy_flags_and_defaults_match_the_jax_cli():
    port = vars(cli.build_parser().parse_args(["toy", "-d", "rings"]))
    ref = vars(jax_build_parser().parse_args(["toy", "-d", "rings"]))
    assert port.pop("device") == "cuda" and ref.pop("device") == -1
    assert port == ref
    assert (port["batch_size"], port["num_vae"], port["beta_rec"], port["beta_kl"],
            port["beta_neg"]) == (512, 2000, 0.2, 0.3, 0.9)
    assert cli.build_parser().parse_args(["toy", "-d", "rings", "-c", "1"]).device == "cuda:1"


@pytest.mark.parametrize("dataset, scale", [("8Gaussians", 1.0), ("2spirals", 2.0)])
def test_toy_config_from_the_flags(monkeypatch, dataset, scale):
    seen = {}
    monkeypatch.setattr(toy_trainer, "train_soft_intro_vae_toy", lambda cfg: seen.update(cfg=cfg))
    cli.main(["toy", "-d", dataset, "-n", "7", "-z", "3", "-s", "4", "-c", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.dataset, cfg.n_iter, cfg.z_dim, cfg.seed, cfg.scale, cfg.device) == (
        dataset, 7, 3, 4, scale, "cpu")
    assert (cfg.batch_size, cfg.num_vae, cfg.test_iter, cfg.save_interval, cfg.pretrained) == (
        512, 2000, 5000, 5000, None)
    assert (cfg.n_layers, cfg.num_hidden) == (3, 256)


def test_toy_cli_runs_on_the_cpu_and_appends_the_results_line(tmp_path, monkeypatch):
    """Three iterations (one vanilla, two intro) at the recipe's width, then
    the final metrics over the 1024x1024 grid (~20 s on one thread)."""
    monkeypatch.chdir(tmp_path)
    cli.main(["toy", "-d", "8Gaussians", "-n", "3", "-b", "8", "-v", "1", "-s", "0", "-c", "cpu"])
    with open(tmp_path / "results_toy" / "results_log_soft_intro_vae.txt") as f:
        line = f.read()
    assert line.startswith("8Gaussians_beta_kl_0.3_beta_neg_0.9_beta_rec_0.2_gnelbo_")
    assert line.endswith("_seed_0\n")


def test_cuda_default_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert toy_trainer.ToyConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["toy", "-d", "8Gaussians", "-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        toy_trainer.build_toy(dataclasses.replace(toy_trainer.ToyConfig(), device="cuda:0"))
