# %% [markdown]
# # Soft-IntroVAE from scratch in PyTorch — Part 3: the bootstrap variant
#
# *The PyTorch/CUDA re-telling of the reference tutorial*
# (`soft_intro_vae_tutorial/soft_intro_vae_bootstrap_code_tutorial.ipynb`),
# the counterpart of `tutorial_bootstrap.py` for `soft_intro_vae_torch`.
# Prerequisites: Part 1 (theory + 2D) and Part 2 (images).
#
# Knobs (environment variables): `TUTORIAL_EPOCHS` (default 3),
# `TUTORIAL_IMAGES` (synthetic CIFAR-shaped images, default 2048),
# `TUTORIAL_RUN_FRAMEWORK=0` (skip the framework run), `TUTORIAL_DEVICE`
# (`cuda` by default; `cpu` runs without a GPU) and `TUTORIAL_OUT`.
#
# ## 1. The problem with $\gamma_r$
#
# The decoder objective's last term asks the decoder to *reconstruct its own
# fakes*:
#
# $$\mathcal{L}_D = s\,\big(\beta_{rec}\mathcal{L}_r(x)
#    + \tfrac{\beta_{kl}}{2}(\mathrm{KL}(\hat x) + \mathrm{KL}(x_f))
#    + \gamma_r\,\tfrac{\beta_{rec}}{2}(\mathcal{L}_r(\hat{\hat x}) + \mathcal{L}_r(\hat x_f))\big).$$
#
# In plain Soft-IntroVAE the target of that reconstruction is the decoder's
# own moving output; early in training, when fakes are noise, it drags the
# decoder toward reproducing noise, so the reference keeps $\gamma_r = 10^{-8}$.
#
# ## 2. The fix: a frozen target decoder
#
# The **bootstrap** variant keeps a frozen copy $D_{\bar\theta}$ of the
# decoder (a target network, as in DQN) and refreshes it every
# `copy_to_target_freq` epochs; decoding through it makes the term stable
# self-distillation, and **$\gamma_r$ defaults to 1.0**.
#
# | site | plain | bootstrap |
# |---|---|---|
# | E-phase decode of the judged codes $z_r, z_f$ | online decoder | **frozen target** |
# | D-phase decode of $z_{rec}, z_{fake}$ | online decoder, codes **detached** | **frozen target**, codes **not** detached |
# | D-phase rec-of-fake targets $\hat x, x_f$ | detached | **not** detached |
# | $\gamma_r$ | $10^{-8}$ | **1.0** |
# | vanilla warm-up reconstruction | online decoder | **frozen target** |

# %%
import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch
import torch.nn as nn

DEVICE = torch.device(os.environ.get("TUTORIAL_DEVICE", "cuda"))
OUT = os.environ.get("TUTORIAL_OUT", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "torch_tutorial_bootstrap_results"))
os.makedirs(OUT, exist_ok=True)

# %% [markdown]
# ## 3. The target copy in PyTorch
#
# The target is a second module with its own tensors, never given to an
# optimizer, its parameters `requires_grad_(False)`; a refresh copies the
# online decoder's parameters *and BatchNorm buffers* into it. "Frozen"
# means its parameters take no gradient; a gradient still flows *through*
# it to its input, which is what the bootstrap D phase uses.

# %%
torch.manual_seed(92)
online = nn.Sequential(nn.Linear(8, 32), nn.BatchNorm1d(32), nn.ReLU(), nn.Linear(32, 4)).to(DEVICE)
target = copy.deepcopy(online).requires_grad_(False)


@torch.no_grad()
def refresh(target: nn.Module, online: nn.Module) -> None:
    target.load_state_dict(online.state_dict())  # a copy into the target's own tensors


with torch.no_grad():
    online[0].weight.add_(0.1)          # a training step moves the online net ...
refresh(target, online)                 # ... and an epoch boundary copies it over
print(f"target == online after a refresh: {torch.equal(target[0].weight, online[0].weight)}; "
      f"own storage: {target[0].weight.data_ptr() != online[0].weight.data_ptr()}")
z = torch.randn(16, 8, device=DEVICE, requires_grad=True)
target(z).square().mean().backward()
print(f"gradient reaches the input through the frozen target: {z.grad.abs().sum() > 0}; "
      f"the target's parameters took none: {all(p.grad is None for p in target.parameters())}")

# %% [markdown]
# ## 4. The framework run
#
# `StepConfig(bootstrap=True)` in `soft_intro_vae_torch/train/step.py` is
# the generic step with the table's changes; `train/image.py
# sync_target_decoder` is the refresh. One vanilla epoch, then the game,
# the target refreshed every epoch.

# %%
if os.environ.get("TUTORIAL_RUN_FRAMEWORK", "1") == "1":
    from soft_intro_vae_torch.train.image import ImageConfig, train_soft_intro_vae

    cfg = ImageConfig(
        dataset="cifar10", z_dim=64, batch_size=32,
        num_epochs=int(os.environ.get("TUTORIAL_EPOCHS", 3)),
        num_vae=1,                  # §5: only the encoder moves this epoch
        beta_rec=1.0, beta_kl=1.0, beta_neg=64.0,
        gamma_r=1.0,                # the point of bootstrapping
        bootstrap=True, copy_to_target_freq=1,
        seed=92, result_dir=OUT, synthetic_fallback=True,
        synthetic_n=int(os.environ.get("TUTORIAL_IMAGES", 2048)),
        scan_steps=8 if DEVICE.type == "cuda" else 1, device=str(DEVICE))
    state, summary = train_soft_intro_vae(cfg)
    print(f"summary: {summary['last_metrics']}")

# %% [markdown]
# ## 5. The two claims that define the variant
#
# (a) right after an epoch-boundary refresh the target equals the online
# decoder; (b) the target's tensors are its own, so the next step moves the
# online decoder and leaves the target where it was.

# %%
if os.environ.get("TUTORIAL_RUN_FRAMEWORK", "1") == "1":
    online_sd, target_sd = state.decoder.state_dict(), state.target_decoder.state_dict()
    same = all(torch.equal(online_sd[k], target_sd[k]) for k in online_sd)
    shared = any(online_sd[k].data_ptr() == target_sd[k].data_ptr() for k in online_sd)
    print(f"online decoder == target after the last refresh: {same}; shared storage: {shared}")

# %% [markdown]
# ## 6. When to reach for bootstrap
#
# The more stable trainer for small and medium image datasets, where the
# cycle term helps sharpness and the second decoder's memory is affordable.
# The CLI has it as its own subcommand with the `image` flags:
# ```
# python -m soft_intro_vae_torch.cli.main bootstrap -d cifar10 -n 250 -z 128 \
#     -b 32 -r 1.0 -k 1.0 -e 256 -g 1.0 --copy_to_target_freq 1 -s 92
# ```
# The port's bootstrap step is held to the JAX package's on the same weights
# and draws (`tests/test_torch_port_image_step.py`).
