# %% [markdown]
# # Soft-IntroVAE from scratch in PyTorch — Part 1: the 2D tutorial
#
# *The PyTorch/CUDA re-telling of the reference tutorial*
# (`soft_intro_vae_tutorial/soft_intro_vae_2d_code_tutorial.ipynb`,
# Daniel & Tamar, ["Soft-IntroVAE: Analyzing and Improving the Introspective
# Variational Autoencoder"](https://arxiv.org/abs/2012.13253), CVPR 2021),
# the counterpart of `tutorial_2d_toy.py` for the `soft_intro_vae_torch`
# package.
#
# This file is a **jupytext percent-format notebook**: run it as a script
# (`python examples/torch_tutorial_2d_toy.py`), open it in Jupyter, or read
# the generated `torch_tutorial_2d_toy.ipynb` beside it. The algorithm is
# built inline in plain PyTorch first, so every moving part is visible; the
# last sections run the same recipe through `soft_intro_vae_torch.train.toy`.
#
# Knobs (environment variables): `TUTORIAL_ITERS` (iterations of the inline
# run, default 6000; the full recipe is 30000), `TUTORIAL_RUN_FRAMEWORK=1`
# (also run the framework recipe with the paper's metrics),
# `TUTORIAL_DEVICE` (`cuda` by default; `cpu` to run without a GPU) and
# `TUTORIAL_OUT` (where the figures go).
#
# **Agenda**
# 1. Variational Autoencoders: the ELBO and the reparameterization trick
# 2. From ELBO to Soft-IntroVAE: the expELBO and the two-phase game
# 3. A from-scratch implementation on 2D toy distributions
# 4. Training, plots, and what to look for
# 5. The framework way (`soft_intro_vae_torch.train.toy`) + paper metrics
# 6. GPU notes: why the step looks the way it does

# %% [markdown]
# ## 1. Variational Autoencoders in four equations
#
# A VAE models data with a latent variable: $p_\theta(x) = \int p_\theta(x|z)\,p(z)\,dz$
# with a fixed prior $p(z) = \mathcal{N}(0, I)$. The posterior is intractable,
# so **variational inference** learns a Gaussian
# $q_\phi(z|x) = \mathcal{N}(\mu_\phi(x), \mathrm{diag}\,\sigma^2_\phi(x))$
# (the **encoder**) and maximizes a lower bound on the evidence:
#
# $$\log p_\theta(x) \;\ge\; \underbrace{\mathbb{E}_{q_\phi(z|x)}\big[\log p_\theta(x|z)\big]}_{-\,\text{reconstruction error } \mathcal{L}_r}
#   \;-\; \underbrace{D_{KL}\big(q_\phi(z|x)\,\|\,p(z)\big)}_{\text{closed form for Gaussians}}
#   \;=\; \mathrm{ELBO}(x).$$
#
# With a Gaussian decoder the reconstruction term is a squared error between
# $x$ and the decoder output $D_\theta(z)$, and the KL between two diagonal
# Gaussians is
#
# $$D_{KL} = -\tfrac12 \sum_d \big(1 + \log\sigma_d^2 - \sigma_d^2 - \mu_d^2\big).$$
#
# The **reparameterization trick** makes the expectation differentiable:
# draw $\varepsilon \sim \mathcal{N}(0, I)$, set $z = \mu + \sigma \odot
# \varepsilon$; gradients flow through $\mu$ and $\sigma$. In PyTorch the
# draw comes from a `torch.Generator` we own, so a run is reproducible.

# %% [markdown]
# ## 2. From ELBO to Soft-IntroVAE
#
# A VAE trained on the ELBO alone gives blurry samples. **Introspective**
# VAEs let *the encoder itself* judge realism: the ELBO acts as an energy.
# The encoder maximizes the ELBO of real data and *minimizes* the ELBO of
# decoder outputs ("fakes": prior samples $D_\theta(z')$ and
# reconstructions); the decoder maximizes the ELBO the frozen encoder gives
# its outputs. Soft-IntroVAE pushes fakes away with the **exponent** of the
# ELBO, which saturates by itself:
#
# $$\mathrm{expELBO}(y) = \exp\!\big({-2s}\,(\beta_{rec}\mathcal{L}_r(y) + \beta_{neg}\mathrm{KL}(y))\big).$$
#
# The objectives (minimized; $s$ a dimension scale):
#
# $$\mathcal{L}_E = s\,(\beta_{rec}\mathcal{L}_r(x) + \beta_{kl}\mathrm{KL}(x))
#    + \tfrac14\big(\mathrm{expELBO}(\hat x) + \mathrm{expELBO}(x_f)\big),$$
# $$\mathcal{L}_D = s\,\big(\beta_{rec}\mathcal{L}_r(x)
#    + \tfrac{\beta_{kl}}{2}(\mathrm{KL}(\hat x) + \mathrm{KL}(x_f))
#    + \gamma_r\,\tfrac{\beta_{rec}}{2}(\mathcal{L}_r(\hat{\hat x}) + \mathcal{L}_r(\hat x_f))\big).$$
#
# Each iteration runs **two optimizer phases in order**: the encoder with
# $\mathcal{L}_E$ (decoder frozen), then the decoder with $\mathcal{L}_D$
# against the *just-updated* encoder.

# %%
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

DEVICE = torch.device(os.environ.get("TUTORIAL_DEVICE", "cuda"))
OUT = os.environ.get("TUTORIAL_OUT", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "torch_tutorial_2d_results"))
os.makedirs(OUT, exist_ok=True)

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    HAVE_MPL = True
except ImportError:  # the figures are optional
    HAVE_MPL = False

# %% [markdown]
# ## 3a. The data: 2D toy distributions
#
# The paper's 2D suite makes the game *visible*. Here is 8Gaussians inline;
# the framework's `data/toy.py` has all six distributions.


# %%
def sample_8gaussians(rng: np.random.Generator, n: int) -> np.ndarray:
    centers = np.array([(np.cos(t), np.sin(t)) for t in np.linspace(0, 2 * np.pi, 9)[:-1]],
                       np.float32) * 2.0
    idx = rng.integers(0, 8, size=n)
    return (centers[idx] + 0.02 * rng.standard_normal((n, 2))).astype(np.float32) / 1.414


rng_np = np.random.default_rng(92)
real = sample_8gaussians(rng_np, 1024)
if HAVE_MPL:
    plt.figure(figsize=(4, 4))
    plt.scatter(real[:, 0], real[:, 1], s=4, alpha=0.5)
    plt.title("8 Gaussians — real samples")
    plt.gca().set_aspect("equal")
    plt.savefig(os.path.join(OUT, "real.png"), dpi=120)
    plt.close()

# %% [markdown]
# ## 3b. Architectures: two tiny MLPs
#
# Three hidden layers of 256 (the reference's `train_soft_intro_vae_2d.py`,
# the framework's `models/mlp.py`). The encoder emits $2 z_{dim}$ numbers,
# split into $(\mu, \log\sigma^2)$.


# %%
def mlp(n_in: int, n_out: int, hidden: int = 256) -> nn.Sequential:
    return nn.Sequential(nn.Linear(n_in, hidden), nn.ReLU(), nn.Linear(hidden, hidden), nn.ReLU(),
                         nn.Linear(hidden, hidden), nn.ReLU(), nn.Linear(hidden, n_out))


Z_DIM = 2
torch.manual_seed(92)
enc, dec = mlp(2, 2 * Z_DIM).to(DEVICE), mlp(Z_DIM, 2).to(DEVICE)


def encode(x):
    mu, logvar = enc(x).chunk(2, dim=1)
    return mu, logvar


# %% [markdown]
# ## 3c. The three loss primitives


# %%
def recon(x, r, reduce="mean"):
    """Squared error summed over dimensions, per sample (mse(sum)/B)."""
    e = ((x - r) ** 2).sum(dim=-1)
    return e.mean() if reduce == "mean" else e


def kl_gauss(mu, logvar, reduce="mean"):
    k = -0.5 * (1 + logvar - logvar.exp() - mu ** 2).sum(dim=-1)
    return k.mean() if reduce == "mean" else k


def exp_elbo(rec_i, kl_i, s, b_rec, b_neg):
    """mean_i exp(-2 s (b_rec rec_i + b_neg kl_i)): per sample, then averaged."""
    return torch.exp(-2.0 * s * (b_rec * rec_i + b_neg * kl_i)).mean()


# %% [markdown]
# ## 3d. The two-phase train step
#
# Two details matter and are easy to get wrong; the reference encodes them
# with `.detach()` and by switching `requires_grad` per phase:
#
# | tensor | E-phase | D-phase |
# |---|---|---|
# | fake / rec fed to the encoder's judging forwards | **detached** | **not** detached (the decoder's learning signal) |
# | expELBO reconstruction *target* `rec` | not detached | — |
# | latent `z` reused from the E-phase | — | detached |
# | codes `z_rec`/`z_fake` into the rec-of-fake decodes | — | detached |
#
# Freezing a subnet (`requires_grad_(False)`) keeps its parameters out of a
# phase's gradient while the gradient still flows *through* it.

# %%
S = 0.5                               # dimension scale of the 2D recipes
B_REC, B_KL, B_NEG = 0.2, 0.3, 0.9    # the paper's 8Gaussians recipe
GAMMA_R = 1e-8
LR = 2e-4

opt_e = torch.optim.Adam(enc.parameters(), lr=LR)
opt_d = torch.optim.Adam(dec.parameters(), lr=LR)
gen = torch.Generator(device=DEVICE)
gen.manual_seed(92)


def randn(*shape):
    return torch.randn(shape, generator=gen, device=DEVICE)


def trainable(net, flag):
    for p in net.parameters():
        p.requires_grad_(flag)


def vanilla_step(x):
    """Plain-VAE warm-up: one joint, unscaled ELBO step."""
    trainable(enc, True)
    trainable(dec, True)
    mu, logvar = encode(x)
    z = mu + randn(*mu.shape) * (0.5 * logvar).exp()
    loss = B_REC * recon(x, dec(z)) + B_KL * kl_gauss(mu, logvar)
    opt_e.zero_grad()
    opt_d.zero_grad()
    loss.backward()
    opt_e.step()
    opt_d.step()
    return loss.detach()


def intro_step(x):
    b = x.shape[0]
    noise = randn(b, Z_DIM)  # one z' batch, shared by both phases

    # ---------------- E phase: update the encoder ----------------
    trainable(enc, True)
    trainable(dec, False)
    fake = dec(noise)
    mu, logvar = encode(x)
    z = mu + randn(*mu.shape) * (0.5 * logvar).exp()
    rec_x = dec(z)
    l_rec, kl_real = recon(x, rec_x), kl_gauss(mu, logvar)
    rmu, rlv = encode(rec_x.detach())
    fmu, flv = encode(fake.detach())
    rec_rec = dec(rmu + randn(*rmu.shape) * (0.5 * rlv).exp())
    rec_fake = dec(fmu + randn(*fmu.shape) * (0.5 * flv).exp())
    ee_r = exp_elbo(recon(rec_x, rec_rec, "none"), kl_gauss(rmu, rlv, "none"), S, B_REC, B_NEG)
    ee_f = exp_elbo(recon(fake, rec_fake, "none"), kl_gauss(fmu, flv, "none"), S, B_REC, B_NEG)
    loss_e = S * (B_REC * l_rec + B_KL * kl_real) + 0.25 * (ee_r + ee_f)
    opt_e.zero_grad()
    loss_e.backward()
    opt_e.step()

    # ------------- D phase: update the decoder (vs the NEW encoder) -------------
    trainable(enc, False)
    trainable(dec, True)
    fake = dec(noise)
    rec_x = dec(z.detach())
    l_rec = recon(x, rec_x)
    rmu, rlv = encode(rec_x)   # NOT detached: the decoder's gradient comes from here
    fmu, flv = encode(fake)
    z_rec = rmu + randn(*rmu.shape) * (0.5 * rlv).exp()
    z_fake = fmu + randn(*fmu.shape) * (0.5 * flv).exp()
    rr, rf = dec(z_rec.detach()), dec(z_fake.detach())
    kl_fake = kl_gauss(fmu, flv)
    loss_d = S * (B_REC * l_rec + 0.5 * B_KL * (kl_gauss(rmu, rlv) + kl_fake)
                  + GAMMA_R * 0.5 * B_REC * (recon(rec_x.detach(), rr) + recon(fake.detach(), rf)))
    opt_d.zero_grad()
    loss_d.backward()
    opt_d.step()
    trainable(enc, True)
    return dict(loss_e=loss_e.detach(), loss_d=loss_d.detach(), rec=l_rec.detach(),
                kl_real=kl_real.detach(), kl_fake=kl_fake.detach(),
                diff_kl=(kl_fake - kl_real).detach(), expelbo_r=ee_r.detach(),
                expelbo_f=ee_f.detach())


# %% [markdown]
# ## 4. Train
#
# 500 vanilla warm-up iterations, then the introspective game. Watch
# `diff_kl = kl_fake − kl_real`: a *positive* gap means the encoder assigns
# more KL to fakes than to data — the introspective signal is alive.

# %%
N_ITER = int(os.environ.get("TUTORIAL_ITERS", 6000))   # full recipe: 30_000
N_VAE = min(500, N_ITER // 2)
BATCH = 512

for it in range(N_ITER):
    x = torch.from_numpy(sample_8gaussians(rng_np, BATCH)).to(DEVICE)
    if it < N_VAE:
        loss = vanilla_step(x)
        if it % 250 == 0:
            print(f"[warm-up {it:5d}] elbo loss {float(loss):8.4f}")
    else:
        m = intro_step(x)
        if it % 1000 == 0 or it == N_ITER - 1:
            print(f"[intro   {it:5d}] rec {float(m['rec']):7.4f}  kl_real "
                  f"{float(m['kl_real']):6.3f}  kl_fake {float(m['kl_fake']):7.3f}  diff_kl "
                  f"{float(m['diff_kl']):7.3f}  expELBO(r,f) ({float(m['expelbo_r']):.2e}, "
                  f"{float(m['expelbo_f']):.2e})")

# %%
with torch.no_grad():
    fakes = dec(randn(2048, Z_DIM)).cpu().numpy()
print(f"decoder samples: mean {fakes.mean(0).round(3)}, std {fakes.std(0).round(3)}")
if HAVE_MPL:
    fig, ax = plt.subplots(1, 2, figsize=(8, 4))
    ax[0].scatter(real[:, 0], real[:, 1], s=4, alpha=0.5)
    ax[0].set_title("real")
    ax[1].scatter(fakes[:, 0], fakes[:, 1], s=4, alpha=0.5, color="C1")
    ax[1].set_title(f"decoder samples after {N_ITER} iters")
    for a in ax:
        a.set_aspect("equal")
        a.set_xlim(-2.2, 2.2)
        a.set_ylim(-2.2, 2.2)
    plt.savefig(os.path.join(OUT, "samples.png"), dpi=120)
    plt.close()
    print(f"saved {OUT}/samples.png — 8 modes, no collapse, is the pass mark")

# %% [markdown]
# ## 5. The framework way
#
# The same recipe, plus per-iteration MultiStepLR, NaN aborts, checkpoints
# and the paper's metrics (grid-normalized ELBO, histogram KL, JSD), is two
# lines with `soft_intro_vae_torch`. Its step (`train/step.py`) is the
# algorithm above generalized over the reference's variants, the JAX
# package's step held to the same numbers (`tests/test_torch_port_toy.py`).

# %%
if os.environ.get("TUTORIAL_RUN_FRAMEWORK", "0") == "1":
    from soft_intro_vae_torch.train.toy import ToyConfig, train_soft_intro_vae_toy

    cfg = ToyConfig(dataset="8Gaussians", z_dim=2, batch_size=512,
                    n_iter=N_ITER, num_vae=N_VAE, beta_kl=0.3, beta_rec=0.2, beta_neg=0.9,
                    test_iter=max(N_ITER, 1), seed=92, result_dir=os.path.join(OUT, "framework"),
                    device=str(DEVICE))
    state, results = train_soft_intro_vae_toy(cfg)
    print(f"paper metrics: {results}")   # gnELBO / histogram KL / JSD
else:
    print("set TUTORIAL_RUN_FRAMEWORK=1 to run the framework recipe with the paper's metrics")

# %% [markdown]
# ## 6. GPU notes — why the PyTorch version is shaped like this
#
# * **Eager steps.** Each phase is a forward, a `backward()` and an
#   optimizer step; on an H100 the toy step is host-bound (hundreds of tiny
#   kernels a step), so the framework's image path replays a CUDA graph of
#   the step (`scan_steps`, `train/graph.py`).
# * **Randomness is explicit.** Every draw comes from the state's
#   `torch.Generator`; the framework's steps also take injected draws
#   (`noises`), which is how they are held to the JAX package bit for bit.
# * **`requires_grad` and `.detach()` are the whole variant story**: the five
#   reference variants are this step with different detach choices.
#
# **Next:** `torch_tutorial_image.py` and `torch_tutorial_bootstrap.py`.
