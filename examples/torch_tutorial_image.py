# %% [markdown]
# # Soft-IntroVAE from scratch in PyTorch — Part 2: images
#
# *The PyTorch/CUDA re-telling of the reference tutorial*
# (`soft_intro_vae_tutorial/soft_intro_vae_image_code_tutorial.ipynb`), the
# counterpart of `tutorial_image.py` for `soft_intro_vae_torch`. Read Part 1
# (`torch_tutorial_2d_toy.py`) first: the theory carries over unchanged; this
# part covers what *changes* when the data is images:
#
# 1. the **dimension scale** $s = 1/(C \cdot H \cdot W)$
# 2. a convolutional ResNet encoder/decoder, written from scratch
# 3. one introspective step of it, by hand
# 4. the same through `soft_intro_vae_torch` (the CIFAR-10 recipe)
# 5. the GPU input path (uint8 on the host, normalized on the card)
#
# Knobs (environment variables): `TUTORIAL_EPOCHS` (epochs of the framework
# run, default 2), `TUTORIAL_IMAGES` (synthetic CIFAR-shaped images, default
# 2048), `TUTORIAL_RUN_FRAMEWORK=0` (skip the framework run),
# `TUTORIAL_DEVICE` (`cuda` by default; `cpu` runs without a GPU) and
# `TUTORIAL_OUT`.

# %% [markdown]
# ## 1. Why the scale $s$ exists
#
# In 2D the reconstruction error sums over 2 dimensions; at 32×32×3 over
# 3072, at 256×256×3 over ~200k. The expELBO
# $\exp(-2s(\beta_{rec}\mathcal{L}_r + \beta_{neg}\mathrm{KL}))$ would
# underflow to exactly 0 for any fake if $s$ stayed 1: no gradient, no game.
# Dividing by the input dimension keeps the exponent workable at every
# resolution. $\beta_{neg}$ grows with the input dimension (CIFAR-10: 256;
# CelebA-HQ 256²: 1024).

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
                                                  "torch_tutorial_image_results"))
os.makedirs(OUT, exist_ok=True)

# %% [markdown]
# ## 2. The conv architecture, from scratch
#
# The reference image models (`soft_intro_vae/train_soft_intro_vae.py`) are
# symmetric ResNets. Encoder: 5×5 conv stem → [ResBlock → AvgPool 2×] per
# stage → ResBlock → flatten → Linear to $2 z_{dim}$. Decoder: Linear from $z$
# → [ResBlock → 2× nearest upsample] per stage → ResBlock → 5×5 conv to RGB.
# Each ResBlock is conv3×3-BN-LReLU-conv3×3-BN with a 1×1 skip when the
# channels change. BatchNorm runs in train mode in every forward, frozen
# subnet or not, as in the reference: its running statistics move with each
# forward.


# %%
class ResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.skip = nn.Conv2d(cin, cout, 1, bias=False) if cin != cout else nn.Identity()
        self.conv1, self.bn1 = nn.Conv2d(cin, cout, 3, 1, 1, bias=False), nn.BatchNorm2d(cout)
        self.conv2, self.bn2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False), nn.BatchNorm2d(cout)

    def forward(self, x):
        y = F.leaky_relu(self.bn1(self.conv1(x)), 0.2)
        return F.leaky_relu(self.bn2(self.conv2(y)) + self.skip(x), 0.2)


class Encoder(nn.Module):
    def __init__(self, z_dim, channels, size):
        super().__init__()
        layers = [nn.Conv2d(3, channels[0], 5, 1, 2, bias=False), nn.BatchNorm2d(channels[0]),
                  nn.LeakyReLU(0.2), nn.AvgPool2d(2)]
        for cin, cout in zip(channels, channels[1:]):
            layers += [ResBlock(cin, cout), nn.AvgPool2d(2)]
        layers.append(ResBlock(channels[-1], channels[-1]))
        self.main = nn.Sequential(*layers)
        self.fc = nn.Linear(channels[-1] * (size // 2 ** len(channels)) ** 2, 2 * z_dim)

    def forward(self, x):
        return self.fc(self.main(x).flatten(1)).chunk(2, dim=1)


class Decoder(nn.Module):
    def __init__(self, z_dim, channels, size):
        super().__init__()
        self.s = size // 2 ** len(channels)
        self.fc = nn.Sequential(nn.Linear(z_dim, channels[-1] * self.s ** 2), nn.ReLU())
        layers, rev = [], list(reversed(channels))
        for cin, cout in zip([rev[0]] + rev[:-1], rev):
            layers += [ResBlock(cin, cout), nn.Upsample(scale_factor=2)]
        layers += [ResBlock(channels[0], channels[0]), nn.Conv2d(channels[0], 3, 5, 1, 2)]
        self.main = nn.Sequential(*layers)
        self.c = channels[-1]

    def forward(self, z):
        return self.main(self.fc(z).view(z.shape[0], self.c, self.s, self.s))


IMAGE, CH, Z_DIM = 32, (64, 128, 256), 128
torch.manual_seed(92)
enc, dec = Encoder(Z_DIM, CH, IMAGE).to(DEVICE), Decoder(Z_DIM, CH, IMAGE).to(DEVICE)
n_params = sum(p.numel() for p in enc.parameters()) + sum(p.numel() for p in dec.parameters())
print(f"encoder+decoder parameters: {n_params / 1e6:.2f}M")

# %% [markdown]
# ## 3. One introspective step, by hand
#
# Part 1's two-phase step with the image scale and an MSE summed over pixels
# per sample; the detach table is the same.

# %%
S = 1.0 / (3 * IMAGE * IMAGE)
B_REC, B_KL, B_NEG, GAMMA_R = 1.0, 1.0, 256.0, 1e-8   # the CIFAR-10 recipe
opt_e = torch.optim.Adam(enc.parameters(), lr=2e-4)
opt_d = torch.optim.Adam(dec.parameters(), lr=2e-4)
gen = torch.Generator(device=DEVICE)
gen.manual_seed(92)


def randn(*shape):
    return torch.randn(shape, generator=gen, device=DEVICE)


def rec_err(x, r, reduce="mean"):
    e = ((x - r) ** 2).flatten(1).sum(1)
    return e.mean() if reduce == "mean" else e


def kl(mu, lv, reduce="mean"):
    k = -0.5 * (1 + lv - lv.exp() - mu ** 2).sum(1)
    return k.mean() if reduce == "mean" else k


def exp_elbo(r, k):
    return torch.exp(-2.0 * S * (B_REC * r + B_NEG * k)).mean()


def sample(mu, lv):
    return mu + randn(*mu.shape) * (0.5 * lv).exp()


def intro_step(x):
    noise = randn(x.shape[0], Z_DIM)
    for p in dec.parameters():
        p.requires_grad_(False)
    fake = dec(noise)
    mu, lv = enc(x)
    z = sample(mu, lv)
    rec = dec(z)
    rmu, rlv = enc(rec.detach())
    fmu, flv = enc(fake.detach())
    ee_r = exp_elbo(rec_err(rec, dec(sample(rmu, rlv)), "none"), kl(rmu, rlv, "none"))
    ee_f = exp_elbo(rec_err(fake, dec(sample(fmu, flv)), "none"), kl(fmu, flv, "none"))
    loss_e = S * (B_REC * rec_err(x, rec) + B_KL * kl(mu, lv)) + 0.25 * (ee_r + ee_f)
    opt_e.zero_grad()
    loss_e.backward()
    opt_e.step()
    for p in dec.parameters():
        p.requires_grad_(True)
    for p in enc.parameters():
        p.requires_grad_(False)
    fake, rec = dec(noise), dec(z.detach())
    rmu, rlv = enc(rec)
    fmu, flv = enc(fake)
    rr, rf = dec(sample(rmu, rlv).detach()), dec(sample(fmu, flv).detach())
    kl_fake = kl(fmu, flv)
    loss_d = S * (B_REC * rec_err(x, rec) + 0.5 * B_KL * (kl(rmu, rlv) + kl_fake)
                  + GAMMA_R * 0.5 * B_REC * (rec_err(rec.detach(), rr) + rec_err(fake.detach(), rf)))
    opt_d.zero_grad()
    loss_d.backward()
    opt_d.step()
    for p in enc.parameters():
        p.requires_grad_(True)
    return dict(loss_e=float(loss_e), loss_d=float(loss_d), kl_real=float(kl(mu, lv)),
                kl_fake=float(kl_fake))


rng = np.random.default_rng(92)
x = torch.from_numpy(rng.random((32, 3, IMAGE, IMAGE), np.float32)).to(DEVICE)
print(intro_step(x))

# %% [markdown]
# With an untrained model the reconstructions are noise, so the encoder finds
# the fakes easy to reject: `kl_fake` sits above `kl_real`.
#
# ## 4. The same through `soft_intro_vae_torch`
#
# `train/step.py build_train_steps` is the one generic two-phase step for
# every variant; the image trainer adds the epoch loop, the vanilla warm-up
# (`num_vae` epochs), sample grids, FID, checkpoints (async, from a host
# snapshot), and the GPU input path:
#
# * the dataset stays **uint8 on the host** (4× fewer host-to-device bytes);
# * a worker thread keeps batches in flight (`data/prefetch.py`);
# * the card normalizes to float32 [0, 1] in a hand-written CUDA kernel
#   (`ops/csrc/u8norm.cu`), bit-equal to numpy's `x / 255` for every byte;
# * the nets run **channels-last** (NHWC in memory), so cuDNN needs no
#   layout transposes;
# * `scan_steps` K replays a CUDA graph of the step K times a call;
# * `remat=True` recomputes each subnet's activations in the backward
#   (activation checkpointing): less device memory for more compute.

# %%
if os.environ.get("TUTORIAL_RUN_FRAMEWORK", "1") == "1":
    from soft_intro_vae_torch.train.image import ImageConfig, train_soft_intro_vae

    cfg = ImageConfig(
        dataset="cifar10", z_dim=Z_DIM, batch_size=32,
        num_epochs=int(os.environ.get("TUTORIAL_EPOCHS", 2)), num_vae=1,
        beta_rec=1.0, beta_kl=1.0, beta_neg=256.0,
        seed=92, result_dir=OUT, synthetic_fallback=True,
        synthetic_n=int(os.environ.get("TUTORIAL_IMAGES", 2048)),
        scan_steps=8 if DEVICE.type == "cuda" else 1, device=str(DEVICE), verbose=True)
    state, summary = train_soft_intro_vae(cfg)
    print(f"summary: {summary['last_metrics']}")

# %% [markdown]
# ## 5. Evaluation and the CLI
#
# FID (`metrics/fid.py`) is the pt_inception network in PyTorch, streaming
# float64 statistics and a Newton–Schulz square root on the card; turn it on
# with `ImageConfig(with_fid=True)` or the CLI's `-f`. The whole recipe:
# ```
# python -m soft_intro_vae_torch.cli.main image -d cifar10 -n 250 -z 128 \
#     -b 32 -r 1.0 -k 1.0 -e 256 -s 92 -f --scan-steps 8
# ```
#
# **Next:** `torch_tutorial_bootstrap.py` — what changes when the decoder gets
# a frozen target copy.
