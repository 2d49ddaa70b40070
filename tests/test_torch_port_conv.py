"""Port parity: soft_intro_vae_torch.models.conv against the JAX package's
ConvEncoder/ConvDecoder, weights carried across by ``image_state_dict_from_jax``.

Tiny size (channels (8, 16), 16x16 images, z 8, batch 4), float32 on the CPU.
Tolerances: outputs within rtol 1e-4, atol 1e-5 (XLA and PyTorch sum the
convolutions in another order; measured < 2e-6). Running statistics after
one train-mode forward: running_mean within atol 1e-6; running_var after
the n/(n-1) factor, n = B*H*W of each BN site, because flax updates it with
the biased batch variance and PyTorch with the unbiased one (ROADMAP Queue
3), within rtol 1e-5. bfloat16 against float32, and against the JAX package
in bfloat16: see those tests' docstrings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from soft_intro_vae_tpu.models.conv import ConvDecoder as JaxDecoder
from soft_intro_vae_tpu.models.conv import ConvEncoder as JaxEncoder
from soft_intro_vae_tpu.utils.torch_compat import (
    convert_image_decoder, convert_image_encoder, load_reference_image_checkpoint)
from soft_intro_vae_torch.models.conv import SoftIntroVAE
from soft_intro_vae_torch.utils.from_jax import image_state_dict_from_jax
from tests.test_torch_compat import build_torch_decoder, build_torch_encoder
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

CH, IMG, CDIM, Z, B = (8, 16), 16, 3, 8, 4
COND = 5
TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _init(module, key, *args):
    return jax.jit(lambda k: module.init(k, *args, train=False))(jax.random.key(key))


@pytest.fixture(scope="module")
def nets():
    kw = dict(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG)
    enc, dec = JaxEncoder(**kw), JaxDecoder(**kw)
    ve = _init(enc, 0, jnp.zeros((1, IMG, IMG, CDIM)))
    vd = _init(dec, 1, jnp.zeros((1, Z)))
    # running statistics away from (0, 1), so eval mode reads them
    rs = np.random.RandomState(3)

    def stats(tree):
        return jax.tree_util.tree_map(
            lambda a: (rs.rand(*a.shape) + 0.5 if a.ndim and a.mean() > 0.5 else 0.1 * rs.randn(*a.shape))
            .astype(np.float32), _np_tree(tree))

    trees = dict(params_e=_np_tree(ve["params"]), stats_e=stats(ve["batch_stats"]),
                 params_d=_np_tree(vd["params"]), stats_d=stats(vd["batch_stats"]))
    return enc, dec, trees


def _port(trees, **kw):
    model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG, **kw)
    model.load_state_dict(image_state_dict_from_jax(
        trees["params_e"], trees["stats_e"], trees["params_d"], trees["stats_d"], CH, IMG,
        trees.get("params_t"), trees.get("stats_t")), strict=True)
    return model


def _bn_sizes(module):
    """n = B*H*W seen by every BatchNorm2d in the next forward, by name."""
    sizes, hooks = {}, []
    for name, m in module.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: sizes.__setitem__(
                    name, inp[0].shape[0] * inp[0].shape[2] * inp[0].shape[3])))
    return sizes, hooks


def _check_stats(got_sd, before_sd, want_sd, sizes, prefix):
    for name, n in sizes.items():
        key = f"{prefix}{name}"
        np.testing.assert_allclose(got_sd[key + ".running_mean"].numpy(),
                                   want_sd[key + ".running_mean"].numpy(), rtol=0, atol=1e-6)
        old = before_sd[key + ".running_var"].numpy()
        got_delta = got_sd[key + ".running_var"].numpy() - 0.9 * old
        want_delta = (want_sd[key + ".running_var"].numpy() - 0.9 * old) * n / (n - 1)
        np.testing.assert_allclose(got_delta, want_delta, rtol=1e-5, atol=1e-7, err_msg=key)


def _images(seed):
    return np.random.RandomState(seed).rand(B, IMG, IMG, CDIM).astype(np.float32)


def test_encoder_train_mode_outputs_and_running_stats(nets):
    enc, _, trees = nets
    x = _images(4)
    (mu_j, lv_j), upd = enc.apply({"params": trees["params_e"], "batch_stats": trees["stats_e"]},
                                  jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = _port(trees).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sizes, hooks = _bn_sizes(model.encoder)
    with torch.no_grad():
        mu, lv = model.encoder(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), **TOL)
    want = image_state_dict_from_jax(trees["params_e"], _np_tree(upd["batch_stats"]),
                                     trees["params_d"], trees["stats_d"], CH, IMG)
    assert len(sizes) == 5  # the stem and 2 residual blocks of 2 norms each
    _check_stats(model.state_dict(), before, want, sizes, "encoder.")


def test_decoder_train_mode_outputs_and_running_stats(nets):
    _, dec, trees = nets
    z = np.random.RandomState(5).randn(B, Z).astype(np.float32)
    y_j, upd = dec.apply({"params": trees["params_d"], "batch_stats": trees["stats_d"]},
                         jnp.asarray(z), train=True, mutable=["batch_stats"])
    model = _port(trees).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sizes, hooks = _bn_sizes(model.decoder)
    with torch.no_grad():
        y = model.decoder(torch.from_numpy(z))
    for h in hooks:
        h.remove()
    assert y.shape == (B, CDIM, IMG, IMG) and y.dtype == torch.float32
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_j), **TOL)
    want = image_state_dict_from_jax(trees["params_e"], trees["stats_e"], trees["params_d"],
                                     _np_tree(upd["batch_stats"]), CH, IMG)
    assert len(sizes) == 6  # 3 residual blocks of 2 norms each
    _check_stats(model.state_dict(), before, want, sizes, "decoder.")


def test_eval_mode_forward_reads_the_carried_statistics(nets):
    enc, dec, trees = nets
    x = _images(6)
    z = np.random.RandomState(7).randn(B, Z).astype(np.float32)
    mu_j, lv_j = enc.apply({"params": trees["params_e"], "batch_stats": trees["stats_e"]},
                           jnp.asarray(x), train=False)
    y_j = dec.apply({"params": trees["params_d"], "batch_stats": trees["stats_d"]},
                    jnp.asarray(z), train=False)
    model = _port(trees).eval()
    with torch.no_grad():
        mu, lv = model.encoder(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        y = model.decoder(torch.from_numpy(z))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), **TOL)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_j), **TOL)


def test_conditional_concat():
    kw = dict(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG, conditional=True, cond_dim=COND)
    enc, dec = JaxEncoder(**kw), JaxDecoder(**kw)
    cond = np.random.RandomState(8).rand(B, COND).astype(np.float32)
    ve = jax.jit(lambda k: enc.init(k, jnp.zeros((1, IMG, IMG, CDIM)), jnp.zeros((1, COND)),
                                    train=False))(jax.random.key(2))
    vd = jax.jit(lambda k: dec.init(k, jnp.zeros((1, Z)), jnp.zeros((1, COND)),
                                    train=False))(jax.random.key(3))
    trees = dict(params_e=_np_tree(ve["params"]), stats_e=_np_tree(ve["batch_stats"]),
                 params_d=_np_tree(vd["params"]), stats_d=_np_tree(vd["batch_stats"]))
    assert trees["params_e"]["fc"]["kernel"].shape[0] == 4 * 4 * CH[-1] + COND
    x = _images(9)
    z = np.random.RandomState(10).randn(B, Z).astype(np.float32)
    mu_j, _ = enc.apply({"params": trees["params_e"], "batch_stats": trees["stats_e"]},
                        jnp.asarray(x), jnp.asarray(cond), train=False)
    y_j = dec.apply({"params": trees["params_d"], "batch_stats": trees["stats_d"]},
                    jnp.asarray(z), jnp.asarray(cond), train=False)
    model = SoftIntroVAE(conditional=True, cond_dim=COND, cdim=CDIM, zdim=Z, channels=CH,
                         image_size=IMG)
    model.load_state_dict(image_state_dict_from_jax(
        trees["params_e"], trees["stats_e"], trees["params_d"], trees["stats_d"], CH, IMG))
    model.eval()
    with torch.no_grad():
        mu, _ = model.encoder(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                              torch.from_numpy(cond))
        y = model.decoder(torch.from_numpy(z), torch.from_numpy(cond))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_j), **TOL)


def test_reference_named_twin_loads_strictly_and_agrees():
    torch.manual_seed(11)
    twin = nn.Module()
    twin.encoder, twin.decoder = build_torch_encoder(), build_torch_decoder()
    model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG)
    sd = twin.state_dict()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    twin.eval()
    model.eval()
    x = torch.from_numpy(_images(12).transpose(0, 3, 1, 2).copy())
    z = torch.randn(B, Z)
    with torch.no_grad():
        want_e = twin.encoder.fc(twin.encoder.main(x).flatten(1))
        want_d = twin.decoder.main(twin.decoder.fc(z).view(B, CH[-1], 4, 4))
        got_e = torch.cat(model.encoder(x), dim=1)
        got_d = model.decoder(z)
    torch.testing.assert_close(got_e, want_e, rtol=0, atol=0)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)


@pytest.mark.parametrize("bootstrap", [False, True])
def test_jax_converters_invert_the_port_converter(nets, bootstrap, tmp_path):
    _, _, trees = nets
    if bootstrap:
        trees = dict(trees, params_t=jax.tree_util.tree_map(lambda a: a + 1.0, trees["params_d"]),
                     stats_t=jax.tree_util.tree_map(lambda a: a * 2.0, trees["stats_d"]))
    model = _port(trees, bootstrap=bootstrap)
    sd = model.state_dict()
    pe, se = convert_image_encoder(sd, CH, IMG)
    pd, sdd = convert_image_decoder(sd, CH, IMG)
    got = dict(params_e=pe, stats_e=se, params_d=pd, stats_d=sdd)
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 3, "model": sd}, path)
    loaded = load_reference_image_checkpoint(str(path), CH, IMG)
    assert loaded["epoch"] == 3
    if bootstrap:
        got["params_t"], got["stats_t"] = loaded["params_d_target"], loaded["stats_d_target"]
    else:
        assert "params_d_target" not in loaded
    for name, tree in got.items():
        want_leaves = jax.tree_util.tree_leaves_with_path(trees[name])
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(want_leaves) == len(got_leaves), name
        for path_, leaf in want_leaves:
            np.testing.assert_array_equal(np.asarray(got_leaves[path_]), leaf,
                                          err_msg=f"{name} {path_}")


def test_target_decoder_takes_no_gradient():
    model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG, bootstrap=True)
    assert all(not p.requires_grad for p in model.target_decoder.parameters())
    assert all(p.requires_grad for p in model.decoder.parameters())
    assert any(k.startswith("target_decoder.main.res_in_4") for k in model.state_dict())


def test_bfloat16_compute_follows_float32(nets):
    """compute_dtype=bfloat16: convolutions in bf16 (inputs and weights
    rounded to 8 bits of mantissa), BN and the linear layers in f32, outputs
    f32. Held to the f32 forward within 5e-2 of each output's largest
    magnitude: a few bf16 roundings (2^-8 each) through 7 norms."""
    _, _, trees = nets
    x = torch.from_numpy(_images(13).transpose(0, 3, 1, 2).copy())
    z = torch.randn(B, Z, generator=torch.Generator().manual_seed(0))
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _port(trees, compute_dtype=dtype).train()
        with torch.no_grad():
            outs[dtype] = (torch.cat(model.encoder(x), 1), model.decoder(z))
        assert all(t.dtype == torch.float32 for t in outs[dtype])
        assert all(p.dtype == torch.float32 for p in model.parameters())
    for a, b in zip(outs[torch.bfloat16], outs[torch.float32]):
        assert (a - b).abs().max() <= 5e-2 * b.abs().max()
        assert (a - b).abs().max() > 0  # bf16 really ran


def test_bfloat16_forward_against_the_jax_package(nets):
    """compute_dtype=bfloat16 in both packages, train mode, same weights: the
    port rounds at other places than flax (``main.predict`` adds its bias
    before the one rounding, avg-pool sums in f32; ROADMAP Queue 3), so the
    two differ by bf16 roundings. Measured at 3 seeds: at most 1.6e-2 of each
    output's largest magnitude (mu 1.6e-2, logvar 9.7e-3, image 8.5e-3);
    held to 3e-2."""
    _, _, trees = nets
    kw = dict(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG, dtype=jnp.bfloat16)
    enc, dec = JaxEncoder(**kw), JaxDecoder(**kw)
    x = _images(40)
    z = np.random.RandomState(50).randn(B, Z).astype(np.float32)
    (mu_j, lv_j), _ = enc.apply({"params": trees["params_e"], "batch_stats": trees["stats_e"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
    y_j, _ = dec.apply({"params": trees["params_d"], "batch_stats": trees["stats_d"]},
                       jnp.asarray(z), train=True, mutable=["batch_stats"])
    model = _port(trees, compute_dtype=torch.bfloat16).train()
    with torch.no_grad():
        mu, lv = model.encoder(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        y = model.decoder(torch.from_numpy(z))
    for got, want in ((mu, mu_j), (lv, lv_j), (y.permute(0, 2, 3, 1), y_j)):
        want = np.asarray(want, np.float32)
        assert np.abs(got.numpy() - want).max() <= 3e-2 * np.abs(want).max()


def test_every_conv_weight_is_channels_last_and_the_state_dict_is_the_references():
    """The nets convert their parameters to channels-last when built (the
    bootstrap target's too); the state_dict keeps the reference twin's names
    and shapes, so a reference .pth and the JAX converters read it as before."""
    model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG, bootstrap=True)
    four_d = {k: p for k, p in model.named_parameters() if p.dim() == 4}
    assert len(four_d) == 6 + 2 * 8  # the encoder's convs, each decoder's
    for k, p in four_d.items():
        assert p.is_contiguous(memory_format=torch.channels_last) and p.stride(1) == 1, k
    twin = nn.Module()
    twin.encoder, twin.decoder = build_torch_encoder(), build_torch_decoder()
    want = {k: v.shape for k, v in twin.state_dict().items()}
    got = {k: v.shape for k, v in model.state_dict().items() if not k.startswith("target_")}
    assert got == want
    assert {k[len("target_"):]: v.shape for k, v in model.state_dict().items()
            if k.startswith("target_")} == {k: v for k, v in want.items() if k.startswith("decoder.")}


@pytest.mark.parametrize("seed", [0, 1])
def test_channels_last_nets_equal_the_same_weights_in_nchw(seed):
    """Train mode, float32: the channels-last nets against the reference-named
    NCHW twin holding the same weights, on the same batch and z. Outputs, and
    after one backward every parameter's gradient, within rtol 1e-5 and 1e-5
    of each tensor's largest magnitude (measured at 3 seeds: outputs <= 1.7e-6,
    gradients <= 7.7e-6 of that magnitude; the BN statistics and convolutions
    sum in another order in each layout). The conv gradients are
    channels-last, as the parameters, which Adam's foreach route needs."""
    torch.manual_seed(13 + seed)
    model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG).train()
    twin = nn.Module()
    twin.encoder, twin.decoder = build_torch_encoder(), build_torch_decoder()
    twin.load_state_dict(model.state_dict(), strict=True)
    twin.train()
    assert all(p.is_contiguous() for p in twin.parameters())
    x = torch.from_numpy(_images(14 + seed).transpose(0, 3, 1, 2).copy())
    z = torch.randn(B, Z, generator=torch.Generator().manual_seed(seed))
    x_cl = x.contiguous(memory_format=torch.channels_last)
    mu, lv = model.encoder(x_cl)
    rec = model.decoder(z)
    assert rec.is_contiguous(memory_format=torch.channels_last)
    t_mu, t_lv = twin.encoder.fc(twin.encoder.main(x).flatten(1)).chunk(2, dim=1)
    t_rec = twin.decoder.main(twin.decoder.fc(z).view(B, CH[-1], 4, 4))
    for got, want in ((mu, t_mu), (lv, t_lv), (rec, t_rec)):
        got, want = got.detach(), want.detach()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    ((mu ** 2).sum() + lv.exp().sum() + ((rec - x_cl) ** 2).sum()).backward()
    ((t_mu ** 2).sum() + t_lv.exp().sum() + ((t_rec - x) ** 2).sum()).backward()
    want = dict(twin.named_parameters())
    for k, p in model.named_parameters():
        w = want[k].grad
        torch.testing.assert_close(p.grad, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()), msg=k)
        if p.dim() == 4:
            assert p.grad.is_contiguous(memory_format=torch.channels_last), k
