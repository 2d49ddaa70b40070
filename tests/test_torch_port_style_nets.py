"""Port parity: soft_intro_vae_torch.models.style against models/style.py.

The JAX package's StyleEncoder, StyleGenerator and mappings are initialised
at a tiny width (3 layers, 8 -> 32 channels, latent 16, batch 2); their
weights go through ``style_state_dict_from_jax`` into the port's nets, and
the same numpy inputs (NHWC for JAX, transposed to NCHW for the port) go
through both. Forward at LOD 1 on the stable path and at LOD 2 on the
blended path (blend 0.6), generator with noise_mode "none" (the
deterministic correction; the noise path draws random planes, which the two
packages draw differently). Tolerance rtol 1e-4, atol 1e-5: f32 sums
(convolutions, moments) are taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.train.style_step import StyleModel as JaxStyleModel
from soft_intro_vae_tpu.train.style_step import StyleModelConfig as JaxStyleModelConfig
from soft_intro_vae_torch.models import lreq
from soft_intro_vae_torch.models.style import blur3x3, downscale2d, upscale2d
from soft_intro_vae_torch.train.style_step import StyleModel, StyleModelConfig
from soft_intro_vae_torch.utils.from_jax import style_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

LAYERS, STARTF, MAXF, LATENT, CH, B = 3, 8, 32, 16, 3, 2
CASES = [(1, None), (2, 0.6)]
IDS = ["lod1-stable", "lod2-blend"]


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def pair():
    kw = dict(startf=STARTF, maxf=MAXF, layer_count=LAYERS, latent_size=LATENT,
              mapping_layers=5, channels=CH)
    jmodel = JaxStyleModel(JaxStyleModelConfig(**kw))
    pe, pd, buf = jax.jit(jmodel.init_params)(jax.random.key(3))
    # non-zero biases, noise weights and dlatent_avg, so every converted tensor matters
    rs = np.random.RandomState(4)
    bump = lambda t: jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32), np_tree(t))
    pe, pd, buf = bump(pe), bump(pd), bump(buf)
    nets = StyleModel(StyleModelConfig(**kw)).make_nets()
    nets.load_state_dict(style_state_dict_from_jax(pe, pd, buf), strict=True)
    return jmodel, pe, pd, buf, nets


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_state_dict_names_are_the_reference_converters(pair):
    from soft_intro_vae_tpu.utils.torch_compat import convert_mapping, convert_style_encoder
    _, pe, _, _, nets = pair
    sd = nets.state_dict()
    assert "decoder.decode_block.1.noise_weight_1" in sd and "dlatent_avg.buff" in sd
    assert sd["encoder.encode_block.0.bias_1"].shape == (1, STARTF, 1, 1)
    assert sd["decoder.const"].shape == (1, MAXF, 4, 4)
    # the reference converters read the port's names; the implicit-mode
    # division by the lreq std aside, they recover the JAX trees' layouts
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    back = convert_style_encoder(enc, LAYERS, STARTF, MAXF)
    np.testing.assert_allclose(back["block_1"]["bias_2"], pe["encoder"]["block_1"]["bias_2"])
    assert back["block_2"]["conv_1"]["kernel"].shape == pe["encoder"]["block_2"]["conv_1"]["kernel"].shape
    tl = {k[len("mapping_tl."):]: v for k, v in sd.items() if k.startswith("mapping_tl.")}
    assert convert_mapping(tl, 3)["block_3"]["kernel"].shape == (LATENT, 2 * LATENT)


@pytest.mark.parametrize("lod,blend", CASES, ids=IDS)
def test_encoder_matches_jax(pair, lod, blend):
    jmodel, pe, _, _, nets = pair
    res = 2 ** (lod + 2)
    x = np.random.RandomState(5 + lod).randn(B, res, res, CH).astype(np.float32)
    jb = None if blend is None else jnp.asarray(blend, jnp.float32)
    y_j = jmodel.encoder.apply({"params": pe["encoder"]}, jnp.asarray(x), lod, jb)
    with torch.no_grad():
        y_t = nets.encoder(_nchw(x), lod, blend)
    assert y_t.shape == (B, 1, LATENT)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lod,blend", CASES, ids=IDS)
def test_generator_matches_jax(pair, lod, blend):
    jmodel, _, pd, _, nets = pair
    styles = np.random.RandomState(7 + lod).randn(B, 2 * LAYERS, LATENT).astype(np.float32)
    jb = None if blend is None else jnp.asarray(blend, jnp.float32)
    y_j = jmodel.decoder.apply({"params": pd["decoder"]}, jnp.asarray(styles), lod, None, jb,
                               "none")
    with torch.no_grad():
        y_t = nets.decoder(torch.tensor(styles), lod, blend, "none")
    res = 2 ** (lod + 2)
    assert y_t.shape == (B, CH, res, res) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)


def test_mappings_match_jax(pair):
    jmodel, pe, pd, _, nets = pair
    rs = np.random.RandomState(9)
    s = rs.randn(B, 1, LATENT).astype(np.float32)
    z = rs.randn(B, LATENT).astype(np.float32)
    tl_j = jmodel.mapping_tl.apply({"params": pe["mapping_tl"]}, jnp.asarray(s))
    fl_j = jmodel.mapping_fl.apply({"params": pd["mapping_fl"]}, jnp.asarray(z))
    with torch.no_grad():
        tl_t = nets.mapping_tl(torch.tensor(s))
        fl_t = nets.mapping_fl(torch.tensor(z))
    assert tl_t.shape == (B, 2, LATENT) and fl_t.shape == (B, 2 * LAYERS, LATENT)
    np.testing.assert_allclose(tl_t.numpy(), np.asarray(tl_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fl_t.numpy(), np.asarray(fl_j), rtol=1e-4, atol=1e-5)


def test_kernel_transforms_and_resampling_match_jax():
    from soft_intro_vae_tpu.models import style as jstyle

    rs = np.random.RandomState(10)
    w = rs.randn(3, 3, 4, 5).astype(np.float32)  # HWIO
    wp = np.pad(w, ((1, 1), (1, 1), (0, 0), (0, 0)))
    box = 0.25 * (wp[1:, 1:] + wp[:-1, 1:] + wp[1:, :-1] + wp[:-1, :-1])
    shift = 4 * box
    t = torch.tensor(w.transpose(3, 2, 0, 1).copy())
    np.testing.assert_allclose(lreq.box_transform(t).numpy(), box.transpose(3, 2, 0, 1),
                               rtol=1e-6)
    np.testing.assert_allclose(lreq.shift_sum_transform(t).numpy(), shift.transpose(3, 2, 0, 1),
                               rtol=1e-6)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    for port_fn, jax_fn in ((blur3x3, jstyle.blur3x3), (upscale2d, jstyle.upscale2d),
                            (downscale2d, jstyle.downscale2d)):
        np.testing.assert_allclose(port_fn(_nchw(x)).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(x))).transpose(0, 3, 1, 2),
                                   rtol=1e-6, atol=1e-6)


def test_bf16_conv_path_keeps_f32_heads(pair):
    _, _, _, _, nets = pair
    kw = dict(startf=STARTF, maxf=MAXF, layer_count=LAYERS, latent_size=LATENT, channels=CH)
    bf = StyleModel(StyleModelConfig(compute_dtype="bfloat16", **kw)).make_nets()
    bf.load_state_dict(nets.state_dict())
    x = torch.randn(B, CH, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        styles = bf.encoder(x, 1, None)
        img = bf.decoder(torch.randn(B, 2 * LAYERS, LATENT), 1, None, "none")
        ref = nets.encoder(x, 1, None)
    assert styles.dtype == img.dtype == torch.float32
    assert bf.encoder.encode_block[2].conv_1.dtype == torch.bfloat16
    # bf16 activations: the styles follow the f32 ones to a bf16-sized error
    torch.testing.assert_close(styles, ref, rtol=0.1, atol=0.1)


def test_other_encoder_variants_name_their_roadmap_item():
    # EncoderWithFC and EncoderWithStatistics are ported
    # (tests/test_torch_port_style_encoders.py); an unknown name still raises
    with pytest.raises(ValueError, match="unknown"):
        StyleModel(StyleModelConfig(encoder_variant="Nope"))


@pytest.mark.parametrize("net, rtol", [("encoder", 1e-2), ("generator", 1e-1)])
def test_bfloat16_against_the_jax_package(pair, net, rtol):
    """compute_dtype bfloat16 in both packages at LOD 1, same weights. The
    JAX default (unfused) path adds the bias and takes the leaky ReLU in bf16
    at each norm site's producer; the port takes that producer in f32, as the
    fused kernel does (ROADMAP Queue 3). Measured at 3 seeds, as a share of
    the output's largest magnitude: encoder <= 4.2e-3, generator <= 4.8e-2
    (<= 5.7e-2 at LOD 2), its image passing through twice as many sites;
    held to 1e-2 and 1e-1."""
    _, pe, pd, buf, _ = pair
    kw = dict(startf=STARTF, maxf=MAXF, layer_count=LAYERS, latent_size=LATENT,
              mapping_layers=5, channels=CH, compute_dtype="bfloat16")
    jmodel = JaxStyleModel(JaxStyleModelConfig(**kw))
    nets = StyleModel(StyleModelConfig(**kw)).make_nets()
    nets.load_state_dict(style_state_dict_from_jax(pe, pd, buf), strict=True)
    if net == "encoder":
        x = np.random.RandomState(60).randn(B, 8, 8, CH).astype(np.float32)
        want = np.asarray(jmodel.encoder.apply({"params": pe["encoder"]}, jnp.asarray(x), 1, None))
        with torch.no_grad():
            got = nets.encoder(_nchw(x), 1, None).numpy()
    else:
        styles = np.random.RandomState(70).randn(B, 2 * LAYERS, LATENT).astype(np.float32)
        want = np.asarray(jmodel.decoder.apply({"params": pd["decoder"]}, jnp.asarray(styles), 1,
                                               None, None, "none"), np.float32).transpose(0, 3, 1, 2)
        with torch.no_grad():
            got = nets.decoder(torch.tensor(styles), 1, None, "none").numpy()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()
