"""Port parity: the style encoder variants (MODEL.ENCODER EncoderWithStatistics
and EncoderWithFC) and MappingToLatentNoStyle against the JAX package.

The JAX nets are initialised at a tiny width (3 layers, 8 -> 32 channels,
latent 16, batch 2), moved 0.1 randn off the init so every converted tensor
matters, and carried across by ``style_state_dict_from_jax`` /
``mapping_no_style_state_dict_from_jax``. The same numpy inputs (NHWC for
JAX, NCHW for the port) go through both at every LOD and on the blended
path, at tests/test_torch_port_style_nets.py's tolerance (rtol 1e-4, atol
1e-5: f32 sums in another order). The last block's ``dense`` reads the
flattened 4x4 map, (H, W, C) in JAX and (C, H, W) here: a converter that
forgot to permute its rows fails the forward comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.models.style import MappingToLatentNoStyle as JaxNoStyle
from soft_intro_vae_tpu.train.style_step import StyleModel as JaxStyleModel
from soft_intro_vae_tpu.train.style_step import StyleModelConfig as JaxStyleModelConfig
from soft_intro_vae_torch.models.style import MappingToLatentNoStyle, StyleEncoder
from soft_intro_vae_torch.train.style_step import StyleModel, StyleModelConfig
from soft_intro_vae_torch.utils.from_jax import (
    mapping_no_style_state_dict_from_jax,
    style_state_dict_from_jax,
)
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

LAYERS, STARTF, MAXF, LATENT, CH, B = 3, 8, 32, 16, 3, 2
VARIANTS = ["EncoderWithStatistics", "EncoderWithFC"]
KW = dict(startf=STARTF, maxf=MAXF, layer_count=LAYERS, latent_size=LATENT, mapping_layers=5,
          channels=CH)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    variant = request.param
    jmodel = JaxStyleModel(JaxStyleModelConfig(encoder_variant=variant, **KW))
    pe, pd, buf = jax.jit(jmodel.init_params)(jax.random.key(3))
    rs = np.random.RandomState(4)
    bump = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32), np_tree(t))
    pe, pd, buf = bump(pe), bump(pd), bump(buf)
    model = StyleModel(StyleModelConfig(encoder_variant=variant, **KW))
    nets = model.make_nets()
    nets.load_state_dict(style_state_dict_from_jax(pe, pd, buf), strict=True)
    return variant, jmodel, pe, model, nets


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_converter_names_and_shapes(pair):
    """The last block holds ``dense`` (16 C_in -> C_out) and no conv_2 or
    bias_2; EncoderWithFC adds ``fc2``; every other tensor is the default
    encoder's."""
    variant, _, pe, _, nets = pair
    sd = nets.encoder.state_dict()
    last = f"encode_block.{LAYERS - 1}"
    c_in = sd[f"{last}.bias_1"].shape[1]
    assert sd[f"{last}.dense.weight"].shape == (min(MAXF, STARTF * 2 ** LAYERS), 16 * c_in)
    assert not any(k.startswith((f"{last}.conv_2", f"{last}.bias_2")) for k in sd)
    assert sd[f"{last}.style_2.weight"].shape[1] == sd[f"{last}.dense.weight"].shape[0]
    assert ("fc2.weight" in sd) == (variant == "EncoderWithFC")
    jk = np.asarray(pe["encoder"][f"block_{LAYERS - 1}"]["dense"]["kernel"])
    assert sorted(sd[f"{last}.dense.weight"].numpy().ravel()) == pytest.approx(sorted(jk.ravel()))
    default = StyleEncoder(STARTF, MAXF, LAYERS, LATENT, CH).state_dict()
    for k, v in default.items():
        if not k.startswith(last):
            assert sd[k].shape == v.shape, k


@pytest.mark.parametrize("lod,blend", [(0, None), (1, None), (2, None), (2, 0.6)],
                         ids=["lod0", "lod1", "lod2", "lod2-blend"])
def test_encoder_forward_matches_jax(pair, lod, blend):
    variant, jmodel, pe, _, nets = pair
    res = 2 ** (lod + 2)
    x = np.random.RandomState(10 + lod).randn(B, res, res, CH).astype(np.float32)
    jb = None if blend is None else jnp.asarray(blend, jnp.float32)
    want = jmodel.encoder.apply({"params": pe["encoder"]}, jnp.asarray(x), lod, jb)
    with torch.no_grad():
        got = nets.encoder(_nchw(x), lod, blend)
    if variant == "EncoderWithFC":
        (want, want_fc), (got, got_fc) = want, got
        assert got_fc.shape == (B, 1)
        np.testing.assert_allclose(got_fc.numpy(), np.asarray(want_fc), rtol=1e-4, atol=1e-5)
    assert got.shape == (B, 1, LATENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_encode_keeps_only_the_styles(pair):
    """StyleModel.encode: (z, mu, logvar) through mapping_tl, the fc2 logit dropped."""
    _, jmodel, pe, model, nets = pair
    rs = np.random.RandomState(20)
    x = rs.randn(B, 16, 16, CH).astype(np.float32)
    eps = rs.randn(B, LATENT).astype(np.float32)
    jz, jmu, jlv = jmodel.encode(pe, jnp.asarray(x), 2, None, jnp.asarray(eps))
    with torch.no_grad():
        z, mu, lv = model.encode(nets, _nchw(x), 2, None, torch.tensor(eps))
    for g, w in ((z, jz), (mu, jmu), (lv, jlv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_encoder_gradients_flow_through_dense(pair):
    """A loss on the styles reaches ``dense`` and every earlier block."""
    variant, _, _, model, nets = pair
    x = torch.tensor(np.random.RandomState(30).randn(B, CH, 16, 16).astype(np.float32))
    out = nets.encoder(x, 2, None)
    styles = out[0] if variant == "EncoderWithFC" else out
    styles.square().mean().backward()
    last = nets.encoder.encode_block[LAYERS - 1]
    assert last.dense.weight.grad is not None and last.dense.weight.grad.abs().sum() > 0
    assert nets.encoder.encode_block[0].conv_1.weight.grad.abs().sum() > 0


def test_mapping_to_latent_no_style_matches_jax():
    jm = JaxNoStyle(latent_size=LATENT, dlatent_size=12, mapping_fmaps=20, mapping_layers=3)
    x = np.random.RandomState(40).randn(B, 1, LATENT).astype(np.float32)
    params = np_tree(jm.init(jax.random.key(5), jnp.asarray(x))["params"])
    sd = mapping_no_style_state_dict_from_jax(params)
    assert sorted(sd) == [f"map_blocks.{i}.{p}" for i in range(3) for p in ("bias", "weight")]
    port = MappingToLatentNoStyle(latent_size=LATENT, dlatent_size=12, mapping_fmaps=20,
                                  mapping_layers=3)
    port.load_state_dict(sd, strict=True)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.tensor(x))
    assert got.shape == (B, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_mapping_to_latent_no_style_converts_with_the_reference_converter():
    """The port's state_dict, read by the JAX package's ``convert_mapping(...,
    bare_linear=True)``, gives back the JAX tree (reference names)."""
    from soft_intro_vae_tpu.utils.torch_compat import convert_mapping

    jm = JaxNoStyle(latent_size=LATENT, dlatent_size=LATENT, mapping_fmaps=LATENT,
                    mapping_layers=3)
    params = np_tree(jm.init(jax.random.key(6), jnp.zeros((1, LATENT)))["params"])
    port = MappingToLatentNoStyle(LATENT, LATENT, LATENT, 3)
    port.load_state_dict(mapping_no_style_state_dict_from_jax(params), strict=True)
    sd = {k: v.numpy() * 1.0 for k, v in port.state_dict().items()}
    # the reference stores implicit-lreq weights: raw * std; the port and JAX keep raw
    for i in range(3):
        sd[f"map_blocks.{i}.weight"] = sd[f"map_blocks.{i}.weight"] * port.map_blocks[i].std
        sd[f"map_blocks.{i}.bias"] = sd[f"map_blocks.{i}.bias"] * 0.1
    back = convert_mapping(sd, 3, bare_linear=True)
    for name, leaf in params.items():
        np.testing.assert_allclose(back[name]["kernel"], leaf["kernel"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(back[name]["bias"], leaf["bias"], rtol=1e-5, atol=1e-6)
