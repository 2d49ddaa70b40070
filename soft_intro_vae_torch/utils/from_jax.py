"""Weights carried across from the JAX package's parameter trees.

The inverses of ``convert_pointnet_encoder``/``convert_pointnet_decoder``
(soft_intro_vae_tpu/utils/torch_compat.py:143-192), of ``convert_mlp``
(:210-217), of ``convert_style_encoder``/``convert_style_generator``/
``convert_mapping`` (:264-321) and of the FID Inception's
``params_from_torch_state_dict`` (soft_intro_vae_tpu/metrics/fid.py:247),
and the layout changes of the DCGAN nets and the separable lreq convs
(soft_intro_vae_tpu/models/lreq.py:96-160). They take the trees as plain numpy arrays (nested dicts), so nothing here
imports JAX.

``checkpoint_payload_from_jax`` carries a whole JAX checkpoint (a decoded
``Checkpointer`` file, utils/flax_msgpack.py) into the port's train states:
the nets through the converters above, the optimizer's moments through the
same layout maps as the weights they belong to, the counts, LRs, EMA nets
and the step. A JAX PRNG key has no torch generator state: the port's
generator is seeded from the key's words (``seed_from_jax_key``), so after a
carry the draws are the port's own.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from soft_intro_vae_torch.models.conv import ResidualBlock, SoftIntroVAE
from soft_intro_vae_torch.models.mlp import SoftIntroVAESimple
from soft_intro_vae_torch.models.pointnet import SoftIntroVAE3D
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.train.style_step import StyleTrainState


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _linear(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[name + ".weight"] = _t(np.asarray(p["kernel"]).T)  # (in, out) -> (out, in)
    if "bias" in p:
        sd[name + ".bias"] = _t(p["bias"])


def pointnet_state_dict_from_jax(params_e: Mapping, stats_e: Mapping,
                                 params_d: Mapping) -> Dict[str, torch.Tensor]:
    """JAX PointNetEncoder/PointNetDecoder trees -> the port's ``SoftIntroVAE3D``
    state_dict, in the reference's names.

    Dense (in, out) -> Conv1d (out, in, 1) and Linear (out, in); BN
    scale/bias/mean/var -> weight/bias/running_mean/running_var with
    ``num_batches_tracked`` 0; the decoder output's columns go from the JAX
    point-major order (n*3 + c) to the reference's channel-major (c*N + n).
    """
    sd: Dict[str, torch.Tensor] = {}
    n_conv = sum(1 for k in params_e if k.startswith("conv_"))
    for i in range(n_conv):
        sd[f"encoder.conv.{3 * i}.weight"] = _t(np.asarray(params_e[f"conv_{i}"]["kernel"]).T[:, :, None])
        bn = f"encoder.conv.{3 * i + 2}"
        sd[bn + ".weight"] = _t(params_e[f"bn_{i}"]["scale"])
        sd[bn + ".bias"] = _t(params_e[f"bn_{i}"]["bias"])
        sd[bn + ".running_mean"] = _t(stats_e[f"bn_{i}"]["mean"])
        sd[bn + ".running_var"] = _t(stats_e[f"bn_{i}"]["var"])
        sd[bn + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    _linear(sd, "encoder.fc.0", params_e["fc"])
    _linear(sd, "encoder.mu_layer", params_e["mu_layer"])
    _linear(sd, "encoder.std_layer", params_e["std_layer"])

    n_hidden = sum(1 for k in params_d if k.startswith("fc_"))
    for i in range(n_hidden):
        _linear(sd, f"decoder.model.{2 * i}", params_d[f"fc_{i}"])
    out = params_d["out"]
    kernel = np.asarray(out["kernel"])
    n_points = kernel.shape[1] // 3
    # reference row r = c*N + n holds the JAX column j = n*3 + c
    c, n = np.divmod(np.arange(3 * n_points), n_points)
    j = n * 3 + c
    _linear(sd, f"decoder.model.{2 * n_hidden}",
            {"kernel": kernel[:, j], **({"bias": np.asarray(out["bias"])[j]} if "bias" in out else {})})
    return sd


def mlp_state_dict_from_jax(params: Mapping, n_layers: int,
                            prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX EncoderMLP/DecoderMLP tree -> the port's net's state_dict, in the
    reference's names under ``prefix`` (e.g. "encoder."); the inverse of
    ``convert_mlp`` (soft_intro_vae_tpu/utils/torch_compat.py:210-217)."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, prefix + "main.input", params["input"])
    for i in range(1, n_layers + 1):
        _linear(sd, prefix + f"main.hidden_{i}", params[f"hidden_{i}"])
    _linear(sd, prefix + "main.output", params["output"])
    return sd


def _conv_oihw(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))  # HWIO -> (out, in, kh, kw)


def inception_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                                  prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``InceptionV3FID`` variables (or one of its blocks') -> the port's
    state_dict under pytorch-fid's names; the inverse of
    ``params_from_torch_state_dict`` (soft_intro_vae_tpu/metrics/fid.py:247-288).

    Each ``BasicConv2d`` node ({"conv": {"kernel"}, "bn": {"scale", "bias"}}
    with {"bn": {"mean", "var"}} among the stats) becomes ``.conv.weight``
    (HWIO -> OIHW) and ``.bn.weight/bias/running_mean/running_var``.
    """
    sd: Dict[str, torch.Tensor] = {}
    if "conv" in params and "bn" in params:
        sd[prefix + "conv.weight"] = _conv_oihw(params["conv"]["kernel"])
        _bn(sd, prefix + "bn", params["bn"], batch_stats["bn"])
        return sd
    for name, node in params.items():
        sd.update(inception_state_dict_from_jax(node, batch_stats[name], f"{prefix}{name}."))
    return sd


def _bn(sd: Dict[str, torch.Tensor], name: str, params: Mapping, stats: Mapping) -> None:
    sd[name + ".weight"] = _t(params["scale"])
    sd[name + ".bias"] = _t(params["bias"])
    sd[name + ".running_mean"] = _t(stats["mean"])
    sd[name + ".running_var"] = _t(stats["var"])
    sd[name + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _resblock(sd: Dict[str, torch.Tensor], name: str, params: Mapping, stats: Mapping) -> None:
    for conv in ("conv1", "conv2", "conv_expand"):
        if conv in params:
            sd[f"{name}.{conv}.weight"] = _conv_oihw(params[conv]["kernel"])
    for bn in ("bn1", "bn2"):
        _bn(sd, f"{name}.{bn}", params[bn], stats[bn])


def _hwc_to_chw(c: int, s: int) -> np.ndarray:
    """For each CHW-flat position, the HWC-flat index holding it: PyTorch
    flattens a (C, s, s) map channel-major, the JAX nets an (s, s, C) one."""
    return np.arange(c * s * s).reshape(s, s, c).transpose(2, 0, 1).ravel()


def image_state_dict_from_jax(params_e: Mapping, stats_e: Mapping, params_d: Mapping,
                              stats_d: Mapping, channels, image_size: int,
                              params_t: Mapping = None,
                              stats_t: Mapping = None) -> Dict[str, torch.Tensor]:
    """JAX ConvEncoder/ConvDecoder trees (params and batch_stats) -> the port's
    ``SoftIntroVAE`` state_dict, in the reference's names; the inverse of
    ``convert_image_encoder``/``convert_image_decoder``
    (soft_intro_vae_tpu/utils/torch_compat.py:61-114).

    HWIO -> OIHW; Dense (in, out) -> Linear (out, in); BN scale/bias/mean/var
    -> weight/bias/running_mean/running_var. The encoder's fc rows and the
    decoder's fc columns and bias cross the flatten: they go from HWC-flat
    back to CHW-flat order (a conditional encoder's extra rows stay after the
    map's). ``params_t``/``stats_t``, when given, become ``target_decoder.``.
    """
    sd: Dict[str, torch.Tensor] = {}
    cc, sz = channels[0], image_size // 2
    sd["encoder.main.0.weight"] = _conv_oihw(params_e["stem_conv"]["kernel"])
    _bn(sd, "encoder.main.1", params_e["stem_bn"], stats_e["stem_bn"])
    for i, ch in enumerate(channels[1:]):
        _resblock(sd, f"encoder.main.res_in_{sz}", params_e[f"res_{i}"], stats_e[f"res_{i}"])
        cc, sz = ch, sz // 2
    _resblock(sd, f"encoder.main.res_in_{sz}", params_e["res_final"], stats_e["res_final"])
    kernel = np.asarray(params_e["fc"]["kernel"])
    n_map = cc * sz * sz
    rows = np.concatenate([_hwc_to_chw(cc, sz), np.arange(n_map, kernel.shape[0])])
    _linear(sd, "encoder.fc", {"kernel": kernel[rows], "bias": params_e["fc"]["bias"]})

    def decoder(prefix: str, params: Mapping, stats: Mapping) -> None:
        cc, sz = channels[-1], image_size // 2 ** len(channels)
        cols = _hwc_to_chw(cc, sz)
        _linear(sd, prefix + "fc.0", {"kernel": np.asarray(params["fc"]["kernel"])[:, cols],
                                      "bias": np.asarray(params["fc"]["bias"])[cols]})
        for i, ch in enumerate(reversed(channels)):
            _resblock(sd, f"{prefix}main.res_in_{sz}", params[f"res_{i}"], stats[f"res_{i}"])
            cc, sz = ch, sz * 2
        _resblock(sd, f"{prefix}main.res_in_{sz}", params["res_final"], stats["res_final"])
        sd[prefix + "main.predict.weight"] = _conv_oihw(params["predict"]["kernel"])
        sd[prefix + "main.predict.bias"] = _t(params["predict"]["bias"])

    decoder("decoder.", params_d, stats_d)
    if params_t is not None:
        decoder("target_decoder.", params_t, stats_t)
    return sd


def _conv_t_iohw(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(2, 3, 0, 1))  # HWIO -> (in, out, kh, kw)


def _plane_param(p) -> torch.Tensor:
    return _t(np.asarray(p).reshape(1, -1, 1, 1))  # (C,) -> (1, C, 1, 1)


def _lreq_linear(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[name + ".weight"] = _t(np.asarray(p["kernel"]).T)
    sd[name + ".bias"] = _t(p["bias"])


def _lreq_conv(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[name + ".weight"] = _conv_oihw(p["kernel"])
    if "bias" in p:
        sd[name + ".bias"] = _t(p["bias"])


def style_state_dict_from_jax(params_e: Mapping, params_d: Mapping,
                              buffers: Mapping) -> Dict[str, torch.Tensor]:
    """JAX StyleModel trees -> the port's ``StyleNets`` state_dict.

    params_e = {"encoder", "mapping_tl"}, params_d = {"decoder",
    "mapping_fl"}, buffers = {"dlatent_avg"}. Both packages store lreq
    weights in explicit mode (raw weight, scaled at forward time), so unlike
    the reference converters nothing is divided by the lreq std: only layouts
    change. HWIO -> (out, in, kh, kw) for convs and (in, out, kh, kw) for the
    fused-upscale transposed convs; Dense (in, out) -> Linear (out, in);
    (C,) biases and noise weights -> (1, C, 1, 1); const NHWC -> NCHW.

    The encoder variants' last block (EncoderWithStatistics, EncoderWithFC)
    holds ``dense`` in place of conv_2/bias_2: its input rows cross the
    flatten of the (4, 4, C) map, HWC-flat in JAX and CHW-flat here, so they
    are permuted as the image encoder's ``fc`` rows are. EncoderWithFC's
    ``fc2`` head is a plain lreq linear.
    """
    sd: Dict[str, torch.Tensor] = {}
    enc = params_e["encoder"]
    n_enc = sum(1 for k in enc if k.startswith("block_"))
    for i in range(n_enc):
        _lreq_conv(sd, f"encoder.from_rgb.{i}.from_rgb", enc[f"from_rgb_{i}"]["from_rgb"])
        blk, name = enc[f"block_{i}"], f"encoder.encode_block.{i}"
        _lreq_conv(sd, name + ".conv_1", blk["conv_1"])
        sd[name + ".bias_1"] = _plane_param(blk["bias_1"])
        if "dense" in blk:
            kernel = np.asarray(blk["dense"]["kernel"])
            rows = _hwc_to_chw(kernel.shape[0] // 16, 4)
            _lreq_linear(sd, name + ".dense", {"kernel": kernel[rows], "bias": blk["dense"]["bias"]})
        else:
            _lreq_conv(sd, name + ".conv_2", blk["conv_2"])
            sd[name + ".bias_2"] = _plane_param(blk["bias_2"])
        _lreq_linear(sd, name + ".style_1", blk["style_1"])
        _lreq_linear(sd, name + ".style_2", blk["style_2"])
    if "fc2" in enc:
        _lreq_linear(sd, "encoder.fc2", enc["fc2"])

    dec = params_d["decoder"]
    sd["decoder.const"] = _t(np.asarray(dec["const"]).transpose(0, 3, 1, 2))
    n_dec = sum(1 for k in dec if k.startswith("block_"))
    for i in range(n_dec):
        blk, name = dec[f"block_{i}"], f"decoder.decode_block.{i}"
        if "conv_1" in blk:
            fused = 2 ** (i + 2) >= 128  # StyleGenerator: resolution * 2 >= 128
            conv = _conv_t_iohw if fused else _conv_oihw
            sd[name + ".conv_1.weight"] = conv(blk["conv_1"]["kernel"])
        for k in ("noise_weight_1", "bias_1", "noise_weight_2", "bias_2"):
            sd[f"{name}.{k}"] = _plane_param(blk[k])
        _lreq_linear(sd, name + ".style_1", blk["style_1"])
        _lreq_conv(sd, name + ".conv_2", blk["conv_2"])
        _lreq_linear(sd, name + ".style_2", blk["style_2"])
        _lreq_conv(sd, f"decoder.to_rgb.{i}.to_rgb", dec[f"to_rgb_{i}"]["to_rgb"])

    for tree, name in ((params_e["mapping_tl"], "mapping_tl"), (params_d["mapping_fl"], "mapping_fl")):
        for i in range(len(tree)):
            _lreq_linear(sd, f"{name}.map_blocks.{i}.fc", tree[f"block_{i + 1}"])
    sd["dlatent_avg.buff"] = _t(buffers["dlatent_avg"])
    return sd


def mapping_no_style_state_dict_from_jax(params: Mapping,
                                         prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ``MappingToLatentNoStyle`` tree -> the port's module's
    state_dict: ``block_{i+1}`` -> the reference's bare ``map_blocks.{i}``
    (the inverse of ``convert_mapping(..., bare_linear=True)``,
    soft_intro_vae_tpu/utils/torch_compat.py:313-322)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(params)):
        _lreq_linear(sd, f"{prefix}map_blocks.{i}", params[f"block_{i + 1}"])
    return sd


def dcgan_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                              kind: str) -> Dict[str, torch.Tensor]:
    """A JAX ``DCGANGenerator`` (``kind="generator"``) or ``DCGANEncoder``
    (``"encoder"``) tree -> the port's net's state_dict (models/dcgan.py):
    ``deconv{i}``/``conv{i}`` and ``bn{i}`` -> ``main.{3 i}`` and
    ``main.{3 i + 1}``. flax's ``ConvTranspose(transpose_kernel=True)`` keeps
    the kernel of the forward convolution it is the gradient of, (kh, kw,
    out, in), as torch's ConvTranspose2d keeps that convolution's (in, out,
    kh, kw): the same permutation as a conv kernel's."""
    conv = "deconv" if kind == "generator" else "conv"
    sd: Dict[str, torch.Tensor] = {}
    for i in range(4):
        sd[f"main.{3 * i}.weight"] = _conv_oihw(params[f"{conv}{i}"]["kernel"])
        sd[f"main.{3 * i}.bias"] = _t(params[f"{conv}{i}"]["bias"])
        if i < 3:
            _bn(sd, f"main.{3 * i + 1}", params[f"bn{i}"], batch_stats[f"bn{i}"])
    return sd


def separable_state_dict_from_jax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ``LreqSeparableConv2d``/``LreqSeparableConvTranspose2d`` tree ->
    the port's module's state_dict under ``prefix``: ``depthwise_kernel``
    (k, k, 1, C) -> ``depthwise.weight`` (C, 1, k, k) and the ``pointwise``
    1 x 1 conv. The transposed form needs no flip: the JAX layer's
    lhs-dilated conv with the flipped kernel is ``F.conv_transpose2d`` with
    the kernel as stored."""
    sd: Dict[str, torch.Tensor] = {}
    sd[prefix + "depthwise.weight"] = _conv_oihw(params["depthwise_kernel"])
    _lreq_conv(sd, prefix + "pointwise", params["pointwise"])
    return sd


class _Tree(dict):
    """A decoded JAX tree that names the path of a leaf it lacks."""

    def __init__(self, tree: Mapping, path: str):
        super().__init__({k: _tree(v, f"{path}/{k}") for k, v in tree.items()})
        self.path = path

    def __missing__(self, key):
        raise KeyError(f"{self.path}/{key}")


def _tree(x, path: str):
    if isinstance(x, Mapping):
        return _Tree(x, path)
    if isinstance(x, torch.Tensor):  # a bfloat16 leaf (flax_msgpack)
        return x.float().numpy()
    return x


def _match(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor], what: str) -> None:
    """``got`` (carried from the file) has ``want``'s entries and shapes."""
    for k, w in want.items():
        if k not in got:
            raise ValueError(f"{what}: the JAX checkpoint has nothing for {k} "
                             f"{tuple(w.shape)} of the target")
        if tuple(got[k].shape) != tuple(w.shape):
            raise ValueError(f"{what}: {k} is {tuple(got[k].shape)} in the JAX checkpoint, "
                             f"{tuple(w.shape)} in the target")
    extra = [k for k in got if k not in want]
    if extra:
        raise ValueError(f"{what}: the JAX checkpoint has {extra[0]} "
                         f"{tuple(got[extra[0]].shape)}, which the target lacks")


def seed_from_jax_key(key) -> int:
    """The port's generator seed for a JAX PRNG key's raw uint32 words: the
    words read as one big-endian integer, modulo 2**64 (a threefry key
    (w0, w1) gives w0 * 2**32 + w1). A fixed rule, so a carried run is
    reproducible; the draws after the carry are the port's own."""
    seed = 0
    for w in np.asarray(key, dtype=np.uint32).reshape(-1):
        seed = ((seed << 32) | int(w)) % 2**64
    return seed


def _generator_state(key, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_from_jax_key(key))
    return gen.get_state()


def _image_layout(model: SoftIntroVAE):
    """(channels, image_size) of the port's image nets."""
    enc = model.encoder
    blocks = [m for m in enc.main if isinstance(m, ResidualBlock)]
    channels = (enc.main[0].out_channels,) + tuple(b.conv2.out_channels for b in blocks[:-1])
    return channels, enc.conv_output_spatial * 2 ** len(channels)


def _generic_state_dict(model, params_e, stats_e, params_d, stats_d, params_t=None,
                        stats_t=None) -> Dict[str, torch.Tensor]:
    """The JAX trees of the generic step's nets -> ``model``'s state_dict, by
    the converter of its kind (3D, image and bootstrap, toy)."""
    if isinstance(model, SoftIntroVAE3D):
        return pointnet_state_dict_from_jax(params_e, stats_e, params_d)
    if isinstance(model, SoftIntroVAE):
        channels, size = _image_layout(model)
        return image_state_dict_from_jax(params_e, stats_e, params_d, stats_d, channels, size,
                                         params_t, stats_t)
    if isinstance(model, SoftIntroVAESimple):
        n_layers = sum(1 for k in params_e if k.startswith("hidden_"))
        return {**mlp_state_dict_from_jax(params_e, n_layers, "encoder."),
                **mlp_state_dict_from_jax(params_d, n_layers, "decoder.")}
    raise TypeError(f"no JAX counterpart for a {type(model).__name__} model")


def _adam_state_dict(opt: torch.optim.Optimizer, names: Sequence[str], mu, nu, count,
                     lr) -> dict:
    """optax ``ScaleByAdamState(count, mu, nu)`` -> torch Adam's state_dict
    for ``opt``, whose parameters are ``names`` in order: ``step`` the count,
    ``exp_avg`` mu and ``exp_avg_sq`` nu (optax's count is the number of
    updates made, as torch's step is); the param group is ``opt``'s own."""
    (group,) = opt.state_dict()["param_groups"]
    step = torch.tensor(float(count), dtype=torch.float32)
    state = {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
             for i, n in enumerate(names)}
    return {"state": state, "param_groups": [{**group, "lr": float(lr)}]}


def train_state_payload_from_jax(tree: Mapping, state: TrainState) -> dict:
    """A JAX ``TrainState`` tree (soft_intro_vae_tpu/train/state.py:19-35)
    -> the payload of the port's ``TrainState.load_state_dict`` for
    ``state`` (3D, image, bootstrap and toy nets). The moments are converted
    as the weights are (OIHW, the image fc's HWC -> CHW order) and land in
    their parameters' memory layout when loaded (train/optim.py)."""
    t = _Tree(tree, "state")
    model = state.model
    sd = _generic_state_dict(model, t["params_e"], t["stats_e"], t["params_d"], t["stats_d"],
                             t["params_d_target"] or None, t["stats_d_target"] or None)
    _match(sd, model.state_dict(), "model")
    params = {k: p for k, p in model.named_parameters() if not k.startswith("target_decoder.")}
    moments = {}
    for which in ("mu", "nu"):
        m = _generic_state_dict(model, t["opt_e"][which], t["stats_e"], t["opt_d"][which],
                                t["stats_d"])
        _match({k: v for k, v in m.items() if k in params}, params, f"opt {which}")
        moments[which] = m
    out = {"model": sd, "step": int(t["step"]), "lr_e": float(t["lr_e"]),
           "lr_d": float(t["lr_d"]), "rng": _generator_state(t["rng"], state.device)}
    for opt, net, lr in (("opt_e", "encoder", "lr_e"), ("opt_d", "decoder", "lr_d")):
        names = [f"{net}.{n}" for n, _ in getattr(model, net).named_parameters()]
        out[opt] = _adam_state_dict(getattr(state, opt), names, moments["mu"], moments["nu"],
                                    t[opt]["count"], t[lr])
    return out


def style_state_payload_from_jax(tree: Mapping, state: StyleTrainState) -> dict:
    """A JAX ``StyleTrainState`` tree (soft_intro_vae_tpu/train/style_step.py:
    172-184) -> the payload of the port's ``StyleTrainState.load_state_dict``:
    the nets and their EMA twins, ``LreqAdamState(count, nu)``
    (soft_intro_vae_tpu/train/lreq_adam.py:25-27) as each LREQAdam's count
    and v in its parameters' order, the LR, the EMA beta and the step."""
    t = _Tree(tree, "state")
    nets = style_state_dict_from_jax(t["params_e"], t["params_d"], t["buffers"])
    _match(nets, state.nets.state_dict(), "nets")
    ema = style_state_dict_from_jax(t["ema_e"], t["ema_d"], t["ema_buffers"])
    _match(ema, state.ema.state_dict(), "ema")
    nu = style_state_dict_from_jax(t["opt_e"]["nu"], t["opt_d"]["nu"], t["buffers"])
    params = dict(state.nets.named_parameters())
    _match({k: v for k, v in nu.items() if k in params}, params, "opt nu")
    lr = torch.tensor(float(t["lr"]), dtype=torch.float32)
    out = {"nets": nets, "ema": ema, "step": int(t["step"]), "lr": lr,
           "ema_beta": torch.tensor(float(t["ema_beta"]), dtype=torch.float32),
           "rng": _generator_state(t["rng"], state.device)}
    for opt, subnets in (("opt_e", ("encoder", "mapping_tl")), ("opt_d", ("decoder", "mapping_fl"))):
        names = [f"{s}.{n}" for s in subnets for n, _ in getattr(state.nets, s).named_parameters()]
        out[opt] = {"count": torch.tensor(int(t[opt]["count"]), dtype=torch.int32),
                    "nu": [nu[n] for n in names], "lr": lr.clone()}
    return out


def checkpoint_payload_from_jax(tree: Mapping, state) -> dict:
    """A decoded JAX checkpoint file ({"epoch", "iteration", "extra",
    "state"}, soft_intro_vae_tpu/utils/checkpoint.py:59-84) -> the port's
    payload for ``state``: the state's entries, ``epoch``, ``iteration`` and
    ``extra``. A tree that does not match ``state``'s nets raises, naming the
    first leaf that differs; nothing is loaded in part."""
    keys = {"epoch", "iteration", "extra", "state"}
    if not isinstance(tree, Mapping) or set(tree) != keys:
        raise ValueError(f"a JAX checkpoint holds {sorted(keys)}; this one holds "
                         f"{sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__}")
    try:
        if isinstance(state, StyleTrainState):
            entries = style_state_payload_from_jax(tree["state"], state)
        elif isinstance(state, TrainState):
            entries = train_state_payload_from_jax(tree["state"], state)
        else:
            raise TypeError(f"a JAX checkpoint loads into a TrainState or a StyleTrainState, "
                            f"not a {type(state).__name__}")
    except KeyError as e:
        raise ValueError(f"the JAX checkpoint has no {e.args[0]}, which the target's "
                         f"config needs") from None
    return {**entries, "epoch": int(tree["epoch"]), "iteration": int(tree["iteration"]),
            "extra": dict(tree["extra"])}
