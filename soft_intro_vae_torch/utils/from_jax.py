"""Weights carried across from the JAX package's parameter trees.

The inverses of ``convert_pointnet_encoder``/``convert_pointnet_decoder``
(soft_intro_vae_tpu/utils/torch_compat.py:143-192), of ``convert_mlp``
(:210-217), of ``convert_style_encoder``/``convert_style_generator``/
``convert_mapping`` (:264-321) and of the FID Inception's
``params_from_torch_state_dict`` (soft_intro_vae_tpu/metrics/fid.py:247).
They take the trees as plain numpy arrays (nested dicts), so nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
