"""Weights carried across from the JAX package's PointNet trees.

The inverse of ``convert_pointnet_encoder``/``convert_pointnet_decoder`` in
soft_intro_vae_tpu/utils/torch_compat.py:143-192. It takes the trees as plain
numpy arrays (nested dicts), so nothing here imports JAX.
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
