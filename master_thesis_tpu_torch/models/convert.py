"""JAX param trees -> port state dicts (the inverse of
master_thesis_tpu/models/convert.py: chn_from_torch, cpn_from_torch).

The trees arrive as nested dicts of numpy arrays (no JAX needed). Layout
rules: conv kernels HWIO -> OIHW; Dense kernels ``(I, O)`` -> ``(O, I)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_CPN_AENC = ["conv12", "conv2", "conv23", "conv3", "conv34", "conv4a", "conv4b"]
_CPN_AREG = ["conv45", "conv5a", "conv5b", "conv56"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _conv(sd: Dict, prefix: str, kernel, bias) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(kernel).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _t(bias)


def chn_from_jax(params: Mapping, nb: int) -> Dict[str, torch.Tensor]:
    """JAX CHN params ``{"nn": {...}}`` -> a ``CHN`` state dict."""
    p = params["nn"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(5):
        _conv(sd, f"nn.conv_first.{i}", p[f"conv_first_{i}_kernel"], p[f"conv_first_{i}_bias"])
    for i in range(nb):
        for j in (1, 2, 3):
            rdb = p[f"rrdb_{i}"][f"rdb{j}"]
            for k in range(1, 6):
                _conv(sd, f"nn.rrdb_trunk.{i}.rdb{j}.conv{k}", rdb[f"conv{k}_kernel"], rdb[f"conv{k}_bias"])
    for name in ("trunk_conv", "upconv1", "upconv2", "hr_conv", "conv_last"):
        _conv(sd, f"nn.{name}", p[f"{name}_kernel"], p[f"{name}_bias"])
    return sd


_VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def vgg_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``VGGFeatures`` params (``conv_{i}``) -> a ``VGGFeatures`` state
    dict, whose keys are torchvision's ``features.{idx}``."""
    sd: Dict[str, torch.Tensor] = {}
    for j, idx in enumerate(_VGG16_CONV_IDX):
        _conv(sd, f"features.{idx}", params[f"conv_{j}"]["kernel"], params[f"conv_{j}"]["bias"])
    return sd


def cpn_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CPN params ``{"A_Encoder": ..., "A_Regressor": ...}`` -> a ``CPN``
    state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for group, names in (("A_Encoder", _CPN_AENC), ("A_Regressor", _CPN_AREG)):
        for name in names:
            q = params[group][name]
            _conv(sd, f"{group}.{name}.conv.0", q["kernel"], q["bias"])
    fc = params["A_Regressor"]["fc"]
    sd["A_Regressor.fc.weight"] = _t(np.asarray(fc["kernel"]).T)
    sd["A_Regressor.fc.bias"] = _t(fc["bias"])
    return sd
