"""JAX param trees -> port state dicts (the inverse of
master_thesis_tpu/models/convert.py: chn_from_torch, cpn_from_torch,
vgg16_from_torch, dfpn_from_torch).

The trees arrive as nested dicts of numpy arrays (no JAX needed). Layout
rules: conv kernels HWIO -> OIHW; transposed-conv kernels ``(k, k, I, O)``
-> ``(I, O, k, k)``; Dense kernels ``(I, O)`` -> ``(O, I)``.
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


# The reference DFPN's Sequential positions (model_dfpn.py:586-743).
_SEP4D_MAP = {
    "conv1_0": "conv.conv_1.0", "conv1_1": "conv.conv_1.2", "conv1_2": "conv.conv_1.4",
    "conv2_0": "conv.conv_2.0", "conv2_1": "conv.conv_2.2", "conv2_2": "conv.conv_2.4",
}
_MIXER_IDX = [0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 23, 24]
_FLOWEST = ["c0", "c1", "c2", "c3", "c4", "c5", "c6", "c7", "c8", "c9", "c10", "t0", "c11",
            "c12", "t1", "c13", "c14", "t2", "c15", "c16", "c17"]


def dfpn_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DFPN params (``separable4d``, ``mixer``, ``flow_64``,
    ``flow_256``) -> a ``DFPN`` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for mine, theirs in _SEP4D_MAP.items():
        q = params["separable4d"][mine]
        _conv(sd, f"corr.{theirs}", q["kernel"], q["bias"])
    for j, idx in enumerate(_MIXER_IDX):
        q = params["mixer"][f"mixer_{j}"]
        _conv(sd, f"corr_mixer.mixer.{idx}", q["kernel"], q["bias"])
    for est in ("flow_64", "flow_256"):
        for i, name in enumerate(_FLOWEST):
            q = params[est][name]
            if name.startswith("t"):
                sd[f"{est}.nn.{2 * i}.weight"] = _t(np.asarray(q["kernel"]).transpose(2, 3, 0, 1))
                sd[f"{est}.nn.{2 * i}.bias"] = _t(q["bias"])
            else:
                _conv(sd, f"{est}.nn.{2 * i}", q["kernel"], q["bias"])
    return sd
