"""JAX param trees -> port state dicts (the inverse of
master_thesis_tpu/models/convert.py: chn_from_torch, cpn_from_torch,
cpn_aux_from_torch, vgg16_from_torch, dfpn_from_torch, lpips_from_torch),
and reference torch checkpoints -> port state dicts
(``load_torch_checkpoint``, ``strip_module_prefix``, and ``cpn_state`` /
``cpn_aux_state``, which split a reference CPN ``weight.pth``).

The trees arrive as nested dicts of numpy arrays (no JAX needed). Layout
rules: conv kernels HWIO -> OIHW; transposed-conv kernels ``(k, k, I, O)``
-> ``(I, O, k, k)``; Dense kernels ``(I, O)`` -> ``(O, I)``. The port's
modules keep the reference's state-dict keys, so a reference checkpoint
needs only unwrapping.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_CPN_AENC = ["conv12", "conv2", "conv23", "conv3", "conv34", "conv4a", "conv4b"]
_CPN_AREG = ["conv45", "conv5a", "conv5b", "conv56"]
_CPN_ENC = ["conv12", "conv2", "conv23", "conv3", "value3"]
_CPN_DEC = ["conv4", "conv5_1", "conv5_2", "convA4_1", "convA4_2", "convA4_3", "convA4_4", "conv3c",
            "conv3b", "conv3a", "conv32", "conv2", "conv21"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _conv(sd: Dict, prefix: str, kernel, bias) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(kernel).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _t(bias)


def strip_module_prefix(sd: Mapping) -> Dict:
    """Removes DataParallel ``module.`` prefixes (reference model_cpn.py:111-113)."""
    return {k.replace("module.", ""): v for k, v in sd.items()}


def unwrap_state_dict(data: Mapping) -> Dict[str, torch.Tensor]:
    """A loaded reference checkpoint as a flat state dict of tensors: a
    Lightning file's ``state_dict`` level taken, DataParallel ``module.``
    prefixes dropped. It goes into ``load_state_dict`` as it is."""
    if "state_dict" in data:
        data = data["state_dict"]
    return strip_module_prefix({k: torch.as_tensor(v) for k, v in dict(data).items()})


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` / ``.ckpt`` file (:func:`unwrap_state_dict`),
    on the CPU."""
    # A Lightning file holds more than tensors (hyper-parameters, loops).
    return unwrap_state_dict(torch.load(path, map_location="cpu", weights_only=False))


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


def cpn_aux_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CPN context params ``{"Encoder": ..., "Decoder": ...}`` (the
    layout of ``cpn_aux_from_torch``) -> a ``CPNContext`` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for group, names in (("Encoder", _CPN_ENC), ("Decoder", _CPN_DEC)):
        for name in names:
            q = params[group][name]
            _conv(sd, f"{group}.{name}.conv.0", q["kernel"], q["bias"])
    return sd


def _select(sd: Mapping, groups) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if k.split(".", 1)[0] in groups}


def cpn_state(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The ``CPN`` keys of a reference CPN state dict (``load_torch_checkpoint``
    of its ``weight.pth``): the aligner's, without the regressor's dead
    conv6a / conv6b and without the context modules'."""
    sd = _select(sd, ("A_Encoder", "A_Regressor"))
    return {k: v for k, v in sd.items() if not k.startswith(("A_Regressor.conv6a.", "A_Regressor.conv6b."))}


def cpn_aux_state(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The ``CPNContext`` keys of a reference CPN state dict: ``Encoder.*`` and
    ``Decoder.*``."""
    return _select(sd, ("Encoder", "Decoder"))


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


_ALEX_IDX = (0, 3, 6, 8, 10)


def lpips_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``LPIPS`` params (``net`` with ``conv0..4``, ``lin0..4``) -> an
    ``LPIPS`` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate(_ALEX_IDX):
        q = params["net"][f"conv{i}"]
        _conv(sd, f"net.features.{idx}", q["kernel"], q["bias"])
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = _t(np.asarray(params[f"lin{i}"]["kernel"]).transpose(3, 2, 0, 1))
    return sd
