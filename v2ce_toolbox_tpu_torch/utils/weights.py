"""Stage-1 weights: seeded random init, reference `.pt` loading, and the
conversion from the JAX package's variable tree.

`from_jax_variables` is the inverse of
`v2ce_toolbox_tpu/utils/torch_compat.convert_v2ce3d_state_dict`: it takes
the flax {'params', 'batch_stats', 'sn'} tree (numpy arrays) and returns
the port's state_dict (reference torch key names).
"""

from __future__ import annotations

import logging
import math
import os.path as op
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from v2ce_toolbox_tpu_torch.models.layers import SNConv3d, _l2normalize

logger = logging.getLogger(__name__)


def _j2t_conv(k: np.ndarray) -> np.ndarray:
    """flax (*spatial, I, O) -> torch (O, I, *spatial)."""
    nsp = k.ndim - 2
    return np.ascontiguousarray(np.transpose(k, (nsp + 1, nsp) + tuple(range(nsp))))


def from_jax_variables(variables: Mapping[str, Any], num_encoders: int = 4,
                       num_residual_blocks: int = 2) -> Dict[str, torch.Tensor]:
    """Flax V2ce3d variables -> the port's state_dict."""
    params = variables["params"]["unet"]
    stats = variables["batch_stats"]["unet"]
    sn = variables.get("sn", {}).get("unet", {})
    sd: Dict[str, np.ndarray] = {}

    def conv(tkey: str, p: Mapping, s: Optional[Mapping]):
        if "kernel_bar" in p:
            sd[f"{tkey}.module.weight_bar"] = _j2t_conv(np.asarray(p["kernel_bar"]))
            sd[f"{tkey}.module.weight_u"] = np.asarray(s["u"])
            sd[f"{tkey}.module.weight_v"] = np.asarray(s["v"])
            if "bias" in p:
                sd[f"{tkey}.module.bias"] = np.asarray(p["bias"])
        else:
            sd[f"{tkey}.weight"] = _j2t_conv(np.asarray(p["kernel"]))
            if "bias" in p:
                sd[f"{tkey}.bias"] = np.asarray(p["bias"])

    def bn(tkey: str, p: Mapping, s: Mapping):
        sd[f"{tkey}.weight"] = np.asarray(p["bn"]["scale"])
        sd[f"{tkey}.bias"] = np.asarray(p["bn"]["bias"])
        sd[f"{tkey}.running_mean"] = np.asarray(s["bn"]["mean"])
        sd[f"{tkey}.running_var"] = np.asarray(s["bn"]["var"])
        sd[f"{tkey}.num_batches_tracked"] = np.zeros((), np.int64)

    def block(tkey: str, name: str):
        p, s, q = params[name], stats[name], sn.get(name, {})
        conv(f"{tkey}.conv1", p["conv1"], q.get("conv1"))
        conv(f"{tkey}.conv2", p["conv2"], q.get("conv2"))
        bn(f"{tkey}.bn1", p["bn1"], s["bn1"])
        bn(f"{tkey}.bn2", p["bn2"], s["bn2"])
        conv(f"{tkey}.downsample.0", p["downsample_conv"], None)
        bn(f"{tkey}.downsample.1", p["downsample_bn"], s["downsample_bn"])

    conv("UNet.head.conv3d", params["head"]["conv"], None)
    for i in range(num_encoders):
        block(f"UNet.encoders.{i}", f"encoder_{i}")
    for i in range(num_residual_blocks):
        block(f"UNet.resblocks.{i}", f"resblock_{i}")
    for i in range(num_encoders):
        block(f"UNet.decoders.{i}", f"decoder_{i}")
    conv("UNet.pred.conv3d", params["pred"]["conv"], None)
    return {k: torch.from_numpy(np.array(v, dtype=v.dtype if v.dtype == np.int64
                                         else np.float32))
            for k, v in sd.items()}


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded random init: kaiming-normal (a=10, fan_in) conv kernels, zero
    biases, unit BN scale and variance, zero BN shift and mean, and unit
    random spectral-norm vectors."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SNConv3d):
                p = m.module
                tensors = [p.weight_bar]
                if p.bias is not None:
                    p.bias.zero_()
            elif isinstance(m, nn.Conv3d):
                tensors = [m.weight]
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()
                continue
            else:
                continue
            for w in tensors:
                fan_in = w.shape[1] * math.prod(w.shape[2:])
                std = math.sqrt(2.0 / (1.0 + 10.0 ** 2)) / math.sqrt(fan_in)
                w.copy_(torch.randn(w.shape, generator=g) * std)
            if isinstance(m, SNConv3d):
                p = m.module
                p.weight_u.copy_(_l2normalize(torch.randn(p.weight_u.shape, generator=g)))
                p.weight_v.copy_(_l2normalize(torch.randn(p.weight_v.shape, generator=g)))


def load_weights(model: nn.Module, model_path: Optional[str], seed: int = 0) -> None:
    """Load a reference `v2ce_3d.pt` state_dict as it is, or fall back to
    the seeded random init when the file does not exist."""
    if model_path and op.exists(model_path):
        if not model_path.endswith((".pt", ".pth")):
            raise ValueError(f"expected a torch state_dict (.pt/.pth), got {model_path}")
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
        model.load_state_dict(sd)
        return
    logger.warning("model checkpoint %s not found — using seeded random init",
                   model_path)
    init_weights(model, seed)
