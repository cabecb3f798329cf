"""Weights: seeded random init, reference `.pt` loading, and the
conversion from the JAX package's variable trees.

`from_jax_variables` is the inverse of
`v2ce_toolbox_tpu/utils/torch_compat.convert_v2ce3d_state_dict`: it takes
the flax {'params', 'batch_stats', 'sn'} tree (numpy arrays) and returns
the port's state_dict (reference torch key names).
`block_from_jax_variables` and `conv_layer_from_jax_variables` do it for
one ResidualBlock3D or ConvLayer3D, `discriminator_from_jax_params` and
`voxel_encoder_from_jax_variables` for the training path's
PatchDiscriminator and VoxelEncoder, and `fastflownet_from_jax_variables`
for FastFlowNet; `load_fastflownet` reads the port's own FastFlowNet `.pt`.
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


def _to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=v.dtype if v.dtype == np.int64
                                         else np.float32))
            for k, v in sd.items()}


def _conv_sd(sd: Dict, tkey: str, p: Mapping, s: Optional[Mapping]) -> None:
    """A Conv (kernel, bias) or SNConv (kernel_bar, bias; u, v in `s`)."""
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


def _bn_sd(sd: Dict, tkey: str, p: Mapping, s: Mapping) -> None:
    sd[f"{tkey}.weight"] = np.asarray(p["bn"]["scale"])
    sd[f"{tkey}.bias"] = np.asarray(p["bn"]["bias"])
    sd[f"{tkey}.running_mean"] = np.asarray(s["bn"]["mean"])
    sd[f"{tkey}.running_var"] = np.asarray(s["bn"]["var"])
    sd[f"{tkey}.num_batches_tracked"] = np.zeros((), np.int64)


def _block_sd(sd: Dict, tkey: str, p: Mapping, s: Mapping, q: Mapping) -> None:
    """A ResidualBlock3D: params p, batch_stats s, sn q."""
    _conv_sd(sd, f"{tkey}conv1", p["conv1"], q.get("conv1"))
    _conv_sd(sd, f"{tkey}conv2", p["conv2"], q.get("conv2"))
    _bn_sd(sd, f"{tkey}bn1", p["bn1"], s["bn1"])
    _bn_sd(sd, f"{tkey}bn2", p["bn2"], s["bn2"])
    _conv_sd(sd, f"{tkey}downsample.0", p["downsample_conv"], None)
    _bn_sd(sd, f"{tkey}downsample.1", p["downsample_bn"], s["downsample_bn"])


def block_from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ResidualBlock3D variables -> the port's ResidualBlock3D
    state_dict."""
    sd: Dict[str, np.ndarray] = {}
    _block_sd(sd, "", variables["params"], variables.get("batch_stats", {}),
              variables.get("sn", {}))
    return _to_torch(sd)


def conv_layer_from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ConvLayer3D variables -> the port's ConvLayer3D state_dict."""
    p, sd = variables["params"], {}
    _conv_sd(sd, "conv3d", p["conv"], variables.get("sn", {}).get("conv"))
    if "norm" in p:
        _bn_sd(sd, "norm_layer", p["norm"], variables["batch_stats"]["norm"])
    return _to_torch(sd)


def from_jax_variables(variables: Mapping[str, Any], num_encoders: int = 4,
                       num_residual_blocks: int = 2) -> Dict[str, torch.Tensor]:
    """Flax V2ce3d variables -> the port's state_dict: every parameter,
    BN statistic and spectral-norm vector."""
    params = variables["params"]["unet"]
    stats = variables["batch_stats"]["unet"]
    sn = variables.get("sn", {}).get("unet", {})
    sd: Dict[str, np.ndarray] = {}

    def block(tkey: str, name: str):
        _block_sd(sd, f"{tkey}.", params[name], stats[name], sn.get(name, {}))

    _conv_sd(sd, "UNet.head.conv3d", params["head"]["conv"], None)
    for i in range(num_encoders):
        block(f"UNet.encoders.{i}", f"encoder_{i}")
    for i in range(num_residual_blocks):
        block(f"UNet.resblocks.{i}", f"resblock_{i}")
    for i in range(num_encoders):
        block(f"UNet.decoders.{i}", f"decoder_{i}")
    _conv_sd(sd, "UNet.pred.conv3d", params["pred"]["conv"], None)
    return _to_torch(sd)


def discriminator_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax PatchDiscriminator2D/3D params (Conv_0 ... Conv_4) -> the
    port's discriminator state_dict (convs.0 ... convs.4)."""
    sd: Dict[str, np.ndarray] = {}
    for i in range(len(params)):
        _conv_sd(sd, f"convs.{i}", params[f"Conv_{i}"], None)
    return _to_torch(sd)


def voxel_encoder_from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax VoxelEncoder variables -> the port's VoxelEncoder state_dict.
    A flax DenseGeneral attention projection (d, heads, head_dim) or
    (heads, head_dim, d) is a torch Linear weight (out, in)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def dense(tkey: str, q: Mapping, n_in: int = 1):
        """A kernel (in axes..., out axes...) with n_in input axes."""
        k = np.asarray(q["kernel"])
        sd[f"{tkey}.weight"] = np.ascontiguousarray(
            k.reshape(math.prod(k.shape[:n_in]), -1).T)
        sd[f"{tkey}.bias"] = np.asarray(q["bias"]).reshape(-1)

    for name in ("down0", "down1", "down2"):
        _conv_sd(sd, f"{name}_conv", p[f"{name}_conv"], None)
        sd[f"{name}_bn.weight"] = np.asarray(p[f"{name}_bn"]["scale"])
        sd[f"{name}_bn.bias"] = np.asarray(p[f"{name}_bn"]["bias"])
        sd[f"{name}_bn.running_mean"] = np.asarray(s[f"{name}_bn"]["mean"])
        sd[f"{name}_bn.running_var"] = np.asarray(s[f"{name}_bn"]["var"])
        sd[f"{name}_bn.num_batches_tracked"] = np.zeros((), np.int64)
    for i in range(2):
        q = p[f"encoder_{i}"]
        for proj in ("query", "key", "value", "out"):
            dense(f"encoder_{i}.self_attn.{proj}", q["self_attn"][proj],
                  2 if proj == "out" else 1)
        for ln in ("norm1", "norm2"):
            sd[f"encoder_{i}.{ln}.weight"] = np.asarray(q[ln]["scale"])
            sd[f"encoder_{i}.{ln}.bias"] = np.asarray(q[ln]["bias"])
        for lin in ("linear1", "linear2"):
            dense(f"encoder_{i}.{lin}", q[lin])
    dense("output", p["output"])
    return _to_torch(sd)


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


# FastFlowNet: the flax names of the JAX package's convs. `_convrelu`'s
# convs bind to the module that builds them, so FastFlowNet's top level
# holds Conv_0 ... Conv_12 in creation order (the three pyramid stages,
# then rconv2 ... rconv6), and each decoder Conv_0 ... Conv_5 plus conv7.
_FFN_TOP = ["pconv1_1", "pconv1_2", "pconv2_1", "pconv2_2", "pconv2_3",
            "pconv3_1", "pconv3_2", "pconv3_3",
            "rconv2", "rconv3", "rconv4", "rconv5", "rconv6"]
_FFN_DECODER = ["conv1", "conv2", "conv3", "conv4", "conv5", "conv6"]


def fastflownet_from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax FastFlowNet variables ({'params': ...}, numpy arrays) -> the
    port's FastFlowNet state_dict. A flax ConvTranspose (SAME, stride 2)
    is torch's ConvTranspose2d(4, 2, 1) with the kernel flipped in both
    spatial axes and laid out (in, out, kh, kw)."""
    params = variables["params"]
    sd: Dict[str, np.ndarray] = {}

    def conv(tkey: str, p: Mapping):
        sd[f"{tkey}.weight"] = _j2t_conv(np.asarray(p["kernel"]))
        sd[f"{tkey}.bias"] = np.asarray(p["bias"])

    for i, name in enumerate(_FFN_TOP):
        conv(f"{name}.0", params[f"Conv_{i}"])
    for lvl in (3, 4, 5, 6):
        p = params[f"up{lvl}"]
        k = np.asarray(p["kernel"])[::-1, ::-1]               # (kh, kw, in, out)
        sd[f"up{lvl}.weight"] = np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))
        sd[f"up{lvl}.bias"] = np.asarray(p["bias"])
    for lvl in (2, 3, 4, 5, 6):
        p = params[f"decoder{lvl}"]
        for i, name in enumerate(_FFN_DECODER):
            conv(f"decoder{lvl}.{name}.0", p[f"Conv_{i}"])
        conv(f"decoder{lvl}.conv7", p["conv7"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_fastflownet(path: str) -> Dict[str, torch.Tensor]:
    """The port's FastFlowNet state_dict from a torch `.pt`/`.pth` file
    (`torch.save(net.state_dict(), path)`)."""
    if not path.endswith((".pt", ".pth")):
        raise ValueError(f"expected a torch state_dict (.pt/.pth), got {path}")
    return torch.load(path, map_location="cpu", weights_only=True)
