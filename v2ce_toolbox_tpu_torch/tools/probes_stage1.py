"""The stage-1 probes of the JAX package's `tools/perf_probe.py`, on the
port: the full-width V2ce3d forward in each ported configuration (cuDNN,
K9 `conv3d_3x3x3`, K10 `fused_up_concat_conv`; f32 and bf16; padded, per
batch size, without spectral norm or BN), and its convs alone against
cuDNN. `perf_probe` registers them under their JAX names (`PROBES` below)
and runs them.

Each probe keeps the JAX probe's shapes as keyword defaults and prints its
line labels: "xla" names cuDNN (`F.conv3d`, its output in the input
dtype, where XLA's was f32), "pallas" the port's CUDA kernel. The models
carry seeded random weights (`init_weights`, seed 0); large inputs are
made on the device from a seeded generator. f32 convs run as the caller
set TF32 (the harness's `devices:` line states it). A timed call hands the
timing loop's checksum a thin slice of its output (`probes_stage2.sample`).
A JAX option that the port does not carry prints "not ported" or "not
applicable" with its reason. `KERNELS` names the kernels each probe must
launch on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.tools.probes_stage2 import _failed, _model, _timed, rand, sample

H, W, FRAMES = 260, 346, 16

# probe -> the port kernels it launches on the card
KERNELS = {
    "model": (), "model_pad": (), "model_bf16": (), "model_bf16_pad": (),
    "conv_iso": (),
    "pallas_conv": ("conv3d_3x3x3",),
    "model_pallas": ("conv3d_3x3x3",), "model_pallas_bf16": ("conv3d_3x3x3",),
    "model_subpixel": ("fused_up_concat_conv",),
    "pallas_model": ("fused_up_concat_conv",),
    "fused_dec": ("fused_up_concat_conv",),
    "batch_scaling": (), "model_overhead": (),
}
# the sub-pixel decoder's only ported form: K10 on the last two decoders
# (at full width the earlier ones exceed its Co <= 64)
SUBPIXEL = dict(subpixel_decoder=True, subpixel_impl="pallas", subpixel_blocks=2)


def _frames(dev, b, frames, h, w) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(0).rand(b, frames, h, w, 2)
                            .astype(np.float32)).to(dev)


def _forward(model, out=sample):
    def fn(args):
        with torch.no_grad():
            return out(model(args[0]))
    return fn


def _conv(x: torch.Tensor, k: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """cuDNN conv of channels-last (B, L, H, W, C) by (kd, kh, kw, C, Co),
    output in the input dtype, channels-last."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2),
                    padding=padding).permute(0, 2, 3, 4, 1)


def _exact(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The 3x3x3 'same' conv of x's and k's values summed in f64."""
    return _conv(x.double(), k.double())


def probe_model(dev, label="model", compute_dtype=torch.float32, pad_to=None, h=H, w=W,
                frames=FRAMES, model_kw=None, **cfg):
    """One full-width V2ce3d window forward, (1, 16, 260, 346, 2) -> 20
    voxel channels, in ModelConfig(compute_dtype, **cfg); with `pad_to`,
    the input zero-padded to (H, W) and the output cropped back."""
    model = _model(dev, model_kw, compute_dtype=compute_dtype, **cfg)
    x = _frames(dev, 1, frames, h, w)
    fn = _forward(model)
    if pad_to is not None:
        ph, pw = pad_to
        fwd = _forward(model, lambda y: sample(y[:, :, :h, :w]))
        fn = lambda args: fwd((F.pad(args[0], (0, 0, 0, pw - w, 0, ph - h)),))  # noqa: E731
    dt = _timed(fn, (x,))
    print(f"{label}: {dt*1e3:.2f} ms/window ({frames/dt:.1f} fps)", flush=True)
    return {"window_s": dt}


CONV_ISO_SHAPES = [
    ("dec0_conv1", (1, 16, 33, 44, 768), 256),
    ("dec2_conv1", (1, 16, 130, 173, 192), 64),
    ("enc1_conv2", (1, 16, 65, 87, 128), 128),
]


def shifted_matmul(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The 3x3x3 'same' conv of (N, L, H, W, C) by (3, 3, 3, C, Co) as 27
    shifted matmuls (`torch.einsum`), each tap's product in the input dtype
    added into an f32 sum."""
    n, l, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    out = torch.zeros((n, l, h, w, k.shape[-1]), dtype=torch.float32, device=x.device)
    for dl in range(3):
        for dh in range(3):
            for dw in range(3):
                sl = xp[:, dl:dl + l, dh:dh + h, dw:dw + w]
                out += torch.einsum("nlhwc,co->nlhwo", sl, k[dl, dh, dw]).float()
    return out


def probe_conv_iso(dev, shapes=CONV_ISO_SHAPES):
    """Decoder-shaped 3x3x3 convs alone: cuDNN against the 27-term
    shifted-matmul form, each in f32 and bf16 (the cast inside the timed
    call, as in the JAX probe)."""
    res = {}
    for name, xshape, cout in shapes:
        cin = xshape[-1]
        x = rand(dev, xshape)
        k = rand(dev, (3, 3, 3, cin, cout), 1, 0.01)
        flops = 2 * int(np.prod(xshape[:4])) * cin * cout * 27
        for label, form, dt in [("conv_f32", _conv, torch.float32),
                                ("conv_bf16", _conv, torch.bfloat16),
                                ("mm_f32", shifted_matmul, torch.float32),
                                ("mm_bf16", shifted_matmul, torch.bfloat16)]:
            try:
                t = _timed(lambda a, form=form, dt=dt: sample(form(a[0].to(dt), a[1].to(dt))),
                           (x, k))
                res[(name, label)] = t
                print(f"{name} {label}: {t*1e3:.2f} ms  {flops/t/1e12:.1f} TF/s", flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"{name} {label}", e)
        del x, k
    return res


PALLAS_CONV_SHAPES = [
    ("res_512", (1, 16, 17, 22, 512), 512),
    ("dec0_conv1", (1, 16, 33, 44, 768), 256),
    ("dec1_conv1", (1, 16, 65, 87, 384), 128),
    ("dec2_conv1", (1, 16, 130, 173, 192), 64),
    ("dec3_conv1", (1, 16, 260, 346, 96), 32),
    ("enc1_conv2", (1, 16, 65, 87, 128), 128),
    ("dec3_conv2", (1, 16, 260, 346, 32), 32),
]


def probe_pallas_conv(dev, shapes=PALLAS_CONV_SHAPES):
    """K9 `conv3d_3x3x3` (f32 out) against cuDNN (`F.conv3d`, out in the
    input dtype) on the model's layer shapes, f32 and bf16. rel_err is K9's
    largest distance from the conv of the same input values summed in f64
    (`_exact`), over its largest output; cuDNN's distance follows it."""
    from v2ce_toolbox_tpu_torch.ops.conv3d import conv3d_3x3x3

    res = {}
    for name, xshape, cout in shapes:
        cin = xshape[-1]
        xf = rand(dev, xshape)
        kf = rand(dev, (3, 3, 3, cin, cout), 1, 0.01)
        flops = 2 * int(np.prod(xshape[:4])) * cin * cout * 27
        for dt, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x, k = xf.to(dt), kf.to(dt)
            try:
                with torch.no_grad():
                    exact = _exact(x, k)
                    scale = float(exact.abs().max()) + 1e-30
                    rel = float((conv3d_3x3x3(x, k).double() - exact).abs().max()) / scale
                    rel_x = float((_conv(x, k).double() - exact).abs().max()) / scale
                del exact
                dt_p = _timed(lambda a: sample(conv3d_3x3x3(*a)), (x, k))
                dt_x = _timed(lambda a: sample(_conv(*a)), (x, k))
                res[(name, label)] = {"pallas_s": dt_p, "xla_s": dt_x, "rel_err": rel,
                                      "xla_rel_err": rel_x}
                print(f"{name} {label}: pallas {dt_p*1e3:.2f} ms ({flops/dt_p/1e12:.1f} TF/s) "
                      f"vs xla {dt_x*1e3:.2f} ms ({flops/dt_x/1e12:.1f} TF/s); rel_err "
                      f"{rel:.2e} (xla {rel_x:.2e}; both from the f64 sum)", flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"{name} {label}", e)
            del x, k
        del xf, kf
    return res


def probe_pallas_model(dev, h=H, w=W, frames=FRAMES, model_kw=None):
    """The bf16 V2ce3d forward with the direct decoder, then with K10 on
    the last one and the last two decoder blocks (one set of weights),
    channel-major output as the driver takes it."""
    x = _frames(dev, 1, frames, h, w)
    variants = [("base", {}), ("pallas-last1", dict(SUBPIXEL, subpixel_blocks=1)),
                ("pallas-last2", SUBPIXEL)]
    res, state = {}, None
    for name, kw in variants:
        model = _model(dev, model_kw, state, compute_dtype=torch.bfloat16, **kw)
        state = model.state_dict()
        fwd = _forward(model, lambda y: sample(y.permute(0, 1, 4, 2, 3).contiguous()))
        res[name] = dt = _timed(fwd, (x,))
        print(f"pallas_model {name}: {dt*1e3:.2f} ms/window ({frames/dt:.1f} fps)", flush=True)
        del model
    return res


FUSED_DEC_GEOMS = [
    # name, hc, wc, hf, wf, Cu, Cs, Co, with the 1x1 projection
    ("dec3", 130, 173, 260, 346, 64, 32, 32, True),
    ("dec2", 65, 87, 130, 173, 128, 64, 64, False),
]


def probe_fused_dec(dev, geoms=FUSED_DEC_GEOMS, frames=FRAMES):
    """K10 `fused_up_concat_conv` against the direct path (nearest
    upsample, concat, cuDNN conv, and the 1x1 projection where dec3 has
    it) at the decoder's dec3 and dec2 conv1 shapes, bf16, and the
    upsample + concat alone. The JAX probe's `fused-k64` variant sets
    `k_align`, a lane-tile knob of the TPU kernel that the port's kernel
    does not have: it prints as not applicable."""
    from v2ce_toolbox_tpu_torch.models.layers import upsample_nearest_to
    from v2ce_toolbox_tpu_torch.ops.decoder import fused_up_concat_conv

    res = {}
    for name, hc, wc, hf, wf, cu, cs, co, with_proj in geoms:
        bf = torch.bfloat16
        coarse = rand(dev, (1, frames, hc, wc, cu)).to(bf)
        skip = rand(dev, (1, frames, hf, wf, cs), 1).to(bf)
        k = rand(dev, (3, 3, 3, cu + cs, co), 2, 0.02).to(bf)
        kd = rand(dev, (1, 1, 1, cu + cs, co), 3, 0.02).to(bf) if with_proj else None
        flops = 2 * frames * hf * wf * (cu + cs) * co * (27 + with_proj)

        def up_concat(c, s):
            up = upsample_nearest_to(c.permute(0, 4, 1, 2, 3), (s.shape[2], s.shape[3]))
            return torch.cat([up.permute(0, 2, 3, 4, 1), s], dim=-1)

        def direct(args):
            c, s, kk, kkd = args
            x = up_concat(c, s)
            y = sample(_conv(x, kk))
            return y if kkd is None else (y, sample(_conv(x, kkd, 0)))

        def fused(args):
            out = fused_up_concat_conv(*args, out_dtype=bf)
            return tuple(map(sample, out)) if isinstance(out, tuple) else sample(out)

        args = tuple(a for a in (coarse, skip, k, kd) if a is not None)
        variants = [("direct", direct), ("up+concat", lambda a: sample(up_concat(a[0], a[1]))),
                    ("fused", fused)]
        for impl, fn in variants:
            try:
                with torch.no_grad():
                    t = _timed(lambda a, fn=fn: fn(a + (None,) * (4 - len(a))), args)
                res[(name, impl)] = t
                print(f"fused_dec {name} {impl}: {t*1e3:.2f} ms  {flops/t/1e12:.1f} "
                      "TF/s-useful", flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"fused_dec {name} {impl}", e)
        if (cu + 4 * cs) % 128:
            res[(name, "fused-k64")] = None
            print(f"fused_dec {name} fused-k64: not applicable (k_align pads the TPU kernel's "
                  "K to Mosaic lane tiles; the port's kernel has no such knob)", flush=True)
        del coarse, skip, k, kd, args
    return res


def probe_batch_scaling(dev, batches=(1, 2, 4), h=H, w=W, frames=FRAMES, model_kw=None):
    """The V2ce3d forward over B = 1, 2 and 4 windows at once, f32 and
    bf16: what a batch saves a window on the small-spatial layers."""
    res = {}
    x1 = _frames(dev, 1, frames, h, w)
    for dt_name, dt in [("f32", torch.float32), ("bf16", torch.bfloat16)]:
        fwd = _forward(_model(dev, model_kw, compute_dtype=dt))
        for b in batches:
            x = x1.expand(b, *x1.shape[1:]) + (torch.arange(b, dtype=torch.float32, device=dev)
                                               * 1e-6).view(b, 1, 1, 1, 1)
            try:
                t = _timed(fwd, (x,))
                res[(b, dt_name)] = t
                print(f"model B={b} {dt_name}: {t*1e3:.1f} ms ({b*frames/t:.1f} fps, "
                      f"{t/b*1e3:.1f} ms/window)", flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"model B={b} {dt_name}", e)
            del x
        del fwd
    return res


def probe_model_overhead(dev, h=H, w=W, frames=FRAMES, model_kw=None):
    """The bf16 model with and without spectral norm and BN: what the SN
    weight recompute and the norms cost beside the convs. The JAX probe's
    last variant also knocks out every conv (`conv_impl="ko:all"`), a
    rewrite the port does not carry: it prints as not ported."""
    variants = [("model[bf16]", {}), ("model[no_sn]", dict(spectral_norm=False)),
                ("model[no_bn]", dict(norm=None)),
                ("model[no_sn_no_bn]", dict(spectral_norm=False, norm=None)),
                ("model[ko:all,no_sn,no_bn]",
                 dict(conv_impl="ko:all", spectral_norm=False, norm=None))]
    res = {}
    for label, cfg in variants:
        try:
            r = probe_model(dev, label, torch.bfloat16, h=h, w=w, frames=frames,
                            model_kw=model_kw, **cfg)
        except NotImplementedError as e:
            res[label] = None
            print(f"{label}: not ported ({e})", flush=True)
            continue
        res[label] = r["window_s"]
    return res


PROBES = {
    "model": probe_model,
    "model_pad": functools.partial(probe_model, label="model_pad384", pad_to=(264, 384)),
    "model_bf16": functools.partial(probe_model, label="model_bf16",
                                    compute_dtype=torch.bfloat16),
    "model_bf16_pad": functools.partial(probe_model, label="model_bf16_pad384",
                                        compute_dtype=torch.bfloat16, pad_to=(264, 384)),
    "conv_iso": probe_conv_iso,
    "pallas_conv": probe_pallas_conv,
    "model_pallas_bf16": functools.partial(probe_model, label="model_pallas_bf16",
                                           compute_dtype=torch.bfloat16, conv_impl="pallas"),
    "model_pallas": functools.partial(probe_model, label="model_pallas_f32",
                                      conv_impl="pallas"),
    "model_subpixel": functools.partial(probe_model, label="model_subpixel[pallas, last 2]",
                                        **SUBPIXEL),
    "pallas_model": probe_pallas_model,
    "fused_dec": probe_fused_dec,
    "batch_scaling": probe_batch_scaling,
    "model_overhead": probe_model_overhead,
}
