"""The stage-1 probes of the JAX package's `tools/perf_probe.py`, on the
port: the full-width V2ce3d forward in each configuration (cuDNN, K9
`conv3d_3x3x3`, K10 `fused_up_concat_conv`, the sub-pixel decoder's
forms, decoder_split, out_layout 'cm', the conv rewrites 'fold', 'd2',
'd2s' and the knockouts; f32 and bf16; padded, per batch size, without
spectral norm or BN), its convs alone against cuDNN, and the rewrites'
convs alone (width packing, the 2D decomposition, the depth fold, the
boundary layers, Winograd F(2x2,3x3)). `perf_probe` registers them under
their JAX names (`PROBES` below) and runs them.

Each probe keeps the JAX probe's shapes as keyword defaults and prints its
line labels: "xla" names cuDNN (`F.conv3d`, its output in the input
dtype, where XLA's was f32), "pallas" the port's CUDA kernel. The models
carry seeded random weights (`init_weights`, seed 0); large inputs are
made on the device from a seeded generator. f32 convs run as the caller
set TF32 (the harness's `devices:` line states it). A timed call hands the
timing loop's checksum a thin slice of its output (`probes_stage2.sample`).
A JAX option that the port does not carry prints "not applicable" with
its reason. `KERNELS` names the kernels each probe must
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
    "model_subpixel": (),
    "pallas_model": ("fused_up_concat_conv",),
    "fused_dec": ("fused_up_concat_conv",),
    "batch_scaling": (), "model_overhead": (),
    "wpack": (), "conv2d_decomp": (), "d2": (), "model_d2": (), "model_knockout": (),
    "boundary": (), "model_variants": (),
    "subpixel_variants": ("fused_up_concat_conv",),
    "winograd": (),
}
# K10 on the last two decoders (at full width the earlier ones exceed its
# Co <= 64)
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
    weight recompute and the norms cost beside the convs; the last variant
    also knocks out every 3x3x3 conv of the blocks (`conv_impl="ko:all"`)."""
    variants = [("model[bf16]", {}), ("model[no_sn]", dict(spectral_norm=False)),
                ("model[no_bn]", dict(norm=None)),
                ("model[no_sn_no_bn]", dict(spectral_norm=False, norm=None)),
                ("model[ko:all,no_sn,no_bn]",
                 dict(conv_impl="ko:all", spectral_norm=False, norm=None))]
    return {label: probe_model(dev, label, torch.bfloat16, h=h, w=w, frames=frames,
                               model_kw=model_kw, **cfg)["window_s"]
            for label, cfg in variants}


WPACK_LAYERS = [
    ("head", 260, 346, 2, 32, (1, 1, 1)),
    ("enc1_c1s2", 260, 346, 32, 64, (1, 2, 2)),
    ("enc1_c2", 130, 173, 64, 64, (1, 1, 1)),
    ("enc2_c1s2", 130, 173, 64, 128, (1, 2, 2)),
    ("enc4_c1s2", 33, 44, 256, 512, (1, 2, 2)),
    ("botl_c", 17, 22, 512, 512, (1, 1, 1)),
    ("dec0_c1", 33, 44, 768, 256, (1, 1, 1)),
    ("dec1_c1", 65, 87, 384, 128, (1, 1, 1)),
    ("dec1_c2", 65, 87, 128, 128, (1, 1, 1)),
    ("dec2_c1", 130, 173, 192, 64, (1, 1, 1)),
    ("dec2_c2", 130, 173, 64, 64, (1, 1, 1)),
    ("dec3_c1", 260, 346, 96, 32, (1, 1, 1)),
    ("dec3_c2", 260, 346, 32, 32, (1, 1, 1)),
]


def _ncdhw(dev, cin, frames, h, w, cout, seed=0):
    """A U[0, 1) NCDHW input and a U[0, 0.01) (Co, C, 3, 3, 3) kernel."""
    return rand(dev, (1, cin, frames, h, w), seed), rand(dev, (cout, cin, 3, 3, 3), seed + 1, 0.01)


def probe_wpack(dev, layers=WPACK_LAYERS, frames=FRAMES):
    """`ops/wpack.conv3d_wpack` (the width-packed (3,3,1) conv, through
    cuDNN) on the model's layers, f32 and bf16."""
    from v2ce_toolbox_tpu_torch.ops.wpack import conv3d_wpack

    res = {}
    for name, h, w, cin, cout, strides in layers:
        x, k = _ncdhw(dev, cin, frames, h, w, cout)
        ho, wo = -(-h // strides[1]), -(-w // strides[2])
        flops = 2 * frames * ho * wo * cin * cout * 27
        for dt_name, dt in [("f32", torch.float32), ("bf16", torch.bfloat16)]:
            try:
                with torch.no_grad():
                    t = _timed(lambda a, dt=dt, s=strides: sample(
                        conv3d_wpack(a[0], a[1], s, compute_dtype=dt)), (x, k))
                res[(name, dt_name)] = t
                print(f"wpack {name} {dt_name}: {t*1e3:.2f} ms  {flops/t/1e12:.1f} TF/s",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"wpack {name} {dt_name}", e)
        del x, k
    return res


C2D_LAYERS = [
    ("head", 260, 346, 2, 32, 1),
    ("enc1_c1s2", 260, 346, 32, 64, 2),
    ("enc1_c2", 130, 173, 64, 64, 1),
    ("dec2_c1", 130, 173, 192, 64, 1),
    ("dec2_c2", 130, 173, 64, 64, 1),
    ("dec3_c1", 260, 346, 96, 32, 1),
    ("dec3_c2", 260, 346, 32, 32, 1),
    ("botl_c", 17, 22, 512, 512, 1),
    ("dec0_c1", 33, 44, 768, 256, 1),
]


def probe_conv2d_decomp(dev, layers=C2D_LAYERS, frames=FRAMES):
    """The 3x3x3 conv as three L-shifted 2D convs (`F.conv2d`, cuDNN) over
    the (B*L) frames, f32 and bf16, summed in f32 (the cast inside the
    timed call). The input is (B, L, C, H, W), so the frames are a free
    reshape."""
    res = {}
    for name, h, w, cin, cout, s in layers:
        x = rand(dev, (1, frames, cin, h, w))
        k = rand(dev, (3, cout, cin, 3, 3), 1, 0.01)
        ho, wo = -(-h // s), -(-w // s)
        flops = 2 * frames * ho * wo * cin * cout * 27

        def fn(args, dt, s=s, ho=ho, wo=wo, cout=cout):
            xx, kk = args[0].to(dt), args[1].to(dt)
            b, l = xx.shape[:2]
            x2 = xx.reshape(b * l, *xx.shape[2:])
            outs = [F.conv2d(x2, kk[dl], stride=s, padding=1).float().reshape(b, l, cout, ho, wo)
                    for dl in range(3)]
            # out[l] += conv_dl(x[l + dl - 1])
            out = outs[1].clone()
            out[:, 1:] += outs[0][:, :-1]
            out[:, :-1] += outs[2][:, 1:]
            return sample(out)

        for dt_name, dt in [("f32", torch.float32), ("bf16", torch.bfloat16)]:
            try:
                with torch.no_grad():
                    t = _timed(functools.partial(fn, dt=dt), (x, k))
                res[(name, dt_name)] = t
                print(f"c2d {name} {dt_name}: {t*1e3:.2f} ms  {flops/t/1e12:.1f} TF/s",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"c2d {name} {dt_name}", e)
        del x, k
    return res


D2_LAYERS = [
    ("dec3_c2", 260, 346, 32, 32),
    ("dec3_c1", 260, 346, 96, 32),
    ("enc1_c2", 130, 173, 64, 64),
    ("dec2_c1", 130, 173, 192, 64),
    ("dec2_c2", 130, 173, 64, 64),
    ("enc2_c2", 65, 87, 128, 128),
    ("dec1_c1", 65, 87, 384, 128),
    ("botl_c", 17, 22, 512, 512),
]


def probe_d2(dev, layers=D2_LAYERS, frames=FRAMES):
    """The depth fold (`_apply_conv` 'd2': one 2D conv with the depth taps
    in its 3*Co outputs, then the L shift-add) against the direct conv
    ('xla', cuDNN) in bf16, on the small-Co layers."""
    from v2ce_toolbox_tpu_torch.models.layers import _apply_conv

    res = {}
    for name, h, w, cin, cout in layers:
        x, k = _ncdhw(dev, cin, frames, h, w, cout)
        flops = 2 * frames * h * w * cin * cout * 27
        for impl in ("xla", "d2"):
            with torch.no_grad():
                t = _timed(lambda a, impl=impl: sample(
                    _apply_conv(a[0], a[1], 1, 1, torch.bfloat16, impl)), (x, k))
            res[(name, impl)] = t
            print(f"d2 {name} {impl} bf16: {t*1e3:.2f} ms  {flops/t/1e12:.1f} TF/s", flush=True)
        del x, k
    return res


def _variants(dev, label, variants, h, w, frames, model_kw):
    """The bf16 V2ce3d forward in each (name, ModelConfig overrides), one
    set of seeded weights, the output channel-major (L, 20, H, W) as the
    driver takes it: a 'cl' variant pays the transpose, a 'cm' one
    returns it."""
    x = _frames(dev, 1, frames, h, w)
    res, state = {}, None
    for name, kw in variants:
        model = _model(dev, model_kw, state, compute_dtype=torch.bfloat16, **kw)
        state = model.state_dict()
        cm = kw.get("out_layout") == "cm"
        fwd = _forward(model, sample if cm else
                       lambda y: sample(y.permute(0, 1, 4, 2, 3).contiguous()))
        res[name] = dt = _timed(fwd, (x,))
        print(f"{label}[{name}]: {dt*1e3:.2f} ms/window ({frames/dt:.1f} fps)", flush=True)
        del model
    return res


def probe_model_d2(dev, h=H, w=W, frames=FRAMES, model_kw=None):
    """The bf16 model with conv_impl 'd2' and 'd2s' against the base."""
    return _variants(dev, "model_d2", [("base", {}), ("d2", dict(conv_impl="d2")),
                                       ("d2s", dict(conv_impl="d2s"))], h, w, frames, model_kw)


def probe_model_knockout(dev, h=H, w=W, frames=FRAMES, model_kw=None):
    """In-model cost of each conv group: the bf16 model with a group's
    3x3x3 block convs replaced by their centre tap, against the full
    model ('ko:head' picks none: the head conv stays 'xla', as in JAX)."""
    return {label: probe_model(dev, f"model[{label}]", torch.bfloat16, h=h, w=w,
                               frames=frames, model_kw=model_kw, conv_impl=label)["window_s"]
            for label in ("xla", "ko:all", "ko:head", "ko:strided", "ko:small", "ko:big")}


# parity of two bf16 formulations relative to the largest output: each
# rounds its sum to bf16 (cuDNN returns the input dtype), the split form
# its two halves apart, so they may part by up to two bf16 ulps (2^-6)
BOUNDARY_TOL = 2 ** -6


def probe_boundary(dev, h=H, w=W, frames=FRAMES):
    """The layers at the model's narrow edges, each formulation against its
    rewrite in bf16, and their parity (max |a - b|, then relative to the
    largest |a|, held within BOUNDARY_TOL): the 1x1 pred to channel-major
    voxels (cuDNN's 3D conv on the channels-last input, or the input
    transposed first and a 2D conv), the 3x3x3 head (channels-last, or
    the (B, L, C, H, W) layout, transposed back or left so), the strided
    enc0 conv (direct, or the phase fold of 'fold'), and dec3's conv1
    (over the concat, or split across it). The layouts are cuDNN's memory
    formats where the JAX probe's were XLA:TPU's."""
    from v2ce_toolbox_tpu_torch.models.layers import upsample_nearest_to
    from v2ce_toolbox_tpu_torch.ops.research import dispatch_conv

    bf = torch.bfloat16
    res = {}

    def run(group, fns, args, pair):
        for name, fn in fns:
            with torch.no_grad():
                res[name] = t = _timed(lambda a, fn=fn: sample(fn(a)), args)
            print(f"boundary {name}: {t*1e3:.2f} ms", flush=True)
        with torch.no_grad():
            a, b = (dict(fns)[n](args).float() for n in pair)
        err = float((a - b).abs().max())
        rel = err / max(float(a.abs().max()), 1e-30)
        res[f"{group} parity"] = rel
        print(f"  {group} parity: {err} (relative {rel:.2e}, limit {BOUNDARY_TOL:g})", flush=True)
        assert rel <= BOUNDARY_TOL, f"boundary {group}: {pair} differ by {rel:.2e}"

    # pred: (1, L, H, W, 32) -> channel-major (L, 2, 10, H, W)
    x32 = rand(dev, (1, frames, h, w, 32))
    kp = rand(dev, (20, 32, 1, 1, 1), 1, 0.1)

    def pred_cur(args):
        x, k = args
        y = torch.relu(F.conv3d(x.to(bf).permute(0, 4, 1, 2, 3), k.to(bf)).float())
        return y[0].transpose(0, 1).reshape(frames, 2, 10, h, w)

    def pred_cm(args):
        x, k = args
        xt = x[0].permute(0, 3, 1, 2).to(bf)
        y = torch.relu(F.conv2d(xt, k[:, :, 0].to(bf)).float())
        return y.reshape(frames, 2, 10, h, w)

    run("pred", [("pred_cur", pred_cur), ("pred_cm", pred_cm)], (x32, kp),
        ("pred_cur", "pred_cm"))

    # head: (1, L, H, W, 2) -> 32 channels, 3x3x3
    xin = rand(dev, (1, frames, h, w, 2), 2)
    kh = rand(dev, (32, 2, 3, 3, 3), 3, 0.1)

    def head_cur(args):
        x, k = args
        return F.conv3d(x.to(bf).permute(0, 4, 1, 2, 3), k.to(bf), padding=1).permute(0, 2, 3, 4, 1)

    def head_cm_stay(args):
        x, k = args
        xt = x.permute(0, 1, 4, 2, 3).contiguous().to(bf)     # (B, L, C, H, W)
        return F.conv3d(xt.transpose(1, 2), k.to(bf), padding=1).transpose(1, 2)

    def head_cm(args):
        return head_cm_stay(args).permute(0, 1, 3, 4, 2)

    run("head", [("head_cur", head_cur), ("head_cm", head_cm), ("head_cm_stay", head_cm_stay)],
        (xin, kh), ("head_cur", "head_cm"))

    # enc0: (1, L, H, W, 32) -> 64 channels, stride (1, 2, 2)
    ke = rand(dev, (64, 32, 3, 3, 3), 4, 0.1)

    def enc0(impl):
        def fn(args):
            x, k = args
            return dispatch_conv(x.permute(0, 4, 1, 2, 3), k, (1, 2, 2), 1, bf, impl)
        return fn

    run("enc0", [("enc0_cur", enc0("xla")), ("enc0_fold", enc0("fold"))], (x32, ke),
        ("enc0_cur", "enc0_fold"))
    del x32, xin

    # dec3 conv1: concat(up 64, skip 32) -> 32, against the two halves
    up = rand(dev, (1, 64, frames, -(-h // 2), -(-w // 2)), 5)
    skip = rand(dev, (1, 32, frames, h, w), 6)
    kc = rand(dev, (32, 96, 3, 3, 3), 7, 0.1)

    def dec3_cur(args):
        u, s, k = args
        x = torch.cat([upsample_nearest_to(u, (h, w)).to(bf), s.to(bf)], dim=1)
        return F.conv3d(x, k.to(bf), padding=1).float()

    def dec3_split(args):
        u, s, k = args
        k = k.to(bf)
        y = F.conv3d(upsample_nearest_to(u, (h, w)).to(bf), k[:, :64], padding=1).float()
        return y + F.conv3d(s.to(bf), k[:, 64:], padding=1).float()

    run("dec3", [("dec3_cur", dec3_cur), ("dec3_split", dec3_split)], (up, skip, kc),
        ("dec3_cur", "dec3_split"))
    return res


def probe_model_variants(dev, h=H, w=W, frames=FRAMES, model_kw=None):
    """In-model A/B of decoder_split, out_layout 'cm' and conv_impl 'fold'
    and their combinations, the bf16 model against the base."""
    variants = [
        ("base", {}),
        ("split", dict(decoder_split=True)),
        ("cm", dict(out_layout="cm")),
        ("fold", dict(conv_impl="fold")),
        ("split+cm", dict(decoder_split=True, out_layout="cm")),
        ("split+cm+fold", dict(decoder_split=True, out_layout="cm", conv_impl="fold")),
    ]
    return _variants(dev, "model_variant", variants, h, w, frames, model_kw)


def probe_subpixel_variants(dev, h=H, w=W, frames=FRAMES, model_kw=None):
    """In-model A/B of the sub-pixel decoder's forms (`ops/subpixel.py`)
    on all decoders and on the top-resolution ones, and of K10 on the last
    one or two, the bf16 model against the base."""
    sp = dict(subpixel_decoder=True)
    variants = [
        ("base", {}),
        ("sp-pfold", dict(sp, subpixel_impl="pfold")),
        ("sp-wfold", dict(sp, subpixel_impl="wfold")),
        ("sp-split", dict(sp, subpixel_impl="split")),
        ("sp-pfold-last1", dict(sp, subpixel_impl="pfold", subpixel_blocks=1)),
        ("sp-pfold-last2", dict(sp, subpixel_impl="pfold", subpixel_blocks=2)),
        ("sp-wfold-last2", dict(sp, subpixel_impl="wfold", subpixel_blocks=2)),
        ("sp-pallas-last2", dict(SUBPIXEL, subpixel_blocks=2)),
        ("sp-pallas-last1", dict(SUBPIXEL, subpixel_blocks=1)),
    ]
    return _variants(dev, "subpixel_variant", variants, h, w, frames, model_kw)


WINOGRAD_SHAPES = [
    ("dec3_conv1", (1, 16, 260, 346, 96), 32),
    ("dec2_conv1", (1, 16, 130, 173, 192), 64),
    ("dec3_conv2", (1, 16, 260, 346, 32), 32),
]


def probe_winograd(dev, shapes=WINOGRAD_SHAPES):
    """Winograd F(2x2,3x3) in plain torch (`ops/winograd.py`: the
    transforms as strided adds, the products by `torch.matmul`) against
    the direct conv (cuDNN) in bf16, on the small-Co layers; rates are
    the direct conv's multiply-adds over the time."""
    from v2ce_toolbox_tpu_torch.ops.winograd import conv3d_winograd

    res = {}
    for name, xshape, cout in shapes:
        cin = xshape[-1]
        x = rand(dev, xshape)
        k = rand(dev, (3, 3, 3, cin, cout), 1, 0.01)
        flops = 2 * int(np.prod(xshape[:4])) * cin * cout * 27
        for label, fn in [
                ("direct_bf16", lambda a: _conv(a[0].to(torch.bfloat16), a[1].to(torch.bfloat16))),
                ("wino_bf16", lambda a: conv3d_winograd(*a, compute_dtype=torch.bfloat16)),
                ("wino_f32", lambda a: conv3d_winograd(*a, compute_dtype=torch.float32))]:
            try:
                with torch.no_grad():
                    t = _timed(lambda a, fn=fn: sample(fn(a)), (x, k))
                res[(name, label)] = t
                print(f"{name} {label}: {t*1e3:.2f} ms  {flops/t/1e12:.1f} TF/s-equiv",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"{name} {label}", e)
        del x, k
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
    "model_subpixel": functools.partial(probe_model, label="model_subpixel",
                                        subpixel_decoder=True),
    "pallas_model": probe_pallas_model,
    "fused_dec": probe_fused_dec,
    "batch_scaling": probe_batch_scaling,
    "model_overhead": probe_model_overhead,
    "wpack": probe_wpack,
    "conv2d_decomp": probe_conv2d_decomp,
    "d2": probe_d2,
    "model_d2": probe_model_d2,
    "model_knockout": probe_model_knockout,
    "boundary": probe_boundary,
    "model_variants": probe_model_variants,
    "subpixel_variants": probe_subpixel_variants,
    "winograd": probe_winograd,
}
