// K11: the VALID convolution of a pre-padded channels-last input over any
// tap box, f32 accumulation: the core of conv3d_quad (3x3x3 stride-1
// 'same', the input padded by one) and conv3d_quad_s122 (3x3x3 stride
// (1,2,2), H/W phases folded into 4C channels: a (3,2,2) VALID conv).
//
// Replaces the Pallas kernel of `v2ce_toolbox_tpu/ops/conv3d_quad.py:156
// _quad_core` (its `_kernel` at :121, `pallas_call` at :198), reached by
// `conv3d_quad:239` and `conv3d_quad_s122:255`. Python wrapper, the pad,
// the phase fold and the plain twin: `ops/conv3d_quad.py`.
//
//   out[b, l, h, w, co] = sum_{dl<kl, dh<kh, dw<kw, c} x[b, l+dl, h+dh, w+dw, c]
//                                                     * k[dl, dh, dw, c, co]
//
// for (l, h, w) < (Lp-kl+1, Hp-kh+1, Wp-kw+1).
//
// Bound on an H100 SXM at the probe's full-width layers (16-frame window
// of the stage-1 model, 260x346 down to 17x22, 32 to 768 channels; 80-247
// GFLOP a stride-1 layer, 40-42 a strided one, counted as the direct
// conv): by operations in both types, at 989 TFLOP/s in bf16 and 67
// TFLOP/s on the CUDA cores in f32 (nothing rounds to TF32). The folded
// strided conv does 12 taps x 4C = 1.78x the direct conv's multiply-adds:
// its zero taps (the phase that reaches index 3) are multiplied as well.
//
// Design: the implicit GEMM of csrc/conv_igemm.cuh (output positions x Co,
// reduced over kl*kh*kw taps x C), with the output box smaller than the
// input box. The TPU kernel packs ws adjacent W positions into its matrix
// unit's 128-lane N dimension (`pack_weights_quad`: useful MACs
// kw/(2*ws)) and picks VMEM tiles; neither exists for the card's mma
// tiles, whose N is 64 wide for every Co, so this kernel does only the
// conv's own multiply-adds, and the JAX wrapper's `ws`/`tiles` arguments
// have no counterpart. bf16 runs mma.sync m16n8k16 with each 32-channel
// step summed from zero and added in IEEE f32; f32 runs CUDA-core FMAs.
// Left for a later PR: what K9's note lists (wgmma and TMA rings, a halo
// shared across taps).
#include "conv_igemm.cuh"

extern "C" int v2ce_conv3d_quad(const void* x, const void* kt, void* out, int B, int Lp,
                                int Hp, int Wp, int C, int Co, int kl, int kh, int kw,
                                int dtype_in, int dtype_out, void* stream) {
  if (kl < 1 || kh < 1 || kw < 1 || kl * kh * kw > v2ce_conv::MAX_TAPS || kl > Lp ||
      kh > Hp || kw > Wp)
    return (int)cudaErrorInvalidValue;
  v2ce_conv::Taps taps;
  taps.n = kl * kh * kw;
  taps.per_plane = 0;
  for (int dl = 0; dl < kl; ++dl)
    for (int dh = 0; dh < kh; ++dh)
      for (int dw = 0; dw < kw; ++dw) {
        const int t = (dl * kh + dh) * kw + dw;
        taps.d[0][t][0] = (signed char)dl;
        taps.d[0][t][1] = (signed char)dh;
        taps.d[0][t][2] = (signed char)dw;
      }
  return v2ce_conv::launch_conv_taps(x, kt, out, B, Lp, Hp, Wp, Lp - kl + 1, Hp - kh + 1,
                                     Wp - kw + 1, C, Co, 1, 0, taps, dtype_in, dtype_out,
                                     static_cast<cudaStream_t>(stream));
}
