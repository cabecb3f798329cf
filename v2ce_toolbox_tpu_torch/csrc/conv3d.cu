// K9: 3x3x3 stride-1 'same' convolution, channels-last, f32 accumulation.
//
// Replaces the Pallas kernel `v2ce_toolbox_tpu/ops/conv3d_pallas.py:106
// conv3d_3x3x3` (its `_kernel` at :81, `pallas_call` at :138). Python
// wrapper and plain twin: `ops/conv3d.py`.
//
//   out[b, l, h, w, co] = sum_{dl,dh,dw,c} x[b, l+dl-1, h+dh-1, w+dw-1, c]
//                                          * k[dl, dh, dw, c, co]
//
// Bound on an H100 SXM at the stage-1 model's full-width shapes (16-frame
// window, 260x346 input; its 14 calls per window do 1.474 TFLOP, 80-247
// GFLOP each): by operations. In bf16 (f32 out) the window's bound is
// 1.49 ms at 989 TFLOP/s; the one call near the memory roof is the
// 32 -> 32 conv at 260x346, 276 MB in 79.6 GFLOP (0.0825 ms of bytes at
// 3.35 TB/s against 0.0805 ms of operations). In f32 every call is bound
// by the 67 TFLOP/s CUDA-core rate, 22.0 ms a window, since the f32 path
// must not round to TF32.
//
// Design: the implicit GEMM of csrc/conv_igemm.cuh (output positions x Co,
// reduced over 27 taps x C). Blocks are independent: the TPU kernel's
// sequential L tiling (to fill its matrix unit) and its VMEM tile
// refusals are gone. bf16 runs the Hopper path: each tap's A tile is a TMA
// box of the input shifted by (dl-1, dh-1, dw-1), its border zero-filled
// by TMA, fed through a shared-memory ring to wgmma; BN is 32 for the
// Co = 32 layer (no idle half tile), 64 or 128 above. f32 runs CUDA-core
// FMAs. What bounds it now: the 27 shifted boxes of a tile are read again
// from L2 (a halo shared across taps would read each input row once), and
// the narrow layers (Co = 32: 2 bytes of A per multiply-add column) ask
// more of L2 and shared memory than of the tensor cores.
#include "conv_igemm.cuh"

extern "C" int v2ce_conv3d(const void* x, const void* kt, void* out, unsigned char* live,
                           long long live_bytes, int B, int L, int H, int W, int C, int Co,
                           int bn, int bk, int dtype_in, int dtype_out, void* stream) {
  v2ce_conv::Taps taps;
  taps.n = 27;
  taps.per_plane = 0;
  for (int dl = 0; dl < 3; ++dl)
    for (int dh = 0; dh < 3; ++dh)
      for (int dw = 0; dw < 3; ++dw) {
        const int t = (dl * 3 + dh) * 3 + dw;
        taps.d[0][t][0] = (signed char)(dl - 1);
        taps.d[0][t][1] = (signed char)(dh - 1);
        taps.d[0][t][2] = (signed char)(dw - 1);
        taps.d[1][t][0] = taps.d[1][t][1] = taps.d[1][t][2] = 0;
      }
  return v2ce_conv::launch_conv_taps(x, kt, out, live, live_bytes, B, L, H, W, L, H, W, C, Co,
                                     1, 0, taps, bn, bk, dtype_in, dtype_out,
                                     static_cast<cudaStream_t>(stream));
}
