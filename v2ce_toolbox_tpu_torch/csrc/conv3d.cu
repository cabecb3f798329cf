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
// refusals are gone; every block gathers its own halo from global memory
// through L2. bf16 runs mma.sync m16n8k16; f32 runs CUDA-core FMAs.
// Left for a later PR: wgmma with TMA-fed multi-stage shared-memory rings,
// reuse of the input halo across the 27 taps inside a block (today each
// tap re-reads its shifted rows, from L2), and a narrower N tile for the
// Co = 32 layer, which leaves half of each 64-wide tile idle.
#include "conv_igemm.cuh"

extern "C" int v2ce_conv3d(const void* x, const void* kt, void* out, int B, int L, int H,
                           int W, int C, int Co, int dtype_in, int dtype_out, void* stream) {
  v2ce_conv::Taps taps;
  taps.n = 27;
  for (int dl = 0; dl < 3; ++dl)
    for (int dh = 0; dh < 3; ++dh)
      for (int dw = 0; dw < 3; ++dw) {
        const int t = (dl * 3 + dh) * 3 + dw;
        taps.d[0][t][0] = (signed char)(dl - 1);
        taps.d[0][t][1] = (signed char)(dh - 1);
        taps.d[0][t][2] = (signed char)(dw - 1);
        taps.d[1][t][0] = taps.d[1][t][1] = taps.d[1][t][2] = 0;
      }
  return v2ce_conv::launch_conv_taps(x, kt, out, B * L, L, H, W, C, Co, 1, taps, dtype_in,
                                     dtype_out, static_cast<cudaStream_t>(stream));
}
