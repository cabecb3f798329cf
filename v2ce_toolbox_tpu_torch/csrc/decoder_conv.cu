// K10: the fused decoder conv on the coarse grid — nearest-up2 + concat +
// 3x3x3 conv (+ the 1x1x1 residual projection) without the upsampled or
// concatenated tensor.
//
// Replaces the Pallas kernel of `v2ce_toolbox_tpu/ops/decoder_pallas.py:276
// fused_up_concat_conv`: `_fused_conv_even` (:211), its `_kernel` (:177)
// and `pallas_call` (:236). The weight fold, the skip fold, the concat and
// the odd-size corrections stay plain torch in `ops/decoder.py`, as they
// are plain XLA in the JAX package.
//
// On the folded input x (B, L, hc, wc, K = Cu + 4 Cs) and the folded
// weights kf (2, 3, 2, 3, K, N), per output H-parity p:
//
//   out[b, l, i, p, j, n] = sum_{dl, a, db, k} x[b, l+dl-1, i+p+a-1, j+db-1, k]
//                                              * kf[p, dl, a, db, k, n]
//
// 18 taps per parity (36 in all), both output W-parities (and the
// projection when 4 Co <= 128) in N. The output (B, L, hc, 2, wc, N) has
// the fine grid (B, L, 2hc, 2wc, ...) as a free view.
//
// Bound on an H100 SXM at the stage-1 model's full-width shapes (decoder_2:
// coarse 65x87, Cu 128, Cs 64, Co 64; decoder_3: coarse 130x173, Cu 64,
// Cs 32, Co 32 with the projection), counted as the direct conv (+ the
// projection) it replaces, 239 and 248 GFLOP: by operations, 0.24 and
// 0.25 ms at 989 TFLOP/s in bf16 (against 0.035 and 0.096 ms of bytes),
// 3.6 and 3.7 ms at 67 TFLOP/s in f32. The kernel itself does 36 taps x K
// x N per coarse position, 1.34x the direct conv's multiply-adds for
// decoder_2 and 2.57x for decoder_3: the zero blocks of the folded
// weights are multiplied all the same.
//
// Design: the implicit GEMM of csrc/conv_igemm.cuh with a tap table of
// (dl-1, p+a-1, db-1) per parity; grid z is the parity. The TPU kernel's
// persistent VMEM copy of the folded weights and its slab tiling are gone:
// each block streams its weight rows from L2. Left for a later PR: wgmma,
// a shared halo across taps, and skipping the zero blocks of the folded
// weights.
#include "conv_igemm.cuh"

extern "C" int v2ce_decoder_conv(const void* x, const void* kt, void* out, int B, int L,
                                 int hc, int wc, int K, int N, int dtype_in, int dtype_out,
                                 void* stream) {
  v2ce_conv::Taps taps;
  taps.n = 18;
  taps.per_plane = 1;
  for (int p = 0; p < 2; ++p)
    for (int dl = 0; dl < 3; ++dl)
      for (int a = 0; a < 2; ++a)
        for (int db = 0; db < 3; ++db) {
          const int t = (dl * 2 + a) * 3 + db;
          taps.d[p][t][0] = (signed char)(dl - 1);
          taps.d[p][t][1] = (signed char)(p + a - 1);
          taps.d[p][t][2] = (signed char)(db - 1);
        }
  return v2ce_conv::launch_conv_taps(x, kt, out, B, L, hc, wc, L, hc, wc, K, N, 2, 0, taps,
                                     dtype_in, dtype_out, static_cast<cudaStream_t>(stream));
}
