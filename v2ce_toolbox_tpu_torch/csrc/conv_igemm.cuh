// Implicit-GEMM convolution over a table of taps, channels-last, shared by
// K9 (csrc/conv3d.cu: 27 taps, one output plane), K10
// (csrc/decoder_conv.cu: 18 taps per output H-parity, two planes), K11
// (csrc/conv3d_quad.cu: a VALID conv over any tap box, the output box
// smaller than the input's) and K12's f32 batched product
// (csrc/wino4.cu: one tap, 36 planes, each with its own input matrix; its
// bf16 route has a fused kernel of its own on the same building blocks).
// The kernels live in csrc/conv_igemm.cu, compiled once for all entries;
// the Hopper building blocks (mbarriers, TMA, wgmma, the live-step
// pre-pass, the tensor-map encoder) in csrc/hopper.cuh.
//
//   out[b, l, h, p, w, n] = sum_t sum_c xp[b, l + dl_t, h + dh_pt, w + dw_t, c]
//                                         * wt[p, t, n, c]
//
// where xp = x + p * x_plane_stride is an input box (B, Li, Hi, Wi, C),
// zero outside it, and (l, h, w) run over the output box (Lo, Ho, Wo).
// Rows of the GEMM are the output positions (b, l, h, w) of one plane p,
// columns the output channels n, and the reduction runs over (tap,
// channel). The output is (B*Lo, Ho, planes, Wo, Co): planes = 1 is plain
// (B, Lo, Ho, Wo, Co). A tap table row per plane (K10's parities) or one
// row for every plane. Channel counts are multiples of 8 (the wrappers
// pad), so every row is a whole number of 16-byte vectors.
//
// bf16 inputs (the Hopper path). A block computes a 128 x BN tile of one
// plane with three warpgroups: one producer thread issues TMA loads into a
// ring of shared-memory stages behind mbarriers, and two consumer
// warpgroups (64 rows each) run wgmma.mma_async m64nBNk16 on them, with
// f32 accumulators in registers (setmaxnreg gives the consumers 232 of
// them, the producer 40).
//   * A step is one tap and one BK-channel slice. Its A tile is a TMA box
//     of the input shifted by the tap: the block's rows are a box of
//     (BW, BH, BL) output positions of one (b, plane), BW*BH*BL = 128,
//     chosen per call from the powers of two to waste the fewest rows on
//     ragged edges, and the tap's (dw, dh, dl) is added to the box's
//     signed coordinates. TMA's out-of-bounds zero fill is the conv border
//     ('same' padding: coordinates -1 and Wi) and the ragged edge. The
//     weight tile is a box (BK, BN) of wt[p, t] (n beyond Co zero-filled).
//     Both land in the 128- (BK = 64) or 64-byte (BK = 32) swizzled
//     K-major layout that wgmma reads. Tensor maps are encoded on the host
//     per call (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so
//     the library needs no -lcuda) and passed as __grid_constant__.
//   * BN per call: 32 for Co <= 32, 64 for Co <= 64, 128 above (K10 takes
//     64); BK = 64 where C is a multiple of 64, else 32 (K10 takes 32).
//     The caller picks them (ops/conv3d.gemm_tiles) and passes them in.
//   * Rounding: each step's BK products are summed from zero in the tensor
//     cores (scale-d = 0 on the step's first wgmma) and the step sums added
//     to the running sum in IEEE f32 in registers, so the rounding error
//     grows with the number of steps, not of products. Two sets of step
//     accumulators take two steps a round, issued back to back, and are
//     added in step order after wait_group 0: ptxas serialises every wgmma
//     (C7514) if a sum is read while a later group is in flight, so the
//     adds of step s cannot overlap step s+1's wgmma; two steps a round
//     leave the tensor cores one gap per two steps instead of one a step.
//   * Live steps: a pre-pass over the weight operand marks, per (plane, N
//     tile, tap, K step), whether any weight of the step's BN x BK block
//     is nonzero (a sign bit alone is zero), into a byte table the wrapper
//     allocates; the producer and the consumers walk only the live steps.
//     A step whose weights are all +-0 adds products that are all +-0, and
//     skipping it leaves every finite running sum unchanged (up to the sign
//     of a zero sum). The skip applies to every entry and to any weights
//     (K9, K10, K11), not only to the folds' structural zeros:
//     wherever a whole BN x BK block is zero, an inf or NaN input that the
//     step would have multiplied by 0 (0 * inf = NaN) is dropped, and the
//     output stays finite where an IEEE conv (the twins, the JAX kernels)
//     gives NaN. For the folds (K10, K11-s122) that is the direct conv's
//     answer, since their zero blocks never meet the input there.
//   * The epilogue stores each consumer's fragments straight to the output
//     (float2 or bf16x2 a thread), masked to the output box and Co.
//   * The boxes the rule picks for a 16-frame window: 260x346 (32, 4, 1)
//     pads the rows by 1.7%, 130x173 (16, 4, 2) by 3.3%, 65x87 (8, 2, 8)
//     by 2.7%, 33x44 (4, 2, 16) by 3.0%, 17x22 (8, 1, 16) by 9.1%.
// What bounds it on an H100: the L2-to-shared-memory traffic, not the
// tensor cores. A step loads (128 + BN) x BK x 2 bytes for 128 x BN x BK
// multiply-adds, and each of the taps loads its own shifted A box: at the
// 260x346 32 -> 32 conv that is 2.49 GB of A boxes in 0.90 ms, and the
// narrow (Co = 32) layers run at 58-98 TFLOP/s where the wide ones reach
// 255-371 (chip_smoke.py on an H100 80GB HBM3 at 700 W). Not done: a halo
// shared across taps (the lever for that traffic), clusters multicasting
// the weight tile, and a persistent grid (tried: no gain outside one-step
// products).
//
// f32 inputs (CUDA cores; nothing may round to TF32): a 128 x 64 tile per
// block of 256 threads, each 32-channel step gathered into shared memory
// through registers with per-element border predicates, one buffer; each
// step's products summed from zero with FMAs and the step sums added in
// IEEE f32, as above (one running sum over K11's 27 x 512 products of
// positive inputs missed its twin by 1.06e-5 of the largest output).
#pragma once

#include <cuda_runtime.h>

namespace v2ce_conv {

constexpr int MAX_TAPS = 27;

struct Taps {
  int n;                            // taps per plane
  int per_plane;                    // 1: plane p reads row p of d; 0: all read row 0
  signed char d[2][MAX_TAPS][3];    // per plane and tap: (dl, dh, dw)
};

// Launch on the (dtype_in, dtype_out) pair: 0 = float32, 1 = bfloat16.
// bf16 inputs take the tile (bn, bk) and a live-step table `live` of at
// least planes * ceil(Co/bn) * taps.n * ceil(C/bk) bytes (live_bytes);
// f32 inputs ignore the three. Returns a cudaError_t: cudaErrorInvalidValue
// for a shape, alignment or tile the kernels do not take.
int launch_conv_taps(const void* x, const void* wt, void* out, unsigned char* live,
                     long long live_bytes, int B, int Li, int Hi, int Wi, int Lo, int Ho,
                     int Wo, int C, int Co, int planes, long long x_plane_stride,
                     const Taps& taps, int bn, int bk, int dtype_in, int dtype_out,
                     cudaStream_t stream);

}  // namespace v2ce_conv
