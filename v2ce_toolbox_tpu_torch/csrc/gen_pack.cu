// K4: LDATI candidate generation without compaction.
//
// Replaces the Pallas kernel `_gen_kernel` reached through
// v2ce_toolbox_tpu/ops/gen_pallas.py:gen_pack (strategies 'slope' and
// 'none'). Input: voxels (B, P, 10, H, W) f32. Output: the full candidate
// grid as rows (B * 9, P * H * W) int32, row = (frame, bin), column = the
// within-bin voxel id v = (po, h, w) with P flipped (po = 0 reads input
// plane P-1):
//   keys = (rel_us << vox_bits) | v, INVALID where the voxel emits nothing;
//   kx   = bits(k) with the low 8 bits replaced by the clipped extra count
//          ('slope' only), written for every voxel;
// and per frame the emitted-candidate and over-mepv drop sums ('none':
// drop 0). The math is K1's (the device functions of common.cuh), so the
// two kernels produce the same bits; only K1 compacts.
//
// Bound on the H100: device-memory bytes. At the main-path chunk
// (24, 2, 10, 260, 346) it reads 172.7 MB of voxels and writes 2 x 155.4 MB
// of keys and kx: 483.6 MB, about 144 us at 3.35 TB/s.
// Design: one thread per (frame, pixel) runs the 9-step debt scan in
// registers from its 10 strided loads and writes its 9 keys and 9 kx words
// down the bin rows; neighbouring threads hold neighbouring pixels, so every
// load and store is coalesced. The per-frame sums reduce in the block
// (shuffles, then one shared-memory step) and land with one integer
// atomicAdd per block and sum: exact and the same in any order. The TPU
// kernel's row blocks and per-step SMEM accumulators are not carried over.

#include "common.cuh"

namespace {

using v2ce::kCB;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kSlope>
__global__ void __launch_bounds__(kThreads)
gen_pack_kernel(const float* __restrict__ vox, v2ce::BinConsts c, int P, int H, int W,
                int vox_bits, int ts_cap, int mepv, float tscale, float vs2,
                int* __restrict__ keys, int* __restrict__ kx, int* __restrict__ emit,
                int* __restrict__ drop) {
  __shared__ int red[2][kWarps];
  const int b = blockIdx.y;
  const long hw = (long)H * W;
  const int seg = (int)(P * hw);
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;

  int emit_sum = 0, drop_sum = 0;
  if (v < seg) {
    const int po = (int)(v / hw);
    const long rem = v - po * hw;
    const float* src = vox + ((long)b * P + (P - 1 - po)) * (kCB + 1) * hw + rem;
    v2ce::Pixel px;
    v2ce::relocate(src, hw, px);
#pragma unroll
    for (int ci = 0; ci < kCB; ++ci) {
      const int e = v2ce::emit_of(px.cnt[ci], mepv, kSlope);
      emit_sum += e;
      drop_sum += v2ce::drop_of(px.cnt[ci], mepv, kSlope);
      const long at = ((long)b * kCB + ci) * seg + v;
      keys[at] = e > 0 ? v2ce::key_of(px, ci, v, c, tscale, vox_bits, ts_cap)
                       : V2CE_INVALID;
      if (kSlope) kx[at] = v2ce::kx_of(px, ci, vs2, mepv);
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    emit_sum += __shfl_down_sync(0xffffffffu, emit_sum, d);
    drop_sum += __shfl_down_sync(0xffffffffu, drop_sum, d);
  }
  if (lane == 0) { red[0][warp] = emit_sum; red[1][warp] = drop_sum; }
  __syncthreads();
  if (threadIdx.x == 0) {
    int se = 0, sd = 0;
    for (int w = 0; w < kWarps; ++w) { se += red[0][w]; sd += red[1][w]; }
    if (se) atomicAdd(emit + b, se);
    if (sd) atomicAdd(drop + b, sd);
  }
}

}  // namespace

// slope != 0: strategy 'slope' (kx written); 0: strategy 'none' (kx may be
// null). emit and drop are zeroed here before the sums land.
extern "C" int v2ce_gen_pack(const float* vox, const float* bs_f, const int* bs_us,
                             int* keys, int* kx, int* emit, int* drop,
                             int B, int P, int H, int W, int vox_bits, int ts_cap,
                             int mepv, int slope, float tscale, float vs2,
                             cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  v2ce::BinConsts c;
  for (int i = 0; i < kCB; ++i) { c.bs_f[i] = bs_f[i]; c.bs_us[i] = bs_us[i]; }
  cudaMemsetAsync(emit, 0, sizeof(int) * B, stream);
  cudaMemsetAsync(drop, 0, sizeof(int) * B, stream);
  const int seg = P * H * W;
  dim3 grid((seg + kThreads - 1) / kThreads, B);
  if (slope) {
    gen_pack_kernel<true><<<grid, kThreads, 0, stream>>>(
        vox, c, P, H, W, vox_bits, ts_cap, mepv, tscale, vs2, keys, kx, emit, drop);
  } else {
    gen_pack_kernel<false><<<grid, kThreads, 0, stream>>>(
        vox, c, P, H, W, vox_bits, ts_cap, mepv, tscale, vs2, keys, nullptr, emit, drop);
  }
  return (int)cudaGetLastError();
}
