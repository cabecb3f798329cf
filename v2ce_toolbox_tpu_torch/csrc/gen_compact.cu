// K1: LDATI candidate generation fused with the chain compaction.
//
// Replaces the Pallas kernel `_gen_compact_kernel` reached through
// v2ce_toolbox_tpu/ops/gen_pallas.py:gen_compact (strategy 'slope').
// Input: voxels (B, P, 10, H, W) f32. For each output pixel v = (po, h, w)
// of a frame (po = 0 reads input plane P-1: the polarity flip), it runs the
// 9-step debt-carrying relocation over the 10 bins, the 3-tap slope k and
// the candidate packing of v2ce_toolbox_tpu/ops/ldati.py:_sample_events_v3,
// then compacts each (frame, bin) row:
//   key = (rel_us << vox_bits) | v, INVALID where the voxel emits nothing;
//   kx  = bits(k) with the low 8 bits replaced by the clipped extra count.
// Rows keep the first capp candidates in ascending v (the canonical order
// of compact_rows(gen_pack(...)); the TPU kernel's (polarity, w-block, h,
// w % 128) order is a tiling artifact). Per row kept = min(total, capp) and
// total; per frame the emitted-candidate and over-mepv drop sums.
//
// Float contract: every expression is the f32 op sequence XLA compiles for
// the JAX kernel, written with round-to-nearest intrinsics (no implicit
// contraction, no fast math; the library is also built with -fmad=false).
// The one fused multiply-add is explicit: XLA folds the chain timestamp's
// `tend / fps / cb` into a multiply by f32(1/fps) * f32(1/cb) (`tscale`)
// and contracts `* tscale + bin_start` into an FMA. The per-bin constants
// come from the wrapper, computed in numpy f32 like gen_pallas.py does.
//
// Bound on the H100: device-memory bytes. The voxel grid (24 x 2 x 10 x 260
// x 346 f32 = 173 MB on the main path) dominates; the compacted rows are
// 216 x 16384 ints.
// Design: count pass -> scan -> write pass -> tail fill. Both passes
// recompute the relocation from the 10 loads of a pixel (one thread per
// pixel, coalesced along w), so no count/tendency/slope grid ever reaches
// device memory; the second read of the voxels costs one more 173 MB
// stream. The count pass stores per (frame, bin, tile of 256 pixels) counts,
// one block per row scans them in tile order, and the write pass ranks each
// candidate inside its tile with warp ballots: positions are exact and
// deterministic, with no atomics. Sums are integer and exact in any order.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // pixels per tile
constexpr int kWarps = kThreads / 32;
constexpr int kCB = 9;               // output bins (10 input bins)
constexpr int kScanThreads = 1024;

struct Pixel {
  int cnt[kCB];
  float tend[kCB];
};

__device__ __forceinline__ void relocate(const float* __restrict__ src, long plane, Pixel& px) {
  float debt = 0.0f;
#pragma unroll
  for (int ci = 0; ci < kCB; ++ci) {
    const float avail = __fsub_rn(src[ci * plane], debt);
    const float cf = ceilf(__fsub_rn(avail, 1e-6f));
    debt = __fsub_rn(cf, avail);
    px.cnt[ci] = __float2int_rz(cf);
    px.tend[ci] = debt;
  }
  // fold the final input bin into the last output bin, truncating
  px.cnt[kCB - 1] += __float2int_rz(__fsub_rn(src[kCB * plane], debt));
}

__device__ __forceinline__ int emit_of(int cnt, int mepv) {
  const int e = cnt == 1 ? 1 : min(cnt, mepv);
  return max(e, 0);
}

struct Consts {
  float bs_f[kCB];
  int bs_us[kCB];
};

__device__ __forceinline__ int key_of(const Pixel& px, int ci, int v, const Consts& c,
                                      float tscale, int vox_bits, int ts_cap) {
  const int cnt = px.cnt[ci];
  const float ts = __fmul_rn(__fmaf_rn(px.tend[ci], tscale, c.bs_f[ci]), 1e6f);
  int rel = __float2int_rz(ts) - c.bs_us[ci];
  rel = min(max(rel, 0), ts_cap);
  if (cnt != 1) rel = 0;  // non-chain slots are drawn after compaction
  return (rel << vox_bits) | v;
}

__device__ __forceinline__ int kx_of(const Pixel& px, int ci, float vs2, int mepv) {
  float k = 0.0f;
  if (ci != 0 && ci != kCB - 1) {
    const float k_raw = __fmul_rn(__fsub_rn(__int2float_rn(px.cnt[ci + 1]),
                                            __int2float_rn(px.cnt[ci - 1])), 0.5f);
    k = __fdiv_rn(__fdiv_rn(k_raw, vs2), __fadd_rn(__int2float_rn(px.cnt[ci]), 1e-8f));
  }
  int extra = min(max(px.cnt[ci] - 1, 0), mepv - 1);
  extra = min(extra, 255);
  return (__float_as_int(k) & ~0xFF) | extra;
}

template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
gen_pass_kernel(const float* __restrict__ vox, Consts c, int P, int H, int W,
                int vox_bits, int ts_cap, int mepv, int capp,
                float tscale, float vs2,
                int* __restrict__ tile_counts, int* __restrict__ tile_emit,
                int* __restrict__ tile_drop, const int* __restrict__ tile_off,
                int* __restrict__ keys, int* __restrict__ kx) {
  __shared__ int wsum[kCB][kWarps];
  __shared__ int red[2][kWarps];
  const int n_tiles = gridDim.x;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const long hw = (long)H * W;
  const int seg = (int)(P * hw);
  const int v = tile * kThreads + threadIdx.x;
  const bool in = v < seg;
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;

  Pixel px;
  if (in) {
    const int po = (int)(v / hw);
    const long rem = v - po * hw;
    const float* src = vox + ((long)b * P + (P - 1 - po)) * (kCB + 1) * hw + rem;
    relocate(src, hw, px);
  } else {
#pragma unroll
    for (int ci = 0; ci < kCB; ++ci) { px.cnt[ci] = 0; px.tend[ci] = 0.0f; }
  }

  unsigned ballots[kCB];
  int emit_sum = 0, drop_sum = 0;
#pragma unroll
  for (int ci = 0; ci < kCB; ++ci) {
    const int e = emit_of(px.cnt[ci], mepv);
    emit_sum += e;
    drop_sum += px.cnt[ci] > mepv ? px.cnt[ci] - mepv : 0;
    ballots[ci] = __ballot_sync(0xffffffffu, in && e > 0);
    if (lane == 0) wsum[ci][warp] = __popc(ballots[ci]);
  }

  if (!kWrite) {
    for (int d = 16; d > 0; d >>= 1) {
      emit_sum += __shfl_down_sync(0xffffffffu, emit_sum, d);
      drop_sum += __shfl_down_sync(0xffffffffu, drop_sum, d);
    }
    if (lane == 0) { red[0][warp] = emit_sum; red[1][warp] = drop_sum; }
    __syncthreads();
    if (threadIdx.x < kCB) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += wsum[threadIdx.x][w];
      tile_counts[((long)b * kCB + threadIdx.x) * n_tiles + tile] = s;
    }
    if (threadIdx.x == 0) {
      int se = 0, sd = 0;
      for (int w = 0; w < kWarps; ++w) { se += red[0][w]; sd += red[1][w]; }
      tile_emit[(long)b * n_tiles + tile] = se;
      tile_drop[(long)b * n_tiles + tile] = sd;
    }
    return;
  }

  __syncthreads();
#pragma unroll
  for (int ci = 0; ci < kCB; ++ci) {
    if (!(in && ((ballots[ci] >> lane) & 1u))) continue;
    int pos = tile_off[((long)b * kCB + ci) * n_tiles + tile];
    for (unsigned w = 0; w < warp; ++w) pos += wsum[ci][w];
    pos += __popc(ballots[ci] & ((1u << lane) - 1u));
    if (pos < capp) {
      const long at = ((long)b * kCB + ci) * capp + pos;
      keys[at] = key_of(px, ci, v, c, tscale, vox_bits, ts_cap);
      kx[at] = kx_of(px, ci, vs2, mepv);
    }
  }
}

// One block per (frame, bin) row: exclusive scan of its tile counts in tile
// order; the rows of bin 0 also reduce their frame's emit/drop tile sums.
__global__ void __launch_bounds__(kScanThreads)
gen_scan_kernel(const int* __restrict__ tile_counts, int* __restrict__ tile_off,
                const int* __restrict__ tile_emit, const int* __restrict__ tile_drop,
                int* __restrict__ kept, int* __restrict__ total,
                int* __restrict__ emit, int* __restrict__ drop, int n_tiles, int capp) {
  __shared__ int scratch[32];
  const long row = blockIdx.x;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int c = i < n_tiles ? tile_counts[row * n_tiles + i] : 0;
    int chunk_total;
    const int ex = v2ce::block_exclusive_sum(c, scratch, &chunk_total);
    if (i < n_tiles) tile_off[row * n_tiles + i] = carry + ex;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) {
    kept[row] = carry < capp ? carry : capp;
    total[row] = carry;
  }
  if (row % kCB == 0) {
    const long b = row / kCB;
    int e = 0, d = 0;
    for (int i = threadIdx.x; i < n_tiles; i += kScanThreads) {
      e += tile_emit[b * n_tiles + i];
      d += tile_drop[b * n_tiles + i];
    }
    e = v2ce::block_sum(e, scratch);
    d = v2ce::block_sum(d, scratch);
    if (threadIdx.x == 0) { emit[b] = e; drop[b] = d; }
  }
}

}  // namespace

extern "C" int v2ce_gen_compact(const float* vox, const float* bs_f, const int* bs_us,
                                int* keys, int* kx, int* kept, int* total,
                                int* emit, int* drop, int* tile_counts, int* tile_off,
                                int* tile_emit, int* tile_drop,
                                int B, int P, int H, int W, int vox_bits, int ts_cap,
                                int mepv, int capp, float tscale, float vs2,
                                cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Consts c;
  // the per-bin constants arrive as host arrays (ctypes pointers)
  for (int i = 0; i < kCB; ++i) { c.bs_f[i] = bs_f[i]; c.bs_us[i] = bs_us[i]; }
  const int seg = P * H * W;
  const int n_tiles = (seg + kThreads - 1) / kThreads;
  dim3 grid(n_tiles, B);
  gen_pass_kernel<false><<<grid, kThreads, 0, stream>>>(
      vox, c, P, H, W, vox_bits, ts_cap, mepv, capp, tscale, vs2,
      tile_counts, tile_emit, tile_drop, nullptr, nullptr, nullptr);
  gen_scan_kernel<<<B * kCB, kScanThreads, 0, stream>>>(
      tile_counts, tile_off, tile_emit, tile_drop, kept, total, emit, drop, n_tiles, capp);
  gen_pass_kernel<true><<<grid, kThreads, 0, stream>>>(
      vox, c, P, H, W, vox_bits, ts_cap, mepv, capp, tscale, vs2,
      nullptr, nullptr, nullptr, tile_off, keys, kx);
  dim3 tail((capp + kThreads - 1) / kThreads, B * kCB);
  v2ce_fill_tail_kernel<<<tail, kThreads, 0, stream>>>(keys, kx, kept, capp);
  return (int)cudaGetLastError();
}
