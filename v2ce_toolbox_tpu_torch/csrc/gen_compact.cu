// K1: LDATI candidate generation fused with the chain compaction.
//
// Replaces the Pallas kernel `_gen_compact_kernel` reached through
// v2ce_toolbox_tpu/ops/gen_pallas.py:gen_compact (strategies 'slope' and
// 'none'). Input: voxels (B, P, 10, H, W) f32. For each output pixel
// v = (po, h, w) of a frame (po = 0 reads input plane P-1: the polarity
// flip), it runs the 9-step debt-carrying relocation over the 10 bins, the
// 3-tap slope k and the candidate packing of
// v2ce_toolbox_tpu/ops/ldati.py:_sample_events_v3 (the device functions of
// common.cuh, shared with K4), then compacts each (frame, bin) row:
//   key = (rel_us << vox_bits) | v, INVALID where the voxel emits nothing;
//   kx  = bits(k) with the low 8 bits replaced by the clipped extra count
//         ('slope' only; 'none' emits the chain events and has no payload).
// Rows keep the first capp candidates in ascending v (the canonical order
// of compact_rows(gen_pack(...)); the TPU kernel's (polarity, w-block, h,
// w % 128) order is a tiling artifact). Per row kept = min(total, capp) and
// total; per frame the emitted-candidate and over-mepv drop sums ('none':
// drop 0).
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

using v2ce::kCB;

constexpr int kThreads = 256;        // pixels per tile
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

template <bool kWrite, bool kSlope>
__global__ void __launch_bounds__(kThreads)
gen_pass_kernel(const float* __restrict__ vox, v2ce::BinConsts c, int P, int H, int W,
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

  v2ce::Pixel px;
  if (in) {
    const int po = (int)(v / hw);
    const long rem = v - po * hw;
    const float* src = vox + ((long)b * P + (P - 1 - po)) * (kCB + 1) * hw + rem;
    v2ce::relocate(src, hw, px);
  } else {
#pragma unroll
    for (int ci = 0; ci < kCB; ++ci) { px.cnt[ci] = 0; px.tend[ci] = 0.0f; }
  }

  unsigned ballots[kCB];
  int emit_sum = 0, drop_sum = 0;
#pragma unroll
  for (int ci = 0; ci < kCB; ++ci) {
    const int e = v2ce::emit_of(px.cnt[ci], mepv, kSlope);
    emit_sum += e;
    drop_sum += v2ce::drop_of(px.cnt[ci], mepv, kSlope);
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
      keys[at] = v2ce::key_of(px, ci, v, c, tscale, vox_bits, ts_cap);
      if (kSlope) kx[at] = v2ce::kx_of(px, ci, vs2, mepv);
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

template <bool kSlope>
void launch(const float* vox, const v2ce::BinConsts& c, int* keys, int* kx, int* kept,
            int* total, int* emit, int* drop, int* tile_counts, int* tile_off,
            int* tile_emit, int* tile_drop, int B, int P, int H, int W, int vox_bits,
            int ts_cap, int mepv, int capp, float tscale, float vs2, cudaStream_t stream) {
  const int seg = P * H * W;
  const int n_tiles = (seg + kThreads - 1) / kThreads;
  dim3 grid(n_tiles, B);
  gen_pass_kernel<false, kSlope><<<grid, kThreads, 0, stream>>>(
      vox, c, P, H, W, vox_bits, ts_cap, mepv, capp, tscale, vs2,
      tile_counts, tile_emit, tile_drop, nullptr, nullptr, nullptr);
  gen_scan_kernel<<<B * kCB, kScanThreads, 0, stream>>>(
      tile_counts, tile_off, tile_emit, tile_drop, kept, total, emit, drop, n_tiles, capp);
  gen_pass_kernel<true, kSlope><<<grid, kThreads, 0, stream>>>(
      vox, c, P, H, W, vox_bits, ts_cap, mepv, capp, tscale, vs2,
      nullptr, nullptr, nullptr, tile_off, keys, kx);
  dim3 tail((capp + kThreads - 1) / kThreads, B * kCB);
  v2ce_fill_tail_kernel<<<tail, kThreads, 0, stream>>>(keys, kx, kept, capp);
}

}  // namespace

// slope != 0: strategy 'slope' (kx written); 0: strategy 'none' (kx may be
// null).
extern "C" int v2ce_gen_compact(const float* vox, const float* bs_f, const int* bs_us,
                                int* keys, int* kx, int* kept, int* total,
                                int* emit, int* drop, int* tile_counts, int* tile_off,
                                int* tile_emit, int* tile_drop,
                                int B, int P, int H, int W, int vox_bits, int ts_cap,
                                int mepv, int slope, int capp, float tscale, float vs2,
                                cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  v2ce::BinConsts c;
  // the per-bin constants arrive as host arrays (ctypes pointers)
  for (int i = 0; i < kCB; ++i) { c.bs_f[i] = bs_f[i]; c.bs_us[i] = bs_us[i]; }
  if (slope) {
    launch<true>(vox, c, keys, kx, kept, total, emit, drop, tile_counts, tile_off,
                 tile_emit, tile_drop, B, P, H, W, vox_bits, ts_cap, mepv, capp,
                 tscale, vs2, stream);
  } else {
    launch<false>(vox, c, keys, nullptr, kept, total, emit, drop, tile_counts, tile_off,
                  tile_emit, tile_drop, B, P, H, W, vox_bits, ts_cap, mepv, capp,
                  tscale, vs2, stream);
  }
  return (int)cudaGetLastError();
}
