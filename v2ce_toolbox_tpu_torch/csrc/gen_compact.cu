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
// x 346 f32 = 172.7 MB on the main path) dominates; the compacted rows are
// 216 x 16384 ints (keys and kx: 28.3 MB), the scratch 0.37 MB.
// Design: one launch (after the memset of its scratch) on the single-pass
// look-back core of compact_core.cuh, so the voxels are read once. A
// compute tile is 1,024 pixels of one frame, 256 threads. The tile's 10 bin
// planes are staged in shared memory (40 KB) by 16-byte cp.async copies of
// 4 pixels, 10 a thread all in flight at once (4-byte copies where H*W % 4
// != 0 or the grid is not 16-byte aligned): the coalesced sweep of a
// register load, but the values wait in shared memory, not in registers,
// while the tile looks back, so 4 blocks fit an SM. Holding them in
// registers (85 a thread, 2 blocks an SM) took 0.2134 ms at the main-path
// chunk (chip_smoke.py's stage-2 timings, NVIDIA H100 80GB HBM3, 700.00
// W). Then lane l of warp w takes
// pixel q * 256 + 32 w + l of step q (q = 0..3), runs the relocation from
// shared memory to mark the bins it emits in, and one ballot a (step, bin)
// counts a warp's candidates; one warp a bin scans its 32 (step, warp)
// counts in pixel order. The tile publishes 11 aggregates for its frame (9
// row counts, emit, drop) and looks back for a bin's offset only where it
// has candidates in that bin (stopping once the offset passes capp), and
// for every total in the frame's last tile. Each thread then runs the
// relocation again (arithmetic on shared memory) and writes its kept
// candidates at offset + (step, warp) prefix + its place in the ballot:
// a warp's keys of a (step, bin) land as one run, so the stores coalesce
// (ranking a thread's own 4 consecutive pixels scattered them). The fill
// tiles that follow wait for each row's total, write the tail [kept,
// capp), kept and total, and per frame emit and drop. The TPU kernel's
// block order and scratch accumulators are not carried over; the design
// this replaces (a count pass, a scan, a write pass that read the voxels
// again, a tail fill) is in PERF.md's findings.

#include "compact_core.cuh"
#include "hopper.cuh"

namespace {

using v2ce::kCB;

constexpr int kThreads = 256;
constexpr int kPixels = 4;                      // pixels a thread
constexpr int kTilePixels = kThreads * kPixels; // ops/gen.py's TILE_PIXELS
constexpr int kQ = kCB + 2;                     // per tile: 9 row counts, emit, drop
constexpr int kFill = kThreads * 16;            // output slots per fill tile
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;                 // 4 x 40 KB of staged voxels an SM

template <bool kSlope, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gen_compact_kernel(const float* __restrict__ vox, v2ce::BinConsts c, int P, int hw,
                   int n_tiles, int nfill, int frames, int vox_bits, int ts_cap, int mepv,
                   int capp, float tscale, float vs2, unsigned* __restrict__ ticket,
                   unsigned long long* __restrict__ status, int* __restrict__ keys,
                   int* __restrict__ kx, int* __restrict__ kept, int* __restrict__ total,
                   int* __restrict__ emit, int* __restrict__ drop) {
  __shared__ __align__(16) float stage[kCB + 1][kTilePixels];   // the tile's voxels
  __shared__ unsigned counts[kCB][kPixels * kWarps];   // per (step, warp), then its prefix
  __shared__ unsigned sums[2][kWarps];                  // emit and drop per warp
  __shared__ unsigned agg[kQ], off[kQ];
  __shared__ unsigned slot_ticket, slot_fill;
  const unsigned t = v2ce::core::take_ticket(ticket, &slot_ticket);
  const unsigned compute = (unsigned)frames * (unsigned)n_tiles;
  if (t >= compute) {   // a fill tile: one chunk of a row's tail
    const long row = (t - compute) / nfill;
    const int chunk = (int)((t - compute) % nfill);
    const long b = row / kCB;
    // quantity q of frame b: status words status[(b * kQ + q) * n_tiles + tile]
    const unsigned long long* last =
        n_tiles ? status + (row + b * 2) * n_tiles + n_tiles - 1 : nullptr;
    v2ce::core::fill_row(last, keys, kSlope ? kx : nullptr, kept, total, row, capp, kFill,
                         chunk, &slot_fill);
    if (chunk == 0 && row % kCB == 0 && threadIdx.x == 0) {   // the frame's sums
      emit[b] = last ? (int)v2ce::core::wait_prefix(last + (long)kCB * n_tiles) : 0;
      drop[b] = last ? (int)v2ce::core::wait_prefix(last + (long)(kCB + 1) * n_tiles) : 0;
    }
    return;
  }
  const long b = t / n_tiles;
  const int j = (int)(t % n_tiles);
  const int seg = P * hw;
  const int tile0 = j * kTilePixels;   // the tile's first pixel in the frame
  const unsigned lane = v2ce::lane_id(), warp = v2ce::warp_id();

  // stage the 10 bin planes of the tile's pixels in the frame: 16-byte
  // copies of 4 pixels (10 a thread, all in flight at once), or pixel by
  // pixel where the planes do not allow them
  if (kVec) {   // hw % 4 == 0: 4 pixels share one plane, all in or all out
    const int v = tile0 + kPixels * (int)threadIdx.x;
    if (v < seg) {
      const int po = v / hw;
      const float* src = vox + ((b * P + (P - 1 - po)) * (kCB + 1)) * (long)hw + (v - po * hw);
#pragma unroll
      for (int ci = 0; ci <= kCB; ++ci)
        v2ce_hopper::cp_async16(v2ce_hopper::smem_u32(&stage[ci][v - tile0]),
                                src + (long)ci * hw);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPixels; ++q) {
      const int v = tile0 + q * kThreads + (int)threadIdx.x;
      if (v < seg) {
        const int po = v / hw;
        const float* src =
            vox + ((b * P + (P - 1 - po)) * (kCB + 1)) * (long)hw + (v - po * hw);
#pragma unroll
        for (int ci = 0; ci <= kCB; ++ci)
          v2ce_hopper::cp_async4(v2ce_hopper::smem_u32(&stage[ci][v - tile0]),
                                 src + (long)ci * hw, true);
      }
    }
  }
  v2ce_hopper::cp_async_wait_all();
  __syncthreads();

  // Step q: lane l of warp w takes pixel q * 256 + 32 w + l of the tile, so
  // a warp's candidates of a (step, bin) are one run of the bin's row.
  const auto pixel = [&](int q, v2ce::Pixel& px) {
    float x[kCB + 1];
#pragma unroll
    for (int ci = 0; ci <= kCB; ++ci) x[ci] = stage[ci][q * kThreads + threadIdx.x];
    v2ce::relocate_values(x, px);
  };
  unsigned long long bits = 0;   // bit 4 * ci + q: pixel q emits in bin ci
  unsigned esum = 0u, dsum = 0u;
#pragma unroll
  for (int q = 0; q < kPixels; ++q) {
    if (tile0 + q * kThreads + (int)threadIdx.x >= seg) continue;
    v2ce::Pixel px;
    pixel(q, px);
#pragma unroll
    for (int ci = 0; ci < kCB; ++ci) {
      const int e = v2ce::emit_of(px.cnt[ci], mepv, kSlope);
      esum += (unsigned)e;
      dsum += (unsigned)v2ce::drop_of(px.cnt[ci], mepv, kSlope);
      if (e > 0) bits |= 1ull << (4 * ci + q);
    }
  }
#pragma unroll
  for (int q = 0; q < kPixels; ++q)
#pragma unroll
    for (int ci = 0; ci < kCB; ++ci) {
      const unsigned bal = __ballot_sync(0xffffffffu, (bits >> (4 * ci + q)) & 1ull);
      if (lane == 0) counts[ci][q * kWarps + warp] = __popc(bal);
    }
  esum = __reduce_add_sync(0xffffffffu, esum);
  dsum = __reduce_add_sync(0xffffffffu, dsum);
  if (lane == 0) {
    sums[0][warp] = esum;
    sums[1][warp] = dsum;
  }
  __syncthreads();

  // per bin, the exclusive scan of its 32 (step, warp) counts in pixel
  // order (warp ci % 8 takes bin ci); the tile's 11 aggregates: 9 row
  // counts, emit and drop
  for (int ci = (int)warp; ci < kCB; ci += kWarps) {
    const unsigned c = counts[ci][lane];
    unsigned incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= (unsigned)d) incl += u;
    }
    counts[ci][lane] = incl - c;
    if (lane == 31) agg[ci] = incl;
  }
  if (threadIdx.x < 2) {
    unsigned a = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sums[threadIdx.x][w];
    agg[kCB + threadIdx.x] = a;
  }
  __syncthreads();

  // publish the 11 aggregates, then look back where it is needed: a bin's
  // offset where the tile places candidates in it (stopping once it
  // passes capp), and every total in the frame's last tile. Warp q % 8
  // takes quantity q.
  unsigned long long* frame_status = status + b * kQ * n_tiles;
  const bool last = j == n_tiles - 1;
  if (threadIdx.x < kQ)
    v2ce::core::publish_aggregate(frame_status + (long)threadIdx.x * n_tiles, 1, j,
                                  agg[threadIdx.x]);
  // another thread stores quantity q's inclusive prefix over the same word:
  // the barrier orders it after the aggregate, so no aggregate lands last
  __syncthreads();
  for (int q = (int)warp; q < kQ; q += kWarps) {
    unsigned o = 0xffffffffu;   // no candidate of this tile lands in the row
    if (last)
      o = v2ce::core::warp_lookback(frame_status + q * n_tiles, 1, j, agg[q]);
    else if (q < kCB && agg[q] > 0)
      o = v2ce::core::warp_lookback(frame_status + q * n_tiles, 1, j, agg[q], (unsigned)capp);
    if (lane == 0) off[q] = o;
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int ci = 0; ci < kCB; ++ci) any |= off[ci] < (unsigned)capp;
  if (!any) return;   // uniform

  // each candidate at its row offset + its (step, warp) prefix + its
  // lane's place in the step's ballot, below capp
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kPixels; ++q) {
    unsigned pos[kCB];
#pragma unroll
    for (int ci = 0; ci < kCB; ++ci) {
      const bool mine = (bits >> (4 * ci + q)) & 1ull;
      const unsigned bal = __ballot_sync(0xffffffffu, mine);
      pos[ci] = mine ? off[ci] + counts[ci][q * kWarps + warp] + __popc(bal & below)
                     : 0xffffffffu;
    }
    if (!((bits >> q) & 0x111111111ull)) continue;
    v2ce::Pixel px;
    pixel(q, px);
    const int v = tile0 + q * kThreads + (int)threadIdx.x;
#pragma unroll
    for (int ci = 0; ci < kCB; ++ci) {
      if (pos[ci] >= (unsigned)capp) continue;
      const long at = (b * kCB + ci) * capp + pos[ci];
      keys[at] = v2ce::key_of(px, ci, v, c, tscale, vox_bits, ts_cap);
      if (kSlope) kx[at] = v2ce::kx_of(px, ci, vs2, mepv);
    }
  }
}

template <bool kSlope, bool kVec>
void launch(const float* vox, const v2ce::BinConsts& c, int* keys, int* kx, int* kept,
            int* total, int* emit, int* drop, unsigned long long* scratch, int B, int P, int hw,
            int n_tiles, int nfill, unsigned grid, int vox_bits, int ts_cap, int mepv,
            int capp, float tscale, float vs2, cudaStream_t stream) {
  static const cudaError_t carveout = cudaFuncSetAttribute(   // room for 4 tiles an SM
      gen_compact_kernel<kSlope, kVec>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  (void)carveout;
  gen_compact_kernel<kSlope, kVec><<<grid, kThreads, 0, stream>>>(
      vox, c, P, hw, n_tiles, nfill, B, vox_bits, ts_cap, mepv, capp, tscale, vs2,
      reinterpret_cast<unsigned*>(scratch), scratch + 1, keys, kx, kept, total, emit, drop);
}

}  // namespace

// slope != 0: strategy 'slope' (kx written); 0: strategy 'none' (kx may be
// null). bs_f and bs_us are host arrays of the 9 bin constants. The launch
// plan (ops/gen.plan): `tiles` compute tiles a frame (ceil(P*H*W / 1024)),
// `fills` fill tiles a (frame, bin) row (ceil(capp / 4096), at least one)
// and `words` 64-bit scratch words, 1 + B * tiles * 11 (the ticket, then
// the status words of quantity q of frame b, tile by tile, at (b * 11 + q)
// * tiles), which are zeroed here before the launch; the grid is B *
// (tiles + 9 * fills) blocks. Returns cudaErrorInvalidValue, touching
// nothing, where the plan is not the kernel's.
extern "C" int v2ce_gen_compact(const float* vox, const float* bs_f, const int* bs_us,
                                int* keys, int* kx, int* kept, int* total, int* emit,
                                int* drop, unsigned long long* scratch, int B, int P, int H,
                                int W, int vox_bits, int ts_cap, int mepv, int slope,
                                int capp, float tscale, float vs2, int tiles, int fills,
                                long long words, cudaStream_t stream) {
  const long seg = (long)P * H * W;
  if (B < 0 || seg < 0 || capp < 0 || tiles != (int)((seg + kTilePixels - 1) / kTilePixels) ||
      fills != v2ce::core::fill_chunks(capp, kFill) ||
      words != 1 + (long long)B * tiles * kQ ||
      (long long)B * (tiles + (long long)kCB * fills) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  v2ce::BinConsts c;
  for (int i = 0; i < kCB; ++i) { c.bs_f[i] = bs_f[i]; c.bs_us[i] = bs_us[i]; }
  const int hw = H * W;
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * (unsigned)(tiles + kCB * fills);
  const bool vec = hw % 4 == 0 && (reinterpret_cast<unsigned long long>(vox) & 15u) == 0;
  using Launch = decltype(&launch<true, true>);
  const Launch go = slope ? (vec ? &launch<true, true> : &launch<true, false>)
                          : (vec ? &launch<false, true> : &launch<false, false>);
  go(vox, c, keys, kx, kept, total, emit, drop, scratch, B, P, hw, tiles, fills, grid,
     vox_bits, ts_cap, mepv, capp, tscale, vs2, stream);
  return (int)cudaGetLastError();
}
