// K2: stable per-row compaction of int32 keys, with one optional payload.
//
// Replaces the Pallas kernel `_compact_kernel2` reached through
// v2ce_toolbox_tpu/ops/compact_pallas.py:compact_rows(algo="place").
// Contract: in each row of n keys, the elements whose key is not INVALID
// (INT32_MAX) move to the front in their original order; the first
// `capp` of them are kept (capp = cap rounded up to the caller's chunk,
// which equals the TPU kernel's whole-chunk drops). Past kept = min(total,
// capp) the row holds INVALID keys and zero payloads. kept and total are
// written per row.
//
// Bound on the H100: device-memory bytes. Every key is read once, the
// payload only where a key is kept, and the outputs are written once; the
// main-path rows (216 rows of 16,384, 31,616 or 179,920 keys, 4,096 or
// 16,384 kept) are mostly INVALID, so the key read dominates. The three
// main-path calls move 14-41 MB each, which L2 holds: there the fixed cost
// of a call (launches, a dependent chain of kernels) weighs as much as the
// bytes.
// Design: one launch (after the memset of its scratch) on the single-pass
// look-back core of compact_core.cuh. A compute tile is 4,096 keys of one
// row, 256 threads: the tile is staged in shared memory by 16-byte cp.async
// copies (four a thread, all in flight at once; key by key where n % 4 !=
// 0 or the keys do not start on 16 bytes, as views such as side_in[None]
// may), then read back strided, so lane l of warp w ranks key s * 256 +
// 32 w + l of step s: one ballot a step, a scan of the 128 (step, warp)
// counts by one warp, whose total is the tile's aggregate; that warp looks
// back for the row offset, and each warp's valid keys of a step land as one
// run at offset + the (step, warp) prefix + the lane's place in the ballot
// (coalesced stores, and payload loads, only below capp). Ranking each
// thread's own 4 consecutive keys instead scattered every store, and the
// three main-path calls took 0.0643 ms on the device, slower than the
// three-launch design (chip_smoke.py's stage-2 timings, NVIDIA H100 80GB
// HBM3, 700.00 W); with this ranking, tiles of 8,192 keys and 512 threads
// took 0.0447 ms over the three calls, these 0.0405 (the same run). Fill
// tiles, one a 16,384-slot chunk of each row's tail, write the tail and
// kept and total, as K1's do. The TPU kernel's butterfly routing,
// roll/place accumulator and sequential chunk grid are not carried over:
// they exist for the TPU's vector unit. The design it replaces (count,
// place and tail kernels, three launches a call) is in PERF.md's findings.

#include "compact_core.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;                    // keys a thread ranks
constexpr int kTile = kThreads * kSteps;      // keys per tile; ops/compact.py's _TILE
constexpr int kFill = 16384;                  // output slots per tail chunk

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
compact_tiles_kernel(const int* __restrict__ keys, const int* __restrict__ pay,
                     int* __restrict__ out_keys, int* __restrict__ out_pay,
                     unsigned* __restrict__ ticket, unsigned long long* __restrict__ status,
                     int* __restrict__ kept, int* __restrict__ total,
                     int rows, int n, int tiles, int fills, int capp) {
  __shared__ __align__(16) int stage[kTile];          // the tile's keys
  __shared__ int counts[kSteps * kWarps];             // per (step, warp), then its prefix
  __shared__ unsigned slot_ticket, slot_off;
  const unsigned t = v2ce::core::take_ticket(ticket, &slot_ticket);
  const unsigned compute = (unsigned)rows * (unsigned)tiles;
  if (t >= compute) {   // a fill tile: one chunk of a row's tail
    const long row = (t - compute) / fills;
    const int chunk = (int)((t - compute) % fills);
    const unsigned long long* last = tiles ? status + row * tiles + tiles - 1 : nullptr;
    v2ce::core::fill_row(last, out_keys, out_pay, kept, total, row, capp, kFill, chunk,
                         &slot_off);
    return;
  }
  const long row = t / tiles;
  const int j = (int)(t % tiles);
  const int* rk = keys + row * n;
  const int base = j * kTile;
  const int len = n - base < kTile ? n - base : kTile;   // keys of this tile
  const unsigned lane = v2ce::lane_id(), warp = v2ce::warp_id();

  // stage the tile: 16-byte copies (4 a thread, all in flight at once), or
  // key by key where the row does not allow them
  if (kVec) {   // n % 4 == 0: a 4-key group is all in the row or all past it
#pragma unroll
    for (int s = 0; s < kSteps / 4; ++s) {
      const int i = 4 * (s * kThreads + (int)threadIdx.x);
      if (i < len) v2ce_hopper::cp_async16(v2ce_hopper::smem_u32(&stage[i]), rk + base + i);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int i = s * kThreads + (int)threadIdx.x;
      if (i < len) v2ce_hopper::cp_async4(v2ce_hopper::smem_u32(&stage[i]), rk + base + i, true);
    }
  }
  v2ce_hopper::cp_async_wait_all();
  __syncthreads();

  // step s holds keys s * 256 + [0, 256): lane l of warp w ranks key
  // s * 256 + 32 w + l, so a warp's valid keys of a step are one run of the
  // row's output
  unsigned ballot[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = s * kThreads + (int)threadIdx.x;
    ballot[s] = __ballot_sync(0xffffffffu, i < len && stage[i] != V2CE_INVALID);
    if (lane == 0) counts[s * kWarps + warp] = __popc(ballot[s]);
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the 128 counts in key order; lane l owns 4
    constexpr int kPer = kSteps * kWarps / 32;
    int c[kPer], local = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) local += c[q] = counts[lane * kPer + q];
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= (unsigned)d) incl += u;
    }
    int run = incl - local;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      counts[lane * kPer + q] = run;
      run += c[q];
    }
    const unsigned agg = (unsigned)__shfl_sync(0xffffffffu, incl, 31);
    const bool last = j == tiles - 1;
    if (lane == 0) v2ce::core::publish_aggregate(status + row * tiles, 1, j, agg);
    unsigned off = 0xffffffffu;   // nothing to place
    if (agg > 0 || last)
      off = v2ce::core::warp_lookback(status + row * tiles, 1, j, agg,
                                      last ? 0xffffffffu : (unsigned)capp);
    if (lane == 0) slot_off = off;
  }
  __syncthreads();
  const unsigned off = slot_off;
  if (off >= (unsigned)capp) return;   // uniform: this tile keeps nothing
  int* ok = out_keys + row * capp;
  int* op = out_pay ? out_pay + row * capp : nullptr;
  const int* rp = pay ? pay + row * n + base : nullptr;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = s * kThreads + (int)threadIdx.x;
    const unsigned pos = off + counts[s * kWarps + warp] + __popc(ballot[s] & below);
    if (((ballot[s] >> lane) & 1u) && pos < (unsigned)capp) {
      ok[pos] = stage[i];
      if (op) op[pos] = rp[i];
    }
  }
}

}  // namespace

// The launch plan (ops/compact.plan): `tiles` compute tiles a row
// (ceil(n / 4096)), `fills` fill tiles a row (ceil(capp / 16384), at least
// one) and `words` 64-bit scratch words (the ticket, then a status word
// per compute tile, 1 + rows * tiles), which are zeroed here before the
// launch; the grid is rows * (tiles + fills) blocks. Returns
// cudaErrorInvalidValue, touching nothing, where the plan is not the
// kernel's.
extern "C" int v2ce_compact_rows(const int* keys, const int* pay, int* out_keys,
                                 int* out_pay, unsigned long long* scratch, int* kept,
                                 int* total, int rows, int n, int capp, int tiles, int fills,
                                 long long words, cudaStream_t stream) {
  if (rows < 0 || n < 0 || capp < 0 || tiles != (int)(((long)n + kTile - 1) / kTile) ||
      fills != v2ce::core::fill_chunks(capp, kFill) || words != 1 + (long long)rows * tiles ||
      (long long)rows * (tiles + fills) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)rows * (unsigned)(tiles + fills);
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  const bool vec = n % 4 == 0 && (reinterpret_cast<unsigned long long>(keys) & 15u) == 0;
  static const cudaError_t carveout[2] = {   // room for the staged tiles of many blocks
      cudaFuncSetAttribute(compact_tiles_kernel<false>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared),
      cudaFuncSetAttribute(compact_tiles_kernel<true>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared)};
  (void)carveout;
  if (vec) {
    compact_tiles_kernel<true><<<grid, kThreads, 0, stream>>>(
        keys, pay, out_keys, out_pay, ticket, scratch + 1, kept, total, rows, n, tiles, fills,
        capp);
  } else {
    compact_tiles_kernel<false><<<grid, kThreads, 0, stream>>>(
        keys, pay, out_keys, out_pay, ticket, scratch + 1, kept, total, rows, n, tiles, fills,
        capp);
  }
  return (int)cudaGetLastError();
}

// K2w: compact_rows(algo="window"), the JAX package's default, replaces
// `_compact_kernel` (compact_pallas.py:127). Its contract is K2's: the TPU
// kernel differs only in routing each chunk through a 2-chunk roll
// butterfly, a VMEM tiling artifact, so the same kernel serves it. The
// wrapper pads n to a multiple of the caller's chunk with INVALID, as the
// JAX wrapper does; this entry exists so that its launches count apart.
extern "C" int v2ce_compact_rows_window(const int* keys, const int* pay, int* out_keys,
                                        int* out_pay, unsigned long long* scratch, int* kept,
                                        int* total, int rows, int n, int capp, int tiles,
                                        int fills, long long words, cudaStream_t stream) {
  return v2ce_compact_rows(keys, pay, out_keys, out_pay, scratch, kept, total, rows, n, capp,
                           tiles, fills, words, stream);
}
