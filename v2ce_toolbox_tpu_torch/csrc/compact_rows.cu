// K2 and K2w: stable per-row compaction of int32 keys, with one optional
// payload.
//
// Replaces the Pallas kernels `_compact_kernel2` (K2) and `_compact_kernel`
// (K2w) reached through v2ce_toolbox_tpu/ops/compact_pallas.py:compact_rows
// with algo="place" and algo="window". The two share one contract: in each
// row of n keys, the elements whose key is not INVALID (INT32_MAX) move to
// the front in their original order; the first `capp` of them are kept
// (capp = cap rounded up to the caller's chunk, which equals the TPU
// kernels' whole-chunk drops). Past kept = min(total, capp) the row holds
// INVALID keys and zero payloads. kept and total are written per row. The
// TPU kernels' butterfly routing (K2w's 2-chunk roll window), roll/place
// accumulator and sequential chunk grid are not carried over: they exist
// for the TPU's vector unit. Nor is the JAX wrapper's pad of n to a
// multiple of the chunk (its grid steps over whole chunks): the kernel
// masks a row's ragged last tile, and INVALID padding keeps no key.
//
// Bound on the H100: device-memory bytes. Every key is read once, the
// payload only where a key is kept, and the outputs are written once.
//
// Design: one launch (after the memset of its scratch) on the single-pass
// look-back core of compact_core.cuh, one block a ticket. A compute tile is
// kThreads * S keys of one row: the tile is staged in shared memory by
// 16-byte cp.async copies (S / 4 a thread, all in flight at once; key by
// key where n % 4 != 0 or the keys do not start on 16 bytes, as views such
// as side_in[None] may), then read back strided, so lane l of warp w ranks
// key s * 256 + 32 w + l of step s: one ballot a step, kept in a register,
// a scan of the S * 8 (step, warp) counts by one warp, whose total is the
// tile's aggregate; that warp looks back for the row offset, and each
// warp's valid keys of a step land as one run at offset + the (step, warp)
// prefix + the lane's place in the ballot (coalesced stores, and payload
// loads, only below capp). Ranking each thread's own 4 consecutive keys
// instead scattered every store. Fill tiles, one a 16,384-slot chunk of
// each row's tail, write the tail and kept and total, as K1's do.
//
// K2 (S = 16, tiles of 4,096 keys): its main-path rows (216 rows of 16,384,
// 31,616 or 179,920 keys, 4,096 or 16,384 kept) are mostly INVALID, so the
// key read dominates; the three main-path calls move 14-41 MB each, which
// the 50 MB L2 holds, and there the fixed cost of a call weighs as much as
// the bytes (0.0405 ms over the three, against 0.0447 with tiles of 8,192
// keys and 512 threads and 0.0643 with the scattered ranking;
// chip_smoke.py's stage-2 timings, NVIDIA H100 80GB HBM3, 700.00 W). K2
// keeps these tiles: on K2w's 8,192-key tiles its grid-width call ran 8.7%
// faster on the device, but two of its three main-path calls 22-26% slower
// and the three 9.4% (PERF.md, "PR 14").
//
// K2w (S = 32, tiles of 8,192 keys): the probes' rows (144 x 182,272 keys,
// 105 MB, density 0.1, one payload) do not fit in L2, so each block's key
// load and payload gather wait on device memory, and the time follows the
// bytes in flight: as many blocks as fit on an SM (four, by registers),
// each with a tile's load, its look-back, then its gather. At density 0.1
// about 57% of the payload's 32-byte sectors hold a kept word, so the
// gather moves ~54 MB where the bound counts ~9 MB; with the keys and the
// outputs the floor is ~178 MB (chip_smoke.py logs it). Tiles of 8,192 keys
// took a call at the probe shape in less time than tiles of 4,096; what
// else was tried, and lost, is in PERF.md ("PR 14"): persistent blocks with
// a ring of tiles (a block that holds a ticket it has not counted stalls
// the look-backs behind it), persistent blocks that take the next ticket
// once the look-back has returned and load its keys under the stores, a
// prefetch of later tiles into L2, a bulk copy of the tile, the payload
// gathered into shared memory, and fewer registers.

#include "compact_core.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;                    // K2: keys a thread ranks
constexpr int kTile = kThreads * kSteps;      // K2: keys per tile; ops/compact.py's _TILE
constexpr int kWindowSteps = 32;              // K2w: keys a thread ranks
constexpr int kWindowTile = kThreads * kWindowSteps;   // K2w: ops/compact.py's _WINDOW_TILE
constexpr int kFill = 16384;                  // output slots per tail chunk

// One block a ticket, a tile of kThreads * S keys (see the header). kVec:
// n % 4 == 0 and the keys start on 16 bytes.
template <bool kVec, int S>
__global__ void __launch_bounds__(kThreads)
compact_tiles_kernel(const int* __restrict__ keys, const int* __restrict__ pay,
                     int* __restrict__ out_keys, int* __restrict__ out_pay,
                     unsigned* __restrict__ ticket, unsigned long long* __restrict__ status,
                     int* __restrict__ kept, int* __restrict__ total,
                     int rows, int n, int tiles, int fills, int capp) {
  constexpr int kT = kThreads * S;
  __shared__ __align__(16) int stage[kT];             // the tile's keys
  __shared__ int counts[S * kWarps];                  // per (step, warp), then its prefix
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
  const int base = j * kT;
  const int len = n - base < kT ? n - base : kT;   // keys of this tile
  const unsigned lane = v2ce::lane_id(), warp = v2ce::warp_id();

  // stage the tile: 16-byte copies (S / 4 a thread, all in flight at once),
  // or key by key where the row does not allow them
  if (kVec) {   // n % 4 == 0: a 4-key group is all in the row or all past it
#pragma unroll
    for (int s = 0; s < S / 4; ++s) {
      const int i = 4 * (s * kThreads + (int)threadIdx.x);
      if (i < len) v2ce_hopper::cp_async16(v2ce_hopper::smem_u32(&stage[i]), rk + base + i);
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = s * kThreads + (int)threadIdx.x;
      if (i < len) v2ce_hopper::cp_async4(v2ce_hopper::smem_u32(&stage[i]), rk + base + i, true);
    }
  }
  v2ce_hopper::cp_async_wait_all();
  __syncthreads();

  // step s holds keys s * 256 + [0, 256): lane l of warp w ranks key
  // s * 256 + 32 w + l, so a warp's valid keys of a step are one run of the
  // row's output
  unsigned ballot[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = s * kThreads + (int)threadIdx.x;
    ballot[s] = __ballot_sync(0xffffffffu, i < len && stage[i] != V2CE_INVALID);
    if (lane == 0) counts[s * kWarps + warp] = __popc(ballot[s]);
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the S * 8 counts in key order; lane l owns S / 4
    constexpr int kPer = S * kWarps / 32;
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
  for (int s = 0; s < S; ++s) {
    const int i = s * kThreads + (int)threadIdx.x;
    const unsigned pos = off + counts[s * kWarps + warp] + __popc(ballot[s] & below);
    if (((ballot[s] >> lane) & 1u) && pos < (unsigned)capp) {
      ok[pos] = stage[i];
      if (op) op[pos] = rp[i];
    }
  }
}

// Checks a launch plan (ops/compact.plan) against the kernel's constants:
// `tiles` compute tiles a row (ceil(n / tile)), `fills` fill tiles a row
// (ceil(capp / 16384), at least one) and `words` 64-bit scratch words (the
// ticket, then a status word per compute tile, 1 + rows * tiles).
bool plan_ok(int rows, int n, int capp, int tiles, int fills, long long words, int tile) {
  return rows >= 0 && n >= 0 && capp >= 0 && tiles == (int)(((long)n + tile - 1) / tile) &&
         fills == v2ce::core::fill_chunks(capp, kFill) && words == 1 + (long long)rows * tiles &&
         (long long)rows * (tiles + fills) < (1ll << 31);
}

// One call: the plan checked (cudaErrorInvalidValue, touching nothing,
// where it is not the kernel's), the scratch zeroed, then rows * (tiles +
// fills) blocks of compact_tiles_kernel<vec, S>.
template <int S>
int launch_tiles(const int* keys, const int* pay, int* out_keys, int* out_pay,
                 unsigned long long* scratch, int* kept, int* total, int rows, int n, int capp,
                 int tiles, int fills, long long words, cudaStream_t stream) {
  if (!plan_ok(rows, n, capp, tiles, fills, words, kThreads * S))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  static const cudaError_t carveout[2] = {   // room for the staged tiles of many blocks
      cudaFuncSetAttribute(compact_tiles_kernel<false, S>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared),
      cudaFuncSetAttribute(compact_tiles_kernel<true, S>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared)};
  (void)carveout;
  const unsigned grid = (unsigned)rows * (unsigned)(tiles + fills);
  const bool vec = n % 4 == 0 && (reinterpret_cast<unsigned long long>(keys) & 15u) == 0;
  const auto kernel = vec ? compact_tiles_kernel<true, S> : compact_tiles_kernel<false, S>;
  kernel<<<grid, kThreads, 0, stream>>>(keys, pay, out_keys, out_pay,
                                        reinterpret_cast<unsigned*>(scratch), scratch + 1, kept,
                                        total, rows, n, tiles, fills, capp);
  return (int)cudaGetLastError();
}

}  // namespace

// K2: tiles of 4,096 keys (ops/compact.plan with _TILE).
extern "C" int v2ce_compact_rows(const int* keys, const int* pay, int* out_keys,
                                 int* out_pay, unsigned long long* scratch, int* kept,
                                 int* total, int rows, int n, int capp, int tiles, int fills,
                                 long long words, cudaStream_t stream) {
  return launch_tiles<kSteps>(keys, pay, out_keys, out_pay, scratch, kept, total, rows, n, capp,
                              tiles, fills, words, stream);
}

// K2w: compact_rows(algo="window"), the JAX package's default, on the
// caller's unpadded rows: tiles of 8,192 keys (ops/compact.plan with
// _WINDOW_TILE).
extern "C" int v2ce_compact_rows_window(const int* keys, const int* pay, int* out_keys,
                                        int* out_pay, unsigned long long* scratch, int* kept,
                                        int* total, int rows, int n, int capp, int tiles,
                                        int fills, long long words, cudaStream_t stream) {
  return launch_tiles<kWindowSteps>(keys, pay, out_keys, out_pay, scratch, kept, total, rows,
                                    n, capp, tiles, fills, words, stream);
}
