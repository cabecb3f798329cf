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
// 16,384 kept) are mostly INVALID, so the key read dominates.
// Design: three launches, deterministic, no atomics. A block is 1024
// threads over a tile of 8 x 1024 keys: each thread loads its 8 keys (one
// coalesced step of the warp each) before it uses any, so eight loads are in
// flight per thread.
//   1. count: blocks of (row, tile) write the tile's count of valid keys to
//      a (rows, tiles) scratch;
//   2. place: blocks of (row, tile) sum the counts of the tiles before their
//      own in the row (the tile's offset) and exit at once if it is past
//      capp; otherwise the 8 x 32 warp ballots of the tile, in key order,
//      are scanned once by the first warp, each valid key's rank is its
//      ballot's prefix plus its lane's place in the ballot, and the kept
//      ones land at offset + rank with their payload;
//   3. tail: blocks of (row, tile of the output) sum the row's counts and
//      write INVALID / 0 past kept, and kept and total.
// Every block is independent, so a single wide row (the EventStream
// route's side list, 3,538,944 keys) spreads over the whole card. Two
// earlier designs, timed by chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700.00 W: one 1024-thread block per row walking its tiles in series took
// 2.6053 ms on that row (its plain twin 0.3989); tiles of 1024 keys, one
// per thread, took 0.0710 ms there but 0.4947 ms at grid width (216 x
// 179,920 keys + payload), against 0.2749 for the row walk: 38,016 short
// blocks per launch. The TPU kernel's butterfly routing, roll/place
// accumulator and sequential chunk grid are not carried over: they exist
// for the TPU's vector unit.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSteps = 8;
constexpr int kTile = kThreads * kSteps;  // keys per block; ops/compact.py's _TILE

__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const int* __restrict__ keys, int* __restrict__ tile_counts, int n) {
  __shared__ int scratch[32];
  const int* rk = keys + (long)blockIdx.y * n;
  const int start = blockIdx.x * kTile + threadIdx.x;
  int c = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = start + s * kThreads;
    c += i < n && rk[i] != V2CE_INVALID;
  }
  c = v2ce::block_sum(c, scratch);
  if (threadIdx.x == 0) tile_counts[(long)blockIdx.y * gridDim.x + blockIdx.x] = c;
}

__global__ void __launch_bounds__(kThreads)
compact_place_kernel(const int* __restrict__ keys, const int* __restrict__ pay,
                     int* __restrict__ out_keys, int* __restrict__ out_pay,
                     const int* __restrict__ tile_counts, int n, int capp) {
  __shared__ int scratch[kSteps * 32];  // per (step, warp): count, then prefix
  const long row = blockIdx.y;
  const int* counts = tile_counts + row * gridDim.x;
  if (counts[blockIdx.x] == 0) return;  // uniform over the block
  const int off = v2ce::range_sum(counts, 0, blockIdx.x, scratch);
  if (off >= capp) return;
  const unsigned lane = v2ce::lane_id(), warp = v2ce::warp_id();
  const int start = blockIdx.x * kTile + threadIdx.x;
  const int* rk = keys + row * n;
  int k[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = start + s * kThreads;
    k[s] = i < n ? rk[i] : V2CE_INVALID;
  }
  unsigned ballot[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    ballot[s] = __ballot_sync(0xffffffffu, k[s] != V2CE_INVALID);
    if (lane == 0) scratch[s * 32 + warp] = __popc(ballot[s]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 256 counts; lane l owns kSteps in a row
    int c[kSteps], local = 0;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) local += c[j] = scratch[lane * kSteps + j];
    int incl = local;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= (unsigned)d) incl += t;
    }
    int run = incl - local;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      scratch[lane * kSteps + j] = run;
      run += c[j];
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int pos = off + scratch[s * 32 + warp] + __popc(ballot[s] & below);
    if (k[s] != V2CE_INVALID && pos < capp) {
      out_keys[row * capp + pos] = k[s];
      if (out_pay) out_pay[row * capp + pos] = pay[row * n + start + s * kThreads];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
compact_tail_kernel(int* __restrict__ out_keys, int* __restrict__ out_pay,
                    const int* __restrict__ tile_counts, int* __restrict__ kept,
                    int* __restrict__ total, int tiles, int capp) {
  __shared__ int scratch[32];
  const long row = blockIdx.y;
  const int tot = v2ce::range_sum(tile_counts, row * tiles, (row + 1) * tiles, scratch);
  const int kp = tot < capp ? tot : capp;
  const long start = (long)blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long c = start + s * kThreads;
    if (c >= kp && c < capp) {
      out_keys[row * capp + c] = V2CE_INVALID;
      if (out_pay) out_pay[row * capp + c] = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    kept[row] = kp;
    total[row] = tot;
  }
}

}  // namespace

// tile_counts is (rows, ceil(n / 8192)) scratch; rows <= 65535.
extern "C" int v2ce_compact_rows(const int* keys, const int* pay, int* out_keys,
                                 int* out_pay, int* tile_counts, int* kept, int* total,
                                 int rows, int n, int capp, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) {
    const dim3 grid(tiles, rows);
    compact_count_kernel<<<grid, kThreads, 0, stream>>>(keys, tile_counts, n);
    compact_place_kernel<<<grid, kThreads, 0, stream>>>(keys, pay, out_keys, out_pay,
                                                        tile_counts, n, capp);
  }
  const dim3 tail_grid(capp > 0 ? (capp + kTile - 1) / kTile : 1, rows);
  compact_tail_kernel<<<tail_grid, kThreads, 0, stream>>>(out_keys, out_pay, tile_counts,
                                                          kept, total, tiles, capp);
  return (int)cudaGetLastError();
}

// K2w: compact_rows(algo="window"), the JAX package's default, replaces
// `_compact_kernel` (compact_pallas.py:127). Its contract is K2's: the TPU
// kernel differs only in routing each chunk through a 2-chunk roll
// butterfly, a VMEM tiling artifact, so the same three launches serve it.
// The wrapper pads n to a multiple of the caller's chunk with INVALID, as
// the JAX wrapper does; this entry exists so that its launches count apart.
extern "C" int v2ce_compact_rows_window(const int* keys, const int* pay, int* out_keys,
                                        int* out_pay, int* tile_counts, int* kept,
                                        int* total, int rows, int n, int capp,
                                        cudaStream_t stream) {
  return v2ce_compact_rows(keys, pay, out_keys, out_pay, tile_counts, kept, total, rows, n,
                           capp, stream);
}
