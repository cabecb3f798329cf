// K3: concatenate the valid prefixes of nb consecutive rows into one row.
//
// Replaces the Pallas kernel `_merge_kernel` reached through
// v2ce_toolbox_tpu/ops/compact_pallas.py:merge_sorted_rows.
// Contract: keys (R, W) int32, R = G * nb. Row r's length is its count of
// non-INVALID keys, and its first `length` slots are its prefix. Output row
// g is the concatenation of the prefixes of rows g*nb .. g*nb+nb-1, cut at
// `cap`, then INVALID keys / zero payloads. kept = min(total, cap) and
// total are written per output row.
//
// Bound on the H100: device-memory bytes, and on the main path mostly the
// output: the one-word stream merge writes a (1, 216 * 16384) row of which
// only the event prefix is data and the rest is the INVALID tail.
// Design: three launches, all deterministic and free of atomics.
//   1. count: one block per input row counts its valid keys;
//   2. copy: blocks of (row, tile of 1024 slots); a block whose tile starts
//      past the row's length exits at once, so the empty tails of sparse
//      rows cost nothing. Each block sums the lengths of the rows before
//      its own in the group (at most nb - 1 ints) to find its offset;
//   3. tail: blocks of (output row, tile) write INVALID / 0 past kept.
// The TPU kernel's lane/sublane rolls into a VMEM accumulator are not
// carried over.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
merge_count_kernel(const int* __restrict__ keys, int* __restrict__ lengths, int width) {
  __shared__ int scratch[32];
  const int* rk = keys + (long)blockIdx.x * width;
  int c = 0;
  for (int i = threadIdx.x; i < width; i += kThreads) c += rk[i] != V2CE_INVALID;
  const int s = v2ce::block_sum(c, scratch);
  if (threadIdx.x == 0) lengths[blockIdx.x] = s;
}

// sum of lengths[first .. last) over the block
__device__ int range_sum(const int* lengths, int first, int last, int* scratch) {
  int c = 0;
  for (int i = first + threadIdx.x; i < last; i += kThreads) c += lengths[i];
  return v2ce::block_sum(c, scratch);
}

__global__ void __launch_bounds__(kThreads)
merge_copy_kernel(const int* __restrict__ keys, const int* __restrict__ pay,
                  int* __restrict__ out_keys, int* __restrict__ out_pay,
                  const int* __restrict__ lengths, int width, int nb, int cap) {
  __shared__ int scratch[32];
  const int row = blockIdx.y;
  const int len = lengths[row];
  const int start = blockIdx.x * kTile;
  if (start >= len) return;  // uniform over the block
  const int group = row / nb;
  const int off = range_sum(lengths, group * nb, row, scratch);
  if (off + start >= cap) return;
  const int end = min(start + kTile, len);
  const int* rk = keys + (long)row * width;
  const int* rp = pay ? pay + (long)row * width : nullptr;
  int* ok = out_keys + (long)group * cap;
  int* op = out_pay ? out_pay + (long)group * cap : nullptr;
  for (int k = start + threadIdx.x; k < end; k += kThreads) {
    const int p = off + k;
    if (p < cap) {
      ok[p] = rk[k];
      if (op) op[p] = rp[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
merge_tail_kernel(int* __restrict__ out_keys, int* __restrict__ out_pay,
                  const int* __restrict__ lengths, int* __restrict__ kept,
                  int* __restrict__ total, int nb, int cap) {
  __shared__ int scratch[32];
  const int group = blockIdx.y;
  const int tot = range_sum(lengths, group * nb, group * nb + nb, scratch);
  const int kp = tot < cap ? tot : cap;
  const long start = (long)blockIdx.x * kTile;
  int* ok = out_keys + (long)group * cap;
  int* op = out_pay ? out_pay + (long)group * cap : nullptr;
  for (long c = start + threadIdx.x; c < start + kTile && c < cap; c += kThreads) {
    if (c >= kp) {
      ok[c] = V2CE_INVALID;
      if (op) op[c] = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    kept[group] = kp;
    total[group] = tot;
  }
}

}  // namespace

extern "C" int v2ce_merge_rows(const int* keys, const int* pay, int* out_keys,
                               int* out_pay, int* lengths, int* kept, int* total,
                               int rows, int width, int nb, int cap,
                               cudaStream_t stream) {
  if (rows > 0) {
    const int groups = rows / nb;
    merge_count_kernel<<<rows, kThreads, 0, stream>>>(keys, lengths, width);
    dim3 copy_grid((width + kTile - 1) / kTile, rows);
    merge_copy_kernel<<<copy_grid, kThreads, 0, stream>>>(keys, pay, out_keys, out_pay,
                                                          lengths, width, nb, cap);
    dim3 tail_grid((cap + kTile - 1) / kTile, groups);
    merge_tail_kernel<<<tail_grid, kThreads, 0, stream>>>(out_keys, out_pay, lengths,
                                                          kept, total, nb, cap);
  }
  return (int)cudaGetLastError();
}
