// K3 and K5: concatenate the valid prefixes of consecutive rows.
//
// Replaces two Pallas kernels of v2ce_toolbox_tpu/ops/compact_pallas.py:
//   K3 `_merge_kernel` (merge_sorted_rows): each group of nb rows -> one row;
//   K5 `_append_kernel` (append_rows): all R rows -> one row, the flatten
//      of the per-frame event buffers (pipeline/driver.py:
//      _flatten_chunk_stream). Its cap arrives rounded up to the caller's
//      chunk: the TPU kernel drops whole chunks once the output is full,
//      which keeps exactly the first cap valids.
// K5 is K3's contract with nb = R. Contract: keys (R, W) int32, any W,
// R = G * nb. Row r's length is its count of non-INVALID keys, and its
// first `length` slots are its prefix. Output row g is the concatenation of
// the prefixes of rows g*nb .. g*nb+nb-1, cut at `cap`, then INVALID keys /
// zero payloads. kept = min(total, cap) and total are written per output row.
//
// Bound on the H100: device-memory bytes. Every key is read once (a row's
// length is its count of valid keys), a payload word only where its key is
// kept, and each output is written once. K3 on the main path mostly writes:
// the one-word stream merge writes a (1, 216 * 16384) row of which only the
// event prefix is data. K5 at the unfused flatten of a 24-frame chunk reads
// (24, 147456) keys (14.2 MB) and the kept events' payload, and writes the
// (1, 3538944) stream and payload (28.3 MB): at most 42.5 MB, about 13 us
// at 3.35 TB/s.
// Design: three launches after zeroing the lengths, deterministic.
//   1. count: blocks of (row, tile of 1024 slots) count the tile's valid
//      keys and add them to the row's length with one integer atomicAdd
//      (exact in any order). One block per row left K5's 24 rows on 24
//      blocks of 132 SMs: 0.345 ms, against 0.107 ms with tiles (K5 on its
//      own kernels, chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W);
//   2. copy: blocks of (row, tile); a block whose tile starts past the
//      row's length exits at once, so the empty tails of sparse rows cost
//      nothing. Each block sums the lengths of the rows before its own in
//      the group (at most nb - 1 ints) to find its offset, so no block
//      waits on another; the ragged edge of W is masked, not padded;
//   3. tail: blocks of (output row, tile) write INVALID / 0 past kept.
// The TPU kernels' lane/sublane rolls into a VMEM accumulator (K3) and the
// write offset carried along the sequential grid (K5) are not carried over.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
merge_count_kernel(const int* __restrict__ keys, int* __restrict__ lengths, int width) {
  __shared__ int scratch[32];
  const int row = blockIdx.y;
  const int start = blockIdx.x * kTile;
  const int s = v2ce::count_valid(keys + (long)row * width + start,
                                  min(kTile, width - start), scratch);
  if (threadIdx.x == 0 && s) atomicAdd(lengths + row, s);
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
  const int off = v2ce::range_sum(lengths, group * nb, row, scratch);
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
  const int tot = v2ce::range_sum(lengths, group * nb, group * nb + nb, scratch);
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

// K3. lengths is (rows,) scratch; kept and total are (rows / nb,).
extern "C" int v2ce_merge_rows(const int* keys, const int* pay, int* out_keys,
                               int* out_pay, int* lengths, int* kept, int* total,
                               int rows, int width, int nb, int cap,
                               cudaStream_t stream) {
  if (rows > 0 && width > 0) {
    dim3 tiles((width + kTile - 1) / kTile, rows);
    cudaMemsetAsync(lengths, 0, sizeof(int) * rows, stream);
    merge_count_kernel<<<tiles, kThreads, 0, stream>>>(keys, lengths, width);
    merge_copy_kernel<<<tiles, kThreads, 0, stream>>>(keys, pay, out_keys, out_pay,
                                                      lengths, width, nb, cap);
  } else if (rows > 0) {
    cudaMemsetAsync(lengths, 0, sizeof(int) * rows, stream);
  }
  if (rows > 0 && cap > 0) {
    dim3 tail_grid((cap + kTile - 1) / kTile, rows / nb);
    merge_tail_kernel<<<tail_grid, kThreads, 0, stream>>>(out_keys, out_pay, lengths,
                                                          kept, total, nb, cap);
  }
  return (int)cudaGetLastError();
}

// K5: all rows into one (nb = rows); cap is already rounded up to the chunk.
extern "C" int v2ce_append_rows(const int* keys, const int* pay, int* out_keys,
                                int* out_pay, int* lengths, int* kept, int* total,
                                int rows, int width, int cap, cudaStream_t stream) {
  return v2ce_merge_rows(keys, pay, out_keys, out_pay, lengths, kept, total, rows, width,
                         rows, cap, stream);
}
