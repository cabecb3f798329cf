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
// Bound on the H100: device-memory bytes. Each row is read once (keys, and
// the payload only where a key is valid) and its output written once; the
// main-path rows (216 rows of 16,384 or 31,616 keys, 4,096 or 16,384 kept)
// are mostly INVALID, so the read dominates.
// Design: one block of 1024 threads per row walks the row in tiles of 1024
// coalesced keys. A warp ballot and a shuffle scan over the 32 warp counts
// rank each valid key within the tile; the running offset carries across
// tiles, so the output is deterministic and uses no atomics. The TPU
// kernel's butterfly routing, roll/place accumulator and sequential chunk
// grid are not carried over: they exist for the TPU's vector unit.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const int* __restrict__ keys, const int* __restrict__ pay,
                    int* __restrict__ out_keys, int* __restrict__ out_pay,
                    int* __restrict__ kept, int* __restrict__ total,
                    int n, int capp) {
  __shared__ int scratch[32];
  const long row = blockIdx.x;
  const int* rk = keys + row * n;
  const int* rp = pay ? pay + row * n : nullptr;
  int* ok = out_keys + row * (long)capp;
  int* op = out_pay ? out_pay + row * (long)capp : nullptr;

  int carry = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    const int k = i < n ? rk[i] : V2CE_INVALID;
    const bool valid = k != V2CE_INVALID;
    int tile_count;
    const int pos = carry + v2ce::block_rank(valid, scratch, &tile_count);
    if (valid && pos < capp) {
      ok[pos] = k;
      if (op) op[pos] = rp[i];
    }
    carry += tile_count;
  }
  const int kp = carry < capp ? carry : capp;
  for (int c = kp + threadIdx.x; c < capp; c += kThreads) {
    ok[c] = V2CE_INVALID;
    if (op) op[c] = 0;
  }
  if (threadIdx.x == 0) {
    kept[row] = kp;
    total[row] = carry;
  }
}

}  // namespace

extern "C" int v2ce_compact_rows(const int* keys, const int* pay, int* out_keys,
                                 int* out_pay, int* kept, int* total,
                                 int rows, int n, int capp, cudaStream_t stream) {
  if (rows > 0) {
    compact_rows_kernel<<<rows, kThreads, 0, stream>>>(keys, pay, out_keys, out_pay,
                                                       kept, total, n, capp);
  }
  return (int)cudaGetLastError();
}
