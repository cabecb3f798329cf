// Shared device helpers of the v2ce kernels: the INVALID marker, block-wide
// scans built from warp ballots and shuffles, and the tail fill that writes
// INVALID keys / zero payloads past each row's kept prefix.
#pragma once

#include <cuda_runtime.h>

#define V2CE_INVALID 0x7fffffff

namespace v2ce {

__device__ __forceinline__ unsigned lane_id() { return threadIdx.x & 31u; }
__device__ __forceinline__ unsigned warp_id() { return threadIdx.x >> 5; }

// Exclusive rank of `flag` among the block's flagged threads, in thread
// order. `scratch` is __shared__ int[32]; *total receives the block's count.
// Every thread of the block must call it (it synchronizes).
__device__ __forceinline__ int block_rank(bool flag, int* scratch, int* total) {
  const unsigned lane = lane_id(), warp = warp_id();
  const unsigned nwarps = (blockDim.x + 31) >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) scratch[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= (unsigned)d) v += t;
    }
    scratch[lane] = v;  // inclusive prefix over warps
  }
  __syncthreads();
  const int warp_off = warp ? scratch[warp - 1] : 0;
  *total = scratch[nwarps - 1];
  __syncthreads();  // scratch may be reused right after
  return warp_off + in_warp;
}

// Exclusive prefix sum of `value` over the block, in thread order.
__device__ __forceinline__ int block_exclusive_sum(int value, int* scratch, int* total) {
  const unsigned lane = lane_id(), warp = warp_id();
  const unsigned nwarps = (blockDim.x + 31) >> 5;
  int v = value;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= (unsigned)d) v += t;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= (unsigned)d) w += t;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  const int warp_off = warp ? scratch[warp - 1] : 0;
  *total = scratch[nwarps - 1];
  __syncthreads();
  return warp_off + v - value;
}

// Block-wide sum; every thread receives it.
__device__ __forceinline__ int block_sum(int value, int* scratch) {
  int total;
  block_exclusive_sum(value, scratch, &total);
  return total;
}

}  // namespace v2ce

// keys/pay rows of `width`; slots at or past kept[row] become INVALID / 0.
// Grid (ceil(width / blockDim.x), rows).
static __global__ void v2ce_fill_tail_kernel(int* __restrict__ keys, int* __restrict__ pay,
                                             const int* __restrict__ kept, long width) {
  const long col = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long row = blockIdx.y;
  if (col >= width || col < kept[row]) return;
  keys[row * width + col] = V2CE_INVALID;
  if (pay) pay[row * width + col] = 0;
}
