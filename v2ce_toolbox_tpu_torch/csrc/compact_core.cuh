// Single-pass stable compaction with decoupled look-back: the core that K1
// (gen_compact.cu), K2 (compact_rows.cu) and K3/K5 (merge_rows.cu) share.
//
// A launch is one 1-D grid of equal blocks. Each block first takes a
// ticket (an atomicAdd on a counter), and the ticket, not blockIdx, names
// its work: tickets [0, compute) are the compute tiles of the sequences
// (rows, or frames) in order, tickets [compute, grid) are fill tiles. A
// block therefore only ever waits on blocks with smaller tickets, which
// have all started and wait on nothing later than themselves: every wait
// ends, whatever order the hardware starts blocks in.
//
// A compute tile counts its valid elements (per quantity; K1 has eleven),
// publishes that aggregate, looks back over its predecessors in the same
// sequence with one warp per quantity (64 predecessors a round of loads)
// for its exclusive offset, and publishes its inclusive prefix. A tile
// with nothing to place skips the look-back, and one whose offset passes
// capp stops it early; the last tile of a sequence always completes it,
// since its inclusive prefix is the total. Positions are exact, so the
// output is deterministic; the only atomics are the ticket. Fill tiles own
// each output row's tail [kept, capp), in chunks: a fill tile waits for
// the row's total (the last compute tile's inclusive prefix), writes its
// chunk INVALID / 0, and the row's first chunk also writes kept and total.
// So the tail needs no second launch, and a wide tail (one row of 120,832
// slots) spreads over many blocks.
//
// A status word packs the flag (high 32 bits) with its value (low 32
// bits), so one 64-bit store publishes both and one load reads a
// consistent pair; relaxed gpu-scope loads and stores suffice, since no
// other memory is published through a flag. The words and the ticket live
// in one scratch buffer that the C entry zeroes with cudaMemsetAsync before
// each launch: a CUDA graph that replays the launch replays the memset, so
// a replay never reads the previous one's flags. The buffer's layout (how
// many tiles, fill tiles and words) is planned in Python (ops/compact.plan,
// ops/compact.merge_plan, ops/gen.plan) and passed to the C entry, which
// checks it against the kernel's constants before it touches the buffer.
#pragma once

#include "common.cuh"

namespace v2ce {
namespace core {

constexpr unsigned kAggregate = 1u;   // the tile's own count is published
constexpr unsigned kPrefix = 2u;      // the inclusive prefix is published

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned flag,
                                             unsigned value) {
  const unsigned long long v = ((unsigned long long)flag << 32) | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Block-wide: this block's ticket. `slot` is a __shared__ word that the
// block does not write again.
__device__ __forceinline__ unsigned take_ticket(unsigned* counter, unsigned* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1u);
  __syncthreads();
  return *slot;
}

// Publishes tile j's aggregate of one quantity, whose status words are
// status[t * stride] for tiles t = 0, 1, ... of its sequence; tile 0's
// aggregate is its inclusive prefix. One thread; where another thread
// later stores the inclusive prefix (warp_lookback's lane 0), a barrier
// between the two must order them (see warp_lookback).
__device__ __forceinline__ void publish_aggregate(unsigned long long* status, long stride,
                                                  int j, unsigned agg) {
  store_status(status + j * stride, j == 0 ? kPrefix : kAggregate, agg);
}

// After publish_aggregate, by one whole warp: returns (in every lane) the
// sum of the aggregates of tiles 0 .. j-1 and publishes tile j's inclusive
// prefix. The warp reads kWindows x 32 predecessors' words with one round
// of loads (lane 0 nearest), then sums window by window up to the nearest
// inclusive prefix, waiting only on words not yet published. Once the sum
// reaches `stop` it returns early without publishing (the tile keeps
// nothing past stop; its successors look past it). Sums wrap modulo 2^32,
// as int32 sums do.
//
// The invariant every wait relies on: a word holds 0, then at most one
// aggregate, then at most one inclusive prefix, and the prefix store is
// the only store of kPrefix into it and the last store to it. Look-backs
// accept either flag, but fill tiles (wait_prefix) wait for kPrefix alone:
// an aggregate that landed after the prefix would hide the prefix for
// good and hang them. The aggregate's store must therefore be ordered
// before this one, by program order where one thread makes both (K2) or
// by a __syncthreads() between them where two threads do (K1).
__device__ __forceinline__ unsigned warp_lookback(unsigned long long* status, long stride,
                                                  int j, unsigned agg,
                                                  unsigned stop = 0xffffffffu) {
  constexpr int kWindows = 2;   // 4 read no faster (K1, NVIDIA H100 80GB HBM3)
  if (j == 0) return 0u;
  const unsigned lane = lane_id();
  unsigned excl = 0u;
  for (int first = j - 1;; first -= 32 * kWindows) {
    unsigned long long s[kWindows];
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      const int t = first - 32 * w - (int)lane;
      s[w] = t >= 0 ? load_status(status + t * stride)
                    : (unsigned long long)kPrefix << 32;   // before tile 0: empty
    }
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      const int t = first - 32 * w - (int)lane;
      while ((unsigned)(s[w] >> 32) == 0u) {
        __nanosleep(32);
        s[w] = load_status(status + t * stride);
      }
      const unsigned prefix = __ballot_sync(0xffffffffu, (unsigned)(s[w] >> 32) == kPrefix);
      const unsigned last = prefix ? (unsigned)__ffs(prefix) - 1u : 31u;
      excl += __reduce_add_sync(0xffffffffu, lane <= last ? (unsigned)s[w] : 0u);
      if (prefix) {                       // warp-uniform
        if (lane == 0) store_status(status + j * stride, kPrefix, excl + agg);
        return excl;
      }
      if (excl >= stop) return excl;      // warp-uniform
    }
  }
}

// The inclusive prefix published at p, once it is there (one thread).
__device__ __forceinline__ unsigned wait_prefix(const unsigned long long* p) {
  unsigned long long s = load_status(p);
  while ((unsigned)(s >> 32) != kPrefix) {
    __nanosleep(64);
    s = load_status(p);
  }
  return (unsigned)s;
}

// Block-wide: keys[lo, hi) = INVALID and, where pay is not null,
// pay[lo, hi) = 0; 16-byte stores where both rows allow them.
__device__ __forceinline__ void fill_tail(int* __restrict__ keys, int* __restrict__ pay,
                                          long lo, long hi) {
  if (lo >= hi) return;
  const bool vec = ((reinterpret_cast<unsigned long long>(keys) |
                     reinterpret_cast<unsigned long long>(pay)) & 15u) == 0;
  long head = hi, body = hi;
  if (vec) {
    head = (lo + 3) & ~3L;
    if (head > hi) head = hi;
    body = head + ((hi - head) & ~3L);
  }
  for (long i = lo + threadIdx.x; i < head; i += blockDim.x) {
    keys[i] = V2CE_INVALID;
    if (pay) pay[i] = 0;
  }
  const int4 inv = make_int4(V2CE_INVALID, V2CE_INVALID, V2CE_INVALID, V2CE_INVALID);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (long i = head + 4L * threadIdx.x; i < body; i += 4L * blockDim.x) {
    *reinterpret_cast<int4*>(keys + i) = inv;
    if (pay) *reinterpret_cast<int4*>(pay + i) = zero;
  }
  for (long i = body + threadIdx.x; i < hi; i += blockDim.x) {
    keys[i] = V2CE_INVALID;
    if (pay) pay[i] = 0;
  }
}

// A fill tile's work, block-wide: chunk `chunk` (of `fill` slots) of the
// capp-wide output row `row`, past kept = min(total, capp), once the row's
// total is published at `last` (the row's last compute tile; null for a
// row with no tiles, whose total is 0); chunk 0 also writes kept and
// total. Returns the total in every thread. `slot` is a __shared__ word.
__device__ __forceinline__ unsigned fill_row(const unsigned long long* last, int* keys,
                                             int* pay, int* kept, int* total, long row,
                                             int capp, int fill, int chunk, unsigned* slot) {
  if (threadIdx.x == 0) {
    const unsigned tot = last ? wait_prefix(last) : 0u;
    *slot = tot;
    if (chunk == 0) {
      kept[row] = (int)tot < capp ? (int)tot : capp;
      total[row] = (int)tot;
    }
  }
  __syncthreads();
  const unsigned tot = *slot;
  const long kp = (int)tot < capp ? (int)tot : capp;
  const long lo = (long)chunk * fill > kp ? (long)chunk * fill : kp;
  const long hi = (long)(chunk + 1) * fill < capp ? (long)(chunk + 1) * fill : capp;
  fill_tail(keys + row * capp, pay ? pay + row * capp : nullptr, lo, hi);
  return tot;
}

// Chunks of `fill` slots in a capp-wide output row (at least one).
__host__ __device__ __forceinline__ int fill_chunks(int capp, int fill) {
  return capp > fill ? (capp + fill - 1) / fill : 1;
}

}  // namespace core
}  // namespace v2ce
