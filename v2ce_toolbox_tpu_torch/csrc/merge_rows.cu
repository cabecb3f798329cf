// K3 and K5: concatenate the valid prefixes of consecutive rows.
//
// Replaces two Pallas kernels of v2ce_toolbox_tpu/ops/compact_pallas.py:
//   K3 `_merge_kernel` (merge_sorted_rows): each group of nb rows -> one row;
//   K5 `_append_kernel` (append_rows): all R rows -> one row, the flatten
//      of the per-frame event buffers (pipeline/driver.py:
//      _flatten_chunk_stream). Its cap arrives rounded up to the caller's
//      chunk: the TPU kernel drops whole chunks once the output is full,
//      which keeps exactly the first cap valids.
// K5 is K3's contract with one group of nb = R rows. Contract: keys (R, W)
// int32, any W, R = G * nb, and the JAX kernels' precondition: each row's
// valid (non-INVALID) keys form a prefix of it. Output row g is the
// concatenation of the prefixes of rows g*nb .. g*nb+nb-1, cut at `cap`,
// then INVALID keys / zero payloads. kept = min(total, cap) and total are
// written per output row.
//
// Bound on the H100: device-memory bytes. Under the precondition a row's
// length needs no read past its prefix, so the least traffic is the kept
// keys read, a payload word only where its key is kept, and each output
// written once. K3 on the main path mostly writes: the one-word stream
// merge writes a (1, 216 * 16384) row of which only the event prefix is
// data. K5 at the unfused flatten of a 24-frame chunk reads the kept part
// of (24, 147456) keys and payload and writes the (1, 3538944) stream and
// payload (28.3 MB): at most 56.6 MB, about 17 us at 3.35 TB/s.
// Design: one launch (after the memset of its scratch) on the single-pass
// look-back core of compact_core.cuh, whose sequences are the output rows:
// a group's compute tiles are the 4,096-key tiles of its nb rows, in order.
// A compute tile (256 threads) first probes the first key of each of its
// four 1,024-key steps; under the precondition the steps whose first key
// is valid are a prefix of the tile and hold all its valid keys, so only
// they are read, and a tile past its row's prefix publishes 0 and reads
// nothing more (an empty tail costs one load a tile). It stages the live
// steps in shared memory by 16-byte cp.async copies (key by key where W %
// 4 != 0 or the keys do not start on 16 bytes), counts them, and one warp
// looks back for the group offset (all 8 for the group's last tile, whose
// inclusive prefix is the total the fill tiles wait on). The tile's valid
// keys are one run, stage[0, count), so there is nothing to rank: thread t
// stores keys t, t + 256, ... from registers, each warp 128 contiguous
// bytes a step, and loads a payload word only where its key is kept
// (below cap). Fill tiles, one a 4,096-slot chunk of each output row,
// write the tail [kept, cap), kept and total, as K1's and K2's do.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --compare-conv --sets stage2 over copies that differ in one choice,
// device ms by graph replays, K3's two main-path calls / K5): with the run
// shifted in shared memory by offset % 4 for 16-byte stores, the kernel
// took 0.0209 / 0.0277 against these 4-byte stores' 0.0205 / 0.0264, so
// the simpler stores stay. On that kernel, 16,384-slot fill chunks took
// 0.0229 / 0.0288, no launch bounds (6 blocks an SM, 4 with a payload,
// where the bounds give 8 and 6) 0.0215 / 0.0307, and one warp's look-back
// for the last tile 0.0219 (the empty side list 0.0086 against 0.0075) /
// 0.0264.
// The TPU kernels' lane/sublane rolls into a VMEM accumulator (K3) and the
// write offset carried along the sequential grid (K5) are not carried
// over. The design this replaces (count, copy and tail kernels, three
// launches a call, each key read twice) is in PERF.md's findings.

#include "compact_core.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;                    // keys a thread stages
constexpr int kTile = kThreads * kSteps;      // keys per tile; ops/compact.py's _MERGE_TILE
constexpr int kProbe = 1024;                  // keys per probed step of a tile
constexpr int kFill = 4096;                   // output slots per tail chunk
static_assert(kTile % kProbe == 0 && kTile / kProbe <= 32 && kProbe % (4 * kThreads) == 0,
              "a probed step is whole 16-byte rounds of the block, one lane probes it");

// The look-back of a group's last tile, whose inclusive prefix is the total
// that the group's fill tiles wait on, by the whole block: warp w reads
// predecessors j-1-32w-lane of each round (256 a round, where one warp reads
// 64), and the warps' sums combine nearest first, up to the nearest
// inclusive prefix. Returns the exclusive offset in every thread; thread 0,
// which published the tile's aggregate, publishes its inclusive prefix (the
// ordering that warp_lookback's invariant asks for).
__device__ __forceinline__ unsigned block_lookback(unsigned long long* status, int j,
                                                   unsigned agg, unsigned* warp_sum,
                                                   unsigned* warp_prefix) {
  if (j == 0) return 0u;
  const unsigned lane = v2ce::lane_id(), warp = v2ce::warp_id();
  unsigned excl = 0u;
  for (int first = j - 1;; first -= kThreads) {
    const int t = first - 32 * (int)warp - (int)lane;
    unsigned long long s = t >= 0 ? v2ce::core::load_status(status + t)
                                  : (unsigned long long)v2ce::core::kPrefix << 32;
    while ((unsigned)(s >> 32) == 0u) {
      __nanosleep(32);
      s = v2ce::core::load_status(status + t);
    }
    const unsigned prefix =
        __ballot_sync(0xffffffffu, (unsigned)(s >> 32) == v2ce::core::kPrefix);
    const unsigned nearest = prefix ? (unsigned)__ffs(prefix) - 1u : 31u;
    const unsigned sum = __reduce_add_sync(0xffffffffu, lane <= nearest ? (unsigned)s : 0u);
    if (lane == 0) {
      warp_sum[warp] = sum;
      warp_prefix[warp] = prefix != 0u;
    }
    __syncthreads();
    bool found = false;
    for (int w = 0; w < kWarps && !found; ++w) {
      excl += warp_sum[w];
      found = warp_prefix[w] != 0u;
    }
    __syncthreads();   // the words are written again in the next round
    if (found) {
      if (threadIdx.x == 0)
        v2ce::core::store_status(status + j, v2ce::core::kPrefix, excl + agg);
      return excl;
    }
  }
}

// kPay: a payload is routed; kVec: W % 4 == 0 and the
// keys start on 16 bytes, so a 4-key group is all in the row or all past it.
// The launch bounds hold a thread to 32 registers (40 with a payload).
template <bool kVec, bool kPay>
__global__ void __launch_bounds__(kThreads, kPay ? 6 : 8)
merge_tiles_kernel(const int* __restrict__ keys, const int* __restrict__ pay,
                   int* __restrict__ out_keys, int* __restrict__ out_pay,
                   unsigned* __restrict__ ticket, unsigned long long* __restrict__ status,
                   int* __restrict__ kept, int* __restrict__ total, int rows, int width,
                   int nb, int tiles, int fills, int capp) {
  __shared__ __align__(16) int stage[kTile];              // the tile's live keys
  __shared__ int warp_counts[kWarps];
  __shared__ unsigned warp_sum[kWarps], warp_prefix[kWarps];
  __shared__ unsigned slot_ticket, slot_off;
  const unsigned t = v2ce::core::take_ticket(ticket, &slot_ticket);
  const unsigned compute = (unsigned)rows * (unsigned)tiles;
  const long seq = (long)nb * tiles;                       // compute tiles of a group
  if (t >= compute) {   // a fill tile: one chunk of a group's tail
    const long g = (t - compute) / fills;
    const int chunk = (int)((t - compute) % fills);
    const unsigned long long* last = seq ? status + g * seq + seq - 1 : nullptr;
    v2ce::core::fill_row(last, out_keys, kPay ? out_pay : nullptr, kept, total, g, capp,
                         kFill, chunk, &slot_off);
    return;
  }
  const long row = t / tiles;
  const long g = row / nb;
  const int j = (int)(t - g * seq);                        // the tile's place in its group
  const bool last = j == seq - 1;
  unsigned long long* gstatus = status + g * seq;
  const int base = (int)(t % tiles) * kTile;
  const int* rk = keys + row * width + base;
  const int len = width - base < kTile ? width - base : kTile;   // keys of this tile
  const unsigned lane = v2ce::lane_id(), warp = v2ce::warp_id();

  // the prefix probes: lane p of every warp reads the first key of the
  // tile's step p of 1,024 keys. Under the precondition the steps whose
  // first key is valid are a prefix of the tile and hold all its valid
  // keys: only they are staged, and a tile with none reads nothing more
  // (uniform over the block, without a barrier)
  const int probe = (int)lane * kProbe;
  const unsigned live = __ballot_sync(0xffffffffu, probe < len &&
                                      __ldg(rk + probe) != V2CE_INVALID);
  const int n = min(len, __popc(live) * kProbe);   // keys to stage
  int kv[kSteps];
  unsigned agg = 0u;
  if (n > 0) {
    if (kVec) {
#pragma unroll
      for (int s = 0; s < kSteps / 4; ++s) {
        const int i = 4 * (s * kThreads + (int)threadIdx.x);
        if (i < n) v2ce_hopper::cp_async16(v2ce_hopper::smem_u32(&stage[i]), rk + i);
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int i = s * kThreads + (int)threadIdx.x;
        if (i < n) v2ce_hopper::cp_async4(v2ce_hopper::smem_u32(&stage[i]), rk + i, true);
      }
    }
    v2ce_hopper::cp_async_wait_all();
    __syncthreads();
    int c = 0;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {   // key s * 256 + thread, kept for the stores
      const int i = s * kThreads + (int)threadIdx.x;
      kv[s] = stage[i];
      c += i < n && kv[s] != V2CE_INVALID;
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) warp_counts[warp] = c;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) agg += (unsigned)warp_counts[w];
  }
  unsigned off;
  if (last) {   // always completes the group: its prefix is the total
    if (threadIdx.x == 0) v2ce::core::publish_aggregate(gstatus, 1, j, agg);
    off = block_lookback(gstatus, j, agg, warp_sum, warp_prefix);
  } else {
    if (warp == 0) {
      if (lane == 0) v2ce::core::publish_aggregate(gstatus, 1, j, agg);
      unsigned o = 0xffffffffu;   // nothing to place
      if (agg > 0u) o = v2ce::core::warp_lookback(gstatus, 1, j, agg, (unsigned)capp);
      if (lane == 0) slot_off = o;
    }
    __syncthreads();
    off = slot_off;
  }
  if (agg == 0u || off >= (unsigned)capp) return;   // uniform: this tile keeps nothing

  // the run stage[0, keep) goes to output [off, off + keep): key s * 256 +
  // thread from registers, so each warp's stores of a step are 128
  // contiguous bytes; the payload is read only where its key is kept
  const int keep = agg < (unsigned)capp - off ? (int)agg : (int)((unsigned)capp - off);
  int* ok = out_keys + g * capp + off;
  int* op = kPay ? out_pay + g * capp + off : nullptr;
  const int* rp = kPay ? pay + row * width + base : nullptr;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = s * kThreads + (int)threadIdx.x;
    if (i < keep) {
      ok[i] = kv[s];
      if (kPay) op[i] = rp[i];
    }
  }
}

template <bool kVec, bool kPay>
void launch(const int* keys, const int* pay, int* out_keys, int* out_pay,
            unsigned long long* scratch, int* kept, int* total, int rows, int width, int nb,
            int tiles, int fills, int capp, unsigned grid, cudaStream_t stream) {
  static const cudaError_t carveout = cudaFuncSetAttribute(   // room for many blocks' stages
      merge_tiles_kernel<kVec, kPay>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  (void)carveout;
  merge_tiles_kernel<kVec, kPay><<<grid, kThreads, 0, stream>>>(
      keys, pay, out_keys, out_pay, reinterpret_cast<unsigned*>(scratch), scratch + 1, kept,
      total, rows, width, nb, tiles, fills, capp);
}

// The launch plan (ops/compact.merge_plan): `tiles` compute tiles a row
// (ceil(W / 4096)), `fills` fill tiles a group (ceil(cap / 4096), at least
// one) and `words` 64-bit scratch words (the ticket, then a status word per
// compute tile, 1 + rows * tiles), which are zeroed here before the launch;
// the grid is rows * tiles + groups * fills blocks. Returns
// cudaErrorInvalidValue, touching nothing, where the plan is not the
// kernel's or a group's total could pass int32.
int merge(const int* keys, const int* pay, int* out_keys, int* out_pay,
          unsigned long long* scratch, int* kept, int* total, int rows, int width, int nb,
          int groups, int cap, int tiles, int fills, long long words, cudaStream_t stream) {
  if (rows < 0 || width < 0 || nb < 0 || groups < 0 || cap < 0 ||
      (long long)groups * nb != rows || (long long)nb * width >= (1ll << 31) ||
      tiles != (int)(((long)width + kTile - 1) / kTile) ||
      fills != v2ce::core::fill_chunks(cap, kFill) || words != 1 + (long long)rows * tiles ||
      (long long)rows * tiles + (long long)groups * fills >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)rows * (unsigned)tiles + (unsigned)groups * (unsigned)fills;
  const bool vec = width % 4 == 0 && (reinterpret_cast<unsigned long long>(keys) & 15u) == 0;
  if (vec && pay)
    launch<true, true>(keys, pay, out_keys, out_pay, scratch, kept, total, rows, width, nb,
                       tiles, fills, cap, grid, stream);
  else if (vec)
    launch<true, false>(keys, pay, out_keys, out_pay, scratch, kept, total, rows, width, nb,
                        tiles, fills, cap, grid, stream);
  else if (pay)
    launch<false, true>(keys, pay, out_keys, out_pay, scratch, kept, total, rows, width, nb,
                        tiles, fills, cap, grid, stream);
  else
    launch<false, false>(keys, pay, out_keys, out_pay, scratch, kept, total, rows, width, nb,
                         tiles, fills, cap, grid, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: rows / nb output rows of cap slots; kept and total are (rows / nb,).
extern "C" int v2ce_merge_rows(const int* keys, const int* pay, int* out_keys, int* out_pay,
                               unsigned long long* scratch, int* kept, int* total, int rows,
                               int width, int nb, int cap, int tiles, int fills,
                               long long words, cudaStream_t stream) {
  if (nb <= 0 || rows % nb) return (int)cudaErrorInvalidValue;
  return merge(keys, pay, out_keys, out_pay, scratch, kept, total, rows, width, nb,
               rows / nb, cap, tiles, fills, words, stream);
}

// K5: all rows into one (one group of nb = rows); cap is already rounded up
// to the chunk.
extern "C" int v2ce_append_rows(const int* keys, const int* pay, int* out_keys,
                                int* out_pay, unsigned long long* scratch, int* kept,
                                int* total, int rows, int width, int cap, int tiles,
                                int fills, long long words, cudaStream_t stream) {
  return merge(keys, pay, out_keys, out_pay, scratch, kept, total, rows, width, rows, 1, cap,
               tiles, fills, words, stream);
}
