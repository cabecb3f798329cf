// K13, K14: the vector-op ceiling probes of the stage-2 roofline, on an
// int32 (r, n_chunks, sc, 128) array (the chain compaction's grid: 144
// rows of 11 chunks of 16,384 keys).
//
//   K13 op_chain (`tools/perf_probe.py:2510 make_op_kernel`, `pallas_call` at
//       :2529): every (sc, 128) tile runs k/4 rounds of lane-roll by 1, XOR
//       with the lane index, sublane-roll by 1, +1 where lane >= 64; the
//       output (r, sc, 128) is each row's last-chunk tile;
//   K14 op_chain_ilp (`:2554 make_ilp_kernel`, `pallas_call` at :2573): the
//       same on 4 independent chains x + i, k/16 rounds each, the output the
//       XOR of the four.
// Python wrappers and plain twins (`torch.roll`): `ops/roofline.py`.
//
// What the probes measure. A round moves each element one lane and one
// sublane on, so an element's chain never meets another's, and the rolls
// are a change of position, not of data: the element that starts at lane j0
// meets lane j = (j0 + rd) mod 128 in round rd, XORs it in and adds bit 6
// of it. K13 is the card's issue rate on strictly dependent int32 chains,
// whose latency the warps and the chains of a thread hide, as the 16 vregs
// of the TPU's tile do; K14 is what four chains an element add on top.
//
// Bound on an H100 SXM: operations, the two ops a round that touch data
// (the XOR and the add), so k/2 an element of every chunk for both kernels,
// at the card's issue rate of one-lane ops (132 SMs x 4 schedulers x 32
// lanes a clock). A scheduler issues one warp instruction a clock; its ALU
// pipe (LOP3, shifts, compares) and its FMA pipe (IMAD) each take half of
// that, so the rate needs both: the XOR is a LOP3 that also masks the lane,
// the add an IMAD by `one`, a kernel parameter the launcher sets to 1, which
// the compiler cannot fold into an ALU add. The bytes (x read once, the last
// tiles written) take a third of the operations' time at k = 256; at k = 64
// they bound it.
//
// Design. A thread carries kLive chains that share one lane j0: kLive /
// kChains consecutive (chunk, sublane) positions m = chunk * sc + i of one
// row, so one position update a round (j + 1, and bit 6 of j) serves all of
// them; K13 keeps 32 chains (32 positions) at 4 blocks an SM, K14 64 (16
// positions x 4 chains) at 2, the counts the measured times chose (PERF.md).
// The chains run in two halves half a round apart, so that XORs and adds
// alternate in the loop. A warp's 32 threads take 32 neighbouring lanes
// (128-byte loads). A work item is (row, kLive / kChains positions, 32
// lanes); the blocks are persistent (as many as fit the card at once) and
// each warp walks the items with the grid's stride, the next item's loads
// (4-byte cp.async into the thread's own shared-memory slots) in flight
// under the current item's chains. At the probe grid every warp takes the
// same number of items (K13 6, K14 24), so no partial wave is left, and the
// items of the last chunk, the only ones that store, are spread over the
// warps. As on the TPU, every chunk's tile is computed and only the last one
// stored: the other results are XORed into a word that the kernel writes
// only where it has bits under `sink` (0 from the launcher), so no compiler
// can drop their chains.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using v2ce_hopper::cp_async4;
using v2ce_hopper::cp_async_wait_all;
using v2ce_hopper::smem_u32;

constexpr int kThreads = 256;
constexpr int kLanes = 128;
// chains a thread keeps and blocks an SM, K13 and K14: 4 blocks of 256
// threads leave a thread 64 registers, 2 blocks 128
constexpr int kLive13 = 32, kBlocks13 = 4;
constexpr int kLive14 = 64, kBlocks14 = 2;
constexpr int kMaxDevices = 16;

// the round's two data ops on one chain: v ^ (j & 127) as one LOP3 (ALU
// pipe), then v * one + b as one IMAD (FMA pipe)
__device__ __forceinline__ void xor_lane(uint32_t& v, uint32_t j) {
  asm("lop3.b32 %0, %0, %1, %2, 0x78;" : "+r"(v) : "r"(j), "r"(127u));
}
__device__ __forceinline__ void add_bit(uint32_t& v, uint32_t b, uint32_t one) {
  asm("mad.lo.u32 %0, %0, %1, %2;" : "+r"(v) : "r"(one), "r"(b));
}

// `rounds` rounds on every chain; j0 is the lane the chains start at. The
// chains run in two halves half a round apart, so that every XOR of one
// half sits beside an add of the other and the two pipes issue in turn:
//   A: x . + x . + x . +       (x the XOR, + the add of a round)
//   B: . x . + x . + x . +
template <int kLive>
__device__ __forceinline__ void run_rounds(uint32_t (&v)[kLive], uint32_t j0, int rounds,
                                           uint32_t one) {
  constexpr int kHalf = kLive / 2;
  if (rounds <= 0) return;
  uint32_t j = j0 + 1u;                    // the lane round 1 meets (unmasked)
  uint32_t b = (j >> 6) & 1u;              // +1 where that lane >= 64
#pragma unroll
  for (int c = 0; c < kHalf; ++c) xor_lane(v[c], j);
  for (int rd = 1; rd < rounds; ++rd) {
    const uint32_t jn = j + 1u;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      add_bit(v[c], b, one);
      xor_lane(v[kHalf + c], j);
    }
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      xor_lane(v[c], jn);
      add_bit(v[kHalf + c], b, one);
    }
    j = jn;
    b = (j >> 6) & 1u;
  }
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    add_bit(v[c], b, one);
    xor_lane(v[kHalf + c], j);
  }
#pragma unroll
  for (int c = 0; c < kHalf; ++c) add_bit(v[kHalf + c], b, one);
}

// a work item: kE positions from m0 of one row, at lanes 32 lg .. 32 lg + 31
struct Item {
  int row, m0, lg;
};

template <int kChains, int kLive, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
op_chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int r, int n_chunks,
                int sc, int rounds, int groups, uint32_t one, uint32_t sink) {
  constexpr int kE = kLive / kChains;      // positions a thread carries
  extern __shared__ uint32_t stage[];      // [kE][kThreads]
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  const int m_all = n_chunks * sc, m_last = m_all - sc;
  const int items = r * groups * 4;

  // items run lane group fastest (neighbouring warps read neighbouring
  // 128-byte pieces of a row), then row, then position: a warp's items lie
  // a grid's stride apart, so the last chunk's items, the only ones that
  // store, are spread over the warps instead of falling to the same warps
  // in every pass
  auto item_of = [&](int it) {
    const int q = it >> 2;
    return Item{q % r, (q / r) * kE, it & 3};
  };
  // an item's loads into this thread's slots, 4-byte cp.async; positions
  // past the row are zero filled
  auto fetch = [&](const Item& w) {
    const uint32_t* src = x + ((long long)w.row * m_all + w.m0) * kLanes + w.lg * 32 + lane;
    const uint32_t dst = smem_u32(&stage[threadIdx.x]);
    const int valid = min(kE, m_all - w.m0);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      cp_async4(dst + e * (kThreads * 4), e < valid ? src + e * kLanes : src, e < valid);
  };

  uint32_t others = 0;
  int it = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  Item w = item_of(it);
  if (it < items) fetch(w);
  for (; it < items; it += warps) {
    cp_async_wait_all();
    uint32_t v[kLive];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const uint32_t x0 = stage[e * kThreads + threadIdx.x];
#pragma unroll
      for (int c = 0; c < kChains; ++c) v[e * kChains + c] = x0 + (uint32_t)c;
    }
    // the next item's loads, in flight under this item's chains
    const Item cur = w;
    if (it + warps < items) {
      w = item_of(it + warps);
      fetch(w);
    }
    const uint32_t j0 = (uint32_t)(cur.lg * 32 + lane);
    run_rounds(v, j0, rounds, one);

    uint32_t res[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      res[e] = v[e * kChains];
#pragma unroll
      for (int c = 1; c < kChains; ++c) res[e] ^= v[e * kChains + c];
    }
    if (cur.m0 + kE <= m_last) {           // no last-chunk position: the common item
#pragma unroll
      for (int e = 0; e < kE; ++e) others ^= res[e];
    } else {
      // the tile rolled by `rounds`: position (i, j0) of the last chunk
      // lands at ((i + rounds) mod sc, (j0 + rounds) mod 128)
      const int t = (cur.m0 - m_last + rounds) % sc;
      const int i0 = t < 0 ? t + sc : t;
      uint32_t* o = out + (long long)cur.row * sc * kLanes +
                    ((j0 + (uint32_t)rounds) & (kLanes - 1));
      if (cur.m0 >= m_last && cur.m0 + kE <= m_all && kE <= sc) {
#pragma unroll                             // all kE in the last chunk: one wrap at most
        for (int e = 0; e < kE; ++e) {
          const int i = i0 + e < sc ? i0 + e : i0 + e - sc;
          o[i * kLanes] = res[e];
        }
      } else {
        int i = i0;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int m = cur.m0 + e;
          if (m < m_last) others ^= res[e];
          else if (m < m_all) o[(long long)i * kLanes] = res[e];
          if (++i == sc) i = 0;
        }
      }
    }
  }
  if (others & sink) atomicXor(out, others & sink);
}

template <int kChains, int kLive, int kBlocks>
int launch(const void* x, void* out, int r, int n_chunks, int sc, int rounds,
           cudaStream_t stream) {
  if (r <= 0 || n_chunks <= 0 || sc <= 0) return (int)cudaGetLastError();
  if (rounds < 0) return (int)cudaErrorInvalidValue;
  constexpr int kE = kLive / kChains;
  constexpr size_t kSmem = (size_t)kE * kThreads * 4;
  const auto kernel = op_chain_kernel<kChains, kLive, kBlocks>;
  static int fill[kMaxDevices] = {};       // blocks that fit the card at once, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!fill[dev]) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                             kSmem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // kBlocks blocks an SM already give each scheduler kBlocks * 2 warps of
    // kLive independent chains; no more, so that the probe grid's items
    // divide evenly among the warps
    fill[dev] = sms * (per_sm < kBlocks ? per_sm : kBlocks);
  }
  // item indices, positions and the warps' strides are 32-bit
  const long long m_all = (long long)n_chunks * sc;
  const long long groups = (m_all + kE - 1) / kE;
  const long long items = (long long)r * groups * 4;
  if (m_all + kE > INT_MAX || (long long)sc * kLanes > INT_MAX ||
      items + (long long)fill[dev] * (kThreads / 32) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long need = (items + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = (int)(need < fill[dev] ? need : fill[dev]);
  kernel<<<grid, kThreads, kSmem, stream>>>(static_cast<const uint32_t*>(x),
                                           static_cast<uint32_t*>(out), r, n_chunks, sc,
                                           rounds, (int)groups, 1u, 0u);
  return (int)cudaGetLastError();
}

}  // namespace

// k / 4 rounds of one chain
extern "C" int v2ce_op_chain(const void* x, void* out, int r, int n_chunks, int sc, int k,
                             void* stream) {
  return launch<1, kLive13, kBlocks13>(x, out, r, n_chunks, sc, k / 4,
                                      static_cast<cudaStream_t>(stream));
}

// k / 16 rounds of 4 independent chains
extern "C" int v2ce_op_chain_ilp(const void* x, void* out, int r, int n_chunks, int sc, int k,
                                 void* stream) {
  return launch<4, kLive14, kBlocks14>(x, out, r, n_chunks, sc, k / 16,
                                      static_cast<cudaStream_t>(stream));
}
