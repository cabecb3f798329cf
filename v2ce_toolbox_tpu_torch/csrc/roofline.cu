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
// A round moves each element one lane and one sublane on, so an element's
// chain never meets another's: a thread carries one element of the tile
// through its rounds in registers (the rolls become its position, (i + k,
// j + k) mod (sc, 128)), XORs the lane it reaches and adds 1 past lane 63,
// four integer ops a round as the TPU kernel's four vector ops. As on the
// TPU, every chunk's tile is computed and only the last one stored: the
// other chunks' results are XORed into a word that the store masks with
// `sink` (0 from the launcher below), so no compiler can drop or sink their
// chains, and an empty `asm volatile` per round keeps the rounds apart.
//
// Bound on an H100 SXM: operations, k int32 ops an element of every
// chunk (the TPU probe's el-ops), at the card's issue rate (132 SMs x 4
// schedulers x 32 lanes a clock); the bytes (x read once, the last tiles
// written) are far less. The probe reads the rate off the difference of
// two k, which cancels the launch and the loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void round_step(uint32_t& v, uint32_t j) {
  v ^= j;                 // x ^ lane, at the lane the roll moved it to
  v += j >> 6;            // where(lane < 64, x, x + 1)
  asm volatile("" : "+r"(v));
}

template <int kChains>
__global__ void __launch_bounds__(kThreads)
op_chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n_chunks,
                int sc, int rounds, uint32_t sink) {
  const int tile = sc * 128;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= tile) return;
  const int row = blockIdx.y;
  const int i0 = e / 128, j0 = e % 128;
  uint32_t last = 0, others = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const uint32_t x0 = x[((size_t)row * n_chunks + ch) * tile + e];
    uint32_t v[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) v[c] = x0 + (uint32_t)c;
    uint32_t j = (uint32_t)j0;
#pragma unroll 4
    for (int rd = 0; rd < rounds; ++rd) {
      j = (j + 1) & 127u;   // roll by one lane
#pragma unroll
      for (int c = 0; c < kChains; ++c) round_step(v[c], j);
    }
    uint32_t res = v[0];
#pragma unroll
    for (int c = 1; c < kChains; ++c) res ^= v[c];
    if (ch == n_chunks - 1) last = res;
    else others ^= res;
  }
  const int i = (i0 + rounds) % sc, j = (j0 + rounds) % 128;
  out[((size_t)row * sc + i) * 128 + j] = last ^ (others & sink);
}

int launch(int chains, const void* x, void* out, int r, int n_chunks, int sc, int rounds,
           cudaStream_t stream) {
  if (r <= 0 || n_chunks <= 0 || sc <= 0) return (int)cudaGetLastError();
  if (r > 65535 || rounds < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((sc * 128 + kThreads - 1) / kThreads), (unsigned)r);
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (chains == 1)
    op_chain_kernel<1><<<grid, kThreads, 0, stream>>>(xi, o, n_chunks, sc, rounds, 0u);
  else
    op_chain_kernel<4><<<grid, kThreads, 0, stream>>>(xi, o, n_chunks, sc, rounds, 0u);
  return (int)cudaGetLastError();
}

}  // namespace

// k / 4 rounds of one chain
extern "C" int v2ce_op_chain(const void* x, void* out, int r, int n_chunks, int sc, int k,
                             void* stream) {
  return launch(1, x, out, r, n_chunks, sc, k / 4, static_cast<cudaStream_t>(stream));
}

// k / 16 rounds of 4 independent chains
extern "C" int v2ce_op_chain_ilp(const void* x, void* out, int r, int n_chunks, int sc, int k,
                                 void* stream) {
  return launch(4, x, out, r, n_chunks, sc, k / 16, static_cast<cudaStream_t>(stream));
}
