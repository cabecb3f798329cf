// K12: the 3x3x3 stride-1 'same' convolution as Winograd F(4,3) over the
// frame axis L and the row axis H, channels-last, f32 accumulation.
//
// Replaces the Pallas kernel of `v2ce_toolbox_tpu/ops/winograd_pallas.py:204
// conv3d_wino4` (its `_kernel` at :98, `pallas_call` at :239). Python
// wrapper, the filter transform U = G k G^T (f32, then cast to x's dtype)
// and the plain twin: `ops/conv3d_wino4.py`.
//
// Per 4x4 (L, H) output tile (J, I), column w' of the W-padded input and
// channel c, and per (xi, lam) of the 6x6 transform positions:
//   E[lam][r] = sum_s BT[lam][s] x[4J+r-1, 4I+s-1, w'-1, c]     (H transform)
//   V[xi][lam] = sum_r BT[xi][r] E[lam][r]                      (L transform)
//   z[xi, lam][w, co] = sum_dw sum_c V[xi, lam][w+dw, c] U[xi, lam][dw, co, c]
//   y[a][bh]   = sum_lam AT[bh][lam] sum_xi AT[a][xi] z[xi, lam]
//   out[4J+a, 4I+bh, w, co] = y[a][bh][w, co]
// The transforms run in the JAX kernel's term order (`_lincomb`), every
// product and partial sum rounded to x's dtype as the JAX kernel's bf16
// arithmetic rounds them; the collapses run in f32 in its order (lam
// outer, xi inner, each z complete before it is collapsed), with no
// contraction. A tile reads padded rows 4J..4J+5 and columns 4I..4I+5
// only, so the JAX kernel's (lt, th) blocks do not change the result and
// the port tiles by 4.
//
// bf16 'full' (`v2ce_conv3d_wino4_bf16`): two launches and the live-step
// pre-pass.
//   1. The input transform: one thread per (tile, w', channel pair)
//      computes its 2 x 36 V values in bf16x2 arithmetic (a bf16 op gives
//      the bits of the f32 op rounded to bf16: double rounding through f32
//      is innocuous for + and x) and writes V (36, M, Cv) in bf16, M = B *
//      ceil(L/4) * ceil(H/4) * (W+2) rows a plane (0.63 GB at the probe's
//      dec3_conv1 shape, (1, 16, 260, 346, 96) -> 32).
//   2. The fused kernel, persistent (one block an SM walks its tiles on one
//      ring). A tile is one (b, J, I), a run of 64 output W positions and
//      32 output channels; the block walks its 36 planes in the JAX
//      kernel's order, lam outer and xi inner. A plane's z is the VALID tap
//      conv of csrc/conv_igemm.cuh with taps (0, 0, dw): a step is one
//      BK-channel slice; its A operand is one TMA box of 72 V rows (rows
//      past W+2 zero-filled) which the three taps read at row offsets dw =
//      0, 1, 2 (the swizzle follows the absolute shared-memory address, so
//      a descriptor one row down reads the next rows); its B operand is U
//      in the core's layout wt[p, dw, co, c] = (36, 3, Co, Cv) (co past Co
//      zero-filled). The step's 3 BK/16 wgmmas sum its 3 BK products an
//      output from zero in the tensor cores; the step sums are added in
//      IEEE f32 in registers, two steps a round (a round may span two
//      planes). When a plane's z is complete the consumers collapse it into
//      p[a], and after xi = 5 p into y[a][bh], and at the end of the tile
//      they store the 16 output phases. Z never leaves the block; the
//      output is the only store.
//      Warpgroups: one producer thread issues the TMA loads (one V box and
//      three U boxes a stage) into a ring behind mbarriers; two consumer
//      warpgroups run the same wgmmas on the same 64 rows, the first
//      keeping a in {0, 1}, the second a in {2, 3}: twice the tensor-core
//      work (0.14 ms of it over the three probe shapes at the bf16 peak)
//      for the register room to keep Z on chip.
//      Registers: a consumer thread holds z, two step sums, two p and four
//      of its eight y, 9 sets of 16 f32 = 144 registers under setmaxnreg
//      232 (the producer 40); its other four y sets, updated once a lam,
//      are parked in shared memory (64 KB for both warpgroups). With all
//      eight y in registers (192) ptxas spills, as it does when the next
//      plane's round is in flight during a collapse.
//      Shared memory: a stage is the V box in a 1024-byte aligned region
//      plus three 32 x BK U boxes, 11 KB at BK = 32 and 21 KB at BK = 64;
//      12 or 7 stages in 160 KB; the parked y; each N tile's live counts and
//      K slices. ops/conv3d_wino4.fused_plan computes the same sizes.
//      Live steps: the core's pre-pass marks each (plane, N tile, dw, K
//      slice) whose 32 x BK block of U is nonzero; a step runs if any of its
//      three dw blocks is live (dense random U marks every step live).
// Summation order against the twin (`_conv3d_wino4_torch`, the JAX order):
// the twin sums each dw's C products apart, collapses the three N = 3Co
// column groups through AT, and adds the three W taps last; this kernel
// adds the dw taps first, inside each step's tensor-core sum, then
// collapses. The same function in another order, inside the f32 tolerance
// (a step still covers BK channels, now for all three taps, so the IEEE
// step adds stay at the old count).
//
// f32 inputs and the probe's ablate='nodot' (`v2ce_conv3d_wino4`): three
// launches through device memory: the input transform (bf16 'nodot' takes
// the bf16x2 one above); the 36 products Z (36, M, N) f32, N = 3 Co,
// through the f32 implicit GEMM of csrc/conv_igemm.cuh (one tap, 36
// planes) -- or, for 'nodot', Z as V's lanes (`lanes`: the V channel of
// each of the 3Co lanes of the JAX kernel's channel padding, -1 for a zero
// pad lane); the output transform, one thread per (tile, w, co), which
// collapses each dw's Z apart and adds the W taps last, as the twin does
// ('nodot' is the twin's ops bit for bit).
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s f32):
// by bytes, x read and the output written once: 0.1375, 0.0687 and 0.0825
// ms at the probe's dec3_conv1, dec2_conv1 and dec3_conv2 shapes, bf16 in
// and f32 out (the Winograd multiply-adds of the TPU kernel's own cost
// estimate, `winograd_pallas.py:264`, take 0.060, 0.060 and 0.020 ms). The
// bf16 design's own floor adds V written and read once: 0.511, 0.259 and
// 0.207 ms (0.977 over the three; 1.14 at the 2.87 TB/s the card's copy
// reaches). The steps' V and U boxes come through L2: 1.81, 1.84 and 0.60
// GB of L2-to-shared traffic at the three shapes (3.11, 3.15 and 1.04
// with a V box a tap). What bounds the fused kernel on the card is neither
// the tensor cores nor those bytes (a V box a tap timed the same, and so
// did BK = 64 steps at C = 96): it is each step's way through the ring and
// the consumers' serial work between rounds (the wait, the IEEE step adds,
// the collapses), with the tensor cores idle meanwhile (PERF.md §6).
// Left: the collapses overlapped with the next round, and the two
// consumer warpgroups splitting N instead of a (no duplicated products):
// both need more registers than the consumers have (ptxas spilled, and
// with a round in flight serialised the wgmmas, C7517/C7518); the input
// transform inside the fused kernel (V from an x slab in shared memory: a
// full-C 6 x 6 x 66 slab is 456 KB at C = 96, so it needs channel slices,
// which reorder the f32 sums); skipping the planes whose AT coefficients
// are zero for a warpgroup's a (xi = 5 for a < 2, xi = 0 for a >= 2).
#include "conv_igemm.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace v2ce_wino4 {
namespace {

using namespace v2ce_hopper;

// the F(4,3) matrices (winograd_pallas.py:47-68), as initialisers of local
// arrays: fully unrolled loops index them with constants, so the zero and
// +-1 tests below fold away
#define V2CE_BT4                                                              \
  {{4, 0, -5, 0, 1, 0}, {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},            \
   {0, -2, -1, 2, 1, 0}, {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}}
#define V2CE_AT4 {{1, 1, 1, 1, 1, 0}, {0, 1, -1, 2, -2, 0}, {0, 1, 1, 4, 4, 0}, {0, 1, -1, 8, -8, 1}}

// sum_i cf[i] * t[i] in the JAX kernel's `_lincomb` order: zeros skipped,
// +-1 folded, left to right (f32; each product and partial sum rounded to f32)
__device__ __forceinline__ float lincomb6(const float (&cf)[6], const float (&t)[6]) {
  float out = 0.f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (cf[i] == 0.f) continue;
    const float term = cf[i] == 1.f ? t[i] : (cf[i] == -1.f ? -t[i] : __fmul_rn(t[i], cf[i]));
    out = first ? term : __fadd_rn(out, term);
    first = false;
  }
  return out;
}

// bf16 pairs as the bits of a bf16x2 register: (f, f), and the bf16 ops on
// them, rounded to nearest. A bf16 op gives the bits of the f32 op rounded
// to bf16: f32's 24 bits are more than 2 x 8 + 2, so rounding twice is
// innocuous for + and x; a negation flips the sign bits.
__device__ __forceinline__ uint32_t bf2(float f) {
  const __nv_bfloat162 h = __float2bfloat162_rn(f);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// lincomb6 on two channels in bf16: each product and partial sum rounded
// to bf16, as the JAX kernel's bf16 arithmetic rounds them
__device__ __forceinline__ uint32_t lincomb6_bf16x2(const float (&cf)[6], const uint32_t (&t)[6]) {
  uint32_t out = 0u;
  bool first = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (cf[i] == 0.f) continue;
    const uint32_t term =
        cf[i] == 1.f ? t[i] : (cf[i] == -1.f ? t[i] ^ 0x80008000u : bf2_mul(t[i], bf2(cf[i])));
    out = first ? term : bf2_add(out, term);
    first = false;
  }
  return out;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// f32: one thread per (tile, w', c) computes its 36 V values from 36 loads
__global__ void __launch_bounds__(256)
wino4_input_kernel(const float* __restrict__ x, float* __restrict__ v, int L, int H, int W, int C,
                   int Cv, int nl, int nh, long long M) {
  const float kBT[6][6] = V2CE_BT4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * Cv) return;
  const int c = (int)(idx % Cv);
  const long long m = idx / Cv;
  long long r = m;
  const int wq = (int)(r % (W + 2));
  r /= (W + 2);
  const int ti = (int)(r % nh);
  r /= nh;
  const int tj = (int)(r % nl);
  const int b = (int)(r / nl);

  float xs[6][6];  // [L row r][H row s]
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const int l = 4 * tj + i - 1, h = 4 * ti + s - 1, w = wq - 1;
      float val = 0.f;
      if (c < C && l >= 0 && l < L && h >= 0 && h < H && w >= 0 && w < W)
        val = x[((((size_t)b * L + l) * H + h) * W + w) * C + c];
      xs[i][s] = val;
    }
#pragma unroll
  for (int lam = 0; lam < 6; ++lam) {
    float e[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = lincomb6(kBT[lam], xs[i]);
#pragma unroll
    for (int xi = 0; xi < 6; ++xi)
      v[((size_t)(xi * 6 + lam) * M + m) * Cv + c] = lincomb6(kBT[xi], e);
  }
}

// bf16: one thread per (tile, w', channel pair) computes its 2 x 36 V values
// from 36 pair loads (one 4-byte load where C is even) and writes them as
// 36 pairs
__global__ void __launch_bounds__(256)
wino4_input_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ v,
                        int L, int H, int W, int C, int Cv, int nl, int nh, long long M) {
  const float kBT[6][6] = V2CE_BT4;
  const int pairs = Cv / 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * pairs) return;
  const int c = 2 * (int)(idx % pairs);
  const long long m = idx / pairs;
  long long r = m;
  const int wq = (int)(r % (W + 2));
  r /= (W + 2);
  const int ti = (int)(r % nh);
  r /= nh;
  const int tj = (int)(r % nl);
  const int b = (int)(r / nl);

  uint32_t xs[6][6];  // [L row r][H row s], channels c and c + 1
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const int l = 4 * tj + i - 1, h = 4 * ti + s - 1, w = wq - 1;
      uint32_t val = 0u;
      if (c < C && l >= 0 && l < L && h >= 0 && h < H && w >= 0 && w < W) {
        const __nv_bfloat16* p = x + ((((size_t)b * L + l) * H + h) * W + w) * C + c;
        if ((C & 1) == 0) {
          val = *reinterpret_cast<const uint32_t*>(p);
        } else {
          val = __bfloat16_as_ushort(p[0]);
          if (c + 1 < C) val |= (uint32_t)__bfloat16_as_ushort(p[1]) << 16;
        }
      }
      xs[i][s] = val;
    }
#pragma unroll
  for (int lam = 0; lam < 6; ++lam) {
    uint32_t e[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = lincomb6_bf16x2(kBT[lam], xs[i]);
#pragma unroll
    for (int xi = 0; xi < 6; ++xi)
      *reinterpret_cast<uint32_t*>(v + ((size_t)(xi * 6 + lam) * M + m) * Cv + c) =
          lincomb6_bf16x2(kBT[xi], e);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
wino4_nodot_kernel(const T* __restrict__ v, float* __restrict__ z, const int* __restrict__ lanes,
                   int Cv, int N, int Np, long long M) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 36 * M * N) return;
  const int j = (int)(idx % N);
  const long long pm = idx / N;  // plane * M + m
  const int src = lanes[j];
  z[pm * Np + j] = src >= 0 ? to_float(v[pm * Cv + src]) : 0.f;
}

// acc (+)= AT[row][k] * t, as the JAX kernel's collapses add it
__device__ __forceinline__ void collapse(float& acc, bool& first, float cf, float t) {
  if (cf == 0.f) return;
  const float term = cf == 1.f ? t : (cf == -1.f ? -t : __fmul_rn(t, cf));
  acc = first ? term : __fadd_rn(acc, term);
  first = false;
}

template <typename OutT>
__global__ void __launch_bounds__(256)
wino4_output_kernel(const float* __restrict__ z, OutT* __restrict__ out, int L, int H, int W,
                    int Co, int Np, int nl, int nh, long long M) {
  const float kAT[4][6] = V2CE_AT4;
  const long long total = M / (W + 2) * W * Co;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = (int)(idx % Co);
  long long r = idx / Co;
  const int w = (int)(r % W);
  r /= W;  // tile (b, J, I)
  const long long mbase = r * (W + 2);
  const int ti = (int)(r % nh);
  r /= nh;
  const int tj = (int)(r % nl);
  const int b = (int)(r / nl);

  float acc[4][4] = {};
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
    const float* zp = z + (size_t)(mbase + w + dw) * Np + dw * Co + co;
    float y[4][4];
    bool yfirst[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bh = 0; bh < 4; ++bh) {
        y[a][bh] = 0.f;
        yfirst[a][bh] = true;
      }
#pragma unroll
    for (int lam = 0; lam < 6; ++lam) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      bool pfirst[4] = {true, true, true, true};
#pragma unroll
      for (int xi = 0; xi < 6; ++xi) {
        const float zz = zp[(size_t)(xi * 6 + lam) * M * Np];
#pragma unroll
        for (int a = 0; a < 4; ++a) collapse(p[a], pfirst[a], kAT[a][xi], zz);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bh = 0; bh < 4; ++bh) collapse(y[a][bh], yfirst[a][bh], kAT[bh][lam], p[a]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bh = 0; bh < 4; ++bh) acc[a][bh] = dw == 0 ? y[a][bh] : __fadd_rn(acc[a][bh], y[a][bh]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bh = 0; bh < 4; ++bh) {
      const int l = 4 * tj + a, h = 4 * ti + bh;
      if (l < L && h < H) store(out + ((((size_t)b * L + l) * H + h) * W + w) * Co + co, acc[a][bh]);
    }
}


// ---------------------------------------------------------------------------
// bf16 'full': the fused products and output transform
// ---------------------------------------------------------------------------

constexpr int FUSED_ROWS = 64;           // output W positions of a block: one m64 tile
constexpr int FUSED_BN = 32;             // output channels of a block
constexpr int FUSED_THREADS = 384;       // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int FUSED_AROWS = 72;          // V rows of a step's box: 64 + 2 for dw, + 6 to 8 rows
constexpr int FUSED_MAX_STAGES = 12;
constexpr int FUSED_MAX_SMEM = 227 * 1024;   // a block's shared memory on sm_90
// the parked y sets: 2 warpgroups x 4 sets x 16 registers x 128 threads, f32
constexpr int FUSED_PARK_BYTES = 2 * 4 * (FUSED_BN / 2) * 128 * 4;

// a stage: the V box in a 1024-byte aligned region, then the three U boxes
__host__ __device__ constexpr int fused_a_region(int bk) {
  return (FUSED_AROWS * bk * 2 + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int fused_stage(int bk) {
  return fused_a_region(bk) + 3 * FUSED_BN * bk * 2;
}

// AT, read at run time (a collapse's coefficient depends on the
// warpgroup and the plane), and the column of each row's first nonzero
// entry
__constant__ float kATrt[4][6] = V2CE_AT4;
__device__ __forceinline__ int at4_first(int r) { return r == 0 ? 0 : 1; }

// acc (+)= cf * t as `collapse` adds it, for a coefficient known at run
// time: nothing where cf is 0, the first term as it is; t * (+-1) is exact,
// so the product stands for the twin's folded +-t
__device__ __forceinline__ float collapse_rt(float acc, float cf, bool first, float t) {
  const float term = __fmul_rn(t, cf);
  return cf == 0.f ? acc : (first ? term : __fadd_rn(acc, term));
}


__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// vmap: V (Cv, W+2, 36 T) in boxes (BK, 72, 1); umap: U (Cv, Cop, 108) in
// boxes (BK, 32, 1); live: the pre-pass's table (36, ntiles, 3, nk). The
// grid: blockIdx.x = (tile * nw + W run) * ntiles + N tile.
template <int BK_, typename OutT>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
wino4_fused_kernel(const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap umap, OutT* __restrict__ out,
                   const unsigned char* __restrict__ live, int L, int H, int W, int Co, int nl,
                   int nh, int nw, int ntiles, int T, int nk, int stages, int n_work) {
  constexpr int BN = FUSED_BN;
  constexpr int SW = BK_ * 2;                // swizzle span = a row of the slice
  constexpr int A_REGION = fused_a_region(BK_), B_BYTES = BN * BK_ * 2;
  constexpr int STAGE = fused_stage(BK_);
  constexpr int NACC = BN / 2;               // f32 registers of a consumer thread's set
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[FUSED_MAX_STAGES], empty[FUSED_MAX_STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  // after the ring: the y sets the consumers park between their updates
  // (see below); per N tile and plane, in walk order, the count of live
  // steps and their K slices
  float* parked = reinterpret_cast<float*>(smem + stages * STAGE);
  int* live_count = reinterpret_cast<int*>(smem + stages * STAGE + FUSED_PARK_BYTES);
  unsigned char* live_list = reinterpret_cast<unsigned char*>(live_count + 36 * ntiles);

  const int tid = threadIdx.x;
  for (int i = tid; i < 36 * ntiles; i += FUSED_THREADS) {
    // walk step q is plane p = 6 xi + lam with lam = q / 6, xi = q % 6
    const int nt = i / 36, q = i % 36, p = (q % 6) * 6 + q / 6;
    const unsigned char* lv = live + ((size_t)p * ntiles + nt) * 3 * nk;
    unsigned char* list = live_list + (size_t)i * nk;
    int count = 0;
    for (int k = 0; k < nk; ++k)
      if (lv[k] | lv[nk + k] | lv[2 * nk + k]) list[count++] = (unsigned char)k;
    live_count[i] = count;
  }
  if (tid == 64) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    // producer warpgroup: one thread keeps the ring full; a step's stage
    // holds V rows w0 .. w0 + 71 of one channel slice (the three dw taps
    // read rows dw .. dw + 63 of it) and the slice's three U boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * 128) {
      prefetch_tensormap(&vmap);
      prefetch_tensormap(&umap);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
        const int nt = t % ntiles, w0 = (t / ntiles) % nw * FUSED_ROWS, tile = t / ntiles / nw;
        const int* count = live_count + nt * 36;
        const unsigned char* list = live_list + (size_t)nt * 36 * nk;
        for (int q = 0; q < 36; ++q) {
          const int p = (q % 6) * 6 + q / 6;
          for (int j = 0; j < count[q]; ++j) {
            const int c0 = list[q * nk + j] * BK_;
            mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
            const uint32_t fb = smem_u32(&full[stage]);
            mbar_expect_tx(fb, FUSED_AROWS * SW + 3 * B_BYTES);
            const uint32_t sa = smem_u32(smem + stage * STAGE);
            tma_load_3d(sa, &vmap, fb, c0, w0, p * T + tile);
            for (int dw = 0; dw < 3; ++dw)
              tma_load_3d(sa + A_REGION + dw * B_BYTES, &umap, fb, c0, nt * BN, p * 3 + dw);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // consumer warpgroups: the block's 64 rows, output phases a = 2 wg + i,
    // i = 0, 1. Registers: z, two step sums (two steps a round), p[i], and
    // y[i][bh] for bh = 0, 1: 9 sets of NACC f32. y[i][2] and y[i][3],
    // updated once a lam, are parked in shared memory, one float a thread
    // and register, so the threads of a warp touch consecutive words.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, wtid = tid % 128;
    float y[4][NACC], pa[2][NACC], z[NACC], s0[NACC], s1[NACC];
    float* park = parked + (size_t)wg * 4 * NACC * 128 + wtid;   // [(2 i + bh - 2) NACC + e] * 128
    int stage = 0;
    uint32_t phase = 0;
    // the block's tiles, one after another on the same ring: the producer
    // loads the next tile's steps while the consumers store this one's
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const int nt = t % ntiles, w0 = (t / ntiles) % nw * FUSED_ROWS, tile = t / ntiles / nw;
      const int n0 = nt * BN;
      const int* count = live_count + nt * 36;
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        z[e] = s0[e] = s1[e] = pa[0][e] = pa[1][e] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          y[i][e] = 0.f;
          park[(i * NACC + e) * 128] = 0.f;
        }
      }

      // wait for the stage, then one step into d: the three dw taps of one
      // channel slice, 3 BK/16 wgmmas, the first from zero, as one group;
      // tap dw reads the V rows dw .. dw + 63 of the stage
      auto issue = [&](float (&d)[NACC]) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t sa = smem_u32(smem + stage * STAGE);
        fence_operands(d);
        wgmma_fence();
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const uint64_t da = smem_desc<SW>(sa + dw * SW);
          const uint64_t db = smem_desc<SW>(sa + A_REGION + dw * B_BYTES);
#pragma unroll
          for (int k = 0; k < BK_ / 16; ++k) wgmma<BN>(d, da + 2 * k, db + 2 * k, dw > 0 || k > 0);
        }
        wgmma_commit();
      };
      auto advance = [&]() {
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      };

      // the walk: plane q (lam = q / 6, xi = q % 6) has `left` steps still to
      // retire; the counts are warp reductions, values the compiler knows to
      // be the same in every lane, so no wgmma sits on a divergent path
      int q = 0;
      int left = (int)__reduce_max_sync(0xffffffffu, (unsigned)count[0]);
      int total = 0;
      for (int i = 0; i < 36; ++i) total += count[i];
      total = (int)__reduce_max_sync(0xffffffffu, (unsigned)total);
      // z is complete for every plane with no step left: collapse xi into
      // p[i], after the last xi lam into y[i][bh], in the JAX kernel's order
      auto finish_planes = [&]() {
        while (left == 0 && q < 36) {
          const int lam = q / 6, xi = q % 6;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int a = 2 * wg + i;
            const float cf = kATrt[a][xi];
            const bool first = xi == at4_first(a);
#pragma unroll
            for (int e = 0; e < NACC; ++e) pa[i][e] = collapse_rt(pa[i][e], cf, first, z[e]);
          }
          if (xi == 5) {
#pragma unroll
            for (int bh = 0; bh < 4; ++bh) {
              const float cf = kATrt[bh][lam];
              const bool first = lam == at4_first(bh);
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < NACC; ++e) {
                  if (bh < 2) {
                    y[2 * i + bh][e] = collapse_rt(y[2 * i + bh][e], cf, first, pa[i][e]);
                  } else {
                    float& yp = park[((2 * i + bh - 2) * NACC + e) * 128];
                    yp = collapse_rt(yp, cf, first, pa[i][e]);
                  }
                }
            }
          }
#pragma unroll
          for (int e = 0; e < NACC; ++e) z[e] = 0.f;
          if (++q < 36) left = (int)__reduce_max_sync(0xffffffffu, (unsigned)count[q]);
        }
      };
      // the step sum d into z, in IEEE f32; free its stage; finish its plane
      // if that was the plane's last step
      auto retire = [&](float (&d)[NACC], int st) {
        fence_operands(d);
#pragma unroll
        for (int e = 0; e < NACC; ++e) z[e] = __fadd_rn(z[e], d[e]);
        mbar_arrive_if(smem_u32(&empty[st]), wtid == 0);
        --left;
        finish_planes();
      };

      finish_planes();                           // leading planes with no live step
      // two steps a round, into s0 and s1, back to back on the tensor cores
      // (the second may open the next plane), both sums retired in step
      // order after wait_group 0: ptxas serialises every wgmma if a sum is
      // read while a later group is in flight (C7514)
      for (int j = 0; j < total; j += 2) {
        const int st0 = stage;
        issue(s0);
        advance();
        const bool two = j + 1 < total;
        int st1 = 0;
        if (two) {
          st1 = stage;
          issue(s1);
          advance();
        }
        wgmma_wait<0>();
        retire(s0, st0);
        if (two) retire(s1, st1);
      }

      // epilogue: thread (warp, g = lane / 4, tig = lane % 4) holds rows
      // 16 warp + g (+8) and columns 8 j + 2 tig (+1) of the 64 x 32 tile,
      // for each of its 8 output phases (a, bh)
      const int lane = tid % 32, g = lane >> 2, tig = lane & 3;
      int rt = tile;
      const int ti = rt % nh;
      rt /= nh;
      const int tj = rt % nl, b = rt / nl;
      const bool even = (Co & 1) == 0;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int bh = 0; bh < 4; ++bh) {
          const int l = 4 * tj + 2 * wg + i, h = 4 * ti + bh;
          if (l >= L || h >= H) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int w = w0 + (wtid / 32) * 16 + g + 8 * half;
            if (w >= W) continue;
            OutT* row = out + ((((size_t)b * L + l) * H + h) * W + w) * Co;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int n = n0 + 8 * j + 2 * tig;
              const int e = 4 * j + 2 * half;
              float v0, v1;
              if (bh < 2) {
                v0 = y[2 * i + bh][e];
                v1 = y[2 * i + bh][e + 1];
              } else {
                v0 = park[((2 * i + bh - 2) * NACC + e) * 128];
                v1 = park[((2 * i + bh - 2) * NACC + e + 1) * 128];
              }
              if (even) {
                if (n < Co) store2(row + n, v0, v1);
              } else {
                if (n < Co) store(row + n, v0);
                if (n + 1 < Co) store(row + n + 1, v1);
              }
            }
          }
        }
    }
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// the fused kernel's dynamic shared memory: the ring, 1024-byte aligned,
// the parked y sets and each N tile's live counts and K slices
inline size_t fused_smem(int bk, int stages, int nk, int ntiles) {
  return 1024 + (size_t)stages * fused_stage(bk) + FUSED_PARK_BYTES +
         (size_t)36 * ntiles * (4 + nk);
}

template <int BK_, typename OutT>
int launch_fused(const CUtensorMap& vmap, const CUtensorMap& umap, void* out,
                 const unsigned char* live, int L, int H, int W, int Co, int nl, int nh, int nw,
                 int ntiles, int T, int nk, int stages, cudaStream_t stream) {
  auto kernel = wino4_fused_kernel<BK_, OutT>;
  const size_t smem = fused_smem(BK_, stages, nk, ntiles);
  // the kernel's static shared memory, and on each device its SM count
  // (the persistent grid) and all the dynamic memory a block can have,
  // granted once (not each call)
  static size_t static_smem = 0;
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (sms[dev] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    static_smem = attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FUSED_MAX_SMEM - (int)static_smem);
    if (err != cudaSuccess) return (int)err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  if (smem + static_smem > (size_t)FUSED_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long n_work = (long long)T * nw * ntiles;
  if (n_work >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_work < sms[dev] ? n_work : sms[dev]);
  kernel<<<grid, FUSED_THREADS, smem, stream>>>(vmap, umap, static_cast<OutT*>(out), live, L, H,
                                                W, Co, nl, nh, nw, ntiles, T, nk, stages,
                                                (int)n_work);
  return (int)cudaGetLastError();
}

inline unsigned blocks(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

// f32 'full' and 'nodot' (either dtype): x (B, L, H, W, C) and ut (36, Np,
// Cv) in x's dtype (0 = f32, 1 = bf16); scratch v (36, M, Cv) in x's dtype
// and z (36, M, Np) f32; lanes (3 Co) int32; out (B, L, H, W, Co) in
// dtype_out. mode 0 = full (f32 inputs only), 1 = nodot.
int three_launches(const void* x, const void* ut, void* v, float* z, const int* lanes, void* out,
                   int B, int L, int H, int W, int C, int Cv, int Co, int Np, int mode,
                   int dtype_in, int dtype_out, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  if (dtype_in < 0 || dtype_in > 1 || dtype_out < 0 || dtype_out > 1 || mode < 0 || mode > 1 ||
      (mode == 0 && dtype_in != 0) || Cv % 8 || Np % 8 || Np < 3 * Co)
    return (int)cudaErrorInvalidValue;
  const int nl = (L + 3) / 4, nh = (H + 3) / 4;
  const long long M = (long long)B * nl * nh * (W + 2);
  if (dtype_in == 0)
    wino4_input_kernel<<<blocks(M * Cv), 256, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(v), L, H, W, C, Cv, nl, nh, M);
  else
    wino4_input_bf16_kernel<<<blocks(M * Cv / 2), 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(v), L, H, W, C, Cv,
        nl, nh, M);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long N = 3LL * Co;
  if (mode == 0) {
    v2ce_conv::Taps taps;
    taps.n = 1;
    taps.per_plane = 0;
    taps.d[0][0][0] = taps.d[0][0][1] = taps.d[0][0][2] = 0;
    err = v2ce_conv::launch_conv_taps(v, ut, z, nullptr, 0, 1, 1, 1, (int)M, 1, 1, (int)M, Cv,
                                      Np, 36, M * Cv, taps, 0, 0, 0, 0, stream);
  } else {
    if (dtype_in == 0)
      wino4_nodot_kernel<float><<<blocks(36 * M * N), 256, 0, stream>>>(
          static_cast<const float*>(v), z, lanes, Cv, (int)N, Np, M);
    else
      wino4_nodot_kernel<__nv_bfloat16><<<blocks(36 * M * N), 256, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(v), z, lanes, Cv, (int)N, Np, M);
    err = (int)cudaGetLastError();
  }
  if (err) return err;
  const long long n_out = (long long)B * nl * nh * W * Co;
  if (dtype_out == 0)
    wino4_output_kernel<float><<<blocks(n_out), 256, 0, stream>>>(
        z, static_cast<float*>(out), L, H, W, Co, Np, nl, nh, M);
  else
    wino4_output_kernel<__nv_bfloat16><<<blocks(n_out), 256, 0, stream>>>(
        z, static_cast<__nv_bfloat16*>(out), L, H, W, Co, Np, nl, nh, M);
  return (int)cudaGetLastError();
}

// bf16 'full': x (B, L, H, W, C) and ut (36, 3, Cop, Cv) bf16, U in the
// conv core's wt[p, dw, co, c] layout (Cop >= Co and Cv >= C multiples of
// 8, zero padded); scratch v (36, M, Cv) bf16; live the pre-pass's table of
// at least 36 * ceil(Cop/32) * 3 * ceil(Cv/bk) bytes; out (B, L, H, W, Co)
// in dtype_out. bk (32 or 64) and stages (1-12) as ops/conv3d_wino4.fused_plan
// picks them. Launches the input transform, the live-step pre-pass and the
// fused kernel.
int fused(const void* x, const void* ut, void* v, void* out, unsigned char* live,
          long long live_bytes, int B, int L, int H, int W, int C, int Cv, int Co, int Cop, int bk,
          int stages, int dtype_out, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  const int nk = cdiv(Cv, bk > 0 ? bk : 1), ntiles = cdiv(Cop, FUSED_BN);
  if (dtype_out < 0 || dtype_out > 1 || (bk != 32 && bk != 64) || C > Cv || Cv % 8 ||
      Cop % 8 || Cop < Co || stages < 1 || stages > FUSED_MAX_STAGES || nk > 255 ||
      live == nullptr || (long long)36 * ntiles * 3 * nk > live_bytes ||
      reinterpret_cast<uintptr_t>(ut) % 16 || reinterpret_cast<uintptr_t>(v) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int nl = (L + 3) / 4, nh = (H + 3) / 4, nw = cdiv(W, FUSED_ROWS);
  const long long T = (long long)B * nl * nh, M = T * (W + 2);
  if (36 * T >= (1LL << 31)) return (int)cudaErrorInvalidValue;

  wino4_input_bf16_kernel<<<blocks(M * Cv / 2), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(v), L, H, W, C, Cv, nl,
      nh, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // V as (Cv, W+2, 36 T) read in boxes (bk, 72, 1); U as (Cv, Cop, 36 * 3)
  // in boxes (bk, 32, 1)
  CUtensorMap vmap, umap;
  const cuuint64_t vdims[3] = {(cuuint64_t)Cv, (cuuint64_t)W + 2, (cuuint64_t)(36 * T)};
  const cuuint64_t vstr[2] = {(cuuint64_t)Cv * 2, (cuuint64_t)(W + 2) * Cv * 2};
  const cuuint32_t vbox[3] = {(cuuint32_t)bk, (cuuint32_t)FUSED_AROWS, 1};
  const cuuint64_t udims[3] = {(cuuint64_t)Cv, (cuuint64_t)Cop, 108};
  const cuuint64_t ustr[2] = {(cuuint64_t)Cv * 2, (cuuint64_t)Cop * Cv * 2};
  const cuuint32_t ubox[3] = {(cuuint32_t)bk, (cuuint32_t)FUSED_BN, 1};
  if (!encode(&vmap, v, 3, vdims, vstr, vbox, bk) || !encode(&umap, ut, 3, udims, ustr, ubox, bk))
    return (int)cudaErrorInvalidValue;

  live_steps_kernel<<<dim3((unsigned)cdiv(3 * nk, 8), (unsigned)ntiles, 36), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(ut), live, 3, Cv, Cop, FUSED_BN, bk, nk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

#define V2CE_FUSED(BK_, OutT)                                                                  \
  return launch_fused<BK_, OutT>(vmap, umap, out, live, L, H, W, Co, nl, nh, nw, ntiles, (int)T, \
                                 nk, stages, stream)
  if (bk == 64) {
    if (dtype_out == 0) V2CE_FUSED(64, float);
    V2CE_FUSED(64, __nv_bfloat16);
  }
  if (dtype_out == 0) V2CE_FUSED(32, float);
  V2CE_FUSED(32, __nv_bfloat16);
#undef V2CE_FUSED
}

}  // namespace v2ce_wino4

extern "C" int v2ce_conv3d_wino4(const void* x, const void* ut, void* v, float* z,
                                 const int* lanes, void* out, int B, int L, int H, int W, int C,
                                 int Cv, int Co, int Np, int mode, int dtype_in, int dtype_out,
                                 void* stream) {
  return v2ce_wino4::three_launches(x, ut, v, z, lanes, out, B, L, H, W, C, Cv, Co, Np, mode,
                                    dtype_in, dtype_out, static_cast<cudaStream_t>(stream));
}

extern "C" int v2ce_conv3d_wino4_bf16(const void* x, const void* ut, void* v, void* out,
                                      unsigned char* live, long long live_bytes, int B, int L,
                                      int H, int W, int C, int Cv, int Co, int Cop, int bk,
                                      int stages, int dtype_out, void* stream) {
  return v2ce_wino4::fused(x, ut, v, out, live, live_bytes, B, L, H, W, C, Cv, Co, Cop, bk,
                           stages, dtype_out, static_cast<cudaStream_t>(stream));
}
