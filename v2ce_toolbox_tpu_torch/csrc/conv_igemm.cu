// The kernels of the shared implicit-GEMM convolution (K9, K10, K11 and
// K12's f32 product); the design note is in csrc/conv_igemm.cuh, the
// Hopper helpers in csrc/hopper.cuh.
#include "conv_igemm.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace v2ce_conv {
namespace {

using namespace v2ce_hopper;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_out2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// ---------------------------------------------------------------------------
// f32 inputs: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;

struct Tile {
  static constexpr int VEC = 4;                      // floats per 16-byte vector
  static constexpr int BKP = BK + VEC;               // padded smem row (16-byte aligned)
  static constexpr int VPR = BK / VEC;               // vectors per row of a step
  static constexpr int ROWS_PER_PASS = THREADS / VPR;
  static constexpr int A_ITERS = BM / ROWS_PER_PASS;
  static constexpr int B_ITERS = BN / ROWS_PER_PASS;
};

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
conv_taps_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                     OutT* __restrict__ out, int B, int Li, int Hi, int Wi, int Lo, int Ho,
                     int Wo, int C, int Co, int planes, long long x_plane_stride, Taps taps) {
  using T = float;
  using TL = Tile;
  __shared__ __align__(16) T As[BM][TL::BKP];
  __shared__ __align__(16) T Bs[BN][TL::BKP];

  const int tid = threadIdx.x;
  const int p = blockIdx.z;
  const int tp = taps.per_plane ? p : 0;
  x += p * x_plane_stride;
  const long long M = (long long)B * Lo * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int vcol = (tid % TL::VPR) * TL::VEC;       // this thread's channel offset in a step
  const int rbase = tid / TL::VPR;

  // the output positions of the rows this thread gathers
  int r_b[TL::A_ITERS], r_l[TL::A_ITERS], r_h[TL::A_ITERS], r_w[TL::A_ITERS];
#pragma unroll
  for (int s = 0; s < TL::A_ITERS; ++s) {
    long long m = m0 + rbase + s * TL::ROWS_PER_PASS;
    if (m < M) {
      r_w[s] = (int)(m % Wo);
      long long t = m / Wo;
      r_h[s] = (int)(t % Ho);
      t /= Ho;
      r_l[s] = (int)(t % Lo);
      r_b[s] = (int)(t / Lo);
    } else {
      r_b[s] = -1;
      r_l[s] = r_h[s] = r_w[s] = 0;
    }
  }

  const int nc = (C + BK - 1) / BK;
  const int steps = taps.n * nc;
  uint4 ra[TL::A_ITERS], rb[TL::B_ITERS];

  auto load = [&](int step) {
    const int t = step / nc;
    const int c = (step % nc) * BK + vcol;
    const int dl = taps.d[tp][t][0], dh = taps.d[tp][t][1], dw = taps.d[tp][t][2];
#pragma unroll
    for (int s = 0; s < TL::A_ITERS; ++s) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const int l2 = r_l[s] + dl, h2 = r_h[s] + dh, w2 = r_w[s] + dw;
      if (r_b[s] >= 0 && c < C && l2 >= 0 && l2 < Li && h2 >= 0 && h2 < Hi && w2 >= 0 &&
          w2 < Wi) {
        const size_t off = ((((size_t)r_b[s] * Li + l2) * Hi + h2) * Wi + w2) * C + c;
        v = __ldg(reinterpret_cast<const uint4*>(x + off));
      }
      ra[s] = v;
    }
#pragma unroll
    for (int s = 0; s < TL::B_ITERS; ++s) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const int n = n0 + rbase + s * TL::ROWS_PER_PASS;
      if (n < Co && c < C) {
        const size_t off = (((size_t)p * taps.n + t) * Co + n) * C + c;
        v = __ldg(reinterpret_cast<const uint4*>(wt + off));
      }
      rb[s] = v;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int s = 0; s < TL::A_ITERS; ++s)
      *reinterpret_cast<uint4*>(&As[rbase + s * TL::ROWS_PER_PASS][vcol]) = ra[s];
#pragma unroll
    for (int s = 0; s < TL::B_ITERS; ++s)
      *reinterpret_cast<uint4*>(&Bs[rbase + s * TL::ROWS_PER_PASS][vcol]) = rb[s];
  };

  // the output row offset of (bl, h, p, w): ((bl * Ho + h) * planes + p) * Wo + w
  auto out_row = [&](long long m) -> size_t {
    const long long w = m % Wo, t = m / Wo;
    return ((size_t)t * planes + p) * Wo + w;
  };

  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int step = 0; step < steps; ++step) {
    stage();
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
    float part[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(&As[ty + 16 * i][k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(&Bs[tx + 16 * j][k]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = part[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          part[i][j] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const size_t row = out_row(m) * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Co) store_out(out + row + n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: TMA ring, wgmma, live steps
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;               // rows of a block: two consumer warpgroups of 64
constexpr int WG_THREADS = 384;          // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int MAX_STAGES = 8;
constexpr int STAGE_BUDGET = 192 * 1024; // shared memory for the ring
constexpr int MAX_SMEM = 227 * 1024;     // a block's dynamic shared memory on sm_90

// the block's rows: a box of (bw, bh, bl) output positions, and the number
// of boxes along W, H and L
struct Box {
  int bw, bh, bl, tw, th, tl;
};

template <int BN_, int BK_, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv_taps_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, OutT* __restrict__ out,
                       const unsigned char* __restrict__ live, int B, int Lo, int Ho, int Wo,
                       int Co, int planes, int x_planes, Box box, int nk, int stages,
                       Taps taps) {
  constexpr int A_BYTES = WG_BM * BK_ * 2, B_BYTES = BN_ * BK_ * 2;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr int SW = BK_ * 2;                // swizzle span = a row of the slice
  constexpr int NACC = BN_ / 2;              // f32 accumulators of a consumer thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ signed char tap_d[MAX_TAPS][3];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  // after the ring: the block's live flags, then the live steps in order
  unsigned char* flags = smem + stages * STAGE;
  uint16_t* list = reinterpret_cast<uint16_t*>(flags + (taps.n * nk + 15) / 16 * 16);
  __shared__ int n_live;

  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int ntiles = (Co + BN_ - 1) / BN_;
  const int nt = blockIdx.x % ntiles;
  int mt = blockIdx.x / ntiles;
  const int bx = mt % box.tw;
  mt /= box.tw;
  const int by = mt % box.th;
  mt /= box.th;
  const int bz = mt % box.tl;
  const int b = mt / box.tl;
  const int w0 = bx * box.bw, h0 = by * box.bh, l0 = bz * box.bl, n0 = nt * BN_;
  const int steps = taps.n * nk;

  const unsigned char* lv = live + ((size_t)p * ntiles + nt) * steps;
  for (int i = tid; i < steps; i += WG_THREADS) flags[i] = lv[i];
  const int tp = taps.per_plane ? p : 0;
  if (tid < taps.n * 3) tap_d[tid / 3][tid % 3] = taps.d[tp][tid / 3][tid % 3];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32) {
    // warp 0 lists the live steps in order
    int count = 0;
    for (int base = 0; base < steps; base += 32) {
      const int s = base + tid;
      const bool f = s < steps && flags[s];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[count + __popc(m & ((1u << tid) - 1u))] = (uint16_t)s;
      count += __popc(m);
    }
    if (tid == 0) n_live = count;
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * 128) {
      prefetch_tensormap(&xmap);
      prefetch_tensormap(&wmap);
      const int xb = x_planes > 1 ? p * B + b : b;
      const int n = n_live;
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n; ++j) {
        const int s = list[j], t = s / nk, c0 = (s % nk) * BK_;
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t fb = smem_u32(&full[stage]);
        mbar_expect_tx(fb, STAGE);
        const uint32_t sa = smem_u32(smem + stage * STAGE);
        tma_load_5d(sa, &xmap, fb, c0, w0 + tap_d[t][2], h0 + tap_d[t][1], l0 + tap_d[t][0],
                    xb);
        tma_load_3d(sa + A_BYTES, &wmap, fb, c0, n0, p * taps.n + t);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups 0 and 1: rows 64 wg .. 64 wg + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, wtid = tid % 128;
    float acc[NACC], p0[NACC], p1[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = p0[i] = p1[i] = 0.f;
    const uint32_t a_off = wg * (A_BYTES / 2);
    int stage = 0;
    uint32_t phase = 0;
    // the live-step count as a warp reduction: a value the compiler knows
    // to be the same in every lane, so no wgmma sits on a divergent path
    const int n = (int)__reduce_max_sync(0xffffffffu, (unsigned)n_live);

    // wait for the stage, then this step's BK/16 wgmmas into d, the first
    // from zero, as one group
    auto issue = [&](float (&d)[NACC]) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint32_t sa = smem_u32(smem + stage * STAGE);
      const uint64_t da = smem_desc<SW>(sa + a_off), db = smem_desc<SW>(sa + A_BYTES);
      fence_operands(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK_ / 16; ++k) wgmma<BN_>(d, da + 2 * k, db + 2 * k, k > 0);
      wgmma_commit();
    };
    // the step sum d into the running sum, in IEEE f32; then free its stage
    auto retire = [&](float (&d)[NACC], int st) {
      fence_operands(d);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
      mbar_arrive_if(smem_u32(&empty[st]), wtid == 0);
    };
    auto advance = [&]() {
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    };

    // two steps a round, into p0 and p1, back to back on the tensor cores,
    // then both sums added in step order: ptxas serialises every wgmma
    // (C7514) when a sum is read while a later group is still in flight,
    // so the sums are read only after wait_group 0
    for (int j = 0; j < n; j += 2) {
      const int s0 = stage;
      issue(p0);
      advance();
      const bool two = j + 1 < n;
      int s1 = 0;
      if (two) {
        s1 = stage;
        issue(p1);
        advance();
      }
      wgmma_wait<0>();
      retire(p0, s0);
      if (two) retire(p1, s1);
    }

    // epilogue: thread (warp, g = lane / 4, tig = lane % 4) holds rows
    // 16 warp + g (+8) and columns 8 j + 2 tig (+1) of its warpgroup's 64
    const int lane = tid % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wg * 64 + (wtid / 32) * 16 + g + 8 * half;
      const int w = w0 + r % box.bw, h = h0 + (r / box.bw) % box.bh,
                l = l0 + r / (box.bw * box.bh);
      if (w >= Wo || h >= Ho || l >= Lo) continue;
      OutT* row = out + (((((size_t)b * Lo + l) * Ho + h) * planes + p) * Wo + w) * Co;
#pragma unroll
      for (int j = 0; j < BN_ / 8; ++j) {
        const int n = n0 + 8 * j + 2 * tig;
        if (n < Co) store_out2(row + n, acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// The box of 128 output positions with the fewest rows past the output's
// edges; within 3% of that, the widest along W, then H.
Box choose_box(int Lo, int Ho, int Wo) {
  auto padded = [&](int bw, int bh, int bl) {
    return (long long)cdiv(Wo, bw) * bw * cdiv(Ho, bh) * bh * cdiv(Lo, bl) * bl;
  };
  long long least = -1;
  for (int bw = WG_BM; bw >= 1; bw /= 2)
    for (int bh = WG_BM / bw; bh >= 1; bh /= 2) {
      const long long v = padded(bw, bh, WG_BM / (bw * bh));
      if (least < 0 || v < least) least = v;
    }
  for (int bw = WG_BM; bw >= 1; bw /= 2)
    for (int bh = WG_BM / bw; bh >= 1; bh /= 2) {
      const int bl = WG_BM / (bw * bh);
      if (padded(bw, bh, bl) * 100 <= least * 103)
        return Box{bw, bh, bl, cdiv(Wo, bw), cdiv(Ho, bh), cdiv(Lo, bl)};
    }
  return Box{WG_BM, 1, 1, cdiv(Wo, WG_BM), Ho, Lo};
}

template <int BN_, int BK_, typename OutT>
int launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, void* out,
                 const unsigned char* live, int B, int Lo, int Ho, int Wo, int Co, int planes,
                 int x_planes, const Box& box, int nk, const Taps& taps, cudaStream_t stream) {
  constexpr int STAGE = (WG_BM + BN_) * BK_ * 2;
  const int stages = STAGE_BUDGET / STAGE < MAX_STAGES ? STAGE_BUDGET / STAGE : MAX_STAGES;
  const int steps = taps.n * nk;
  const size_t smem =
      1024 + (size_t)stages * STAGE + (size_t)(steps + 15) / 16 * 16 + (size_t)(2 * steps + 15) / 16 * 16;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = conv_taps_wgmma_kernel<BN_, BK_, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * box.tl * box.th * box.tw * cdiv(Co, BN_);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, (unsigned)planes), WG_THREADS, smem, stream>>>(
      xmap, wmap, static_cast<OutT*>(out), live, B, Lo, Ho, Wo, Co, planes, x_planes, box, nk,
      stages, taps);
  return (int)cudaGetLastError();
}

template <int BN_, int BK_>
int launch_wgmma_out(int dtype_out, const CUtensorMap& xmap, const CUtensorMap& wmap,
                     void* out, const unsigned char* live, int B, int Lo, int Ho, int Wo,
                     int Co, int planes, int x_planes, const Box& box, int nk,
                     const Taps& taps, cudaStream_t stream) {
  if (dtype_out == 0)
    return launch_wgmma<BN_, BK_, float>(xmap, wmap, out, live, B, Lo, Ho, Wo, Co, planes,
                                         x_planes, box, nk, taps, stream);
  return launch_wgmma<BN_, BK_, __nv_bfloat16>(xmap, wmap, out, live, B, Lo, Ho, Wo, Co,
                                               planes, x_planes, box, nk, taps, stream);
}

int launch_bf16(const void* x, const void* wt, void* out, unsigned char* live,
                long long live_bytes, int B, int Li, int Hi, int Wi, int Lo, int Ho, int Wo,
                int C, int Co, int planes, long long x_plane_stride, const Taps& taps, int bn,
                int bk, int dtype_out, cudaStream_t stream) {
  if ((bn != 32 && bn != 64 && bn != 128) || (bk != 32 && bk != 64) || C % 8 || Co % 8 ||
      taps.n < 1 || taps.n > MAX_TAPS || planes < 1 || planes > 65535 || live == nullptr ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const long long plane_elems = (long long)B * Li * Hi * Wi * C;
  if (x_plane_stride != 0 && x_plane_stride != plane_elems) return (int)cudaErrorInvalidValue;
  const int x_planes = x_plane_stride != 0 ? planes : 1;
  const int nk = cdiv(C, bk), ntiles = cdiv(Co, bn), steps = taps.n * nk;
  if (steps > 65535) return (int)cudaErrorInvalidValue;   // the live list is uint16
  if ((long long)planes * ntiles * steps > live_bytes) return (int)cudaErrorInvalidValue;
  const Box box = choose_box(Lo, Ho, Wo);

  // the input (C, Wi, Hi, Li, B * x_planes), read as boxes (bk, bw, bh, bl, 1)
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[5] = {(cuuint64_t)C, (cuuint64_t)Wi, (cuuint64_t)Hi, (cuuint64_t)Li,
                               (cuuint64_t)B * x_planes};
  const cuuint64_t xstr[4] = {(cuuint64_t)C * 2, (cuuint64_t)Wi * C * 2,
                              (cuuint64_t)Hi * Wi * C * 2, (cuuint64_t)Li * Hi * Wi * C * 2};
  const cuuint32_t xbox[5] = {(cuuint32_t)bk, (cuuint32_t)box.bw, (cuuint32_t)box.bh,
                              (cuuint32_t)box.bl, 1};
  // the weights (C, Co, planes * taps), read as boxes (bk, bn, 1)
  const cuuint64_t wdims[3] = {(cuuint64_t)C, (cuuint64_t)Co, (cuuint64_t)planes * taps.n};
  const cuuint64_t wstr[2] = {(cuuint64_t)C * 2, (cuuint64_t)Co * C * 2};
  const cuuint32_t wbox[3] = {(cuuint32_t)bk, (cuuint32_t)bn, 1};
  if (!encode(&xmap, x, 5, xdims, xstr, xbox, bk) || !encode(&wmap, wt, 3, wdims, wstr, wbox, bk))
    return (int)cudaErrorInvalidValue;

  live_steps_kernel<<<dim3((unsigned)cdiv(steps, 8), (unsigned)ntiles, (unsigned)planes), 256, 0,
                      stream>>>(static_cast<const __nv_bfloat16*>(wt), live, taps.n, C, Co, bn,
                                bk, nk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

#define V2CE_WGMMA(BN_, BK_)                                                                \
  if (bn == BN_ && bk == BK_)                                                               \
    return launch_wgmma_out<BN_, BK_>(dtype_out, xmap, wmap, out, live, B, Lo, Ho, Wo, Co,  \
                                      planes, x_planes, box, nk, taps, stream);
  V2CE_WGMMA(32, 32)
  V2CE_WGMMA(32, 64)
  V2CE_WGMMA(64, 32)
  V2CE_WGMMA(64, 64)
  V2CE_WGMMA(128, 32)
  V2CE_WGMMA(128, 64)
#undef V2CE_WGMMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int launch_conv_taps(const void* x, const void* wt, void* out, unsigned char* live,
                     long long live_bytes, int B, int Li, int Hi, int Wi, int Lo, int Ho,
                     int Wo, int C, int Co, int planes, long long x_plane_stride,
                     const Taps& taps, int bn, int bk, int dtype_in, int dtype_out,
                     cudaStream_t stream) {
  const long long M = (long long)B * Lo * Ho * Wo;
  if (M <= 0 || Co <= 0) return (int)cudaSuccess;
  if (dtype_out != 0 && dtype_out != 1) return (int)cudaErrorInvalidValue;
  if (dtype_in == 1)
    return launch_bf16(x, wt, out, live, live_bytes, B, Li, Hi, Wi, Lo, Ho, Wo, C, Co, planes,
                       x_plane_stride, taps, bn, bk, dtype_out, stream);
  if (dtype_in != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN),
                  (unsigned)planes);
  if (dtype_out == 0)
    conv_taps_f32_kernel<float><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(out),
        B, Li, Hi, Wi, Lo, Ho, Wo, C, Co, planes, x_plane_stride, taps);
  else
    conv_taps_f32_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<__nv_bfloat16*>(out), B, Li, Hi, Wi, Lo, Ho, Wo, C, Co, planes,
        x_plane_stride, taps);
  return (int)cudaGetLastError();
}

}  // namespace v2ce_conv
