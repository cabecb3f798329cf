// Implicit-GEMM convolution over a table of taps, channels-last, shared by
// K9 (csrc/conv3d.cu: 27 taps, one output plane), K10
// (csrc/decoder_conv.cu: 18 taps per output H-parity, two planes), K11
// (csrc/conv3d_quad.cu: a VALID conv over any tap box, the output box
// smaller than the input's) and K12's batched product
// (csrc/wino4.cu: one tap, 36 planes, each with its own input matrix).
//
//   out[b, l, h, p, w, n] = sum_t sum_c xp[b, l + dl_t, h + dh_pt, w + dw_t, c]
//                                         * wt[p, t, n, c]
//
// where xp = x + p * x_plane_stride is an input box (B, Li, Hi, Wi, C),
// zero outside it, and (l, h, w) run over the output box (Lo, Ho, Wo).
// Rows of the GEMM are the output positions (b, l, h, w) of one plane p,
// columns the output channels n, and the reduction runs over (tap,
// channel). The output is (B*Lo, Ho, planes, Wo, Co): planes = 1 is plain
// (B, Lo, Ho, Wo, Co). A tap table row per plane (K10's parities) or one
// row for every plane.
//
// A block computes a BM x BN tile of one plane: per (tap, BK-channel
// step) it gathers the shifted input rows (zero-filled at the border) and
// the weight rows into shared memory, then accumulates in f32 registers.
// The global loads of the next step are issued before the current step's
// arithmetic. bf16 inputs run mma.sync m16n8k16, f32 inputs CUDA-core
// FMAs, so nothing rounds to TF32; in both, each step's BK products are
// summed from zero and the step sums added to the running sum in IEEE
// f32, so the rounding error grows with the number of steps, not of
// products (one running sum over K11's 27 x 512 products of positive
// inputs missed its twin by 1.06e-5 of the largest output). Channel counts
// must be multiples of 8 (the wrappers pad), so every 16-byte vector of a
// row is wholly inside or outside C.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace v2ce_conv {
namespace {

constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;
constexpr int MAX_TAPS = 27;

struct Taps {
  int n;                            // taps per plane
  int per_plane;                    // 1: plane p reads row p of d; 0: all read row 0
  signed char d[2][MAX_TAPS][3];    // per plane and tap: (dl, dh, dw)
};

template <typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte vector
  static constexpr int BKP = BK + VEC;               // padded smem row (16-byte aligned)
  static constexpr int VPR = BK / VEC;               // vectors per row of a step
  static constexpr int ROWS_PER_PASS = THREADS / VPR;
  static constexpr int A_ITERS = BM / ROWS_PER_PASS;
  static constexpr int B_ITERS = BN / ROWS_PER_PASS;
};

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS)
conv_taps_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                 OutT* __restrict__ out, int B, int Li, int Hi, int Wi, int Lo, int Ho,
                 int Wo, int C, int Co, int planes, long long x_plane_stride, Taps taps) {
  using TL = Tile<T>;
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

  if constexpr (std::is_same<T, float>::value) {
    // CUDA cores: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
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
  } else {
    // tensor cores: 8 warps as 4 (M) x 2 (N), each a 32 x 32 tile of
    // 2 x 4 m16n8 fragments
    const int lane = tid % 32, warp = tid / 32;
    const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
    const int g = lane >> 2, tig = lane & 3;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    load(0);
    for (int step = 0; step < steps; ++step) {
      stage();
      __syncthreads();
      if (step + 1 < steps) load(step + 1);
      // the tensor cores' f32 accumulation does not round as IEEE adds do,
      // and its error grows with the reduction length: each step's BK
      // products are summed there from zero, and the step sums here
      // (the same rule as the CUDA-core path)
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const T* a0 = &As[wm + 16 * i + g][kk + 2 * tig];
          af[i][0] = *reinterpret_cast<const uint32_t*>(a0);
          af[i][1] = *reinterpret_cast<const uint32_t*>(a0 + 8 * TL::BKP);
          af[i][2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
          af[i][3] = *reinterpret_cast<const uint32_t*>(a0 + 8 * TL::BKP + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T* b0 = &Bs[wn + 8 * j + g][kk + 2 * tig];
          bf[j][0] = *reinterpret_cast<const uint32_t*>(b0);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(b0 + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], af[i], bf[j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm + 16 * i + g + 8 * half;
        if (m >= M) continue;
        const size_t row = out_row(m) * Co;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn + 8 * j + 2 * tig;
          if (n < Co) store_out2(out + row + n, acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        }
      }
  }
}

// Launch on the (dtype_in, dtype_out) pair: 0 = float32, 1 = bfloat16.
inline int launch_conv_taps(const void* x, const void* wt, void* out, int B, int Li, int Hi,
                            int Wi, int Lo, int Ho, int Wo, int C, int Co, int planes,
                            long long x_plane_stride, const Taps& taps, int dtype_in,
                            int dtype_out, cudaStream_t stream) {
  const long long M = (long long)B * Lo * Ho * Wo;
  if (M <= 0 || Co <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN),
                  (unsigned)planes);
#define V2CE_CONV_LAUNCH(TI, TO)                                                   \
  conv_taps_kernel<TI, TO><<<grid, THREADS, 0, stream>>>(                        \
      static_cast<const TI*>(x), static_cast<const TI*>(wt), static_cast<TO*>(out), \
      B, Li, Hi, Wi, Lo, Ho, Wo, C, Co, planes, x_plane_stride, taps)
  if (dtype_in == 0 && dtype_out == 0) V2CE_CONV_LAUNCH(float, float);
  else if (dtype_in == 0 && dtype_out == 1) V2CE_CONV_LAUNCH(float, __nv_bfloat16);
  else if (dtype_in == 1 && dtype_out == 0) V2CE_CONV_LAUNCH(__nv_bfloat16, float);
  else if (dtype_in == 1 && dtype_out == 1) V2CE_CONV_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef V2CE_CONV_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace v2ce_conv
