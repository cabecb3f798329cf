// K12: the 3x3x3 stride-1 'same' convolution as Winograd F(4,3) over the
// frame axis L and the row axis H, the three W taps folded into the
// product's N = 3*Co, channels-last, f32 accumulation.
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
//   Z[xi, lam] = V[xi, lam] (M x C) . U[xi, lam] (C x 3Co)       (36 products)
//   y[a][bh]   = sum_lam AT[bh][lam] sum_xi AT[a][xi] Z[xi, lam]
//   out[4J+a, 4I+bh, w, co] = y[w, co] + y[w+1, Co+co] + y[w+2, 2Co+co]
// The transforms run in the JAX kernel's term order (`_lincomb`), every
// product and partial sum rounded to x's dtype as the JAX kernel's bf16
// arithmetic rounds them; the collapses and the W-tap combine run in f32,
// in its order, with no contraction (the twin's ops, bit for bit). A tile
// reads padded rows 4J..4J+5 and columns 4I..4I+5 only, so the JAX
// kernel's (lt, th) blocks do not change the result and the port tiles by 4.
//
// Three launches, with the scratch the wrapper allocates:
//   1. input transform: one thread per (tile, w', c) computes its 36 V
//      values from 36 loads and writes V (36, M, Cv) in x's dtype, M = B *
//      ceil(L/4) * ceil(H/4) * (W+2) rows a position;
//   2. the 36 products Z (36, M, N) f32 through the implicit GEMM of
//      csrc/conv_igemm.cuh (one tap, 36 planes, each with its own rows of
//      V and U; bf16 on the Hopper path: TMA boxes of 128 V rows, wgmma,
//      IEEE f32 step sums; f32 CUDA-core FMAs)
//      -- or, for the probe's ablate='nodot', Z as V's lanes (`lanes`: the
//      V channel of each of the 3Co lanes of the JAX kernel's channel
//      padding, -1 for a zero pad lane);
//   3. output transform: one thread per (tile, w, co) reads its 3 x 36 Z
//      values, collapses them and writes the 16 outputs.
// At the probe's dec3_conv1 shape, (1, 16, 260, 346, 96) with Co = 32, V
// and Z are 1.25 GB each in f32 (V 0.63 GB in bf16): the design trades
// device memory and ~6.5 GB of traffic for simplicity.
//
// Bound on an H100 SXM: by operations, the Winograd multiply-adds of the
// TPU kernel's own cost estimate (`winograd_pallas.py:264`: the direct
// conv's 2*B*L*H*W*C*Co*27 times 36/144), at 989 TFLOP/s in bf16 and 67
// TFLOP/s in f32; by bytes, x read and the output written once. Left for a
// later PR: one fused kernel that keeps V and Z on chip (the TPU kernel's
// structure); until then V and Z through device memory bound it.
#include "conv_igemm.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

// the F(4,3) matrices (winograd_pallas.py:47-68), as initialisers of local
// arrays: fully unrolled loops index them with constants, so the zero and
// +-1 tests below fold away
#define V2CE_BT4                                                              \
  {{4, 0, -5, 0, 1, 0}, {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},            \
   {0, -2, -1, 2, 1, 0}, {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}}
#define V2CE_AT4 {{1, 1, 1, 1, 1, 0}, {0, 1, -1, 2, -2, 0}, {0, 1, 1, 4, 4, 0}, {0, 1, -1, 8, -8, 1}}

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// sum_i cf[i] * t[i] in the JAX kernel's `_lincomb` order: zeros skipped,
// +-1 folded, left to right, each product and partial sum rounded.
template <bool kBf16>
__device__ __forceinline__ float lincomb6(const float (&cf)[6], const float (&t)[6]) {
  float out = 0.f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (cf[i] == 0.f) continue;
    const float term =
        cf[i] == 1.f ? t[i] : (cf[i] == -1.f ? -t[i] : rnd<kBf16>(__fmul_rn(t[i], cf[i])));
    out = first ? term : rnd<kBf16>(__fadd_rn(out, term));
    first = false;
  }
  return out;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(256)
wino4_input_kernel(const T* __restrict__ x, T* __restrict__ v, int L, int H, int W, int C,
                   int Cv, int nl, int nh, long long M) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
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
        val = to_float(x[((((size_t)b * L + l) * H + h) * W + w) * C + c]);
      xs[i][s] = val;
    }
#pragma unroll
  for (int lam = 0; lam < 6; ++lam) {
    float e[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = lincomb6<kBf16>(kBT[lam], xs[i]);
#pragma unroll
    for (int xi = 0; xi < 6; ++xi) {
      const float vv = lincomb6<kBf16>(kBT[xi], e);
      store(v + ((size_t)(xi * 6 + lam) * M + m) * Cv + c, vv);
    }
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

inline unsigned blocks(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

// x (B, L, H, W, C) and ut (36, Np, Cv) in x's dtype (0 = f32, 1 = bf16);
// scratch v (36, M, Cv) in x's dtype and z (36, M, Np) f32; lanes (3 Co)
// int32; out (B, L, H, W, Co) in dtype_out. mode 0 = full, 1 = nodot.
// live, live_bytes, bn, bk: the product's live-step table and tile (bf16).
extern "C" int v2ce_conv3d_wino4(const void* x, const void* ut, void* v, float* z,
                                 const int* lanes, void* out, unsigned char* live,
                                 long long live_bytes, int B, int L, int H, int W, int C, int Cv,
                                 int Co, int Np, int bn, int bk, int mode, int dtype_in,
                                 int dtype_out, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B <= 0 || L <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  if (dtype_in < 0 || dtype_in > 1 || dtype_out < 0 || dtype_out > 1 || mode < 0 || mode > 1 ||
      Cv % 8 || Np % 8 || Np < 3 * Co)
    return (int)cudaErrorInvalidValue;
  const int nl = (L + 3) / 4, nh = (H + 3) / 4;
  const long long M = (long long)B * nl * nh * (W + 2);
  if (dtype_in == 0)
    wino4_input_kernel<float><<<blocks(M * Cv), 256, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(v), L, H, W, C, Cv, nl, nh, M);
  else
    wino4_input_kernel<__nv_bfloat16><<<blocks(M * Cv), 256, 0, stream>>>(
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
    err = v2ce_conv::launch_conv_taps(v, ut, z, live, live_bytes, 1, 1, 1, (int)M, 1, 1, (int)M,
                                      Cv, Np, 36, M * Cv, taps, bn, bk, dtype_in, 0, stream);
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
