// K8: the FastFlowNet cost volume, (2*md+1)^2 taps, NCHW, f32.
//
// Replaces the Pallas kernel `v2ce_toolbox_tpu/ops/correlation.py:59
// correlation` (its `_corr_kernel` at :43, `pallas_call` at :69), which in
// turn stands for the reference's CUDA correlation extension (pad 4,
// kernel 1, max displacement 4, strides 1). Python wrapper and plain twin:
// `ops/correlation.py`.
//
//   out[n, (dy+md)*(2md+1) + (dx+md), y, x]
//       = (sum_c f1[n, c, y, x] * f2[n, c, y+dy, x+dx]) * (1/C)
//
// with f2 read as zero outside its H x W plane.
//
// Bound on an H100 SXM: by bytes. FastFlowNet calls it on its five pyramid
// levels (C 32 at 80x96, C 64 at 40x48, 20x24, 10x12, 5x6 for 260x346
// frames padded to 320x384); one 16-pair call reads f1 and f2 and writes
// the 81 output planes, ~105 MB in ~1.6 GFLOP, so ~31 us at 3.35 TB/s
// against ~24 us of f32 FMAs at 67 TFLOP/s. Writing the 81-plane output
// is the larger part at the finest level.
//
// Design: a block owns a TILE_Y x TILE_X tile of output pixels of one
// image, one thread a pixel, and keeps its (2md+1)^2 sums in registers.
// It walks C in steps of CSTEP channels: the f2 tile plus its md-pixel
// halo is staged in shared memory (zero outside the plane, so f2 is never
// padded in device memory, where the TPU wrapper pads it with a copy),
// each thread reads its own f1 value (coalesced along x) and does the
// taps' FMAs from shared memory. Each output plane is written once,
// coalesced along x. Left for later work: more pixels per thread (to
// reuse the halo reads across neighbours in registers) and a wider
// store path.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 8;
constexpr int CSTEP = 8;

template <int MD>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                float* __restrict__ out, int C, int H, int W, float inv_c) {
  constexpr int D = 2 * MD + 1;
  constexpr int SX = TILE_X + 2 * MD;
  constexpr int SY = TILE_Y + 2 * MD;
  __shared__ float tile[CSTEP][SY][SX];

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TILE_X;
  const int y0 = blockIdx.y * TILE_Y;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE_X + tx;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool inside = x < W && y < H;
  const long long plane = (long long)H * W;
  const float* f1n = f1 + (long long)n * C * plane;
  const float* f2n = f2 + (long long)n * C * plane;

  float acc[D * D];
#pragma unroll
  for (int d = 0; d < D * D; ++d) acc[d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CSTEP) {
    const int cn = min(CSTEP, C - c0);
    __syncthreads();
    for (int i = tid; i < cn * SY * SX; i += TILE_X * TILE_Y) {
      const int cc = i / (SY * SX);
      const int r = i % (SY * SX);
      const int sy = r / SX;
      const int sx = r % SX;
      const int gy = y0 + sy - MD;
      const int gx = x0 + sx - MD;
      tile[cc][sy][sx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                             ? f2n[(c0 + cc) * plane + (long long)gy * W + gx]
                             : 0.f;
    }
    __syncthreads();
    if (inside) {
      for (int cc = 0; cc < cn; ++cc) {
        const float a = f1n[(c0 + cc) * plane + (long long)y * W + x];
#pragma unroll
        for (int dy = 0; dy < D; ++dy)
#pragma unroll
          for (int dx = 0; dx < D; ++dx)
            acc[dy * D + dx] = fmaf(a, tile[cc][ty + dy][tx + dx], acc[dy * D + dx]);
      }
    }
  }
  if (!inside) return;
  float* o = out + (long long)n * D * D * plane + (long long)y * W + x;
#pragma unroll
  for (int d = 0; d < D * D; ++d) o[d * plane] = acc[d] * inv_c;
}

template <int MD>
int launch(const float* f1, const float* f2, float* out, int N, int C, int H, int W,
           float inv_c, cudaStream_t stream) {
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, N);
  corr_kernel<MD><<<grid, block, 0, stream>>>(f1, f2, out, C, H, W, inv_c);
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2: (N, C, H, W) f32, contiguous; out: (N, (2md+1)^2, H, W) f32;
// inv_c: 1/C rounded to f32 once, as the TPU kernel's `sum * inv_c`.
// md in 1..4; returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for another md).
extern "C" int v2ce_correlation(const void* f1, const void* f2, void* out, int N, int C,
                                int H, int W, int md, float inv_c, void* stream) {
  const float* a = static_cast<const float*>(f1);
  const float* b = static_cast<const float*>(f2);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (md) {
    case 1: return launch<1>(a, b, o, N, C, H, W, inv_c, s);
    case 2: return launch<2>(a, b, o, N, C, H, W, inv_c, s);
    case 3: return launch<3>(a, b, o, N, C, H, W, inv_c, s);
    case 4: return launch<4>(a, b, o, N, C, H, W, inv_c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
