// K8: the FastFlowNet cost volume, (2*md+1)^2 taps, NCHW, f32.
//
// Replaces the Pallas kernel `v2ce_toolbox_tpu/ops/correlation.py:59
// correlation` (its `_corr_kernel` at :43, `pallas_call` at :69), which in
// turn stands for the reference's CUDA correlation extension (pad 4,
// kernel 1, max displacement 4, strides 1). Python wrapper, plain twin and
// the launch plan: `ops/correlation.py`.
//
//   out[n, slot(t), y, x] = (sum_c f1[n, c, y, x] * f2[n, c, y+dy, x+dx]) * (1/C),
//   t = (dy+md)*(2md+1) + (dx+md),
//
// with f2 read as zero outside its H x W plane; every tap t in the list is
// stored into channel slot(t) of `out` (all taps in order by default), an
// (N, >= T, H, W) view whose batch stride may exceed T*H*W, so FastFlowNet
// writes its 53 taps straight into its decoder's input.
//
// Bound on an H100 SXM: by bytes. FastFlowNet calls it on its five pyramid
// levels (C 32 at 80x96, C 64 at 40x48, 20x24, 10x12, 5x6 for 260x346
// frames padded to 320x384); one 16-pair call reads f1 and f2 and writes
// the 81 output planes, ~105 MB in ~1.06 GFLOP, so ~31 us at 3.35 TB/s
// against ~16 us of f32 FMAs at 67 TFLOP/s. The three coarse levels are
// latency: a few hundred threads of work each.
//
// Design. A work item is a TY x TX tile of output pixels of one image and
// DYB of the 2md+1 displacement rows dy (the plan splits dy over items
// where the tiles alone would be too few). A thread owns P (4, or 2 on the
// coarse levels) adjacent x pixels of one row and one dy, all 2md+1 dx:
// (2md+1) * P sums in registers. As many blocks as the card holds walk the
// items; each walks C in slices of CS channels through a ring of shared-
// memory stages that runs on from one item into the next: one thread
// issues TMA loads of the f1 tile and of the f2 tile plus its halo (TY +
// DYB - 1 rows, TX + 2md columns) from 4-D tensor maps (W, H, C, N), whose
// out-of-bounds zero fill is the border, STAGES - 1 slices ahead, while the
// block sums the current one. For each channel a thread loads its P f1
// values and a window of P + 2md f2 values of its row in 16-byte (8-byte
// at P 2) shared loads, and each f2 value feeds up to P FMAs. Tile rows are
// padded so a quarter warp's 16-byte loads of two rows fall on distinct
// banks. Each sum is one fmaf chain over c ascending, whatever the tiling,
// so a tap subset equals the full volume's planes bit for bit. The sums
// are stored with 16-byte (8-byte, 4-byte) stores along x where W and the
// view's strides allow. TMA needs 16-byte row strides: where W is not a
// multiple of 4 (the 5x6 level), or a pointer is not 16-byte aligned, the
// block's threads stage each slice with 4-byte cp.async copies (zero
// filled outside the plane) instead, one stage.
//
// What bounds it (H100, chip runs at FastFlowNet's levels): at 80x96 and
// 40x48 the tiles' TMA traffic from L2 (each f2 row is read again by the
// tiles above and below it: ~80 MB at 80x96 for 8 MB of features) and the
// 50 MB of sums written; at the three coarse levels, latency (a launch, a
// load and a 64-channel chain of FMAs a thread). Tried on an H100 and no
// faster: 8 pixels a thread (one block an SM), a 16-byte cp.async ring in
// place of TMA; one block an item instead of the persistent blocks lost
// ~10% at 80x96.
#include <cstring>

#include "hopper.cuh"

// a named namespace around the anonymous one, as in conv_igemm.cu: nvcc's
// host stubs cannot tell two anonymous namespaces of one unit apart
namespace v2ce_corr {
namespace {

using namespace v2ce_hopper;

constexpr int MAX_THREADS = 288;     // ops/correlation.MAX_THREADS
constexpr int MAX_STAGES = 4;        // ops/correlation.MAX_STAGES
constexpr int MAX_TAPS = 81;
constexpr int MAX_SMEM = 232448;
constexpr int MAX_DEVICES = 16;

// the launch plan (ops/correlation.plan, in PLAN_FIELDS order): tile, x
// pixels a thread, dy rows a block, channels a slice, ring stages, and the
// f1 and f2 tiles' row pitches in floats
struct Plan {
  int tx, ty, p, dyb, cs, stages, r1, r2;
};

struct Slots {
  signed char s[MAX_TAPS];           // tap -> output channel, -1: not stored
};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// floats of one ring stage: the f2 tile, then the f1 tile, each 128-byte aligned
__host__ __device__ inline int f2_floats(const Plan& pl) {
  return round_up(pl.cs * (pl.ty + pl.dyb - 1) * pl.r2, 32);
}
__host__ __device__ inline int stage_floats(const Plan& pl) {
  return f2_floats(pl) + round_up(pl.cs * pl.ty * pl.r1, 32);
}

template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      v[i] = q.x, v[i + 1] = q.y;
    }
  }
}

// two blocks an SM: ptxas gives a thread 96 registers, which hold md 4's 36
// sums at P 4 without a spill
template <int MD, int P, bool TMA>
__global__ void __launch_bounds__(MAX_THREADS, 2)
corr_kernel(const __grid_constant__ CUtensorMap m1, const __grid_constant__ CUtensorMap m2,
            const float* __restrict__ f1, const float* __restrict__ f2, float* __restrict__ out,
            int N, int C, int H, int W, float inv_c, Plan pl, long long out_bstride, int vec,
            const __grid_constant__ Slots slots) {
  constexpr int D = 2 * MD + 1;
  constexpr int VW = P % 4 == 0 ? 4 : 2;                   // shared-load width
  constexpr int L = (P + 2 * MD + VW - 1) / VW * VW;        // f2 window a thread loads
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);

  const int gpr = pl.tx / P, G = gpr * pl.ty, by2 = pl.ty + pl.dyb - 1;
  const int n_dyb = D / pl.dyb;
  const int tiles_x = (W + pl.tx - 1) / pl.tx, tiles_y = (H + pl.ty - 1) / pl.ty;
  const int items = tiles_x * tiles_y * N * n_dyb;
  const int tid = threadIdx.x;
  const int g = tid % G, dyl = tid / G;
  const int gx = g % gpr, ty = g / gpr;
  const int nk = (C + pl.cs - 1) / pl.cs;
  const int sf = stage_floats(pl), f2f = f2_floats(pl);
  const uint32_t stage_bytes =
      (uint32_t)(pl.cs * by2 * pl.r2 + pl.cs * pl.ty * pl.r1) * 4u;
  const long long plane = (long long)H * W;

  // A block walks the work items blockIdx.x, + gridDim.x, ...; its slices,
  // item after item, are one sequence q that the ring follows across
  // items, so the next item's loads overlap this one's sums and stores.
  struct Item {
    int x0, y0, n, dy0;                // tile origin, image, first dy row
  };
  auto item_of = [&](int it) {
    const int bx = it % tiles_x;
    int r = it / tiles_x;
    const int by = r % tiles_y;
    r /= tiles_y;
    return Item{bx * pl.tx, by * pl.ty, r / n_dyb, r % n_dyb * pl.dyb};
  };
  auto issue = [&](int q) {            // TMA: the block's slice q into its stage
    const int it = blockIdx.x + q / nk * gridDim.x, k = q % nk;
    if (it >= items) return;
    const Item t = item_of(it);
    const int st = q % pl.stages;
    float* s2 = ring + st * sf;
    mbar_expect_tx(smem_u32(&full[st]), stage_bytes);
    tma_load_4d(smem_u32(s2), &m2, smem_u32(&full[st]), t.x0 - MD, t.y0 - MD + t.dy0,
                k * pl.cs, t.n);
    tma_load_4d(smem_u32(s2 + f2f), &m1, smem_u32(&full[st]), t.x0, t.y0, k * pl.cs, t.n);
  };
  auto stage_plain = [&](const Item& t, int k) {  // cp.async: slice k into stage 0
    const int c0 = k * pl.cs;
    const float* a2 = f2 + (long long)t.n * C * plane;
    const float* a1 = f1 + (long long)t.n * C * plane;
    const int w2 = pl.tx - P + L;      // the f2 columns the windows read
    for (int line = tid; line < pl.cs * by2; line += blockDim.x) {
      const int c = c0 + line / by2, gy = t.y0 - MD + t.dy0 + line % by2;
      const bool row_ok = c < C && gy >= 0 && gy < H;
      const float* src = row_ok ? a2 + c * plane + (long long)gy * W : a2;
      const uint32_t dst = smem_u32(ring + line * pl.r2);
      for (int col = 0; col < w2; ++col) {
        const int gx2 = t.x0 - MD + col;
        const bool ok = row_ok && gx2 >= 0 && gx2 < W;
        cp_async4(dst + 4 * col, ok ? src + gx2 : a2, ok);
      }
    }
    for (int line = tid; line < pl.cs * pl.ty; line += blockDim.x) {
      const int c = c0 + line / pl.ty, gy = t.y0 + line % pl.ty;
      const bool row_ok = c < C && gy < H;
      const float* src = row_ok ? a1 + c * plane + (long long)gy * W : a1;
      const uint32_t dst = smem_u32(ring + f2f + line * pl.r1);
      for (int col = 0; col < pl.tx; ++col) {
        const bool ok = row_ok && t.x0 + col < W;
        cp_async4(dst + 4 * col, ok ? src + t.x0 + col : a1, ok);
      }
    }
    cp_async_wait_all();
  };

  if constexpr (TMA) {
    if (tid == 0) {
      prefetch_tensormap(&m1);
      prefetch_tensormap(&m2);
      for (int s = 0; s < pl.stages; ++s) mbar_init(smem_u32(&full[s]), 1);
      fence_mbar_init();
      for (int q = 0; q < pl.stages - 1; ++q) issue(q);
    }
    __syncthreads();
  }

  int q = 0;                           // the block's slice count
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item t = item_of(it);
    float acc[D][P];
#pragma unroll
    for (int dx = 0; dx < D; ++dx)
#pragma unroll
      for (int p = 0; p < P; ++p) acc[dx][p] = 0.f;

    for (int k = 0; k < nk; ++k, ++q) {
      const float* s2;
      if constexpr (TMA) {
        // the stage of slice q - 1 is free: every thread passed the barrier after it
        if (tid == 0) issue(q + pl.stages - 1);
        const int st = q % pl.stages;
        mbar_wait(smem_u32(&full[st]), (uint32_t)((q / pl.stages) & 1));
        s2 = ring + st * sf;
      } else {
        stage_plain(t, k);
        __syncthreads();
        s2 = ring;
      }
      const float* b_row = s2 + (ty + dyl) * pl.r2 + gx * P;
      const float* a_row = s2 + f2f + ty * pl.r1 + gx * P;
      const int cn = min(pl.cs, C - k * pl.cs);
      for (int cc = 0; cc < cn; ++cc) {
        float a[P], b[L];
        load_row(a, a_row + cc * pl.ty * pl.r1);
        load_row(b, b_row + cc * by2 * pl.r2);
#pragma unroll
        for (int dx = 0; dx < D; ++dx)
#pragma unroll
          for (int p = 0; p < P; ++p) acc[dx][p] = fmaf(a[p], b[p + dx], acc[dx][p]);
      }
      __syncthreads();
    }

    const int y = t.y0 + ty, xg = t.x0 + gx * P;
    if (y >= H || xg >= W) continue;
    const int dy = t.dy0 + dyl;
    float* o = out + (long long)t.n * out_bstride + (long long)y * W + xg;
#pragma unroll
    for (int dx = 0; dx < D; ++dx) {
      const int s = slots.s[dy * D + dx];
      if (s < 0) continue;
      float* qo = o + s * plane;
      float v[P];
#pragma unroll
      for (int p = 0; p < P; ++p) v[p] = acc[dx][p] * inv_c;
      if constexpr (P % 4 == 0) {
        if (vec == 4) {
#pragma unroll
          for (int p = 0; p < P; p += 4)
            if (xg + p < W)
              *reinterpret_cast<float4*>(qo + p) = make_float4(v[p], v[p + 1], v[p + 2], v[p + 3]);
          continue;
        }
      }
      if (vec == 2) {
#pragma unroll
        for (int p = 0; p < P; p += 2)
          if (xg + p < W) *reinterpret_cast<float2*>(qo + p) = make_float2(v[p], v[p + 1]);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (xg + p < W) qo[p] = v[p];
      }
    }
  }
}

template <int MD, int P, bool TMA>
int launch(const CUtensorMap& m1, const CUtensorMap& m2, const float* f1, const float* f2,
           float* out, int N, int C, int H, int W, float inv_c, const Plan& pl,
           long long out_bstride, int vec, const Slots& slots, cudaStream_t stream) {
  constexpr int D = 2 * MD + 1;
  const size_t smem = 128 + (size_t)(TMA ? pl.stages : 1) * stage_floats(pl) * 4;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = corr_kernel<MD, P, TMA>;
  const int threads = pl.tx / P * pl.ty * pl.dyb;
  const long long items =
      (long long)((W + pl.tx - 1) / pl.tx) * ((H + pl.ty - 1) / pl.ty) * N * (D / pl.dyb);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // as many blocks as the card holds at once, each walking items; the
  // shared-memory attribute and the occupancy of each (device, threads,
  // shared memory) are looked up once
  struct Known {
    int dev, threads;
    size_t smem;
    int blocks;
  };
  static Known known[16];
  static int n_known = 0;
  static int smem_set[MAX_DEVICES] = {};     // the attribute, the most yet asked a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if ((int)smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = (int)smem;
  }
  int blocks = 0;
  for (int i = 0; i < n_known && !blocks; ++i)
    if (known[i].dev == dev && known[i].threads == threads && known[i].smem == smem)
      blocks = known[i].blocks;
  if (!blocks) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
            cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    if (n_known < 16) known[n_known++] = Known{dev, threads, smem, blocks};
  }
  const int grid = (int)(items < blocks ? items : blocks);
  kernel<<<grid, threads, smem, stream>>>(m1, m2, f1, f2, out, N, C, H, W, inv_c, pl,
                                          out_bstride, vec, slots);
  return (int)cudaGetLastError();
}

template <int MD>
int launch_md(bool tma, const CUtensorMap& m1, const CUtensorMap& m2, const float* f1,
              const float* f2, float* out, int N, int C, int H, int W, float inv_c,
              const Plan& pl, long long out_bstride, int vec, const Slots& slots,
              cudaStream_t stream) {
#define V2CE_CORR(P_)                                                                        \
  if (pl.p == P_)                                                                            \
    return tma ? launch<MD, P_, true>(m1, m2, f1, f2, out, N, C, H, W, inv_c, pl, out_bstride, \
                                      vec, slots, stream)                                    \
               : launch<MD, P_, false>(m1, m2, f1, f2, out, N, C, H, W, inv_c, pl,           \
                                       out_bstride, vec, slots, stream);
  V2CE_CORR(2)
  V2CE_CORR(4)
#undef V2CE_CORR
  return (int)cudaErrorInvalidValue;
}

bool encode_features(CUtensorMap* map, const void* base, int N, int C, int H, int W, int bx,
                     int by, int cs) {
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C, (cuuint64_t)N};
  const cuuint64_t str[3] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4,
                             (cuuint64_t)C * H * W * 4};
  const cuuint32_t box[4] = {(cuuint32_t)bx, (cuuint32_t)by, (cuuint32_t)cs, 1};
  return encode_f32(map, base, 4, dims, str, box);
}

}  // namespace
}  // namespace v2ce_corr

using namespace v2ce_corr;

// f1, f2: (N, C, H, W) f32, contiguous; out: the (N, T, H, W) f32 view
// whose channel, row and pixel strides are H*W, W, 1 and whose batch
// stride is out_batch_stride (>= T*H*W); taps: T distinct taps in
// [0, (2md+1)^2), tap taps[j] stored into channel j (a host array; null:
// all taps in order); inv_c: 1/C rounded to f32 once, as the TPU kernel's
// `sum * inv_c`; plan: the 8 ints of ops/correlation.plan. md in 1..4;
// returns cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// arguments outside the kernel's limits).
extern "C" int v2ce_correlation(const void* f1, const void* f2, void* out, int N, int C, int H,
                                int W, int md, float inv_c, const int* taps, int n_taps,
                                long long out_batch_stride, const int* plan, void* stream) {
  if (md < 1 || md > 4 || N < 1 || C < 1 || H < 1 || W < 1 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int D = 2 * md + 1;
  const Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7]};
  const int vw = pl.p % 4 == 0 ? 4 : 2, window = round_up(pl.p + 2 * md, vw);
  if ((pl.p != 2 && pl.p != 4) || pl.tx < pl.p || pl.tx % pl.p || pl.ty < 1 ||
      pl.dyb < 1 || D % pl.dyb || pl.tx / pl.p * pl.ty * pl.dyb > MAX_THREADS || pl.cs < 1 ||
      pl.cs > 256 || pl.stages < 1 || pl.stages > MAX_STAGES || pl.r1 < pl.tx ||
      pl.r1 % 4 || pl.r1 > 256 || pl.r2 < pl.tx - pl.p + window || pl.r2 % 4 ||
      pl.r2 > 256 || pl.ty + pl.dyb - 1 > 256)
    return (int)cudaErrorInvalidValue;
  const int T = taps ? n_taps : D * D;
  if (T < 1 || T > D * D || out_batch_stride < (long long)T * H * W)
    return (int)cudaErrorInvalidValue;
  Slots slots;
  for (int t = 0; t < MAX_TAPS; ++t) slots.s[t] = (signed char)(taps || t >= D * D ? -1 : t);
  for (int j = 0; taps && j < T; ++j) {
    if (taps[j] < 0 || taps[j] >= D * D || slots.s[taps[j]] >= 0)
      return (int)cudaErrorInvalidValue;
    slots.s[taps[j]] = (signed char)j;
  }
  // the widest store that keeps every row of every plane aligned
  auto fits = [&](int v) {
    return pl.p % v == 0 && W % v == 0 && out_batch_stride % v == 0 &&
           reinterpret_cast<uintptr_t>(out) % (4 * v) == 0;
  };
  const int vec = fits(4) ? 4 : fits(2) ? 2 : 1;
  const bool tma = W % 4 == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(f2) % 16 == 0;
  CUtensorMap m1, m2;
  memset(&m1, 0, sizeof(m1));
  memset(&m2, 0, sizeof(m2));
  if (tma && (!encode_features(&m1, f1, N, C, H, W, pl.r1, pl.ty, pl.cs) ||
              !encode_features(&m2, f2, N, C, H, W, pl.r2, pl.ty + pl.dyb - 1, pl.cs)))
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(f1);
  const float* b = static_cast<const float*>(f2);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (md) {
    case 1: return launch_md<1>(tma, m1, m2, a, b, o, N, C, H, W, inv_c, pl, out_batch_stride, vec, slots, s);
    case 2: return launch_md<2>(tma, m1, m2, a, b, o, N, C, H, W, inv_c, pl, out_batch_stride, vec, slots, s);
    case 3: return launch_md<3>(tma, m1, m2, a, b, o, N, C, H, W, inv_c, pl, out_batch_stride, vec, slots, s);
    default: return launch_md<4>(tma, m1, m2, a, b, o, N, C, H, W, inv_c, pl, out_batch_stride, vec, slots, s);
  }
}
