// Shared device helpers of the v2ce kernels: the INVALID marker, lane and
// warp ids, and the LDATI generation math that K1 (gen_compact.cu) and K4
// (gen_pack.cu) share, so both run the identical f32 op sequence. The
// compaction core of K1, K2, K3 and K5 is compact_core.cuh.
#pragma once

#include <cuda_runtime.h>

#define V2CE_INVALID 0x7fffffff

namespace v2ce {

__device__ __forceinline__ unsigned lane_id() { return threadIdx.x & 31u; }
__device__ __forceinline__ unsigned warp_id() { return threadIdx.x >> 5; }

// ---------------------------------------------------------------------------
// LDATI generation (v2ce_toolbox_tpu/ops/gen_pallas.py:_gen_kernel and
// _gen_compact_kernel). Every expression is the f32 op sequence XLA compiles
// for the JAX kernels, written with round-to-nearest intrinsics (the library
// is built with -fmad=false). The one fused multiply-add is explicit: XLA
// folds the chain timestamp's `tend / fps / cb` into a multiply by
// f32(1/fps) * f32(1/cb) (`tscale`) and contracts `* tscale + bin_start`
// into an FMA. The per-bin constants come from the wrapper, computed in
// numpy f32 like gen_pallas.py does.
// ---------------------------------------------------------------------------

constexpr int kCB = 9;               // output bins (10 input bins)

struct Pixel {
  int cnt[kCB];
  float tend[kCB];
};

struct BinConsts {
  float bs_f[kCB];
  int bs_us[kCB];
};

// The 9-step debt-carrying relocation of one pixel from its 10 bin values.
__device__ __forceinline__ void relocate_values(const float (&x)[kCB + 1], Pixel& px) {
  float debt = 0.0f;
#pragma unroll
  for (int ci = 0; ci < kCB; ++ci) {
    const float avail = __fsub_rn(x[ci], debt);
    const float cf = ceilf(__fsub_rn(avail, 1e-6f));
    debt = __fsub_rn(cf, avail);
    px.cnt[ci] = __float2int_rz(cf);
    px.tend[ci] = debt;
  }
  // fold the final input bin into the last output bin, truncating
  px.cnt[kCB - 1] += __float2int_rz(__fsub_rn(x[kCB], debt));
}

// The same from memory: src points at the pixel's bin 0 and `plane` is the
// stride between bins.
__device__ __forceinline__ void relocate(const float* __restrict__ src, long plane, Pixel& px) {
  float x[kCB + 1];
#pragma unroll
  for (int ci = 0; ci <= kCB; ++ci) x[ci] = src[ci * plane];
  relocate_values(x, px);
}

// Candidates a voxel emits: 'slope' all its events up to mepv, 'none' the
// chain event only.
__device__ __forceinline__ int emit_of(int cnt, int mepv, bool slope) {
  if (!slope) return cnt == 1;
  const int e = cnt == 1 ? 1 : min(cnt, mepv);
  return max(e, 0);
}

__device__ __forceinline__ int drop_of(int cnt, int mepv, bool slope) {
  return slope && cnt > mepv ? cnt - mepv : 0;
}

// Packed key (rel_us << vox_bits) | v; rel_us is the chain timestamp within
// the bin, 0 for non-chain slots (their draw comes later).
__device__ __forceinline__ int key_of(const Pixel& px, int ci, int v, const BinConsts& c,
                                      float tscale, int vox_bits, int ts_cap) {
  const float ts = __fmul_rn(__fmaf_rn(px.tend[ci], tscale, c.bs_f[ci]), 1e6f);
  int rel = __float2int_rz(ts) - c.bs_us[ci];
  rel = min(max(rel, 0), ts_cap);
  if (px.cnt[ci] != 1) rel = 0;
  return (rel << vox_bits) | v;
}

// Slope payload: bits of k with the low 8 bits replaced by the clipped
// extra-event count.
__device__ __forceinline__ int kx_of(const Pixel& px, int ci, float vs2, int mepv) {
  float k = 0.0f;
  if (ci != 0 && ci != kCB - 1) {
    const float k_raw = __fmul_rn(__fsub_rn(__int2float_rn(px.cnt[ci + 1]),
                                            __int2float_rn(px.cnt[ci - 1])), 0.5f);
    k = __fdiv_rn(__fdiv_rn(k_raw, vs2), __fadd_rn(__int2float_rn(px.cnt[ci]), 1e-8f));
  }
  int extra = min(max(px.cnt[ci] - 1, 0), mepv - 1);
  extra = min(extra, 255);
  return (__float_as_int(k) & ~0xFF) | extra;
}

}  // namespace v2ce
