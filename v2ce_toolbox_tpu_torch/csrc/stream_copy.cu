// K7, K15, K16: one identity copy kernel whose block copies a given span
// of bytes, with three C entries that differ only in the span.
//
//   K7  layout_barrier (`v2ce_toolbox_tpu/ops/barrier.py:32`, `_identity_kernel`
//       at :28, `pallas_call` at :43): one block per (h, w) plane of the
//       leading index of x viewed as (lead, h, w), any dtype;
//   K15 stream_copy (`tools/perf_probe.py:2597 copy_kern`, `pallas_call` at
//       :2602): one block per (row, chunk) of an int32 (r, n_chunks, sc, 128)
//       array, 64 KB at the sampler's chunk of 16,384 keys;
//   K16 stream_copy_row (`tools/perf_probe.py:2626 copy_row_kern`,
//       `pallas_call` at :2631): one block per row, 704 KB there.
// Python wrappers and plain twins (`clone()`): `ops/barrier.py`,
// `ops/roofline.py`.
//
// Bound on an H100 SXM: bytes, every input byte read once and every output
// byte written once at 3.35 TB/s. K15 against K16 measures what a block's
// fixed cost adds at the same bytes, as the TPU probe measured its grid
// step's. Design: 512 threads a block walk the span in 16-byte vectors
// (4-byte words, or bytes, where the span or the pointers are not 16-byte
// aligned), four loads in flight a thread before their stores. The TPU
// kernels' VMEM blocks and their DMA pipelining are the card's loads and
// stores; K7's purpose on the TPU, a custom call that pins XLA's default
// layouts between the model and the sampler, has no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512, kUnroll = 4;

template <typename V>
__global__ void __launch_bounds__(kThreads)
span_copy_kernel(const V* __restrict__ src, V* __restrict__ dst, long long span) {
  const long long base = (long long)blockIdx.x * span;
  const V* s = src + base;
  V* d = dst + base;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < span; i += kUnroll * kThreads) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[i + u * kThreads] = v[u];
  }
  for (; i < span; i += kThreads) d[i] = s[i];
}

int launch_span_copy(const void* src, void* dst, long long n_spans, long long span_bytes,
                     cudaStream_t stream) {
  if (n_spans <= 0 || span_bytes <= 0) return (int)cudaGetLastError();
  if (n_spans > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)src | (uintptr_t)dst;
  const dim3 grid((unsigned)n_spans);
  if (span_bytes % 16 == 0 && align % 16 == 0)
    span_copy_kernel<uint4><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), span_bytes / 16);
  else if (span_bytes % 4 == 0 && align % 4 == 0)
    span_copy_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), span_bytes / 4);
  else
    span_copy_kernel<uint8_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), span_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int v2ce_layout_barrier(const void* src, void* dst, long long lead,
                                   long long plane_bytes, void* stream) {
  return launch_span_copy(src, dst, lead, plane_bytes, static_cast<cudaStream_t>(stream));
}

extern "C" int v2ce_stream_copy(const void* src, void* dst, long long rows, long long n_chunks,
                                long long chunk_bytes, void* stream) {
  return launch_span_copy(src, dst, rows * n_chunks, chunk_bytes,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int v2ce_stream_copy_row(const void* src, void* dst, long long rows,
                                    long long row_bytes, void* stream) {
  return launch_span_copy(src, dst, rows, row_bytes, static_cast<cudaStream_t>(stream));
}
