// K7, K15, K16: identity copies, one block per span of bytes.
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
// byte written once at 3.35 TB/s. The TPU kernels' VMEM blocks and their
// DMA pipelining are the card's loads and stores; K7's purpose on the TPU,
// a custom call that pins XLA's default layouts between the model and the
// sampler, has no counterpart here.
//
// K7 and K15 (`span_copy_kernel`): 512 threads a block walk the span in
// 16-byte vectors (4-byte words, or bytes, where the span or the pointers
// are not 16-byte aligned), four loads in flight a thread before their
// stores. Their spans are small enough that several blocks share an SM.
//
// K16 (`row_copy_kernel`): a 704 KB row a block gives 144 blocks for 132
// SMs, and the register path above kept ~32 KB in flight an SM, so the
// row copy was bound by latency (Little's law). Here one thread moves the
// row through a ring of ROW_STAGES 16 KB shared-memory stages with
// Hopper's bulk copies: `cp.async.bulk` loads complete on an mbarrier
// each, `cp.async.bulk` stores leave from the same stage, and a stage is
// loaded again once its store has read it (bulk groups,
// `wait_group.read`), with ROW_AHEAD loads (160 KB) in flight. One block
// an SM (two, with half the ring each, ran slower on an H100). Rows that
// each stream their own 704 KB stayed below `clone`'s rate at the same
// bytes with every copy path tried (bulk ring or registers, chunk order),
// and the 12 rows past 132 run as a second wave. A row's bytes before the
// first 16-byte boundary and after the last are copied by the warp's threads;
// the wrapper allocates the output at the source's 16-byte phase, so the
// bulk copies apply to both. A caller whose pointers differ in that phase
// gets the warp's byte copy for the whole row.
#include "hopper.cuh"

// a named namespace around the anonymous one, as in conv_igemm.cu: nvcc's
// host stubs cannot tell two anonymous namespaces of one unit apart
namespace v2ce_copy {
namespace {

using namespace v2ce_hopper;

constexpr int kThreads = 512, kUnroll = 4;
constexpr int ROW_THREADS = 32, ROW_STAGES = 13, ROW_STAGE = 16384, ROW_AHEAD = 10;
constexpr int MAX_DEVICES = 16;

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

__global__ void __launch_bounds__(ROW_THREADS)
row_copy_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                long long row_bytes) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ROW_STAGES];
  const unsigned char* s = src + (long long)blockIdx.x * row_bytes;
  unsigned char* d = dst + (long long)blockIdx.x * row_bytes;
  const int lane = threadIdx.x;
  if ((((uintptr_t)s ^ (uintptr_t)d) & 15) != 0) {
    for (long long i = lane; i < row_bytes; i += ROW_THREADS) d[i] = s[i];
    return;
  }
  // head: up to the first 16-byte boundary; body: whole 16-byte units; tail
  const long long head = min((long long)((16 - ((uintptr_t)s & 15)) & 15), row_bytes);
  const long long body = (row_bytes - head) & ~15LL;
  for (long long i = lane; i < head; i += ROW_THREADS) d[i] = s[i];
  for (long long i = head + body + lane; i < row_bytes; i += ROW_THREADS) d[i] = s[i];
  if (body == 0 || lane != 0) return;

  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const unsigned char* bs = s + head;
  unsigned char* bd = d + head;
  const long long n = (body + ROW_STAGE - 1) / ROW_STAGE;
  auto bytes_of = [&](long long i) {
    return (uint32_t)min((long long)ROW_STAGE, body - i * ROW_STAGE);
  };
  auto load = [&](long long i) {
    const int st = (int)(i % ROW_STAGES);
    const uint32_t b = bytes_of(i);
    mbar_expect_tx(smem_u32(&full[st]), b);
    bulk_load(smem_u32(ring + st * ROW_STAGE), bs + i * ROW_STAGE, b, smem_u32(&full[st]));
  };
  for (int st = 0; st < ROW_STAGES; ++st) mbar_init(smem_u32(&full[st]), 1);
  fence_mbar_init();
  for (long long i = 0; i < n && i < ROW_AHEAD; ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    const int st = (int)(i % ROW_STAGES);
    mbar_wait(smem_u32(&full[st]), (uint32_t)((i / ROW_STAGES) & 1));
    fence_proxy_async();
    bulk_store(bd + i * ROW_STAGE, smem_u32(ring + st * ROW_STAGE), bytes_of(i));
    bulk_commit();
    // chunk j goes into the stage of chunk j - ROW_STAGES, whose store is
    // the group ROW_STAGES - ROW_AHEAD before the newest
    const long long j = i + ROW_AHEAD;
    if (j < n) {
      if (j >= ROW_STAGES) bulk_wait_read<ROW_STAGES - ROW_AHEAD>();
      load(j);
    }
  }
  bulk_wait<0>();
}

}  // namespace
}  // namespace v2ce_copy

using namespace v2ce_copy;

extern "C" int v2ce_layout_barrier(const void* src, void* dst, long long lead,
                                   long long plane_bytes, void* stream) {
  return launch_span_copy(src, dst, lead, plane_bytes, static_cast<cudaStream_t>(stream));
}

extern "C" int v2ce_stream_copy(const void* src, void* dst, long long rows, long long n_chunks,
                                long long chunk_bytes, void* stream) {
  return launch_span_copy(src, dst, rows * n_chunks, chunk_bytes,
                          static_cast<cudaStream_t>(stream));
}

// K16: `rows` rows of `row_bytes` each (any length and alignment).
extern "C" int v2ce_stream_copy_row(const void* src, void* dst, long long rows,
                                    long long row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem = 128 + ROW_STAGES * ROW_STAGE;
  static bool smem_set[MAX_DEVICES] = {};    // the attribute, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(row_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  row_copy_kernel<<<(unsigned)rows, ROW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), row_bytes);
  return (int)cudaGetLastError();
}
