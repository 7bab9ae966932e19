// Row gather with zero rows for out-of-range indices.
//
// Replaces the TPU kernel `monotone_row_gather` (pillarnext_tpu/ops/pallas_gather.py:60):
//   out[i] = table[idx[i]] if 0 <= idx[i] < R, else a zero row.
//
// What bounds it on Hopper: bytes.  At the flagship densify it writes a
// 1.8M x 64 bf16 image (~230 MB) and reads at most the 98304-row table,
// which stays in the 50 MB L2.  The TPU kernel needed index streams whose
// real entries ascend within a window (so one DMA'd window plus a one-hot
// matmul could serve a tile); Hopper's L2 serves random rows, so this
// kernel assumes nothing about the order and is exact for any index stream.
//
// Design: a pure byte copy.  Neighbouring threads take neighbouring
// 16-byte chunks of a row (64 bf16 channels = 128 B = 8 threads), so each
// warp stores whole rows with full-width vector stores.  Rows whose size is
// not a multiple of 16 B fall back to 4- or 2-byte chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Chunk>
__global__ void row_gather_kernel(const Chunk* __restrict__ table,
                                  const int* __restrict__ idx,
                                  Chunk* __restrict__ out, long long m,
                                  long long r, long long chunks_per_row) {
  const long long total = m * chunks_per_row;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / chunks_per_row;
    const long long col = t - row * chunks_per_row;
    const long long src = idx[row];
    Chunk v;
    if (src >= 0 && src < r) {
      v = table[src * chunks_per_row + col];
    } else {
      v = Chunk{};  // zero-initialised chunk
    }
    out[t] = v;
  }
}

template <typename Chunk>
int launch(const void* table, const void* idx, void* out, long long m,
           long long r, long long row_bytes, cudaStream_t stream) {
  const long long cpr = row_bytes / static_cast<long long>(sizeof(Chunk));
  const long long total = m * cpr;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond ~64 blocks per SM
  row_gather_kernel<Chunk><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const Chunk*>(table), static_cast<const int*>(idx),
      static_cast<Chunk*>(out), m, r, cpr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t (0 = launched); -1 for a row size that is not a
// whole number of 2-byte elements.
extern "C" int pnx_row_gather(const void* table, const void* idx, void* out,
                              long long m, long long r, long long row_bytes,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(table, idx, out, m, r, row_bytes, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(table, idx, out, m, r, row_bytes, s);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return launch<uint16_t>(table, idx, out, m, r, row_bytes, s);
  return -1;
}
