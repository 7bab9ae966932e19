// Row gather with zero rows for out-of-range indices.
//
// Replaces the TPU kernel `monotone_row_gather` (pillarnext_tpu/ops/pallas_gather.py:60):
//   out[i] = table[idx[i]] if 0 <= idx[i] < R, else a zero row.
//
// What bounds it on Hopper: bytes, and at narrow rows the instructions per
// byte.  At the serving densify it writes a 1.8M x 64 bf16 image (230 MB,
// more than the 50 MB L2) and reads at most the 98304-row table (12.6 MB,
// which fits in L2).  At the cluster-mean gathers the rows are 12 bytes
// (3 x f32): there a design that spends a thread, an index load and a
// divide on every 4 bytes is bound by issue, not by bytes.  The TPU kernel
// needed index streams whose real entries ascend within a window (one DMA'd
// window plus a one-hot matmul served a tile); Hopper's L2 serves random
// rows, so this kernel assumes nothing about the order and is a byte copy,
// exact for any index stream.
//
// Design: built around the output, which is contiguous.
//  - Narrow rows, the widths the port gathers that are not a multiple of 16
//    bytes (12: 3 x f32, 6: 3 x bf16): one thread owns G = 16 /
//    gcd(row_bytes, 16) consecutive output rows (4 rows = 48 bytes at
//    12-byte rows), loads their G indices once (a vector load where
//    aligned), reads each valid row with the widest loads the table's
//    alignment allows (a 12-byte row: one 8-byte and one 4-byte load), and
//    puts the group in shared memory; the warp then stores its 32 groups,
//    which are contiguous in the output, as 16-byte stores with
//    neighbouring lanes on neighbouring chunks.  A row whose index is out
//    of range loads nothing and stays zero.  The ragged tail stores only
//    the bytes below m rows.
//  - Wide rows (a multiple of 16 bytes on 16-byte aligned pointers): 16-byte
//    chunks, neighbouring lanes on neighbouring chunks of a row, the chunk's
//    row found by a shift when the chunks per row are a power of two (a
//    32-bit divide otherwise); each thread issues the loads of 4 chunks
//    before any store.
//  - Anything else (unaligned pointers, other narrow widths) takes the same
//    chunked loop with 8-, 4- or 2-byte chunks: slower, still exact.
// The table is read through the read-only path (__ldg); it fits in L2.
// The output is written with streaming stores (__stcs): it is written once
// and, at the densify, is larger than L2.  Offsets are 32-bit unless the
// output or the table spans 2^31 bytes or more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // chunked kernel
constexpr int kUnroll = 4;          // chunks in flight per thread, chunked kernel
constexpr int kGroupThreads = 128;  // grouped kernel (its staging fits static shared memory)

__host__ __device__ constexpr int gcd_c(int a, int b) { return b == 0 ? a : gcd_c(b, a % b); }

// One thread per group of G output rows; RB row bytes, UB bytes per load.
// A warp's 32 groups are contiguous in the output: each thread puts its
// group in shared memory and the warp stores the span as whole 16-byte
// chunks, neighbouring lanes on neighbouring chunks.
template <int RB, int UB, typename Off>
__global__ void __launch_bounds__(kGroupThreads)
gather_grouped(const unsigned char* __restrict__ table, const int* __restrict__ idx,
               unsigned char* __restrict__ out, Off m, int r, bool vec_idx) {
  constexpr int G = 16 / gcd_c(RB, 16);
  constexpr int W = G * RB / 4;  // 32-bit words per group
  constexpr int Q = W / 4;       // 16-byte chunks per group (odd: no bank conflicts)
  static_assert((G * RB) % 16 == 0, "a group is whole 16-byte chunks");
  __shared__ uint4 stage[kGroupThreads * Q];
  const int lane = threadIdx.x & 31;
  const Off wrow0 = (static_cast<Off>(blockIdx.x) * kGroupThreads + (threadIdx.x & ~31)) * G;
  const Off row0 = wrow0 + static_cast<Off>(lane) * G;

  int src[G];
  if (row0 + G <= m && vec_idx) {
    if constexpr (G == 2) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(idx + row0));
      src[0] = v.x; src[1] = v.y;
    } else {
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(idx + row0) + q);
        src[4 * q] = v.x; src[4 * q + 1] = v.y; src[4 * q + 2] = v.z; src[4 * q + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) src[j] = row0 + j < m ? __ldg(idx + row0 + j) : -1;
  }

  uint32_t w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = 0u;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (static_cast<unsigned>(src[j]) < static_cast<unsigned>(r)) {
      const unsigned char* p = table + static_cast<Off>(src[j]) * RB;
      if constexpr (UB == 4 && RB % 8 == 4) {
        // an odd number of words: one 4-byte load and 8-byte loads for the
        // rest, the 4-byte one first or last as the row's address allows
        constexpr int NW = RB / 4;
        const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
        const int b = j * RB / 4;  // the row's first word in the group
        if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
#pragma unroll
          for (int u = 0; u < NW / 2; ++u) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(q) + u);
            w[b + 2 * u] = v.x;
            w[b + 2 * u + 1] = v.y;
          }
          w[b + NW - 1] = __ldg(q + NW - 1);
        } else {
          w[b] = __ldg(q);
#pragma unroll
          for (int u = 0; u < NW / 2; ++u) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(q + 1) + u);
            w[b + 1 + 2 * u] = v.x;
            w[b + 2 + 2 * u] = v.y;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < RB / UB; ++u) {
          const int o = j * RB + u * UB;  // byte offset in the group
          if constexpr (UB == 8) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + u);
            w[o / 4] = v.x;
            w[o / 4 + 1] = v.y;
          } else if constexpr (UB == 4) {
            w[o / 4] = __ldg(reinterpret_cast<const unsigned int*>(p) + u);
          } else {
            const unsigned short v = __ldg(reinterpret_cast<const unsigned short*>(p) + u);
            w[o / 4] |= static_cast<uint32_t>(v) << (8 * (o % 4));
          }
        }
      }
    }
  }

  uint4* ws = stage + (threadIdx.x & ~31) * Q;
#pragma unroll
  for (int q = 0; q < Q; ++q)
    ws[lane * Q + q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  __syncwarp();
  if (wrow0 >= m) return;
  // the warp's span, cut at row m (a whole number of 2-byte elements)
  const Off bytes = (m - wrow0 < 32 * G ? m - wrow0 : static_cast<Off>(32 * G)) * RB;
  uint4* dst = reinterpret_cast<uint4*>(out + wrow0 * RB);
#pragma unroll
  for (int u = lane; u < 32 * Q; u += 32) {
    if (static_cast<Off>(u) * 16 + 16 <= bytes) {
      __stcs(dst + u, ws[u]);
    } else if (static_cast<Off>(u) * 16 < bytes) {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(ws + u);
      unsigned short* o = reinterpret_cast<unsigned short*>(dst + u);
      for (int e = 0; e < 8 && static_cast<Off>(u) * 16 + 2 * e < bytes; ++e) o[e] = h[e];
    }
  }
}

// Chunks of type U, neighbouring threads on neighbouring chunks of the
// output; kUnroll chunks per thread, all loaded before any is stored.
template <typename U, typename Off, bool kPow2>
__global__ void __launch_bounds__(kThreads)
gather_chunked(const U* __restrict__ table, const int* __restrict__ idx, U* __restrict__ out,
               Off total, int r, Off cpr, int shift) {
  const Off base = static_cast<Off>(blockIdx.x) * (kThreads * kUnroll) + threadIdx.x;
  U v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Off t = base + k * kThreads;
    v[k] = U{};
    if (t < total) {
      const Off row = kPow2 ? (t >> shift) : t / cpr;
      const int s = __ldg(idx + row);
      if (static_cast<unsigned>(s) < static_cast<unsigned>(r))
        v[k] = __ldg(table + static_cast<Off>(s) * cpr + (t - row * cpr));
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Off t = base + k * kThreads;
    if (t < total) __stcs(out + t, v[k]);
  }
}

template <typename U, typename Off>
int launch_chunked(const void* table, const int* idx, void* out, long long m, long long r,
                   long long row_bytes, cudaStream_t s) {
  const long long cpr = row_bytes / static_cast<long long>(sizeof(U));
  const long long total = m * cpr;
  const long long blocks = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const U* t = static_cast<const U*>(table);
  U* o = static_cast<U*>(out);
  if ((cpr & (cpr - 1)) == 0) {
    int shift = 0;
    while ((1LL << shift) < cpr) ++shift;
    gather_chunked<U, Off, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, idx, o, static_cast<Off>(total), static_cast<int>(r), static_cast<Off>(cpr), shift);
  } else {
    gather_chunked<U, Off, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, idx, o, static_cast<Off>(total), static_cast<int>(r), static_cast<Off>(cpr), 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int RB, int UB, typename Off>
int launch_grouped(const void* table, const int* idx, void* out, long long m, long long r,
                   cudaStream_t s) {
  constexpr int G = 16 / gcd_c(RB, 16);
  const long long groups = (m + G - 1) / G;
  const bool vec_idx = reinterpret_cast<uintptr_t>(idx) % (G == 2 ? 8 : 16) == 0;
  gather_grouped<RB, UB, Off>
      <<<static_cast<unsigned>((groups + kGroupThreads - 1) / kGroupThreads), kGroupThreads, 0, s>>>(
          static_cast<const unsigned char*>(table), idx, static_cast<unsigned char*>(out),
          static_cast<Off>(m), static_cast<int>(r), vec_idx);
  return static_cast<int>(cudaGetLastError());
}

// The widest load unit (8, 4 or 2 bytes) that divides the row and the
// table's alignment.
template <int RB, typename Off>
int grouped_by_unit(const void* table, const int* idx, void* out, long long m, long long r,
                    uintptr_t table_align, cudaStream_t s) {
  if constexpr (RB % 8 == 0) {
    if (table_align % 8 == 0) return launch_grouped<RB, 8, Off>(table, idx, out, m, r, s);
  }
  if constexpr (RB % 4 == 0) {
    if (table_align % 4 == 0) return launch_grouped<RB, 4, Off>(table, idx, out, m, r, s);
  }
  return launch_grouped<RB, 2, Off>(table, idx, out, m, r, s);
}

template <typename Off>
int dispatch(const void* table, const int* idx, void* out, long long m, long long r,
             long long row_bytes, cudaStream_t s) {
  const uintptr_t t_align = reinterpret_cast<uintptr_t>(table);
  const bool out16 = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (row_bytes % 16 == 0 && t_align % 16 == 0 && out16)
    return launch_chunked<uint4, Off>(table, idx, out, m, r, row_bytes, s);
  // the narrow rows the port gathers: 3 x f32 (cluster means) and 3 x bf16
  if (out16 && t_align % 2 == 0) {
    if (row_bytes == 12) return grouped_by_unit<12, Off>(table, idx, out, m, r, t_align, s);
    if (row_bytes == 6) return grouped_by_unit<6, Off>(table, idx, out, m, r, t_align, s);
  }
  const uintptr_t align = t_align | reinterpret_cast<uintptr_t>(out) | static_cast<uintptr_t>(row_bytes);
  if (align % 8 == 0) return launch_chunked<uint2, Off>(table, idx, out, m, r, row_bytes, s);
  if (align % 4 == 0) return launch_chunked<unsigned int, Off>(table, idx, out, m, r, row_bytes, s);
  if (align % 2 == 0) return launch_chunked<unsigned short, Off>(table, idx, out, m, r, row_bytes, s);
  return -1;
}

}  // namespace

// Returns a cudaError_t (0 = launched); -1 for a row size or pointer that is
// not a whole number of 2-byte elements.
extern "C" int pnx_row_gather(const void* table, const void* idx, void* out,
                              long long m, long long r, long long row_bytes,
                              void* stream) {
  if (m == 0) return 0;
  if (m < 0 || r < 0 || r > 0x7fffffffLL || row_bytes <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  // 32-bit offsets while the output and the table (plus one block's reach)
  // stay below 2^31 bytes
  const long long reach = (m + kThreads * kUnroll * 16LL) * row_bytes;
  if (reach < (1LL << 31) && r * row_bytes < (1LL << 31))
    return dispatch<int>(table, ix, out, m, r, row_bytes, s);
  return dispatch<long long>(table, ix, out, m, r, row_bytes, s);
}
