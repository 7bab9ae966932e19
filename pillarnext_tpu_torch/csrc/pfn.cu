// Two-layer PFN over pillar-sorted points, split by points; layer 1 on the
// tensor cores in bf16, everything else register-blocked on the CUDA cores.
//
// Replaces the TPU kernel `fused_pfn_two_layer` (pillarnext_tpu/ops/pallas_pfn.py:93):
//   Dense(no bias) -> folded BN on the f32 accumulator -> one rounding to the
//   compute type -> ReLU -> per-pillar max -> broadcast back, concat ->
//   Dense -> BN -> ReLU -> per-pillar max  ==>  the (cap + 1, c1) compact table.
//
// What bounds it on Hopper: bytes in bf16 (at the serving frame, N = 200k
// points, df = 10, c0 = 32, c1 = 64, cap = 98304, ~65k occupied slots:
// 17.4 MB, 5.2 us against 1.21 GFLOP, 1.2 us on the tensor cores, counting
// layer 1's pillar half once per slot), operations in f32 (18 us on the
// CUDA cores; TF32 tensor cores would break the f32 tolerance).  This
// kernel does that half per point (1.77 GFLOP), for the tolerance's sake
// (step 4 below).  Short of
// either, latency: pillars hold ~2 points (median; 99th percentile 12), so
// work split by pillars gives a warp almost nothing to overlap, and a third
// of the serving bucket's slots are empty.
//
// Design.  A block owns the slots whose first point lies in its window
// [wW, (w + 1)W) of the sorted stream, W = 112; blocks are persistent and
// stride over windows.  The block finds its first and last owned point by
// a block-wide search of the ascending `slot` array (128 probes per round:
// one round when the boundary is within 128 points, as it almost always
// is).  It then walks its points in chunks of at most 128 that end on a
// pillar boundary, so every pillar of a chunk is complete (a window of 112
// points plus the pillar that crosses its end nearly always fits one
// chunk at the measured sizes: median 2 points, maximum 26):
//   1. stage the chunk's features (16-byte cp.async copies of its bytes)
//      and slots in shared memory; a warp ballot scan numbers its pillars;
//   2. layer 0, (128 x df) x (df x c0), as f32 FMAs on 4 x 8 register
//      blocks in both types, each sum in ascending k as the plain version's
//      matmul takes it (on the tensor cores, its other summation order
//      rounded ~6x more v0 values the other way, and one such v0 moved a
//      layer-1 value across the ReLU by 129 bf16 ulps); BN on the f32 sum
//      with separate roundings (multiply, then add), one rounding, ReLU;
//      v0 is kept in shared memory;
//   3. the pillar max of v0 by 16-byte row chunks in shared memory (the
//      identity 0 is exact: every value is post-ReLU);
//   4. layer 1 as one (128 x 2c0) x (2c0 x c1) product over [v0, m0 of the
//      point's pillar] (one f32 sum over all 2c0 terms, as the plain
//      version's matmul): in bf16 mma.sync m16n8k16 with f32 accumulators
//      (the bf16 products are exact in f32, so only the order of the sums
//      differs), in f32 FMAs on 4 x 8 register blocks (TF32 tensor cores
//      would break the f32 tolerance); BN, one rounding, ReLU into shared
//      memory;
//   5. the pillar max of v1, written once per slot as 16-byte stores,
//      together with zero rows for any empty slots before the next slot.
//   Steps 4 and 5 run 32 output columns at a time, so v1 holds one group.
// A pillar of more than 128 points takes two sweeps of chunks (the first
// for its layer-0 max, the second for layer 1), so any pillar size is
// right.  Rows before the first slot and after the last (the ~33k unused
// slots of the serving bucket and the dump row `cap`) are zeroed by all
// blocks together.  Nothing carries between blocks and there are no
// atomics: the result is deterministic.  The weights, rounded to the
// compute type here, are staged into shared memory once per block.
// Chunks are not double-buffered: several blocks per SM overlap one
// block's loads with another's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

constexpr int kT = 128;        // chunk length, points
constexpr int kWindow = 112;   // window length: most windows' pillars fit one chunk
constexpr int kThreads = 128;  // 4 warps x 32 rows
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDf = 16;
constexpr int kMaxC0 = 64;
constexpr int kMaxC1 = 128;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T>
struct Layout {
  // padded widths (multiples of 32 columns), row strides in elements
  int c0p, c1p, k1;      // k1 = 2 * c0p, the depth of layer 1
  int s0, s1;            // strides of v0 / m0 rows and of v1 rows
  int w1s;               // stride of the staged W1
  static constexpr int pad = 16 / sizeof(T);  // one 16-byte chunk per row
  __host__ __device__ Layout(int c0, int c1) {
    c0p = round_up(c0, 32);
    c1p = round_up(c1, 32);
    k1 = 2 * c0p;
    s0 = c0p + pad;
    s1 = 32 + pad;  // v1 holds one 32-column group
    if constexpr (std::is_same<T, float>::value)
      w1s = c1p;  // f32: W1[k][n]
    else
      w1s = k1 + pad;  // bf16: W1^T[n][k], k pairs contiguous for mma.sync
  }
  __host__ __device__ size_t xs_bytes() const { return kT * kMaxDf * sizeof(T) + 32; }
  __host__ __device__ size_t buf_bytes() const {  // v0, m0, then v1
    return (2ull * kT * s0 + 1ull * kT * s1) * sizeof(T);
  }
  __host__ __device__ size_t w0_bytes() const {  // f32 [kMaxDf][c0p], rounded to T
    return static_cast<size_t>(kMaxDf) * c0p * sizeof(float);
  }
  __host__ __device__ size_t w1_bytes() const {
    return (std::is_same<T, float>::value ? k1 * w1s : c1p * w1s) * sizeof(T);
  }
  __host__ __device__ size_t smem_bytes() const {
    return xs_bytes() + buf_bytes() + w0_bytes() + w1_bytes() +
           (2 * c0p + 2 * c1p) * sizeof(float) + (c0p + c1p) * sizeof(T) +
           (3 * kT + 1 + kWarps + 1) * sizeof(int);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// BN on the f32 sum with separate roundings (no fma contraction, as the
// plain version computes it), one rounding to T, ReLU
template <typename T>
__device__ __forceinline__ T bn_relu(float z, float inv, float shift) {
  const float y = to_f(from_f<T>(__fadd_rn(__fmul_rn(z, inv), shift)));
  return from_f<T>(fmaxf(y, 0.f));
}

// elementwise max of two 16-byte chunks of T
__device__ __forceinline__ uint4 max16(uint4 a, uint4 b, float*) {
  float4 x = *reinterpret_cast<float4*>(&a), y = *reinterpret_cast<float4*>(&b);
  float4 r = make_float4(fmaxf(x.x, y.x), fmaxf(x.y, y.y), fmaxf(x.z, y.z), fmaxf(x.w, y.w));
  return *reinterpret_cast<uint4*>(&r);
}
__device__ __forceinline__ uint4 max16(uint4 a, uint4 b, __nv_bfloat16*) {
  uint4 r;
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __hmax2(x[i], y[i]);
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// First i in [lo, hi) with slot[i] >= v, or hi; slot ascending.  Called by
// the whole block with the same arguments.  The first round probes the 128
// points from lo; each later round cuts the range 128-fold.
__device__ int block_lower_bound(const int* __restrict__ slot, int v, int lo, int hi) {
  long long step = 1;
  while (lo < hi) {
    const long long pos = lo + static_cast<long long>(threadIdx.x) * step;
    const bool lt = pos < hi && __ldg(slot + pos) < v;
    const int c = __syncthreads_count(lt);
    if (c == 0) return lo;
    const long long next = lo + static_cast<long long>(c) * step;
    lo = static_cast<int>(lo + static_cast<long long>(c - 1) * step + 1);
    if (c < kThreads && next < hi) hi = static_cast<int>(next);  // probe `next` was >= v
    step = (hi - lo + kThreads - 1) / kThreads;
    if (step < 1) step = 1;
  }
  return lo;
}

template <typename T>
struct Smem {
  unsigned char* xs;  // staged feature bytes of the chunk
  T* v0;              // (kT, s0) layer 0 of each point
  T* m0;              // (kT, s0) layer-0 max of each pillar of the chunk
  T* v1;              // (kT, s1) layer 1 of each point, one column group
  float* w0;  // (kMaxDf, c0p) W0 rounded to T
  T* w1;
  float* bn0;  // (2, c0p)
  float* bn1;  // (2, c1p)
  T* run0;     // (c0p) running layer-0 max of a pillar longer than a chunk
  T* run1;     // (c1p)
  int* sl;     // (kT) slot of each point
  int* seg;    // (kT) pillar of each point within the chunk
  int* beg;    // (kT + 1) first point of each pillar within the chunk
  int* wsum;   // (kWarps) pillars starting in each warp's rows
  int* misc;   // [0] pillars in the chunk
};

template <typename T>
__device__ Smem<T> carve(unsigned char* base, const Layout<T>& L) {
  Smem<T> s;
  unsigned char* p = base;
  s.xs = p; p += L.xs_bytes();
  s.v0 = reinterpret_cast<T*>(p);
  s.m0 = s.v0 + kT * L.s0;
  s.v1 = s.m0 + kT * L.s0;
  p += L.buf_bytes();
  s.w0 = reinterpret_cast<float*>(p); p += L.w0_bytes();
  s.w1 = reinterpret_cast<T*>(p); p += L.w1_bytes();
  s.bn0 = reinterpret_cast<float*>(p); p += 2 * L.c0p * sizeof(float);
  s.bn1 = reinterpret_cast<float*>(p); p += 2 * L.c1p * sizeof(float);
  s.run0 = reinterpret_cast<T*>(p); p += L.c0p * sizeof(T);
  s.run1 = reinterpret_cast<T*>(p); p += L.c1p * sizeof(T);
  s.sl = reinterpret_cast<int*>(p); p += kT * sizeof(int);
  s.seg = reinterpret_cast<int*>(p); p += kT * sizeof(int);
  s.beg = reinterpret_cast<int*>(p); p += (kT + 1) * sizeof(int);
  s.wsum = reinterpret_cast<int*>(p); p += kWarps * sizeof(int);
  s.misc = reinterpret_cast<int*>(p);
  return s;
}

struct Args {
  const void* feats;  // (n, df) sorted by slot
  const int* slot;    // (n,) ascending; cap = dump
  const float* w0;    // (df, c0)
  const float* bn0;   // (2, c0) inv, shift
  const float* w1;    // (2 * c0, c1)
  const float* bn1;   // (2, c1)
  void* out;          // (cap + 1, c1)
  int n, cap, df, c0, c1;
};

enum Mode { kNormal = 0, kBigMax0 = 1, kBigLayer1 = 2 };

template <typename T>
struct Pfn {
  const Args& a;
  const Layout<T>& L;
  const Smem<T>& s;
  int lane, warp;

  // ---- staging --------------------------------------------------------
  __device__ void stage(int p, int q) {
    const int rb = a.df * static_cast<int>(sizeof(T));
    const long long total = static_cast<long long>(a.n) * rb;
    const long long b0 = static_cast<long long>(p) * rb, b1 = static_cast<long long>(q) * rb;
    const long long a0 = b0 & ~15LL;
    const unsigned char* g = static_cast<const unsigned char*>(a.feats);
    for (long long k = a0 + 16 * threadIdx.x; k < b1; k += 16 * kThreads) {
      if (k + 16 <= total) {
        cp_async16(s.xs + (k - a0), g + k);
      } else {
        for (long long h = k; h < total; h += 2)
          *reinterpret_cast<unsigned short*>(s.xs + (h - a0)) =
              *reinterpret_cast<const unsigned short*>(g + h);
      }
    }
    const int i = threadIdx.x;
    const int cnt = q - p;
    const bool in = i < cnt;
    const int sv = in ? __ldg(a.slot + p + i) : 0;
    const bool start = in && (i == 0 || sv != __ldg(a.slot + p + i - 1));
    const unsigned ball = __ballot_sync(0xffffffffu, start);
    if (lane == 0) s.wsum[warp] = __popc(ball);
    cp_async_wait_all();
    __syncthreads();
    int before = 0, total_segs = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s.wsum[w] : 0;
      total_segs += s.wsum[w];
    }
    const int k = before + __popc(ball & ((1u << lane) - 1u)) + (start ? 1 : 0) - 1;
    s.sl[i] = sv;
    s.seg[i] = in ? k : 0;
    if (start) s.beg[k] = i;
    if (i == 0) {
      s.beg[total_segs] = cnt;
      s.misc[0] = total_segs;
    }
    __syncthreads();
  }

  // row i of the chunk that starts at point p, in the staged bytes
  __device__ __forceinline__ const T* xrow(int p, int i) const {
    const long long rb = static_cast<long long>(a.df) * sizeof(T);
    const long long off = (static_cast<long long>(p) + i) * rb - ((static_cast<long long>(p) * rb) & ~15LL);
    return reinterpret_cast<const T*>(s.xs + off);
  }

  // ---- layer 0: v0 = relu(round((x @ W0) * inv0 + shift0)) ------------
  // On the CUDA cores in both types, each sum in ascending k by fma: with
  // K = df <= 16 this is cheap, and it keeps v0's roundings where the plain
  // version's f32 matmul puts them (a v0 rounded the other way moves every
  // layer-1 sum of its pillar).  Lane (rg, cg) holds rows rg + 8r and
  // columns cg * 8 + c of its warp's 32 x 32 block.
  __device__ void layer0(int p) {
    const int row0 = warp * 32;
    const int rg = lane >> 2, cg = lane & 3;
    const T* xr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) xr[r] = xrow(p, row0 + rg + 8 * r);
#pragma unroll 1
    for (int n0 = cg * 8; n0 < L.c0p; n0 += 32) {
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      for (int k = 0; k < a.df; ++k) {
        const float4 b0 = *reinterpret_cast<const float4*>(s.w0 + k * L.c0p + n0);
        const float4 b1 = *reinterpret_cast<const float4*>(s.w0 + k * L.c0p + n0 + 4);
        const float w[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = to_f(xr[r][k]);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(x, w[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = n0 + c;
          s.v0[(row0 + rg + 8 * r) * L.s0 + col] =
              bn_relu<T>(acc[r][c], s.bn0[col], s.bn0[L.c0p + col]);
        }
    }
  }

  // ---- layer 1 over [v0, m0 of the pillar], 32 columns at a time -------
  __device__ void layer1(int g0) {  // columns [g0, g0 + 32) into v1
    const int row0 = warp * 32;
    if constexpr (std::is_same<T, float>::value) {
      const int rg = lane >> 2, cg = lane & 3;
      const float* vr[4];
      const float* mr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + rg + 8 * r;
        vr[r] = s.v0 + row * L.s0;
        mr[r] = s.m0 + s.seg[row] * L.s0;
      }
#pragma unroll 1
      {
        const int n0 = g0 + cg * 8;
        float acc[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
        // k ascending over [v0 | m0]: the v0 half, then the m0 half
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          const float* src[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) src[r] = half == 0 ? vr[r] : mr[r];
          const float* wh = s.w1 + half * L.c0p * L.w1s + n0;
#pragma unroll 4
          for (int k = 0; k < L.c0p; ++k) {
            const float4 b0 = *reinterpret_cast<const float4*>(wh + k * L.w1s);
            const float4 b1 = *reinterpret_cast<const float4*>(wh + k * L.w1s + 4);
            const float w[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float x = src[r][k];
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(x, w[c], acc[r][c]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int col = n0 + c;
            s.v1[(row0 + rg + 8 * r) * L.s1 + col - g0] =
                bn_relu<T>(acc[r][c], s.bn1[col], s.bn1[L.c1p + col]);
          }
      }
    } else {
      const int g = lane >> 2, t = lane & 3;
      const T* vr[2][2];
      const T* mr[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + m * 16 + g + 8 * h;
          vr[m][h] = s.v0 + row * L.s0;
          mr[m][h] = s.m0 + s.seg[row] * L.s0;
        }
#pragma unroll 1
      {
        const int n0 = g0;
        float acc[2][4][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < L.k1; k0 += 16) {
          uint32_t af[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int k = k0 + 2 * t + (q >> 1) * 8;
              const T* r = k < L.c0p ? vr[m][q & 1] + k : mr[m][q & 1] + (k - L.c0p);
              af[m][q] = *reinterpret_cast<const uint32_t*>(r);
            }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const T* wn = s.w1 + (n0 + j * 8 + g) * L.w1s + k0;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wn + 2 * t);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wn + 2 * t + 8);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_bf16(acc[m][j], af[m], b0, b1);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row0 + m * 16 + g + (e >> 1) * 8;
              const int col = n0 + j * 8 + 2 * t + (e & 1);
              s.v1[row * L.s1 + col - g0] = bn_relu<T>(acc[m][j][e], s.bn1[col], s.bn1[L.c1p + col]);
            }
      }
    }
  }

  // ---- output rows ------------------------------------------------------
  // chunk ch (16 bytes of T) of row `row` of the output, from v (or zeros)
  __device__ void store_chunk(long long row, int ch, uint4 v) const {
    constexpr int E = 16 / sizeof(T);
    T* out = static_cast<T*>(a.out) + row * a.c1;
    const int c = ch * E;
    if (c >= a.c1) return;
    if (c + E <= a.c1 && ((reinterpret_cast<uintptr_t>(out + c) & 15) == 0)) {
      *reinterpret_cast<uint4*>(out + c) = v;
    } else {
      const T* e = reinterpret_cast<const T*>(&v);
      for (int i = 0; i < E && c + i < a.c1; ++i) out[c + i] = e[i];
    }
  }

  // zero rows [r0, r1) of the output, spread over `nthreads` threads
  __device__ void zero_rows(long long r0, long long r1, long long tid, long long nthreads) const {
    constexpr int E = 16 / sizeof(T);
    const int nch = (a.c1 + E - 1) / E;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (long long u = tid; u < (r1 - r0) * nch; u += nthreads)
      store_chunk(r0 + u / nch, static_cast<int>(u % nch), z);
  }

  // ---- one chunk [p, q) of whole pillars (or one part of a long one) ----
  // `after`: the slot of the first point after the chunk's last pillar, or
  // -1 when the rows after it are zeroed elsewhere.
  __device__ void chunk(int p, int q, Mode mode, int after) {
    __syncthreads();  // the previous chunk is done with shared memory
    stage(p, q);
    layer0(p);
    __syncthreads();
    const int nseg = s.misc[0];
    constexpr int E = 16 / sizeof(T);
    if (mode != kBigLayer1) {
      // pillar max of v0 by 16-byte chunks, several pillars per warp
      const int nch = L.c0p / E;
      const int per = 32 / nch;
      const int ch = lane % nch;
      if (lane < per * nch) {
        for (int k = warp * per + lane / nch; k < nseg; k += kWarps * per) {
          uint4 m = make_uint4(0u, 0u, 0u, 0u);
          for (int r = s.beg[k]; r < s.beg[k + 1]; ++r)
            m = max16(m, *reinterpret_cast<const uint4*>(s.v0 + r * L.s0 + ch * E), (T*)nullptr);
          if (mode == kBigMax0) {
            uint4* run = reinterpret_cast<uint4*>(s.run0) + ch;
            *run = max16(*run, m, (T*)nullptr);
          } else {
            *reinterpret_cast<uint4*>(s.m0 + k * L.s0 + ch * E) = m;
          }
        }
      }
      if (mode == kBigMax0) return;
    } else {
      // every point of the chunk is in the long pillar: m0 is the running max
      for (int c = threadIdx.x; c < L.c0p; c += kThreads) s.m0[c] = s.run0[c];
    }
    __syncthreads();
    // layer 1 and its pillar max, 32 columns at a time
    const int nch = 32 / E;  // 16-byte chunks of a 32-column group
    const int per = 32 / nch;
    const int ch = lane % nch;
    for (int g0 = 0; g0 < L.c1p; g0 += 32) {
      layer1(g0);
      __syncthreads();
      const int gch = g0 / E + ch;  // the chunk's index in an output row
      for (int k = warp * per + lane / nch; k < nseg; k += kWarps * per) {
        uint4 m = make_uint4(0u, 0u, 0u, 0u);
        for (int r = s.beg[k]; r < s.beg[k + 1]; ++r)
          m = max16(m, *reinterpret_cast<const uint4*>(s.v1 + r * L.s1 + ch * E), (T*)nullptr);
        if (mode == kBigLayer1) {
          uint4* run = reinterpret_cast<uint4*>(s.run1) + gch;
          *run = max16(*run, m, (T*)nullptr);
          continue;
        }
        const int sv = s.sl[s.beg[k]];
        store_chunk(sv, gch, m);
        const int nxt = k + 1 < nseg ? s.sl[s.beg[k + 1]] : after;
        for (int r = sv + 1; r < nxt; ++r) store_chunk(r, gch, make_uint4(0u, 0u, 0u, 0u));
      }
      __syncthreads();  // v1 is free for the next group
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) pfn_two_layer_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout<T> L(a.c0, a.c1);
  const Smem<T> s = carve<T>(smem_raw, L);
  Pfn<T> f{a, L, s, static_cast<int>(threadIdx.x & 31), static_cast<int>(threadIdx.x >> 5)};

  // weights, rounded to T, zero-padded to the padded widths
  constexpr bool kF32 = std::is_same<T, float>::value;
  for (int i = threadIdx.x; i < kMaxDf * L.c0p; i += kThreads) {
    const int k = i / L.c0p, n = i % L.c0p;
    s.w0[k * L.c0p + n] = to_f(from_f<T>(k < a.df && n < a.c0 ? a.w0[k * a.c0 + n] : 0.f));
  }
  for (int i = threadIdx.x; i < L.k1 * L.c1p; i += kThreads) {
    const int k = i / L.c1p, n = i % L.c1p;
    // rows [0, c0) of W1 meet v0, rows [c0, 2 c0) meet the pillar max
    const int src = k < L.c0p ? (k < a.c0 ? k : -1) : (k - L.c0p < a.c0 ? a.c0 + k - L.c0p : -1);
    const T v = from_f<T>(src >= 0 && n < a.c1 ? a.w1[src * a.c1 + n] : 0.f);
    if (kF32) s.w1[k * L.w1s + n] = v; else s.w1[n * L.w1s + k] = v;
  }
  for (int i = threadIdx.x; i < L.c0p; i += kThreads) {
    s.bn0[i] = i < a.c0 ? to_f(from_f<T>(a.bn0[i])) : 0.f;
    s.bn0[L.c0p + i] = i < a.c0 ? to_f(from_f<T>(a.bn0[a.c0 + i])) : 0.f;
  }
  for (int i = threadIdx.x; i < L.c1p; i += kThreads) {
    s.bn1[i] = i < a.c1 ? to_f(from_f<T>(a.bn1[i])) : 0.f;
    s.bn1[L.c1p + i] = i < a.c1 ? to_f(from_f<T>(a.bn1[a.c1 + i])) : 0.f;
  }
  __syncthreads();

  // points in slots below cap, the first and the last such slot
  const int n_eff = block_lower_bound(a.slot, a.cap, 0, a.n);
  const int first = n_eff > 0 ? __ldg(a.slot) : a.cap + 1;
  const int last = n_eff > 0 ? __ldg(a.slot + n_eff - 1) : -1;

  // rows before the first slot and after the last (the dump row included),
  // zeroed by all blocks together
  {
    const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long nth = static_cast<long long>(gridDim.x) * kThreads;
    if (n_eff == 0) {
      f.zero_rows(0, a.cap + 1LL, tid, nth);
    } else {
      f.zero_rows(0, first, tid, nth);
      f.zero_rows(last + 1LL, a.cap + 1LL, tid, nth);
    }
  }

  for (long long w0 = static_cast<long long>(blockIdx.x) * kWindow; w0 < n_eff;
       w0 += static_cast<long long>(gridDim.x) * kWindow) {
    const int lo = static_cast<int>(w0);
    const int we = static_cast<int>(w0 + kWindow < n_eff ? w0 + kWindow : n_eff);
    // first point of the first slot that starts in the window
    const int s0 = lo == 0 ? 0 : block_lower_bound(a.slot, __ldg(a.slot + lo - 1) + 1, lo, n_eff);
    if (s0 >= we) continue;  // a long pillar covers the whole window
    const int e = block_lower_bound(a.slot, __ldg(a.slot + we - 1) + 1, we, n_eff);
    const int tail = e < n_eff ? __ldg(a.slot + e) : -1;  // -1: zeroed above
    int p = s0;
    while (p < e) {
      int q = e;
      if (e - p > kT) q = block_lower_bound(a.slot, __ldg(a.slot + p + kT), p, p + kT);
      if (q > p) {
        f.chunk(p, q, kNormal, q < e ? __ldg(a.slot + q) : tail);
        p = q;
        continue;
      }
      // one pillar of more than kT points: its layer-0 max over every part
      // first, then layer 1 over every part
      const int sv = __ldg(a.slot + p);
      const int pe = block_lower_bound(a.slot, sv + 1, p + kT, e);
      __syncthreads();
      for (int c = threadIdx.x; c < L.c0p; c += kThreads) s.run0[c] = from_f<T>(0.f);
      for (int c = threadIdx.x; c < L.c1p; c += kThreads) s.run1[c] = from_f<T>(0.f);
      for (int c0 = p; c0 < pe; c0 += kT) f.chunk(c0, c0 + kT < pe ? c0 + kT : pe, kBigMax0, -1);
      for (int c0 = p; c0 < pe; c0 += kT) f.chunk(c0, c0 + kT < pe ? c0 + kT : pe, kBigLayer1, -1);
      __syncthreads();
      constexpr int E = 16 / sizeof(T);
      const int nxt = pe < e ? __ldg(a.slot + pe) : tail;
      for (int ch = threadIdx.x; ch < L.c1p / E; ch += kThreads)
        f.store_chunk(sv, ch, reinterpret_cast<const uint4*>(s.run1)[ch]);
      f.zero_rows(sv + 1LL, nxt > sv ? nxt : sv + 1LL, threadIdx.x, kThreads);
      p = pe;
    }
  }
}

struct Shape {
  int smem;    // dynamic shared memory of a block, bytes
  int per_sm;  // resident blocks per SM (0: a block does not fit)
  int sms;     // SMs of the device
};

// The launch shape for (c0, c1) on the current device, worked out once per
// (T, c0, c1, device): the attribute, occupancy and SM-count queries are
// host calls that a serving frame should not repeat.
template <typename T>
int launch_shape(int c0, int c1, Shape* shape) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Shape> cache;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto key = std::make_tuple(device, c0, c1);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *shape = it->second;
    return 0;
  }
  Shape sh{static_cast<int>(Layout<T>(c0, c1).smem_bytes()), 0, 0};
  auto kern = pfn_two_layer_kernel<T>;
  // the attribute belongs to the kernel, not to (c0, c1): set it to the
  // largest widths' need, so that a shape cached earlier stays launchable
  const int most = static_cast<int>(Layout<T>(kMaxC0, kMaxC1).smem_bytes());
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sh.per_sm, kern, kThreads, sh.smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sh.sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cache.emplace(key, sh);
  *shape = sh;
  return 0;
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  Shape sh;
  const int e = launch_shape<T>(a.c0, a.c1, &sh);
  if (e != 0) return e;
  const long long resident = static_cast<long long>(sh.sms > 0 ? sh.sms : 1) * (sh.per_sm > 0 ? sh.per_sm : 1);
  long long blocks = (static_cast<long long>(a.n) + kWindow - 1) / kWindow;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  pfn_two_layer_kernel<T><<<static_cast<unsigned>(blocks), kThreads, sh.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The weights and BN rows are f32 and
// are rounded to the compute type here.  Returns a cudaError_t (0 =
// launched); -1 when a width exceeds what the kernel was written for
// (df <= 16, c0 <= 64, c1 <= 128) or the features are not 16-byte aligned.
extern "C" int pnx_pfn_two_layer(const void* feats, const void* slot, const void* w0,
                                 const void* bn0, const void* w1, const void* bn1, void* out,
                                 int n, int cap, int df, int c0, int c1, int dtype,
                                 void* stream) {
  if (df < 1 || df > kMaxDf || c0 < 1 || c0 > kMaxC0 || c1 < 1 || c1 > kMaxC1 || n < 0 || cap < 0)
    return -1;
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0) return -1;
  const Args a{feats, static_cast<const int*>(slot), static_cast<const float*>(w0),
               static_cast<const float*>(bn0), static_cast<const float*>(w1),
               static_cast<const float*>(bn1), out, n, cap, df, c0, c1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return -1;
}

// The launch shape for widths (c0, c1) and dtype (0 = float32, 1 =
// bfloat16): a block's dynamic shared memory in bytes and the blocks that
// fit on one SM.  Returns a cudaError_t (0 = ok); -1 for widths or a dtype
// the kernel does not take.
extern "C" int pnx_pfn_launch_shape(int c0, int c1, int dtype, int* smem_bytes, int* blocks_per_sm) {
  if (c0 < 1 || c0 > kMaxC0 || c1 < 1 || c1 > kMaxC1) return -1;
  Shape sh{0, 0, 0};
  int e = -1;
  if (dtype == 0) e = launch_shape<float>(c0, c1, &sh);
  if (dtype == 1) e = launch_shape<__nv_bfloat16>(c0, c1, &sh);
  *smem_bytes = sh.smem;
  *blocks_per_sm = sh.per_sm;
  return e;
}
