// Two-layer PFN over pillar-sorted points, one warp per compact slot.
//
// Replaces the TPU kernel `fused_pfn_two_layer` (pillarnext_tpu/ops/pallas_pfn.py:93):
//   Dense(no bias) -> folded BN on the f32 accumulator -> one rounding to the
//   compute type -> ReLU -> per-pillar max -> broadcast back, concat ->
//   Dense -> BN -> ReLU -> per-pillar max  ==>  the (cap + 1, c1) compact table.
//
// What bounds it on Hopper: bytes.  At the flagship (N = 200k points,
// df = 10, c0 = 32, c1 = 64, cap = 98304, bf16) it reads ~4 MB of points and
// writes a 12.6 MB table; its ~0.5 GFLOP are far below the card's rate.  The
// skew of points per pillar and the occupancy matter more than FLOPs.
//
// Design: the TPU kernel's one-hot MXU placement and lane shift-scans exist
// because a TPU grid runs in order and has no cheap scatter; here each warp
// owns one slot, walks that slot's contiguous point range twice and writes
// its row once.  Blocks are persistent (a few per SM, warps striding over
// the slots), so the 18 KB of weights is staged into shared memory once per
// block.  Lane l holds channels l, l + 32, ... of each layer; the number of
// channels per lane is a template parameter, so every per-lane array stays
// in registers.  No atomics and no state across blocks: the result is
// deterministic.  Identity 0 for the max is exact: every reduced value is
// post-ReLU (pallas_pfn.py:43-45).  Weights, already rounded to the compute
// type by the wrapper, sit in shared memory as f32.  Layer 1's half that
// reads the pillar max is the same for every point of a pillar, so it is
// computed once per pillar.  The dump slot `cap` and empty slots are 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // warps per block; each warp owns one slot at a time
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDf = 16;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// one rounding to the compute type, returned as f32
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Layer 0 of one point for this lane's channels: f32 dot, BN with separate
// roundings (no fma contraction, as the plain version computes it), one
// rounding to T, ReLU.
template <typename T, int N0>
__device__ __forceinline__ void layer0(const T* __restrict__ x, const float* w0,
                                       const float* bn0, int df, int c0, int lane,
                                       float (&v)[N0]) {
  float xs[kMaxDf];
#pragma unroll
  for (int k = 0; k < kMaxDf; ++k) xs[k] = k < df ? load_f(x + k) : 0.f;
#pragma unroll
  for (int t = 0; t < N0; ++t) {
    const int c = lane + 32 * t;
    float r = 0.f;
    if (c < c0) {
      float z = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDf; ++k)
        if (k < df) z = fmaf(xs[k], w0[k * c0 + c], z);
      r = fmaxf(round_to(__fadd_rn(__fmul_rn(z, bn0[c]), bn0[c0 + c]), (T*)nullptr), 0.f);
    }
    v[t] = r;
  }
}

// acc[t] += sum over i < c0 of src_i * w[i * c1 + lane + 32 t], where src_i
// lives in lane i % 32, register i / 32
template <int N0, int N1>
__device__ __forceinline__ void warp_matvec(const float (&src)[N0], const float* w,
                                            int c0, int c1, int lane, float (&acc)[N1]) {
#pragma unroll
  for (int s = 0; s < N0; ++s) {
#pragma unroll 8
    for (int l = 0; l < 32; ++l) {
      const int i = 32 * s + l;
      const float si = __shfl_sync(0xffffffffu, src[s], l);
      if (i < c0) {
#pragma unroll
        for (int t = 0; t < N1; ++t) {
          const int j = lane + 32 * t;
          if (j < c1) acc[t] = fmaf(si, w[i * c1 + j], acc[t]);
        }
      }
    }
  }
}

template <typename T, int N0, int N1>
__global__ void pfn_two_layer_kernel(
    const T* __restrict__ feats,      // (N, df) sorted by slot
    const int* __restrict__ bounds,   // (cap + 1,) first point of each slot
    const float* __restrict__ w0g,    // (df, c0)
    const float* __restrict__ bn0g,   // (2, c0) inv, shift
    const float* __restrict__ w1g,    // (2 * c0, c1)
    const float* __restrict__ bn1g,   // (2, c1)
    T* __restrict__ out,              // (cap + 1, c1)
    int cap, int df, int c0, int c1) {
  extern __shared__ float smem[];
  float* w0 = smem;                   // df * c0
  float* bn0 = w0 + df * c0;          // 2 * c0
  float* w1 = bn0 + 2 * c0;           // 2 * c0 * c1
  float* bn1 = w1 + 2 * c0 * c1;      // 2 * c1
  for (int i = threadIdx.x; i < df * c0; i += blockDim.x) w0[i] = w0g[i];
  for (int i = threadIdx.x; i < 2 * c0; i += blockDim.x) bn0[i] = bn0g[i];
  for (int i = threadIdx.x; i < 2 * c0 * c1; i += blockDim.x) w1[i] = w1g[i];
  for (int i = threadIdx.x; i < 2 * c1; i += blockDim.x) bn1[i] = bn1g[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int slot = blockIdx.x * kWarps + (threadIdx.x >> 5); slot <= cap;
       slot += gridDim.x * kWarps) {
    T* row = out + static_cast<long long>(slot) * c1;
    // the dump slot's points are not read: its row is 0
    const int start = slot < cap ? bounds[slot] : 0;
    const int end = slot < cap ? bounds[slot + 1] : 0;

    // pass 1: per-pillar max of layer 0
    float m0[N0];
#pragma unroll
    for (int t = 0; t < N0; ++t) m0[t] = 0.f;
    for (int p = start; p < end; ++p) {
      float v[N0];
      layer0<T, N0>(feats + static_cast<long long>(p) * df, w0, bn0, df, c0, lane, v);
#pragma unroll
      for (int t = 0; t < N0; ++t) m0[t] = fmaxf(m0[t], v[t]);
    }

    // layer 1's pillar-max half, once per pillar
    float base[N1];
#pragma unroll
    for (int t = 0; t < N1; ++t) base[t] = 0.f;
    warp_matvec<N0, N1>(m0, w1 + c0 * c1, c0, c1, lane, base);

    // pass 2: layer 1 over [layer0(p), pillar max], per-pillar max
    float m1[N1];
#pragma unroll
    for (int t = 0; t < N1; ++t) m1[t] = 0.f;
    for (int p = start; p < end; ++p) {
      float v[N0];
      layer0<T, N0>(feats + static_cast<long long>(p) * df, w0, bn0, df, c0, lane, v);
      float z[N1];
#pragma unroll
      for (int t = 0; t < N1; ++t) z[t] = 0.f;
      warp_matvec<N0, N1>(v, w1, c0, c1, lane, z);
#pragma unroll
      for (int t = 0; t < N1; ++t) {
        const int j = lane + 32 * t;
        if (j < c1) {
          const float y = round_to(
              __fadd_rn(__fmul_rn(__fadd_rn(z[t], base[t]), bn1[j]), bn1[c1 + j]), (T*)nullptr);
          m1[t] = fmaxf(m1[t], fmaxf(y, 0.f));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < N1; ++t) {
      const int j = lane + 32 * t;
      if (j < c1) store_t(row + j, m1[t]);
    }
  }
}

template <typename T, int N0, int N1>
int launch(const void* feats, const void* bounds, const void* w0, const void* bn0,
           const void* w1, const void* bn1, void* out, int cap, int df, int c0,
           int c1, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (df * c0 + 2 * c0 + 2 * c0 * c1 + 2 * c1);
  auto kern = pfn_two_layer_kernel<T, N0, N1>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms < 1) sms = 1;
  int blocks = (cap + 1 + kWarps - 1) / kWarps;
  if (blocks > sms * kBlocksPerSm) blocks = sms * kBlocksPerSm;
  kern<<<blocks, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(bounds),
      static_cast<const float*>(w0), static_cast<const float*>(bn0),
      static_cast<const float*>(w1), static_cast<const float*>(bn1),
      static_cast<T*>(out), cap, df, c0, c1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* feats, const void* bounds, const void* w0, const void* bn0,
             const void* w1, const void* bn1, void* out, int cap, int df, int c0,
             int c1, cudaStream_t s) {
  const int n0 = (c0 + 31) / 32;
  const int n1 = (c1 + 31) / 32;
#define PNX_PFN_CASE(A, B)                                                       \
  if (n0 == A && n1 == B)                                                        \
    return launch<T, A, B>(feats, bounds, w0, bn0, w1, bn1, out, cap, df, c0, c1, s);
  PNX_PFN_CASE(1, 1) PNX_PFN_CASE(1, 2) PNX_PFN_CASE(1, 3) PNX_PFN_CASE(1, 4)
  PNX_PFN_CASE(2, 1) PNX_PFN_CASE(2, 2) PNX_PFN_CASE(2, 3) PNX_PFN_CASE(2, 4)
#undef PNX_PFN_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched);
// -1 when a width exceeds what the kernel was written for (df <= 16,
// c0 <= 64, c1 <= 128).
extern "C" int pnx_pfn_two_layer(const void* feats, const void* bounds,
                                 const void* w0, const void* bn0,
                                 const void* w1, const void* bn1, void* out,
                                 int cap, int df, int c0, int c1, int dtype,
                                 void* stream) {
  if (df < 1 || df > kMaxDf || c0 < 1 || c1 < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(feats, bounds, w0, bn0, w1, bn1, out, cap, df, c0, c1, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(feats, bounds, w0, bn0, w1, bn1, out, cap, df, c0, c1, s);
  return -1;
}
