// Broadcast segmented reduction over a sorted segment stream.
//
// Replaces the TPU kernel `sorted_segment_bcast` / `_pass`
// (pillarnext_tpu/ops/pallas_segscan.py:124 / :49): for non-decreasing seg,
//   out[i] = reduce(x[j] for every j with seg[j] == seg[i]),  reduce = max | sum,
// i.e. segment_<reduce>(x, seg)[seg].  It carries the PFN max-broadcast of the
// training forward (x: 1.2M x 32 bf16 at B = 4, 300k points per sample).
//
// What bounds it on Hopper: bytes.  Read x and seg once, write out once:
// 1.2M x (64 + 4 + 64) B ~ 158 MB, ~0.047 ms at 3.35 TB/s.
//
// The TPU kernel ran a sequential grid with a VMEM carry and a log2(T)
// shift-scan per tile, twice (prefix and suffix).  Blocks on Hopper run in
// no order, so nothing is carried between them.  Instead:
//   1. `ends`: one warp per tile of `tile` rows finds the tile's first run
//      (rows equal to seg[first]) and last run (rows equal to seg[last]) with
//      warp ballots and reduces each over the tile: two entries per tile,
//      (seg, value).  A tile that holds one run emits its total once and the
//      reduction's identity for the second entry, so no row is counted twice.
//   2. The entries form a sorted segment stream 2 * n / tile long: the
//      wrapper resolves runs that cross tiles by applying the same two passes
//      to it, recursively, until the stream fits one tile.
//   3. `write`: one warp per tile writes every row.  Runs inside the tile are
//      reduced by a walk over the tile; the first and last run take the
//      resolved entry values, and their x rows are not read again.
// Lanes hold channels (32 per pass over the row), so every row is one
// coalesced load or store per warp.  Cost is linear in N: a segment of half
// the stream (the dump slot of masked points) is read once in `ends` and
// written once in `write`.  No atomics: sums run in a fixed order, in f32,
// and give the same bits run to run; max is exact.  No host synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct MaxOp {
  __device__ static float identity() { return -CUDART_INF_F; }
  // NaN-propagating, like torch's amax
  __device__ static float combine(float a, float b) { return (a > b || a != a) ? a : b; }
};

struct SumOp {
  __device__ static float identity() { return 0.0f; }
  __device__ static float combine(float a, float b) { return a + b; }
};

// [r0, head_end) is the tile's first run, [tail_start, r1) its last run
// (the same run when fs == ls).  Warp-uniform: every lane gets the result.
__device__ __forceinline__ void run_bounds(const int* __restrict__ seg, long long r0,
                                           long long r1, int fs, int ls, int lane,
                                           long long* head_end, long long* tail_start) {
  *head_end = r1;
  for (long long base = r0; base < r1; base += 32) {
    const long long i = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, i < r1 && seg[i] != fs);
    if (m) {
      *head_end = base + __ffs(m) - 1;
      break;
    }
  }
  *tail_start = r0;
  for (long long top = r1; top > r0; top -= 32) {
    const long long i = top - 1 - lane;
    const unsigned m = __ballot_sync(0xffffffffu, i >= r0 && seg[i] != ls);
    if (m) {
      *tail_start = top - 1 - (__ffs(m) - 1) + 1;
      break;
    }
  }
}

template <typename T, typename Op>
__global__ void seg_ends_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                                float* __restrict__ ent_val, int* __restrict__ ent_seg,
                                long long n, int c, int tile, long long n_tiles) {
  const long long t = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= n_tiles) return;  // whole warps only: the ballots need all 32 lanes
  const long long r0 = t * tile;
  const long long r1 = min(r0 + tile, n);
  const int fs = seg[r0];
  const int ls = seg[r1 - 1];
  long long head_end, tail_start;
  run_bounds(seg, r0, r1, fs, ls, lane, &head_end, &tail_start);
  if (lane == 0) {
    ent_seg[2 * t] = fs;
    ent_seg[2 * t + 1] = ls;
  }
  for (int ch = lane; ch < c; ch += 32) {
    float head = Op::identity();
    for (long long i = r0; i < head_end; ++i) head = Op::combine(head, to_float(x[i * c + ch]));
    float tail = Op::identity();
    if (fs != ls) {
      for (long long i = tail_start; i < r1; ++i) tail = Op::combine(tail, to_float(x[i * c + ch]));
    }
    ent_val[(2 * t) * c + ch] = head;
    ent_val[(2 * t + 1) * c + ch] = tail;
  }
}

template <typename T>
__device__ __forceinline__ void fill_rows(T* __restrict__ out, long long lo, long long hi, int c,
                                          int ch, float v) {
  const T w = from_float<T>(v);
  for (long long i = lo; i < hi; ++i) out[i * c + ch] = w;
}

// `full` holds the resolved (2 * n_tiles, c) entry values, or is null when
// the stream is a single tile (every run is then complete within it).
template <typename T, typename Op>
__global__ void seg_write_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                                 const float* __restrict__ full, T* __restrict__ out,
                                 long long n, int c, int tile, long long n_tiles) {
  const long long t = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= n_tiles) return;
  const long long r0 = t * tile;
  const long long r1 = min(r0 + tile, n);
  const int fs = seg[r0];
  const int ls = seg[r1 - 1];
  long long lo = r0, hi = r1;  // rows whose runs are reduced here
  long long head_end = r0, tail_start = r1;
  if (full != nullptr) {
    run_bounds(seg, r0, r1, fs, ls, lane, &head_end, &tail_start);
    lo = head_end;
    hi = fs != ls ? tail_start : head_end;
  }
  for (int ch = lane; ch < c; ch += 32) {
    if (full != nullptr) {
      fill_rows(out, r0, head_end, c, ch, full[(2 * t) * c + ch]);
      if (fs != ls) fill_rows(out, tail_start, r1, c, ch, full[(2 * t + 1) * c + ch]);
    }
    if (lo >= hi) continue;
    long long run_start = lo;
    int cur = seg[lo];
    float acc = Op::identity();
    for (long long i = lo; i < hi; ++i) {
      const int s = seg[i];
      if (s != cur) {
        fill_rows(out, run_start, i, c, ch, acc);
        run_start = i;
        cur = s;
        acc = Op::identity();
      }
      acc = Op::combine(acc, to_float(x[i * c + ch]));
    }
    fill_rows(out, run_start, hi, c, ch, acc);
  }
}

constexpr int kThreads = 128;  // 4 warps, 4 tiles per block

unsigned blocks_for(long long n_tiles) {
  return static_cast<unsigned>((n_tiles * 32 + kThreads - 1) / kThreads);
}

template <typename T, typename Op>
int launch_ends(const void* x, const void* seg, void* ent_val, void* ent_seg, long long n, int c,
         int tile, cudaStream_t s) {
  const long long n_tiles = (n + tile - 1) / tile;
  seg_ends_kernel<T, Op><<<blocks_for(n_tiles), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(seg), static_cast<float*>(ent_val),
      static_cast<int*>(ent_seg), n, c, tile, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Op>
int launch_write(const void* x, const void* seg, const void* full, void* out, long long n, int c,
          int tile, cudaStream_t s) {
  const long long n_tiles = (n + tile - 1) / tile;
  seg_write_kernel<T, Op><<<blocks_for(n_tiles), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(seg), static_cast<const float*>(full),
      static_cast<T*>(out), n, c, tile, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; op: 0 = max, 1 = sum.  Entries are f32.
// Each returns a cudaError_t (0 = launched), or -1 for bad arguments.
extern "C" int pnx_segscan_ends(const void* x, const void* seg, void* ent_val, void* ent_seg,
                                long long n, int c, int tile, int dtype, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || tile <= 0) return -1;
  if (dtype == 0 && op == 0) return launch_ends<float, MaxOp>(x, seg, ent_val, ent_seg, n, c, tile, s);
  if (dtype == 0 && op == 1) return launch_ends<float, SumOp>(x, seg, ent_val, ent_seg, n, c, tile, s);
  if (dtype == 1 && op == 0)
    return launch_ends<__nv_bfloat16, MaxOp>(x, seg, ent_val, ent_seg, n, c, tile, s);
  if (dtype == 1 && op == 1)
    return launch_ends<__nv_bfloat16, SumOp>(x, seg, ent_val, ent_seg, n, c, tile, s);
  return -1;
}

extern "C" int pnx_segscan_write(const void* x, const void* seg, const void* full, void* out,
                                 long long n, int c, int tile, int dtype, int op,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || tile <= 0) return -1;
  if (dtype == 0 && op == 0) return launch_write<float, MaxOp>(x, seg, full, out, n, c, tile, s);
  if (dtype == 0 && op == 1) return launch_write<float, SumOp>(x, seg, full, out, n, c, tile, s);
  if (dtype == 1 && op == 0) return launch_write<__nv_bfloat16, MaxOp>(x, seg, full, out, n, c, tile, s);
  if (dtype == 1 && op == 1) return launch_write<__nv_bfloat16, SumOp>(x, seg, full, out, n, c, tile, s);
  return -1;
}
