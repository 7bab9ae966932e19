// Broadcast segmented reduction over a sorted segment stream — kernel 3.
//
// Replaces the TPU kernel `sorted_segment_bcast` / `_pass`
// (pillarnext_tpu/ops/pallas_segscan.py:124 / :49): for non-decreasing seg,
//   out[i] = reduce(x[j] for every j with seg[j] == seg[i]),  reduce = max | sum,
// i.e. segment_<reduce>(x, seg)[seg].  It carries the PFN max-broadcast of the
// training forward (x: 1.2M x 32 bf16 at B = 4, 300k points per sample) and
// the two f32 segment sums of its backward.
//
// What bounds it on Hopper: bytes.  Read x and seg once, write out once:
// 1.2M x (64 + 4 + 64) B ~ 158 MB for bf16, ~0.047 ms at 3.35 TB/s; 312 MB,
// ~0.093 ms, for f32.  The work is a few flops per byte.
//
// The TPU kernel ran a sequential grid with a VMEM carry and a log2(T)
// shift-scan per tile, twice (prefix, then suffix), and formed a sum as
// prefix + suffix - x, which cancels.  Blocks on Hopper run in no order, so
// nothing is carried between them, and the point is to keep enough bytes in
// flight.  The design:
//   1. `seg_tile_kernel`, one block of 256 threads per tile of `tile` rows
//      (4096 from the wrapper).  A row is cut into chunks of VB bytes (16
//      when the row width and the pointers allow it, else 8, 4 or 2: the
//      wrapper picks the widest and the kernel is built for each); the
//      threads of a group share a row, one chunk each (4 threads for a
//      64-byte bf16 row, 8 for a 128-byte f32 row), and a group owns
//      consecutive rows.  A thread issues the loads of 4 rows before it uses
//      any, at 64 registers so that 4 blocks fit an SM (64 KB in flight per
//      SM), then walks them in order, reducing each run of equal seg in f32.
//      A run that ends inside the group is written at once, from registers,
//      with VB-byte stores.  Each group leaves its first run's partial in
//      shared memory; the group where a run starts adds the partials of the
//      groups it covers, in group order, and every group writes its share
//      of the run.  x is read once.
//   2. The tile's first run (rows equal to seg[tile start]) and last run go
//      out as two (seg, f32 value) entries with their row extents, unwritten.
//      A tile that holds a single run emits its total once and the identity
//      as the second entry, so no row is counted twice.
//   3. The 2 * n / tile entries are a sorted segment stream: the wrapper
//      resolves them by the same kernel, which for one tile writes every run
//      itself (1.2M rows give 586 entries, one tile), recursively when there
//      are more.
//   4. `seg_fill_kernel` writes the first and last run of every tile from
//      the resolved entries and never reads x: the dump slot's ~400k padded
//      rows of the train stream cost one write.
// One call is 3 launches when n <= tile^2 / 2 rows (8.4M), 1 when n <= tile.
// Where this differs from a persistent, bulk-copy (TMA) design: one block
// per tile and plain vector loads; 4 loads in flight per thread at 4 blocks
// per SM keep more than the ~20 KB per SM that the memory's latency asks for.
// A development sweep on the H100 (tiles of 1024-4096 rows, 4-16 loads in
// flight, 1-4 blocks per SM) chose these: 4 blocks of 64 registers did as
// well as 16 loads in flight at 2 blocks, and the larger tile halves the
// entries.
// No atomics: sums run in a fixed order (rows in order within a group, then
// groups, then tiles), in f32, and give the same bits run to run and the
// same bits to every row of a run; max is exact and propagates NaN.  The
// output rounds to the input type once.  No host synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a tile's block
constexpr int kMinBlocks = 4;  // per SM: caps the tile kernel at 64 registers
constexpr int kBatch = 4;      // rows whose loads a thread issues before it uses any
constexpr int kFillSplit = 4;  // blocks that share the fill of one tile

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

template <int VB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// One chunk of VB bytes of a row: E values of T.
template <typename T, int VB>
struct Vec {
  static constexpr int E = VB / static_cast<int>(sizeof(T));
  using R = typename Raw<VB>::type;

  __device__ static R load(const T* __restrict__ x, int row, int c, int chunk) {
    return __ldg(reinterpret_cast<const R*>(x + row * c) + chunk);
  }
  __device__ static void unpack(const R& r, float* v) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = to_float(e[k]);
  }
  __device__ static R pack(const float* v) {
    R r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int k = 0; k < E; ++k) e[k] = from_float<T>(v[k]);
    return r;
  }
  // rows [lo, hi) of the chunk get v
  __device__ static void fill(T* __restrict__ out, int lo, int hi, int c, int chunk, const float* v) {
    const R w = pack(v);
    for (int i = lo; i < hi; ++i) reinterpret_cast<R*>(out + i * c)[chunk] = w;
  }
};

// How a block cuts its tile: q chunks per row, qb of them per column slice
// (a row wider than kThreads chunks is done in slices), groups of qb
// threads, each owning `rows` consecutive rows of the tile's `len`.
struct Geometry {
  int q, qb, groups, rows;
};

__device__ __forceinline__ Geometry geometry(int c, int es, int vb, int len) {
  Geometry g;
  g.q = c * es / vb;
  g.qb = g.q < kThreads ? g.q : kThreads;
  g.groups = kThreads / g.qb;
  g.rows = (len + g.groups - 1) / g.groups;
  return g;
}

// The group where the run of seg s that covers group g's last rows starts
// (tseg[g] == s): back over groups that hold nothing but that run.
__device__ __forceinline__ int run_owner(const int* hseg, const int* tseg, int g, int s) {
  while (g > 0 && hseg[g] == s && tseg[g - 1] == s) --g;
  return g;
}

// Shared-memory rows of E floats, laid out [k][slot] so that the threads of
// a warp touch consecutive words.
template <int E>
__device__ __forceinline__ void sh_load(const float* a, int slot, float* v) {
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = a[k * kThreads + slot];
}
template <int E>
__device__ __forceinline__ void sh_store(float* a, int slot, const float* v) {
#pragma unroll
  for (int k = 0; k < E; ++k) a[k * kThreads + slot] = v[k];
}

// One tile per block.  With one tile (n <= tile) every run is written;
// otherwise the tile's first and last runs go to the entries (ent_val:
// (2 * n_tiles, c) f32, ent_seg, ent_rows: the first run's rows [0, h) and
// the last run's rows [t, len) of the tile as h, t).
template <typename T, typename Op, int VB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_tile_kernel(const T* __restrict__ x, const int* __restrict__ seg, T* __restrict__ out,
                float* __restrict__ ent_val, int* __restrict__ ent_seg, int* __restrict__ ent_rows,
                long long n, int c, int tile) {
  using V = Vec<T, VB>;
  constexpr int E = V::E;
  __shared__ int s_hseg[kThreads], s_tseg[kThreads];  // each group's first and last seg
  __shared__ float s_head[E * kThreads], s_tot[E * kThreads];
  __shared__ int s_head_end, s_tail_start;

  // rows are counted from the tile's first row from here on
  const long long r0 = static_cast<long long>(blockIdx.x) * tile;
  const int len = static_cast<int>(r0 + tile < n ? tile : n - r0);
  x += r0 * c;
  out += r0 * c;
  seg += r0;
  const bool single = gridDim.x == 1;
  const Geometry geo = geometry(c, sizeof(T), VB, len);
  const int ng = (len + geo.rows - 1) / geo.rows;  // groups that hold rows
  const int g = threadIdx.x / geo.qb, q = threadIdx.x % geo.qb;
  const bool active = g < ng;
  const int a = g * geo.rows;
  const int b = active ? min(a + geo.rows, len) : a;
  const int fs = __ldg(seg), ls = __ldg(seg + len - 1);
  // the tile's first and last runs are the entries' unless the tile is all
  auto deferred = [&](int s) { return !single && (s == fs || s == ls); };

  if (threadIdx.x == 0) {
    s_head_end = len;
    s_tail_start = fs == ls ? len : 0;
  }
  __syncthreads();
  if (active && q == 0) {
    const int h = __ldg(seg + a), t = __ldg(seg + b - 1);
    s_hseg[g] = h;
    s_tseg[g] = t;
    if (a > 0) {  // a run boundary on the group boundary
      const int p = __ldg(seg + a - 1);
      if (p == fs && h != fs) s_head_end = a;
      if (h == ls && p != ls) s_tail_start = a;
    }
  }

  for (int q0 = 0; q0 < geo.q; q0 += geo.qb) {
    const int chunk = q0 + q;
    const bool mine = active && chunk < geo.q;
    const int slot = g * geo.qb + q;
    float acc[E];
#pragma unroll
    for (int k = 0; k < E; ++k) acc[k] = Op::identity();
    int start = a, head_end = b;  // the group's last run starts at `start`
    if (mine) {
      bool open = true;  // the group's first run has not ended
      int cur = __ldg(seg + a);
      for (int base = a; base < b; base += kBatch) {
        typename V::R r[kBatch];
        int s[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (base + j < b) {
            s[j] = __ldg(seg + base + j);
            r[j] = V::load(x, base + j, c, chunk);
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = base + j;
          if (i >= b) break;
          if (s[j] != cur) {
            if (q == 0) {
              if (cur == fs) s_head_end = i;
              if (s[j] == ls) s_tail_start = i;
            }
            if (open) {
              sh_store<E>(s_head, slot, acc);
              head_end = i;
              open = false;
            } else {
              V::fill(out, start, i, c, chunk, acc);  // began and ended in this group
            }
#pragma unroll
            for (int k = 0; k < E; ++k) acc[k] = Op::identity();
            start = i;
            cur = s[j];
          }
          float v[E];
          V::unpack(r[j], v);
#pragma unroll
          for (int k = 0; k < E; ++k) acc[k] = Op::combine(acc[k], v[k]);
        }
      }
      if (open) sh_store<E>(s_head, slot, acc);
    }
    __syncthreads();

    // the group where a run starts adds the partials of the groups it covers
    // to its own last run's (still in acc)
    if (mine) {
      const int s = s_tseg[g];
      if (run_owner(s_hseg, s_tseg, g, s) == g) {
        float v[E];
        for (int h = g + 1; h < ng && s_hseg[h] == s; ++h) {
          sh_load<E>(s_head, h * geo.qb + q, v);
#pragma unroll
          for (int k = 0; k < E; ++k) acc[k] = Op::combine(acc[k], v[k]);
          if (s_tseg[h] != s) break;
        }
        sh_store<E>(s_tot, slot, acc);
      }
    }
    __syncthreads();

    if (mine) {
      const int hs = s_hseg[g], ts = s_tseg[g];
      float v[E];
      if (hs != ts && !deferred(hs)) {  // the first run, rows [a, head_end)
        if (g > 0 && s_tseg[g - 1] == hs)
          sh_load<E>(s_tot, run_owner(s_hseg, s_tseg, g - 1, hs) * geo.qb + q, v);
        else
          sh_load<E>(s_head, slot, v);  // began and ended in this group
        V::fill(out, a, head_end, c, chunk, v);
      }
      if (!deferred(ts)) {  // the last run, rows [start, b)
        sh_load<E>(s_tot, run_owner(s_hseg, s_tseg, g, ts) * geo.qb + q, v);
        V::fill(out, start, b, c, chunk, v);
      }
      if (!single && g == 0) {
        float* first = ent_val + 2LL * blockIdx.x * c + chunk * E;
        float* last = first + c;
        sh_load<E>(s_hseg[0] == s_tseg[0] ? s_tot : s_head, q, v);
#pragma unroll
        for (int k = 0; k < E; ++k) first[k] = v[k];
        if (fs == ls) {
#pragma unroll
          for (int k = 0; k < E; ++k) v[k] = Op::identity();
        } else {
          sh_load<E>(s_tot, run_owner(s_hseg, s_tseg, ng - 1, ls) * geo.qb + q, v);
        }
#pragma unroll
        for (int k = 0; k < E; ++k) last[k] = v[k];
      }
    }
    __syncthreads();  // the next column slice reuses the shared rows
  }
  if (!single && threadIdx.x == 0) {
    const long long e0 = 2LL * blockIdx.x;
    ent_seg[e0] = fs;
    ent_seg[e0 + 1] = ls;
    ent_rows[e0] = s_head_end;
    ent_rows[e0 + 1] = s_tail_start;
  }
}

// Rows [0, h) of tile t get full[2 t], rows [t', len) get full[2 t + 1],
// (h, t') = ent_rows[2 t], ent_rows[2 t + 1].  Writes only.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
seg_fill_kernel(const float* __restrict__ full, const int* __restrict__ ent_rows,
                T* __restrict__ out, long long n, int c, int tile) {
  using V = Vec<T, VB>;
  constexpr int E = V::E;
  const long long t = blockIdx.x;  // blockIdx.y: which of kFillSplit parts of the rows
  const long long r0 = t * tile;
  const int len = static_cast<int>((r0 + tile < n ? r0 + tile : n) - r0);
  const int head = __ldg(ent_rows + 2 * t), tail = __ldg(ent_rows + 2 * t + 1);
  const int q = c * static_cast<int>(sizeof(T)) / VB;
  const int span = (head + len - tail) * q;
  for (int idx = blockIdx.y * kThreads + threadIdx.x; idx < span; idx += kFillSplit * kThreads) {
    const int rr = idx / q, chunk = idx - rr * q;
    const bool first = rr < head;
    const long long row = r0 + (first ? rr : tail + rr - head);
    const float* src = full + (2 * t + (first ? 0 : 1)) * c + chunk * E;
    float v[E];
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = __ldg(src + k);
    reinterpret_cast<typename V::R*>(out + row * c)[chunk] = V::pack(v);
  }
}

struct Args {
  const void* x;
  const int* seg;
  void* out;
  float* ent_val;
  int* ent_seg;
  int* ent_rows;
  long long n;
  int c, tile;
};

template <typename T, typename Op, int VB>
int launch_tiles(const Args& a, cudaStream_t s) {
  const long long n_tiles = (a.n + a.tile - 1) / a.tile;
  seg_tile_kernel<T, Op, VB><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const T*>(a.x), a.seg, static_cast<T*>(a.out), a.ent_val, a.ent_seg, a.ent_rows,
      a.n, a.c, a.tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
int launch_fill(const float* full, const int* ent_rows, void* out, long long n, int c, int tile,
                cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + tile - 1) / tile), kFillSplit);
  seg_fill_kernel<T, VB><<<grid, kThreads, 0, s>>>(full, ent_rows, static_cast<T*>(out), n, c, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Op, int VB>
int tile_shape(int* threads, int* smem, int* regs, int* per_sm) {
  const auto kernel = seg_tile_kernel<T, Op, VB>;
  cudaFuncAttributes attr = {};
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
  *threads = kThreads;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  *regs = attr.numRegs;
  return static_cast<int>(e);
}

// F(VB) for the vector width vb, or -1 (2 bytes only for a 2-byte type).
template <typename T, typename F>
int by_width(int vb, F&& f) {
  switch (vb) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 2:
      if constexpr (sizeof(T) == 2) return f(std::integral_constant<int, 2>{});
      return -1;
    default: return -1;
  }
}

template <typename T, typename Op>
int tiles_for(const Args& a, int vb, cudaStream_t s) {
  return by_width<T>(vb, [&](auto w) { return launch_tiles<T, Op, decltype(w)::value>(a, s); });
}

// vb is a valid chunk for rows of c values of es bytes at these pointers
bool width_ok(int vb, int c, int es, const void* p, const void* q) {
  if (vb < es || vb > 16 || (vb & (vb - 1)) != 0) return false;
  if ((static_cast<long long>(c) * es) % vb != 0) return false;
  return reinterpret_cast<uintptr_t>(p) % vb == 0 && reinterpret_cast<uintptr_t>(q) % vb == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; op: 0 = max, 1 = sum; vb: the chunk
// width in bytes (16, 8, 4 or 2, at least one value), which must divide the
// row and the addresses of x and out.  With n <= tile the entries are not
// used and may be null.  Returns a cudaError_t (0 = launched), or -1 for
// bad arguments.
extern "C" int pnx_segscan_tiles(const void* x, const void* seg, void* out, void* ent_val,
                                 void* ent_seg, void* ent_rows, long long n, int c, int tile,
                                 int dtype, int op, int vb, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (n <= 0 || c <= 0 || tile <= 0 || (dtype != 0 && dtype != 1) || (op != 0 && op != 1)) return -1;
  if (!width_ok(vb, c, es, x, out)) return -1;
  if (n > tile && (ent_val == nullptr || ent_seg == nullptr || ent_rows == nullptr)) return -1;
  const Args a{x, static_cast<const int*>(seg), out, static_cast<float*>(ent_val),
               static_cast<int*>(ent_seg), static_cast<int*>(ent_rows), n, c, tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return op == 0 ? tiles_for<float, MaxOp>(a, vb, s) : tiles_for<float, SumOp>(a, vb, s);
  return op == 0 ? tiles_for<__nv_bfloat16, MaxOp>(a, vb, s) : tiles_for<__nv_bfloat16, SumOp>(a, vb, s);
}

// full: the resolved (2 * n_tiles, c) f32 entries; ent_rows as
// pnx_segscan_tiles wrote it.  Same dtype and vb rules.
extern "C" int pnx_segscan_fill(const void* full, const void* ent_rows, void* out, long long n,
                                int c, int tile, int dtype, int vb, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (n <= 0 || c <= 0 || tile <= 0 || (dtype != 0 && dtype != 1)) return -1;
  if (!width_ok(vb, c, es, out, out)) return -1;
  const float* f = static_cast<const float*>(full);
  const int* rows = static_cast<const int*>(ent_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_width<float>(vb, [&](auto w) {
      return launch_fill<float, decltype(w)::value>(f, rows, out, n, c, tile, s);
    });
  return by_width<__nv_bfloat16>(vb, [&](auto w) {
    return launch_fill<__nv_bfloat16, decltype(w)::value>(f, rows, out, n, c, tile, s);
  });
}

// The tile kernel's launch shape for (dtype, op, vb): threads per block,
// static shared memory in bytes (it uses no dynamic shared memory),
// registers per thread and resident blocks per SM.  Returns a cudaError_t
// (0 = ok), or -1 for arguments the kernel is not built for.
extern "C" int pnx_segscan_launch_shape(int dtype, int op, int vb, int* threads, int* smem,
                                        int* regs, int* per_sm) {
  if ((dtype != 0 && dtype != 1) || (op != 0 && op != 1)) return -1;
  auto shape = [&](auto t, auto o) {
    using T = decltype(t);
    using Op = decltype(o);
    return by_width<T>(vb, [&](auto w) {
      return tile_shape<T, Op, decltype(w)::value>(threads, smem, regs, per_sm);
    });
  };
  if (dtype == 0) return op == 0 ? shape(float{}, MaxOp{}) : shape(float{}, SumOp{});
  return op == 0 ? shape(__nv_bfloat16{}, MaxOp{}) : shape(__nv_bfloat16{}, SumOp{});
}
