// Greedy rotated (or circle) NMS of many lanes on the card, with no host read.
//
// Replaces no TPU kernel: the JAX package's NMS (pillarnext_tpu/core/nms.py)
// is a while_loop over 128-candidate chunks whose exits the port's CPU path
// (core/nms.py `_streamed`) reads on the host, once a chunk and once a
// fixpoint round, over a rotated IoU of several hundred elementwise
// launches.  The reference's own path was one CUDA kernel
// (iou3d_nms_kernel.cu): a suppression bitmask on the card, then a greedy
// sweep.  This file is that design with the sweep on the card as well.
//
// Contract (core/nms.py `_greedy_nms`): over score-sorted rows, row i of a
// lane is kept iff it is valid and no kept j < i has iou(j, i) > th (circle:
// d^2(j, i) < r^2); a lane stops at post_max kept rows.  Output: the kept
// rows' `order` entries compacted in score order, padded with 0 / false.
//
// The IoU is the port's float32 formula (core/torch_box_ops.py
// `boxes_iou_bev`: corners, the branch-free boundary integral with its
// on-boundary margins, inclusive on A's pass and exclusive on B's) with every
// product and sum rounded on its own (__fmul_rn, __fadd_rn: no contraction
// into FMA), the divisions rounded correctly and PyTorch's NaN rules for
// maximum, minimum and clamp, so the keep sets match the CPU path's and the
// elementwise version's on the card except at ties with the threshold.
//
// What bounds it: the mask's IoU operations (~340 float ops a pair that needs
// the integral) and, in the sweep, the latency of one greedy walk a lane.
// Design:
//  - Mask launch: grid (column block, row block, lane) of 64-row tiles, upper
//    triangle only; a tile without a valid row exits at once.  The column
//    boxes' corners, edges and margins are computed once into shared memory;
//    each thread owns one row (box A) and writes one 64-bit word: bit c set
//    iff column c (box B, later in score order) is valid and overlaps.  A
//    pair whose circumscribed circles lie apart by a margin far above the
//    formula's rounding has an empty clipped boundary, so an area of exactly
//    0: at a threshold of at least kFarThresh it is skipped after a distance
//    test.  A thread first marks the columns that pass that test, then runs
//    the integral over the marked ones only, so a warp pays for its busiest
//    row's near pairs, not for every column any of its rows is near.
//  - Sweep launch: one warp a lane, its "removed" words in shared memory.
//    For each 64-row block: the block's valid rows by ballot, its diagonal
//    words in two registers a thread, the greedy choice inside the block by
//    find-first-set over the candidates (a shuffle per kept row, no memory
//    round trip), the kept rows' order entries written out, then their mask
//    rows OR-ed into the later words with coalesced loads.  The lane stops
//    at post_max kept rows and pads the rest.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;            // rows and columns of a mask tile: the bits of a word
constexpr int kSweepWarps = 4;       // lanes a sweep block walks
constexpr float kEpsDist = 1e-5f;    // torch_box_ops._EPS_DIST
constexpr float kFarThresh = 1e-3f;  // least threshold at which far pairs are skipped
constexpr unsigned kFull = 0xffffffffu;

// PyTorch's float rules on the card: maximum / minimum propagate NaN (else
// std::max / std::min), clamp returns NaN unchanged.
__device__ __forceinline__ float tmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}
__device__ __forceinline__ float tmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}
__device__ __forceinline__ float clamp_lo(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp01(float v) { return v != v ? v : fminf(fmaxf(v, 0.f), 1.f); }

// One box's derived values: CCW corners, edge vectors, on-boundary margins
// (torch_box_ops._corners_xy, _boundary_integral's ex / ey / margin), its
// area, centre and circumradius.
struct Box {
  float cx[4], cy[4], ex[4], ey[4], mg[4];
  float area, x, y, rad;
};
constexpr int kFields = 24;

__device__ __forceinline__ Box make_box(float x, float y, float dx, float dy, float yaw) {
  Box b;
  const float hx = __fmul_rn(dx, 0.5f), hy = __fmul_rn(dy, 0.5f);
  const float c = cosf(yaw), s = sinf(yaw);
  const float lx[4] = {hx, -hx, -hx, hx};
  const float ly[4] = {hy, hy, -hy, -hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.cx[k] = __fadd_rn(__fsub_rn(__fmul_rn(lx[k], c), __fmul_rn(ly[k], s)), x);
    b.cy[k] = __fadd_rn(__fadd_rn(__fmul_rn(lx[k], s), __fmul_rn(ly[k], c)), y);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.ex[k] = __fsub_rn(b.cx[(k + 1) & 3], b.cx[k]);
    b.ey[k] = __fsub_rn(b.cy[(k + 1) & 3], b.cy[k]);
    const float scale = __fadd_rn(__fadd_rn(fabsf(b.ex[k]), fabsf(b.ey[k])), 1e-12f);
    b.mg[k] = __fmul_rn(kEpsDist, scale);
  }
  b.area = __fmul_rn(dx, dy);
  b.x = x;
  b.y = y;
  b.rad = 0.5f * sqrtf(dx * dx + dy * dy);
  return b;
}

// Sum over P's edges of the line integral of (x dy - y dx) inside Q
// (torch_box_ops._boundary_integral), op for op.
template <bool kInclusive>
__device__ __forceinline__ float boundary_integral(const float* px, const float* py, const Box& q) {
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      s[i][k] = __fsub_rn(__fmul_rn(q.ex[k], __fsub_rn(py[i], q.cy[k])),
                          __fmul_rn(q.ey[k], __fsub_rn(px[i], q.cx[k])));
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + 1) & 3;
    float t_lo = 0.f, t_hi = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float s0 = s[i][k], s1 = s[j][k];
      const float denom = __fsub_rn(s1, s0);
      const float margin = q.mg[k];
      const bool degen = fabsf(denom) < margin;
      const float tc = __fdiv_rn(-s0, degen ? margin : denom);
      const bool degen_empty = degen && (kInclusive ? s0 < -margin : s0 < margin);
      const float lo_k = (!degen && denom > 0.f) ? tc : (degen_empty ? 2.f : 0.f);
      const float hi_k = (!degen && denom < 0.f) ? tc : (degen_empty ? -1.f : 1.f);
      t_lo = k == 0 ? lo_k : tmax(t_lo, lo_k);
      t_hi = k == 0 ? hi_k : tmin(t_hi, hi_k);
    }
    t_lo = clamp01(t_lo);
    t_hi = tmax(clamp01(t_hi), t_lo);
    const float dx = __fsub_rn(px[j], px[i]), dy = __fsub_rn(py[j], py[i]);
    const float x0 = __fadd_rn(px[i], __fmul_rn(t_lo, dx)), y0 = __fadd_rn(py[i], __fmul_rn(t_lo, dy));
    const float x1 = __fadd_rn(px[i], __fmul_rn(t_hi, dx)), y1 = __fadd_rn(py[i], __fmul_rn(t_hi, dy));
    const float contrib = __fsub_rn(__fmul_rn(x0, y1), __fmul_rn(x1, y0));
    total = i == 0 ? contrib : __fadd_rn(total, contrib);
  }
  return total;
}

// The circumscribed circles lie apart by far more than the formula's
// rounding: the clipped boundary is empty and the area exactly 0.  A NaN is
// never far; a centre at infinity is, and the formula reads NaN there,
// which is not over the threshold either.
__device__ __forceinline__ bool far_apart(float ax, float ay, float arad, float bx, float by, float brad) {
  const float gx = ax - bx, gy = ay - by;
  const float reach = (arad + brad) * 1.001f + 1e-3f;
  return gx * gx + gy * gy > reach * reach;
}

// iou(a, b) > th, a the earlier row (torch_box_ops.boxes_iou_bev(a, b)).
__device__ __forceinline__ bool iou_over(const Box& a, const Box& b, float th) {
  const float ia = boundary_integral<true>(a.cx, a.cy, b);
  const float ib = boundary_integral<false>(b.cx, b.cy, a);
  const float inter = clamp_lo(__fmul_rn(0.5f, __fadd_rn(ia, ib)), 0.f);
  const float uni = clamp_lo(__fsub_rn(__fadd_rn(a.area, b.area), inter), 1e-8f);
  return __fdiv_rn(inter, uni) > th;
}

__device__ __forceinline__ void put_box(float (*sb)[kTile], int t, const Box& b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sb[k][t] = b.cx[k];
    sb[4 + k][t] = b.cy[k];
    sb[8 + k][t] = b.ex[k];
    sb[12 + k][t] = b.ey[k];
    sb[16 + k][t] = b.mg[k];
  }
  sb[20][t] = b.area;
  sb[21][t] = b.x;
  sb[22][t] = b.y;
  sb[23][t] = b.rad;
}

__device__ __forceinline__ Box get_box(const float (*sb)[kTile], int c) {
  Box b;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.cx[k] = sb[k][c];
    b.cy[k] = sb[4 + k][c];
    b.ex[k] = sb[8 + k][c];
    b.ey[k] = sb[12 + k][c];
    b.mg[k] = sb[16 + k][c];
  }
  b.area = sb[20][c];
  b.x = sb[21][c];
  b.y = sb[22][c];
  b.rad = sb[23][c];
  return b;
}

// mask[lane, row, cb] bit c: column cb * 64 + c (> row, valid) is suppressed
// by row.  rows (lanes, k, d) float32: d = 7 [x, y, z, dx, dy, dz, yaw] for
// rotated, d = 2 [x, y] for circle; thresh (lanes,): the IoU threshold, or r^2.
template <bool kCircle>
__global__ void __launch_bounds__(kTile)
nms_mask(const float* __restrict__ rows, const unsigned char* __restrict__ valid,
         const float* __restrict__ thresh, unsigned long long* __restrict__ mask,
         int k, int words, int d) {
  const int cb = blockIdx.x, rb = blockIdx.y, lane = blockIdx.z;
  if (cb < rb) return;
  const int t = threadIdx.x;
  const int row = rb * kTile + t, col = cb * kTile + t;
  const float* base = rows + static_cast<size_t>(lane) * k * d;
  const unsigned char* v = valid + static_cast<size_t>(lane) * k;
  const bool row_ok = row < k && v[row];
  const bool col_ok = col < k && v[col];

  __shared__ float sb[kCircle ? 2 : kFields][kTile];
  __shared__ bool s_ok[kTile];
  s_ok[t] = col_ok;
  if (col_ok) {
    const float* p = base + static_cast<size_t>(col) * d;
    if constexpr (kCircle) {
      sb[0][t] = p[0];
      sb[1][t] = p[1];
    } else {
      put_box(sb, t, make_box(p[0], p[1], p[3], p[4], p[6]));
    }
  }
  if (!__syncthreads_or(row_ok)) return;

  const float th = thresh[lane];
  unsigned long long bits = 0ull;
  if (row_ok) {
    const float* p = base + static_cast<size_t>(row) * d;
    const int c0 = cb == rb ? t + 1 : 0;
    if constexpr (kCircle) {
      const float ax = p[0], ay = p[1];
      for (int c = c0; c < kTile; ++c) {
        if (!s_ok[c]) continue;
        const float gx = __fsub_rn(ax, sb[0][c]), gy = __fsub_rn(ay, sb[1][c]);
        if (__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)) < th) bits |= 1ull << c;
      }
    } else {
      const Box a = make_box(p[0], p[1], p[3], p[4], p[6]);
      // first the columns past the distance test, then the integral over
      // those alone: a warp runs it as often as its busiest row needs
      const bool skip_far = th >= kFarThresh;
      unsigned long long near = 0ull;
      for (int c = c0; c < kTile; ++c)
        if (s_ok[c] && !(skip_far && far_apart(a.x, a.y, a.rad, sb[21][c], sb[22][c], sb[23][c])))
          near |= 1ull << c;
      for (; near != 0ull; near &= near - 1ull) {
        const int c = __ffsll(static_cast<long long>(near)) - 1;
        if (iou_over(a, get_box(sb, c), th)) bits |= 1ull << c;
      }
    }
  }
  if (row < k) mask[(static_cast<size_t>(lane) * k + row) * words + cb] = bits;
}

// One warp a lane: the greedy walk over the mask, then the compaction.
__global__ void __launch_bounds__(32 * kSweepWarps)
nms_sweep(const unsigned long long* __restrict__ mask, const unsigned char* __restrict__ valid,
          const long long* __restrict__ order, long long order_stride, long long* __restrict__ sel,
          unsigned char* __restrict__ sel_valid, int lanes, int k, int words, int post_max) {
  extern __shared__ unsigned long long removed_all[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int lane = blockIdx.x * kSweepWarps + warp;
  if (lane >= lanes) return;
  unsigned long long* removed = removed_all + static_cast<size_t>(warp) * words;
  for (int w = t; w < words; w += 32) removed[w] = 0ull;
  __syncwarp();
  const unsigned long long* m = mask + static_cast<size_t>(lane) * k * words;
  const unsigned char* v = valid + static_cast<size_t>(lane) * k;
  const long long* ord = order + static_cast<size_t>(lane) * order_stride;
  long long* s_out = sel + static_cast<size_t>(lane) * post_max;
  unsigned char* v_out = sel_valid + static_cast<size_t>(lane) * post_max;

  int count = 0;
  for (int w = 0; w < words && count < post_max; ++w) {
    const int r0 = w * kTile;
    const int i_lo = r0 + t, i_hi = r0 + 32 + t;
    const bool v_lo = i_lo < k && v[i_lo];
    const bool v_hi = i_hi < k && v[i_hi];
    const unsigned long long vbits = static_cast<unsigned long long>(__ballot_sync(kFull, v_lo)) |
                                     (static_cast<unsigned long long>(__ballot_sync(kFull, v_hi)) << 32);
    unsigned long long cand = vbits & ~removed[w];
    if (cand == 0ull) continue;
    const unsigned long long d_lo = v_lo ? m[static_cast<size_t>(i_lo) * words + w] : 0ull;
    const unsigned long long d_hi = v_hi ? m[static_cast<size_t>(i_hi) * words + w] : 0ull;
    unsigned long long kept = 0ull;
    int room = post_max - count;
    while (cand != 0ull && room > 0) {
      const int r = __ffsll(static_cast<long long>(cand)) - 1;
      kept |= 1ull << r;
      --room;
      const unsigned long long dr = __shfl_sync(kFull, r < 32 ? d_lo : d_hi, r & 31);
      cand &= ~dr & ~((2ull << r) - 1ull);  // 2 << 63 wraps to 0: clears every bit
    }
    if ((kept >> t) & 1ull) {
      const int pos = count + __popcll(kept & ((1ull << t) - 1ull));
      s_out[pos] = ord[i_lo];
      v_out[pos] = 1;
    }
    if ((kept >> (t + 32)) & 1ull) {
      const int pos = count + __popcll(kept & ((1ull << (t + 32)) - 1ull));
      s_out[pos] = ord[i_hi];
      v_out[pos] = 1;
    }
    count += __popcll(kept);
    if (count < post_max) {
      for (int w2 = w + 1 + t; w2 < words; w2 += 32) {
        unsigned long long acc = removed[w2];
        for (unsigned long long kk = kept; kk != 0ull; kk &= kk - 1ull) {
          const int r = __ffsll(static_cast<long long>(kk)) - 1;
          acc |= m[static_cast<size_t>(r0 + r) * words + w2];
        }
        removed[w2] = acc;
      }
    }
    __syncwarp();
  }
  for (int p = count + t; p < post_max; p += 32) {
    s_out[p] = 0;
    v_out[p] = 0;
  }
}

}  // namespace

extern "C" {

// Launches the mask and the sweep on `stream`; returns a cudaError_t (0 =
// launched), -1 for sizes the kernel does not take.  mask: (lanes, k, words)
// scratch, words = ceil(k / 64); sel (lanes, post_max) int64 and sel_valid
// (lanes, post_max) bool, written whole.
int pnx_nms(const void* rows, const void* valid, const void* order, long long order_stride,
            const void* thresh, void* mask, void* sel, void* sel_valid, int lanes, int k, int d,
            int post_max, int circle, void* stream) {
  if (lanes < 0 || k < 0 || post_max < 0 || lanes > 65535 || d != (circle ? 2 : 7)) return -1;
  if (lanes == 0 || post_max == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kSweepWarps) * words * sizeof(unsigned long long);
  if (words > 65535 || smem > 48 * 1024) return -1;
  if (k > 0) {
    const dim3 grid(words, words, lanes);
    const float* r = static_cast<const float*>(rows);
    const unsigned char* v = static_cast<const unsigned char*>(valid);
    const float* th = static_cast<const float*>(thresh);
    unsigned long long* mk = static_cast<unsigned long long*>(mask);
    if (circle)
      nms_mask<true><<<grid, kTile, 0, s>>>(r, v, th, mk, k, words, d);
    else
      nms_mask<false><<<grid, kTile, 0, s>>>(r, v, th, mk, k, words, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep<<<(lanes + kSweepWarps - 1) / kSweepWarps, 32 * kSweepWarps, smem, s>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const unsigned char*>(valid),
      static_cast<const long long*>(order), order_stride, static_cast<long long*>(sel),
      static_cast<unsigned char*>(sel_valid), lanes, k, words, post_max);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
