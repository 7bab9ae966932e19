// Host-side geometry kernels for the data pipeline and test oracles.
//
// TPU-native rebuild of the reference's native components:
//   - points_in_rbbox / box_collision_test: the numba-JIT host kernels used by
//     GT-paste augmentation and database creation
//     (reference: det3d/core/bbox/box_np_ops.py:184-302)
//   - rotated-rectangle polygon-clip overlap / IoU and greedy rotated NMS:
//     host oracle mirroring the semantics of the reference CUDA kernels
//     (reference: det3d/core/iou3d_nms/src/iou3d_cpu.cpp,
//                 iou3d_nms_kernel.cu:104-324)
//
// Exposed via a plain C ABI and loaded from Python with ctypes
// (pillarnext_tpu_torch/core/native_geometry.py, which compiles this file
// with `c++ -O3 -shared -fPIC` on first use).  The port's copy of
// pillarnext_tpu/core/native/geometry.cpp.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr float kEps = 1e-8f;

struct Pt {
  float x, y;
};

inline float cross(const Pt &a, const Pt &b) { return a.x * b.y - a.y * b.x; }

inline float cross3(const Pt &p1, const Pt &p2, const Pt &p0) {
  return (p1.x - p0.x) * (p2.y - p0.y) - (p2.x - p0.x) * (p1.y - p0.y);
}

inline bool rect_cross(const Pt &p1, const Pt &p2, const Pt &q1, const Pt &q2) {
  return std::min(p1.x, p2.x) <= std::max(q1.x, q2.x) &&
         std::min(q1.x, q2.x) <= std::max(p1.x, p2.x) &&
         std::min(p1.y, p2.y) <= std::max(q1.y, q2.y) &&
         std::min(q1.y, q2.y) <= std::max(p1.y, p2.y);
}

// Point strictly inside (with margin) a [x,y,z,dx,dy,dz,yaw] box's BEV rect.
inline bool in_box2d(const float *box, const Pt &p) {
  constexpr float kMargin = 1e-2f;
  const float c = std::cos(-box[6]), s = std::sin(-box[6]);
  const float dx = p.x - box[0], dy = p.y - box[1];
  const float rx = dx * c + dy * (-s);
  const float ry = dx * s + dy * c;
  return std::fabs(rx) < box[3] / 2 + kMargin && std::fabs(ry) < box[4] / 2 + kMargin;
}

// Proper intersection of segments (p0,p1) and (q0,q1); writes the point to ans.
inline bool seg_intersection(const Pt &p1, const Pt &p0, const Pt &q1, const Pt &q0,
                             Pt &ans) {
  if (!rect_cross(p0, p1, q0, q1)) return false;
  const float s1 = cross3(q0, p1, p0);
  const float s2 = cross3(p1, q1, p0);
  const float s3 = cross3(p0, q1, q0);
  const float s4 = cross3(q1, p1, q0);
  if (!(s1 * s2 > 0 && s3 * s4 > 0)) return false;
  const float s5 = cross3(q1, p1, p0);
  if (std::fabs(s5 - s1) > kEps) {
    ans.x = (s5 * q0.x - s1 * q1.x) / (s5 - s1);
    ans.y = (s5 * q0.y - s1 * q1.y) / (s5 - s1);
  } else {
    const float a0 = p0.y - p1.y, b0 = p1.x - p0.x, c0 = p0.x * p1.y - p1.x * p0.y;
    const float a1 = q0.y - q1.y, b1 = q1.x - q0.x, c1 = q0.x * q1.y - q1.x * q0.y;
    const float det = a0 * b1 - a1 * b0;
    ans.x = (b0 * c1 - b1 * c0) / det;
    ans.y = (a1 * c0 - a0 * c1) / det;
  }
  return true;
}

inline void rotate_about(const Pt &center, float c, float s, Pt &p) {
  const float nx = (p.x - center.x) * c + (p.y - center.y) * (-s) + center.x;
  const float ny = (p.x - center.x) * s + (p.y - center.y) * c + center.y;
  p.x = nx;
  p.y = ny;
}

// Exact BEV overlap area of two rotated boxes [x,y,z,dx,dy,dz,yaw]:
// collect edge intersections + contained corners, sort by angle, shoelace.
float box_overlap_bev(const float *a, const float *b) {
  const float ax1 = a[0] - a[3] / 2, ay1 = a[1] - a[4] / 2;
  const float ax2 = a[0] + a[3] / 2, ay2 = a[1] + a[4] / 2;
  const float bx1 = b[0] - b[3] / 2, by1 = b[1] - b[4] / 2;
  const float bx2 = b[0] + b[3] / 2, by2 = b[1] + b[4] / 2;

  Pt ca{a[0], a[1]}, cb{b[0], b[1]};
  Pt pa[5] = {{ax1, ay1}, {ax2, ay1}, {ax2, ay2}, {ax1, ay2}, {}};
  Pt pb[5] = {{bx1, by1}, {bx2, by1}, {bx2, by2}, {bx1, by2}, {}};
  const float cac = std::cos(a[6]), cas = std::sin(a[6]);
  const float cbc = std::cos(b[6]), cbs = std::sin(b[6]);
  for (int k = 0; k < 4; ++k) {
    rotate_about(ca, cac, cas, pa[k]);
    rotate_about(cb, cbc, cbs, pb[k]);
  }
  pa[4] = pa[0];
  pb[4] = pb[0];

  Pt poly[16];
  Pt centroid{0, 0};
  int cnt = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      if (seg_intersection(pa[i + 1], pa[i], pb[j + 1], pb[j], poly[cnt])) {
        centroid.x += poly[cnt].x;
        centroid.y += poly[cnt].y;
        ++cnt;
      }
  for (int k = 0; k < 4; ++k) {
    if (in_box2d(a, pb[k])) {
      centroid.x += pb[k].x;
      centroid.y += pb[k].y;
      poly[cnt++] = pb[k];
    }
    if (in_box2d(b, pa[k])) {
      centroid.x += pa[k].x;
      centroid.y += pa[k].y;
      poly[cnt++] = pa[k];
    }
  }
  if (cnt < 3) return 0.0f;
  centroid.x /= cnt;
  centroid.y /= cnt;

  // angular sort around the centroid (insertion-style; cnt <= 16)
  for (int j = 0; j < cnt - 1; ++j)
    for (int i = 0; i < cnt - j - 1; ++i) {
      const bool swap =
          std::atan2(poly[i].y - centroid.y, poly[i].x - centroid.x) >
          std::atan2(poly[i + 1].y - centroid.y, poly[i + 1].x - centroid.x);
      if (swap) std::swap(poly[i], poly[i + 1]);
    }

  float area = 0;
  for (int k = 0; k < cnt - 1; ++k) {
    Pt u{poly[k].x - poly[0].x, poly[k].y - poly[0].y};
    Pt v{poly[k + 1].x - poly[0].x, poly[k + 1].y - poly[0].y};
    area += cross(u, v);
  }
  return std::fabs(area) / 2.0f;
}

inline float iou_bev(const float *a, const float *b) {
  const float sa = a[3] * a[4];
  const float sb = b[3] * b[4];
  const float inter = box_overlap_bev(a, b);
  return inter / std::max(sa + sb - inter, kEps);
}

}  // namespace

extern "C" {

// points: (n, point_stride) rows [x, y, z, ...]; boxes: (m, box_dim) rows
// [x, y, z, dx, dy, dz, ..., yaw]; out: (n, m) uint8.
void pnx_points_in_rbbox(const float *points, int64_t n, int64_t point_stride,
                         const float *boxes, int64_t m, int64_t box_dim,
                         uint8_t *out) {
  for (int64_t j = 0; j < m; ++j) {
    const float *b = boxes + j * box_dim;
    const float c = std::cos(b[box_dim - 1]), s = std::sin(b[box_dim - 1]);
    const float hx = b[3] / 2, hy = b[4] / 2, hz = b[5] / 2;
    for (int64_t i = 0; i < n; ++i) {
      const float *p = points + i * point_stride;
      uint8_t hit = 0;
      if (std::fabs(p[2] - b[2]) <= hz) {
        const float dx = p[0] - b[0], dy = p[1] - b[1];
        const float lx = dx * c + dy * s;
        const float ly = -dx * s + dy * c;
        hit = (std::fabs(lx) <= hx && std::fabs(ly) <= hy) ? 1 : 0;
      }
      out[i * m + j] = hit;
    }
  }
}

// corners_a: (n, 4, 2), corners_b: (k, 4, 2) clockwise quads; out: (n, k).
void pnx_box_collision_test(const float *corners_a, int64_t n,
                            const float *corners_b, int64_t k, uint8_t *out) {
  // Precompute AABBs.
  auto standup = [](const float *c, int64_t cnt, float *su) {
    for (int64_t i = 0; i < cnt; ++i) {
      const float *q = c + i * 8;
      float xmin = q[0], ymin = q[1], xmax = q[0], ymax = q[1];
      for (int v = 1; v < 4; ++v) {
        xmin = std::min(xmin, q[v * 2]);
        xmax = std::max(xmax, q[v * 2]);
        ymin = std::min(ymin, q[v * 2 + 1]);
        ymax = std::max(ymax, q[v * 2 + 1]);
      }
      su[i * 4] = xmin;
      su[i * 4 + 1] = ymin;
      su[i * 4 + 2] = xmax;
      su[i * 4 + 3] = ymax;
    }
  };
  float *sa = new float[n * 4];
  float *sb = new float[k * 4];
  standup(corners_a, n, sa);
  standup(corners_b, k, sb);

  auto contains = [](const float *quad, const float *pts) {
    // all 4 pts strictly inside clockwise quad
    for (int l = 0; l < 4; ++l) {
      const float px = pts[l * 2], py = pts[l * 2 + 1];
      for (int v = 0; v < 4; ++v) {
        const int w = (v + 1) % 4;
        // reference negates the edge vector for clockwise winding
        const float vx = -(quad[v * 2] - quad[w * 2]);
        const float vy = -(quad[v * 2 + 1] - quad[w * 2 + 1]);
        const float cr = vy * (quad[v * 2] - px) - vx * (quad[v * 2 + 1] - py);
        if (cr >= 0) return false;
      }
    }
    return true;
  };

  for (int64_t i = 0; i < n; ++i) {
    const float *qa = corners_a + i * 8;
    for (int64_t j = 0; j < k; ++j) {
      const float *qb = corners_b + j * 8;
      uint8_t ret = 0;
      const float iw = std::min(sa[i * 4 + 2], sb[j * 4 + 2]) -
                       std::max(sa[i * 4], sb[j * 4]);
      if (iw > 0) {
        const float ih = std::min(sa[i * 4 + 3], sb[j * 4 + 3]) -
                         std::max(sa[i * 4 + 1], sb[j * 4 + 1]);
        if (ih > 0) {
          // edge-pair proper intersections
          for (int v = 0; v < 4 && !ret; ++v) {
            const int v2 = (v + 1) % 4;
            const float Ax = qa[v * 2], Ay = qa[v * 2 + 1];
            const float Bx = qa[v2 * 2], By = qa[v2 * 2 + 1];
            for (int l = 0; l < 4; ++l) {
              const int l2 = (l + 1) % 4;
              const float Cx = qb[l * 2], Cy = qb[l * 2 + 1];
              const float Dx = qb[l2 * 2], Dy = qb[l2 * 2 + 1];
              const bool acd = (Dy - Ay) * (Cx - Ax) > (Cy - Ay) * (Dx - Ax);
              const bool bcd = (Dy - By) * (Cx - Bx) > (Cy - By) * (Dx - Bx);
              if (acd != bcd) {
                const bool abc = (Cy - Ay) * (Bx - Ax) > (By - Ay) * (Cx - Ax);
                const bool abd = (Dy - Ay) * (Bx - Ax) > (By - Ay) * (Dx - Ax);
                if (abc != abd) {
                  ret = 1;
                  break;
                }
              }
            }
          }
          if (!ret && (contains(qa, qb) || contains(qb, qa))) ret = 1;
        }
      }
      out[i * k + j] = ret;
    }
  }
  delete[] sa;
  delete[] sb;
}

// boxes_a: (n, 7), boxes_b: (m, 7) [x,y,z,dx,dy,dz,yaw]; out: (n, m) BEV overlap area.
void pnx_boxes_overlap_bev(const float *boxes_a, int64_t n, const float *boxes_b,
                           int64_t m, float *out) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < m; ++j)
      out[i * m + j] = box_overlap_bev(boxes_a + i * 7, boxes_b + j * 7);
}

// Row-aligned BEV IoU: out[i] = iou(boxes_a[i], boxes_b[i]).
void pnx_boxes_aligned_iou_bev(const float *boxes_a, const float *boxes_b,
                               int64_t n, float *out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = iou_bev(boxes_a + i * 7, boxes_b + i * 7);
}

// Greedy rotated-BEV NMS over score-sorted boxes (n, 7); keep indices written
// to `keep`, returns number kept.  Mirrors the reference CUDA bitmask + host
// scan semantics (iou3d_nms.cpp:113-159) on the host.
int64_t pnx_rotated_nms(const float *boxes, int64_t n, float thresh,
                        int64_t *keep) {
  bool *suppressed = new bool[n]();
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (suppressed[i]) continue;
    keep[cnt++] = i;
    const float *bi = boxes + i * 7;
    for (int64_t j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      if (iou_bev(bi, boxes + j * 7) > thresh) suppressed[j] = true;
    }
  }
  delete[] suppressed;
  return cnt;
}

}  // extern "C"
