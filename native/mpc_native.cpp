// mpc_native: host-side geometry runtime for the mpc_tpu framework.
//
// Equivalents of the reference's C++ pybind11 modules
// (SURVEY.md §2.2):
//   * pycrcc collision checker + road-boundary checks
//     (reference test/test_mpc_planner.py:36-47): oriented-rectangle SAT
//     sweeps of the planned trajectory vs obstacles and boundary polylines.
//   * pycrccosy CurvilinearCoordinateSystem
//     (reference MPC_Planner/configuration.py:264-277): arc-length
//     projection of points onto a reference polyline.
//   * nearest-point deviation metric (reference mpc_planner.py:184-197).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

namespace {

struct Vec2 {
  double x, y;
};

inline Vec2 sub(Vec2 a, Vec2 b) { return {a.x - b.x, a.y - b.y}; }
inline double dot(Vec2 a, Vec2 b) { return a.x * b.x + a.y * b.y; }
inline double cross(Vec2 a, Vec2 b) { return a.x * b.y - a.y * b.x; }

// Corners of an oriented rectangle (length along heading).
void rect_corners(double cx, double cy, double length, double width,
                  double theta, Vec2 out[4]) {
  const double c = std::cos(theta), s = std::sin(theta);
  const double hl = 0.5 * length, hw = 0.5 * width;
  const double dx[4] = {hl, hl, -hl, -hl};
  const double dy[4] = {hw, -hw, -hw, hw};
  for (int i = 0; i < 4; ++i) {
    out[i] = {cx + dx[i] * c - dy[i] * s, cy + dx[i] * s + dy[i] * c};
  }
}

// Separating-axis test for two convex quads.
bool sat_overlap(const Vec2 a[4], const Vec2 b[4]) {
  const Vec2* polys[2] = {a, b};
  for (int p = 0; p < 2; ++p) {
    for (int i = 0; i < 4; ++i) {
      const Vec2 e = sub(polys[p][(i + 1) & 3], polys[p][i]);
      const Vec2 axis = {-e.y, e.x};
      double amin = std::numeric_limits<double>::infinity(), amax = -amin;
      double bmin = amin, bmax = -amin;
      for (int j = 0; j < 4; ++j) {
        const double pa = dot(a[j], axis);
        const double pb = dot(b[j], axis);
        amin = std::min(amin, pa); amax = std::max(amax, pa);
        bmin = std::min(bmin, pb); bmax = std::max(bmax, pb);
      }
      if (amax < bmin || bmax < amin) return false;
    }
  }
  return true;
}

inline int orient_sign(Vec2 a, Vec2 b, Vec2 c) {
  const double v = cross(sub(b, a), sub(c, a));
  return (v > 0) - (v < 0);
}

bool segments_cross(Vec2 p1, Vec2 p2, Vec2 q1, Vec2 q2) {
  return orient_sign(p1, p2, q1) != orient_sign(p1, p2, q2) &&
         orient_sign(q1, q2, p1) != orient_sign(q1, q2, p2);
}

bool point_in_quad(Vec2 p, const Vec2 quad[4]) {
  int sign = 0;
  for (int i = 0; i < 4; ++i) {
    const int s = orient_sign(quad[i], quad[(i + 1) & 3], p);
    if (s == 0) continue;
    if (sign == 0) sign = s;
    else if (s != sign) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Sweep the ego rectangle along a trajectory vs one static obstacle
// rectangle.  states: row-major (T, 5) rows [x, y, delta, v, psi].
// Returns the first colliding step, or -1.
int64_t mpc_traj_obstacle_collision(const double* states, int64_t T,
                                    double ego_length, double ego_width,
                                    double obs_x, double obs_y,
                                    double obs_length, double obs_width,
                                    double obs_theta) {
  if (obs_length <= 0.0 || obs_width <= 0.0) return -1;
  Vec2 obs[4];
  rect_corners(obs_x, obs_y, obs_length, obs_width, obs_theta, obs);
  for (int64_t t = 0; t < T; ++t) {
    Vec2 ego[4];
    rect_corners(states[t * 5 + 0], states[t * 5 + 1], ego_length, ego_width,
                 states[t * 5 + 4], ego);
    if (sat_overlap(ego, obs)) return t;
  }
  return -1;
}

// Sweep the ego rectangle vs a boundary polyline (n points, row-major
// (n, 2)).  Returns the first step whose rectangle intersects any boundary
// segment, or -1.
int64_t mpc_traj_boundary_collision(const double* states, int64_t T,
                                    double ego_length, double ego_width,
                                    const double* boundary, int64_t n) {
  if (n < 2) return -1;
  for (int64_t t = 0; t < T; ++t) {
    Vec2 ego[4];
    rect_corners(states[t * 5 + 0], states[t * 5 + 1], ego_length, ego_width,
                 states[t * 5 + 4], ego);
    double lo_x = ego[0].x, hi_x = ego[0].x, lo_y = ego[0].y, hi_y = ego[0].y;
    for (int i = 1; i < 4; ++i) {
      lo_x = std::min(lo_x, ego[i].x); hi_x = std::max(hi_x, ego[i].x);
      lo_y = std::min(lo_y, ego[i].y); hi_y = std::max(hi_y, ego[i].y);
    }
    for (int64_t j = 0; j + 1 < n; ++j) {
      const Vec2 p1 = {boundary[j * 2], boundary[j * 2 + 1]};
      const Vec2 p2 = {boundary[j * 2 + 2], boundary[j * 2 + 3]};
      // broad phase
      if (std::max(p1.x, p2.x) < lo_x || std::min(p1.x, p2.x) > hi_x ||
          std::max(p1.y, p2.y) < lo_y || std::min(p1.y, p2.y) > hi_y)
        continue;
      if (point_in_quad(p1, ego) || point_in_quad(p2, ego)) return t;
      for (int i = 0; i < 4; ++i) {
        if (segments_cross(p1, p2, ego[i], ego[(i + 1) & 3])) return t;
      }
    }
  }
  return -1;
}

// Per-step Euclidean distance to the nearest vertex of a reference polyline
// (reference mpc_planner.py:184-197 / find_closest_point).
void mpc_deviation_to_path(const double* states, int64_t T,
                           const double* path, int64_t n, double* out) {
  for (int64_t t = 0; t < T; ++t) {
    const double px = states[t * 5 + 0], py = states[t * 5 + 1];
    double best = std::numeric_limits<double>::infinity();
    for (int64_t j = 0; j < n; ++j) {
      const double dx = path[j * 2] - px, dy = path[j * 2 + 1] - py;
      best = std::min(best, dx * dx + dy * dy);
    }
    out[t] = std::sqrt(best);
  }
}

// Curvilinear (Frenet) projection: for each query point, the arc length s
// and signed lateral offset d of its projection onto the polyline
// (role of pycrccosy.CurvilinearCoordinateSystem, configuration.py:264-277).
void mpc_curvilinear_project(const double* path, int64_t n,
                             const double* points, int64_t m,
                             double* out_s, double* out_d) {
  for (int64_t q = 0; q < m; ++q) {
    const Vec2 p = {points[q * 2], points[q * 2 + 1]};
    double best_d2 = std::numeric_limits<double>::infinity();
    double best_s = 0.0, best_signed = 0.0, s_acc = 0.0;
    for (int64_t j = 0; j + 1 < n; ++j) {
      const Vec2 a = {path[j * 2], path[j * 2 + 1]};
      const Vec2 b = {path[j * 2 + 2], path[j * 2 + 3]};
      const Vec2 ab = sub(b, a);
      const double ab2 = dot(ab, ab);
      const double seg_len = std::sqrt(ab2);
      double tpar = ab2 > 1e-12 ? dot(sub(p, a), ab) / ab2 : 0.0;
      tpar = std::max(0.0, std::min(1.0, tpar));
      const Vec2 proj = {a.x + tpar * ab.x, a.y + tpar * ab.y};
      const Vec2 dvec = sub(p, proj);
      const double d2 = dot(dvec, dvec);
      if (d2 < best_d2) {
        best_d2 = d2;
        best_s = s_acc + tpar * seg_len;
        const double side = cross(ab, sub(p, a));
        best_signed = std::copysign(std::sqrt(d2), side);
      }
      s_acc += seg_len;
    }
    out_s[q] = best_s;
    out_d[q] = best_signed;
  }
}

int64_t mpc_native_abi_version() { return 1; }

}  // extern "C"
