// Native geometry kernels for eigenpinns_tpu.
//
// The reference leans on third-party C++ for its heavy host-side
// preprocessing (robust_laplacian's local triangulations, scipy/sklearn
// kd-trees; SURVEY.md sec 2.3). This library is the framework's own
// production implementation of those kernels, built for the 1M-point
// scale where the Python fallbacks (eigenpinns_tpu/geometry/point_cloud.py,
// sampling/samplers.py) become the bottleneck:
//
//   epk_knn                  grid-hashed k-nearest-neighbors
//   epk_fps                  farthest-point sampling (exact, O(N*s))
//   epk_local_triangulations_v2  tangent-plane Bowyer-Watson Delaunay
//                            one-rings per point (the point-cloud
//                            Laplacian's triangle soup; separate PCA
//                            frame neighborhood k_frame)
//
// Exposed through a plain C ABI and loaded with ctypes
// (eigenpinns_tpu/geometry/native.py). OpenMP-parallel where available.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline double norm2(const V3& a) { return dot(a, a); }

// ---------------------------------------------------------------------------
// Spatial grid for kNN.
// ---------------------------------------------------------------------------

struct Grid {
  double min[3];
  double cell;
  int64_t dims[3];
  std::vector<std::vector<int64_t>> cells;

  static Grid build(const double* pts, int64_t n, int64_t target_per_cell) {
    Grid g;
    double mx[3];
    for (int d = 0; d < 3; ++d) {
      g.min[d] = pts[d];
      mx[d] = pts[d];
    }
    for (int64_t i = 1; i < n; ++i)
      for (int d = 0; d < 3; ++d) {
        g.min[d] = std::min(g.min[d], pts[3 * i + d]);
        mx[d] = std::max(mx[d], pts[3 * i + d]);
      }
    double vol = 1.0;
    for (int d = 0; d < 3; ++d) vol *= std::max(mx[d] - g.min[d], 1e-12);
    g.cell = std::cbrt(vol * target_per_cell / std::max<int64_t>(n, 1));
    g.cell = std::max(g.cell, 1e-12);
    for (int d = 0; d < 3; ++d) {
      g.dims[d] = std::max<int64_t>(
          1, (int64_t)std::floor((mx[d] - g.min[d]) / g.cell) + 1);
    }
    g.cells.resize(g.dims[0] * g.dims[1] * g.dims[2]);
    for (int64_t i = 0; i < n; ++i) g.cells[g.cell_of(pts + 3 * i)].push_back(i);
    return g;
  }

  int64_t clampc(double v, int d) const {
    int64_t c = (int64_t)std::floor((v - min[d]) / cell);
    return std::min(std::max<int64_t>(c, 0), dims[d] - 1);
  }
  int64_t cell_of(const double* p) const {
    return (clampc(p[0], 0) * dims[1] + clampc(p[1], 1)) * dims[2] +
           clampc(p[2], 2);
  }
};

// k nearest neighbors of query point (excluding `self` when >= 0).
void knn_query(const Grid& g, const double* pts, int64_t n, const double* q,
               int64_t k, int64_t self, int64_t* out_idx) {
  const int64_t cq[3] = {g.clampc(q[0], 0), g.clampc(q[1], 1),
                         g.clampc(q[2], 2)};
  // Expanding ring search over grid cells.
  std::vector<std::pair<double, int64_t>> best;  // max-heap by distance
  best.reserve(k + 1);
  auto push = [&](int64_t i) {
    if (i == self) return;
    const V3 d = {pts[3 * i] - q[0], pts[3 * i + 1] - q[1],
                  pts[3 * i + 2] - q[2]};
    double d2 = norm2(d);
    if ((int64_t)best.size() < k) {
      best.emplace_back(d2, i);
      std::push_heap(best.begin(), best.end());
    } else if (d2 < best.front().first) {
      std::pop_heap(best.begin(), best.end());
      best.back() = {d2, i};
      std::push_heap(best.begin(), best.end());
    }
  };
  for (int64_t r = 0;; ++r) {
    bool any_cell = false;
    for (int64_t dx = -r; dx <= r; ++dx)
      for (int64_t dy = -r; dy <= r; ++dy)
        for (int64_t dz = -r; dz <= r; ++dz) {
          if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) != r)
            continue;  // shell only
          int64_t cx = cq[0] + dx, cy = cq[1] + dy, cz = cq[2] + dz;
          if (cx < 0 || cy < 0 || cz < 0 || cx >= g.dims[0] ||
              cy >= g.dims[1] || cz >= g.dims[2])
            continue;
          any_cell = true;
          for (int64_t i : g.cells[(cx * g.dims[1] + cy) * g.dims[2] + cz])
            push(i);
        }
    // Done when we have k and the next shell cannot contain anything
    // closer than our current worst.
    if ((int64_t)best.size() >= k) {
      double shell_min = (double)r * g.cell;  // conservative
      if (best.front().first <= shell_min * shell_min) break;
    }
    if (!any_cell && r > g.dims[0] + g.dims[1] + g.dims[2]) break;
  }
  std::sort_heap(best.begin(), best.end());
  for (int64_t j = 0; j < k; ++j)
    out_idx[j] = j < (int64_t)best.size() ? best[j].second : -1;
}

// ---------------------------------------------------------------------------
// 2D Bowyer-Watson Delaunay for small point sets (local triangulations).
// ---------------------------------------------------------------------------

struct Tri2 {
  int a, b, c;
  double cx, cy, r2;  // circumcircle
  bool alive;
};

bool circumcircle(const double* px, const double* py, int a, int b, int c,
                  double& cx, double& cy, double& r2) {
  double ax = px[a], ay = py[a], bx = px[b], by = py[b], ox = px[c],
         oy = py[c];
  double d = 2.0 * (ax * (by - oy) + bx * (oy - ay) + ox * (ay - by));
  if (std::fabs(d) < 1e-14) return false;
  double a2 = ax * ax + ay * ay, b2 = bx * bx + by * by,
         c2 = ox * ox + oy * oy;
  cx = (a2 * (by - oy) + b2 * (oy - ay) + c2 * (ay - by)) / d;
  cy = (a2 * (ox - bx) + b2 * (ax - ox) + c2 * (bx - ax)) / d;
  double dx = ax - cx, dy = ay - cy;
  r2 = dx * dx + dy * dy;
  return true;
}

// Returns triangles as index triples into the local point set.
int delaunay2d(const std::vector<double>& xs, const std::vector<double>& ys,
               std::vector<int>& out_tris) {
  int m = (int)xs.size();
  if (m < 3) return 0;
  // Super-triangle.
  double minx = xs[0], maxx = xs[0], miny = ys[0], maxy = ys[0];
  for (int i = 1; i < m; ++i) {
    minx = std::min(minx, xs[i]);
    maxx = std::max(maxx, xs[i]);
    miny = std::min(miny, ys[i]);
    maxy = std::max(maxy, ys[i]);
  }
  double dmax = std::max(maxx - minx, maxy - miny) + 1e-9;
  double midx = 0.5 * (minx + maxx), midy = 0.5 * (miny + maxy);
  std::vector<double> px(xs), py(ys);
  px.push_back(midx - 20 * dmax);
  py.push_back(midy - dmax);
  px.push_back(midx);
  py.push_back(midy + 20 * dmax);
  px.push_back(midx + 20 * dmax);
  py.push_back(midy - dmax);

  std::vector<Tri2> tris;
  Tri2 super{m, m + 1, m + 2, 0, 0, 0, true};
  circumcircle(px.data(), py.data(), super.a, super.b, super.c, super.cx,
               super.cy, super.r2);
  tris.push_back(super);

  std::vector<std::pair<int, int>> poly;
  for (int i = 0; i < m; ++i) {
    poly.clear();
    for (auto& t : tris) {
      if (!t.alive) continue;
      double dx = px[i] - t.cx, dy = py[i] - t.cy;
      if (dx * dx + dy * dy <= t.r2) {
        t.alive = false;
        // Collect edges; boundary edges appear once.
        int e[3][2] = {{t.a, t.b}, {t.b, t.c}, {t.c, t.a}};
        for (auto& ed : e) {
          auto rev = std::make_pair(ed[1], ed[0]);
          auto it = std::find(poly.begin(), poly.end(), rev);
          if (it != poly.end())
            poly.erase(it);
          else
            poly.emplace_back(ed[0], ed[1]);
        }
      }
    }
    for (auto& ed : poly) {
      Tri2 t{ed.first, ed.second, i, 0, 0, 0, true};
      if (!circumcircle(px.data(), py.data(), t.a, t.b, t.c, t.cx, t.cy,
                        t.r2))
        continue;
      tris.push_back(t);
    }
    // Compact occasionally to bound memory.
    if (tris.size() > 4096) {
      std::vector<Tri2> keep;
      keep.reserve(tris.size());
      for (auto& t : tris)
        if (t.alive) keep.push_back(t);
      tris.swap(keep);
    }
  }
  int count = 0;
  for (auto& t : tris) {
    if (!t.alive) continue;
    if (t.a >= m || t.b >= m || t.c >= m) continue;  // touches super-tri
    out_tris.push_back(t.a);
    out_tris.push_back(t.b);
    out_tris.push_back(t.c);
    ++count;
  }
  return count;
}

// Symmetric 3x3 eigen-decomposition (Jacobi sweeps) for PCA frames.
void eig3(const double A_in[3][3], double vals[3], double vecs[3][3]) {
  double A[3][3];
  std::memcpy(A, A_in, sizeof(A));
  double V[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int sweep = 0; sweep < 16; ++sweep) {
    double off = std::fabs(A[0][1]) + std::fabs(A[0][2]) + std::fabs(A[1][2]);
    if (off < 1e-15) break;
    for (int p = 0; p < 2; ++p)
      for (int q = p + 1; q < 3; ++q) {
        if (std::fabs(A[p][q]) < 1e-18) continue;
        double theta = (A[q][q] - A[p][p]) / (2 * A[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1));
        double c = 1.0 / std::sqrt(t * t + 1), s = t * c;
        for (int k = 0; k < 3; ++k) {
          double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {
          double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 3; ++k) {
          double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
  }
  int order[3] = {0, 1, 2};
  double d[3] = {A[0][0], A[1][1], A[2][2]};
  std::sort(order, order + 3, [&](int i, int j) { return d[i] < d[j]; });
  for (int k = 0; k < 3; ++k) {
    vals[k] = d[order[k]];
    for (int r = 0; r < 3; ++r) vecs[r][k] = V[r][order[k]];
  }
}

}  // namespace

extern "C" {

// kNN (excluding self): out_idx is (n, k) int64.
int epk_knn(const double* pts, int64_t n, int64_t k, int64_t* out_idx) {
  if (k >= n) return -1;
  Grid g = Grid::build(pts, n, 8);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t i = 0; i < n; ++i)
    knn_query(g, pts, n, pts + 3 * i, k, i, out_idx + i * k);
  return 0;
}

// Farthest-point sampling: out_idx (n_samples,) in selection order.
int epk_fps(const double* pts, int64_t n, int64_t n_samples, int64_t start,
            int64_t* out_idx) {
  if (n_samples > n) return -1;
  std::vector<double> dist(n, 1e300);
  int64_t cur = start % n;
  out_idx[0] = cur;
  for (int64_t s = 1; s < n_samples; ++s) {
    const double* p = pts + 3 * cur;
    int64_t far_i = 0;
    double far_d = -1.0;
#ifdef _OPENMP
#pragma omp parallel
    {
      int64_t l_i = 0;
      double l_d = -1.0;
#pragma omp for nowait
      for (int64_t i = 0; i < n; ++i) {
        double dx = pts[3 * i] - p[0], dy = pts[3 * i + 1] - p[1],
               dz = pts[3 * i + 2] - p[2];
        double d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < dist[i]) dist[i] = d2;
        if (dist[i] > l_d) {
          l_d = dist[i];
          l_i = i;
        }
      }
#pragma omp critical
      if (l_d > far_d) {
        far_d = l_d;
        far_i = l_i;
      }
    }
#else
    for (int64_t i = 0; i < n; ++i) {
      double dx = pts[3 * i] - p[0], dy = pts[3 * i + 1] - p[1],
             dz = pts[3 * i + 2] - p[2];
      double d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < dist[i]) dist[i] = d2;
      if (dist[i] > far_d) {
        far_d = dist[i];
        far_i = i;
      }
    }
#endif
    cur = far_i;
    out_idx[s] = cur;
  }
  return 0;
}

// Local tangent-plane Delaunay one-rings.
// k_frame: neighbor count for the PCA tangent frame (may differ from
// the triangulation neighborhood k_nbrs; <= 0 means "same"). The v2
// symbol name exists so that a stale _native.so from before the
// k_frame parameter fails to bind (AttributeError -> rebuild) instead
// of silently misreading the argument list.
// out_tris: caller-allocated (max_tris, 3) int64; returns count or -1.
int64_t epk_local_triangulations_v2(const double* pts, int64_t n,
                                    int64_t k_nbrs, int64_t k_frame,
                                    int64_t max_tris, int64_t* out_tris) {
  int64_t k = std::min(k_nbrs, n - 1);
  if (k < 2) return -1;
  int64_t kf = (k_frame <= 0) ? k : std::min(k_frame, n - 1);
  int64_t kq = std::max(k, kf);  // neighbors sorted by distance: prefixes
  Grid g = Grid::build(pts, n, 8);
  std::vector<std::vector<int64_t>> per_point(n);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 32)
#endif
  for (int64_t i = 0; i < n; ++i) {
    std::vector<int64_t> nb(kq);
    knn_query(g, pts, n, pts + 3 * i, kq, i, nb.data());
    // Triangulation set: self + first k neighbors.
    std::vector<int64_t> loc;
    loc.push_back(i);
    for (int64_t j = 0; j < k; ++j)
      if (nb[j] >= 0) loc.push_back(nb[j]);
    int m = (int)loc.size();
    if (m < 3) continue;
    // PCA frame from self + first kf neighbors (mean-centered).
    std::vector<int64_t> fset;
    fset.push_back(i);
    for (int64_t j = 0; j < kf; ++j)
      if (nb[j] >= 0) fset.push_back(nb[j]);
    int mf = (int)fset.size();
    double mean[3] = {0, 0, 0};
    for (int64_t id : fset)
      for (int d = 0; d < 3; ++d) mean[d] += pts[3 * id + d];
    for (int d = 0; d < 3; ++d) mean[d] /= mf;
    double C[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
    for (int64_t id : fset) {
      double v[3] = {pts[3 * id] - mean[0], pts[3 * id + 1] - mean[1],
                     pts[3 * id + 2] - mean[2]};
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) C[r][c] += v[r] * v[c];
    }
    double vals[3], vecs[3][3];
    eig3(C, vals, vecs);
    // Largest two eigenvectors span the tangent plane (cols 2, 1).
    std::vector<double> xs(m), ys(m);
    for (int j = 0; j < m; ++j) {
      double v[3] = {pts[3 * loc[j]] - pts[3 * i],
                     pts[3 * loc[j] + 1] - pts[3 * i + 1],
                     pts[3 * loc[j] + 2] - pts[3 * i + 2]};
      xs[j] = v[0] * vecs[0][2] + v[1] * vecs[1][2] + v[2] * vecs[2][2];
      ys[j] = v[0] * vecs[0][1] + v[1] * vecs[1][1] + v[2] * vecs[2][1];
    }
    std::vector<int> tris;
    delaunay2d(xs, ys, tris);
    auto& mine = per_point[i];
    for (size_t t = 0; t + 2 < tris.size(); t += 3) {
      int a = tris[t], b = tris[t + 1], c = tris[t + 2];
      if (a != 0 && b != 0 && c != 0) continue;  // one-ring only
      mine.push_back(loc[a]);
      mine.push_back(loc[b]);
      mine.push_back(loc[c]);
    }
  }
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (size_t t = 0; t + 2 < per_point[i].size(); t += 3) {
      if (count >= max_tris) return -2;  // caller buffer too small
      out_tris[3 * count] = per_point[i][t];
      out_tris[3 * count + 1] = per_point[i][t + 1];
      out_tris[3 * count + 2] = per_point[i][t + 2];
      ++count;
    }
  }
  return count;
}


// Intrinsic Delaunay flips on a triangle soup (port of
// eigenpinns_tpu/geometry/point_cloud.py::intrinsic_delaunay_flips —
// same radial tufted-style edge pairing, same intrinsic unfold; the
// Python loop costs ~1.2 ms per 1k triangles, this kernel removes the
// 100k-triangle gate for production clouds). tris (T,3) int64,
// lengths (T,3) double (edge opposite corner), weights (T,) double —
// all mutated in place. Returns the number of flips (>= 0) or -1.
int64_t epk_delaunay_flips(const double* pts, int64_t n_pts,
                           int64_t* tris, double* lengths, double* weights,
                           int64_t T, int64_t max_flips) {
  (void)n_pts;
  if (max_flips < 0) max_flips = 30 * T;
  auto cot_at = [&](int64_t t, int c) -> double {
    const double* l = lengths + 3 * t;
    double a = l[(c + 1) % 3], b = l[(c + 2) % 3], lc = l[c];
    double s = 0.5 * (a + b + lc);
    double area2 = s * (s - a) * (s - b) * (s - lc);
    if (area2 < 1e-300) area2 = 1e-300;
    return (a * a + b * b - lc * lc) / (4.0 * std::sqrt(area2));
  };

  // Edge sides per vertex pair, in first-seen order (mirrors the
  // Python dict's insertion order so both paths flip identically).
  struct Side { int64_t t; int c; };
  std::unordered_map<uint64_t, int64_t> vp_slot;
  std::vector<std::vector<Side>> vp_sides;
  std::vector<uint64_t> vp_keys;
  vp_slot.reserve(2 * (size_t)T);
  auto key_of = [](int64_t u, int64_t v) -> uint64_t {
    if (u > v) std::swap(u, v);
    return ((uint64_t)u << 32) | (uint64_t)v;
  };
  for (int64_t t = 0; t < T; ++t) {
    int64_t a = tris[3 * t], b = tris[3 * t + 1], c = tris[3 * t + 2];
    int64_t es[3][2] = {{b, c}, {a, c}, {a, b}};
    for (int corner = 0; corner < 3; ++corner) {
      uint64_t k = key_of(es[corner][0], es[corner][1]);
      auto it = vp_slot.find(k);
      int64_t slot;
      if (it == vp_slot.end()) {
        slot = (int64_t)vp_sides.size();
        vp_slot.emplace(k, slot);
        vp_sides.emplace_back();
        vp_keys.push_back(k);
      } else {
        slot = it->second;
      }
      vp_sides[slot].push_back({t, corner});
    }
  }

  // Radial pairing -> glued edge ids (flat: 2 sides per eid).
  std::vector<Side> sides2;                  // [2*eid], [2*eid+1]
  std::vector<char> paired;                  // eid has 2 sides?
  std::vector<int64_t> tri_eid(3 * (size_t)T, -1);
  for (size_t s = 0; s < vp_sides.size(); ++s) {
    auto& lst = vp_sides[s];
    uint64_t k = vp_keys[s];
    int64_t u = (int64_t)(k >> 32), v = (int64_t)(k & 0xffffffffu);
    if (lst.size() >= 2) {
      double ax = pts[3 * v] - pts[3 * u];
      double ay = pts[3 * v + 1] - pts[3 * u + 1];
      double az = pts[3 * v + 2] - pts[3 * u + 2];
      double an = std::sqrt(ax * ax + ay * ay + az * az) + 1e-300;
      ax /= an; ay /= an; az /= an;
      double r1[3] = {1, 0, 0}, r2[3] = {0, 0, 0};
      bool have_ref = false;
      std::vector<std::pair<double, Side>> ang;
      ang.reserve(lst.size());
      for (auto& sd : lst) {
        int64_t apex = tris[3 * sd.t + sd.c];
        double wx = pts[3 * apex] - pts[3 * u];
        double wy = pts[3 * apex + 1] - pts[3 * u + 1];
        double wz = pts[3 * apex + 2] - pts[3 * u + 2];
        double dot = wx * ax + wy * ay + wz * az;
        wx -= ax * dot; wy -= ay * dot; wz -= az * dot;
        if (!have_ref) {
          double nw = std::sqrt(wx * wx + wy * wy + wz * wz);
          if (nw > 1e-300) { r1[0] = wx / nw; r1[1] = wy / nw; r1[2] = wz / nw; }
          r2[0] = ay * r1[2] - az * r1[1];
          r2[1] = az * r1[0] - ax * r1[2];
          r2[2] = ax * r1[1] - ay * r1[0];
          have_ref = true;
        }
        double x = wx * r1[0] + wy * r1[1] + wz * r1[2];
        double y = wx * r2[0] + wy * r2[1] + wz * r2[2];
        ang.push_back({std::atan2(y, x), sd});
      }
      std::stable_sort(ang.begin(), ang.end(),
                       [](const std::pair<double, Side>& a,
                          const std::pair<double, Side>& b) {
                         return a.first < b.first;
                       });
      for (size_t i = 0; i < ang.size(); ++i) lst[i] = ang[i].second;
    }
    size_t j = 0;
    for (; j + 1 < lst.size(); j += 2) {
      int64_t eid = (int64_t)paired.size();
      sides2.push_back(lst[j]);
      sides2.push_back(lst[j + 1]);
      paired.push_back(1);
      tri_eid[3 * lst[j].t + lst[j].c] = eid;
      tri_eid[3 * lst[j + 1].t + lst[j + 1].c] = eid;
    }
    if (j < lst.size()) {
      int64_t eid = (int64_t)paired.size();
      sides2.push_back(lst[j]);
      sides2.push_back(lst[j]);
      paired.push_back(0);
      tri_eid[3 * lst[j].t + lst[j].c] = eid;
    }
  }

  std::deque<int64_t> queue;
  std::vector<char> in_queue(paired.size(), 0);
  for (size_t e = 0; e < paired.size(); ++e)
    if (paired[e]) { queue.push_back((int64_t)e); in_queue[e] = 1; }

  int64_t n_flips = 0;
  const double eps = 1e-12;
  while (!queue.empty() && n_flips < max_flips) {
    int64_t eid = queue.front();
    queue.pop_front();
    in_queue[eid] = 0;
    if (!paired[eid]) continue;
    Side s1 = sides2[2 * eid], s2 = sides2[2 * eid + 1];
    int64_t t1 = s1.t, t2 = s2.t;
    int c1 = s1.c, c2 = s2.c;
    if (cot_at(t1, c1) + cot_at(t2, c2) >= -eps) continue;
    int64_t apex1 = tris[3 * t1 + c1];
    int64_t apex2 = tris[3 * t2 + c2];
    if (apex1 == apex2) continue;
    int64_t p = tris[3 * t1 + (c1 + 1) % 3];
    int64_t q = tris[3 * t1 + (c1 + 2) % 3];
    int iq2 = -1, ip2 = -1;
    for (int i = 0; i < 3; ++i) {
      if (tris[3 * t2 + i] == q) iq2 = i;
      if (tris[3 * t2 + i] == p) ip2 = i;
    }
    if (iq2 < 0 || ip2 < 0) continue;
    double L = lengths[3 * t1 + c1];
    double pc = lengths[3 * t1 + (c1 + 2) % 3];
    double qc = lengths[3 * t1 + (c1 + 1) % 3];
    double pd = lengths[3 * t2 + iq2];
    double qd = lengths[3 * t2 + ip2];
    double xc = (pc * pc - qc * qc + L * L) / (2 * L);
    double yc = std::sqrt(std::max(pc * pc - xc * xc, 0.0));
    double xd = (pd * pd - qd * qd + L * L) / (2 * L);
    double yd = -std::sqrt(std::max(pd * pd - xd * xd, 0.0));
    double diag = std::hypot(xc - xd, yc - yd);
    if (diag <= eps || diag + 1e-12 >= pc + pd || diag + 1e-12 >= qc + qd)
      continue;

    int64_t e_pc = tri_eid[3 * t1 + (c1 + 2) % 3];
    int64_t e_qc = tri_eid[3 * t1 + (c1 + 1) % 3];
    int64_t e_pd = tri_eid[3 * t2 + iq2];
    int64_t e_qd = tri_eid[3 * t2 + ip2];

    tris[3 * t1] = p; tris[3 * t1 + 1] = apex1; tris[3 * t1 + 2] = apex2;
    lengths[3 * t1] = diag; lengths[3 * t1 + 1] = pd; lengths[3 * t1 + 2] = pc;
    tris[3 * t2] = q; tris[3 * t2 + 1] = apex1; tris[3 * t2 + 2] = apex2;
    lengths[3 * t2] = diag; lengths[3 * t2 + 1] = qd; lengths[3 * t2 + 2] = qc;
    double w_new = 0.5 * (weights[t1] + weights[t2]);
    weights[t1] = weights[t2] = w_new;

    sides2[2 * eid] = Side{t1, 0};
    sides2[2 * eid + 1] = Side{t2, 0};
    tri_eid[3 * t1] = eid;
    tri_eid[3 * t2] = eid;

    // Match the old side by EXACT (triangle, corner) — triangle alone
    // is ambiguous when both sides of an edge live on one triangle
    // (possible after nonmanifold/tufted gluing), and the Python
    // reference path matches the exact side; the two must stay
    // bit-identical for delaunay_flips="auto" determinism.
    auto rewire = [&](int64_t e, Side old_s, Side ns) {
      if (e < 0) return;
      for (int i = 0; i < 2; ++i)
        if (sides2[2 * e + i].t == old_s.t &&
            sides2[2 * e + i].c == old_s.c) {
          sides2[2 * e + i] = ns;
          break;
        }
      tri_eid[3 * ns.t + ns.c] = e;
    };
    rewire(e_pc, Side{t1, (c1 + 2) % 3}, Side{t1, 2});
    rewire(e_pd, Side{t2, iq2}, Side{t1, 1});
    rewire(e_qc, Side{t1, (c1 + 1) % 3}, Side{t2, 2});
    rewire(e_qd, Side{t2, ip2}, Side{t2, 1});
    ++n_flips;
    int64_t touched[5] = {eid, e_pc, e_pd, e_qc, e_qd};
    for (int i = 0; i < 5; ++i) {
      int64_t e = touched[i];
      if (e >= 0 && paired[e] && !in_queue[e]) {
        queue.push_back(e);
        in_queue[e] = 1;
      }
    }
  }
  return n_flips;
}

}  // extern "C"
