// Host-side map compiler of the port: the truncated distance-field splat
// and the occupancy / min-label / representative-point build.
//
// The port's counterpart of the JAX package's native/map_builder.cpp, with
// the same two C entry points.  It is held to give the same bytes as the
// port's numpy builds (map/distance_field.py::build_field_codes with
// native=False, map/occupancy.py::build_occupancy_arrays with
// native=False) by construction, so every operation is the numpy one:
//   * base cell: rint((p - origin) / cell) under the default rounding mode,
//     halves to even as np.round (not llround, which rounds them away);
//   * cell-centre offset: ((origin + base * cell) + d * cell) - p, with
//     d the offset from the base cell, in the numpy build's order;
//   * cut-off: sqrt(d2) < trunc on the double distance, then the float
//     cast of that distance as the numpy build's astype(float32);
//   * no contraction of a*b + c: ops/build.py compiles this file with
//     -ffp-contract=off and no -march, so no host's FMA changes a rounding.
// The early outs on dx^2 >= trunc^2 and dx^2 + dy^2 >= trunc^2 skip no
// selected cell: in binary floating point sqrt(fl(t * t)) == t, and the
// rounded sums and sqrt are monotone, so such a distance is >= trunc.
//
// Each thread owns a slab of x rows and walks every point, so each cell is
// written by one thread and the bytes do not depend on the thread count.
// Loaded with ctypes by map/native.py; built by g++ at first use
// (ops/build.py::build_map).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline int64_t flat_index(int64_t ny, int64_t nz, int64_t x, int64_t y,
                          int64_t z) {
  return (x * ny + y) * nz + z;
}

}  // namespace

extern "C" {

// points: [n, 3] float64, already scaled into weighted space.
// origin: [3] the grid's min corner (weighted space); cell: the cell size.
// field: [nx * ny * nz] float32, filled with float(trunc) by the caller;
// each cell within trunc of a point gets the least float distance.
// n_threads <= 0: one thread a hardware thread.  Returns 0.
int mcl3dl_build_distance_field(const double* points, int64_t n,
                                double cell, double trunc,
                                const double* origin, int64_t nx,
                                int64_t ny, int64_t nz, float* field,
                                int n_threads) {
  const int64_t r = static_cast<int64_t>(std::ceil(trunc / cell + 0.5));
  const double trunc2 = trunc * trunc;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = static_cast<int>(std::min<int64_t>(n_threads, nx));
  if (n_threads <= 0) return 0;

  auto worker = [&](int tid) {
    const int64_t x_lo = nx * tid / n_threads;
    const int64_t x_hi = nx * (tid + 1) / n_threads;
    for (int64_t i = 0; i < n; ++i) {
      const double* p = points + i * 3;
      int64_t b[3];
      double cb[3];
      for (int a = 0; a < 3; ++a) {
        b[a] = static_cast<int64_t>(std::nearbyint((p[a] - origin[a]) / cell));
        cb[a] = origin[a] + static_cast<double>(b[a]) * cell;
      }
      const int64_t x0 = std::max(b[0] - r, x_lo);
      const int64_t x1 = std::min(b[0] + r, x_hi - 1);
      if (x0 > x1) continue;
      const int64_t y0 = std::max<int64_t>(b[1] - r, 0);
      const int64_t y1 = std::min(b[1] + r, ny - 1);
      const int64_t z0 = std::max<int64_t>(b[2] - r, 0);
      const int64_t z1 = std::min(b[2] + r, nz - 1);
      for (int64_t x = x0; x <= x1; ++x) {
        const double dx = cb[0] + static_cast<double>(x - b[0]) * cell - p[0];
        const double dx2 = dx * dx;
        if (dx2 >= trunc2) continue;
        for (int64_t y = y0; y <= y1; ++y) {
          const double dy =
              cb[1] + static_cast<double>(y - b[1]) * cell - p[1];
          const double dxy2 = dx2 + dy * dy;
          if (dxy2 >= trunc2) continue;
          float* row = field + flat_index(ny, nz, x, y, 0);
          for (int64_t z = z0; z <= z1; ++z) {
            const double dz =
                cb[2] + static_cast<double>(z - b[2]) * cell - p[2];
            const double dist = std::sqrt(dxy2 + dz * dz);
            if (dist < trunc) {
              const float d = static_cast<float>(dist);
              if (d < row[z]) row[z] = d;
            }
          }
        }
      }
    }
  };

  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  return 0;
}

// points: [n, 3] float64 raw coordinates; labels: [n] uint32, or null for
// all 0.  origin: [3] the grid's min corner; dims nx, ny, nz.
// occupied [V] uint8 and min_label [V] uint32, filled with 0 and
// 0xFFFFFFFF by the caller; rep_offsets [V * rep_points * 3] uint8, filled
// with 127.  A voxel holding points gets occupied 1, the least label and
// rep_points stride samples of its points in point order (the first and
// the last among them), each as uint8 offsets: rint(255 * (p / cell -
// (origin / cell + voxel))) clipped to [0, 255], as the numpy build.
// Returns 0.
int mcl3dl_build_occupancy_rep(const double* points, const uint32_t* labels,
                               int64_t n, double cell, const double* origin,
                               int64_t nx, int64_t ny, int64_t nz,
                               int32_t rep_points, uint8_t* occupied,
                               uint32_t* min_label, uint8_t* rep_offsets) {
  const int64_t dims[3] = {nx, ny, nz};
  std::vector<int64_t> flat(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t v[3];
    for (int a = 0; a < 3; ++a) {
      v[a] = static_cast<int64_t>(
          std::floor((points[i * 3 + a] - origin[a]) / cell));
      v[a] = std::min(std::max<int64_t>(v[a], 0), dims[a] - 1);
    }
    flat[i] = flat_index(ny, nz, v[0], v[1], v[2]);
  }
  // by voxel, and in point order inside a voxel (np.argsort kind="stable")
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return flat[a] < flat[b]; });

  const int64_t denom = std::max<int64_t>(rep_points - 1, 1);
  for (int64_t s = 0; s < n;) {
    const int64_t idx = flat[order[s]];
    int64_t e = s;
    uint32_t lbl_min = 0xFFFFFFFFu;
    for (; e < n && flat[order[e]] == idx; ++e)
      lbl_min = std::min(lbl_min, labels ? labels[order[e]] : 0u);
    occupied[idx] = 1;
    min_label[idx] = lbl_min;
    const int64_t cnt = e - s;
    const int64_t v[3] = {idx / (nz * ny), (idx / nz) % ny, idx % nz};
    for (int32_t k = 0; k < rep_points; ++k) {
      const int64_t j = order[s + (k * (cnt - 1)) / denom];
      for (int a = 0; a < 3; ++a) {
        const double off = points[j * 3 + a] / cell -
                           (origin[a] / cell + static_cast<double>(v[a]));
        double q = std::nearbyint(off * 255.0);
        q = std::min(std::max(q, 0.0), 255.0);
        rep_offsets[(idx * rep_points + k) * 3 + a] = static_cast<uint8_t>(q);
      }
    }
    s = e;
  }
  return 0;
}

}  // extern "C"
