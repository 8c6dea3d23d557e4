// The tier-2 measurement for Hopper (sm_90a): the beam's two marches and
// the likelihood's field sampler, one thread a ray or a query.
//
// M2 mcl_march_sphere: the sphere trace of models/beam.py::raycast_df on
// rays already set up by the caller (begin, unit direction, the range
// max_t = floor((|ray| + tol) / grid) * grid and wu = |W u|, all from
// PyTorch): from t = grid, while the ray has not hit and t < max_t, for
// at most num_steps probes, read the nearest-cell distance d at
// begin + dir * t, keep the first field entry (d < 0.99 trunc), stop at a
// hit (d <= sqrt(2) grid_max / 2), else step t += max((d - r) /
// max(wu, 1e-6), grid).  Outputs the loop's carry: found [R] bool, cpos
// [R, 3], d0_hit, t_entry, d_entry [R] f32; the incidence epilogue stays
// PyTorch.
//
// M3 mcl_march_dda: the half-cell march of models/beam.py::raycast_occ
// over the occupancy grid, on rays set up by the caller (begin, direction,
// max_t = |ray| + tol, begin_inside, begin_voxel): for s < num_steps while
// t = f32((s + 1) * step) < max_t, the voxel floor((p - origin) / cell)
// (a true division), out of the map unoccupied, the int64 minimum label
// against filter_label_max, the origin's voxel skipped, and with
// `refine` the first of the voxel's representative points
// origin + (i + q / 255) * cell whose squared perpendicular distance
// (|rel|^2 - foot^2, foot = |rel . dir|, each three-term sum added x + y,
// then + z) is below max((ray_angle_half * foot)^2, min_dist_thr_sq);
// without it the first representative.  Outputs found [R] bool and
// cpos [R, 3].
//
// M4 mcl_sample_field: DistanceField.sample_nearest or sample_trilinear
// (through the corner pack where the field has one) at queries q [Q, 3]
// (field.cuh), out [Q] f32.
//
// None replaces a Pallas kernel.  On the TPU the marches are XLA
// lax.while_loops (mcl_3dl_tpu/models/beam.py:132, raycast_df, and :259,
// raycast_occ) and the sampler is the gather XLA fuses into the tier-2
// likelihood (mcl_3dl_tpu/models/likelihood.py:170-187); the port's plain
// versions are Python loops of 15-30 small torch ops a probe that read
// their exit on the host every probe, and ~40 eager ops over [N, K] for
// the trilinear gather.
//
// Exact arithmetic.  Built with -fmad=false and spelled with __fmul_rn,
// __fadd_rn, __fsub_rn and __fdiv_rn, each operation rounds as the plain
// version's torch op does.  A ray stops at its own exit (a hit, or t past
// its range): from then on the plain loop's `active` mask is false for
// it, so its later iterations change nothing; this is why one thread a
// ray gives the vectorised loop's bits, with or without its early exit.
//
// What bounds them on this card.  M4 streams its queries: 12 B read and
// 4 B written a query (1.6 GB at the 1M x 96 tier-2 likelihood, 0.48 ms
// at 3.35 TB/s), its table reads hitting L2 (the flagship field is 1 MB,
// its corner pack 8 MB); the operations (~60 a trilinear query) are far
// under the f32 rate.  M2 and M3 read and write 50-60 B a ray once, and
// their probes are chains of dependent table reads (L2-resident: the
// field, or the occupancy grid's 21 B a voxel), so they are
// latency-bound below a few thousand rays and bytes-bound at the 1M x 3
// fallback; one thread a ray, 256 a block, keeps every SM's warps
// interleaving their reads.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using mcl::Field;

constexpr int THREADS = 256;

// torch.clamp(v, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ int64_t thread_index() {
  return (int64_t)blockIdx.x * THREADS + threadIdx.x;
}

int blocks_for(int64_t n) { return (int)((n + THREADS - 1) / THREADS); }

// ---- M4

__global__ void __launch_bounds__(THREADS)
sample_field_kernel(const float* __restrict__ q, Field f,
                    const int32_t* __restrict__ packed, bool trilinear,
                    float* __restrict__ out, int64_t n) {
  const int64_t i = thread_index();
  if (i >= n) return;
  const float ox = f.origin[0], oy = f.origin[1], oz = f.origin[2];
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  out[i] = trilinear
               ? mcl::sample_trilinear(f, packed, ox, oy, oz, qx, qy, qz)
               : mcl::sample_nearest(f, ox, oy, oz, qx, qy, qz);
}

// ---- M2

struct Sphere {
  int num_steps;
  float grid;            // f32(map_grid_min)
  float radius;          // f32(sqrt(2) * map_grid_max / 2)
  float d_entry_thr;     // f32(trunc * 0.99)
};

__global__ void __launch_bounds__(THREADS)
march_sphere_kernel(const float* __restrict__ begin,
                    const float* __restrict__ dir,
                    const float* __restrict__ max_t,
                    const float* __restrict__ wu, Field f, Sphere m,
                    bool* __restrict__ found_out, float* __restrict__ cpos,
                    float* __restrict__ d0_out, float* __restrict__ te_out,
                    float* __restrict__ de_out, int64_t n_rays) {
  const int64_t r = thread_index();
  if (r >= n_rays) return;
  const float bx = begin[3 * r], by = begin[3 * r + 1], bz = begin[3 * r + 2];
  const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  const float mt = max_t[r];
  const float wu_c = clamp_min(wu[r], 1e-6f);
  const float ox = f.origin[0], oy = f.origin[1], oz = f.origin[2];

  bool found = false;
  float t = m.grid, cx = 0.0f, cy = 0.0f, cz = 0.0f, d0 = 0.0f;
  float t_entry = -1.0f, d_entry = f.trunc;
  for (int s = 0; s < m.num_steps && t < mt; ++s) {
    const float px = __fadd_rn(bx, __fmul_rn(dx, t));
    const float py = __fadd_rn(by, __fmul_rn(dy, t));
    const float pz = __fadd_rn(bz, __fmul_rn(dz, t));
    const float d = mcl::sample_nearest(f, ox, oy, oz, px, py, pz);
    if (d < m.d_entry_thr && t_entry < 0.0f) {
      t_entry = t;
      d_entry = d;
    }
    if (d <= m.radius) {
      cx = px;
      cy = py;
      cz = pz;
      d0 = d;
      found = true;
      break;
    }
    t = __fadd_rn(
        t, clamp_min(__fdiv_rn(__fsub_rn(d, m.radius), wu_c), m.grid));
  }
  found_out[r] = found;
  cpos[3 * r] = cx;
  cpos[3 * r + 1] = cy;
  cpos[3 * r + 2] = cz;
  d0_out[r] = d0;
  te_out[r] = t_entry;
  de_out[r] = d_entry;
}

// ---- M3

struct Occ {
  const bool* occupied;      // [nx, ny, nz]
  const int64_t* min_label;  // [nx, ny, nz]
  const uint8_t* rep;        // [nx, ny, nz, reps, 3] u8 offsets
  const float* origin;       // [3]
  int nx, ny, nz, reps;
  float cell;                // as f32
};

struct Dda {
  int num_steps;
  float step;                // f32(cell * 0.5)
  int64_t label_max;         // filter_label_max
  float ray_angle_half;      // as f32
  float min_dist_thr_sq;     // as f32
  bool refine;
};

__global__ void __launch_bounds__(THREADS)
march_dda_kernel(const float* __restrict__ begin,
                 const float* __restrict__ dir,
                 const float* __restrict__ max_t,
                 const bool* __restrict__ begin_inside,
                 const int* __restrict__ begin_voxel, Occ o, Dda m,
                 bool* __restrict__ found_out, float* __restrict__ cpos,
                 int64_t n_rays) {
  const int64_t r = thread_index();
  if (r >= n_rays) return;
  const float b[3] = {begin[3 * r], begin[3 * r + 1], begin[3 * r + 2]};
  const float d[3] = {dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
  const int bv[3] = {begin_voxel[3 * r], begin_voxel[3 * r + 1],
                     begin_voxel[3 * r + 2]};
  const float org[3] = {o.origin[0], o.origin[1], o.origin[2]};
  const int dims[3] = {o.nx, o.ny, o.nz};
  const float mt = max_t[r];

  bool found = false;
  float c[3] = {0.0f, 0.0f, 0.0f};
  // a ray that begins outside the map never collides
  for (int s = 0; begin_inside[r] && s < m.num_steps; ++s) {
    const float t = __double2float_rn((double)(s + 1) * (double)m.step);
    if (!(t < mt)) break;
    int v[3];
    bool inside = true;
    for (int a = 0; a < 3; ++a) {
      const float p = __fadd_rn(b[a], __fmul_rn(d[a], t));
      v[a] = __float2int_rd(__fdiv_rn(__fsub_rn(p, org[a]), o.cell));
      inside = inside && v[a] >= 0 && v[a] < dims[a];
    }
    if (!inside) continue;
    const int64_t flat = ((int64_t)v[0] * o.ny + v[1]) * o.nz + v[2];
    if (!o.occupied[flat] || __ldg(reinterpret_cast<const long long*>(o.min_label) + flat) >
                                  m.label_max)
      continue;
    if (v[0] == bv[0] && v[1] == bv[1] && v[2] == bv[2]) continue;
    const uint8_t* rep = o.rep + flat * o.reps * 3;
    for (int k = 0; k < o.reps; ++k) {
      float rp[3];
      for (int a = 0; a < 3; ++a)
        rp[a] = __fadd_rn(
            org[a],
            __fmul_rn(__fadd_rn(__int2float_rn(v[a]),
                                __fdiv_rn((float)__ldg(rep + 3 * k + a),
                                          255.0f)),
                      o.cell));
      bool pass = true;
      if (m.refine) {
        float rel[3];
        for (int a = 0; a < 3; ++a) rel[a] = __fsub_rn(rp[a], b[a]);
        const float foot = fabsf(__fadd_rn(
            __fadd_rn(__fmul_rn(rel[0], d[0]), __fmul_rn(rel[1], d[1])),
            __fmul_rn(rel[2], d[2])));
        const float ra = __fmul_rn(m.ray_angle_half, foot);
        const float thr = clamp_min(__fmul_rn(ra, ra), m.min_dist_thr_sq);
        const float len2 = __fadd_rn(
            __fadd_rn(__fmul_rn(rel[0], rel[0]), __fmul_rn(rel[1], rel[1])),
            __fmul_rn(rel[2], rel[2]));
        pass = __fsub_rn(len2, __fmul_rn(foot, foot)) < thr;
      }
      if (pass) {
        c[0] = rp[0];
        c[1] = rp[1];
        c[2] = rp[2];
        found = true;
        break;
      }
    }
    if (found) break;
  }
  found_out[r] = found;
  cpos[3 * r] = c[0];
  cpos[3 * r + 1] = c[1];
  cpos[3 * r + 2] = c[2];
}

}  // namespace

extern "C" int mcl_sample_field(const float* q, const uint8_t* codes,
                                const int32_t* packed, const float* origin,
                                float* out, int64_t n, int nx, int ny, int nz,
                                float wx, float wy, float wz, float cell,
                                float scale, float trunc, int trilinear,
                                cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  const Field f{codes, origin, nx, ny, nz, wx, wy, wz, cell, scale, trunc};
  sample_field_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      q, f, packed, trilinear != 0, out, n);
  return (int)cudaGetLastError();
}

extern "C" int mcl_march_sphere(const float* begin, const float* dir,
                                const float* max_t, const float* wu,
                                const uint8_t* codes, const float* origin,
                                bool* found, float* cpos, float* d0_hit,
                                float* t_entry, float* d_entry, int64_t n_rays,
                                int nx, int ny, int nz, int num_steps,
                                float wx, float wy, float wz, float cell,
                                float scale, float trunc, float grid,
                                float radius, float d_entry_thr,
                                cudaStream_t stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  const Field f{codes, origin, nx, ny, nz, wx, wy, wz, cell, scale, trunc};
  const Sphere m{num_steps, grid, radius, d_entry_thr};
  march_sphere_kernel<<<blocks_for(n_rays), THREADS, 0, stream>>>(
      begin, dir, max_t, wu, f, m, found, cpos, d0_hit, t_entry, d_entry,
      n_rays);
  return (int)cudaGetLastError();
}

extern "C" int mcl_march_dda(const float* begin, const float* dir,
                             const float* max_t, const bool* begin_inside,
                             const int* begin_voxel, const bool* occupied,
                             const int64_t* min_label, const uint8_t* rep,
                             const float* origin, bool* found, float* cpos,
                             int64_t n_rays, int nx, int ny, int nz, int reps,
                             int num_steps, float step, float cell,
                             int64_t label_max, float ray_angle_half,
                             float min_dist_thr_sq, int refine,
                             cudaStream_t stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  const Occ o{occupied, min_label, rep, origin, nx, ny, nz, reps, cell};
  const Dda m{num_steps, step, label_max, ray_angle_half, min_dist_thr_sq,
              refine != 0};
  march_dda_kernel<<<blocks_for(n_rays), THREADS, 0, stream>>>(
      begin, dir, max_t, begin_inside, begin_voxel, o, m, found, cpos,
      n_rays);
  return (int)cudaGetLastError();
}
