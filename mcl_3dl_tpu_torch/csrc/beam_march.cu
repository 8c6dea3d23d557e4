// The beam model's fixed-step march for Hopper (sm_90a).
//
// M1 mcl_march_fixed computes models/beam.py::raycast_fixed for rays
// already set up by the caller (begin, unit direction and the probe limit
// l_b = floor((|ray| + hit_range) / grid), all from PyTorch): for
// i = 1 .. num_steps - 1 while i < l_b it probes t_i = f32(i * grid),
// reads the nearest-cell code of the distance field at begin + dir * t_i
// (DistanceField.sample_nearest: the _cells transform, gather_codes'
// out-of-map rule, code * trunc/255), keeps the first entry
// (d < 0.99 trunc) and the first hit (d <= sqrt(2) grid_max / 2), and
// forms the incidence sin_ang and the collision point as the loop does.
// Outputs: found [R] bool, cpos [R, 3] f32, sin_ang [R] f32.
//
// It replaces no Pallas kernel.  On the TPU this march is an XLA
// lax.fori_loop (mcl_3dl_tpu/models/beam.py:269-331, raycast_fixed, called
// from the overflow rescore at :488) that the compiler fuses into one
// loop; the port's plain version is a Python loop of ~20 small torch ops
// a probe.
//
// Exact arithmetic.  Built with -fmad=false and spelled with __fmul_rn,
// __fadd_rn, __fsub_rn and __fdiv_rn, each operation rounds as the plain
// version's torch op does: q * w - origin, then a true division by the
// cell (the plain version divides by a device scalar), round half to
// even, and t_i as one f32 rounding of the exact product i * grid.  A ray
// stops at its first hit or once i >= l_b: after either, no later probe is
// eligible in the plain loop, so nothing can change.
//
// What bounds it on this card.  Each probe is ~20 f32 operations and one
// data-dependent u8 read from the field (1 MB at the flagship map, held
// in L2); the rays' own bytes (45 B a ray) are read and written once.
// Both bounds are a few microseconds at the main path's 196,608 rays, so
// the march is latency-bound: a thread's probes are a dependent chain of
// L2 reads.  One thread a ray gives 768 blocks of 256, under one wave of
// the card's 132 SMs x 2048 threads, which keeps every SM's warps
// interleaving their reads.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using mcl::Field;

constexpr int THREADS = 256;

struct March {
  int num_steps;
  float grid;            // f32(map_grid_min)
  float radius;          // f32(sqrt(2) * map_grid_max / 2)
  float d_entry_thr;     // f32(trunc * 0.99)
};

__global__ void __launch_bounds__(THREADS)
march_fixed_kernel(const float* __restrict__ begin,
                   const float* __restrict__ dir,
                   const float* __restrict__ l_b, Field f, March m,
                   bool* __restrict__ found_out, float* __restrict__ cpos,
                   float* __restrict__ sin_out, int n_rays) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n_rays) return;
  const float bx = begin[3 * r], by = begin[3 * r + 1], bz = begin[3 * r + 2];
  const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  const float lb = l_b[r];
  const float ox = f.origin[0], oy = f.origin[1], oz = f.origin[2];

  bool found = false;
  float t_hit = 0.0f, d_hit = 0.0f, t_entry = -1.0f, d_entry = f.trunc;
  for (int i = 1; i < m.num_steps && (float)i < lb; ++i) {
    const float ti = __double2float_rn((double)i * (double)m.grid);
    const float d = mcl::sample_nearest(
        f, ox, oy, oz, __fadd_rn(bx, __fmul_rn(dx, ti)),
        __fadd_rn(by, __fmul_rn(dy, ti)), __fadd_rn(bz, __fmul_rn(dz, ti)));
    if (d < m.d_entry_thr && t_entry < 0.0f) {
      t_entry = ti;
      d_entry = d;
    }
    if (d <= m.radius) {
      t_hit = ti;
      d_hit = d;
      found = true;
      break;
    }
  }

  float sin_ang = 0.0f, cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (found) {
    const float span = __fsub_rn(t_hit, t_entry);
    sin_ang = 1.0f;
    if (t_entry >= 0.0f && span > m.grid)
      sin_ang = fminf(fmaxf(__fdiv_rn(__fsub_rn(d_entry, d_hit),
                                      fmaxf(span, 1e-6f)),
                            0.0f),
                      1.0f);
    cx = __fadd_rn(bx, __fmul_rn(dx, t_hit));
    cy = __fadd_rn(by, __fmul_rn(dy, t_hit));
    cz = __fadd_rn(bz, __fmul_rn(dz, t_hit));
  }
  found_out[r] = found;
  sin_out[r] = sin_ang;
  cpos[3 * r] = cx;
  cpos[3 * r + 1] = cy;
  cpos[3 * r + 2] = cz;
}

}  // namespace

extern "C" int mcl_march_fixed(const float* begin, const float* dir,
                               const float* l_b, const uint8_t* codes,
                               const float* origin, bool* found, float* cpos,
                               float* sin_ang, int n_rays, int nx, int ny,
                               int nz, int num_steps, float wx, float wy,
                               float wz, float cell, float scale, float trunc,
                               float grid, float radius, float d_entry_thr,
                               cudaStream_t stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  const Field f{codes, origin, nx, ny, nz, wx, wy, wz, cell, scale, trunc};
  const March m{num_steps, grid, radius, d_entry_thr};
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  march_fixed_kernel<<<blocks, THREADS, 0, stream>>>(
      begin, dir, l_b, f, m, found, cpos, sin_ang, n_rays);
  return (int)cudaGetLastError();
}
