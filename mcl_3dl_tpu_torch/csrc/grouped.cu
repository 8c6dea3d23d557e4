// Pose-grouped local-table kernels for Hopper (sm_90a).
//
// K1 mcl_like_score replaces mcl_3dl_tpu/ops/grouped.py::_like_kernel
//    (the likelihood-field score over the counting-sorted particle
//    layout).
// K2 mcl_beam_pen replaces mcl_3dl_tpu/ops/grouped.py::_beam_kernel
//    (the beam model's fixed kd-tree-style march over the same layout).
//
// Layout.  Particles are counting-sorted into 1024-slot tiles; every tile
// holds one pose bin (tile_group[t]).  Coefficients are [nt, 12, 1024]
// f32, so coefficient c of slot j sits at A[(t*12 + c)*1024 + j] and the
// 12 reads of a warp are coalesced.  One thread owns one sorted slot;
// a 256-thread block lies inside one tile, so all its threads read the
// same (point, bin) table and the same skip words (no divergence on the
// whole-point skip).
//
// Per virtual point k the thread dequantizes the 2^-16 fixed-point point,
// evaluates u = A p + b unfused (the library is built with -fmad=false and
// the query spells out __fmul_rn/__fadd_rn), rounds half-even relative to
// the (k, bin) window origin and reads one u8 code of the 144-row x
// 128-lane table straight from global memory / L2.  Points are looped in
// order inside the thread, so the f32 sums are accumulated in the same
// order as the plain PyTorch version: the results are bit-equal.
//
// The per-block skip bits of the TPU kernel are ignored: a skipped block
// is an exact no-op for in-envelope queries, and slots outside the
// envelope are rescored or never read.  The whole-point word SKIP_ALL is
// honoured (uniform per block).
//
// Bound on the H100: device-memory bytes.  Each live (point, bin) table
// is 18 KB and is read by every tile of that bin; the coefficients are
// 48 B per slot; the arithmetic is ~20 f32 operations per lookup.
// Left for later: staging the (k, bin) tables in shared memory with TMA
// or cp.async, and several particles per thread to cut the per-lookup
// index arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int BX = 12;
constexpr int BY = 12;
constexpr int R_ROWS = BX * BY;
constexpr int ZW = 128;
constexpr int THREADS = 256;

struct Coef {
  float a[12];
};

__device__ __forceinline__ Coef load_coef(const float* __restrict__ A,
                                          int t, int j) {
  Coef c;
  const float* base = A + (size_t)t * 12 * TILE + j;
#pragma unroll
  for (int i = 0; i < 12; ++i) c.a[i] = __ldg(base + (size_t)i * TILE);
  return c;
}

__device__ __forceinline__ float axis(float a0, float a1, float a2, float b,
                                      float px, float py, float pz) {
  // ((a0*px + a1*py) + a2*pz) + b, each operation rounded
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, px), __fmul_rn(a1, py)),
                             __fmul_rn(a2, pz)), b);
}

// Distance of the nearest-cell lookup of A p + b in one local table:
// code * trunc/255 inside the window, trunc outside.
__device__ __forceinline__ float table_dist(const Coef& c, float px, float py,
                                            float pz, const int* __restrict__ m,
                                            const uint8_t* __restrict__ tab,
                                            float code_scale, float trunc) {
  const float ux = axis(c.a[0], c.a[1], c.a[2], c.a[9], px, py, pz);
  const float uy = axis(c.a[3], c.a[4], c.a[5], c.a[10], px, py, pz);
  const float uz = axis(c.a[6], c.a[7], c.a[8], c.a[11], px, py, pz);
  const int ix = __float2int_rn(ux) - __ldg(m + 0);
  const int iy = __float2int_rn(uy) - __ldg(m + 1);
  const int iz = __float2int_rn(uz) - __ldg(m + 2);
  if (ix < 0 || ix >= BX || iy < 0 || iy >= BY || iz < 0 || iz >= ZW)
    return trunc;
  const float code = (float)__ldg(tab + (ix * BY + iy) * ZW + iz);
  return __fmul_rn(code, code_scale);
}

__device__ __forceinline__ float point_coord(const int* __restrict__ pts,
                                             int i, float pt_scale) {
  return __fmul_rn((float)__ldg(pts + i), pt_scale);
}

__global__ void __launch_bounds__(THREADS)
like_score_kernel(const float* __restrict__ A,
                  const int* __restrict__ tile_group,
                  const int* __restrict__ meta, const int* __restrict__ pts_fp,
                  const int* __restrict__ skipw,
                  const uint8_t* __restrict__ tables,
                  float* __restrict__ score, float* __restrict__ match,
                  int n_slots, int kk, int gg, int skip_all, float code_scale,
                  float pt_scale, float trunc, float mdm, float mdf, float mw) {
  const int slot = blockIdx.x * THREADS + threadIdx.x;
  if (slot >= n_slots) return;
  const int t = slot / TILE;
  const int g = __ldg(tile_group + t);
  const Coef c = load_coef(A, t, slot % TILE);
  float acc = 0.0f, mac = 0.0f;
  for (int k = 0; k < kk; ++k) {
    const int kg = k * gg + g;
    if (__ldg(skipw + kg) == skip_all) continue;  // no cell can match
    const float px = point_coord(pts_fp, k * 4 + 0, pt_scale);
    const float py = point_coord(pts_fp, k * 4 + 1, pt_scale);
    const float pz = point_coord(pts_fp, k * 4 + 2, pt_scale);
    const float d = table_dist(c, px, py, pz, meta + (size_t)kg * 4,
                               tables + (size_t)kg * R_ROWS * ZW,
                               code_scale, trunc);
    if (d <= mdm) {
      // max(mw * (mdm - max(d, mdf)), 0), then the running sums
      const float contrib =
          fmaxf(__fmul_rn(mw, __fsub_rn(mdm, fmaxf(d, mdf))), 0.0f);
      acc = __fadd_rn(acc, contrib);
      mac = __fadd_rn(mac, 1.0f);
    }
  }
  score[slot] = acc;
  match[slot] = mac;
}

__global__ void __launch_bounds__(THREADS)
beam_pen_kernel(const float* __restrict__ A,
                const int* __restrict__ tile_group,
                const int* __restrict__ meta, const int* __restrict__ pts_fp,
                const int* __restrict__ aux, const int* __restrict__ skip,
                const uint8_t* __restrict__ tables, float* __restrict__ npen,
                int n_slots, int bb, int nprobe, int gg, int skip_all,
                int long_pen, float code_scale, float pt_scale, float trunc,
                float grid_min, float radius, float hr2, float sin_total_ref,
                float d_entry_thr, float tol) {
  const int slot = blockIdx.x * THREADS + threadIdx.x;
  if (slot >= n_slots) return;
  const int t = slot / TILE;
  const int g = __ldg(tile_group + t);
  const Coef c = load_coef(A, t, slot % TILE);
  float total = 0.0f;
  for (int b = 0; b < bb; ++b) {
    const float len_b = __fmul_rn((float)__ldg(aux + 2 * b), pt_scale);
    const bool bvalid = __ldg(aux + 2 * b + 1) > 0;
    // probes at i*grid_min for 1 <= i < floor((len + tol) / grid_min)
    const float l_b = floorf(__fdiv_rn(__fadd_rn(len_b, tol), grid_min));
    bool found = false;
    float t_hit = 0.0f, d_hit = 0.0f, t_entry = -1.0f, d_entry = trunc;
    for (int s = 0; s < nprobe; ++s) {
      const int kp = b * nprobe + s;
      const int kg = kp * gg + g;
      // all blocks skippable: empty space, an exact identity on the carry
      if (__ldg(skip + kg) == skip_all) continue;
      const float px = point_coord(pts_fp, kp * 4 + 0, pt_scale);
      const float py = point_coord(pts_fp, kp * 4 + 1, pt_scale);
      const float pz = point_coord(pts_fp, kp * 4 + 2, pt_scale);
      const float d = table_dist(c, px, py, pz, meta + (size_t)kg * 4,
                                 tables + (size_t)kg * R_ROWS * ZW,
                                 code_scale, trunc);
      const float i = (float)(s - 1);
      const bool elig = (i >= 1.0f) && (i < l_b) && bvalid && !found;
      if (elig && d < d_entry_thr && t_entry < 0.0f) {
        t_entry = __fmul_rn(i, grid_min);
        d_entry = d;
      }
      if (elig && d <= radius) {
        t_hit = __fmul_rn(i, grid_min);
        d_hit = d;
        found = true;
      }
    }
    // incidence over the field-entry -> hit span
    const float span = __fsub_rn(t_hit, t_entry);
    float sin_v = 1.0f;
    if (found && t_entry >= 0.0f && span > grid_min) {
      const float q = __fdiv_rn(__fsub_rn(d_entry, d_hit), fmaxf(span, 1e-6f));
      sin_v = fminf(fmaxf(q, 0.0f), 1.0f);
    }
    const bool graze = found && (sin_v <= sin_total_ref);
    const float dist = __fsub_rn(len_b, t_hit);
    const bool shrt = found && !graze && (__fmul_rn(dist, dist) >= hr2);
    const bool lng = !found && long_pen;
    if ((shrt || lng) && bvalid) total = __fadd_rn(total, 1.0f);
  }
  npen[slot] = total;
}

}  // namespace

extern "C" int mcl_like_score(const float* A, const int* tile_group,
                              const int* meta, const int* pts_fp,
                              const int* skipw, const uint8_t* tables,
                              float* score, float* match, int n_slots, int kk,
                              int gg, int skip_all, float code_scale,
                              float pt_scale, float trunc, float mdm, float mdf,
                              float mw, cudaStream_t stream) {
  const int blocks = (n_slots + THREADS - 1) / THREADS;
  like_score_kernel<<<blocks, THREADS, 0, stream>>>(
      A, tile_group, meta, pts_fp, skipw, tables, score, match, n_slots, kk,
      gg, skip_all, code_scale, pt_scale, trunc, mdm, mdf, mw);
  return (int)cudaGetLastError();
}

extern "C" int mcl_beam_pen(const float* A, const int* tile_group,
                            const int* meta, const int* pts_fp, const int* aux,
                            const int* skip, const uint8_t* tables, float* npen,
                            int n_slots, int bb, int nprobe, int gg,
                            int skip_all, int long_pen, float code_scale,
                            float pt_scale, float trunc, float grid_min,
                            float radius, float hr2, float sin_total_ref,
                            float d_entry_thr, float tol, cudaStream_t stream) {
  const int blocks = (n_slots + THREADS - 1) / THREADS;
  beam_pen_kernel<<<blocks, THREADS, 0, stream>>>(
      A, tile_group, meta, pts_fp, aux, skip, tables, npen, n_slots, bb,
      nprobe, gg, skip_all, long_pen, code_scale, pt_scale, trunc, grid_min,
      radius, hr2, sin_total_ref, d_entry_thr, tol);
  return (int)cudaGetLastError();
}
