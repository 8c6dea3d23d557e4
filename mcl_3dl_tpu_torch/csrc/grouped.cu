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
// f32, so coefficient c of slot j sits at A[(t*12 + c)*1024 + j].  For
// each virtual point k (a scan point, or a probe of the fixed march) and
// bin g there is one 144-row x 128-lane u8 table (18 KB) of the distance
// field around the bin's queries, its window origin meta[k, g] and a skip
// word: bit h set when no in-envelope query can match (K1), or enter or
// hit (K2), in rows 16h..16h+15; all nine bits (SKIP_ALL) when none can
// anywhere.
//
// What bounds them on this card.  Each (slot, point) lookup is ~20 f32
// operations in a fixed order (the affine query, unfused, as the plain
// PyTorch version rounds it) and one data-dependent u8 read from an 18 KB
// table that all ~11 tiles of a bin share.  The byte bound (each table,
// coefficient and output once) is 0.04-0.06 ms at the main path's shapes;
// the kernels run at 4-6x it (PERF.md).  What holds them there is
// the table reads: a table row (one x, y cell, 128 z lanes) is one
// 128-byte line, a warp's 32 queries of one point fall in as many lines
// as they have distinct rows, and each read waits on L1 or L2.  The
// design, chosen by a sweep on the card (PERF.md, findings on K1/K2):
//
//   * One block per tile (K2: per tile and beam, the beams of a tile in
//     neighbouring blocks, so the coefficient re-reads hit L2).  Tables
//     are read through L1 with __ldg.  A ring of tables copied into shared
//     memory with cp.async, shared by the 2-4 tiles of a block, lost to it
//     at every shape tried: the per-table barriers and copies cost more
//     than the shared-memory reads saved.
//   * A thread owns SLOTS slots, their 12 coefficients in registers, and
//     issues the table reads of POINTS points (SLOTS x POINTS loads) before
//     it uses any; each slot still sums its points in order, so the f32
//     results are bit-equal to the plain version's.
//   * The block compacts the live points (skip word != SKIP_ALL, in order)
//     into shared memory with the dequantized point and the window origin;
//     warps then walk the list on their own, without block barriers.  A
//     skipped point is an exact no-op on the slots the caller keeps.
//   * Rounding to the nearest cell is u + 1.5*2^23 in f32 (ties to even,
//     as __float2int_rn and torch.round) read back as an integer, with the
//     window origin folded in.  For |u| < 2^22 that is round(u); beyond,
//     the unsigned window test fails, as the plain version's does, while
//     window origins are below 2^22 - 12 cells.  The code -> distance ->
//     score mapping is a 257-entry table in shared memory computed with
//     the plain version's operations (entry 256: outside the window, the
//     truncation distance).  Conversions run at 1/8 of the f32 rate.
//   * K1 adds every live point's (contribution, match) pair, 0 when
//     unmatched, exactly as the plain version adds zeros.
//   * K2 marches only the probes 2 <= s < min(nprobe, l_b + 1) that are
//     live; an invalid beam's blocks return at once; a warp stops once
//     all its slots have found a hit (elig requires !found).  Penalties are
//     0/1 sums, added to the zeroed output with atomicAdd: exact in any
//     order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int BX = 12;
constexpr int BY = 12;
constexpr int R_ROWS = BX * BY;
constexpr int ZW = 128;
constexpr int TAB_BYTES = R_ROWS * ZW;               // 18432
constexpr int OUTSIDE = 256;                         // code of a query outside the window
constexpr int NCODE = 257;
constexpr float MAGIC = 12582912.0f;                 // 1.5 * 2^23
constexpr unsigned MAGIC_BITS = 0x4B400000u;         // its f32 bits

// slots per thread, and points whose table reads a thread issues before
// it uses any (PERF.md: the sweep)
constexpr int K1_SLOTS = 2;
constexpr int K2_SLOTS = 4;
constexpr int POINTS = 4;

// One live (point, bin) of a tile, staged in shared memory.
struct __align__(16) Live {
  float px, py, pz, t;     // dequantized point; K2: probe distance i*grid_min
  unsigned ox, oy, oz;     // window origin + MAGIC_BITS, per axis
  int kg;                  // table index k * G + g
};

// Dynamic shared memory of a block of T threads: the live list, the code
// table and the compaction counts.
template <int T>
constexpr int smem_bytes() {
  return T * (int)sizeof(Live) + NCODE * 8 + 32 * 4;
}

__device__ __forceinline__ float axis(float a0, float a1, float a2, float b,
                                      float px, float py, float pz) {
  // ((a0*px + a1*py) + a2*pz) + b, each operation rounded
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, px), __fmul_rn(a1, py)),
                             __fmul_rn(a2, pz)), b);
}

// Offset of the nearest cell of A p + b in the (point, bin) table, or -1
// outside the window.
__device__ __forceinline__ int cell_index(const float (&a)[12], const Live& e) {
  const float ux = axis(a[0], a[1], a[2], a[9], e.px, e.py, e.pz);
  const float uy = axis(a[3], a[4], a[5], a[10], e.px, e.py, e.pz);
  const float uz = axis(a[6], a[7], a[8], a[11], e.px, e.py, e.pz);
  const unsigned ix = __float_as_uint(__fadd_rn(ux, MAGIC)) - e.ox;
  const unsigned iy = __float_as_uint(__fadd_rn(uy, MAGIC)) - e.oy;
  const unsigned iz = __float_as_uint(__fadd_rn(uz, MAGIC)) - e.oz;
  const bool in = ix < (unsigned)BX && iy < (unsigned)BY && iz < (unsigned)ZW;
  return in ? (int)((ix * BY + iy) * ZW + iz) : -1;
}

// The codes of SLOTS queries of one point.
template <int S>
__device__ __forceinline__ void lookup_codes(const float (&a)[S][12],
                                             const Live& e,
                                             const uint8_t* __restrict__ tab,
                                             int (&code)[S]) {
  int idx[S];
#pragma unroll
  for (int i = 0; i < S; ++i) idx[i] = cell_index(a[i], e);
#pragma unroll
  for (int i = 0; i < S; ++i)
    code[i] = idx[i] >= 0 ? (int)__ldg(tab + idx[i]) : OUTSIDE;
}

// The coefficients of this thread's slots threadIdx.x + i*T (coalesced).
template <int S>
__device__ __forceinline__ void load_coef(float (&a)[S][12],
                                          const float* __restrict__ At) {
  constexpr int T = TILE / S;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int c = 0; c < 12; ++c)
      a[i][c] = __ldg(At + c * TILE + threadIdx.x + i * T);
}

__device__ __forceinline__ Live make_live(const int* __restrict__ p4,
                                          const int* __restrict__ m4,
                                          float pt_scale, int kg, float t) {
  Live e;
  e.px = __fmul_rn((float)__ldg(p4 + 0), pt_scale);
  e.py = __fmul_rn((float)__ldg(p4 + 1), pt_scale);
  e.pz = __fmul_rn((float)__ldg(p4 + 2), pt_scale);
  e.t = t;
  e.ox = MAGIC_BITS + (unsigned)__ldg(m4 + 0);
  e.oy = MAGIC_BITS + (unsigned)__ldg(m4 + 1);
  e.oz = MAGIC_BITS + (unsigned)__ldg(m4 + 2);
  e.kg = kg;
  return e;
}

// Compacts the flagged entries of one chunk (one candidate a thread) into
// list[0..n) in thread order; returns n in every thread.
template <int T>
__device__ int compact(bool flag, const Live& e, Live* list, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) wsum[warp] = __popc(bal);
  __syncthreads();
  int before = 0, n = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) {
    const int c = wsum[w];
    before += w < warp ? c : 0;
    n += c;
  }
  if (flag) list[before + __popc(bal & ((1u << lane) - 1u))] = e;
  __syncthreads();
  return n;
}

template <int S, int P>
__global__ void __launch_bounds__(TILE / S)
like_score_kernel(const float* __restrict__ A,
                  const int* __restrict__ tile_group,
                  const int* __restrict__ meta, const int* __restrict__ pts_fp,
                  const int* __restrict__ skipw,
                  const uint8_t* __restrict__ tables,
                  float* __restrict__ score, float* __restrict__ match, int kk,
                  int gg, int skip_all, float code_scale, float pt_scale,
                  float trunc, float mdm, float mdf, float mw) {
  constexpr int T = TILE / S;
  extern __shared__ __align__(16) uint8_t smem[];
  Live* list = reinterpret_cast<Live*>(smem);
  float2* lut = reinterpret_cast<float2*>(list + T);
  int* wsum = reinterpret_cast<int*>(lut + NCODE);

  const int t = blockIdx.x;
  const int g = __ldg(tile_group + t);
  const float* At = A + (size_t)t * 12 * TILE;

  // (contribution, match) of each code: max(mw * (mdm - max(d, mdf)), 0)
  // and 1 where d <= mdm, else (0, 0)
  for (int c = threadIdx.x; c < NCODE; c += T) {
    const float d = c < 256 ? __fmul_rn((float)c, code_scale) : trunc;
    const bool m = d <= mdm;
    lut[c] = make_float2(
        m ? fmaxf(__fmul_rn(mw, __fsub_rn(mdm, fmaxf(d, mdf))), 0.0f) : 0.0f,
        m ? 1.0f : 0.0f);
  }
  float a[S][12], acc[S], mac[S];
  load_coef<S>(a, At);
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = mac[i] = 0.0f;

  for (int base = 0; base < kk; base += T) {
    const int k = base + (int)threadIdx.x;
    const int kg = k * gg + g;
    const bool live = k < kk && __ldg(skipw + kg) != skip_all;
    Live e = {};
    if (live)
      e = make_live(pts_fp + 4 * k, meta + 4 * (size_t)kg, pt_scale, kg, 0.0f);
    const int n = compact<T>(live, e, list, wsum);
    for (int q = 0; q < n; q += P) {
      int code[P][S];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (q + u >= n) break;
        const Live p = list[q + u];
        lookup_codes<S>(a, p, tables + (size_t)p.kg * TAB_BYTES, code[u]);
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (q + u >= n) break;
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const float2 cm = lut[code[u][i]];
          acc[i] = __fadd_rn(acc[i], cm.x);
          mac[i] = __fadd_rn(mac[i], cm.y);
        }
      }
    }
    __syncthreads();                    // the list is rewritten next chunk
  }
  const size_t slot0 = (size_t)t * TILE + threadIdx.x;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    score[slot0 + i * T] = acc[i];
    match[slot0 + i * T] = mac[i];
  }
}

struct March {
  bool found;
  float t_hit, d_hit, t_entry, d_entry;
};

template <int S, int P>
__global__ void __launch_bounds__(TILE / S)
beam_pen_kernel(const float* __restrict__ A,
                const int* __restrict__ tile_group,
                const int* __restrict__ meta, const int* __restrict__ pts_fp,
                const int* __restrict__ aux, const int* __restrict__ skip,
                const uint8_t* __restrict__ tables, float* __restrict__ npen,
                int bb, int nprobe, int gg, int skip_all, int long_pen,
                float code_scale, float pt_scale, float trunc, float grid_min,
                float radius, float hr2, float sin_total_ref,
                float d_entry_thr, float tol) {
  constexpr int T = TILE / S;
  extern __shared__ __align__(16) uint8_t smem[];
  Live* list = reinterpret_cast<Live*>(smem);
  float* dlut = reinterpret_cast<float*>(list + T);
  int* wsum = reinterpret_cast<int*>(dlut + 2 * NCODE);

  const int t = blockIdx.x / bb;
  const int b = blockIdx.x - t * bb;
  if (__ldg(aux + 2 * b + 1) <= 0) return;      // invalid beam: adds nothing
  const float len_b = __fmul_rn((float)__ldg(aux + 2 * b), pt_scale);
  // probes at i*grid_min for 1 <= i < floor((len + tol) / grid_min)
  const float l_b = floorf(__fdiv_rn(__fadd_rn(len_b, tol), grid_min));
  const int g = __ldg(tile_group + t);
  const float* At = A + (size_t)t * 12 * TILE;

  for (int c = threadIdx.x; c < NCODE; c += T)
    dlut[c] = c < 256 ? __fmul_rn((float)c, code_scale) : trunc;
  float a[S][12];
  load_coef<S>(a, At);
  March m[S];
#pragma unroll
  for (int i = 0; i < S; ++i) m[i] = March{false, 0.0f, 0.0f, -1.0f, trunc};

  bool done = false;
  for (int base = 0; base < nprobe; base += T) {
    const int s = base + (int)threadIdx.x;
    const int kp = b * nprobe + s;
    const int kg = kp * gg + g;
    // eligible probes: i = s - 1 with 1 <= i < l_b
    const bool live = s < nprobe && s >= 2 && (float)(s - 1) < l_b &&
                      __ldg(skip + kg) != skip_all;
    Live e = {};
    if (live)
      e = make_live(pts_fp + 4 * kp, meta + 4 * (size_t)kg, pt_scale, kg,
                    __fmul_rn((float)(s - 1), grid_min));
    const int n = compact<T>(live, e, list, wsum);
    for (int q = 0; q < n && !__all_sync(0xffffffffu, done); q += P) {
      int code[P][S];
      float tp[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (q + u >= n) break;
        const Live p = list[q + u];
        tp[u] = p.t;
        lookup_codes<S>(a, p, tables + (size_t)p.kg * TAB_BYTES, code[u]);
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (q + u >= n) break;
        done = true;
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const float d = dlut[code[u][i]];
          if (!m[i].found) {
            // entry bookkeeping before the hit update, as the plain version
            if (d < d_entry_thr && m[i].t_entry < 0.0f) {
              m[i].t_entry = tp[u];
              m[i].d_entry = d;
            }
            if (d <= radius) {
              m[i].t_hit = tp[u];
              m[i].d_hit = d;
              m[i].found = true;
            }
          }
          done = done && m[i].found;
        }
      }
    }
    __syncthreads();                    // the list is rewritten next chunk
  }
  const size_t slot0 = (size_t)t * TILE + threadIdx.x;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    // incidence over the field-entry -> hit span
    const March& r = m[i];
    const float span = __fsub_rn(r.t_hit, r.t_entry);
    float sin_v = 1.0f;
    if (r.found && r.t_entry >= 0.0f && span > grid_min) {
      const float qv =
          __fdiv_rn(__fsub_rn(r.d_entry, r.d_hit), fmaxf(span, 1e-6f));
      sin_v = fminf(fmaxf(qv, 0.0f), 1.0f);
    }
    const bool graze = r.found && (sin_v <= sin_total_ref);
    const float dist = __fsub_rn(len_b, r.t_hit);
    const bool shrt = r.found && !graze && (__fmul_rn(dist, dist) >= hr2);
    const bool lng = !r.found && long_pen;
    if (shrt || lng) atomicAdd(npen + slot0 + i * T, 1.0f);
  }
}

// Raises a kernel's dynamic shared-memory limit to what it needs.
cudaError_t allow_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" int mcl_like_score(const float* A, const int* tile_group,
                              const int* meta, const int* pts_fp,
                              const int* skipw, const uint8_t* tables,
                              float* score, float* match, int n_slots, int kk,
                              int gg, int skip_all, float code_scale,
                              float pt_scale, float trunc, float mdm, float mdf,
                              float mw, cudaStream_t stream) {
  constexpr int S = K1_SLOTS, T = TILE / S;
  const int nt = n_slots / TILE;
  if (nt == 0) return (int)cudaSuccess;
  auto kernel = like_score_kernel<S, POINTS>;
  const int smem = smem_bytes<T>();
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<nt, T, smem, stream>>>(A, tile_group, meta, pts_fp, skipw, tables,
                                   score, match, kk, gg, skip_all, code_scale,
                                   pt_scale, trunc, mdm, mdf, mw);
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
  constexpr int S = K2_SLOTS, T = TILE / S;
  const int nt = n_slots / TILE;
  cudaError_t e = cudaMemsetAsync(npen, 0, sizeof(float) * (size_t)n_slots,
                                  stream);
  if (e != cudaSuccess || nt == 0 || bb == 0) return (int)e;
  auto kernel = beam_pen_kernel<S, POINTS>;
  const int smem = smem_bytes<T>();
  e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<nt * bb, T, smem, stream>>>(
      A, tile_group, meta, pts_fp, aux, skip, tables, npen, bb, nprobe, gg,
      skip_all, long_pen, code_scale, pt_scale, trunc, grid_min, radius, hr2,
      sin_total_ref, d_entry_thr, tol);
  return (int)cudaGetLastError();
}
