// The distance field's samplers on the device, shared by the marches
// (beam_march.cu: M1; tier2.cu: M2) and the field sampler (tier2.cu: M4).
//
// Each spells DistanceField's plain PyTorch version operation for
// operation (map/distance_field.py), so that a kernel built with
// -fmad=false gives its bits: the _cells transform q * w - origin, then a
// true division by the cell (the plain version divides by a device
// scalar, never by a reciprocal); round half to even for torch.round, a
// round down for torch.floor; gather_codes' out-of-map rule (trunc, else
// code * f32(trunc / 255)).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mcl {

struct Field {
  const uint8_t* codes;  // [nx, ny, nz]
  const float* origin;   // [3], weighted space
  int nx, ny, nz;
  float wx, wy, wz;      // dist weights, as f32
  float cell;            // as f32
  float scale;           // f32(trunc / 255)
  float trunc;           // f32(trunc): out-of-map distance
};

// a query in cell units along one axis: (q * w - origin) / cell
__device__ __forceinline__ float cells(float q, float w, float o,
                                       float cell) {
  return __fdiv_rn(__fsub_rn(__fmul_rn(q, w), o), cell);
}

// nearest-cell distance at q (DistanceField.sample_nearest), the origin
// already read into ox, oy, oz
__device__ __forceinline__ float sample_nearest(const Field& f, float ox,
                                                float oy, float oz, float qx,
                                                float qy, float qz) {
  const int ix = __float2int_rn(cells(qx, f.wx, ox, f.cell));
  const int iy = __float2int_rn(cells(qy, f.wy, oy, f.cell));
  const int iz = __float2int_rn(cells(qz, f.wz, oz, f.cell));
  if (ix < 0 || ix >= f.nx || iy < 0 || iy >= f.ny || iz < 0 || iz >= f.nz)
    return f.trunc;
  const uint8_t c =
      __ldg(f.codes + ((int64_t)ix * f.ny + iy) * f.nz + iz);
  return __fmul_rn((float)c, f.scale);
}

// corner offset d (0 or 1) of cell i stays inside [0, n); i + d wraps as
// the plain version's int32 sum does
__device__ __forceinline__ bool in_map(int i, int d, int n) {
  const int j = (int)((unsigned)i + (unsigned)d);
  return j >= 0 && j < n;
}

// trilinearly interpolated distance at q (DistanceField.sample_trilinear):
// the eight corners of the cell cube at floor(u), weights (1 - f, f), each
// out-of-map corner trunc, summed in the plain loop's order
// out + ((w0 * w1) * w2) * v over dx, dy, dz; through the corner pack
// `packed` ([nx * ny * nz, 2] words, the cube above each cell, word dx's
// byte dz + 2 dy) where it is not null, else eight reads of the codes
__device__ __forceinline__ float sample_trilinear(const Field& f,
                                                  const int32_t* packed,
                                                  float ox, float oy,
                                                  float oz, float qx,
                                                  float qy, float qz) {
  const float ux = cells(qx, f.wx, ox, f.cell);
  const float uy = cells(qy, f.wy, oy, f.cell);
  const float uz = cells(qz, f.wz, oz, f.cell);
  const int i0[3] = {__float2int_rd(ux), __float2int_rd(uy),
                     __float2int_rd(uz)};
  const float fx = __fsub_rn(ux, __int2float_rn(i0[0]));
  const float fy = __fsub_rn(uy, __int2float_rn(i0[1]));
  const float fz = __fsub_rn(uz, __int2float_rn(i0[2]));
  const float w[3][2] = {{__fsub_rn(1.0f, fx), fx},
                         {__fsub_rn(1.0f, fy), fy},
                         {__fsub_rn(1.0f, fz), fz}};
  const int dims[3] = {f.nx, f.ny, f.nz};
  bool in[3][2];
  for (int a = 0; a < 3; ++a) {
    in[a][0] = in_map(i0[a], 0, dims[a]);
    in[a][1] = in_map(i0[a], 1, dims[a]);
  }
  int32_t word[2] = {0, 0};
  if (packed != nullptr) {
    // the row of the cube's low corner, clamped into [0, n - 2]
    int64_t ic[3];
    for (int a = 0; a < 3; ++a)
      ic[a] = min(max(i0[a], 0), dims[a] - 2);
    const int64_t row = (ic[0] * f.ny + ic[1]) * f.nz + ic[2];
    word[0] = __ldg(packed + 2 * row);
    word[1] = __ldg(packed + 2 * row + 1);
  }
  float out = 0.0f;
  for (int dx = 0; dx < 2; ++dx)
    for (int dy = 0; dy < 2; ++dy)
      for (int dz = 0; dz < 2; ++dz) {
        const bool ok = in[0][dx] && in[1][dy] && in[2][dz];
        float v = f.trunc;
        if (ok) {
          int code;
          if (packed != nullptr) {
            code = (word[dx] >> (8 * (dz + 2 * dy))) & 0xFF;
          } else {
            const int64_t cell = ((int64_t)(i0[0] + dx) * f.ny + (i0[1] + dy))
                                     * f.nz + (i0[2] + dz);
            code = __ldg(f.codes + cell);
          }
          v = __fmul_rn((float)code, f.scale);
        }
        out = __fadd_rn(
            out, __fmul_rn(__fmul_rn(__fmul_rn(w[0][dx], w[1][dy]), w[2][dz]),
                           v));
      }
  return out;
}

}  // namespace mcl
