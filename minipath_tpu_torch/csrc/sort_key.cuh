// The pieces of the path tracer's sort keys shared by the compaction's key
// pass (csrc/compact.cu) and the NEE shadow batch's (csrc/shadow.cu): the
// Morton code of a point's cell in a 16^3 grid over a bounding box
// (render/wavefront.py::_position_cells and _morton16) and the direction bin
// (_direction_bin). Every float step is the plain version's, in its order,
// rounded as PyTorch's CUDA kernels round it: `c / t` for a Python number c
// is `(1 / t) * c`, 1 / t an IEEE division; clamp passes NaN through; a
// float-to-int32 cast truncates (and sends NaN to 0). The libraries are
// built with -fmad=false, so nothing fuses.

#pragma once

#include <cuda_runtime.h>

// float32 as PyTorch rounds the plain version's Python doubles.
constexpr float MIN_EXTENT = (float)1e-6;  // _position_cells' clamp of the box
constexpr float MIN_MAJOR = (float)1e-9;   // _direction_bin's clamp of |major|

__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ int clamp_int(int v, int lo, int hi) { return min(max(v, lo), hi); }

// _position_cells and _morton16 for one point `o` of the box [lo, hi]: axis
// c's bit b of the cell goes to bit 3b + 2 - c of the 12-bit code.
__device__ __forceinline__ int morton_cell(const float o[3], const float lo[3], const float hi[3]) {
  int morton = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float scale = (1.0f / clamp_min(hi[c] - lo[c], MIN_EXTENT)) * 16.0f;
    const int cell = (int)clamp((o[c] - lo[c]) * scale, 0.0f, 15.0f);
#pragma unroll
    for (int b = 0; b < 4; ++b) morton |= ((cell >> b) & 1) << (3 * b + (2 - c));
  }
  return morton;
}

// _direction_bin: one of 96 bins, 6 dominant-axis faces x 4 x 4 quantized
// minor components.
__device__ __forceinline__ int direction_bin(float x, float y, float z) {
  const float axv = fabsf(x), ayv = fabsf(y), azv = fabsf(z);
  const bool ax0 = axv >= ayv && axv >= azv;
  const bool ax1 = !ax0 && ayv >= azv;
  const float major = ax0 ? x : (ax1 ? y : z);
  const float m1 = ax0 ? y : (ax1 ? z : x);
  const float m2 = ax0 ? z : (ax1 ? x : y);
  const int face = 2 * (int)ax1 + 4 * (int)(!ax0 && !ax1) + (int)(major > 0.0f);
  const float inv_major = 1.0f / clamp_min(fabsf(major), MIN_MAJOR);
  const int q1 = clamp_int((int)((m1 * inv_major + 1.0f) * 2.0f), 0, 3);
  const int q2 = clamp_int((int)((m2 * inv_major + 1.0f) * 2.0f), 0, 3);
  return (face << 4) | (q1 << 2) | q2;
}
