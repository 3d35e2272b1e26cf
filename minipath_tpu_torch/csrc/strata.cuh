// The sample strata of render/stratify.py on uint32 lanes, shared by the
// bounce-shading kernel (csrc/shade.cu) and the camera-ray kernel
// (csrc/camera.cu).
//
// stratify.py keeps a uint32 in an int64 and masks every multiply and left
// shift back to 32 bits; here the same steps wrap in uint32 arithmetic, which
// gives the same bits. A pixel id (a signed int32, the render's seed XORed
// in) enters by its two's-complement bit pattern, as stratify.py's _u32 does.
//
// Two modes: hashed jitter (a cyclic shift of the pixel's strata by a hash of
// its id and the dimension's salt, then the uniform inside the stratum) and
// Owen-scrambled Sobol (no uniform read).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

enum { STRAT_NONE = 0, STRAT_JITTER = 1, STRAT_SOBOL = 2 };

constexpr unsigned GOLDEN = 0x9E3779B9u;  // Weyl increment between dimension salts

__device__ __forceinline__ unsigned hash_u32(unsigned x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  x = x ^ (x >> 15);
  return x;
}

__device__ __forceinline__ unsigned hash_shift(int pid, int spp, unsigned salt) {
  return hash_u32((unsigned)pid ^ (salt * GOLDEN)) % (unsigned)spp;
}

__device__ __forceinline__ unsigned laine_karras(unsigned x, unsigned seed) {
  x = x + seed;
  x = x ^ (x * 0x6C50B47Cu);
  x = x ^ (x * 0xB82F1E52u);
  x = x ^ (x * 0xC7AFE638u);
  x = x ^ (x * 0x8D22F6E6u);
  return x;
}

__device__ __forceinline__ unsigned owen(unsigned x, unsigned seed) {
  return __brev(laine_karras(__brev(x), seed));
}

__device__ __forceinline__ unsigned dim_seed(int pid, unsigned salt, unsigned which) {
  return hash_u32((unsigned)pid ^ ((salt * 2u + which) * GOLDEN));
}

__device__ __forceinline__ float to_unit(unsigned x) { return (float)(x >> 8) * 0x1p-24f; }

// The i-th point of the second Sobol dimension.
__device__ __forceinline__ unsigned sobol_dim1(unsigned i) {
  unsigned y = 0;
#pragma unroll
  for (int bit = 0; bit < 32; ++bit) {
    // Direction numbers: v_0 = 2^31, v_j = v_{j-1} ^ (v_{j-1} >> 1).
    unsigned v = 0x80000000u;
    for (int k = 0; k < bit; ++k) v ^= v >> 1;
    if ((i >> bit) & 1u) y ^= v;
  }
  return y;
}

// stratify.py::strat1d for sample s of pixel pid: spp > 0 strata (inv_spp is
// float32(1 / spp)), or Sobol.
__device__ __forceinline__ float stratify1d(int mode, int spp, float inv_spp, int s, int pid, float u,
                                            unsigned salt) {
  if (mode == STRAT_SOBOL) return to_unit(owen(__brev((unsigned)s), dim_seed(pid, salt, 0)));
  const unsigned j = (unsigned)(((int64_t)s + hash_shift(pid, spp, salt)) % spp);
  return ((float)j + u) * inv_spp;
}

// stratify.py::strat2d on the gx x gy grid of grid_factor(spp) (inv_gx and
// inv_gy are float32(1 / gx) and float32(1 / gy)), or Sobol; u1 and u2 are the
// uniforms in, the stratified pair out.
__device__ __forceinline__ void stratify2d(int mode, int spp, int gx, float inv_gx, float inv_gy, int s, int pid,
                                           float& u1, float& u2, unsigned salt) {
  if (mode == STRAT_SOBOL) {
    const unsigned i = (unsigned)s;
    u1 = to_unit(owen(__brev(i), dim_seed(pid, salt, 0)));
    u2 = to_unit(owen(sobol_dim1(i), dim_seed(pid, salt, 1)));
    return;
  }
  const unsigned j = (unsigned)(((int64_t)s + hash_shift(pid, spp, salt)) % spp);
  u1 = ((float)(j % (unsigned)gx) + u1) * inv_gx;
  u2 = ((float)(j / (unsigned)gx) + u2) * inv_gy;
}
