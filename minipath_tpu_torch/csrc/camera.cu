// The camera rays of a batch of pixel packets, one thread per ray, written
// straight into the (B, 9, P) rows (origin, direction, inverse direction)
// that the traversal kernels read. It replaces no TPU kernel: the JAX package
// leaves ray generation to XLA, which fuses it on the TPU. On the card the
// plain chain (camera.py::sample_rays with render/stratify.py, then
// render/kernels.py::rays_to_rays9) is a few dozen elementwise kernels over
// whole (B, P) tensors, int64 hashes and pixel ids among them, and a
// concatenation and a transpose copy at the end; here each ray reads its
// four uniforms and writes its nine floats once.
//
// What bounds it on an H100: bytes. A ray reads 16 B of uniforms (none in
// Sobol mode) and writes 36 B; its ~150 integer and float operations (two
// hashes a dimension pair, a square root, a sine and a cosine, a
// normalisation, three reciprocals) take a fraction of the time those bytes
// take at 3.35 TB/s. Neighbouring threads take neighbouring lanes of a packet,
// so every row is written, and the uniforms read, in whole sectors.
//
// Lane p of packet b is sample s0 + p / bp of the pixel origin[b] + (q % bw,
// q / bw), q = p % bp: the packets are bh x bw pixel blocks repeated for each
// sample, sample-major, as render/integrator.py::tile_batch_rays and
// render/frame.py::gen_rays9_blocks lay them out. The pixel id of the strata
// is (y * row_stride + (x & x_mask)) ^ strat_seed in uint32: film_strat's
// (y << 14) | (x & 0x3FFF) for the tile path, y * (wc * bw) + x for frame
// blocks.
//
// Every floating-point step is the plain chain's, in its order, rounded as
// PyTorch's CUDA kernels round it: a product with a Python scalar is one with
// its float32 rounding, the squared norm sums (x, z) first and y after (the
// order of torch.sum's reduction over three elements), the direction is
// divided by the norm, and 1 / d is an IEEE division. sinf, cosf and sqrtf are
// the accurate ones. The library is built with -fmad=false, so nothing fuses.

#include <cstdint>
#include <cuda_runtime.h>

#include "strata.cuh"

#define MP_CAMERA_BLOCK 256

namespace {

// float32(2 * pi), as PyTorch rounds the plain chain's Python double.
constexpr float TWO_PI = 0x1.921fb6p+2f;

struct CameraArgs {
  int64_t n;         // B * P rays
  int lanes;         // P: rays of a packet
  int block_pixels;  // bp: pixels of a packet's block
  int block_width;   // bw
  const int* origin;  // (B, 2): each packet's first pixel, (x, y)
  int s0;             // the sample index of a packet's first lane
  unsigned row_stride;
  unsigned x_mask;
  // Strata.
  int strat_mode;
  int spp;  // strata of a pixel (jitter mode)
  int gx;
  float inv_gx;
  float inv_gy;
  unsigned strat_seed;
  unsigned salt;  // the film's; the lens takes salt + 1
  // The uniforms, (B, P, 2) each; null in Sobol mode.
  const float* u_film;
  const float* u_lens;
  // camera.py::CameraSampler, float32 in device memory: (3,) each, then
  // three scalars.
  const float* center;
  const float* up;
  const float* right;
  const float* film_origin_offset;
  const float* pixel_scale;
  const float* lens_radius;
  const float* lens_weight;
  float* rays9;  // (B, 9, P), contiguous
};

__global__ void __launch_bounds__(MP_CAMERA_BLOCK) camera_kernel(const CameraArgs a) {
  const int64_t i = (int64_t)blockIdx.x * MP_CAMERA_BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const int64_t b = i / a.lanes;
  const int p = (int)(i - b * a.lanes);
  const int q = p % a.block_pixels;
  const int s = a.s0 + p / a.block_pixels;
  const int x = a.origin[2 * b] + q % a.block_width;
  const int y = a.origin[2 * b + 1] + q / a.block_width;

  float j0 = 0.0f, j1 = 0.0f, u0 = 0.0f, u1 = 0.0f;
  if (a.strat_mode != STRAT_SOBOL) {
    const float2 f = reinterpret_cast<const float2*>(a.u_film)[i];
    const float2 l = reinterpret_cast<const float2*>(a.u_lens)[i];
    j0 = f.x, j1 = f.y, u0 = l.x, u1 = l.y;
  }
  if (a.strat_mode != STRAT_NONE) {
    const int pid = (int)(((unsigned)y * a.row_stride + ((unsigned)x & a.x_mask)) ^ a.strat_seed);
    stratify2d(a.strat_mode, a.spp, a.gx, a.inv_gx, a.inv_gy, s, pid, j0, j1, a.salt);
    stratify2d(a.strat_mode, a.spp, a.gx, a.inv_gx, a.inv_gy, s, pid, u0, u1, a.salt + 1);
  }
  // The film point, jittered by +-0.5 px.
  const float film_u = (float)x + (j0 - 0.5f);
  const float film_v = (float)y + (j1 - 0.5f);
  // The lens: a uniform point on the disc, polar.
  const float r = sqrtf(u0);
  const float theta = TWO_PI * u1;
  const float lens_u = r * cosf(theta);
  const float lens_v = r * sinf(theta);

  const float fu = film_u * *a.pixel_scale, fv = film_v * *a.pixel_scale;
  const float lu = *a.lens_radius * lens_u, lv = *a.lens_radius * lens_v;
  const float lw = *a.lens_weight;
  float o[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float film_point = (a.film_origin_offset[c] + a.up[c] * fv) - a.right[c] * fu;
    const float lens_vector = a.right[c] * lu + a.up[c] * lv;
    d[c] = lens_vector * lw - film_point;
    o[c] = a.center[c] + lens_vector;
  }
  // geometry/ray.py::make_rays.
  const float norm = sqrtf((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1]);
  float* row = a.rays9 + b * 9 * a.lanes + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dn = d[c] / norm;
    row[c * a.lanes] = o[c];
    row[(3 + c) * a.lanes] = dn;
    row[(6 + c) * a.lanes] = dn == 0.0f ? INFINITY : 1.0f / dn;
  }
}

}  // namespace

extern "C" {

const char* mp_camera_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int mp_camera_args_size() { return (int)sizeof(CameraArgs); }

// The camera rays of `args->n` lanes on `stream`. Returns the launch's
// cudaError_t (0 on success). The arguments are read on the host, at the
// launch.
int mp_camera_rays(const void* args, void* stream) {
  const CameraArgs& a = *(const CameraArgs*)args;
  if (a.n == 0) return 0;
  if (a.lanes < 1 || a.block_pixels < 1 || a.block_width < 1 || a.lanes % a.block_pixels ||
      a.block_pixels % a.block_width || (a.strat_mode != STRAT_SOBOL && (!a.u_film || !a.u_lens)) ||
      (a.strat_mode == STRAT_JITTER && (a.spp < 1 || a.gx < 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (a.n + MP_CAMERA_BLOCK - 1) / MP_CAMERA_BLOCK;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  camera_kernel<<<(unsigned)blocks, MP_CAMERA_BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
