// BVH traversal of the 8-wide BVH over the f32 kernel layout, one thread per
// ray. One loop, three instances:
//   full closest-hit (K1): port of minipath_tpu/render/pallas_kernels.py
//     ::_traverse_kernel, with the shading normal and material epilogue;
//   lean closest-hit (K2) and lean any-hit (K2, occlusion): port of
//     pallas_kernels.py::_traverse_kernel_pt, which returns (t, tri, u, v)
//     and leaves shading to the caller.
// The Python wrappers, the plain PyTorch version and the design note are in
// minipath_tpu_torch/render/kernels.py.
//
// Scene rows (all 16-byte aligned, read through the read-only cache):
//   node_box   (N, 48) f32: child c at [6c, 6c+6) = min xyz, max xyz
//   node_links (N, 8)  i32: encoded child links (scene/bvh/links.py)
//   tri_data   (M, 80) f32: lane l at [9l, 9l+9) = v0, e1, e2; [72+l] = material
//   tri_shade  (M, 72) f32: lane l at [9l, 9l+9) = vertex normals n0, n1, n2
//              (full mode only)
// Rays: (B, 9, P) f32 rows o, d, inv_d, so neighbouring threads load
// neighbouring words.
//
// Every floating-point step is written in the same order as the plain
// version, and the library is built with -fmad=false, so both give the same
// bits for t, tri, u and v.

#include <cuda_runtime.h>
#include <stdint.h>

#define MP_STACK_CAPACITY 128
#define MP_NULL_LINK (-8)
#define MP_COUNT_BITS 3
#define MP_COUNT_MASK 7
#define MP_BLOCK 128

namespace {

struct TraceArgs {
  const float* node_box;
  const int* node_links;
  const float* tri_data;
  const float* tri_shade;  // full mode only
  int root;                // used where `roots` is null
  const int* roots;        // (B,) per-packet roots, or null
  // Live packets as one i32 in device memory (read by the kernel, so the
  // caller needs no host sync), or null: then `live_rays` is the bound.
  const int* live_packets;
  int64_t live_rays;
  const float* rays9;
  int64_t n_rays;
  int P;
  int stack_size;
  float t_max;
  float* t_out;
  int* tri_out;
  float* normal_out;  // full mode
  int* mat_out;       // full mode
  float* u_out;       // lean mode
  float* v_out;       // lean mode
  int* counters;      // (B, 3) i32, zeroed by the caller
};

// LEAN: write (u, v) instead of the shading normal and material.
// ANYHIT: a ray stops after the first 8-triangle packet in which it has a
// hit with 0 <= t < t_max; only `tri >= 0` then carries meaning.
template <bool LEAN, bool ANYHIT>
__global__ void __launch_bounds__(MP_BLOCK) traverse_kernel(const TraceArgs a) {
  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = ray < a.n_rays;
  const int64_t b = valid ? ray / a.P : 0;
  const int P = a.P;

  float best_t = a.t_max, best_u = 0.f, best_v = 0.f;
  int best_tri = -1;
  int ovf = 0, ivis = 0, ltst = 0;

  if (valid) {
    const float* r = a.rays9 + b * 9 * P + (ray - b * P);
    const float ox = __ldg(r), oy = __ldg(r + P), oz = __ldg(r + 2 * P);
    const float dx = __ldg(r + 3 * P), dy = __ldg(r + 4 * P), dz = __ldg(r + 5 * P);
    // 1/d clamped to +-1e30: rays carry +inf for a zero component, and the
    // clamp keeps 0 * inf = NaN out of the slab test.
    const float ix = fminf(fmaxf(__ldg(r + 6 * P), -1e30f), 1e30f);
    const float iy = fminf(fmaxf(__ldg(r + 7 * P), -1e30f), 1e30f);
    const float iz = fminf(fmaxf(__ldg(r + 8 * P), -1e30f), 1e30f);

    const int root = a.roots ? __ldg(a.roots + b) : a.root;
    const bool live = a.live_packets ? b < (int64_t)__ldg(a.live_packets) : ray < a.live_rays;

    int stack_link[MP_STACK_CAPACITY];
    float stack_t[MP_STACK_CAPACITY];
    int sp = 0;
    if (root != MP_NULL_LINK && live) {
      stack_link[0] = root;
      stack_t[0] = 0.f;
      sp = 1;
    }

    while (sp > 0) {
      --sp;
      const int link = stack_link[sp];
      // Occlusion prune at pop: the subtree starts beyond this ray's best.
      if (stack_t[sp] > best_t) continue;
      const int count = link & MP_COUNT_MASK;
      const int idx = link >> MP_COUNT_BITS;

      if (count == 0) {
        ++ivis;
        const float2* box = reinterpret_cast<const float2*>(a.node_box + (int64_t)idx * 48);
        const int4* lk = reinterpret_cast<const int4*>(a.node_links + (int64_t)idx * 8);
        const int4 la = __ldg(lk), lb = __ldg(lk + 1);
        const int links[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
        // Hit children, sorted by entry distance, farthest first (stable
        // for ties), so that the nearest is pushed last and pops first.
        int hit_link[8];
        float hit_t[8];
        int n_hit = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 p0 = __ldg(box + 3 * c), p1 = __ldg(box + 3 * c + 1),
                       p2 = __ldg(box + 3 * c + 2);
          const float tx0 = (p0.x - ox) * ix, tx1 = (p1.y - ox) * ix;
          const float ty0 = (p0.y - oy) * iy, ty1 = (p2.x - oy) * iy;
          const float tz0 = (p1.x - oz) * iz, tz1 = (p2.y - oz) * iz;
          const float t1 = fmaxf(fmaxf(fminf(tx0, tx1), 0.f),
                                 fmaxf(fminf(ty0, ty1), fminf(tz0, tz1)));
          const float t2 = fminf(fminf(fmaxf(tx0, tx1), best_t),
                                 fminf(fmaxf(ty0, ty1), fmaxf(tz0, tz1)));
          if (t1 <= t2 && links[c] != MP_NULL_LINK) {
            int j = n_hit++;
            while (j > 0 && hit_t[j - 1] < t1) {
              hit_t[j] = hit_t[j - 1];
              hit_link[j] = hit_link[j - 1];
              --j;
            }
            hit_t[j] = t1;
            hit_link[j] = links[c];
          }
        }
        for (int k = 0; k < n_hit; ++k) {
          // Bounded push: an entry that does not fit is dropped and counted.
          if (sp < a.stack_size) {
            stack_link[sp] = hit_link[k];
            stack_t[sp] = hit_t[k];
            ++sp;
          } else {
            ++ovf;
          }
        }
      } else {
        ltst += count;
        for (int j = 0; j < count; ++j) {
          const int pk = idx + j;
          const float* row = a.tri_data + (int64_t)pk * 80;
#pragma unroll 2
          for (int lane = 0; lane < 8; ++lane) {
            const float* tr = row + 9 * lane;
            const float v0x = __ldg(tr), v0y = __ldg(tr + 1), v0z = __ldg(tr + 2);
            const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4), e1z = __ldg(tr + 5);
            const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7), e2z = __ldg(tr + 8);
            // Two-sided Moller-Trumbore.
            const float px = dy * e2z - dz * e2y;
            const float py = dz * e2x - dx * e2z;
            const float pz = dx * e2y - dy * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const float inv_det = 1.0f / det;
            const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
            const float u = inv_det * (sx * px + sy * py + sz * pz);
            const float qx = sy * e1z - sz * e1y;
            const float qy = sz * e1x - sx * e1z;
            const float qz = sx * e1y - sy * e1x;
            const float v = inv_det * (dx * qx + dy * qy + dz * qz);
            const float t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
            if (u >= 0.f && v >= 0.f && u + v <= 1.f && t >= 0.f && t < best_t) {
              best_t = t;
              best_tri = pk * 8 + lane;
              best_u = u;
              best_v = v;
            }
          }
          if (ANYHIT && best_tri >= 0) break;
        }
        // Occlusion: the first packet with a hit ends the ray's traversal.
        if (ANYHIT && best_tri >= 0) sp = 0;
      }
    }

    a.t_out[ray] = best_t;
    a.tri_out[ray] = best_tri;
    if (LEAN) {
      a.u_out[ray] = best_u;
      a.v_out[ray] = best_v;
    } else {
      // Shading normal of the winning hit, interpolated once from its
      // (u, v): the value the TPU kernel carries through every accepted hit.
      float nx = 0.f, ny = 0.f, nz = 0.f;
      int mat = 0;
      if (best_tri >= 0) {
        const int pk = best_tri >> 3, lane = best_tri & 7;
        const float* sh = a.tri_shade + (int64_t)pk * 72 + 9 * lane;
        const float n0x = __ldg(sh), n0y = __ldg(sh + 1), n0z = __ldg(sh + 2);
        const float n1x = __ldg(sh + 3), n1y = __ldg(sh + 4), n1z = __ldg(sh + 5);
        const float n2x = __ldg(sh + 6), n2y = __ldg(sh + 7), n2z = __ldg(sh + 8);
        const float ix_ = n0x + best_u * (n1x - n0x) + best_v * (n2x - n0x);
        const float iy_ = n0y + best_u * (n1y - n0y) + best_v * (n2y - n0y);
        const float iz_ = n0z + best_u * (n1z - n0z) + best_v * (n2z - n0z);
        const float inv_len = rsqrtf(fmaxf(ix_ * ix_ + iy_ * iy_ + iz_ * iz_, 1e-30f));
        nx = ix_ * inv_len;
        ny = iy_ * inv_len;
        nz = iz_ * inv_len;
        mat = (int)__ldg(a.tri_data + (int64_t)pk * 80 + 72 + lane);
      }
      a.normal_out[3 * ray] = nx;
      a.normal_out[3 * ray + 1] = ny;
      a.normal_out[3 * ray + 2] = nz;
      a.mat_out[ray] = mat;
    }
  }

  // Per-packet counters (sums over the packet's rays): one atomic per warp
  // where the whole warp lies in one packet, one per thread otherwise.
  const unsigned full = 0xffffffffu;
  const int64_t b0 = __shfl_sync(full, b, 0);
  int* counters = a.counters;
  if (__all_sync(full, valid && b == b0)) {
    for (int off = 16; off > 0; off >>= 1) {
      ovf += __shfl_down_sync(full, ovf, off);
      ivis += __shfl_down_sync(full, ivis, off);
      ltst += __shfl_down_sync(full, ltst, off);
    }
    if ((threadIdx.x & 31) == 0) {
      if (ovf) atomicAdd(counters + 3 * b, ovf);
      atomicAdd(counters + 3 * b + 1, ivis);
      atomicAdd(counters + 3 * b + 2, ltst);
    }
  } else if (valid) {
    if (ovf) atomicAdd(counters + 3 * b, ovf);
    if (ivis) atomicAdd(counters + 3 * b + 1, ivis);
    if (ltst) atomicAdd(counters + 3 * b + 2, ltst);
  }
}

template <bool LEAN, bool ANYHIT>
int launch(const TraceArgs& a, void* stream) {
  if (a.stack_size < 1 || a.stack_size > MP_STACK_CAPACITY || a.P < 1)
    return (int)cudaErrorInvalidValue;
  if (a.n_rays == 0) return 0;
  const int64_t blocks = (a.n_rays + MP_BLOCK - 1) / MP_BLOCK;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  traverse_kernel<LEAN, ANYHIT><<<(unsigned)blocks, MP_BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mp_stack_capacity() { return MP_STACK_CAPACITY; }

const char* mp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1: full closest-hit. Launches on `stream` and returns the launch's
// cudaError_t (0 on success). `counters` is (B, 3) i32, zeroed by the caller.
int mp_trace_packets(const void* node_box, const void* node_links,
                     const void* tri_data, const void* tri_shade, int root,
                     const void* rays9, int64_t n_rays, int64_t live_rays,
                     int P, int stack_size, float t_max, void* t_out,
                     void* tri_out, void* normal_out, void* mat_out,
                     void* counters, void* stream) {
  TraceArgs a{};
  a.node_box = (const float*)node_box;
  a.node_links = (const int*)node_links;
  a.tri_data = (const float*)tri_data;
  a.tri_shade = (const float*)tri_shade;
  a.root = root;
  a.live_rays = live_rays;
  a.rays9 = (const float*)rays9;
  a.n_rays = n_rays;
  a.P = P;
  a.stack_size = stack_size;
  a.t_max = t_max;
  a.t_out = (float*)t_out;
  a.tri_out = (int*)tri_out;
  a.normal_out = (float*)normal_out;
  a.mat_out = (int*)mat_out;
  a.counters = (int*)counters;
  return launch<false, false>(a, stream);
}

// K2: lean closest-hit (anyhit == 0) or any-hit (anyhit != 0). `roots` is
// (B,) i32 or null (then `root` for every packet); `live_packets` is one i32
// in device memory or null (every packet live). Outputs t, tri, u, v are
// (B*P,); `counters` is (B, 3) i32, zeroed by the caller.
int mp_trace_packets_pt(const void* node_box, const void* node_links,
                        const void* tri_data, int root, const void* roots,
                        const void* live_packets, const void* rays9,
                        int64_t n_rays, int P, int stack_size, float t_max,
                        int anyhit, void* t_out, void* tri_out, void* u_out,
                        void* v_out, void* counters, void* stream) {
  TraceArgs a{};
  a.node_box = (const float*)node_box;
  a.node_links = (const int*)node_links;
  a.tri_data = (const float*)tri_data;
  a.root = root;
  a.roots = (const int*)roots;
  a.live_packets = (const int*)live_packets;
  a.live_rays = n_rays;
  a.rays9 = (const float*)rays9;
  a.n_rays = n_rays;
  a.P = P;
  a.stack_size = stack_size;
  a.t_max = t_max;
  a.t_out = (float*)t_out;
  a.tri_out = (int*)tri_out;
  a.u_out = (float*)u_out;
  a.v_out = (float*)v_out;
  a.counters = (int*)counters;
  return anyhit ? launch<true, true>(a, stream) : launch<true, false>(a, stream);
}

}  // extern "C"
