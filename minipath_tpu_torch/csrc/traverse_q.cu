// K3: traversal of the 8-wide BVH over the hierarchical 16-bit quantized
// layout, one thread per ray. Port of
// minipath_tpu/render/pallas_kernels.py::_traverse_kernel_q (wrapper
// trace_packets_pallas_q). One loop, three instances:
//   full closest-hit: t, tri, the interpolated i8 shading normal and the u16
//     material (K1's contract);
//   lean closest-hit: t, tri, u, v (K2's contract; shading is the caller's);
//   lean any-hit: the occlusion trace.
// The Python wrapper, the plain PyTorch version and the dispatch by scene
// type are in minipath_tpu_torch/render/kernels_q.py; the quantizer is
// minipath_tpu_torch/scene/bvh/quantize.py.
//
// What bounds it on an H100: as K1 and K2 (csrc/traverse.cu), divergent,
// latency-bound loads of node and triangle rows, which neighbouring threads
// take from different places. The layout reads fewer bytes a step: a node row
// is 128 B (u16 child boxes and links) against 192 + 32 B, and a lean leaf
// visit reads the 144 B of vertex words of a 256 B triangle row against 320 B.
// The price is the dequantization: 12 multiply-adds per child box, 18 per
// triangle lane, each rounded twice.
//
// Design. Each stack entry is (link, t_entry, its decompressed box): eight
// words, two float4s of local memory. The box is what the pop needs: an inner
// node's box is the frame its children's u16 boxes decompress against, and a
// leaf's box is the frame of its triangles. The root's entry takes the stored
// scene box. Per ray the rules are K1's: slab test with 1/d clamped to
// +-1e30, hit children sorted by entry distance and pushed far-first (stable),
// prune at pop, two-sided Moller-Trumbore with a strict t < best_t, lanes in
// order; any-hit stops after the first 8-triangle packet with a hit under
// t_max. The TPU kernel's octant child order and its missing pop re-prune
// exist for a 2048-lane shared stack and are not carried over. Rows are read
// through the read-only cache as int4: a node row as 8, a triangle row as 16,
// of which a lean leaf visit reads the first 9 (in two halves, to bound the
// registers that hold them).
//
// Rows (16-byte aligned):
//   node_q (N, 32) i32: child c's box at words 3c..3c+2 as u16 pairs
//          (minx|miny, minz|maxx, maxy|maxz); links at words 24..31
//   tri_q  (M, 64) i32: 72 u16 vertex coordinates at words 0..35 (lane l,
//          value k at 9l+k), 8 u16 materials at 36..39, 72 i8 normal
//          components at 40..57 (same order as the vertices)
// Rays: (B, 9, P) f32 rows o, d, inv_d.
//
// The decompression is written as scale = (max - min) * (1/65535), then
// min + q * scale, and the library is built with -fmad=false: the quantizer's
// containment fix-up proves that the decompressed child box holds the exact
// child box for exactly these separately rounded steps, and the plain version
// takes the same steps, so both give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define MP_STACK_CAPACITY 128
#define MP_NULL_LINK (-8)
#define MP_COUNT_BITS 3
#define MP_COUNT_MASK 7
#define MP_BLOCK 128
#define MP_INV_U16 0x1.0001p-16f   // float32(1 / 65535)
#define MP_INV_127 0x1.020408p-7f  // float32(1 / 127)

namespace {

struct TraceArgsQ {
  const int4* node_q;     // 8 int4 a row
  const int4* tri_q;      // 16 int4 a row
  int root;
  const float* root_box;  // (6,) f32: the root entry's frame
  // Live packets as one i32 in device memory, or null (every packet live).
  const int* live_packets;
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

__device__ __forceinline__ float lo16(int w) { return (float)(w & 0xFFFF); }
__device__ __forceinline__ float hi16(int w) { return (float)((w >> 16) & 0xFFFF); }

// Byte k (0..3) of w, sign-extended: (w << (24 - 8k)) >> 24 on int32.
__device__ __forceinline__ float i8f(int w, int k) {
  return (float)((int)((unsigned)w << (24 - 8 * k)) >> 24);
}

template <bool LEAN, bool ANYHIT>
__global__ void __launch_bounds__(MP_BLOCK) traverse_q_kernel(const TraceArgsQ a) {
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
    const float ix = fminf(fmaxf(__ldg(r + 6 * P), -1e30f), 1e30f);
    const float iy = fminf(fmaxf(__ldg(r + 7 * P), -1e30f), 1e30f);
    const float iz = fminf(fmaxf(__ldg(r + 8 * P), -1e30f), 1e30f);
    const bool live = a.live_packets ? b < (int64_t)__ldg(a.live_packets) : true;

    // Entry = {link (as float bits), t_entry, min x, min y} {min z, max x, max y, max z}.
    float4 stack[MP_STACK_CAPACITY][2];
    int sp = 0;
    if (a.root != MP_NULL_LINK && live) {
      stack[0][0] = make_float4(__int_as_float(a.root), 0.f, __ldg(a.root_box), __ldg(a.root_box + 1));
      stack[0][1] = make_float4(__ldg(a.root_box + 2), __ldg(a.root_box + 3), __ldg(a.root_box + 4),
                                __ldg(a.root_box + 5));
      sp = 1;
    }

    while (sp > 0) {
      --sp;
      const float4 e0 = stack[sp][0];
      // Occlusion prune at pop: the subtree starts beyond this ray's best.
      if (e0.y > best_t) continue;
      const float4 e1 = stack[sp][1];
      const int link = __float_as_int(e0.x);
      const float bminx = e0.z, bminy = e0.w, bminz = e1.x;
      const float bmaxx = e1.y, bmaxy = e1.z, bmaxz = e1.w;
      const int count = link & MP_COUNT_MASK;
      const int idx = link >> MP_COUNT_BITS;

      if (count == 0) {
        ++ivis;
        const int4* row = a.node_q + (int64_t)idx * 8;
        int w[24];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int4 v = __ldg(row + i);
          w[4 * i] = v.x;
          w[4 * i + 1] = v.y;
          w[4 * i + 2] = v.z;
          w[4 * i + 3] = v.w;
        }
        const int4 la = __ldg(row + 6), lb = __ldg(row + 7);
        const int links[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
        const float msx = (bmaxx - bminx) * MP_INV_U16;
        const float msy = (bmaxy - bminy) * MP_INV_U16;
        const float msz = (bmaxz - bminz) * MP_INV_U16;
        // Hit children, sorted by entry distance, farthest first (stable
        // for ties), so that the nearest is pushed last and pops first.
        int hit_c[8];
        float hit_t[8];
        int n_hit = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float cminx = bminx + lo16(w[3 * c]) * msx;
          const float cminy = bminy + hi16(w[3 * c]) * msy;
          const float cminz = bminz + lo16(w[3 * c + 1]) * msz;
          const float cmaxx = bminx + hi16(w[3 * c + 1]) * msx;
          const float cmaxy = bminy + lo16(w[3 * c + 2]) * msy;
          const float cmaxz = bminz + hi16(w[3 * c + 2]) * msz;
          const float tx0 = (cminx - ox) * ix, tx1 = (cmaxx - ox) * ix;
          const float ty0 = (cminy - oy) * iy, ty1 = (cmaxy - oy) * iy;
          const float tz0 = (cminz - oz) * iz, tz1 = (cmaxz - oz) * iz;
          const float t1 = fmaxf(fmaxf(fminf(tx0, tx1), 0.f),
                                 fmaxf(fminf(ty0, ty1), fminf(tz0, tz1)));
          const float t2 = fminf(fminf(fmaxf(tx0, tx1), best_t),
                                 fminf(fmaxf(ty0, ty1), fmaxf(tz0, tz1)));
          if (t1 <= t2 && links[c] != MP_NULL_LINK) {
            int j = n_hit++;
            while (j > 0 && hit_t[j - 1] < t1) {
              hit_t[j] = hit_t[j - 1];
              hit_c[j] = hit_c[j - 1];
              --j;
            }
            hit_t[j] = t1;
            hit_c[j] = c;
          }
        }
        const int* words = reinterpret_cast<const int*>(row);
        for (int k = 0; k < n_hit; ++k) {
          // Bounded push: an entry that does not fit is dropped and counted.
          if (sp < a.stack_size) {
            // The child's box again, from the row's words (an L1 hit), with
            // the same steps as in the slab test: the same bits.
            const int c = hit_c[k];
            const int w0 = __ldg(words + 3 * c), w1 = __ldg(words + 3 * c + 1),
                      w2 = __ldg(words + 3 * c + 2);
            stack[sp][0] = make_float4(__int_as_float(__ldg(words + 24 + c)), hit_t[k],
                                       bminx + lo16(w0) * msx, bminy + hi16(w0) * msy);
            stack[sp][1] = make_float4(bminz + lo16(w1) * msz, bminx + hi16(w1) * msx,
                                       bminy + lo16(w2) * msy, bminz + hi16(w2) * msz);
            ++sp;
          } else {
            ++ovf;
          }
        }
      } else {
        ltst += count;
        // The leaf's triangles are u16 fractions of the leaf's own box.
        const float lsx = (bmaxx - bminx) * MP_INV_U16;
        const float lsy = (bmaxy - bminy) * MP_INV_U16;
        const float lsz = (bmaxz - bminz) * MP_INV_U16;
        for (int j = 0; j < count; ++j) {
          const int pk = idx + j;
          const int4* row = a.tri_q + (int64_t)pk * 16;
          // Lanes 0-3 read words 0..19 (int4 0..4), lanes 4-7 words 16..35
          // (int4 4..8).
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            int w[20];
#pragma unroll
            for (int i = 0; i < 5; ++i) {
              const int4 v = __ldg(row + 4 * half + i);
              w[4 * i] = v.x;
              w[4 * i + 1] = v.y;
              w[4 * i + 2] = v.z;
              w[4 * i + 3] = v.w;
            }
            const int base = 16 * half;
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              const int lane = 4 * half + l;
              const int u0 = 9 * lane;
#define MP_COORD(k) ((((u0 + (k)) & 1) ? hi16(w[((u0 + (k)) >> 1) - base]) : lo16(w[((u0 + (k)) >> 1) - base])))
              const float v0x = bminx + MP_COORD(0) * lsx;
              const float v0y = bminy + MP_COORD(1) * lsy;
              const float v0z = bminz + MP_COORD(2) * lsz;
              const float e1x = bminx + MP_COORD(3) * lsx - v0x;
              const float e1y = bminy + MP_COORD(4) * lsy - v0y;
              const float e1z = bminz + MP_COORD(5) * lsz - v0z;
              const float e2x = bminx + MP_COORD(6) * lsx - v0x;
              const float e2y = bminy + MP_COORD(7) * lsy - v0y;
              const float e2z = bminz + MP_COORD(8) * lsz - v0z;
#undef MP_COORD
              // Two-sided Moller-Trumbore, K1's steps.
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
      // Shading normal of the winning hit from its i8 vertex normals,
      // interpolated once from (u, v), and its u16 material.
      float nx = 0.f, ny = 0.f, nz = 0.f;
      int mat = 0;
      if (best_tri >= 0) {
        const int pk = best_tri >> 3, lane = best_tri & 7;
        const int* words = reinterpret_cast<const int*>(a.tri_q + (int64_t)pk * 16);
        float n[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int byte = 9 * lane + k;
          n[k] = i8f(__ldg(words + 40 + (byte >> 2)), byte & 3) * MP_INV_127;
        }
        const float ix_ = n[0] + best_u * (n[3] - n[0]) + best_v * (n[6] - n[0]);
        const float iy_ = n[1] + best_u * (n[4] - n[1]) + best_v * (n[7] - n[1]);
        const float iz_ = n[2] + best_u * (n[5] - n[2]) + best_v * (n[8] - n[2]);
        const float inv_len = rsqrtf(fmaxf(ix_ * ix_ + iy_ * iy_ + iz_ * iz_, 1e-30f));
        nx = ix_ * inv_len;
        ny = iy_ * inv_len;
        nz = iz_ * inv_len;
        mat = (__ldg(words + 36 + (lane >> 1)) >> (16 * (lane & 1))) & 0xFFFF;
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
int launch(const TraceArgsQ& a, void* stream) {
  if (a.stack_size < 1 || a.stack_size > MP_STACK_CAPACITY || a.P < 1)
    return (int)cudaErrorInvalidValue;
  if (a.n_rays == 0) return 0;
  const int64_t blocks = (a.n_rays + MP_BLOCK - 1) / MP_BLOCK;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  traverse_q_kernel<LEAN, ANYHIT><<<(unsigned)blocks, MP_BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mp_stack_capacity() { return MP_STACK_CAPACITY; }

const char* mp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K3. mode 0: full closest-hit, out_a = normal (B*P*3 f32), mat_out (B*P
// i32), out_b unused; mode 1: lean closest-hit, out_a = u, out_b = v; mode 2:
// lean any-hit, as mode 1. `root_box` is 6 f32 in device memory;
// `live_packets` is one i32 in device memory or null. Launches on `stream`
// and returns the launch's cudaError_t (0 on success). `counters` is (B, 3)
// i32, zeroed by the caller.
int mp_trace_packets_q(const void* node_q, const void* tri_q, int root,
                       const void* root_box, const void* live_packets,
                       const void* rays9, int64_t n_rays, int P, int stack_size,
                       float t_max, int mode, void* t_out, void* tri_out,
                       void* out_a, void* out_b, void* mat_out, void* counters,
                       void* stream) {
  TraceArgsQ a{};
  a.node_q = (const int4*)node_q;
  a.tri_q = (const int4*)tri_q;
  a.root = root;
  a.root_box = (const float*)root_box;
  a.live_packets = (const int*)live_packets;
  a.rays9 = (const float*)rays9;
  a.n_rays = n_rays;
  a.P = P;
  a.stack_size = stack_size;
  a.t_max = t_max;
  a.t_out = (float*)t_out;
  a.tri_out = (int*)tri_out;
  a.counters = (int*)counters;
  if (mode == 0) {
    a.normal_out = (float*)out_a;
    a.mat_out = (int*)mat_out;
    return launch<false, false>(a, stream);
  }
  a.u_out = (float*)out_a;
  a.v_out = (float*)out_b;
  if (mode == 1) return launch<true, false>(a, stream);
  if (mode == 2) return launch<true, true>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
