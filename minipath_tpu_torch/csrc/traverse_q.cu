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
// What bounds it on an H100: as K1 and K2 (csrc/traverse.cu), divergent
// loads of node and triangle rows, which neighbouring threads take from
// different places, so that load slots and cache bandwidth run short
// beside latency. The layout requests fewer bytes a step: a node row is 128 B
// (u16 child boxes and links) and its frame row 32 B against 192 + 32 B, and a
// lean leaf visit reads the 144 B of vertex words of a 256 B triangle row
// against 288 B. The price is the dequantization: 12 multiply-adds per child
// box, 18 per triangle lane, each rounded twice.
//
// Design. A stack entry is (link, t_entry), 8 bytes, as K1's and K2's
// (traverse_common.cuh): the box a pop needs is not carried on the stack but
// read where it lives. An inner node's own decompressed box, the frame its
// children's u16 boxes decompress against, is its node_frame row, read beside
// the node row (two loads that do not wait for each other); a leaf's box, the
// frame of its triangles, rides as float bits in words 58..63 of its packets'
// rows and arrives with the first of them. Both are derived once, at scene
// preparation, with the very float32 steps below (render/kernels_q.py); a BVH
// is a tree, so a node's box is a function of the node alone. The hit children
// are sorted by insertion straight into the stack, and the nearest goes on in
// registers without a round trip through the stack. Per ray the rules are
// K1's: slab test with 1/d clamped to +-1e30, hit children pushed far-first
// (stable), prune at pop, two-sided Moller-Trumbore with a strict t < best.t,
// lanes in order; any-hit stops after the first 8-triangle packet with a hit
// under t_max. The TPU kernel's octant child order and its missing pop
// re-prune exist for a 2048-lane shared stack and are not carried over. Rows
// are read through the read-only cache as int4: a node row as 8, a triangle
// row as 16, of which a lean leaf visit reads the first 9 (in two halves, to
// bound the registers that hold them) and, once a leaf, the last 2.
//
// Rows (16-byte aligned):
//   node_q (N, 32) i32: child c's box at words 3c..3c+2 as u16 pairs
//          (minx|miny, minz|maxx, maxy|maxz); links at words 24..31
//   tri_q  (M, 64) i32: 72 u16 vertex coordinates at words 0..35 (lane l,
//          value k at 9l+k), 8 u16 materials at 36..39, 72 i8 normal
//          components at 40..57 (same order as the vertices), the leaf's own
//          box as 6 f32 at 58..63
//   node_frame (N, 8) f32: the node's own box (min xyz, max xyz), 2 of padding
// Rays: (B, 9, P) f32 rows o, d, inv_d.
//
// The decompression is written as scale = (max - min) * (1/65535), then
// min + q * scale, and the library is built with -fmad=false: the quantizer's
// containment fix-up proves that the decompressed child box holds the exact
// child box for exactly these separately rounded steps, and the plain version
// takes the same steps, so both give the same bits.

#include "traverse_common.cuh"

#define MP_INV_U16 0x1.0001p-16f   // float32(1 / 65535)
#define MP_INV_127 0x1.020408p-7f  // float32(1 / 127)

namespace {

struct TraceArgsQ {
  const int4* node_q;     // 8 int4 a row
  const int4* tri_q;      // 16 int4 a row
  const float4* node_frame;  // 2 float4 a row: the node's own box
  int root;
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

// The low and the high u16 of a word as float, without an integer-to-float
// conversion: the 16 bits placed under the exponent of 2^23 are the float
// 2^23 + q exactly, and the subtraction of 2^23 is exact too.
__device__ __forceinline__ float lo16(int w) {
  return __uint_as_float(__byte_perm((unsigned)w, 0x4B000000u, 0x7610)) - 8388608.f;
}
__device__ __forceinline__ float hi16(int w) {
  return __uint_as_float(__byte_perm((unsigned)w, 0x4B000000u, 0x7632)) - 8388608.f;
}

// Byte k (0..3) of w, sign-extended: (w << (24 - 8k)) >> 24 on int32.
__device__ __forceinline__ float i8f(int w, int k) {
  return (float)((int)((unsigned)w << (24 - 8 * k)) >> 24);
}

template <bool LEAN, bool ANYHIT>
__global__ void __launch_bounds__(MP_BLOCK, MP_MIN_BLOCKS) traverse_q_kernel(const TraceArgsQ a) {
  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = ray < a.n_rays;
  const int64_t b = valid ? ray / a.P : 0;
  const int P = a.P;

  MpBest best{a.t_max, 0.f, 0.f, -1};
  int ovf = 0, ivis = 0, ltst = 0;

  if (valid) {
    const float* r = a.rays9 + b * 9 * P + (ray - b * P);
    const float ox = __ldg(r), oy = __ldg(r + P), oz = __ldg(r + 2 * P);
    const float dx = __ldg(r + 3 * P), dy = __ldg(r + 4 * P), dz = __ldg(r + 5 * P);
    const float ix = fminf(fmaxf(__ldg(r + 6 * P), -1e30f), 1e30f);
    const float iy = fminf(fmaxf(__ldg(r + 7 * P), -1e30f), 1e30f);
    const float iz = fminf(fmaxf(__ldg(r + 8 * P), -1e30f), 1e30f);
    const bool live = a.live_packets ? b < (int64_t)__ldg(a.live_packets) : true;

    // Entry = {link (as float bits), t_entry}: one 8-byte local access.
    float2 stack[MP_STACK_CAPACITY];
    int sp = 0;
    // The entry being visited lives in registers. The root enters with
    // t_entry 0, under the pop's prune test.
    int cur = a.root;
    bool have = a.root != MP_NULL_LINK && live && !(0.f > best.t);

    while (have) {
      // Inner nodes first: the ray walks on while its entry is an inner node,
      // so that a warp's rays meet at the leaf part below.
      while (have && (cur & MP_COUNT_MASK) == 0) {
        ++ivis;
        const int idx = cur >> MP_COUNT_BITS;
        // The node's own box, the frame of its children's u16 boxes: two
        // loads that do not wait for the row's.
        const float4* frame = a.node_frame + (int64_t)idx * 2;
        const float4 fa = __ldg(frame), fb = __ldg(frame + 1);
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
        const float bminx = fa.x, bminy = fa.y, bminz = fa.z;
        const float msx = (fa.w - bminx) * MP_INV_U16;
        const float msy = (fb.x - bminy) * MP_INV_U16;
        const float msz = (fb.y - bminz) * MP_INV_U16;
        // The hit children go to the stack as their slab tests finish.
        MpChildren ch = mp_children(sp, a.stack_size);
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
          const float t2 = fminf(fminf(fmaxf(tx0, tx1), best.t),
                                 fminf(fmaxf(ty0, ty1), fmaxf(tz0, tz1)));
          if (t1 <= t2 && links[c] != MP_NULL_LINK) mp_hit_child(stack + sp, ch, t1, links[c], ovf);
        }
        have = mp_children_done(stack, sp, ch, best.t, cur, ovf);
      }
      if (!have) break;

      // The leaf: its packets of 8 triangles, in order.
      {
        const int count = cur & MP_COUNT_MASK;
        const int idx = cur >> MP_COUNT_BITS;
        ltst += count;
        // The leaf's own box, the frame of its triangles' u16 vertices, rides
        // in words 58..63 of its packets' rows (as float bits).
        const int4* first = a.tri_q + (int64_t)idx * 16;
        const int4 fa = __ldg(first + 14), fb = __ldg(first + 15);
        const float bminx = __int_as_float(fa.z), bminy = __int_as_float(fa.w), bminz = __int_as_float(fb.x);
        const float lsx = (__int_as_float(fb.y) - bminx) * MP_INV_U16;
        const float lsy = (__int_as_float(fb.z) - bminy) * MP_INV_U16;
        const float lsz = (__int_as_float(fb.w) - bminz) * MP_INV_U16;
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
              mp_test_triangle(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
                               pk * 8 + lane, best);
            }
          }
          if (ANYHIT && best.tri >= 0) break;
        }
        // Occlusion: the first packet with a hit ends the ray's traversal.
        if (ANYHIT && best.tri >= 0) break;
        have = mp_pop(stack, sp, best.t, cur);
      }
    }

    a.t_out[ray] = best.t;
    a.tri_out[ray] = best.tri;
    if (LEAN) {
      a.u_out[ray] = best.u;
      a.v_out[ray] = best.v;
    } else {
      // Shading normal of the winning hit from its i8 vertex normals,
      // interpolated once from (u, v), and its u16 material.
      float nx = 0.f, ny = 0.f, nz = 0.f;
      int mat = 0;
      if (best.tri >= 0) {
        const int pk = best.tri >> 3, lane = best.tri & 7;
        const int* words = reinterpret_cast<const int*>(a.tri_q + (int64_t)pk * 16);
        float n[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int byte = 9 * lane + k;
          n[k] = i8f(__ldg(words + 40 + (byte >> 2)), byte & 3) * MP_INV_127;
        }
        const float ix_ = n[0] + best.u * (n[3] - n[0]) + best.v * (n[6] - n[0]);
        const float iy_ = n[1] + best.u * (n[4] - n[1]) + best.v * (n[7] - n[1]);
        const float iz_ = n[2] + best.u * (n[5] - n[2]) + best.v * (n[8] - n[2]);
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
// lean any-hit, as mode 1. `node_frame` is (N, 8) f32, a row for each row of
// `node_q`; `live_packets` is one i32 in device memory or null. Launches on `stream`
// and returns the launch's cudaError_t (0 on success). `counters` is (B, 3)
// i32, zeroed by the caller.
int mp_trace_packets_q(const void* node_q, const void* tri_q, const void* node_frame, int root,
                       const void* live_packets,
                       const void* rays9, int64_t n_rays, int P, int stack_size,
                       float t_max, int mode, void* t_out, void* tri_out,
                       void* out_a, void* out_b, void* mat_out, void* counters,
                       void* stream) {
  TraceArgsQ a{};
  a.node_q = (const int4*)node_q;
  a.tri_q = (const int4*)tri_q;
  a.node_frame = (const float4*)node_frame;
  a.root = root;
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
