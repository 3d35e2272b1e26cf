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
// What bounds the loop on an H100. A warp's 32 rays read 32 different rows,
// so every load costs the L1 about one pass a thread whatever its
// width, and the bytes the threads request (224 B an inner visit, 288 B a
// packet test) add up to terabytes a second, served by L1 and L2: the loop is
// short of load slots and cache bandwidth as much as of latency. What
// the design does about it:
//   - 16-byte loads: a node's boxes are 12 float4, two children to three of
//     them; a packet's 72 vertex words are 18 float4, taken nine at a time
//     (lanes 0-3, then lanes 4-7) so that the registers they take stay
//     bounded, and unpacked by constant indices;
//   - nothing but the stack in local memory: the hit children are sorted by
//     insertion straight into the stack as their slab tests finish, and the
//     entry being visited (the nearest child, as a rule) stays in registers
//     instead of going through the stack (traverse_common.cuh);
//   - a ray goes on through inner nodes while its entry is one and does its
//     leaf after, so that a warp's rays meet at the leaf part.
// Each ray's sequence of visits is that of the plain version.
//
// Every floating-point step is written in the same order as the plain
// version, and the library is built with -fmad=false, so both give the same
// bits for t, tri, u and v.

#include "traverse_common.cuh"

namespace {

struct TraceArgs {
  const float* node_box;
  const int* node_links;
  const float* tri_data;
  const float* tri_shade;  // full mode only
  int root;                // used where `roots` is null
  const int* roots;        // (B,) per-packet roots, or null
  // Live packets as one i32 in device memory (read by the kernel, so the
  // caller needs no host sync), or null: every packet is live.
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

// LEAN: write (u, v) instead of the shading normal and material.
// ANYHIT: a ray stops after the first 8-triangle packet in which it has a
// hit with 0 <= t < t_max; only `tri >= 0` then carries meaning.
template <bool LEAN, bool ANYHIT>
__global__ void __launch_bounds__(MP_BLOCK, MP_MIN_BLOCKS) traverse_kernel(const TraceArgs a) {
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
    // 1/d clamped to +-1e30: rays carry +inf for a zero component, and the
    // clamp keeps 0 * inf = NaN out of the slab test.
    const float ix = fminf(fmaxf(__ldg(r + 6 * P), -1e30f), 1e30f);
    const float iy = fminf(fmaxf(__ldg(r + 7 * P), -1e30f), 1e30f);
    const float iz = fminf(fmaxf(__ldg(r + 8 * P), -1e30f), 1e30f);

    const int root = a.roots ? __ldg(a.roots + b) : a.root;
    const bool live = !a.live_packets || b < (int64_t)__ldg(a.live_packets);

    // Entry = {link (as float bits), t_entry}: one 8-byte local access.
    float2 stack[MP_STACK_CAPACITY];
    int sp = 0;
    // The entry being visited lives in registers. The root enters with
    // t_entry 0, under the pop's prune test.
    int cur = root;
    bool have = root != MP_NULL_LINK && live && !(0.f > best.t);

    while (have) {
      // Inner nodes first: the ray walks on while its entry is an inner node,
      // so that a warp's rays meet at the leaf part below.
      while (have && (cur & MP_COUNT_MASK) == 0) {
        ++ivis;
        const int idx = cur >> MP_COUNT_BITS;
        const float4* box = reinterpret_cast<const float4*>(a.node_box + (int64_t)idx * 48);
        const int4* lk = reinterpret_cast<const int4*>(a.node_links + (int64_t)idx * 8);
        const int4 la = __ldg(lk), lb = __ldg(lk + 1);
        const int links[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
        // The hit children go to the stack as their slab tests finish. Two
        // children share three float4s of the row.
        MpChildren ch = mp_children(sp, a.stack_size);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float4 f0 = __ldg(box + 3 * p), f1 = __ldg(box + 3 * p + 1), f2 = __ldg(box + 3 * p + 2);
          const float lo[2][3] = {{f0.x, f0.y, f0.z}, {f1.z, f1.w, f2.x}};
          const float hi[2][3] = {{f0.w, f1.x, f1.y}, {f2.y, f2.z, f2.w}};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 2 * p + h;
            const float tx0 = (lo[h][0] - ox) * ix, tx1 = (hi[h][0] - ox) * ix;
            const float ty0 = (lo[h][1] - oy) * iy, ty1 = (hi[h][1] - oy) * iy;
            const float tz0 = (lo[h][2] - oz) * iz, tz1 = (hi[h][2] - oz) * iz;
            const float t1 = fmaxf(fmaxf(fminf(tx0, tx1), 0.f),
                                   fmaxf(fminf(ty0, ty1), fminf(tz0, tz1)));
            const float t2 = fminf(fminf(fmaxf(tx0, tx1), best.t),
                                   fminf(fmaxf(ty0, ty1), fmaxf(tz0, tz1)));
            if (t1 <= t2 && links[c] != MP_NULL_LINK) mp_hit_child(stack + sp, ch, t1, links[c], ovf);
          }
        }
        have = mp_children_done(stack, sp, ch, best.t, cur, ovf);
      }
      if (!have) break;

      // The leaf: its packets of 8 triangles, in order.
      {
        const int count = cur & MP_COUNT_MASK;
        const int idx = cur >> MP_COUNT_BITS;
        ltst += count;
        for (int j = 0; j < count; ++j) {
          const int pk = idx + j;
          const float4* row = reinterpret_cast<const float4*>(a.tri_data + (int64_t)pk * 80);
          // A half of the packet (lanes 0-3: words 0..35, float4 0..8; lanes
          // 4-7: words 36..71, float4 9..17) is taken two lanes at a time, so
          // that 20 registers hold the words in flight: float4 0..4 for the
          // first two lanes, then float4 4 again (kept) and 5..8 for the next
          // two, whose words start at word 2 of these.
#pragma unroll 1
          for (int half = 0; half < 2; ++half) {
            float w[20];
#pragma unroll
            for (int quarter = 0; quarter < 2; ++quarter) {
#pragma unroll
              for (int i = quarter; i < 5; ++i) {
                const float4 f = __ldg(row + 9 * half + 4 * quarter + i);
                w[4 * i] = f.x;
                w[4 * i + 1] = f.y;
                w[4 * i + 2] = f.z;
                w[4 * i + 3] = f.w;
              }
#pragma unroll
              for (int l = 0; l < 2; ++l) {
                const float* tr = w + 2 * quarter + 9 * l;  // v0, e1, e2
                mp_test_triangle(ox, oy, oz, dx, dy, dz, tr[0], tr[1], tr[2], tr[3], tr[4], tr[5], tr[6], tr[7],
                                 tr[8], pk * 8 + 4 * half + 2 * quarter + l, best);
              }
              // The last float4 holds the first two words of the next lanes.
              w[0] = w[16];
              w[1] = w[17];
              w[2] = w[18];
              w[3] = w[19];
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
      // Shading normal of the winning hit, interpolated once from its
      // (u, v): the value the TPU kernel carries through every accepted hit.
      float nx = 0.f, ny = 0.f, nz = 0.f;
      int mat = 0;
      if (best.tri >= 0) {
        const int pk = best.tri >> 3, lane = best.tri & 7;
        const float* sh = a.tri_shade + (int64_t)pk * 72 + 9 * lane;
        const float n0x = __ldg(sh), n0y = __ldg(sh + 1), n0z = __ldg(sh + 2);
        const float n1x = __ldg(sh + 3), n1y = __ldg(sh + 4), n1z = __ldg(sh + 5);
        const float n2x = __ldg(sh + 6), n2y = __ldg(sh + 7), n2z = __ldg(sh + 8);
        const float ix_ = n0x + best.u * (n1x - n0x) + best.v * (n2x - n0x);
        const float iy_ = n0y + best.u * (n1y - n0y) + best.v * (n2y - n0y);
        const float iz_ = n0z + best.u * (n1z - n0z) + best.v * (n2z - n0z);
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

// K1: full closest-hit. `live_packets` is one i32 in device memory or null
// (every packet live), as in K2. Launches on `stream` and returns the
// launch's cudaError_t (0 on success). `counters` is (B, 3) i32, zeroed by
// the caller.
int mp_trace_packets(const void* node_box, const void* node_links,
                     const void* tri_data, const void* tri_shade, int root,
                     const void* live_packets, const void* rays9,
                     int64_t n_rays, int P, int stack_size, float t_max,
                     void* t_out, void* tri_out, void* normal_out,
                     void* mat_out, void* counters, void* stream) {
  TraceArgs a{};
  a.node_box = (const float*)node_box;
  a.node_links = (const int*)node_links;
  a.tri_data = (const float*)tri_data;
  a.tri_shade = (const float*)tri_shade;
  a.root = root;
  a.live_packets = (const int*)live_packets;
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
