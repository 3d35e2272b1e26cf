// The path tracer's NEE shadow batch around K2's any-hit trace, for the
// "pos" order: a box pass, a key pass, torch.sort, a pack pass, K2, and a
// resolve pass. It replaces no TPU kernel: the JAX package sorts the
// segments with lax.sort and leaves the key, the gathers and the scatter back
// to XLA (minipath_tpu/render/wavefront.py's bounce loop), which fuses them
// on the TPU. On the card the plain version (render/wavefront.py::
// _shadow_batch, the tracer's packing and the scatter back) is about 110
// PyTorch kernels a NEE bounce, each over every lane, however few of them
// are candidates: a masked bounding box, the Morton code's 12 bit steps, the
// direction bin's ~25 passes, the key's shifts, a torch.cat of origin and
// segment and its gather, the parking, the inverse, _pack_rays9's cat and
// transposing copy, the scatter of the answers and the masked add.
//
// Here, a NEE bounce of N lanes of which n_cand are candidates:
//   box      one masked min/max of the candidates' origins, and n_cand, and
//            the live packets ceil(n_cand / P), all three left in device
//            memory: a grid-stride pass, each block's partial reduced by the
//            block that finishes last;
//   key      one thread a lane: ((!cand) << 27) | (morton << 7) | dbin, the
//            plain version's key bit for bit (sort_key.cuh, shared with the
//            compaction), a non-candidate's point taken as 0;
//   sort     torch.sort of that key, the plain version's call, so the same
//            permutation, ties included, and K2 sees the same packets;
//   pack     K2's (B, 9, P) rows for the live packets alone: sorted slot i <
//            n_cand gets its candidate's origin, segment and inverse (+inf
//            for a zero component), the rest of the last live packet the
//            plain parking (origin 1e9, segment 1, inverse 1), and a slot
//            past N the row of slot N - 1, as _pack_rays9 pads. Packets past
//            the live count are not written: K2 loads their rays but traces
//            none of them;
//   resolve  sorted slots i < n_cand: where any-hit found no blocker,
//            radiance[order[i]] += contrib[order[i]], in place in the
//            radiance the shading kernel wrote; the blocked candidates are
//            counted for pt.shadow_occluded.
// The plain version adds +0.0 to every lane it does not light; the resolve
// pass leaves those lanes alone. The bits are the same unless a lane's
// radiance is -0.0, and the bounce loop never makes one: radiance starts at
// +0.0 and only gains terms that are not negative, and a sum that starts at
// +0.0 cannot round to -0.0.
//
// What bounds it on an H100: bytes. A lane: the box reads its flag (1 B), the
// key its flag and wi and writes its key (17 B), the sort ~108 B; a
// candidate: the box and the key read its origin (12 B each), the pack reads
// its index and gathers its origin and segment (32 B) and writes its row
// (36 B), the resolve reads its index and answer (12 B) and, when lit, its
// contribution and radiance and writes the radiance (36 B). The candidates
// are 4-41% of the lanes on the benchmark's cells, so the box and the key
// read a point only where there is a candidate, and the pack and the resolve
// visit the live prefix alone, with grids that stride over the count in
// device memory: the host never reads it.
//
// The gather: the pack pass reads each candidate's origin and segment rows
// from the query's own arrays, two 12-B rows a candidate, 1-2 sectors each.
// The compaction's key pass stages a 64-B record a lane for its permute pass
// instead, because there every lane is gathered (six rows a lane). Here the
// staged version (the key pass writing each candidate's origin and segment
// as one 32-B record, the pack pass gathering that one sector) was measured
// on an H100 80GB HBM3 at 700 W over the benchmark cells' batches: its pack
// pass is faster where candidates are many (0.27 against 0.36 ms at 38%),
// but its key pass pays more (0.33 against 0.17 ms), and the pair was 5-21%
// slower at every share from 4% to 41%.
//
// Every float step is the plain version's, in its order; the library is
// built with -fmad=false.

#include <cstdint>
#include <cuda_runtime.h>

#include "sort_key.cuh"

#define MP_SHADOW_BLOCK 256
// The most blocks a grid-stride pass (pack, resolve) launches: 16 of 256
// threads on each of 132 SMs, rounded up.
#define MP_SHADOW_GRID 2176

namespace {

constexpr float PARK_ORIGIN = 1e9f;  // _shadow_batch's parking, far outside any scene

struct ShadowArgs {
  int64_t n;  // lanes
  // The bounce's query: (N,) flags and contiguous (N, 3) rows.
  const bool* cand;
  const float* origin;
  const float* segment;
  const float* wi;
  const float* contrib;
  // Four i32 in device memory, zero before the box pass: the candidates and
  // the live packets (written by the box pass), the blocked candidates
  // (counted by the resolve pass), and the box pass's finished blocks.
  int* counts;
  // The box pass: each block's lo, hi and count, then the candidates' box.
  float* partial;  // (partial_rows, 8)
  int64_t partial_rows;
  float* box;  // (6,) lo, then hi
  // The key pass.
  int* key;  // (N,)
  // The pack pass.
  const int64_t* order;  // (N,) the sort's indices
  int packet;            // P, lanes a packet
  float* rays;           // (ceil(N / P), 9, P)
  // The resolve pass.
  const int* tri;    // (ceil(N / P) * P,) any-hit's answers, >= 0 where blocked
  float* radiance;   // (N, 3) rows, the last axis contiguous; updated in place
  int64_t s_radiance;
};

// Min and max as torch.amin and torch.amax take them: a NaN wins.
__device__ __forceinline__ float min_nan(float a, float b) { return isnan(a) ? a : (isnan(b) || b < a ? b : a); }
__device__ __forceinline__ float max_nan(float a, float b) { return isnan(a) ? a : (isnan(b) || b > a ? b : a); }

struct Box {
  float lo[3], hi[3];
  int count;
};

__device__ __forceinline__ void merge(Box& a, const Box& b) {
#pragma unroll
  for (int c = 0; c < 3; ++c) a.lo[c] = min_nan(a.lo[c], b.lo[c]), a.hi[c] = max_nan(a.hi[c], b.hi[c]);
  a.count += b.count;
}

// The block's box, in thread 0; every thread of the block calls it.
__device__ Box block_box(Box b) {
#pragma unroll
  for (int s = 16; s; s >>= 1) {
    Box o;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o.lo[c] = __shfl_xor_sync(0xffffffffu, b.lo[c], s);
      o.hi[c] = __shfl_xor_sync(0xffffffffu, b.hi[c], s);
    }
    o.count = __shfl_xor_sync(0xffffffffu, b.count, s);
    merge(b, o);
  }
  __shared__ Box warps[MP_SHADOW_BLOCK / 32];
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x / 32] = b;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < MP_SHADOW_BLOCK / 32; ++w) merge(b, warps[w]);
  return b;
}

__device__ __forceinline__ Box empty_box() {
  return Box{{INFINITY, INFINITY, INFINITY}, {-INFINITY, -INFINITY, -INFINITY}, 0};
}

__global__ void __launch_bounds__(MP_SHADOW_BLOCK) box_kernel(const ShadowArgs a) {
  Box b = empty_box();
  for (int64_t i = (int64_t)blockIdx.x * MP_SHADOW_BLOCK + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * MP_SHADOW_BLOCK) {
    if (a.cand[i]) {
      ++b.count;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = a.origin[3 * i + c];
        b.lo[c] = min_nan(b.lo[c], v), b.hi[c] = max_nan(b.hi[c], v);
      }
    }
  }
  b = block_box(b);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    float* p = a.partial + 8 * (int64_t)blockIdx.x;
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = b.lo[c], p[3 + c] = b.hi[c];
    p[6] = __int_as_float(b.count);
    __threadfence();
    last = atomicAdd(a.counts + 3, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The block that finished last merges every block's partial (read past L1,
  // where another SM wrote it).
  b = empty_box();
  for (int k = threadIdx.x; k < (int)gridDim.x; k += MP_SHADOW_BLOCK) {
    const float* p = a.partial + 8 * (int64_t)k;
    Box o;
#pragma unroll
    for (int c = 0; c < 3; ++c) o.lo[c] = __ldcg(p + c), o.hi[c] = __ldcg(p + 3 + c);
    o.count = __float_as_int(__ldcg(p + 6));
    merge(b, o);
  }
  __syncthreads();  // the warps' slots of block_box are reused
  b = block_box(b);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.box[c] = b.lo[c], a.box[3 + c] = b.hi[c];
    a.counts[0] = b.count;
    a.counts[1] = (b.count + a.packet - 1) / a.packet;
  }
}

__global__ void __launch_bounds__(MP_SHADOW_BLOCK) key_kernel(const ShadowArgs a) {
  const int64_t i = (int64_t)blockIdx.x * MP_SHADOW_BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const bool cand = a.cand[i];
  const float* op = a.origin + 3 * i;
  const float* wp = a.wi + 3 * i;
  // _position_cells takes a non-candidate's point as 0.
  const float o[3] = {cand ? op[0] : 0.0f, cand ? op[1] : 0.0f, cand ? op[2] : 0.0f};
  const float lo[3] = {a.box[0], a.box[1], a.box[2]};
  const float hi[3] = {a.box[3], a.box[4], a.box[5]};
  a.key[i] = ((int)!cand << 27) | (morton_cell(o, lo, hi) << 7) | direction_bin(wp[0], wp[1], wp[2]);
}

__device__ __forceinline__ float inverse(float d) { return d == 0.0f ? INFINITY : 1.0f / d; }

__global__ void __launch_bounds__(MP_SHADOW_BLOCK) pack_kernel(const ShadowArgs a) {
  const int P = a.packet;
  const int64_t n_cand = a.counts[0];
  const int64_t slots = (int64_t)a.counts[1] * P;
  for (int64_t i = (int64_t)blockIdx.x * MP_SHADOW_BLOCK + threadIdx.x; i < slots;
       i += (int64_t)gridDim.x * MP_SHADOW_BLOCK) {
    const int64_t j = i < a.n ? i : a.n - 1;
    float o0 = PARK_ORIGIN, o1 = PARK_ORIGIN, o2 = PARK_ORIGIN, s0 = 1.0f, s1 = 1.0f, s2 = 1.0f;
    if (j < n_cand) {
      const int64_t src = a.order[j];
      const float* op = a.origin + 3 * src;
      const float* sp = a.segment + 3 * src;
      o0 = op[0], o1 = op[1], o2 = op[2];
      s0 = sp[0], s1 = sp[1], s2 = sp[2];
    }
    const int64_t b = i / P;
    float* r = a.rays + 9 * b * P + (i - b * P);
    r[0] = o0, r[P] = o1, r[2 * P] = o2;
    r[3 * P] = s0, r[4 * P] = s1, r[5 * P] = s2;
    r[6 * P] = inverse(s0), r[7 * P] = inverse(s1), r[8 * P] = inverse(s2);
  }
}

__global__ void __launch_bounds__(MP_SHADOW_BLOCK) resolve_kernel(const ShadowArgs a) {
  const int64_t n_cand = a.counts[0];
  int blocked = 0;
  for (int64_t i = (int64_t)blockIdx.x * MP_SHADOW_BLOCK + threadIdx.x; i < n_cand;
       i += (int64_t)gridDim.x * MP_SHADOW_BLOCK) {
    if (a.tri[i] >= 0) {
      ++blocked;
      continue;
    }
    const int64_t src = a.order[i];
    float* r = a.radiance + src * a.s_radiance;
    const float* c = a.contrib + 3 * src;
    r[0] = r[0] + c[0], r[1] = r[1] + c[1], r[2] = r[2] + c[2];
  }
  // One atomic add a block.
  __shared__ int warps[MP_SHADOW_BLOCK / 32];
  blocked = __reduce_add_sync(0xffffffffu, blocked);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x / 32] = blocked;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < MP_SHADOW_BLOCK / 32; ++w) n += warps[w];
    if (n) atomicAdd(a.counts + 2, n);
  }
}

int launch(void (*kernel)(ShadowArgs), const ShadowArgs& a, void* stream, int64_t threads, int64_t max_blocks) {
  if (threads == 0) return 0;
  int64_t blocks = (threads + MP_SHADOW_BLOCK - 1) / MP_SHADOW_BLOCK;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, MP_SHADOW_BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mp_shadow_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int mp_shadow_args_size() { return (int)sizeof(ShadowArgs); }

// Each entry launches one pass over `args->n` lanes on `stream` and returns
// the launch's cudaError_t (0 on success). The arguments are read on the
// host, at the launch.

// The candidates' box, their count and the live packets.
int mp_shadow_box(const void* args, void* stream) {
  const ShadowArgs& a = *(const ShadowArgs*)args;
  if (a.n && (!a.cand || !a.origin || !a.counts || !a.partial || a.partial_rows < 1 || !a.box || a.packet < 1))
    return (int)cudaErrorInvalidValue;
  return launch(box_kernel, a, stream, a.n, a.partial_rows);
}

// The sort key of every lane.
int mp_shadow_key(const void* args, void* stream) {
  const ShadowArgs& a = *(const ShadowArgs*)args;
  if (a.n && (!a.cand || !a.origin || !a.wi || !a.box || !a.key)) return (int)cudaErrorInvalidValue;
  return launch(key_kernel, a, stream, a.n, INT64_MAX);
}

// K2's rows of the live packets, from the sort's order.
int mp_shadow_pack(const void* args, void* stream) {
  const ShadowArgs& a = *(const ShadowArgs*)args;
  if (a.packet < 1 || (a.n && (!a.origin || !a.segment || !a.counts || !a.order || !a.rays)))
    return (int)cudaErrorInvalidValue;
  return launch(pack_kernel, a, stream, (a.n + a.packet - 1) / a.packet * a.packet, MP_SHADOW_GRID);
}

// The unblocked candidates' light added to their lanes' radiance.
int mp_shadow_resolve(const void* args, void* stream) {
  const ShadowArgs& a = *(const ShadowArgs*)args;
  if (a.n && (!a.contrib || !a.counts || !a.order || !a.tri || !a.radiance)) return (int)cudaErrorInvalidValue;
  return launch(resolve_kernel, a, stream, a.n, MP_SHADOW_GRID);
}

}  // extern "C"
