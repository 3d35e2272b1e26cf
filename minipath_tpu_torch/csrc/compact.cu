// The path tracer's coherence compaction between bounces, around one
// torch.sort: a key pass, one thread per lane, and a permute pass, one thread
// per output lane. It replaces no TPU kernel: the JAX package sorts with
// lax.sort and leaves the key and the gather to XLA, which fuses them on the
// TPU. On the card the plain version (render/wavefront.py::_compact_plain) is
// about ninety PyTorch kernels a call, each reading and writing whole (N,)
// or (N, 3) arrays: the position cells, the Morton code's 12 bit steps, the
// direction bin's ~25 passes, the key's shifts, a torch.cat of the payload
// into (N, 15), its gather by the permutation, and inv_direction and the
// live prefix recomputed. Here the key pass reads a lane's state once, in
// order, writes its int32 key, counts the live lanes and stages the lane's
// payload in a 64-B record; the permute pass reads a lane's source index,
// gathers the source's record, and writes the next state with its inverse
// direction and live flag.
//
// What bounds it on an H100: bytes. What the work needs, a lane: the key
// reads origin, direction and flag (25 B) and writes 4; the permute reads an
// 8-B index, gathers 52-56 B of the source's state and writes 65-69 B;
// torch.sort moves ~110 B between them. The arithmetic is a few dozen
// integer and float operations a lane. The gathers land where the sort sends
// them, scattered over the whole state: read from the state's own arrays
// they would be six rows a lane (four of 12 B, which may straddle two 32-B
// sectors, and two of 4 B), each costing at least a whole sector; that
// version ran at ~20% of its bound. So the key pass, which reads the lane's
// state in order anyway, stages the payload (origin, direction, throughput,
// radiance, pixel slot, MIS pdf: 56 B) in one 64-B record, and the permute
// pass gathers that record: two whole sectors a lane, four 16-B loads. The
// staging spends 64 B a lane of in-order writes, and 32 B more of reads, to
// save the scattered reads' wasted sectors. The records, and the permute's
// rows, go out through shared memory, so that each warp store covers whole
// sectors.
//
// The key is the plain version's, bit for bit, so the same torch.sort call
// gives the same permutation, ties included: (dead << 19) | (dbin << 12) |
// morton, where morton interleaves the lane's cell of a 16^3 grid over the
// origins' bounding box (the caller's torch amin and amax, NaN propagated)
// and dbin is one of 96 direction bins (6 dominant-axis faces x 4 x 4
// quantized minor components) or one of 8 octants; both come from
// sort_key.cuh, which the NEE shadow batch's key pass (shadow.cu) shares.

#include <cstdint>
#include <cuda_runtime.h>

#include "sort_key.cuh"

#define MP_COMPACT_BLOCK 256

namespace {

struct CompactArgs {
  int64_t n;
  // The path state: pointer and row stride in elements; the last axis is
  // contiguous.
  const float* origin;
  int64_t s_origin;
  const float* direction;
  int64_t s_direction;
  const float* throughput;
  int64_t s_throughput;
  const float* radiance;
  int64_t s_radiance;
  const int* pixel;
  int64_t s_pixel;
  const bool* active;
  int64_t s_active;
  const float* prev_pdf;  // null without NEE
  int64_t s_prev_pdf;
  // The key pass.
  const float* lo;  // (3,) the origins' bounding box
  const float* hi;
  int fine_direction;  // 96 direction bins, else the 8 octants
  int* key;            // (N,)
  float4* record;      // (N, 4) 64-B payload records, written by the key pass
  // The permute pass.
  const int64_t* perm;  // (N,) the sort's indices
  // One i32 in device memory, zero before the key pass: the key pass counts
  // the live lanes into it, the permute pass reads it.
  int* n_live;
  // The next state: (N, 9) rows of origin, direction and inverse direction,
  // the rest contiguous.
  float* o_rays;
  float* o_throughput;
  float* o_radiance;
  int* o_pixel;
  bool* o_active;
  float* o_prev_pdf;  // null without NEE
};

__global__ void __launch_bounds__(MP_COMPACT_BLOCK) key_kernel(const CompactArgs a) {
  // Every thread of the block takes part in the warp vote and the block's
  // record store below; a thread past the last lane loads the last lane's
  // state and stores nothing of it.
  const int64_t first = (int64_t)blockIdx.x * MP_COMPACT_BLOCK;
  const int64_t i = first + threadIdx.x;
  const bool in = i < a.n;
  const int64_t l = in ? i : a.n - 1;
  // Every load first: as far as the compiler knows the stores below may
  // alias them, and a load after a store would wait for it.
  const float* op = a.origin + l * a.s_origin;
  const float* dp = a.direction + l * a.s_direction;
  const float* tp = a.throughput + l * a.s_throughput;
  const float* rp = a.radiance + l * a.s_radiance;
  const float o[3] = {op[0], op[1], op[2]};
  const float x = dp[0], y = dp[1], z = dp[2];
  const float t0 = tp[0], t1 = tp[1], t2 = tp[2];
  const float r0 = rp[0], r1 = rp[1], r2 = rp[2];
  const int pixel = a.pixel[l * a.s_pixel];
  const float pdf = a.prev_pdf ? a.prev_pdf[l * a.s_prev_pdf] : 0.0f;
  const bool active = a.active[l * a.s_active];
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) lo[c] = a.lo[c], hi[c] = a.hi[c];

  const int morton = morton_cell(o, lo, hi);
  const int dbin = a.fine_direction ? direction_bin(x, y, z)
                                    : (int)(x > 0.0f) * 4 + (int)(y > 0.0f) * 2 + (int)(z > 0.0f);
  if (in) a.key[i] = ((int)!active << 19) | (dbin << 12) | morton;
  // The live lanes: a vote a warp, one atomic add a block (one a warp, all on
  // one address, held the pass back by a third).
  __shared__ int warp_live[MP_COMPACT_BLOCK / 32];
  const unsigned live = __ballot_sync(0xffffffffu, in && active);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x / 32] = __popc(live);

  // The payload, bits unchanged (the pixel slot as a float's bits), staged in
  // shared memory, so that each of a warp's stores covers 512 whole bytes of
  // the block's records.
  __shared__ float4 tile[4 * MP_COMPACT_BLOCK];
  const int k = 4 * threadIdx.x;
  tile[k] = make_float4(o[0], o[1], o[2], x);
  tile[k + 1] = make_float4(y, z, t0, t1);
  tile[k + 2] = make_float4(t2, r0, r1, r2);
  tile[k + 3] = make_float4(__int_as_float(pixel), pdf, 0.0f, 0.0f);
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < MP_COMPACT_BLOCK / 32; ++w) n += warp_live[w];
    if (n) atomicAdd(a.n_live, n);
  }
  float4* rec = a.record + 4 * first;
  const int64_t left = 4 * (a.n - first);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = j * MP_COMPACT_BLOCK + threadIdx.x;
    if (e < left) rec[e] = tile[e];
  }
}

__device__ __forceinline__ float inverse(float d) { return d == 0.0f ? INFINITY : 1.0f / d; }

// A block's `count` staged floats out to `out`, each warp store 128 whole
// bytes.
__device__ __forceinline__ void store_tile(float* out, const float* tile, int count) {
  for (int e = threadIdx.x; e < count; e += MP_COMPACT_BLOCK) out[e] = tile[e];
}

__global__ void __launch_bounds__(MP_COMPACT_BLOCK) permute_kernel(const CompactArgs a) {
  // Every thread of the block takes part in the staged stores below; a
  // thread past the last lane gathers the last lane's record and stores
  // none of it.
  const int64_t first = (int64_t)blockIdx.x * MP_COMPACT_BLOCK;
  const int64_t i = first + threadIdx.x;
  const bool in = i < a.n;
  const float4* rec = a.record + 4 * a.perm[in ? i : a.n - 1];
  const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2], r3 = rec[3];
  if (in) {
    a.o_pixel[i] = __float_as_int(r3.x);
    a.o_active[i] = i < *a.n_live;
    if (a.o_prev_pdf) a.o_prev_pdf[i] = r3.y;
  }
  // The 9- and 3-float rows through shared memory (odd strides, so no bank
  // conflicts): written straight from each thread, a warp's store would
  // touch 9 or 3 times the sectors it fills.
  __shared__ float rays[9 * MP_COMPACT_BLOCK];
  __shared__ float thr[3 * MP_COMPACT_BLOCK];
  __shared__ float rad[3 * MP_COMPACT_BLOCK];
  float* ray = rays + 9 * threadIdx.x;
  ray[0] = r0.x, ray[1] = r0.y, ray[2] = r0.z;
  ray[3] = r0.w, ray[4] = r1.x, ray[5] = r1.y;
  ray[6] = inverse(r0.w), ray[7] = inverse(r1.x), ray[8] = inverse(r1.y);
  float* t = thr + 3 * threadIdx.x;
  t[0] = r1.z, t[1] = r1.w, t[2] = r2.x;
  float* r = rad + 3 * threadIdx.x;
  r[0] = r2.y, r[1] = r2.z, r[2] = r2.w;
  __syncthreads();
  const int rows = (int)(a.n - first < MP_COMPACT_BLOCK ? a.n - first : MP_COMPACT_BLOCK);
  store_tile(a.o_rays + 9 * first, rays, 9 * rows);
  store_tile(a.o_throughput + 3 * first, thr, 3 * rows);
  store_tile(a.o_radiance + 3 * first, rad, 3 * rows);
}

int launch(void (*kernel)(CompactArgs), const CompactArgs& a, void* stream) {
  if (a.n == 0) return 0;
  const int64_t blocks = (a.n + MP_COMPACT_BLOCK - 1) / MP_COMPACT_BLOCK;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, MP_COMPACT_BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mp_compact_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int mp_compact_args_size() { return (int)sizeof(CompactArgs); }

// The sort key and payload record of `args->n` lanes, and their live count,
// on `stream`. Returns the launch's cudaError_t (0 on success). The
// arguments are read on the host, at the launch.
int mp_compact_key(const void* args, void* stream) {
  const CompactArgs& a = *(const CompactArgs*)args;
  if (a.n && (!a.origin || !a.direction || !a.throughput || !a.radiance || !a.pixel || !a.active || !a.lo ||
              !a.hi || !a.key || !a.record || !a.n_live))
    return (int)cudaErrorInvalidValue;
  return launch(key_kernel, a, stream);
}

// The next state of `args->n` lanes, gathered from the key pass's records by
// `args->perm`, on `stream`. Returns the launch's cudaError_t (0 on success).
int mp_compact_permute(const void* args, void* stream) {
  const CompactArgs& a = *(const CompactArgs*)args;
  if (a.n && (!a.record || !a.perm || !a.n_live || !a.o_rays || !a.o_throughput || !a.o_radiance || !a.o_pixel ||
              !a.o_active))
    return (int)cudaErrorInvalidValue;
  return launch(permute_kernel, a, stream);
}

}  // extern "C"
