// The dependent multiply/min/max chain of the device-health probe, one
// thread per element (f32) or per pair of elements (bf16x2). One template,
// three instances:
//   chain_kernel<float>: port of minipath_tpu/utils/calibrate.py
//     ::_vpu_chain_kernel (K4, the compute probe of device_health) and of
//     tools/microbench_vpu_bf16.py::_chain_kernel in f32 (K5);
//   chain_kernel<__nv_bfloat162>: K5 in bf16, two lanes a thread.
// The Python wrapper, the plain PyTorch version and the probe are in
// minipath_tpu_torch/utils/calibrate.py.
//
// Each element computes what both Pallas bodies compute:
//   b = a * 1.0009765625, acc = a, then `iters` times
//   acc = max(min(acc * b, a * acc), a * 0.5).
// There is no addition, and IEEE mul, min and max each round once, so the
// kernel and its plain version give the same bits. The constant is rounded
// to the element type first, as the JAX and PyTorch versions round it: in
// bf16 it becomes 1.0, so there b == a.
//
// What bounds it on an H100: the rate of the arithmetic pipes, two
// multiplies and a min and a max per element and iteration, all dependent
// on the previous iteration. The SASS holds 2 FMUL and 2 FMNMX an iteration
// (f32; HMUL2, HFMA2 and 2 HMNMX2 for bf16x2), and FMNMX retires at half the
// FMUL rate, so the min/max set the bound. With a thread per element the
// work is one dependent chain per thread, and the warps of an SM hide its
// latency only when there are enough of them: K4's 65,536 elements are 512
// blocks, 3 or 4 on each SM. `iters` is a runtime argument and the result is
// written out, so the loop cannot be folded away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MP_CHAIN_BLOCK 128

namespace {

__device__ __forceinline__ float chain_mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float chain_min(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ float chain_max(float x, float y) { return fmaxf(x, y); }

__device__ __forceinline__ __nv_bfloat162 chain_mul(__nv_bfloat162 x, __nv_bfloat162 y) {
  return __hmul2(x, y);
}
__device__ __forceinline__ __nv_bfloat162 chain_min(__nv_bfloat162 x, __nv_bfloat162 y) {
  return __hmin2(x, y);
}
__device__ __forceinline__ __nv_bfloat162 chain_max(__nv_bfloat162 x, __nv_bfloat162 y) {
  return __hmax2(x, y);
}

template <typename T>
__device__ __forceinline__ T chain_const(float v);
template <>
__device__ __forceinline__ float chain_const<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat162 chain_const<__nv_bfloat162>(float v) {
  return __float2bfloat162_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(MP_CHAIN_BLOCK)
    chain_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, int iters) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T a = x[i];
  const T b = chain_mul(a, chain_const<T>(1.0009765625f));
  const T half = chain_mul(a, chain_const<T>(0.5f));
  T acc = a;
  for (int k = 0; k < iters; ++k) {
    acc = chain_max(chain_min(chain_mul(acc, b), chain_mul(a, acc)), half);
  }
  out[i] = acc;
}

template <typename T>
int launch_chain(const void* x, void* out, int64_t n, int iters, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (n + MP_CHAIN_BLOCK - 1) / MP_CHAIN_BLOCK;
  chain_kernel<T><<<(unsigned)blocks, MP_CHAIN_BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, n, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mp_chain_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K4, and K5 in f32: `n` float elements. Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
int mp_chain_f32(const void* x, void* out, int64_t n, int iters, void* stream) {
  return launch_chain<float>(x, out, n, iters, stream);
}

// K5 in bf16: `n_pairs` pairs of bf16 elements, two lanes a thread.
int mp_chain_bf16x2(const void* x, void* out, int64_t n_pairs, int iters, void* stream) {
  return launch_chain<__nv_bfloat162>(x, out, n_pairs, iters, stream);
}

}  // extern "C"
