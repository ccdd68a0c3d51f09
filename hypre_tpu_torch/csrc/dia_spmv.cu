// Square DIA SpMV for Hopper (sm_90a): y[i] = sum_k data[k, i] * x[i + off[k]].
//
// Replaces hypre_tpu/ops/pallas_dia.py::pallas_dia_spmv (the Pallas TPU
// kernel, body `kernel` at :156-175).  That kernel staged an x window into
// VMEM through a zero-padded buffer and chunked wide operators into
// 64-offset calls to fit VMEM; none of that carries over.  Here:
//
//   * one thread per row, in a grid-stride loop; the offsets are a small
//     int64 device array (const __restrict__, so reads go through the
//     read-only cache), any count in one launch (no chunking);
//   * taps with i + off[k] outside [0, n) are skipped by an explicit bounds
//     check -- there is no padded copy of x, so a zero in `data` would not
//     make the read safe;
//   * the sum runs in offset order in the vector type V, with bf16 data
//     widened to float before the multiply (pallas_dia.py:163-174);
//   * k * n + i is computed in 64 bits: relocated levels reach ~1e3
//     offsets x 2e6 cells, past int32.
//
// What bounds it: device-memory bytes.  Neighbouring threads read
// neighbouring data[k, i] and x[i + off[k]], and x (7 MB at 96^3 in f64)
// stays in the 50 MB L2, so one call moves about
// (noff * sizeof(D) + 2 * sizeof(V)) * n bytes: 31.9 MB in f32 and 63.7 MB
// in f64 for the 96^3 7-point operator (n = 884,736).  At the data-sheet
// 3.35 TB/s that is a floor of ~9.5 us (f32) and ~19 us (f64) -- derived,
// not measured; PERF.md records the measured time beside it.  Vectorized
// loads, TMA staging and a fused Jacobi epilogue are later work.
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/dia_kernel.py):
// each entry point launches on the given stream, does not synchronize,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename D, typename V>
__global__ void dia_spmv_kernel(const D* __restrict__ data,
                                const int64_t* __restrict__ offsets,
                                const V* __restrict__ x, V* __restrict__ y,
                                int64_t n, int64_t noff) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    V acc = V(0);
    for (int64_t k = 0; k < noff; ++k) {
      const int64_t j = i + offsets[k];
      if (j >= 0 && j < n) acc += (V)widen(data[k * n + i]) * x[j];
    }
    y[i] = acc;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535;

template <typename D, typename V>
int launch(const void* data, const void* offsets, const void* x, void* y,
           int64_t n, int64_t noff, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    dia_spmv_kernel<D, V><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const D*)data, (const int64_t*)offsets, (const V*)x, (V*)y, n, noff);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dia_spmv_f32_f32(const void* data, const void* offsets, const void* x,
                     void* y, int64_t n, int64_t noff, void* stream) {
  return launch<float, float>(data, offsets, x, y, n, noff, stream);
}

int dia_spmv_bf16_f32(const void* data, const void* offsets, const void* x,
                      void* y, int64_t n, int64_t noff, void* stream) {
  return launch<__nv_bfloat16, float>(data, offsets, x, y, n, noff, stream);
}

int dia_spmv_f64_f64(const void* data, const void* offsets, const void* x,
                     void* y, int64_t n, int64_t noff, void* stream) {
  return launch<double, double>(data, offsets, x, y, n, noff, stream);
}

}  // extern "C"
