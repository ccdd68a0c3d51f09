// Slot-major ELL SpMV for Hopper (sm_90a):
//   y[i] = sum_{s < width} widen(data[s, i]) * x[cols[s, i]],  i < num_rows.
//
// The counterpart of the TPU gather probes K2/K3
// (scripts/exp_mosaic_gather.py::run, the flat take at :52-57, and
// ::k_big): they measured whether a Pallas kernel could gather x[cols]
// from a VMEM-resident x for the coarse-level SpMV.  In the system that
// gather is the ELL SpMV of every coarse operator and grid transfer
// (hypre_tpu/ops/spmv.py::ell_spmv), here fused with the multiply and the
// slot reduction so no [width, n] temporary reaches device memory.
//
//   * Layout: slot-major [width, n] (hypre_tpu_torch/ops/csr.py::to_ell),
//     so for each slot neighbouring threads read neighbouring data and
//     cols.  Padding slots hold (col 0, value 0) and are read like any
//     other: they add 0 * x[0].
//   * One thread per row, in a grid-stride loop; the sum runs in slot
//     order in the vector type V.  bf16 data is widened to float in
//     registers, so no widened copy of the matrix is made per matvec.
//   * x (num_cols entries; P is tall and R is wide, so num_cols may
//     differ from n) is read through the read-only path; at 96^3 the
//     coarse x vectors (0.08-2.2 MB) stay in the 50 MB L2.
//   * s * n + i is computed in 64 bits.
//
// What bounds it: device-memory bytes.  A call moves the padded matrix,
// width * n * (sizeof(D) + 4) bytes, plus x and y once; at 96^3 in f64
// that is 13-127 MB per operator, a floor of 4-38 us at the data-sheet
// 3.35 TB/s.  Rows of unequal length (fill 0.31-0.36 on R) leave a
// warp waiting on its longest row and the padding is read anyway;
// per-row lengths, x staged in shared memory for the small levels and a
// fused Jacobi epilogue are later work.
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/ell_kernel.py):
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
__global__ void ell_spmv_kernel(const D* __restrict__ data,
                                const int32_t* __restrict__ cols,
                                const V* __restrict__ x, V* __restrict__ y,
                                int64_t n, int64_t width) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    V acc = V(0);
    for (int64_t s = 0; s < width; ++s) {
      const int64_t p = s * n + i;
      acc += (V)widen(data[p]) * __ldg(x + cols[p]);
    }
    y[i] = acc;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535;

template <typename D, typename V>
int launch(const void* data, const void* cols, const void* x, void* y,
           int64_t n, int64_t width, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    ell_spmv_kernel<D, V><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const D*)data, (const int32_t*)cols, (const V*)x, (V*)y, n, width);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ell_spmv_f32_f32(const void* data, const void* cols, const void* x,
                     void* y, int64_t n, int64_t width, void* stream) {
  return launch<float, float>(data, cols, x, y, n, width, stream);
}

int ell_spmv_bf16_f32(const void* data, const void* cols, const void* x,
                      void* y, int64_t n, int64_t width, void* stream) {
  return launch<__nv_bfloat16, float>(data, cols, x, y, n, width, stream);
}

int ell_spmv_f64_f64(const void* data, const void* cols, const void* x,
                     void* y, int64_t n, int64_t width, void* stream) {
  return launch<double, double>(data, cols, x, y, n, width, stream);
}

}  // extern "C"
