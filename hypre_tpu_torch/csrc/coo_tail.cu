// The COO tail of a lattice operator for Hopper (sm_90a), in place:
//   y[rows_u[s]] += sum_{e in [seg_ptr[s], seg_ptr[s+1])} widen(vals[e]) * x[cols[e]]
//
// Replaces hypre_tpu/ops/dia.py::tail_apply (:87-92), the system's use of
// the flat gather K2 (c) (scripts/exp_mosaic_gather.py:52) on the lattice
// path: gather, multiply, segment sum and a scatter-add on distinct rows,
// which XLA runs as separate ops on the TPU (no Pallas kernel there).  A
// tail holds the entries of a relocated operator that sit on diagonals too
// sparse to be worth a streamed DIA row; it is applied right after the DIA
// part (K1) or the parity sum produced y.  On the solver path the tail now
// rides in K1's own launch (csrc/dia_spmv.cu, the same sum in the same
// order); this kernel is the form for a tail with no K1 launch beside it.
//
// Design:
//   * Rows are sorted and distinct (rows_u), and the entries of one row
//     are contiguous: the segment index of the reference becomes a
//     segment-pointer array at freeze time, and one thread owns one output
//     row.  No atomics, so the result is the same on every run.
//   * A thread sums its segment in stored order, multiply and add not
//     contracted (round-to-nearest intrinsics), so in f64 the result is
//     bitwise that of the plain version's ordered segment sum.
//   * Segments are short (a rare diagonal crosses a row once; the 96^3
//     tails hold a few entries a row), so a thread a row keeps the
//     pointer and row reads coalesced and wastes few lanes; vals and cols
//     of neighbouring rows are neighbours in memory.
//   * bf16 vals come as their 16-bit pattern and are widened in registers.
//
// What bounds it: device-memory bytes: vals and cols once (T entries),
// seg_ptr and rows_u once, one x element an entry (gathered), y read and
// written on the rows touched.  At these sizes (10^3-10^5 entries) the
// launch itself is the larger cost.
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/tail_kernel.py):
// each entry point launches on the given stream, does not synchronize, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float widen(uint16_t v) {  // bf16 bits -> float
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename D, typename V>
__global__ void __launch_bounds__(kThreads)
coo_tail_kernel(const D* __restrict__ vals, const int32_t* __restrict__ cols,
                const int32_t* __restrict__ seg_ptr,
                const int32_t* __restrict__ rows_u, const V* __restrict__ x,
                V* __restrict__ y, int32_t nseg) {
  const int32_t s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= nseg) return;
  const int32_t e0 = __ldg(seg_ptr + s), e1 = __ldg(seg_ptr + s + 1);
  V acc = V(0);
  for (int32_t e = e0; e < e1; ++e)
    acc = add_rn(acc, mul_rn((V)widen(__ldg(vals + e)), __ldg(x + __ldg(cols + e))));
  const int32_t r = __ldg(rows_u + s);
  y[r] = add_rn(y[r], acc);
}

template <typename D, typename V>
int launch(const void* vals, const void* cols, const void* seg_ptr,
           const void* rows_u, const void* x, void* y, int64_t nseg,
           void* stream) {
  if (nseg > 0) {
    const unsigned blocks = (unsigned)((nseg + kThreads - 1) / kThreads);
    coo_tail_kernel<D, V><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const D*)vals, (const int32_t*)cols, (const int32_t*)seg_ptr,
        (const int32_t*)rows_u, (const V*)x, (V*)y, (int32_t)nseg);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define TAIL_ENTRY(DT, D, V)                                                  \
  extern "C" int coo_tail_##DT(const void* vals, const void* cols,            \
                               const void* seg_ptr, const void* rows_u,       \
                               const void* x, void* y, int64_t nseg,          \
                               void* stream) {                                \
    return launch<D, V>(vals, cols, seg_ptr, rows_u, x, y, nseg, stream);     \
  }

TAIL_ENTRY(f64_f64, double, double)
TAIL_ENTRY(f32_f32, float, float)
TAIL_ENTRY(bf16_f32, uint16_t, float)
