// Gathers for Hopper (sm_90a): the counterparts of the TPU gather probes
// K2 and K3 in scripts/exp_mosaic_gather.py.
//
//   take_along_axis<1>: out[r, c] = x[r mod R, idx[r, c]]
//     K2 (a), :35-39, the lane gather, and K3 (::k_big, :65-79), the same
//     over a grid of idx blocks with one x block resident: x is [R, C]
//     and idx's rows are a multiple of R.
//   take_along_axis<0>: out[r, c] = x[idx[r, c], c mod C]
//     K2 (b), :43-47, the sublane gather.
//   flat_take:          out[e] = table[idx[e]]  (idx of any shape)
//     K2 (c), :52-57, the flat gather from a 128k-entry table: the gather
//     the ELL SpMV (ell_spmv.cu) performs, there fused with its multiply
//     and reduction.  On the solver path it is GatherOp's x[pos]
//     (hypre_tpu/ops/dia.py:877), so it has an f64 instance beside f32.
//
// f32 values (flat_take: f32 or f64), int32 indices, one output element
// per thread in a grid-stride loop, so the idx reads and out writes are coalesced; the
// table reads go through the read-only path.  Indices must lie in range
// (0 <= idx < the gathered extent): the kernels do not check them.
//
// What bounds it: device-memory bytes, 8 per output element (idx in,
// out back) plus the table once.  On the TPU the probes asked whether
// Mosaic lowers such gathers at all; on Hopper a gather is an ordinary
// load, and its cost is the scattered table reads, which L2 absorbs when
// the table is small (K3's x is 1 MB).
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/gather_kernel.py):
// each entry point launches on the given stream, does not synchronize,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int AXIS>
__global__ void take_along_axis_kernel(const float* __restrict__ x,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ out, int64_t xr,
                                       int64_t xc, int64_t ir, int64_t ic) {
  const int64_t total = ir * ic;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t r = e / ic;
    const int64_t c = e - r * ic;
    const int64_t j = idx[e];
    out[e] = AXIS == 1 ? __ldg(x + (r % xr) * xc + j)
                       : __ldg(x + j * xc + c % xc);
  }
}

template <typename T>
__global__ void flat_take_kernel(const T* __restrict__ table,
                                 const int32_t* __restrict__ idx,
                                 T* __restrict__ out, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride)
    out[e] = __ldg(table + idx[e]);
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535;

unsigned blocks_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" {

int take_along_axis_f32(const void* x, const void* idx, void* out, int64_t xr,
                        int64_t xc, int64_t ir, int64_t ic, int axis,
                        void* stream) {
  if (ir * ic > 0) {
    const unsigned blocks = blocks_for(ir * ic);
    if (axis == 1)
      take_along_axis_kernel<1><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)x, (const int32_t*)idx, (float*)out, xr, xc, ir, ic);
    else
      take_along_axis_kernel<0><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)x, (const int32_t*)idx, (float*)out, xr, xc, ir, ic);
  }
  return (int)cudaGetLastError();
}

int flat_take_f32(const void* table, const void* idx, void* out, int64_t total,
                  void* stream) {
  if (total > 0)
    flat_take_kernel<float><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int32_t*)idx, (float*)out, total);
  return (int)cudaGetLastError();
}

int flat_take_f64(const void* table, const void* idx, void* out, int64_t total,
                  void* stream) {
  if (total > 0)
    flat_take_kernel<double><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)table, (const int32_t*)idx, (double*)out, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
