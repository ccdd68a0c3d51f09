// A dense operator on relocated cells for Hopper (sm_90a), one launch:
//   y[pos[r]] = sum_j widen(M[r, j]) * x[pos[j]]   for every row r of M
//   y[c] = 0                                        where row_of_cell[c] == -1
//
// Replaces, for the lattice path's collapsed coarse solve, the four
// launches of ScatterOp(GatherOp(DenseMatrix)) (hypre_tpu/ops/dia.py::spmv,
// :876-880, built by hypre_tpu/solvers/amg/boomeramg.py:1466): the flat
// gather x[pos], which is K2 (c) (scripts/exp_mosaic_gather.py:52) as the
// system uses it and which the port ran as `flat_take` (csrc/gather.cu),
// then a gemv, a zero fill and an indexed copy.  M is [rows, cols]
// row-major (the collapsed sub-cycle at 96^3: 1,529^2 f64, 18.7 MB, or
// 1,731^2 f32, 12.0 MB); pos [cols] (the cells of M's rows and columns:
// M is square) and row_of_cell [ncells] (its inverse, -1 on an empty
// cell, built at freeze time) are int32.
//
// Design:
//   * Each block stages the gathered vector x[pos] into shared memory
//     once (cols * sizeof(V): 12 KB at 96^3 f64): flat_take's work, with
//     no launch of its own and no round trip through device memory.  A
//     thread issues the index loads of its share, then the x loads, so
//     the staging costs two memory latencies, not two a value.
//   * One warp a row of M, written to its cell; the empty cells (56% of
//     them at 96^3) are zeroed by a grid-stride pass over row_of_cell, so
//     no warp idles on one (a warp a cell took a second wave of blocks
//     in f32 and ran slower).  A warp streams its row of M with 16-byte
//     streaming loads (__ldcs: M is read once a call, x and the indices
//     keep the L2), twelve loads a lane in flight (a 96^3 row is 24
//     loads a lane: two rounds), against the shared copy of x.  The
//     first round is issued before the staging, which it does not need,
//     so its latency overlaps the staging's.  A row starts where r * cols
//     puts it, so the elements before its first 16-byte boundary and
//     after its last are read as scalars.
//   * Each lane sums its elements in a fixed order, and the warp adds
//     the 32 partial sums with a fixed shuffle tree: every run gives the
//     same bits (not the gemv's order: the result agrees with the plain
//     version to rounding, 1e-12 in f64).
//   * 8 warps a block: 192 blocks at 96^3 (f64), all resident at once on
//     132 SMs; a block needing more than 48 KB of shared memory (cols
//     above 6,144 in f64) asks for it, up to the card's 227 KB.
//   * bf16 M (a relocated dense level under bf16 storage) comes as its
//     16-bit pattern and is widened to float in registers.
//
// What bounds it: device-memory bytes, M read once plus the vectors:
// 18.7 MB in f64 at 96^3, 5.6 us at the data-sheet 3.35 TB/s (derived;
// PERF.md records the measured time).
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/cell_dense_kernel.py):
// each entry point launches on the given stream, does not synchronize, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kInFlight = 12;  // 16-byte loads of M a lane has in flight
constexpr int kStage = 8;      // x[pos] values a thread stages at once

__device__ __forceinline__ float widen(uint16_t v) {  // bf16 bits -> float
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename D, typename V>
__global__ void __launch_bounds__(kThreads)
cell_dense_kernel(const D* __restrict__ M, const int32_t* __restrict__ pos,
                  const int32_t* __restrict__ row_of_cell,
                  const V* __restrict__ x, V* __restrict__ y, int32_t cols,
                  int32_t ncells) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* xs = reinterpret_cast<V*>(smem);
  const int lane = threadIdx.x % 32;
  const int32_t rows = cols;
  const int32_t r0 = blockIdx.x * kWarps + threadIdx.x / 32;
  const int32_t r = r0 < rows ? r0 : -1;
  constexpr int W = 16 / sizeof(D);  // elements a 16-byte load
  const D* row = M + (int64_t)(r < 0 ? 0 : r) * cols;
  const int32_t head = min(
      cols, (int32_t)(((16 - ((uintptr_t)row & 15)) & 15) / sizeof(D)));
  const int32_t nvec = (cols - head) / W;
  const int4* rv = reinterpret_cast<const int4*>(row + head);
  int4 raw[kInFlight];  // the first round of the row, before the staging
  if (r >= 0) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (lane + 32 * u < nvec) raw[u] = __ldcs(rv + lane + 32 * u);
  }
  // the empty cells
  for (int32_t c = blockIdx.x * kThreads + threadIdx.x; c < ncells;
       c += gridDim.x * kThreads)
    if (__ldg(row_of_cell + c) < 0) y[c] = V(0);

  for (int32_t j0 = threadIdx.x; j0 < cols; j0 += kThreads * kStage) {
    int32_t p[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int32_t j = j0 + u * kThreads;
      p[u] = j < cols ? __ldg(pos + j) : 0;
    }
    V v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (j0 + u * kThreads < cols) v[u] = __ldg(x + p[u]);
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (j0 + u * kThreads < cols) xs[j0 + u * kThreads] = v[u];
  }
  __syncthreads();

  if (r < 0) return;
  const V* xv = xs + head;
  V acc = V(0);
  if (lane < head) acc = (V)widen(__ldcs(row + lane)) * xs[lane];
  for (int32_t v0 = lane;; ) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int32_t v = v0 + 32 * u;
      if (v < nvec) {
        D m[W];
        memcpy(m, &raw[u], 16);
#pragma unroll
        for (int k = 0; k < W; ++k) acc += (V)widen(m[k]) * xv[v * W + k];
      }
    }
    v0 += 32 * kInFlight;
    if (v0 >= nvec) break;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (v0 + 32 * u < nvec) raw[u] = __ldcs(rv + v0 + 32 * u);
  }
  for (int32_t j = head + nvec * W + lane; j < cols; j += 32)
    acc += (V)widen(__ldcs(row + j)) * xs[j];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) y[__ldg(pos + r)] = acc;
}

template <typename D, typename V>
int launch(const void* M, const void* pos, const void* row_of_cell,
           const void* x, void* y, int64_t cols, int64_t ncells,
           void* stream) {
  if (ncells <= 0 || cols <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)cols * sizeof(V);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cell_dense_kernel<D, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((cols + kWarps - 1) / kWarps);
  cell_dense_kernel<D, V><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const D*)M, (const int32_t*)pos, (const int32_t*)row_of_cell,
      (const V*)x, (V*)y, (int32_t)cols, (int32_t)ncells);
  return (int)cudaGetLastError();
}

}  // namespace

#define CELL_DENSE_ENTRY(DT, D, V)                                            \
  extern "C" int cell_dense_##DT(const void* M, const void* pos,              \
                                 const void* row_of_cell, const void* x,      \
                                 void* y, int64_t cols, int64_t ncells,       \
                                 void* stream) {                              \
    return launch<D, V>(M, pos, row_of_cell, x, y, cols, ncells, stream);     \
  }

CELL_DENSE_ENTRY(f64_f64, double, double)
CELL_DENSE_ENTRY(f32_f32, float, float)
CELL_DENSE_ENTRY(bf16_f32, uint16_t, float)
