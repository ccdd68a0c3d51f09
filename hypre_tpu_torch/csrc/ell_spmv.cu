// Slot-major ELL SpMV for Hopper (sm_90a), with fused epilogues:
//   ax[i] = sum_{s < row_len[i]} widen(data[s, i]) * x[cols[s, i]]
//   plain  y = ax        resid  y = f - ax        axpy  y = u + ax
//   jacobi y = u + (w * d) * (f - ax), x = u (square operators)
//
// The counterpart of the TPU gather probes K2/K3
// (scripts/exp_mosaic_gather.py::run, the flat take at :52-57, and
// ::k_big): they measured whether a Pallas kernel could gather x[cols]
// from a VMEM-resident x for the coarse-level SpMV.  In the system that
// gather is the ELL SpMV of every coarse operator and grid transfer
// (hypre_tpu/ops/spmv.py::ell_spmv), here fused with the multiply, the
// slot reduction and the elementwise work that follows the matvec in
// the V-cycle (hypre_tpu/solvers/amg/relax.py::jacobi, the residual and
// the prolongation), which XLA fuses the same way on the TPU.
//
// Design:
//   * A block holds TB tiles of 32 consecutive rows x S slot lanes
//     (blockDim = (32, S, TB), 256 threads, 512 for S = 16).  Thread
//     (r, s) sums slots s, s+S, s+2S, ... of its row, so for each slot a
//     warp reads 32 neighbouring data/cols entries of the slot-major
//     [width, n] layout: coalesced.  The S partial sums meet in shared
//     memory and lane 0 adds them in lane order, so the result is the
//     same on every run.  S (1..16) comes from the wrapper
//     (ops/ell_kernel.py::slot_lanes): more lanes for wider rows and
//     for levels too small to fill 132 SMs one thread a row.
//   * Each row stops at row_len[i]: padding is neither loaded nor
//     multiplied (the R operators are 64-69% padding at 96^3).  The
//     loop itself runs to the warp's longest row with every load
//     predicated, so rows of unequal length (1-4 entries on P) do not
//     split the warp into paths that wait on their loads in turn.
//   * The slot loop is unrolled by 4, loads before multiplies, so four
//     cols -> x gathers are in flight per thread.
//   * data and cols are read once per call with streaming loads
//     (__ldcs), so x keeps the L2; x goes through the read-only path.
//   * Index math is 32-bit when width * n < 2^31 (every 96^3 operator),
//     64-bit otherwise.
//   * bf16 data (stored as its 16-bit pattern) is widened to float in
//     registers; the epilogue uses round-to-nearest intrinsics, so no
//     multiply-add is contracted there and it rounds as the unfused
//     torch ops do.
//
// What bounds it: device-memory bytes.  A call needs the nnz entries
// (data + cols), row_len, x, y and the form's vectors once; at 96^3 in
// f64 that is 0.1-18 us per operator at the data-sheet 3.35 TB/s.
// chip_smoke.py times each 96^3 operator beside that floor.
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/ell_kernel.py):
// one entry point per form and dtype pair, each launches on the given
// stream, does not synchronize, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a lane count it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Form { kPlain = 0, kResid = 1, kAxpy = 2, kJacobi = 3 };

__device__ __forceinline__ float widen(uint16_t v) {  // bf16 bits -> float
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

__device__ __forceinline__ uint16_t ld_stream(const uint16_t* p) {
  return __ldcs(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_stream(const double* p) { return __ldcs(p); }
__device__ __forceinline__ int ld_stream(const int32_t* p) {
  return __ldcs(reinterpret_cast<const int*>(p));
}

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename D, typename V>
struct Args {
  const D* data;
  const int32_t* cols;
  const int32_t* row_len;
  const V* x;
  const V* f;
  const V* u;
  const V* d;
  V w;
  V* y;
};

// threads a block: TB tiles of 32 rows x S lanes
template <int S>
struct Shape {
  static constexpr int TB = S >= 8 ? 1 : 8 / S;
  static constexpr int threads = 32 * S * TB;
};

template <typename D, typename V, int S, int F, typename I>
__global__ void __launch_bounds__(Shape<S>::threads)
ell_spmv_kernel(Args<D, V> a, I n) {
  constexpr int TB = Shape<S>::TB;
  const int r = threadIdx.x, s = threadIdx.y, t = threadIdx.z;
  const I i = ((I)blockIdx.x * TB + t) * 32 + r;
  // the slot loop runs to the longest row of the warp, every load
  // predicated on the lane's own row length: no branch diverges, and a
  // slot past a row's end is neither loaded nor multiplied
  const int len = i < n ? __ldg(a.row_len + i) : 0;
  const int wlen = __reduce_max_sync(0xffffffffu, len);
  // the epilogue's operands, read before the slot loop so their latency
  // hides behind it (lane 0 of each row writes y)
  V ef = V(0), eu = V(0), ed = V(0);
  if (s == 0 && i < n) {
    if constexpr (F == kResid || F == kJacobi) ef = __ldg(a.f + i);
    if constexpr (F == kAxpy) eu = __ldg(a.u + i);
    if constexpr (F == kJacobi) {
      eu = __ldg(a.x + i);
      ed = __ldg(a.d + i);
    }
  }
  V acc = V(0);
  for (int k = s; k < wlen; k += 4 * S) {
    int c[4];
    D v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k + j * S;
      c[j] = 0;
      v[j] = D(0);
      if (kk < len) {
        const I p = (I)kk * n + i;
        c[j] = ld_stream(a.cols + p);
        v[j] = ld_stream(a.data + p);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k + j * S < len) acc += (V)widen(v[j]) * __ldg(a.x + c[j]);
    }
  }
  if constexpr (S > 1) {
    __shared__ V part[TB][S][32];
    part[t][s][r] = acc;
    __syncthreads();
    if (s != 0) return;
#pragma unroll
    for (int q = 1; q < S; ++q) acc += part[t][q][r];
  }
  if (i >= n) return;
  if constexpr (F == kPlain) {
    a.y[i] = acc;
  } else if constexpr (F == kResid) {
    a.y[i] = sub_rn(ef, acc);
  } else if constexpr (F == kAxpy) {
    a.y[i] = add_rn(eu, acc);
  } else {
    a.y[i] = add_rn(eu, mul_rn(mul_rn(a.w, ed), sub_rn(ef, acc)));
  }
}

template <typename D, typename V, int S, int F>
void go(const Args<D, V>& a, int64_t n, int64_t width, cudaStream_t stream) {
  using Sh = Shape<S>;
  const int64_t tiles = (n + 31) / 32;
  const dim3 block(32, S, Sh::TB);
  const dim3 grid((unsigned)((tiles + Sh::TB - 1) / Sh::TB));
  if (width * n < (int64_t(1) << 31)) {
    ell_spmv_kernel<D, V, S, F, int32_t><<<grid, block, 0, stream>>>(a, (int32_t)n);
  } else {
    ell_spmv_kernel<D, V, S, F, int64_t><<<grid, block, 0, stream>>>(a, n);
  }
}

template <typename D, typename V, int F>
int launch(const void* data, const void* cols, const void* row_len,
           const void* x, const void* f, const void* u, const void* d,
           double w, void* y, int64_t n, int64_t width, int lanes,
           void* stream) {
  const Args<D, V> a{(const D*)data, (const int32_t*)cols,
                     (const int32_t*)row_len, (const V*)x, (const V*)f,
                     (const V*)u, (const V*)d, (V)w, (V*)y};
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    switch (lanes) {
      case 1: go<D, V, 1, F>(a, n, width, st); break;
      case 2: go<D, V, 2, F>(a, n, width, st); break;
      case 4: go<D, V, 4, F>(a, n, width, st); break;
      case 8: go<D, V, 8, F>(a, n, width, st); break;
      case 16: go<D, V, 16, F>(a, n, width, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define ELL_ENTRY(FORM, F, DT, D, V)                                          \
  extern "C" int ell_spmv_##FORM##_##DT(                                      \
      const void* data, const void* cols, const void* row_len, const void* x, \
      const void* f, const void* u, const void* d, double w, void* y,         \
      int64_t n, int64_t width, int lanes, void* stream) {                    \
    return launch<D, V, F>(data, cols, row_len, x, f, u, d, w, y, n, width,   \
                           lanes, stream);                                    \
  }

#define ELL_FORMS(DT, D, V)              \
  ELL_ENTRY(plain, kPlain, DT, D, V)     \
  ELL_ENTRY(resid, kResid, DT, D, V)     \
  ELL_ENTRY(axpy, kAxpy, DT, D, V)       \
  ELL_ENTRY(jacobi, kJacobi, DT, D, V)

ELL_FORMS(f64_f64, double, double)
ELL_FORMS(f32_f32, float, float)
ELL_FORMS(bf16_f32, uint16_t, float)
