// Square DIA SpMV for Hopper (sm_90a), with fused epilogues:
//   ax[i] = sum_k widen(data[k, i]) * x[i + off[k]]   (taps outside [0, n) skipped)
//   plain  y = ax        resid  y = f - ax        axpy  y = u + ax
//   jacobi y = u + (w * d) * (f - ax), x = u
//
// Replaces hypre_tpu/ops/pallas_dia.py::pallas_dia_spmv (the Pallas TPU
// kernel, body `kernel` at :156-175).  That kernel staged an x window into
// VMEM through a zero-padded buffer and chunked wide operators into
// 64-offset calls to fit VMEM; none of that carries over.  The epilogues
// are the elementwise work that follows the fine-level matvec in the
// V-cycle (hypre_tpu/solvers/amg/relax.py::jacobi, the residual), which
// XLA fuses on the TPU.
//
// Design:
//   * Offsets by value: up to 8 taps (the 96^3 fine level has 7) come in
//     the kernel's parameters and the tap loop is unrolled over 8, each
//     tap guarded by k < noff (the same for every thread).  More taps
//     are read from a device array in a runtime loop, in the same
//     kernel; any count, one launch.
//   * Interior / edge split: a thread whose rows have every tap inside
//     [0, n) (rows [lo, hi), computed on the host) takes no bounds
//     check -- for the 7-point operator all but the first and last
//     nx * ny rows.  The edge rows keep the check: there is no padded
//     copy of x, so a zero in `data` would not make a read safe.
//   * Several rows a thread with 16-byte loads: with VEC a thread takes
//     R = 16 / sizeof(data) consecutive rows (8 in bf16, 4 in f32, 2 in
//     f64) and loads data[k, i..i+R), f, u, d and y as 16-byte vectors
//     (two for f32 vectors beside bf16 data).  The wrapper sets VEC when
//     n is a multiple of R and every pointer is 16-byte aligned;
//     otherwise one row a thread with scalar loads.  x[i + off] goes
//     through L1/L2, where every tap reuses it: as aligned vectors for
//     an interior tap whose offset is a multiple of R (5 of the 7
//     taps at 96^3), else as scalars.
//   * 128-thread blocks: in bf16 the grid is 864 blocks, so the last
//     blocks an SM takes differ by a smaller share of the work.
//   * data is read once per call with streaming loads (__ldcs) so x
//     keeps the L2.  Index math is 32-bit unless the wrapper asks for
//     64 (`wide`: noff * n or n + |offset| reaches 2^31), at any count.
//   * The sum runs in offset order in the vector type V, with bf16 data
//     (stored as its 16-bit pattern) widened to float in registers
//     (pallas_dia.py:163-174).  The epilogue uses round-to-nearest
//     intrinsics, so no multiply-add is contracted there.
//
// What bounds it: device-memory bytes.  One call needs data, x, y and
// the form's vectors once: (noff * sizeof(D) + 2 * sizeof(V)) * n for
// the plain form, 31.9 MB in f32 and 63.7 MB in f64 for the 96^3
// 7-point operator, a floor of ~9.5 us (f32) and ~19 us (f64) at the
// data-sheet 3.35 TB/s (derived; PERF.md records the measured time).
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/dia_kernel.py):
// one entry point per form and dtype pair, each launches on the given
// stream, does not synchronize, and returns cudaGetLastError() (or
// cudaErrorInvalidValue when more than 8 offsets come without the
// device array).  Each instance is (form, dtype pair, vector path,
// index width): 48 kernels.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Form { kPlain = 0, kResid = 1, kAxpy = 2, kJacobi = 3 };
constexpr int kMaxByValue = 8;  // taps that come by value
constexpr int kThreads = 128;

__device__ __forceinline__ float widen(uint16_t v) {  // bf16 bits -> float
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// R consecutive values from p: 16-byte vector loads when they fill whole
// vectors (p is then 16-byte aligned), else scalar loads.  `stream`
// marks data read once per call.  (uint16_t, the bf16 storage, is
// unsigned short, which __ldcs and __ldg take.)
template <bool stream, typename T, int R>
__device__ __forceinline__ void load_rows(const T* p, T (&v)[R]) {
  if constexpr (R * sizeof(T) % 16 == 0) {
    constexpr int C = R * sizeof(T) / 16;
    const int4* q = reinterpret_cast<const int4*>(p);
    int4 tmp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) tmp[c] = stream ? __ldcs(q + c) : __ldg(q + c);
    memcpy(v, tmp, sizeof(tmp));
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = stream ? __ldcs(p + r) : __ldg(p + r);
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_rows(T* p, const T (&v)[R]) {
  if constexpr (R * sizeof(T) % 16 == 0) {
    constexpr int C = R * sizeof(T) / 16;
    int4 tmp[C];
    memcpy(tmp, v, sizeof(tmp));
    int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = tmp[c];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = v[r];
  }
}

template <typename I>
struct Taps {
  I off[kMaxByValue];  // the offsets, when noff <= kMaxByValue
};

template <typename D, typename V>
struct Args {
  const D* data;
  const int64_t* offsets;  // device array, read when noff > kMaxByValue
  const V* x;
  const V* f;
  const V* u;
  const V* d;
  V w;
  V* y;
};

template <typename D, typename V, int F, bool VEC, typename I>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(Args<D, V> a, Taps<I> taps, int noff, I n, I lo, I hi) {
  constexpr int R = VEC ? 16 / sizeof(D) : 1;
  const I i0 = ((I)blockIdx.x * kThreads + threadIdx.x) * R;
  if (i0 >= n) return;
  V acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = V(0);

  // one tap: data[k, i0..i0+R) times x[i0 + r + off].  On the 16-byte
  // path an interior tap whose offset is a multiple of R (0, +-nx,
  // +-nx*ny on the 96^3 grid; the test is the same for the whole grid)
  // reads its x window as aligned vectors too.
  auto tap = [&](int k, I off, bool checked) {
    D dv[R];
    load_rows<true>(a.data + (I)k * n + i0, dv);
    const V* xp = a.x + i0 + off;
    if (VEC && !checked && off % R == 0) {
      V xv[R];
      load_rows<false>(xp, xv);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += (V)widen(dv[r]) * xv[r];
      return;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!checked) {
        acc[r] += (V)widen(dv[r]) * __ldg(xp + r);
      } else {
        const I j = i0 + r + off;
        if (j >= 0 && j < n) acc[r] += (V)widen(dv[r]) * __ldg(xp + r);
      }
    }
  };
  const bool interior = i0 >= lo && i0 + R <= hi;
  if (noff <= kMaxByValue) {
    if (interior) {
#pragma unroll
      for (int k = 0; k < kMaxByValue; ++k)
        if (k < noff) tap(k, taps.off[k], false);
    } else {
#pragma unroll
      for (int k = 0; k < kMaxByValue; ++k)
        if (k < noff) tap(k, taps.off[k], true);
    }
  } else if (interior) {
    for (int k = 0; k < noff; ++k) tap(k, (I)__ldg(a.offsets + k), false);
  } else {
    for (int k = 0; k < noff; ++k) tap(k, (I)__ldg(a.offsets + k), true);
  }

  V ef[R], eu[R], ed[R], out[R];
  if constexpr (F == kResid || F == kJacobi) load_rows<false>(a.f + i0, ef);
  if constexpr (F == kAxpy) load_rows<false>(a.u + i0, eu);
  if constexpr (F == kJacobi) {
    load_rows<false>(a.x + i0, eu);
    load_rows<false>(a.d + i0, ed);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (F == kPlain) {
      out[r] = acc[r];
    } else if constexpr (F == kResid) {
      out[r] = sub_rn(ef[r], acc[r]);
    } else if constexpr (F == kAxpy) {
      out[r] = add_rn(eu[r], acc[r]);
    } else {
      out[r] = add_rn(eu[r], mul_rn(mul_rn(a.w, ed[r]), sub_rn(ef[r], acc[r])));
    }
  }
  store_rows(a.y + i0, out);
}

template <typename D, typename V, int F, bool VEC, typename I>
void go(const Args<D, V>& a, const int64_t* offs, int64_t noff, int64_t n,
        int64_t lo, int64_t hi, cudaStream_t stream) {
  constexpr int R = VEC ? 16 / sizeof(D) : 1;
  Taps<I> taps{};
  for (int64_t k = 0; k < noff && k < kMaxByValue; ++k) taps.off[k] = (I)offs[k];
  const int64_t threads = (n + R - 1) / R;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  dia_spmv_kernel<D, V, F, VEC, I><<<blocks, kThreads, 0, stream>>>(
      a, taps, (int)noff, (I)n, (I)lo, (I)hi);
}

template <typename D, typename V, int F>
int launch(const void* data, const void* offsets_dev, const int64_t* offs,
           int64_t noff, const void* x, const void* f, const void* u,
           const void* d, double w, void* y, int64_t n, int vec, int wide,
           void* stream) {
  const Args<D, V> a{(const D*)data, (const int64_t*)offsets_dev,
                     (const V*)x, (const V*)f, (const V*)u, (const V*)d,
                     (V)w, (V*)y};
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (noff > kMaxByValue && offsets_dev == nullptr) return (int)cudaErrorInvalidValue;
  // rows [lo, hi) have every tap inside [0, n)
  int64_t lo = 0, hi = n;
  for (int64_t k = 0; k < noff; ++k) {
    if (-offs[k] > lo) lo = -offs[k];
    if (n - offs[k] < hi) hi = n - offs[k];
  }
  if (lo > n) lo = n;
  if (hi < lo) hi = lo;
  if (wide) {
    if (vec) go<D, V, F, true, int64_t>(a, offs, noff, n, lo, hi, st);
    else go<D, V, F, false, int64_t>(a, offs, noff, n, lo, hi, st);
  } else {
    if (vec) go<D, V, F, true, int32_t>(a, offs, noff, n, lo, hi, st);
    else go<D, V, F, false, int32_t>(a, offs, noff, n, lo, hi, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define DIA_ENTRY(FORM, F, DT, D, V)                                          \
  extern "C" int dia_spmv_##FORM##_##DT(                                      \
      const void* data, const void* offsets_dev, const int64_t* offsets,      \
      int64_t noff, const void* x, const void* f, const void* u,              \
      const void* d, double w, void* y, int64_t n, int vec, int wide,       \
      void* stream) {                                                         \
    return launch<D, V, F>(data, offsets_dev, offsets, noff, x, f, u, d, w,   \
                           y, n, vec, wide, stream);                          \
  }

#define DIA_FORMS(DT, D, V)              \
  DIA_ENTRY(plain, kPlain, DT, D, V)     \
  DIA_ENTRY(resid, kResid, DT, D, V)     \
  DIA_ENTRY(axpy, kAxpy, DT, D, V)       \
  DIA_ENTRY(jacobi, kJacobi, DT, D, V)

DIA_FORMS(f64_f64, double, double)
DIA_FORMS(f32_f32, float, float)
DIA_FORMS(bf16_f32, uint16_t, float)
