// Square DIA SpMV for Hopper (sm_90a), with fused epilogues and an
// optional COO tail:
//   ax[i] = sum_k widen(data[k, i]) * x[i + off[k]]   (taps outside [0, n) skipped)
//   ax[i] = ax[i] + sum_{e in [tail_ptr[i], tail_ptr[i+1])} widen(tail_vals[e]) * tail_x[tail_cols[e]]
//   plain  y = ax        resid  y = f - ax        axpy  y = u + ax
//   jacobi y = u + (w * d) * (f - ax), x = u
//
// Replaces hypre_tpu/ops/pallas_dia.py::pallas_dia_spmv (the Pallas TPU
// kernel, body `kernel` at :156-175).  That kernel staged an x window into
// VMEM through a zero-padded buffer and chunked wide operators into
// 64-offset calls to fit VMEM; none of that carries over.  The epilogues
// are the elementwise work that follows the fine-level matvec in the
// V-cycle (hypre_tpu/solvers/amg/relax.py::jacobi, the residual), which
// XLA fuses on the TPU.  The tail is hypre_tpu/ops/dia.py::tail_apply
// (:87), the exact remainder of a lattice operator on diagonals too rare
// to stream, which the JAX package applies right after the DIA part.
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
//   * Offset lanes for many diagonals on few rows (the relocated lattice
//     operators: 10^2-10^3 offsets on 10^4-10^5 cells).  One thread a
//     row walking every offset in turn leaves the card a few thousand
//     threads that each wait out one memory latency a tap.  With S > 1
//     lanes a block takes 32 rows x S lanes; lane s sums the taps
//     k = s, s + S, ... of its row (loads coalesced over the 32 rows, the
//     loop unrolled so four taps are in flight), the partial sums meet in
//     shared memory and lane 0 adds them in lane order and writes the
//     form.  The order is fixed, so the result is the same every run; it
//     is not the offset order of the one-lane path.  The wrapper picks S
//     from the row and offset counts (ops/dia_kernel.py::offset_lanes).
//   * The tail rides in the launch that makes ax.  Alone it is bound by
//     launches, not bytes: a 96^3 tail holds 10^3-10^4 entries (a few
//     KB), under 1 us of traffic, against ~5 us for a launch of its own,
//     and on the DIAWithTail levels the form's epilogue then ran as
//     unfused torch ops after it.  Here the row pointer (int32 [n + 1],
//     built at freeze time) gives each row its segment.  In the offset-
//     lane kernel the last lane, which has the fewest taps, reads the
//     row's pointers before its taps and sums the segment after them,
//     and lane 0 adds it after the lane reduction.  In the row kernel a
//     launch with a tail takes the one-row-a-thread instances (its
//     pointers read before the taps): the 16-byte instances, the plain
//     path's, carry no tail code, which kept their registers and their
//     time.  The segment is summed from zero in stored order with
//     mul_rn / add_rn, four entries' loads in flight, and added to ax
//     before the epilogue (rows with an empty segment are left as they
//     are), so in f64 the result is bitwise K1, then the separate tail
//     kernel (csrc/coo_tail.cu), then the torch epilogue.  tail_x is K1's
//     x unless the caller names another vector (the parity restriction:
//     its tail gathers from the flat fine vector, not from the parity
//     part K1 reads).  A null tail_ptr is a branch that is the same for
//     every thread, not another template instance.  noff == 0 with a
//     tail is legal (ax = 0 plus the tail).
//
// What bounds it: device-memory bytes.  One call needs data, x, y and
// the form's vectors once: (noff * sizeof(D) + 2 * sizeof(V)) * n for
// the plain form, 31.9 MB in f32 and 63.7 MB in f64 for the 96^3
// 7-point operator, a floor of ~9.5 us (f32) and ~19 us (f64) at the
// data-sheet 3.35 TB/s (derived; PERF.md records the measured time).  A
// tail adds its entries (value, column, one gathered x) and 4 * (n + 1)
// bytes of row pointer.
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/dia_kernel.py):
// one entry point per form and dtype pair, each launches on the given
// stream, does not synchronize, and returns cudaGetLastError() (or
// cudaErrorInvalidValue when more than 8 offsets, or offset lanes, come
// without the device array).  Each instance is (form, dtype pair, vector
// path, index width): 48 kernels, and (form, dtype pair, index width)
// for the offset-lane kernel: 24 more.

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
  // the COO tail, or tail_ptr == nullptr: entries of row i are
  // [tail_ptr[i], tail_ptr[i + 1]), each tail_vals[e] * tail_x[tail_cols[e]]
  const int32_t* tail_ptr;
  const int32_t* tail_cols;
  const D* tail_vals;
  const V* tail_x;
};

constexpr int kTailBatch = 4;  // tail entries whose loads are in flight at once

// The tail entries [e0, e1) summed from zero in stored order.  The
// products of a batch are formed before they are added, so their loads
// overlap; the adds keep the order.
template <typename D, typename V>
__device__ __forceinline__ V tail_sum(const Args<D, V>& a, int32_t e0,
                                      int32_t e1) {
  V t = V(0);
  int32_t e = e0;
  for (; e + kTailBatch <= e1; e += kTailBatch) {
    V p[kTailBatch];
#pragma unroll
    for (int u = 0; u < kTailBatch; ++u)
      p[u] = mul_rn((V)widen(__ldg(a.tail_vals + e + u)),
                    __ldg(a.tail_x + __ldg(a.tail_cols + e + u)));
#pragma unroll
    for (int u = 0; u < kTailBatch; ++u) t = add_rn(t, p[u]);
  }
  for (; e < e1; ++e)
    t = add_rn(t, mul_rn((V)widen(__ldg(a.tail_vals + e)),
                         __ldg(a.tail_x + __ldg(a.tail_cols + e))));
  return t;
}

template <typename D, typename V, int F, bool VEC, typename I>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(Args<D, V> a, Taps<I> taps, int noff, I n, I lo, I hi) {
  constexpr int R = VEC ? 16 / sizeof(D) : 1;
  const I i0 = ((I)blockIdx.x * kThreads + threadIdx.x) * R;
  if (i0 >= n) return;
  V acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = V(0);
  // the row's tail segment, its pointers read before the taps so the
  // reads overlap them (the 16-byte instances take no tail)
  int32_t e0 = 0, e1 = 0;
  if constexpr (!VEC) {
    if (a.tail_ptr != nullptr) {
      e0 = __ldg(a.tail_ptr + i0);
      e1 = __ldg(a.tail_ptr + i0 + 1);
    }
  }

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
  if constexpr (!VEC) {
    if (a.tail_ptr != nullptr && e1 != e0)
      acc[0] = add_rn(acc[0], tail_sum(a, e0, e1));
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

constexpr int kLaneRows = 32;  // rows a block of the offset-lane kernel
constexpr int kMaxLanes = 32;

// blockDim = (kLaneRows, S): thread (rx, s) sums the taps k = s, s + S,
// ... of row blockIdx.x * kLaneRows + rx; lane 0 reduces and writes.
// The last lane, which has the fewest taps, reads the row's tail
// pointers before its taps (their latency overlaps the taps) and sums
// the segment after them; lane 0 adds it after the lane reduction.
template <typename D, typename V, int F, typename I>
__global__ void __launch_bounds__(kLaneRows * kMaxLanes)
dia_spmv_lanes_kernel(Args<D, V> a, int noff, I n) {
  __shared__ V part[kMaxLanes * kLaneRows];
  __shared__ V tail_part[kLaneRows];
  __shared__ bool has_tail[kLaneRows];
  const int rx = threadIdx.x, s = threadIdx.y, S = blockDim.y;
  const I i = (I)blockIdx.x * kLaneRows + rx;
  const bool tail_lane = a.tail_ptr != nullptr && s == S - 1 && i < n;
  int32_t e0 = 0, e1 = 0;
  if (tail_lane) {
    e0 = __ldg(a.tail_ptr + i);
    e1 = __ldg(a.tail_ptr + i + 1);
  }
  V acc = V(0);
  if (i < n) {
#pragma unroll 4
    for (int k = s; k < noff; k += S) {
      const I j = i + (I)__ldg(a.offsets + k);
      if (j >= 0 && j < n)
        acc += (V)widen(__ldcs(a.data + (I)k * n + i)) * __ldg(a.x + j);
    }
  }
  if (tail_lane) {
    has_tail[rx] = e1 != e0;
    if (e1 != e0) tail_part[rx] = tail_sum(a, e0, e1);
  }
  part[s * kLaneRows + rx] = acc;
  __syncthreads();
  if (s != 0 || i >= n) return;
  V ax = part[rx];
  for (int t = 1; t < S; ++t) ax = add_rn(ax, part[t * kLaneRows + rx]);
  if (a.tail_ptr != nullptr && has_tail[rx]) ax = add_rn(ax, tail_part[rx]);
  V out;
  if constexpr (F == kPlain) {
    out = ax;
  } else if constexpr (F == kResid) {
    out = sub_rn(__ldg(a.f + i), ax);
  } else if constexpr (F == kAxpy) {
    out = add_rn(__ldg(a.u + i), ax);
  } else {
    out = add_rn(__ldg(a.x + i), mul_rn(mul_rn(a.w, __ldg(a.d + i)),
                                        sub_rn(__ldg(a.f + i), ax)));
  }
  a.y[i] = out;
}

template <typename D, typename V, int F, typename I>
void go_lanes(const Args<D, V>& a, int64_t noff, int64_t n, int lanes,
              cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kLaneRows - 1) / kLaneRows);
  dia_spmv_lanes_kernel<D, V, F, I><<<blocks, dim3(kLaneRows, lanes), 0, stream>>>(
      a, (int)noff, (I)n);
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
           int lanes, const void* tail_ptr, const void* tail_cols,
           const void* tail_vals, const void* tail_x, void* stream) {
  const Args<D, V> a{(const D*)data, (const int64_t*)offsets_dev,
                     (const V*)x, (const V*)f, (const V*)u, (const V*)d,
                     (V)w, (V*)y, (const int32_t*)tail_ptr,
                     (const int32_t*)tail_cols, (const D*)tail_vals,
                     (const V*)(tail_x != nullptr ? tail_x : x)};
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if ((noff > kMaxByValue || lanes > 1) && offsets_dev == nullptr)
    return (int)cudaErrorInvalidValue;
  if (lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  if (tail_ptr != nullptr) vec = 0;  // the 16-byte instances take no tail
  if (lanes > 1) {
    if (wide) go_lanes<D, V, F, int64_t>(a, noff, n, lanes, st);
    else go_lanes<D, V, F, int32_t>(a, noff, n, lanes, st);
    return (int)cudaGetLastError();
  }
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
      int lanes, const void* tail_ptr, const void* tail_cols,                 \
      const void* tail_vals, const void* tail_x, void* stream) {              \
    return launch<D, V, F>(data, offsets_dev, offsets, noff, x, f, u, d, w,   \
                           y, n, vec, wide, lanes, tail_ptr, tail_cols,       \
                           tail_vals, tail_x, stream);                        \
  }

#define DIA_FORMS(DT, D, V)              \
  DIA_ENTRY(plain, kPlain, DT, D, V)     \
  DIA_ENTRY(resid, kResid, DT, D, V)     \
  DIA_ENTRY(axpy, kAxpy, DT, D, V)       \
  DIA_ENTRY(jacobi, kJacobi, DT, D, V)

DIA_FORMS(f64_f64, double, double)
DIA_FORMS(f32_f32, float, float)
DIA_FORMS(bf16_f32, uint16_t, float)
