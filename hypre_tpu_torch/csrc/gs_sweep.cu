// One level-scheduled Gauss-Seidel sweep for Hopper (sm_90a), one launch:
// for each wavefront l in order, for every row i of it (rows that read
// only values final in earlier wavefronts),
//   plain:  u[i] += w * dinv[i] * (f[i] - sum_k a[i,k] * u[col[i,k]])
//   omega:  u[i] += w * ((1-om)(u[i] - v[i])
//                        + dinv[i] * (om f[i] - S_cur + (1-om) S_pre))
//           (S_cur over u, S_pre over v; rows with dinv == 0 are skipped)
//
// No Pallas kernel is replaced: the JAX package runs a sweep as a
// lax.scan over the wavefronts, a gather, row sum and scatter-add a step
// (hypre_tpu/solvers/amg/relax.py::gauss_seidel, :174-193), which XLA
// compiles into one loop on the TPU.  Eager torch pays about six
// launches a wavefront (2,708 wavefronts a direction at 96^3), so here
// the whole sweep is one launch.
//
// Layout (built by hypre_tpu_torch/solvers/amg/relax.py): the level's CSR
// (int32 indptr / indices, float64 values) and float64 dinv, shared by the
// level's schedules; per schedule its rows in wavefront order (`order`),
// the wavefront pointers (`wf_ptr`) and one hazard flag a wavefront.
// Arithmetic is float64 whatever the vectors' type (the schedule keeps
// the host's float64 values, as the JAX package's does); the update is
// rounded once to the vectors' type and added in it, as the JAX step's
// `.at[rows].add` does.
//
// Design:
//   * S lanes a row (1..32, a power of two from the wrapper): lane s sums
//     entries s, s+S, ... of its row and the S partial sums meet in a
//     fixed xor-shuffle tree, so every run gives the same bits (not the
//     plain version's slot order: the two agree to rounding).
//   * Narrow levels (the widest wavefront under a constant of the
//     wrapper, ops/gs_kernel.py) run in ONE block that walks the
//     wavefronts with __syncthreads() between them; wide levels in one
//     cooperative grid with every block resident (sized from the
//     occupancy query, never above it) and a grid sync between
//     wavefronts, u read through L2 (__ldcg) since the SMs' L1 caches do
//     not see each other's writes.  A refused cooperative launch is
//     returned to the wrapper, which raises.
//   * Every thread runs the same number of passes over a wavefront, so
//     the shuffles and barriers are reached by all.
//   * A row's index, entry range, first four entries a lane, divisor and
//     f do not depend on u: the next wavefront's first pass loads them
//     before the barrier, so after it only the u gathers (one L2 round
//     trip) stand between two barriers.
//   * A wavefront whose rows read another row of the same wavefront (a
//     nonsymmetric pattern) is flagged at build time and runs in two
//     phases, all updates into `scratch` and then all writes, so every
//     row reads the values from before the wavefront, as the JAX step
//     does.  Symmetric patterns have no such wavefront.
//   * Only the rows in `order` are written: nothing outside u[:n].
//
// What bounds it: latency, not bytes.  A sweep is a chain of dependent
// wavefronts (286 on the 96^3 fine level, 862 on its level 2), each at
// least one barrier and one dependent L2 round trip; the bytes (the CSR
// once, the vectors) take ~31 us on the fine level at 3.35 TB/s.
// chip_smoke.py times every level's sweep beside that bytes bound.
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/gs_kernel.py):
// one entry point per vector type; each launches on the given stream,
// does not synchronize, and returns the launch's CUDA error (0 on
// success; cudaErrorInvalidValue for a lane count it does not take).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockMax = 1024;   // threads of the one-block form
constexpr int kCoopThreads = 256;  // threads a block of the grid form

template <typename V>
struct Args {
  const int32_t* indptr;
  const int32_t* indices;
  const double* data;
  const double* dinv;
  const int32_t* order;
  const int32_t* wf_ptr;
  const uint8_t* hazard;
  const V* f;
  const V* v;
  V* u;
  double* scratch;
  double w;
  double omega;
  int nwf;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float to_v(double x, float) { return __double2float_rn(x); }
__device__ __forceinline__ double to_v(double x, double) { return x; }

// u as the sweep reads it: through L2 in the grid form (other SMs wrote
// it), through the block's own L1 in the one-block form
template <bool COOP, typename V>
__device__ __forceinline__ V load_u(const V* p) {
  if constexpr (COOP) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

template <bool COOP>
__device__ __forceinline__ void barrier() {
  if constexpr (COOP) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// u[i] + update, the update rounded once to V
template <bool COOP, typename V>
__device__ __forceinline__ void apply(V* u, int i, double upd) {
  u[i] = add_rn(load_u<COOP>(u + i), to_v(upd, V(0)));
}

// What a pass of a row group reads before it reads u: the row, its
// entry range, this lane's first four entries, its divisor and f.  None
// of it depends on u, so the next wavefront's is loaded before the
// barrier that ends the current one and its latency hides behind it.
template <typename V>
struct Row {
  int i;  // -1: no row for this group in the pass
  int kb, ke;
  int c[4];
  double d[4];
  double di;
  V fi;
};

template <typename V, int S>
__device__ __forceinline__ void fetch(const Args<V>& a, int p, int end,
                                      int lane, Row<V>& r) {
  r.i = -1;
  if (p >= end) return;
  r.i = __ldg(a.order + p);
  r.kb = __ldg(a.indptr + r.i);
  r.ke = __ldg(a.indptr + r.i + 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = r.kb + lane + j * S;
    r.c[j] = k < r.ke ? __ldg(a.indices + k) : 0;
    r.d[j] = k < r.ke ? __ldg(a.data + k) : 0.0;
  }
  r.di = __ldg(a.dinv + r.i);
  r.fi = __ldg(a.f + r.i);
}

template <typename V, bool OMEGA, bool COOP, int S>
__global__ void __launch_bounds__(COOP ? kCoopThreads : kBlockMax)
gs_sweep_kernel(Args<V> a) {
  const int tid = COOP ? blockIdx.x * blockDim.x + threadIdx.x : threadIdx.x;
  const int nthreads = COOP ? gridDim.x * blockDim.x : blockDim.x;
  const int groups = nthreads / S;  // rows a pass
  const int g = tid / S;
  const int lane = tid % S;
  const bool leader = lane == 0;
  Row<V> r;
  fetch<V, S>(a, __ldg(a.wf_ptr) + g, __ldg(a.wf_ptr + 1), lane, r);
  for (int l = 0; l < a.nwf; ++l) {
    const int beg = __ldg(a.wf_ptr + l);
    const int end = __ldg(a.wf_ptr + l + 1);
    const bool two_phase = __ldg(a.hazard + l) != 0;
    for (int p0 = beg; p0 < end; p0 += groups) {
      const int p = p0 + g;
      if (p0 != beg) fetch<V, S>(a, p, end, lane, r);  // a later pass
      double s = 0.0, sp = 0.0;
      if (r.i >= 0) {
        // the lane's entries lane, lane + S, ... in order: four from
        // registers, the rest (rows longer than 4 S) loaded here
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (r.kb + lane + j * S < r.ke) {
            s += r.d[j] * (double)load_u<COOP>(a.u + r.c[j]);
            if constexpr (OMEGA) sp += r.d[j] * (double)__ldg(a.v + r.c[j]);
          }
        }
        for (int k = r.kb + lane + 4 * S; k < r.ke; k += S) {
          const int c = __ldg(a.indices + k);
          const double d = __ldg(a.data + k);
          s += d * (double)load_u<COOP>(a.u + c);
          if constexpr (OMEGA) sp += d * (double)__ldg(a.v + c);
        }
      }
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off, S);
        if constexpr (OMEGA) sp += __shfl_xor_sync(0xffffffffu, sp, off, S);
      }
      if (r.i < 0 || !leader) continue;
      const int i = r.i;
      const double di = r.di;
      double upd;
      if constexpr (!OMEGA) {
        upd = __dmul_rn(__dmul_rn(a.w, di), __dsub_rn((double)r.fi, s));
      } else {
        if (di == 0.0) {
          upd = 0.0;
        } else {
          const double om1 = 1.0 - a.omega;
          const V of = mul_rn((V)a.omega, r.fi);
          const double rr = __dadd_rn(__dsub_rn((double)of, s), __dmul_rn(om1, sp));
          const V du = mul_rn((V)om1, sub_rn(load_u<COOP>(a.u + i), __ldg(a.v + i)));
          upd = __dmul_rn(a.w, __dadd_rn((double)du, __dmul_rn(di, rr)));
        }
      }
      if (two_phase) {
        a.scratch[p] = upd;
      } else {
        apply<COOP>(a.u, i, upd);
      }
    }
    // the next wavefront's first pass, ahead of the barrier
    if (l + 1 < a.nwf) {
      fetch<V, S>(a, end + g, __ldg(a.wf_ptr + l + 2), lane, r);
    }
    if (two_phase) {
      barrier<COOP>();  // every row of the wavefront has read u
      for (int p0 = beg; p0 < end; p0 += groups) {
        const int p = p0 + g;
        if (p < end && leader) apply<COOP>(a.u, __ldg(a.order + p), a.scratch[p]);
      }
    }
    barrier<COOP>();  // the wavefront's values are final
  }
}

template <typename V, bool OMEGA, bool COOP, int S>
int go(const Args<V>& a, int max_width, cudaStream_t stream) {
  auto kern = gs_sweep_kernel<V, OMEGA, COOP, S>;
  const long long want = (long long)max_width * S;  // threads a full pass needs
  if constexpr (!COOP) {
    long long t = (want + 31) / 32 * 32;
    const int threads = (int)(t < 32 ? 32 : (t > kBlockMax ? kBlockMax : t));
    gs_sweep_kernel<V, OMEGA, COOP, S><<<1, threads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  } else {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kCoopThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    // every block resident at once: never more than the occupancy allows
    long long blocks = (want + kCoopThreads - 1) / kCoopThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
    Args<V> args = a;
    void* params[] = {(void*)&args};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)blocks),
                                    dim3(kCoopThreads), params, 0, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
}

template <typename V, bool OMEGA, bool COOP>
int by_lanes(const Args<V>& a, int lanes, int max_width, cudaStream_t st) {
  switch (lanes) {
    case 1: return go<V, OMEGA, COOP, 1>(a, max_width, st);
    case 2: return go<V, OMEGA, COOP, 2>(a, max_width, st);
    case 4: return go<V, OMEGA, COOP, 4>(a, max_width, st);
    case 8: return go<V, OMEGA, COOP, 8>(a, max_width, st);
    case 16: return go<V, OMEGA, COOP, 16>(a, max_width, st);
    case 32: return go<V, OMEGA, COOP, 32>(a, max_width, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename V>
int launch(const void* indptr, const void* indices, const void* data,
           const void* dinv, const void* order, const void* wf_ptr,
           const void* hazard, const void* f, const void* v, void* u,
           void* scratch, double w, double omega, int omega_form, int nwf,
           int max_width, int lanes, int coop, void* stream) {
  const Args<V> a{(const int32_t*)indptr, (const int32_t*)indices,
                  (const double*)data, (const double*)dinv,
                  (const int32_t*)order, (const int32_t*)wf_ptr,
                  (const uint8_t*)hazard, (const V*)f, (const V*)v, (V*)u,
                  (double*)scratch, w, omega, nwf};
  cudaStream_t st = (cudaStream_t)stream;
  if (nwf <= 0) return (int)cudaGetLastError();
  if (omega_form) {
    return coop ? by_lanes<V, true, true>(a, lanes, max_width, st)
                : by_lanes<V, true, false>(a, lanes, max_width, st);
  }
  return coop ? by_lanes<V, false, true>(a, lanes, max_width, st)
              : by_lanes<V, false, false>(a, lanes, max_width, st);
}

}  // namespace

#define GS_ENTRY(DT, V)                                                        \
  extern "C" int gs_sweep_##DT(                                                \
      const void* indptr, const void* indices, const void* data,               \
      const void* dinv, const void* order, const void* wf_ptr,                 \
      const void* hazard, const void* f, const void* v, void* u,               \
      void* scratch, double w, double omega, int omega_form, int nwf,          \
      int max_width, int lanes, int coop, void* stream) {                      \
    return launch<V>(indptr, indices, data, dinv, order, wf_ptr, hazard, f, v, \
                     u, scratch, w, omega, omega_form, nwf, max_width, lanes,  \
                     coop, stream);                                            \
  }

GS_ENTRY(f64, double)
GS_ENTRY(f32, float)
