// One level-scheduled Gauss-Seidel sweep for Hopper (sm_90a), one launch:
// for every row i of the schedule (rows grouped in wavefronts: a row reads
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
// the wavefront pointers (`wf_ptr`), each row's wavefront (`wave`, -1
// outside the schedule), `slots` (`order` with each wavefront padded by
// -1 to a multiple of 32 positions) and one hazard flag a wavefront.
// Arithmetic is float64 whatever the vectors' type (the schedule keeps
// the host's float64 values, as the JAX package's does); the update is
// rounded once to the vectors' type and added in it, as the JAX step's
// `.at[rows].add` does.
//
// The read rule, which fixes the result whatever the timing: row i reads
// u_j new if and only if 0 <= wave[j] < wave[i], else the value from
// before the sweep.  It is the JAX step's meaning (at wavefront l, u_ext
// holds the new values of the wavefronts before l).
//
// S lanes a row (1..32, a power of two from the wrapper): lane s sums
// entries s, s+S, ... of its row and the S partial sums meet in a fixed
// xor-shuffle tree, so every run gives the same bits (not the plain
// version's slot order: the two agree to rounding).  Two forms, the same
// per-row arithmetic (row_sums, row_update: lane order, xor tree, f64
// sums, one rounding), so the same bits at the same S:
//
// * The sync-free form (gs_sweep_syncfree_kernel, the default).  No
//   wavefront barrier: each row waits only for the rows it reads new.
//   - Old values come from the input u (read only), new ones from the
//     values the rows publish (below); the result goes to `out`.  A row
//     of the same or a later wavefront reads u, so a nonsymmetric
//     pattern's same-wavefront reads need no second phase.
//   - Completion flags that carry the value: the level's done[n][2]
//     (64-bit words) holds each row's value as the sweep that last
//     finished it published it, beside that sweep's epoch.  The writer
//     stores out[i] and publishes it: a double as two words (its low and
//     high 32 bits, each beside the epoch in the word's high half), a
//     float as one.  A reader polls the words of its entries that the
//     rule reads new with relaxed loads at device scope (through L2)
//     until every word holds this sweep's epoch, and takes the value
//     from them.  Each 64-bit word is read and written whole
//     (single-copy atomic), and only this sweep writes this epoch, so a
//     reader never mixes two sweeps' halves; the value travels with its
//     flag, so no fence and no second load stand on the critical path.
//     (The design this replaced, an int32 flag released after out[i]
//     and polled with acquire loads, then out[j] loaded through L2,
//     costs two more L2 round trips a step; gs_step_probe times both.)
//   - The epoch lives on the device (ctl[0], the level's last sweep):
//     a launch stamps ctl[0] + 1, and the last warp to finish (counted in
//     ctl[1], which it resets) stores the new epoch.  No host value
//     changes between launches, so a sweep can be captured in a CUDA
//     graph.  The stamp wraps at 2^32 (int32 arithmetic modulo 2^32,
//     compared for equality only): a flag could be mistaken for this
//     sweep's only if its row was last finished exactly k * 2^32 sweeps
//     of the level ago, and every row a schedule reads is finished again
//     by every sweep of that schedule.
//   - Forward progress.  A cooperative launch keeps every block resident;
//     warp w takes the passes w, w + W, ... (W warps; a pass is 32 / S
//     consecutive slots, one row each, S lanes a row).  A row waits only
//     on rows of earlier wavefronts, which lie at earlier slots.  By
//     induction on the slot: the unfinished row at the smallest slot
//     waits on finished rows only; so do the other rows of its pass
//     (their wavefronts end before the pass begins, see below); its warp
//     is resident and has finished its earlier passes (smaller slots),
//     so the pass finishes.
//   - The intra-warp trap: were a row and a row that reads it in one
//     pass, the reader's lanes would spin while the writer's lanes wait
//     for them at a shuffle or at the point where the warp's lanes
//     reconverge: a deadlock.  The slots never let a pass straddle two
//     wavefronts (each wavefront starts at a multiple of 32 slots, a pass
//     is 32 / S slots and aligned), so no row of a pass reads another
//     row of it; the S lanes of a row vote and reduce with their own
//     group's mask.
//   - Poll rounds: a warp polls its pending rows together, one round (one
//     L2 round trip) at a time, and a row whose lanes hold all their
//     values is summed and published in that round.  A row never waits
//     for the other rows of its pass: had the warp reconverged after
//     each row's wait, every row would be published at its pass's
//     slowest, and that delay would add up along the wavefronts.
//   - Every spin is bounded: past kPollLimit rounds a warp writes a
//     fault code (1 + a pending row's slot) into the fault word and
//     finishes its pending rows with what they have; every kFaultCheck
//     rounds a waiting warp reads that word and does the same once it is
//     set.  A bug shows as a fault, not a hang; the wrapper's callers
//     read the word after a synchronize.
// * The wavefront form (gs_sweep_kernel, the reference form kept from the
//   first port): the wavefronts in order with a barrier between them, in
//   ONE block (__syncthreads) for narrow levels or a cooperative grid
//   (grid sync, u through L2) for wide ones; every thread runs the same
//   passes, so all reach the shuffles and barriers; the next wavefront's
//   row metadata (no u in it) is loaded before the barrier; a wavefront
//   whose rows read each other (a hazard) runs in two phases through
//   `scratch`; it updates `out` (a copy of u) in place, only the rows in
//   `order`.
//
// What bounds it: latency, not bytes.  A sweep is a chain of dependent
// wavefronts (286 on the 96^3 fine level, 862 on its level 2); the bytes
// (the CSR once, the vectors) take ~33 us on the fine level at 3.35 TB/s.
// The wavefront form pays a barrier and an L2 round trip a wavefront
// (0.9-3.1 us on the 96^3 levels); the sync-free form one cross-SM step
// (publish, poll) and a row's reduction a wavefront on the critical
// path.  gs_step_probe measures that step, t_step (two warps on two
// SMs, ping-pong: 0.48 us, against 0.96 for the flag design, on an
// H100 80GB HBM3 at 700 W); chip_smoke.py times every level's sweep
// beside the bytes bound and the latency bound (wavefronts x t_step).
// On that card a f64 96^3 V-cycle's 14 sweeps take 4.2 ms in the
// sync-free form (0.65-0.76 us a wavefront on levels 1-5, 1.47 on
// level 0) against 11.1 ms in the wavefront form.
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/gs_kernel.py):
// entry points per vector type and form; each launches on the given
// stream, does not synchronize, and returns the launch's CUDA error (0 on
// success; cudaErrorInvalidValue for a lane count it does not take).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockMax = 1024;    // threads of the one-block form
constexpr int kCoopThreads = 256;  // threads a block of the grid form
constexpr int kFreeThreads = 256;  // threads a block of the sync-free form
constexpr unsigned kPollLimit = 1u << 20;  // polls before a lane gives up
constexpr unsigned kFaultCheck = 1024;     // polls between fault-word reads

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

template <typename V>
struct FreeArgs {
  const int32_t* indptr;
  const int32_t* indices;
  const double* data;
  const double* dinv;
  const int32_t* slots;  // the schedule's rows, wavefronts padded by -1
  const int32_t* wave;   // [n] each row's wavefront, -1 outside
  const V* f;
  const V* v;
  const V* u;     // before the sweep; read only
  V* out;         // after the sweep; the scheduled rows written
  uint64_t* done;  // [n][2] each row's published value and epoch
  int32_t* ctl;   // [2] the level's epoch; this launch's arrivals
  int32_t* fault;
  double w;
  double omega;
  int nslots;  // slots of the schedule
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float to_v(double x, float) { return __double2float_rn(x); }
__device__ __forceinline__ double to_v(double x, double) { return x; }

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Wait until *flag == epoch (acquire): the flag design's wait, which
// only the probe runs now.  Bounded: past kPollLimit polls the fault
// word takes `code` (if it holds none) and the wait ends; a lane that
// finds the word set stops waiting too.
__device__ __forceinline__ void wait_flag(const int32_t* flag, int epoch,
                                          int32_t* fault, int code) {
  unsigned polls = 0;
  while (ld_acquire(flag) != epoch) {
    if (++polls % kFaultCheck == 0) {
      if (polls >= kPollLimit) {
        atomicCAS(fault, 0, code);
        return;
      }
      if (ld_relaxed(fault) != 0) return;
    }
  }
}

// A row's value published with the epoch of the sweep that wrote it: a
// double as two 64-bit words {epoch:32 | low 32 bits} {epoch:32 | high
// 32 bits}, a float as one {epoch:32 | its 32 bits}.
__device__ __forceinline__ void publish(uint64_t* p, int epoch, double x) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  const unsigned long long e = (unsigned long long)(unsigned)epoch << 32;
  asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};" ::"l"(p),
               "l"(e | (b & 0xffffffffull)), "l"(e | (b >> 32))
               : "memory");
}

__device__ __forceinline__ void publish(uint64_t* p, int epoch, float x) {
  const unsigned long long e = (unsigned long long)(unsigned)epoch << 32;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p),
               "l"(e | (unsigned long long)__float_as_uint(x))
               : "memory");
}

// One poll of a published value: its words (a float's one word twice)
__device__ __forceinline__ void peek(const uint64_t* p, uint64_t& w0,
                                     uint64_t& w1, double) {
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
               : "=l"(w0), "=l"(w1)
               : "l"(p)
               : "memory");
}

__device__ __forceinline__ void peek(const uint64_t* p, uint64_t& w0,
                                     uint64_t& w1, float) {
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w0) : "l"(p) : "memory");
  w1 = w0;
}

__device__ __forceinline__ bool stamped(uint64_t w0, uint64_t w1, int epoch) {
  return (unsigned)(w0 >> 32) == (unsigned)epoch &&
         (unsigned)(w1 >> 32) == (unsigned)epoch;
}

__device__ __forceinline__ double unpack(uint64_t w0, uint64_t w1, double) {
  return __longlong_as_double((long long)((w1 << 32) | (w0 & 0xffffffffull)));
}

__device__ __forceinline__ float unpack(uint64_t w0, uint64_t, float) {
  return __uint_as_float((unsigned)w0);
}

// Poll one published value (the words at p) until it holds `epoch`.
// Bounded like wait_flag: past kPollLimit polls the fault word takes
// `code` and the wait ends (with V(0)).
template <typename V>
__device__ __forceinline__ V wait_value(const uint64_t* p, int epoch,
                                        int32_t* fault, int code) {
  uint64_t w0, w1;
  unsigned polls = 0;
  for (;;) {
    peek(p, w0, w1, V(0));
    if (stamped(w0, w1, epoch)) return unpack(w0, w1, V(0));
    if (++polls % kFaultCheck == 0) {
      if (polls >= kPollLimit) {
        atomicCAS(fault, 0, code);
        return V(0);
      }
      if (ld_relaxed(fault) != 0) return V(0);
    }
  }
}

// u as the wavefront form reads it: through L2 in the grid form (other
// SMs wrote it), through the block's own L1 in the one-block form
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

// What a pass of a row group reads before it reads u: the row, its
// entry range, this lane's first four entries, its divisor and f.  None
// of it depends on u, so the wavefront form loads the next wavefront's
// before the barrier that ends the current one.
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
__device__ __forceinline__ void fetch_row(int i, const int32_t* indptr,
                                          const int32_t* indices,
                                          const double* data,
                                          const double* dinv, const V* f,
                                          int lane, Row<V>& r) {
  r.i = i;
  r.kb = __ldg(indptr + r.i);
  r.ke = __ldg(indptr + r.i + 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = r.kb + lane + j * S;
    r.c[j] = k < r.ke ? __ldg(indices + k) : 0;
    r.d[j] = k < r.ke ? __ldg(data + k) : 0.0;
  }
  r.di = __ldg(dinv + r.i);
  r.fi = __ldg(f + r.i);
}

template <typename V, int S>
__device__ __forceinline__ void fetch(const int32_t* order,
                                      const int32_t* indptr,
                                      const int32_t* indices,
                                      const double* data, const double* dinv,
                                      const V* f, int p, int end, int lane,
                                      Row<V>& r) {
  r.i = -1;
  if (p >= end) return;
  fetch_row<V, S>(__ldg(order + p), indptr, indices, data, dinv, f, lane, r);
}

// The lane's partial sums of a row: its entries lane, lane + S, ... in
// order, four from registers (x(j, col) gives the value of entry j) and
// the rest (rows longer than 4 S) loaded here (x(-1, col)).  Both forms
// sum through this function, so they give the same bits.
template <typename V, bool OMEGA, int S, typename X>
__device__ __forceinline__ void row_sums(const Row<V>& r, int lane,
                                         const int32_t* indices,
                                         const double* data, const V* v,
                                         X x, double& s, double& sp) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r.kb + lane + j * S < r.ke) {
      s += r.d[j] * (double)x(j, r.c[j]);
      if constexpr (OMEGA) sp += r.d[j] * (double)__ldg(v + r.c[j]);
    }
  }
  for (int k = r.kb + lane + 4 * S; k < r.ke; k += S) {
    const int c = __ldg(indices + k);
    const double d = __ldg(data + k);
    s += d * (double)x(-1, c);
    if constexpr (OMEGA) sp += d * (double)__ldg(v + c);
  }
}

// The row's update, before its one rounding to V (ui, vi: u[i] and v[i]
// from before the sweep; vi unused in the plain form)
template <typename V, bool OMEGA>
__device__ __forceinline__ double row_update(double w, double omega,
                                             const Row<V>& r, double s,
                                             double sp, V ui, V vi) {
  if constexpr (!OMEGA) {
    return __dmul_rn(__dmul_rn(w, r.di), __dsub_rn((double)r.fi, s));
  } else {
    if (r.di == 0.0) return 0.0;
    const double om1 = 1.0 - omega;
    const V of = mul_rn((V)omega, r.fi);
    const double rr = __dadd_rn(__dsub_rn((double)of, s), __dmul_rn(om1, sp));
    const V du = mul_rn((V)om1, sub_rn(ui, vi));
    return __dmul_rn(w, __dadd_rn((double)du, __dmul_rn(r.di, rr)));
  }
}

// ---------------------------------------------------------------------------
// The sync-free form
// ---------------------------------------------------------------------------

template <typename V, bool OMEGA, int S>
__global__ void __launch_bounds__(kFreeThreads)
gs_sweep_syncfree_kernel(FreeArgs<V> a) {
  constexpr int R = 32 / S;  // rows a warp's pass
  const int lane32 = threadIdx.x & 31;
  const int grp = lane32 / S;
  const int lane = lane32 % S;
  // the group's own lanes: its votes and shuffles wait for no other group
  const unsigned gmask =
      S == 32 ? 0xffffffffu : ((1u << (S & 31)) - 1u) << (grp * S);
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  // this sweep's stamp (modulo 2^32)
  const int epoch = (int)((unsigned)ld_relaxed(a.ctl) + 1u);
  for (long long p0 = warp * R; p0 < a.nslots; p0 += nwarps * R) {
    const long long p = p0 + grp;
    const int i = p < a.nslots ? __ldg(a.slots + p) : -1;  // -1: a pad
    bool pending = i >= 0;  // the group's row is not yet published
    Row<V> r;
    int wi = 0;
    V ui = V(0), vi = V(0);
    bool nw[4];  // which of the lane's four register entries are read new
    V xr[4];     // their values
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nw[j] = false;
      xr[j] = V(0);
    }
    if (pending) {
      fetch_row<V, S>(i, a.indptr, a.indices, a.data, a.dinv, a.f, lane, r);
      wi = __ldg(a.wave + i);
      ui = __ldg(a.u + i);
      if constexpr (OMEGA) vi = __ldg(a.v + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r.kb + lane + j * S < r.ke) {
          const int wc = __ldg(a.wave + r.c[j]);
          nw[j] = wc >= 0 && wc < wi;
          if (!nw[j]) xr[j] = __ldg(a.u + r.c[j]);
        }
      }
    }
    const int code = (int)(p + 1);  // 1 + the slot, if a wait gives up
    // Poll rounds, the whole warp together: each round every pending
    // row's lanes load the words they still wait for (one L2 round trip
    // for all), and a row whose lanes all have their values is summed
    // and published in that round, whatever its neighbours in the warp
    // still wait for.
    unsigned polls = 0;
    bool give_up = false;
    while (__any_sync(0xffffffffu, pending)) {
      if (pending) {
        uint64_t w0[4], w1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nw[j] && !give_up)
            peek(a.done + 2 * (size_t)r.c[j], w0[j], w1[j], V(0));
        bool have = true;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!nw[j]) continue;
          if (give_up) {
            nw[j] = false;
          } else if (stamped(w0[j], w1[j], epoch)) {
            xr[j] = unpack(w0[j], w1[j], V(0));
            nw[j] = false;
          } else {
            have = false;
          }
        }
        if (__all_sync(gmask, have)) {
          // entries past the four in registers (rows longer than 4 S)
          // wait here, one at a time
          const auto x = [&](int j, int c) -> V {
            if (j >= 0) return xr[j];
            const int wc = __ldg(a.wave + c);
            if (wc >= 0 && wc < wi)
              return wait_value<V>(a.done + 2 * (size_t)c, epoch, a.fault, code);
            return __ldg(a.u + c);
          };
          double s = 0.0, sp = 0.0;
          row_sums<V, OMEGA, S>(r, lane, a.indices, a.data, a.v, x, s, sp);
#pragma unroll
          for (int off = S / 2; off > 0; off >>= 1) {
            s += __shfl_xor_sync(gmask, s, off, S);
            if constexpr (OMEGA) sp += __shfl_xor_sync(gmask, sp, off, S);
          }
          if (lane == 0) {
            const double upd = row_update<V, OMEGA>(a.w, a.omega, r, s, sp, ui, vi);
            const V o = add_rn(ui, to_v(upd, V(0)));
            a.out[i] = o;
            publish(a.done + 2 * (size_t)i, epoch, o);  // out[i] is final
          }
          pending = false;
        }
      }
      // bounded: past kPollLimit rounds (or once another wait gave up)
      // the rows still pending are finished with what they have
      if (++polls % kFaultCheck == 0 && !give_up) {
        if (polls >= kPollLimit) {
          if (pending && lane == 0) atomicCAS(a.fault, 0, code);
          give_up = true;
        } else if (ld_relaxed(a.fault) != 0) {
          give_up = true;
        }
      }
    }
  }
  // every thread has read the epoch and finished its rows: the last warp
  // of the launch stores the new epoch and resets the arrivals
  __syncwarp();
  if (lane32 == 0) {
    const int before = atomicAdd(a.ctl + 1, 1);
    if (before == (int)nwarps - 1) {
      a.ctl[1] = 0;
      a.ctl[0] = epoch;
    }
  }
}

// ---------------------------------------------------------------------------
// The wavefront form (the reference)
// ---------------------------------------------------------------------------

template <typename V, bool OMEGA, bool COOP, int S>
__global__ void __launch_bounds__(COOP ? kCoopThreads : kBlockMax)
gs_sweep_kernel(Args<V> a) {
  const int tid = COOP ? blockIdx.x * blockDim.x + threadIdx.x : threadIdx.x;
  const int nthreads = COOP ? gridDim.x * blockDim.x : blockDim.x;
  const int groups = nthreads / S;  // rows a pass
  const int g = tid / S;
  const int lane = tid % S;
  const bool leader = lane == 0;
  const auto x = [&](int, int c) -> V { return load_u<COOP>(a.u + c); };
  Row<V> r;
  fetch<V, S>(a.order, a.indptr, a.indices, a.data, a.dinv, a.f,
              __ldg(a.wf_ptr) + g, __ldg(a.wf_ptr + 1), lane, r);
  for (int l = 0; l < a.nwf; ++l) {
    const int beg = __ldg(a.wf_ptr + l);
    const int end = __ldg(a.wf_ptr + l + 1);
    const bool two_phase = __ldg(a.hazard + l) != 0;
    for (int p0 = beg; p0 < end; p0 += groups) {
      const int p = p0 + g;
      if (p0 != beg)  // a later pass
        fetch<V, S>(a.order, a.indptr, a.indices, a.data, a.dinv, a.f, p,
                    end, lane, r);
      double s = 0.0, sp = 0.0;
      if (r.i >= 0) row_sums<V, OMEGA, S>(r, lane, a.indices, a.data, a.v, x, s, sp);
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off, S);
        if constexpr (OMEGA) sp += __shfl_xor_sync(0xffffffffu, sp, off, S);
      }
      if (r.i < 0 || !leader) continue;
      const int i = r.i;
      const V ui = load_u<COOP>(a.u + i);
      const double upd = row_update<V, OMEGA>(
          a.w, a.omega, r, s, sp, ui, OMEGA ? __ldg(a.v + i) : V(0));
      if (two_phase) {
        a.scratch[p] = upd;
      } else {
        a.u[i] = add_rn(ui, to_v(upd, V(0)));
      }
    }
    // the next wavefront's first pass, ahead of the barrier
    if (l + 1 < a.nwf) {
      fetch<V, S>(a.order, a.indptr, a.indices, a.data, a.dinv, a.f, end + g,
                  __ldg(a.wf_ptr + l + 2), lane, r);
    }
    if (two_phase) {
      barrier<COOP>();  // every row of the wavefront has read u
      for (int p0 = beg; p0 < end; p0 += groups) {
        const int p = p0 + g;
        if (p < end && leader) {
          const int i = __ldg(a.order + p);
          a.u[i] = add_rn(load_u<COOP>(a.u + i), to_v(a.scratch[p], V(0)));
        }
      }
    }
    barrier<COOP>();  // the wavefront's values are final
  }
}

// Blocks of a cooperative launch of `kern`: enough for `want` threads,
// never more than can be resident at once (0 or below on error, the
// negated CUDA error).
template <typename K>
long long coop_blocks(K kern, int threads, long long want, int cap) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, 0);
  if (e != cudaSuccess) return -(long long)e;
  if (!coop) return -(long long)cudaErrorNotSupported;
  if (per_sm < 1) return -(long long)cudaErrorCooperativeLaunchTooLarge;
  long long blocks = (want + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (cap > 0 && blocks > cap) blocks = cap;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  return blocks;
}

template <typename K, typename A>
int coop_launch(K kern, long long blocks, int threads, const A& a,
                cudaStream_t stream) {
  A args = a;
  void* params[] = {(void*)&args};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kern, dim3((unsigned)blocks), dim3(threads), params, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
    const long long blocks = coop_blocks(kern, kCoopThreads, want, 0);
    if (blocks <= 0) return (int)-blocks;
    return coop_launch(kern, blocks, kCoopThreads, a, stream);
  }
}

template <typename V, bool OMEGA>
int go_free(const FreeArgs<V>& a, int lanes, int max_blocks, cudaStream_t st) {
  const auto run = [&](auto kern, int s) {
    // S threads a slot: no more warps than passes
    const long long blocks =
        coop_blocks(kern, kFreeThreads, (long long)a.nslots * s, max_blocks);
    if (blocks <= 0) return (int)-blocks;
    return coop_launch(kern, blocks, kFreeThreads, a, st);
  };
  switch (lanes) {
    case 1: return run(gs_sweep_syncfree_kernel<V, OMEGA, 1>, 1);
    case 2: return run(gs_sweep_syncfree_kernel<V, OMEGA, 2>, 2);
    case 4: return run(gs_sweep_syncfree_kernel<V, OMEGA, 4>, 4);
    case 8: return run(gs_sweep_syncfree_kernel<V, OMEGA, 8>, 8);
    case 16: return run(gs_sweep_syncfree_kernel<V, OMEGA, 16>, 16);
    case 32: return run(gs_sweep_syncfree_kernel<V, OMEGA, 32>, 32);
    default: return (int)cudaErrorInvalidValue;
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

template <typename V>
int launch_free(const void* indptr, const void* indices, const void* data,
                const void* dinv, const void* slots, const void* wave,
                const void* f, const void* v, const void* u, void* out,
                void* done, void* ctl, void* fault, double w, double omega,
                int omega_form, int nslots, int lanes, int max_blocks,
                void* stream) {
  // done: uint64 [n][2], 16-byte aligned (each row's two words in one
  // aligned pair)
  const FreeArgs<V> a{(const int32_t*)indptr, (const int32_t*)indices,
                      (const double*)data, (const double*)dinv,
                      (const int32_t*)slots, (const int32_t*)wave,
                      (const V*)f, (const V*)v, (const V*)u, (V*)out,
                      (uint64_t*)done, (int32_t*)ctl, (int32_t*)fault, w,
                      omega, nslots};
  cudaStream_t st = (cudaStream_t)stream;
  if (nslots <= 0) return (int)cudaGetLastError();
  return omega_form ? go_free<V, true>(a, lanes, max_blocks, st)
                    : go_free<V, false>(a, lanes, max_blocks, st);
}

// ---------------------------------------------------------------------------
// t_step: one cross-SM step of the sync-free form, measured
// ---------------------------------------------------------------------------

// Two blocks of one warp, each on its own SM (each asks for more than
// half an SM's shared memory), pass a value back and forth `rounds`
// times.  mode 1, the sync-free kernel's step: publish the value with
// its epoch (relaxed 64-bit words); the other polls the words (relaxed,
// through L2) until they hold the epoch.  mode 0, the flag design it
// replaced: store the value, release an int32 flag; the other polls the
// flag with acquire loads, then loads the value through L2.  Block 0
// reads the global timer around the rounds.  buf (64 bytes, zeroed):
// int32 flags [3] at 0 (flags[2] the fault word), float64 values [2] at
// 16, the published words [2][2] at 32.  res[0] = ns, res[1] = values
// that arrived wrong or polls that gave up, res[2], res[3] = the two
// blocks' SMs.
__global__ void gs_step_probe_kernel(char* buf, int rounds, int mode,
                                     long long* res) {
  extern __shared__ char keep_apart[];
  if (threadIdx.x != 0) return;
  const int me = blockIdx.x, other = 1 - me;
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  res[2 + me] = smid;
  keep_apart[0] = 0;
  int32_t* flags = (int32_t*)buf;
  double* vals = (double*)(buf + 16);
  uint64_t* words = (uint64_t*)(buf + 32);
  int32_t* fault = flags + 2;
  long long bad = 0;
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int k = 1; k <= rounds; ++k) {
    for (int turn = 0; turn < 2; ++turn) {
      if ((turn == 0) == (me == 0)) {  // send
        if (mode == 0) {
          vals[me] = (double)k;
          st_release(flags + me, k);
        } else {
          publish(words + 2 * me, k, (double)k);
        }
      } else {  // receive
        double x;
        if (mode == 0) {
          wait_flag(flags + other, k, fault, 1);
          x = __ldcg(vals + other);
        } else {
          x = wait_value<double>(words + 2 * other, k, fault, 1);
        }
        bad += x != (double)k;
      }
    }
    if (ld_relaxed(fault) != 0) break;
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (me == 0) res[0] = (long long)(t1 - t0);
  if (me == 0) bad += ld_relaxed(fault) != 0;
  if (bad) atomicAdd((unsigned long long*)(res + 1), (unsigned long long)bad);
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
  }                                                                            \
  extern "C" int gs_syncfree_##DT(                                             \
      const void* indptr, const void* indices, const void* data,               \
      const void* dinv, const void* slots, const void* wave, const void* f,    \
      const void* v, const void* u, void* out, void* done, void* ctl,          \
      void* fault, double w, double omega, int omega_form, int nslots,         \
      int lanes, int max_blocks, void* stream) {                               \
    return launch_free<V>(indptr, indices, data, dinv, slots, wave, f, v, u,   \
                          out, done, ctl, fault, w, omega, omega_form, nslots, \
                          lanes, max_blocks, stream);                          \
  }

GS_ENTRY(f64, double)
GS_ENTRY(f32, float)

// buf: 64 bytes zeroed, res: int64 [4] zeroed, mode 0 (flag, acquire,
// load) or 1 (published words); one cooperative launch of two blocks
// (both resident, on two SMs)
extern "C" int gs_step_probe(void* buf, int rounds, int mode, void* res,
                             void* stream) {
  const int smem = 160 * 1024;  // over half of an SM's 228 KB
  cudaError_t e = cudaFuncSetAttribute(
      gs_step_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  char* b = (char*)buf;
  long long* r = (long long*)res;
  void* params[] = {(void*)&b, (void*)&rounds, (void*)&mode, (void*)&r};
  e = cudaLaunchCooperativeKernel((const void*)gs_step_probe_kernel, dim3(2),
                                  dim3(32), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
