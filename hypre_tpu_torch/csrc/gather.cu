// Gathers for Hopper (sm_90a): the counterparts of the TPU gather probes
// K2 and K3 in scripts/exp_mosaic_gather.py.
//
//   take_along_axis, axis 1: out[r, c] = x[r mod R, idx[r, c]]
//     K2 (a), :35-39, the lane gather (the probe's pallas_call at :20), and
//     K3 (::k_big, :65-79, its pallas_call at :72), the same over a grid of
//     8 idx blocks with one x block resident: x is [R, C] and idx's rows
//     are a multiple of R.
//   take_along_axis, axis 0: out[r, c] = x[idx[r, c], c mod C]
//     K2 (b), :43-47, the sublane gather; idx's columns are a multiple of C.
//   flat_take:               out[e] = table[idx[e]]  (idx of any shape)
//     K2 (c), :52-57, the flat gather from a 128k-entry table: the gather
//     the ELL SpMV (ell_spmv.cu) performs, there fused with its multiply
//     and reduction.  In the system it is GatherOp's x[pos]
//     (hypre_tpu/ops/dia.py:877; the port's ops/dia.py:811), so it has an
//     f64 instance beside f32.
//
// f32 values (flat_take: f32 or f64), int32 indices.  Indices must lie in
// range (0 <= idx < the gathered extent): the kernels do not check them.
//
// Two forms of each, the same bits (a gather is exact):
//
// * The tiled form (the default; take_along_axis_kernel, flat_take_kernel).
//   What bounds it on this card: for K3, device-memory bytes, 8 an output
//   element (idx in, out back) plus x once, 17.8 MB, 5.32 us at the data
//   sheet's 3.35 TB/s; the earlier form lost its time to integer
//   arithmetic (a 64-bit division and modulo an element, each an emulated
//   sequence) and 4-byte accesses.  For the probes' 32,768 elements, the
//   launch and two dependent memory latencies (idx, then x or the table)
//   from an L2 the timing method (utils/timing.py) has flushed: an empty
//   kernel reads ~5 us there, the bytes 0.12-0.23 us, and the kernel's own
//   code is fetched cold, so a longer kernel pays for its length.  For a
//   flat gather from a table, the scattered table reads (at 2M gathers
//   from a 512 KB table, the L2's rate of sector reads).
//   take_along_axis's design:
//   - The ops/gather_kernel.py plan gives the launch: the instance, the
//     grid, the x rows (axis 1) or the strip of x columns (axis 0) a block
//     owns, the run of output segments it walks, its threads and its
//     shared memory.  A segment is a contiguous run of out (and idx) that
//     reads one staged part of x: a piece of an idx row (axis 1), or the
//     strip's columns of one column tile of an idx row (axis 0).  Blocks
//     (g, b) own group g's segments [b * chunk, (b + 1) * chunk): when x
//     has few rows against the card's SMs, a group's segments spread over
//     several blocks.
//   - The shared instance stages the block's part of x in shared memory
//     once (2 KB for K3's row, 8 KB for K2 (b)'s 32-column strip) with
//     cp.async, issued after the thread's first batch of idx loads, so the
//     two latencies overlap instead of adding.  The L2 instance (a row or
//     a 32-column strip larger than a block's 227 KB) reads x through the
//     read-only path; the plan picks it by shape.
//   - A thread walks quads (4 consecutive output elements of a segment): 16-
//     byte idx loads (__ldcs, read once), the shared-memory reads, 16-byte
//     streaming stores (__stcs).  Consecutive threads take consecutive
//     quads.  With more quads than threads (K3: 8 a thread) the B = 8
//     instance keeps 8 idx loads a thread in flight (64 KB an SM); with a
//     quad or none a thread (K2) the B = 1 instance, whose shorter code
//     the card fetches sooner from memory after an L2 flush.
//     A quad that straddles a segment's end (ic % 4 != 0, a ragged strip)
//     moves its segment's elements as scalars, and the whole launch takes
//     scalars when a pointer is not 16-byte aligned.
//   - 32-bit index arithmetic throughout (the plan refuses outputs and x
//     of 2^31 elements or more); the divisions by launch constants are a
//     multiply-high and a shift (FastDiv).
//   flat_take's tiled form is one element a thread over a grid with a
//   thread for each (the plan's), 32-bit indexing: a gather from a table
//   is bound by its scattered reads or, at the probe's size, by the
//   launch and two latencies, not by the instructions the earlier form
//   spent.  A 16-byte-quad design (idx loads and stores of four, two
//   quads a thread in flight, the grid the card's resident blocks) was
//   slower at every size measured (PERF.md §6) and is not kept; the tiled
//   form ties the elementwise one.
//
// * The elementwise form (the first port's, kept as the reference:
//   take_along_axis_elementwise_kernel, flat_take_elementwise_kernel): one
//   output element a thread in a grid-stride loop over at most 65,535
//   blocks, 64-bit index arithmetic, 4-byte accesses, x through the
//   read-only path.
//
// Plain C interface, loaded with ctypes (hypre_tpu_torch/ops/gather_kernel.py):
// each entry point launches on the given stream, does not synchronize,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- the elementwise form ----------------------------------------------------

template <int AXIS>
__global__ void take_along_axis_elementwise_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t xr, int64_t xc, int64_t ir, int64_t ic) {
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
__global__ void flat_take_elementwise_kernel(const T* __restrict__ table,
                                             const int32_t* __restrict__ idx,
                                             T* __restrict__ out,
                                             int64_t total) {
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

// -- the tiled form ------------------------------------------------------------

constexpr int kTakeThreads = 128;  // at most (TAKE_THREADS)
constexpr int kTakeBatch = 8;      // quads a thread has in flight, large runs
constexpr int kFlatThreads = 256;  // at most (FLAT_THREADS)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n / d for 0 <= n < 2^31 as a multiply-high, add and shift, with m and s
// made on the host (the round-up method CUTLASS's FastDivmod uses).
struct FastDiv {
  uint32_t m, s;
  int32_t d;
  __device__ __forceinline__ int32_t operator()(int32_t n) const {
    return (int32_t)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};

FastDiv fast_div(int32_t d) {
  uint32_t s = 0;
  while ((1u << s) < (uint32_t)d) ++s;
  const uint64_t m = (((uint64_t)1 << 32) * (((uint64_t)1 << s) - d)) / d + 1;
  return FastDiv{(uint32_t)m, s, d};
}

struct TakeArgs {
  const float* x;
  const int32_t* idx;
  float* out;
  int32_t xr, xc, ir, ic;
  int32_t group;  // x rows (axis 1) or strip columns (axis 0) a block owns
  int32_t span;   // axis 1: a segment's elements (a piece of an idx row)
  int32_t chunk;  // segments a block walks
  int32_t vec;    // 1: x, idx and out are 16-byte aligned
  FastDiv quads;  // quads a segment spans (at most)
  FastDiv reps;   // idx rows a row of x serves (axis 1), column tiles (axis 0)
  FastDiv pieces; // axis 1: segments an idx row is cut into
};

// A batch of a thread's quads: the segment's first element and end, the
// x row within the group (axis 1), the quad's first element (-1: none),
// its indices.
template <int B>
struct Batch {
  int4 j[B];
  int32_t a[B], end[B], key[B], e4[B];
};

// A segment of group g0's (axis 1: i = (key * reps + t) * pieces + piece,
// a piece of idx row t * xr + g0 + key; axis 0: i = r * reps + t, the
// strip's columns of column tile t of idx row r): its first element, its
// end and its key.
template <int AXIS>
__device__ __forceinline__ void segment(const TakeArgs& p, int32_t g0,
                                        int32_t gn, int32_t i, int32_t& a,
                                        int32_t& end, int32_t& key) {
  if (AXIS == 1) {
    const int32_t kt = p.pieces(i);
    const int32_t piece = i - kt * p.pieces.d;
    key = p.reps(kt);
    const int32_t row = (kt - key * p.reps.d) * p.xr + g0 + key;
    a = row * p.ic + piece * p.span;
    end = a + min(p.span, p.ic - piece * p.span);
  } else {
    const int32_t r = p.reps(i);
    a = r * p.ic + (i - r * p.reps.d) * p.xc + g0;
    end = a + gn;
    key = 0;
  }
}

template <int AXIS, bool SHARED, int B>
__global__ void __launch_bounds__(kTakeThreads)
take_along_axis_kernel(TakeArgs p) {
  extern __shared__ __align__(16) float xs[];
  // the block's group: x rows [g0, g0 + gn) (axis 1) or columns (axis 0)
  const int32_t g0 = blockIdx.x * p.group;
  const int32_t gn = min(p.group, (AXIS == 1 ? p.xr : p.xc) - g0);
  const int32_t nseg_g =
      AXIS == 1 ? gn * p.reps.d * p.pieces.d : p.ir * p.reps.d;
  const int32_t seg0 = blockIdx.y * p.chunk;
  if (seg0 >= nseg_g) return;  // the whole block: no barrier is skipped
  const int32_t items = min(p.chunk, nseg_g - seg0) * p.quads.d;
  const int32_t nt = blockDim.x, tid = threadIdx.x;

  Batch<B> bt;
  auto load = [&](int32_t w0) {
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int32_t w = w0 + u * nt;
      bt.e4[u] = -1;
      if (w >= items) continue;
      const int32_t sq = p.quads(w);
      int32_t a, end, key;
      segment<AXIS>(p, g0, gn, seg0 + sq, a, end, key);
      const int32_t e4 = (a & ~3) + 4 * (w - sq * p.quads.d);
      if (e4 >= end) continue;  // past the segment's end
      bt.a[u] = a;
      bt.end[u] = end;
      bt.key[u] = key;
      bt.e4[u] = e4;
      if (p.vec && e4 >= a && e4 <= end - 4) {
        bt.j[u] = __ldcs(reinterpret_cast<const int4*>(p.idx + e4));
      } else {
        int32_t jj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          jj[c] = (e4 + c >= a && e4 + c < end) ? __ldcs(p.idx + e4 + c) : 0;
        bt.j[u] = make_int4(jj[0], jj[1], jj[2], jj[3]);
      }
    }
  };
  auto take = [&](int32_t j, int32_t pos, int32_t key) -> float {
    if (AXIS == 1)
      return SHARED ? xs[key * p.xc + j] : __ldg(p.x + (g0 + key) * p.xc + j);
    return SHARED ? xs[j * gn + pos] : __ldg(p.x + j * p.xc + g0 + pos);
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int32_t e4 = bt.e4[u];
      if (e4 < 0) continue;
      const int32_t a = bt.a[u], end = bt.end[u], key = bt.key[u];
      const int32_t jj[4] = {bt.j[u].x, bt.j[u].y, bt.j[u].z, bt.j[u].w};
      if (p.vec && e4 >= a && e4 <= end - 4) {
        float4 v;
        v.x = take(jj[0], e4 - a, key);
        v.y = take(jj[1], e4 + 1 - a, key);
        v.z = take(jj[2], e4 + 2 - a, key);
        v.w = take(jj[3], e4 + 3 - a, key);
        __stcs(reinterpret_cast<float4*>(p.out + e4), v);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (e4 + c >= a && e4 + c < end)
            __stcs(p.out + e4 + c, take(jj[c], e4 + c - a, key));
      }
    }
  };

  load(tid);  // the first batch's idx loads, before the staging
  if (SHARED) {
    if (AXIS == 1) {  // x rows [g0, g0 + gn), contiguous
      const float* src = p.x + g0 * p.xc;
      const int32_t n = gn * p.xc;
      if (p.vec && p.xc % 4 == 0)
        for (int32_t u = tid; u < n / 4; u += nt)
          cp_async16(xs + 4 * u, src + 4 * u);
      else
        for (int32_t u = tid; u < n; u += nt) cp_async4(xs + u, src + u);
    } else {  // x[:, g0:g0 + gn] into xs[row * gn + col]
      if (p.vec && p.xc % 4 == 0) {  // then g0 and gn are multiples of 4
        const int32_t qr = gn / 4;
        for (int32_t u = tid; u < p.xr * qr; u += nt) {
          const int32_t row = u / qr, c = u - row * qr;
          cp_async16(xs + row * gn + 4 * c, p.x + row * p.xc + g0 + 4 * c);
        }
      } else {
        for (int32_t u = tid; u < p.xr * gn; u += nt) {
          const int32_t row = u / gn, c = u - row * gn;
          cp_async4(xs + u, p.x + row * p.xc + g0 + c);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  for (int32_t w0 = tid;;) {
    store();
    w0 += nt * B;
    if (w0 >= items) break;
    load(w0);
  }
}

// One element a thread; the grid-stride loop serves a grid smaller than
// the count (a plan's `blocks` override).
template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
flat_take_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                 T* __restrict__ out, int32_t total) {
  const uint32_t stride = gridDim.x * blockDim.x;
#pragma unroll 1
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
       e < (uint32_t)total; e += stride)
    __stcs(out + e, __ldg(table + __ldcs(idx + e)));
}

template <int AXIS, bool SHARED, int B>
int launch_take(const TakeArgs& p, int64_t gx, int64_t gy, int64_t threads,
                int64_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        take_along_axis_kernel<AXIS, SHARED, B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  take_along_axis_kernel<AXIS, SHARED, B>
      <<<dim3((unsigned)gx, (unsigned)gy), (unsigned)threads, (size_t)smem,
         stream>>>(p);
  return (int)cudaGetLastError();
}

template <int AXIS, bool SHARED>
int launch_take(const TakeArgs& p, int64_t batch, int64_t gx, int64_t gy,
                int64_t threads, int64_t smem, cudaStream_t stream) {
  if (batch == 1)
    return launch_take<AXIS, SHARED, 1>(p, gx, gy, threads, smem, stream);
  if (batch == kTakeBatch)
    return launch_take<AXIS, SHARED, kTakeBatch>(p, gx, gy, threads, smem,
                                                 stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_flat(const void* table, const void* idx, void* out, int64_t total,
                int64_t blocks, int64_t threads, void* stream) {
  if (threads <= 0 || threads > kFlatThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (total <= 0 || blocks <= 0) return (int)cudaGetLastError();
  flat_take_kernel<T><<<(unsigned)blocks, (unsigned)threads, 0,
                        (cudaStream_t)stream>>>(
      (const T*)table, (const int32_t*)idx, (T*)out, (int32_t)total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiled form, from the plan (ops/gather_kernel.py::take_plan):
// `shared` picks the instance and `batch` (1 or 8) the quads a thread has
// in flight, (gx, gy) the grid, `group` / `span` / `chunk` / `quads` what
// a block owns, `threads` and `smem` its threads and bytes; `vec` says
// the pointers are 16-byte aligned.
int take_along_axis_f32(const void* x, const void* idx, void* out, int64_t xr,
                        int64_t xc, int64_t ir, int64_t ic, int axis,
                        int shared, int64_t batch, int64_t gx, int64_t gy,
                        int64_t group, int64_t span, int64_t chunk,
                        int64_t quads, int64_t threads, int64_t smem, int vec,
                        void* stream) {
  if (gx <= 0 || gy <= 0) return (int)cudaGetLastError();
  if (threads <= 0 || threads > kTakeThreads || threads % 32 || quads <= 0 ||
      span <= 0)
    return (int)cudaErrorInvalidValue;
  TakeArgs p;
  p.x = (const float*)x;
  p.idx = (const int32_t*)idx;
  p.out = (float*)out;
  p.xr = (int32_t)xr;
  p.xc = (int32_t)xc;
  p.ir = (int32_t)ir;
  p.ic = (int32_t)ic;
  p.group = (int32_t)group;
  p.span = (int32_t)span;
  p.chunk = (int32_t)chunk;
  p.vec = vec;
  p.quads = fast_div((int32_t)quads);
  p.reps = fast_div((int32_t)(axis == 1 ? ir / xr : ic / xc));
  p.pieces = fast_div((int32_t)(axis == 1 ? (ic + span - 1) / span : 1));
  const cudaStream_t s = (cudaStream_t)stream;
  if (axis == 1)
    return shared ? launch_take<1, true>(p, batch, gx, gy, threads, smem, s)
                  : launch_take<1, false>(p, batch, gx, gy, threads, smem, s);
  return shared ? launch_take<0, true>(p, batch, gx, gy, threads, smem, s)
                : launch_take<0, false>(p, batch, gx, gy, threads, smem, s);
}

// (blocks, threads) the grid, from ops/gather_kernel.py::flat_plan.
int flat_take_f32(const void* table, const void* idx, void* out, int64_t total,
                  int64_t blocks, int64_t threads, void* stream) {
  return launch_flat<float>(table, idx, out, total, blocks, threads, stream);
}

int flat_take_f64(const void* table, const void* idx, void* out, int64_t total,
                  int64_t blocks, int64_t threads, void* stream) {
  return launch_flat<double>(table, idx, out, total, blocks, threads, stream);
}

// The elementwise form.
int take_along_axis_elementwise_f32(const void* x, const void* idx, void* out,
                                    int64_t xr, int64_t xc, int64_t ir,
                                    int64_t ic, int axis, void* stream) {
  if (ir * ic > 0) {
    const unsigned blocks = blocks_for(ir * ic);
    if (axis == 1)
      take_along_axis_elementwise_kernel<1>
          <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
              (const float*)x, (const int32_t*)idx, (float*)out, xr, xc, ir,
              ic);
    else
      take_along_axis_elementwise_kernel<0>
          <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
              (const float*)x, (const int32_t*)idx, (float*)out, xr, xc, ir,
              ic);
  }
  return (int)cudaGetLastError();
}

int flat_take_elementwise_f32(const void* table, const void* idx, void* out,
                              int64_t total, void* stream) {
  if (total > 0)
    flat_take_elementwise_kernel<float>
        <<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)table, (const int32_t*)idx, (float*)out, total);
  return (int)cudaGetLastError();
}

int flat_take_elementwise_f64(const void* table, const void* idx, void* out,
                              int64_t total, void* stream) {
  if (total > 0)
    flat_take_elementwise_kernel<double>
        <<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
            (const double*)table, (const int32_t*)idx, (double*)out, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
