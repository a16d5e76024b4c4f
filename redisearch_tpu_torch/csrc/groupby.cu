// GROUPBY kernels for Hopper (sm_90a): the batched per-query sums (B3,
// below) and the single-query sums and min/max (B4 and B5, after it).
//
// ---- B3: batched per-query sums
//
// Replaces the Pallas TPU kernel `redisearch_tpu/ops/groupby.py`
// `_sums_batch_kernel` (entry `groupby_aggregate_batch`).  It computes
// what that kernel computes, not the way it computes it: the TPU version
// builds bf16 one-hot tiles and contracts them on the MXU with a
// two-term bf16 split, because the TPU has no fast scatter.  This card
// has one, so each query's groups are histogram bins filled with
// atomics.
//
// Inputs, per query b of B: gslots int32 [B, S, n] (slot 0 = the base
// rows, slot 1+j = op j's rows; a gid outside [0, G_pad) is skipped) and
// vals f32 [B, S-1, n].  Output f32 [B, C, G_pad], C = 1 + (S-1) *
// (2 + want_sumsq): channel 0 the base count, then per op its count, sum
// and (optional) sum of squares.
//
// Design (a simple, correct first version):
//   * one block per query; blocks walk queries blockIdx.x,
//     blockIdx.x + gridDim.x, ... (the grid is capped by the wrapper);
//   * shared-memory branch, when C * G_pad * 4 bytes fit in dynamic
//     shared memory (up to 227 KB, opted in with cudaFuncSetAttribute
//     above 48 KB): zero the histogram, walk the n lanes of every slot
//     with atomicAdd into it, then write the whole row out with plain
//     stores;
//   * global branch, for larger group spaces (the pipeline allows up to
//     65,536 groups, about 3 MB a query): zero the query's own output
//     row, barrier, atomicAdd straight into it.
//
// Order of sums: float atomics add in no fixed order.  Counts are exact
// (integers far below 2^24).  Sums of integer-valued f32 whose partial
// sums stay below 2^24 are exact whatever the order (bench prices are
// integers in 1..9,999).  For general inputs a sum differs from an
// in-order sum by at most a few f32 roundings of the group's running
// total: hold it to rtol 1e-5 of the group's sum of |v|.
//
// What bounds it on this card: shared-memory atomic contention on hot
// groups (all lanes of one group serialise on one bank word) and one
// block per query (a batch smaller than the card's ~2 blocks per SM
// leaves SMs idle).  Later work: warp-aggregated atomics (__match_any
// over gids, one atomic per distinct gid per warp), a sort-by-gid
// segmented reduce, or fusing with the raw intersection so the
// [B, W_raw] lanes never reach device memory.
//
// Built by redisearch_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
groupby_kernel(const int* __restrict__ gslots, const float* __restrict__ vals,
               float* __restrict__ out, int B, int S, long long n, int G_pad,
               int want_sumsq) {
  extern __shared__ float s_hist[];
  const int per_op = 2 + want_sumsq;
  const long long row = (long long)(1 + (S - 1) * per_op) * G_pad;

  for (int q = blockIdx.x; q < B; q += gridDim.x) {
    float* h = SMEM ? s_hist : out + (long long)q * row;
    __syncthreads();   // the previous query is done with the histogram
    for (long long i = threadIdx.x; i < row; i += THREADS) h[i] = 0.0f;
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      const int* g = gslots + ((long long)q * S + s) * n;
      const float* v =
          s > 0 ? vals + ((long long)q * (S - 1) + (s - 1)) * n : nullptr;
      float* hc = h + (s == 0 ? 0 : (long long)(1 + (s - 1) * per_op) * G_pad);
      for (long long i = threadIdx.x; i < n; i += THREADS) {
        const int gid = g[i];
        if (gid < 0 || gid >= G_pad) continue;
        atomicAdd(hc + gid, 1.0f);
        if (s > 0) {
          const float x = v[i];
          atomicAdd(hc + G_pad + gid, x);
          if (want_sumsq) atomicAdd(hc + 2 * G_pad + gid, x * x);
        }
      }
    }
    if (SMEM) {
      __syncthreads();
      float* o = out + (long long)q * row;
      for (long long i = threadIdx.x; i < row; i += THREADS) o[i] = h[i];
    }
  }
}

// ---- B4 and B5: one query's count/sum/sumsq and min/max per group
//
// Replace the Pallas TPU kernels `redisearch_tpu/ops/groupby.py`
// `_sums_kernel` (B4) and `_minmax_kernel` (B5), entry `groupby_aggregate`
// (via `_groupby_pallas`), which the window program's fused aggregation
// (`agg/pipeline.py` `_make_fused`) calls once per (query, reducer
// operand).  Inputs: gids int32 [n] (-1 or >= G_pad = skip; the wrapper
// masks invalid rows to -1) and values f32 [n] (0 on skipped rows), n up
// to a segment's n_pad (about 1M), G_pad <= 65,536.
//
// The TPU kernels contract bf16 one-hot tiles on the MXU (sums, with a
// two-term bf16 split) and run a masked [chunk, 128] reduce per group
// tile (min/max).  Here: a grid-stride pass over the rows sized to fill
// the 132 SMs; each block histograms its rows in shared memory when the
// group space fits (3 * G_pad * 4 bytes <= 227 KB: G up to about 19k),
// then merges its non-empty groups into the output with global atomics;
// above that it updates the output with global atomics directly.  Min and
// max are float atomics by the sign trick (atomicMin on the int bits of a
// non-negative float, atomicMax on the unsigned bits of a negative one),
// after -0.0 is made +0.0 (equal under the reference's minimum); a NaN
// value sets the group's flag, and the wrapper turns flagged groups'
// min and max into NaN, as jnp.minimum / jnp.maximum propagate it.  The
// wrapper initialises the outputs: sums to 0, min/max to +3.4e38 /
// -3.4e38 (the empty-group identities).
//
// Bounds: one read of the [n] gids and values (8 bytes a row: 2.4 us at
// 1M rows and 3.35 TB/s) against atomic contention on hot groups (all
// rows of one group serialise on one shared-memory word) and the merge
// (grid x non-empty groups global atomics).  Later work: warp-aggregated
// atomics (__match_any_sync over the gids), a sort-by-gid segmented
// reduce, and one pass for the base count and every operand of a query.

constexpr int T1 = 256;
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ void atomic_min_f(float* a, float v) {
  if (v >= 0.0f) {
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_f(float* a, float v) {
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(T1)
gb_sums_kernel(const int* __restrict__ gids, const float* __restrict__ vals,
               float* __restrict__ out, long long n, int G_pad) {
  extern __shared__ float s_sums[];
  float* h = SMEM ? s_sums : out;
  if (SMEM) {
    for (int i = threadIdx.x; i < 3 * G_pad; i += T1) s_sums[i] = 0.0f;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * T1;
  for (long long i = (long long)blockIdx.x * T1 + threadIdx.x; i < n;
       i += stride) {
    const int g = gids[i];
    if (g < 0 || g >= G_pad) continue;
    const float x = vals[i];
    atomicAdd(h + g, 1.0f);
    atomicAdd(h + G_pad + g, x);
    atomicAdd(h + 2 * G_pad + g, x * x);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < G_pad; i += T1) {
      const float c = s_sums[i];
      if (c == 0.0f) continue;
      atomicAdd(out + i, c);
      atomicAdd(out + G_pad + i, s_sums[G_pad + i]);
      atomicAdd(out + 2 * G_pad + i, s_sums[2 * G_pad + i]);
    }
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(T1)
gb_minmax_kernel(const int* __restrict__ gids, const float* __restrict__ vals,
                 float* __restrict__ out, int* __restrict__ nan_flag,
                 long long n, int G_pad) {
  extern __shared__ float s_mm[];
  float* mn = SMEM ? s_mm : out;
  float* mx = SMEM ? s_mm + G_pad : out + G_pad;
  int* nf = SMEM ? reinterpret_cast<int*>(s_mm + 2 * G_pad) : nan_flag;
  if (SMEM) {
    for (int i = threadIdx.x; i < G_pad; i += T1) {
      mn[i] = BIG;
      mx[i] = -BIG;
      nf[i] = 0;
    }
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * T1;
  for (long long i = (long long)blockIdx.x * T1 + threadIdx.x; i < n;
       i += stride) {
    const int g = gids[i];
    if (g < 0 || g >= G_pad) continue;
    const float x = vals[i];
    if (isnan(x)) {
      nf[g] = 1;    // every writer stores 1
      continue;
    }
    const float y = x + 0.0f;   // -0.0 -> +0.0
    atomic_min_f(mn + g, y);
    atomic_max_f(mx + g, y);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < G_pad; i += T1) {
      if (nf[i]) nan_flag[i] = 1;
      if (mn[i] <= mx[i]) {
        atomic_min_f(out + i, mn[i]);
        atomic_max_f(out + G_pad + i, mx[i]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  With
// use_smem the histogram row lives in dynamic shared memory (the wrapper
// checks that it fits); otherwise the kernel accumulates in `out`.
int rs_groupby_launch(const void* gslots, const void* vals, void* out, int B,
                      int S, long long n, int G_pad, int want_sumsq, int grid,
                      int use_smem, void* stream) {
  if (grid < 1 || S < 1 || G_pad < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gslots);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  if (use_smem) {
    const size_t bytes =
        (size_t)(1 + (S - 1) * (2 + want_sumsq)) * G_pad * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        groupby_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    groupby_kernel<true><<<grid, THREADS, bytes, st>>>(g, v, o, B, S, n,
                                                       G_pad, want_sumsq);
  } else {
    groupby_kernel<false><<<grid, THREADS, 0, st>>>(g, v, o, B, S, n, G_pad,
                                                    want_sumsq);
  }
  return (int)cudaGetLastError();
}

// B4: count/sum/sumsq of one query into out f32 [3, G_pad] (zeroed by
// the caller).  Returns cudaGetLastError() (0 = launched).
int rs_gb_sums_launch(const void* gids, const void* vals, void* out,
                      long long n, int G_pad, int grid, int use_smem,
                      void* stream) {
  if (grid < 1 || G_pad < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  if (use_smem) {
    const size_t bytes = (size_t)3 * G_pad * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        gb_sums_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    gb_sums_kernel<true><<<grid, T1, bytes, st>>>(g, v, o, n, G_pad);
  } else {
    gb_sums_kernel<false><<<grid, T1, 0, st>>>(g, v, o, n, G_pad);
  }
  return (int)cudaGetLastError();
}

// B5: min/max of one query into out f32 [2, G_pad] (+3.4e38 / -3.4e38 set
// by the caller) and nan_flag int32 [G_pad] (zeroed by the caller).
int rs_gb_minmax_launch(const void* gids, const void* vals, void* out,
                        void* nan_flag, long long n, int G_pad, int grid,
                        int use_smem, void* stream) {
  if (grid < 1 || G_pad < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  int* nf = static_cast<int*>(nan_flag);
  if (use_smem) {
    const size_t bytes = (size_t)3 * G_pad * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        gb_minmax_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    gb_minmax_kernel<true><<<grid, T1, bytes, st>>>(g, v, o, nf, n, G_pad);
  } else {
    gb_minmax_kernel<false><<<grid, T1, 0, st>>>(g, v, o, nf, n, G_pad);
  }
  return (int)cudaGetLastError();
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
