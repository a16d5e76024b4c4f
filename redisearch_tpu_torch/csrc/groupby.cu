// Batched per-query GROUPBY sums for Hopper (sm_90a).
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

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
