// GROUPBY kernels for Hopper (sm_90a): the batched per-query sums (B3,
// below) and one request's count/sum/sumsq and min/max in one fused pass
// (B4 and B5, after it).
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

// ---- B4 and B5 fused: one request's group-by in one pass (gb_single_kernel)
//
// Replaces the Pallas TPU kernels `redisearch_tpu/ops/groupby.py`
// `_sums_kernel` (B4, count/sum/sumsq) and `_minmax_kernel` (B5, min/max),
// entry `groupby_aggregate` (via `_groupby_pallas`).  The window program's
// fused aggregation (`agg/pipeline.py` `_make_fused`) calls it once per
// request: the base count and every reducer operand of the request in one
// call, where the JAX package calls `groupby_aggregate` once for the base
// and once per operand, and the port's earlier kernels ran B4 twice and
// B5 once behind about twenty small torch ops (masking, fills, `where`).
//
// Inputs are the raw columns, masked here: gid int32 [n], valid bool [n],
// and per operand j its present bool [n] and values f32 [n], each either
// a column (step 1) or a broadcast constant passed as one element (step 0:
// an APPLY constant, which `_lanes` expands with stride 0, is never
// materialised).  A row counts for the base iff valid & 0 <= gid <
// n_groups, for operand j iff also present_j.  Output f32 [C, G_pad], C =
// has_base + n_ops * (3 + 2 * want_minmax): the base count, then per
// operand count, sum, sumsq (, min, max).  The kernel writes every cell:
// 0 for empty sums, +-3.4e38 for empty min/max (the Pallas identities:
// min = min(3.4e38, values)), NaN min and max for a group holding a NaN
// value, and -0.0 ordered just below +0.0 (a group of -0.0s reads -0.0,
// one of -0.0 and +0.0 min -0.0 and max +0.0).  So the wrapper allocates
// the output and fills nothing.
//
// Bound: bytes.  The rows are read once (gid and valid once for the base
// and every operand, where a call per operand read them again and masked
// them in separate torch ops), n * (4 + 1 + n_ops * 5) bytes,
// plus the C * G_pad * 4 output: 10 MB and 3.0 us at 3.35 TB/s for the
// `*` request (1,000,064 rows, one operand).  Operations are a few per
// byte, far below any compute rate.
//
// Design:
//   * Warp-private histograms.  Each warp of a block owns a [C, G_pad]
//     histogram in shared memory, so no two warps ever touch one bin.
//     Counts are uint32 (integer shared atomics are native: exact in any
//     order), min and max an order-preserving uint32 code of the float
//     (native atomicMin / atomicMax; a NaN takes the extreme code, 0 for
//     min and ~0 for max, so it wins and decodes back to NaN with no
//     flag).  Sums are plain read-modify-writes in a fixed order: this
//     card has no f32 add on shared memory (atomicAdd becomes a
//     compare-and-swap loop), and a fixed order makes them bit-stable.
//     (Plain updates of the counts and codes too measured slower than
//     the fire-and-forget integer atomics.)
//   * A warp takes 256 rows a step, 8 a lane: their gid, valid and first
//     operand in one round trip (every load in flight before any is used;
//     windows of a few thousand rows are latency-bound, not
//     bandwidth-bound).  For each group of 32 rows the lanes write their
//     lane id into a per-warp tag byte of their group and read it back:
//     if no lane lost, every group has one lane and each lane adds its
//     own row; else `__match_any_sync` finds each group's lanes, they
//     stage their values and the lowest lane adds the sums in lane
//     order.  A __syncwarp between groups of 32 rows orders the writes.
//   * Hot groups: where every counted row of a warp step is one group (a
//     G = 1 window), each lane sums its rows in order, the warp sums its
//     lanes with a shuffle butterfly and one lane adds the result, where
//     its 32 lanes would otherwise update one bin one after another.
//   * Small windows (n <= the wrapper's rows a block, 2,048): one block
//     reduces its warps' histograms in warp order and writes the final
//     values.  One launch, no second pass, no global atomics.
//   * Larger windows (up to the `*` request): one block per 2,048 rows, at
//     most one per SM, each a contiguous run of rows, store their reduced
//     histograms with plain coalesced stores into a scratch [blocks, C,
//     G_pad] that the wrapper allocates (132 x 4 x 1,024 x 4 B = 2.2 MB
//     for `*`, in L2); then gb_single_merge_kernel, one thread per (cell,
//     slice of the blocks), reduces them in block order and writes the
//     final values.  Every order is fixed (rows to lanes, lanes, warps,
//     blocks), so two launches on the same inputs give bit-identical
//     sums.
//   * Group spaces whose histogram does not fit four warps (about 56 KB
//     a warp, e.g. G = 16,384 or 65,536): gb_single_init_kernel
//     initialises the output, the rows add into it with global atomics,
//     and gb_single_decode_kernel turns counts and min/max codes into
//     floats.  Correct at every G up to 65,536; its sums are not
//     bit-stable (blocks add in any order).

constexpr int MAX_OPS = 16;
constexpr int U = 8;               // rows a lane takes per step
constexpr int TILE = 32 * U;       // rows a warp takes per step
constexpr int MAX_WARPS = 16;
constexpr int MAX_CH = 1 + MAX_OPS * 5;
constexpr int MERGE_SLICES = 32;
// dynamic shared memory a block may use: 227 KB less 1 KB for the static
constexpr int SMEM_OPT_IN = 232448 - 1024;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// channel kinds
constexpr int K_SUM = 0, K_MIN = 1, K_MAX = 2, K_CNT = 3;

struct SingleOps {
  const unsigned char* pres[MAX_OPS];
  const float* vals[MAX_OPS];
  int pres_step[MAX_OPS];          // 1, or 0 for a broadcast constant
  int vals_step[MAX_OPS];
};

// order-preserving code of a float's raw bits (a < b <=> code(a) <
// code(b)), -0.0 just below +0.0: IEEE-754 minimum/maximum order, as the
// JAX package's jnp.minimum / jnp.maximum give
__device__ __forceinline__ unsigned f2code(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the inverse; codes 0 and ~0 (a NaN's, below) decode to NaNs
__device__ __forceinline__ float code2f(unsigned c) {
  return __uint_as_float((c & 0x80000000u) ? (c & 0x7fffffffu) : ~c);
}

__device__ __forceinline__ unsigned min_code(float x) {
  return isnan(x) ? 0u : f2code(x);
}

__device__ __forceinline__ unsigned max_code(float x) {
  return isnan(x) ? FULL : f2code(x);
}

__device__ __forceinline__ int chan_kind(int c, int has_base, int per_op) {
  if (c < has_base) return K_CNT;
  const int k = (c - has_base) % per_op;
  return k == 0 ? K_CNT : (k < 3 ? K_SUM : k - 2);
}

__device__ __forceinline__ unsigned chan_init(int kind) {
  return kind == K_MIN ? f2code(BIG) : (kind == K_MAX ? f2code(-BIG) : 0u);
}

__device__ __forceinline__ unsigned combine(int kind, unsigned a,
                                            unsigned b) {
  switch (kind) {
    case K_SUM:
      return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
    case K_MIN: return min(a, b);
    case K_MAX: return max(a, b);
    default: return a + b;
  }
}

__device__ __forceinline__ uint4 combine4(int kind, uint4 a, uint4 b) {
  return make_uint4(combine(kind, a.x, b.x), combine(kind, a.y, b.y),
                    combine(kind, a.z, b.z), combine(kind, a.w, b.w));
}

__device__ __forceinline__ float final_value(int kind, unsigned v) {
  return kind == K_SUM ? __uint_as_float(v)
                       : (kind == K_CNT ? (float)v : code2f(v));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// A sum into bin i: plain in a warp-private shared histogram (the caller
// orders the writers), an atomic in the global branch.
template <bool SMEM>
__device__ __forceinline__ void add_sum(unsigned* h, int i, float v) {
  float* f = reinterpret_cast<float*>(h) + i;
  if (SMEM) {
    *f += v;
  } else {
    atomicAdd(f, v);
  }
}

// SMEM: each warp's histogram (C * G_pad words), its group tags (G_pad
// bytes) and its staging words (32) in shared memory; the block's reduced
// histogram goes to part[blockIdx] (counts and codes as they are) when
// part is given, else straight to out as final values.  !SMEM: atomics
// into out (initialised and decoded by the kernels below).
template <bool SMEM>
__global__ void __launch_bounds__(MAX_WARPS * 32)
gb_single_kernel(const int* __restrict__ gid,
                 const unsigned char* __restrict__ valid, const SingleOps ops,
                 int n_ops, long long n, long long rows_per_block,
                 int n_groups, int G_pad, int has_base, int want_minmax,
                 float* __restrict__ out,
                 unsigned* __restrict__ part) {
  extern __shared__ uint4 s_mem4[];
  __shared__ unsigned char s_kind[MAX_CH];
  unsigned* s_mem = reinterpret_cast<unsigned*>(s_mem4);
  const int per_op = 3 + 2 * want_minmax;
  const int C = has_base + n_ops * per_op;
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  // words a warp owns: histogram, a tag byte per group, staging
  const int wstride = C * G_pad + G_pad / 4 + 32;
  unsigned* h = SMEM ? s_mem + (threadIdx.x >> 5) * wstride
                     : reinterpret_cast<unsigned*>(out);
  unsigned char* tag = reinterpret_cast<unsigned char*>(h + C * G_pad);
  unsigned* stage = h + C * G_pad + G_pad / 4;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s_kind[c] = (unsigned char)chan_kind(c, has_base, per_op);
  }
  __syncthreads();
  const int g4 = G_pad / 4;
  const int ws4 = wstride / 4;
  if (SMEM) {   // every warp's channels: zeros, then the min/max codes
    for (int i = threadIdx.x; i < W * ws4; i += blockDim.x) {
      s_mem4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (want_minmax) {
      __syncthreads();
      const unsigned lo = f2code(BIG), hi = f2code(-BIG);
      for (int w = 0; w < W; ++w) {
        for (int j = 0; j < n_ops; ++j) {
          uint4* m = s_mem4 + w * ws4 + (has_base + j * per_op + 3) * g4;
          for (int i = threadIdx.x; i < g4; i += blockDim.x) {
            m[i] = make_uint4(lo, lo, lo, lo);
            m[g4 + i] = make_uint4(hi, hi, hi, hi);
          }
        }
      }
    }
    __syncthreads();
  }

  const unsigned char* P0 = n_ops > 0 ? ops.pres[0] : nullptr;
  const float* V0 = n_ops > 0 ? ops.vals[0] : nullptr;
  const long long ps0 = ops.pres_step[0], vs0 = ops.vals_step[0];
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  // a step's rows: gid, valid and the first operand in one round trip;
  // the next step's are loaded before this one is added
  int gv[U];
  unsigned char vv[U], pn[U];
  float xn[U];
  auto load_step = [&](long long t) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = t + u * 32 + lane;
      const bool ok = r < r1;
      gv[u] = ok ? gid[r] : -1;
      vv[u] = ok ? valid[r] : 0;
      pn[u] = ok && P0 != nullptr ? P0[r * ps0] : 0;
      xn[u] = ok && V0 != nullptr ? V0[r * vs0] : 0.0f;
    }
  };
  load_step(r0 + (long long)(threadIdx.x >> 5) * TILE);
  for (long long t = r0 + (long long)(threadIdx.x >> 5) * TILE; t < r1;
       t += (long long)W * TILE) {
    int key[U];
    unsigned char p0[U];
    float x0[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = (vv[u] && gv[u] >= 0 && gv[u] < n_groups) ? gv[u] : -1;
      p0[u] = pn[u];
      x0[u] = xn[u];
    }
    load_step(t + (long long)W * TILE);
    // uni: every counted row of the step is one group k0 (hot groups)
    bool uni = false;
    int k0 = -1;
    int first = -1;
#pragma unroll
    for (int u = U - 1; u >= 0; --u) first = key[u] >= 0 ? key[u] : first;
    const unsigned has = __ballot_sync(FULL, first >= 0);
    if (has != 0) {
      k0 = __shfl_sync(FULL, first, __ffs(has) - 1);
      bool one = true;
#pragma unroll
      for (int u = 0; u < U; ++u) one = one && (key[u] < 0 || key[u] == k0);
      uni = __all_sync(FULL, one);
    }
    // per group of 32 rows: does any group hold two lanes?  (tags)
    unsigned conf = 0;
    unsigned peers[U];
#pragma unroll
    for (int u = 0; u < U; ++u) peers[u] = 1u << lane;
    if (SMEM && !uni) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (key[u] >= 0) tag[key[u]] = (unsigned char)lane;
        __syncwarp();
        const bool lost = key[u] >= 0 && tag[key[u]] != (unsigned char)lane;
        if (__any_sync(FULL, lost)) {
          conf |= 1u << u;
          peers[u] = __match_any_sync(FULL, key[u]);
        }
        __syncwarp();
      }
    }
    if (has_base) {   // counts: integer atomics, exact in any order
      if (uni) {
        int c = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) c += key[u] >= 0;
        c = __reduce_add_sync(FULL, c);
        if (lane == 0) atomicAdd(h + k0, (unsigned)c);
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (key[u] >= 0) atomicAdd(h + key[u], 1u);
        }
      }
    }
    for (int j = 0; j < n_ops; ++j) {
      unsigned char pv[U];
      float xv[U];
      if (j == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          pv[u] = key[u] >= 0 ? p0[u] : 0;
          xv[u] = x0[u];
        }
      } else {
        const unsigned char* P = ops.pres[j];
        const float* V = ops.vals[j];
        const long long ps = ops.pres_step[j], vs = ops.vals_step[j];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long r = t + u * 32 + lane;
          pv[u] = key[u] >= 0 ? P[r * ps] : 0;
          xv[u] = key[u] >= 0 ? V[r * vs] : 0.0f;
        }
      }
      const int c0 = (has_base + j * per_op) * G_pad;
      if (uni) {    // each lane's rows in order, then a butterfly
        int c = 0;
        float s = 0.0f, q = 0.0f;
        unsigned lo = FULL, hi = 0u;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (pv[u]) {
            const float x = xv[u];
            ++c;
            s += x;
            q += x * x;
            lo = min(lo, min_code(x));
            hi = max(hi, max_code(x));
          }
        }
        c = __reduce_add_sync(FULL, c);
        if (c == 0) continue;                  // warp-uniform
        s = warp_sum(s);
        q = warp_sum(q);
        lo = __reduce_min_sync(FULL, lo);
        hi = __reduce_max_sync(FULL, hi);
        if (lane == 0) {
          atomicAdd(h + c0 + k0, (unsigned)c);
          add_sum<SMEM>(h, c0 + G_pad + k0, s);
          add_sum<SMEM>(h, c0 + 2 * G_pad + k0, q);
          if (want_minmax) {
            atomicMin(h + c0 + 3 * G_pad + k0, lo);
            atomicMax(h + c0 + 4 * G_pad + k0, hi);
          }
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float x = xv[u];
        const int g = key[u];
        if (pv[u]) {      // counts, min and max: exact in any order
          atomicAdd(h + c0 + g, 1u);
          if (want_minmax) {
            atomicMin(h + c0 + 3 * G_pad + g, min_code(x));
            atomicMax(h + c0 + 4 * G_pad + g, max_code(x));
          }
        }
        if (!(conf >> u & 1u)) {              // every group one lane
          if (pv[u]) {
            add_sum<SMEM>(h, c0 + G_pad + g, x);
            add_sum<SMEM>(h, c0 + 2 * G_pad + g, x * x);
          }
        } else {    // the group's lowest lane adds its lanes in lane order
          const unsigned mine = __ballot_sync(FULL, pv[u] != 0) & peers[u];
          stage[lane] = __float_as_uint(x);
          __syncwarp();
          if (mine != 0 && lane == __ffs(peers[u]) - 1) {
            float s = 0.0f, q = 0.0f;
            for (unsigned m = mine; m; m &= m - 1) {
              const float y = __uint_as_float(stage[__ffs(m) - 1]);
              s += y;
              q += y * y;
            }
            add_sum<SMEM>(h, c0 + G_pad + g, s);
            add_sum<SMEM>(h, c0 + 2 * G_pad + g, q);
          }
        }
        if (SMEM) __syncwarp();
      }
    }
  }

  if (SMEM) {   // the warps' histograms in warp order, 4 cells a thread
    __syncthreads();
    for (int c = 0; c < C; ++c) {
      const int kind = s_kind[c];
      for (int i = c * g4 + threadIdx.x; i < (c + 1) * g4;
           i += blockDim.x) {
        uint4 v = s_mem4[i];
        switch (kind) {
          case K_SUM:
#pragma unroll 4
            for (int w = 1; w < W; ++w) {
              v = combine4(K_SUM, v, s_mem4[w * ws4 + i]);
            }
            break;
          case K_MIN:
#pragma unroll 4
            for (int w = 1; w < W; ++w) {
              v = combine4(K_MIN, v, s_mem4[w * ws4 + i]);
            }
            break;
          case K_MAX:
#pragma unroll 4
            for (int w = 1; w < W; ++w) {
              v = combine4(K_MAX, v, s_mem4[w * ws4 + i]);
            }
            break;
          default:
#pragma unroll 4
            for (int w = 1; w < W; ++w) {
              v = combine4(K_CNT, v, s_mem4[w * ws4 + i]);
            }
        }
        if (part != nullptr) {
          reinterpret_cast<uint4*>(part)[(long long)blockIdx.x * C * g4 + i] =
              v;
        } else {
          reinterpret_cast<float4*>(out)[i] =
              make_float4(final_value(kind, v.x), final_value(kind, v.y),
                          final_value(kind, v.z), final_value(kind, v.w));
        }
      }
    }
  }
}

// The second pass of a large window: per output cell, the blocks'
// partials in block order (slice k combines blocks k, k + 32, ...; the
// slices are then combined in slice order), final values out.
__global__ void __launch_bounds__(32 * MERGE_SLICES)
gb_single_merge_kernel(const unsigned* __restrict__ part,
                       float* __restrict__ out, int P, int cells, int G_pad,
                       int has_base, int per_op) {
  __shared__ unsigned s[MERGE_SLICES][32];
  const int c = threadIdx.x & 31;
  const int sl = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + c;
  const int kind = i < cells ? chan_kind(i / G_pad, has_base, per_op) : 0;
  unsigned v = 0u;
  if (i < cells && sl < P) {
    v = part[(long long)sl * cells + i];
#pragma unroll 4
    for (int p = sl + MERGE_SLICES; p < P; p += MERGE_SLICES) {
      v = combine(kind, v, part[(long long)p * cells + i]);
    }
  }
  s[sl][c] = v;
  __syncthreads();
  if (sl != 0 || i >= cells) return;
  for (int k = 1; k < MERGE_SLICES && k < P; ++k) v = combine(kind, v, s[k][c]);
  out[i] = final_value(kind, v);
}

// global branch: the output's identities (0 counts and sums, min/max
// codes) ...
__global__ void gb_single_init_kernel(unsigned* __restrict__ out, int cells,
                                      int G_pad, int has_base, int per_op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cells) out[i] = chan_init(chan_kind(i / G_pad, has_base, per_op));
}

// ... and, after the atomics, counts and min/max codes made floats in place
__global__ void gb_single_decode_kernel(float* __restrict__ out, int cells,
                                        int G_pad, int has_base, int per_op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int kind = chan_kind(i / G_pad, has_base, per_op);
  if (kind != K_SUM) out[i] = final_value(kind, __float_as_uint(out[i]));
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

// B4/B5 fused: one request's base count and up to MAX_OPS operands into
// out f32 [C, G_pad] (see gb_single_kernel).  pres / vals / *_step are
// host arrays of n_ops entries.  use_smem with blocks > 1 needs `part`,
// blocks * C * G_pad uint32 of scratch.  Launches one kernel (one small
// window), two (a large one) or three (the global branch) on `stream`;
// returns cudaGetLastError() (0 = launched).
int rs_gb_single_launch(const void* gid, const void* valid,
                        const void* const* pres, const void* const* vals,
                        const int* pres_step, const int* vals_step,
                        int n_ops, long long n, int n_groups, int G_pad,
                        int has_base, int want_minmax, int blocks,
                        int warps, long long rows_per_block, int use_smem,
                        void* out, void* part, void* stream) {
  if (n_ops < 0 || n_ops > MAX_OPS || blocks < 1 || warps < 1 ||
      warps > MAX_WARPS || G_pad < 1 || n_groups < 1 || n_groups > G_pad ||
      rows_per_block < 1 || (has_base == 0 && n_ops == 0) ||
      (use_smem && blocks > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  SingleOps ops = {};
  for (int j = 0; j < n_ops; ++j) {
    ops.pres[j] = static_cast<const unsigned char*>(pres[j]);
    ops.vals[j] = static_cast<const float*>(vals[j]);
    ops.pres_step[j] = pres_step[j];
    ops.vals_step[j] = vals_step[j];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gid);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* o = static_cast<float*>(out);
  const int per_op = 3 + 2 * want_minmax;
  const int cells = (has_base + n_ops * per_op) * G_pad;
  const int threads = warps * 32;
  cudaError_t e;
  if (use_smem) {   // per warp: histogram, group tag bytes, staging words
    const size_t bytes =
        (size_t)warps * (cells + G_pad / 4 + 32) * sizeof(unsigned);
    // opt in once per device to all the shared memory a block may have
    static bool opted[64];
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (bytes > 48 * 1024 && (dev >= 64 || !opted[dev])) {
      e = cudaFuncSetAttribute(gb_single_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_OPT_IN);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) opted[dev] = true;
    }
    unsigned* p = blocks > 1 ? static_cast<unsigned*>(part) : nullptr;
    gb_single_kernel<true><<<blocks, threads, bytes, st>>>(
        g, v, ops, n_ops, n, rows_per_block, n_groups, G_pad, has_base,
        want_minmax, o, p);
    if (blocks > 1) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      gb_single_merge_kernel<<<(cells + 31) / 32, 32 * MERGE_SLICES, 0, st>>>(
          p, o, blocks, cells, G_pad, has_base, per_op);
    }
  } else {
    const int cb = (cells + 255) / 256;
    gb_single_init_kernel<<<cb, 256, 0, st>>>(reinterpret_cast<unsigned*>(o),
                                              cells, G_pad, has_base, per_op);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gb_single_kernel<false><<<blocks, threads, 0, st>>>(
        g, v, ops, n_ops, n, rows_per_block, n_groups, G_pad, has_base,
        want_minmax, o, nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gb_single_decode_kernel<<<cb, 256, 0, st>>>(o, cells, G_pad, has_base,
                                                per_op);
  }
  return (int)cudaGetLastError();
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
