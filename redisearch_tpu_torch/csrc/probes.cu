// Probes of B1's grid step for Hopper (sm_90a): the counterparts of the
// four TPU probe scripts in `benchmarks/`, which split the cost of the
// Pallas B1 step into its floor, its window copies, its phase work and
// G queries a step.  Nothing in the engine calls them; they measure what
// each part costs on this card.  Four kernels cover the eight Pallas
// functions:
//
//   probe_floor    benchmarks/grid_floor_probe.py cur_kernel (:48),
//                  fused_kernel (:76), g_kernel (:92), curany_kernel (:191)
//   probe_gwin     benchmarks/gstep_probe.py kern (:32),
//                  benchmarks/grid_floor_probe.py gdma_kernel (:111)
//   probe_gcols    benchmarks/gstep_probe2.py kern (:33)
//   probe_variant  benchmarks/kernel_probe.py variant_kernel (:68)
//
// Each computes what its Pallas function computes; the plain torch
// versions beside the wrappers (`bench/probes.py`) repeat the
// arithmetic, bit for bit where the outputs are exact (build with
// --fmad=false and no fast-math, as `ops/_build.py` does: BM25 in
// `probe_variant` must round as the plain version does).
//
// What a TPU grid step is, a block is here: a block reads its own meta
// row (there is no scalar prefetch), and a loop over G queries inside
// the block stands for the TPU's G queries a step.  Window starts are
// row offsets `meta // 128`, clamped into the array (the plain versions
// clamp the same way), so no start reads outside its array.
//
// Bound: bytes, for all four.  Each does a few integer or f32
// operations a byte it moves, far below the card's rates.  Their source
// arrays (1 to 8.4 MB) fit in the 50 MB L2, and the probes' windows
// repeat across queries, so an L2 hit can beat the HBM bound of the
// bytes a call moves (each query's windows read once, the outputs
// written once).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int BLK = 128;
constexpr float NEG_INF = -3.4e38f;

// A sink the compiler cannot see through.  Values folded into it stay
// live, so the loads that feed them are issued; it is written only when
// the flag is nonzero, and nothing sets the flag.
__device__ int g_sink_flag = 0;
__device__ unsigned g_sink[1024];

__device__ __forceinline__ void sink(unsigned v) {
  if (*reinterpret_cast<volatile int*>(&g_sink_flag))
    g_sink[blockIdx.x & 1023] = v;
}

// cp.async: 16 bytes from global to shared memory, in flight until
// waited for; each thread's copies form groups in commit order.
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// First row of a window of `rows` rows whose first lane is `start`:
// floor(start / 128), clamped into [0, n_rows - rows].
__device__ __forceinline__ long long win_row(int start, int rows,
                                             long long n_rows) {
  const long long s = start >> 7;  // arithmetic shift: floor division
  const long long hi = n_rows - rows;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

__device__ __forceinline__ unsigned warp_sum_u(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------
// probe_floor: the step floor.  A block serves G queries; each writes
// meta[q, 0] across 128 lanes, in B1's layout (three [1, 128] outputs,
// doc lanes, zero scores, zero counts, with the fmeta row read as B1's
// spec copies it) or in one fused [3, 128] int32 output.  Bound: the
// output bytes (384 lanes a query); the design is one store a lane, 128
// threads, nothing staged.  The `any` kernel adds B1's four window
// arrays as unused arguments and is launched with the 196,608 bytes of
// dynamic shared memory that curany_kernel's VMEM scratch takes, which
// leaves one block an SM: the probe shows what that occupancy costs.

__device__ __forceinline__ void floor_body(const int* __restrict__ meta,
                                           int meta_cols,
                                           const float* __restrict__ fmeta,
                                           int* __restrict__ out0,
                                           float* __restrict__ out_s,
                                           int* __restrict__ out_c,
                                           int fused, int G) {
  const int lane = threadIdx.x;
  for (int g = 0; g < G; ++g) {
    const long long q = (long long)blockIdx.x * G + g;
    const int v = meta[q * meta_cols];
    if (fused) {
      int* o = out0 + q * 3 * BLK;
      o[lane] = v;
      o[BLK + lane] = v;
      o[2 * BLK + lane] = v;
    } else {
      out0[q * BLK + lane] = v;
      out_s[q * BLK + lane] = 0.0f;
      out_c[q * BLK + lane] = 0;
      if (lane < 3) sink(__float_as_uint(fmeta[q * 3 + lane]));
    }
  }
}

__global__ void __launch_bounds__(BLK)
    probe_floor_kernel(const int* __restrict__ meta, int meta_cols,
                       const float* __restrict__ fmeta, int* out0,
                       float* out_s, int* out_c, int fused, int G) {
  floor_body(meta, meta_cols, fmeta, out0, out_s, out_c, fused, G);
}

__global__ void __launch_bounds__(BLK)
    probe_floor_any_kernel(const int* __restrict__ meta, int meta_cols,
                           const float* __restrict__ fmeta, int* out0,
                           float* out_s, int* out_c, int fused, int G,
                           const void* a0, const void* a1, const void* a2,
                           const void* a3) {
  floor_body(meta, meta_cols, fmeta, out0, out_s, out_c, fused, G);
}

// ---------------------------------------------------------------------
// probe_gwin: G queries a block, each with one window (gstep's `kern`:
// d and f at meta[q, 0], `rows0` rows; out [1, 128] = the int32 sum of
// d's live lanes (flat lane >= meta[q, 1]) plus the f32 sum of f's live
// lanes cut to int32) or two (gdma_kernel: d and f at meta[q, 0] for
// `rows0` rows and at meta[q, 1] for `rows1`; out [3, 128] = the
// column max of the first d window plus that of the second; the f
// windows are read and unused, as the TPU probe copies them).
//
// Bound: the window bytes (8 a lane a window) and the outputs.  Two
// arms.  `staged`: every window goes through shared memory in tiles of
// GW_TILE rows with cp.async, in a two-stage ring whose next tile (the
// next window's or the next query's) is in flight while this one is
// reduced.  Tiles, not whole windows: two stages of gdma's widest
// windows would take (72 + 264) x 128 x 8 B x 2 = 688 KB, past the 227
// KB a block may hold.  `direct`: no staging, 16-byte loads straight
// into registers, GW_UNROLL of them issued before any is used; the
// unused f loads of the two-window mode are folded into the sink so
// that they are issued at all.  The pair shows whether staging pays on
// this card.

constexpr int GW_THREADS = 256;
constexpr int GW_WARPS = GW_THREADS / 32;
constexpr int GW_TILE = 16;
constexpr int GW_UNROLL = 4;

struct GwinArgs {
  const int* meta;
  int meta_cols;
  const int* d;
  const float* f;
  long long n_rows;
  int* out;
  int G, colmax, rows0, rows1;
};

// The output of one query from its block-wide partial sums (sum mode):
// every thread's partial first reduced within its warp, then the warps'
// in order.  Ends with the partials' buffers free again.
__device__ __forceinline__ void gwin_sum_out(const GwinArgs& a, long long q,
                                             unsigned isum, float fsum,
                                             unsigned* red_i, float* red_f) {
  const int tid = threadIdx.x;
  isum = warp_sum_u(isum);
  fsum = warp_sum_f(fsum);
  if ((tid & 31) == 0) {
    red_i[tid >> 5] = isum;
    red_f[tid >> 5] = fsum;
  }
  __syncthreads();
  if (tid < BLK) {
    unsigned si = 0;
    float sf = 0.0f;
    for (int w = 0; w < GW_WARPS; ++w) {
      si += red_i[w];
      sf += red_f[w];
    }
    // astype(int32) truncates toward zero, as __float2int_rz does
    a.out[q * BLK + tid] = static_cast<int>(si + (unsigned)__float2int_rz(sf));
  }
  __syncthreads();
}

__global__ void __launch_bounds__(GW_THREADS) probe_gwin_staged(GwinArgs a) {
  __shared__ __align__(16) int sd[2][GW_TILE * BLK];
  __shared__ __align__(16) float sf[2][GW_TILE * BLK];
  __shared__ unsigned red_i[GW_WARPS];
  __shared__ float red_f[GW_WARPS];
  __shared__ int red_m[GW_THREADS / BLK][BLK];
  const int tid = threadIdx.x;
  const int t0 = (a.rows0 + GW_TILE - 1) / GW_TILE;
  const int tq = t0 + (a.colmax ? (a.rows1 + GW_TILE - 1) / GW_TILE : 0);
  const int n = a.G * tq;
  const long long q0 = (long long)blockIdx.x * a.G;

  // tile i of the block: query g, window w, its rows [r0, r0 + nr)
  auto locate = [&](int i, int& g, int& w, int& r0, int& nr) {
    g = i / tq;
    const int j = i - g * tq;
    w = j >= t0;
    r0 = (w ? j - t0 : j) * GW_TILE;
    nr = min(GW_TILE, (w ? a.rows1 : a.rows0) - r0);
  };
  auto issue = [&](int i) {
    int g, w, r0, nr;
    locate(i, g, w, r0, nr);
    const long long srow =
        win_row(a.meta[(q0 + g) * a.meta_cols + w], w ? a.rows1 : a.rows0,
                a.n_rows) + r0;
    const int* ds = a.d + srow * BLK;
    const float* fs = a.f + srow * BLK;
    const int st = i & 1;
    for (int c = tid; c < nr * (BLK / 4); c += GW_THREADS) {
      cp16(&sd[st][c * 4], ds + c * 4);
      cp16(&sf[st][c * 4], fs + c * 4);
    }
  };

  unsigned isum = 0;
  float fsum = 0.0f;
  int m = INT_MIN;
  unsigned acc = 0;  // two-window mode: the column's sum of maxima
  issue(0);
  cp_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) issue(i + 1);
    cp_commit();  // empty on the last tile: wait_group 1 still means tile i
    cp_wait<1>();
    __syncthreads();
    int g, w, r0, nr;
    locate(i, g, w, r0, nr);
    const int st = i & 1;
    const long long q = q0 + g;
    const bool last = r0 + nr == (w ? a.rows1 : a.rows0);
    if (!a.colmax) {
      const int roff = a.meta[q * a.meta_cols + 1];
      for (int e = tid; e < nr * BLK; e += GW_THREADS) {
        if (r0 * BLK + e >= roff) {
          isum += (unsigned)sd[st][e];
          fsum += sf[st][e];
        }
      }
      if (last) {
        gwin_sum_out(a, q, isum, fsum, red_i, red_f);
        isum = 0;
        fsum = 0.0f;
      }
    } else {
      const int c = tid & (BLK - 1);
      for (int r = tid / BLK; r < nr; r += GW_THREADS / BLK)
        m = max(m, sd[st][r * BLK + c]);
      if (last) {
        red_m[tid / BLK][c] = m;
        __syncthreads();
        if (tid < BLK) {
          unsigned wm = (unsigned)m;
          for (int h = 1; h < GW_THREADS / BLK; ++h)
            wm = (unsigned)max((int)wm, red_m[h][c]);
          acc = w ? acc + wm : wm;
          if (w) {
            int* o = a.out + q * 3 * BLK;
            o[c] = (int)acc;
            o[BLK + c] = (int)acc;
            o[2 * BLK + c] = (int)acc;
          }
        }
        m = INT_MIN;
      }
    }
    __syncthreads();  // stage i & 1 is free for tile i + 2
  }
}

__global__ void __launch_bounds__(GW_THREADS) probe_gwin_direct(GwinArgs a) {
  __shared__ unsigned red_i[GW_WARPS];
  __shared__ float red_f[GW_WARPS];
  __shared__ int red_m[GW_WARPS][BLK];
  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * a.G;
  unsigned snk = 0;
  for (int g = 0; g < a.G; ++g) {
    const long long q = q0 + g;
    const int* mrow = a.meta + q * a.meta_cols;
    if (!a.colmax) {
      const long long srow = win_row(mrow[0], a.rows0, a.n_rows);
      const int roff = mrow[1];
      const int4* d4 = reinterpret_cast<const int4*>(a.d + srow * BLK);
      const float4* f4 = reinterpret_cast<const float4*>(a.f + srow * BLK);
      const int n4 = a.rows0 * (BLK / 4);
      unsigned isum = 0;
      float fsum = 0.0f;
      for (int base = tid; base < n4; base += GW_THREADS * GW_UNROLL) {
        int4 dv[GW_UNROLL];
        float4 fv[GW_UNROLL];
#pragma unroll
        for (int u = 0; u < GW_UNROLL; ++u) {
          const int c = base + u * GW_THREADS;
          if (c < n4) {
            dv[u] = __ldg(d4 + c);
            fv[u] = __ldg(f4 + c);
          }
        }
#pragma unroll
        for (int u = 0; u < GW_UNROLL; ++u) {
          const int c = base + u * GW_THREADS;
          if (c < n4) {
            const int l = c * 4;
            if (l >= roff) { isum += (unsigned)dv[u].x; fsum += fv[u].x; }
            if (l + 1 >= roff) { isum += (unsigned)dv[u].y; fsum += fv[u].y; }
            if (l + 2 >= roff) { isum += (unsigned)dv[u].z; fsum += fv[u].z; }
            if (l + 3 >= roff) { isum += (unsigned)dv[u].w; fsum += fv[u].w; }
          }
        }
      }
      gwin_sum_out(a, q, isum, fsum, red_i, red_f);
    } else {
      // thread: columns 4 * (tid % 32) .. + 3, rows tid / 32 + 8 j
      const int c4 = tid & 31, rg = tid >> 5;
      unsigned acc = 0;
      for (int w = 0; w < 2; ++w) {
        const int rows = w ? a.rows1 : a.rows0;
        const long long srow = win_row(mrow[w], rows, a.n_rows);
        const int4* d4 = reinterpret_cast<const int4*>(a.d + srow * BLK);
        const uint4* f4 =
            reinterpret_cast<const uint4*>(a.f + srow * BLK);
        int4 mx = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
        for (int r = rg; r < rows; r += GW_WARPS * GW_UNROLL) {
          int4 dv[GW_UNROLL];
          uint4 fv[GW_UNROLL];
#pragma unroll
          for (int u = 0; u < GW_UNROLL; ++u) {
            const int rr = r + u * GW_WARPS;
            if (rr < rows) {
              dv[u] = __ldg(d4 + rr * (BLK / 4) + c4);
              fv[u] = __ldg(f4 + rr * (BLK / 4) + c4);
            }
          }
#pragma unroll
          for (int u = 0; u < GW_UNROLL; ++u) {
            if (r + u * GW_WARPS < rows) {
              mx.x = max(mx.x, dv[u].x);
              mx.y = max(mx.y, dv[u].y);
              mx.z = max(mx.z, dv[u].z);
              mx.w = max(mx.w, dv[u].w);
              snk ^= fv[u].x ^ fv[u].y ^ fv[u].z ^ fv[u].w;
            }
          }
        }
        red_m[rg][c4 * 4 + 0] = mx.x;
        red_m[rg][c4 * 4 + 1] = mx.y;
        red_m[rg][c4 * 4 + 2] = mx.z;
        red_m[rg][c4 * 4 + 3] = mx.w;
        __syncthreads();
        if (tid < BLK) {
          int wm = red_m[0][tid];
          for (int h = 1; h < GW_WARPS; ++h) wm = max(wm, red_m[h][tid]);
          acc = w ? acc + (unsigned)wm : (unsigned)wm;
        }
        __syncthreads();
      }
      if (tid < BLK) {
        int* o = a.out + q * 3 * BLK;
        o[tid] = (int)acc;
        o[BLK + tid] = (int)acc;
        o[2 * BLK + tid] = (int)acc;
      }
    }
  }
  sink(snk);
}

// ---------------------------------------------------------------------
// probe_gcols: G queries a block, one 32-row int32 window each (at
// meta[q, 0]); out [1, 128] f32 = the window's column sums, taken in
// f32 over 8-row tiles (each tile's rows in order, then the tiles in
// order, as the TPU kernel's loop adds them), times the f32 weight whose
// bits are meta[q, 1].  Bound: the window bytes (16 KB a query); the
// design is one thread a column, all 32 of a thread's loads issued
// before the first add.  With integer values below 2^24 / 32 every sum
// is exact in any order, so the output equals the plain version's and
// the TPU's bit for bit.

constexpr int GC_ROWS = 32;
constexpr int GC_TILE = 8;

__global__ void __launch_bounds__(BLK)
    probe_gcols_kernel(const int* __restrict__ meta,
                       const int* __restrict__ d, long long n_rows,
                       float* __restrict__ out, int G) {
  const int c = threadIdx.x;
  for (int g = 0; g < G; ++g) {
    const long long q = (long long)blockIdx.x * G + g;
    const long long srow = win_row(meta[2 * q], GC_ROWS, n_rows);
    const float w = __int_as_float(meta[2 * q + 1]);
    int v[GC_ROWS];
#pragma unroll
    for (int r = 0; r < GC_ROWS; ++r) v[r] = __ldg(d + (srow + r) * BLK + c);
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < GC_ROWS / GC_TILE; ++t) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < GC_TILE; ++r) s += (float)v[t * GC_TILE + r];
      acc += s;
    }
    out[q * BLK + c] = acc * w;
  }
}

// ---------------------------------------------------------------------
// probe_variant: B1's grid step in three modes, one block a query.
//   empty  reads its meta and fmeta rows, writes zero outputs;
//   load   adds the window loads: every byte of the slots' windows
//          (doc, freq, mask for each slot, doc length for slot 0; rows
//          W / 128 + R_EXTRA from start // 128) once, through a
//          two-stage ring of VA_TILE-row tiles in shared memory;
//   phase  adds, over the pivot window (slot 0) as its tiles arrive,
//          the in-range & qmask test and BM25 in the JAX probe's
//          operation order, held in shared memory, then a top-k by k
//          rounds of a block-wide arg-max (ties to the lowest lane);
//          an exhausted round gives (INT32_MAX, NEG_INF), B1's filler.
// The counts output is zero in every mode, as in the probe.  Bound: the
// window bytes (552,960 a query at (8192, 32768)).  Tiles, not whole
// windows: those bytes are past the 227 KB a block may hold.  The ring
// takes 64 KB, the pivot's scores and docs 8 B a lane (73,728 B at
// 72 rows), so the phase mode holds one or two blocks an SM.

constexpr int VA_THREADS = 256;
constexpr int VA_WARPS = VA_THREADS / 32;
constexpr int VA_TILE = 16;
constexpr int VA_MAX_T = 4;
constexpr int VA_ARRAYS = 4;
constexpr int VA_STAGE_WORDS = VA_ARRAYS * VA_TILE * BLK;

struct VariantArgs {
  const int* meta;     // [B, 3T]: starts, lens, qmasks
  const float* fmeta;  // [B, T + 1]: tweights, avgdl
  const int* docs;
  const float* tfs;
  const int* masks;
  const float* dl;
  long long n_rows;
  int T, k, mode;
  int rows[VA_MAX_T];
  int* out_docs;
  float* out_scores;
  int* out_counts;
};

__global__ void __launch_bounds__(VA_THREADS) probe_variant_kernel(
    VariantArgs a) {
  extern __shared__ __align__(16) unsigned va_smem[];
  __shared__ float top_s[BLK];
  __shared__ int top_d[BLK];
  __shared__ float red_s[VA_WARPS];
  __shared__ int red_l[VA_WARPS];
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  const int* mrow = a.meta + q * 3 * a.T;
  const float* frow = a.fmeta + q * (a.T + 1);
  int* od = a.out_docs + q * BLK;
  float* os = a.out_scores + q * BLK;
  int* oc = a.out_counts + q * BLK;

  if (a.mode == 0) {
    unsigned snk = 0;
    if (tid < 3 * a.T) snk = (unsigned)mrow[tid];
    if (tid <= a.T) snk ^= __float_as_uint(frow[tid]);
    sink(snk);
    if (tid < BLK) {
      od[tid] = 0;
      os[tid] = 0.0f;
      oc[tid] = 0;
    }
    return;
  }

  unsigned* ring = va_smem;  // [2 stages][4 arrays][VA_TILE * BLK]
  float* ps = reinterpret_cast<float*>(ring + 2 * VA_STAGE_WORDS);
  int* pd = reinterpret_cast<int*>(ps + a.rows[0] * BLK);
  int first[VA_MAX_T + 1];
  first[0] = 0;
  for (int t = 0; t < a.T; ++t)
    first[t + 1] = first[t] + (a.rows[t] + VA_TILE - 1) / VA_TILE;
  const int n = first[a.T];

  auto locate = [&](int i, int& t, int& r0, int& nr) {
    t = 0;
    while (i >= first[t + 1]) ++t;
    r0 = (i - first[t]) * VA_TILE;
    nr = min(VA_TILE, a.rows[t] - r0);
  };
  auto issue = [&](int i) {
    int t, r0, nr;
    locate(i, t, r0, nr);
    const long long off =
        (win_row(mrow[t], a.rows[t], a.n_rows) + r0) * BLK;
    const void* src[VA_ARRAYS] = {a.docs + off, a.tfs + off, a.masks + off,
                                  a.dl + off};
    unsigned* stage = ring + (i & 1) * VA_STAGE_WORDS;
    const int n_arr = t == 0 ? 4 : 3;
    const int chunks = nr * (BLK / 4);
    for (int c = tid; c < n_arr * chunks; c += VA_THREADS) {
      const int arr = c / chunks, cc = c - arr * chunks;
      cp16(stage + arr * VA_TILE * BLK + cc * 4,
           static_cast<const unsigned*>(src[arr]) + cc * 4);
    }
  };

  const int start0 = mrow[0], len0 = mrow[a.T], qmask0 = mrow[2 * a.T];
  const float avgdl = frow[a.T];
  const int rr = ((start0 % BLK) + BLK) % BLK;  // Python's start % 128
  issue(0);
  cp_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) issue(i + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    int t, r0, nr;
    locate(i, t, r0, nr);
    if (a.mode == 2 && t == 0) {
      const unsigned* stage = ring + (i & 1) * VA_STAGE_WORDS;
      for (int e = tid; e < nr * BLK; e += VA_THREADS) {
        const int lane = r0 * BLK + e;
        const int doc = (int)stage[e];
        const float tf = __uint_as_float(stage[VA_TILE * BLK + e]);
        const int msk = (int)stage[2 * VA_TILE * BLK + e];
        const float dlv = __uint_as_float(stage[3 * VA_TILE * BLK + e]);
        const bool valid = lane >= rr && lane < rr + len0 &&
                           (msk & qmask0) != 0;
        const float norm =
            1.2f * (0.25f + 0.75f * dlv / fmaxf(avgdl, 1e-9f));
        const float score = 2.0f * tf * 2.2f / (tf + norm);
        ps[lane] = valid ? score : NEG_INF;
        pd[lane] = valid ? doc : INT_MAX;
      }
    }
    __syncthreads();
  }

  if (a.mode == 1) {
    if (tid < BLK) {
      od[tid] = 0;
      os[tid] = 0.0f;
      oc[tid] = 0;
    }
    return;
  }

  const int nl = a.rows[0] * BLK;
  for (int i = 0; i < a.k; ++i) {
    float bs = NEG_INF;
    int bl = INT_MAX;
    for (int l = tid; l < nl; l += VA_THREADS) {
      const float s = ps[l];
      if (s > bs || (s == bs && l < bl)) {
        bs = s;
        bl = l;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s = __shfl_down_sync(0xffffffffu, bs, o);
      const int l = __shfl_down_sync(0xffffffffu, bl, o);
      if (s > bs || (s == bs && l < bl)) {
        bs = s;
        bl = l;
      }
    }
    if ((tid & 31) == 0) {
      red_s[tid >> 5] = bs;
      red_l[tid >> 5] = bl;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < VA_WARPS; ++w) {
        if (red_s[w] > bs || (red_s[w] == bs && red_l[w] < bl)) {
          bs = red_s[w];
          bl = red_l[w];
        }
      }
      if (bs == NEG_INF) {  // no valid lane left
        top_d[i] = INT_MAX;
        top_s[i] = NEG_INF;
      } else {
        top_d[i] = pd[bl];
        top_s[i] = bs;
        ps[bl] = NEG_INF;
      }
    }
    __syncthreads();
  }
  if (tid < BLK) {
    od[tid] = tid < a.k ? top_d[tid] : INT_MAX;
    os[tid] = tid < a.k ? top_s[tid] : NEG_INF;
    oc[tid] = 0;
  }
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` and returns cudaGetLastError() (0 =
// launched).  Every pointer is a device pointer but `rows` (host).

// With `anys` (four pointers, host array) the `any` kernel, launched
// with `smem` bytes of dynamic shared memory.
int rs_probe_floor_launch(const void* meta, int meta_cols, const void* fmeta,
                          void* out0, void* out_s, void* out_c, int fused,
                          int G, int B, const void* const* anys, int smem,
                          void* stream) {
  if (G < 1 || B % G != 0 || meta_cols < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(meta);
  const float* fm = static_cast<const float*>(fmeta);
  int* o0 = static_cast<int*>(out0);
  float* os = static_cast<float*>(out_s);
  int* oc = static_cast<int*>(out_c);
  if (B == 0) return (int)cudaGetLastError();
  if (anys) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_floor_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    probe_floor_any_kernel<<<B / G, BLK, smem, st>>>(
        m, meta_cols, fm, o0, os, oc, fused, G, anys[0], anys[1], anys[2],
        anys[3]);
  } else {
    probe_floor_kernel<<<B / G, BLK, 0, st>>>(m, meta_cols, fm, o0, os, oc,
                                              fused, G);
  }
  return (int)cudaGetLastError();
}

int rs_probe_gwin_launch(const void* meta, int meta_cols, const void* d,
                         const void* f, long long n_rows, void* out, int B,
                         int G, int colmax, int rows0, int rows1, int staged,
                         void* stream) {
  if (G < 1 || B % G != 0 || rows0 < 1 || (colmax && rows1 < 1) ||
      rows0 > n_rows || (colmax && rows1 > n_rows))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  GwinArgs a;
  a.meta = static_cast<const int*>(meta);
  a.meta_cols = meta_cols;
  a.d = static_cast<const int*>(d);
  a.f = static_cast<const float*>(f);
  a.n_rows = n_rows;
  a.out = static_cast<int*>(out);
  a.G = G;
  a.colmax = colmax;
  a.rows0 = rows0;
  a.rows1 = rows1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    probe_gwin_staged<<<B / G, GW_THREADS, 0, st>>>(a);
  else
    probe_gwin_direct<<<B / G, GW_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int rs_probe_gcols_launch(const void* meta, const void* d, long long n_rows,
                          void* out, int B, int G, void* stream) {
  if (G < 1 || B % G != 0 || n_rows < GC_ROWS)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  probe_gcols_kernel<<<B / G, BLK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const int*>(d), n_rows,
      static_cast<float*>(out), G);
  return (int)cudaGetLastError();
}

// Dynamic shared memory: the ring, and in the phase mode (2) the pivot's
// scores and docs.
int rs_probe_variant_launch(const void* meta, const void* fmeta,
                            const void* docs, const void* tfs,
                            const void* masks, const void* dl,
                            long long n_rows, int T, const int* rows, int k,
                            int mode, void* out_docs, void* out_scores,
                            void* out_counts, int B, void* stream) {
  if (T < 1 || T > VA_MAX_T || k < 1 || k > BLK || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  VariantArgs a;
  for (int t = 0; t < T; ++t) {
    if (rows[t] < 1 || rows[t] > n_rows) return (int)cudaErrorInvalidValue;
    a.rows[t] = rows[t];
  }
  if (B == 0) return (int)cudaGetLastError();
  a.meta = static_cast<const int*>(meta);
  a.fmeta = static_cast<const float*>(fmeta);
  a.docs = static_cast<const int*>(docs);
  a.tfs = static_cast<const float*>(tfs);
  a.masks = static_cast<const int*>(masks);
  a.dl = static_cast<const float*>(dl);
  a.n_rows = n_rows;
  a.T = T;
  a.k = k;
  a.mode = mode;
  a.out_docs = static_cast<int*>(out_docs);
  a.out_scores = static_cast<float*>(out_scores);
  a.out_counts = static_cast<int*>(out_counts);
  const size_t smem =
      mode == 0 ? 0
                : 2 * VA_STAGE_WORDS * sizeof(unsigned) +
                      (mode == 2 ? (size_t)rows[0] * BLK * 8 : 0);
  const cudaError_t e = cudaFuncSetAttribute(
      probe_variant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  probe_variant_kernel<<<B, VA_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
