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
// the block stands for the TPU's G queries a step; probe_floor and
// probe_gcols run persistent blocks that walk many such groups (see
// "Persistent blocks" below), as a TPU core walks its grid.  Window
// starts are row offsets `meta // 128`, clamped into the array (the
// plain versions clamp the same way), so no start reads outside its
// array.
//
// Bound: bytes, for all four.  Each does a few integer or f32
// operations a byte it moves, far below the card's rates.  Their source
// arrays (1 to 8.4 MB) fit in the 50 MB L2, and the probes' windows
// repeat across queries, so an L2 hit can beat the HBM bound of the
// bytes a call moves (each query's windows read once, the outputs
// written once).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int BLK = 128;
constexpr float NEG_INF = -3.4e38f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// A sink the compiler cannot see through.  Values folded into it stay
// live, so the loads that feed them are issued; it is written only when
// the flag is nonzero, and nothing sets the flag.
__device__ int g_sink_flag = 0;
__device__ unsigned g_sink[1024];

__device__ __forceinline__ int sink_flag() {
  return *reinterpret_cast<volatile int*>(&g_sink_flag);
}
__device__ __forceinline__ void sink(unsigned v) {
  if (sink_flag()) g_sink[blockIdx.x & 1023] = v;
}

// The TMA ring of the `staged` gwin arm, of probe_variant's load and
// phase modes and of probe_gcols: S stages in dynamic shared memory, each with a `full` and
// an `empty` mbarrier.  One producer thread (lane 0 of the block's last
// warp) waits on `empty`, arms `full` with the tile's bytes
// (arrive.expect_tx) and issues one cp.async.bulk a tile of each array;
// the consumer warps wait on `full`, read the tile and arrive on
// `empty`, one arrival a warp.  Tile i sits in stage i % S; its round
// i / S is the phase parity that both sides wait for.
constexpr int RING_MAX_STAGES = 16;
constexpr int RING_CWARPS = 4;                     // consumer warps
constexpr int RING_CTHREADS = RING_CWARPS * 32;
constexpr int RING_THREADS = RING_CTHREADS + 32;   // and a producer warp

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* b,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of copies to complete.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_u32(b))
      : "memory");
}
// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
  const unsigned a = smem_u32(b);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// A barrier of the consumer warps only (the producer never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(RING_CTHREADS) : "memory");
}
// The rings' barriers: `full` counts the producer's one arrival (and the
// bytes), `empty` one arrival a consumer warp.  Thread 0 sets them up;
// the caller's __syncthreads() publishes them.
__device__ __forceinline__ void ring_init(unsigned long long* full,
                                          unsigned long long* empty, int S) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], RING_CWARPS);
    }
    mbar_fence_init();
  }
}
// A consumer warp is done with a stage.
__device__ __forceinline__ void ring_release(unsigned long long* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
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
// Persistent blocks (probe_floor, probe_gcols).  The TPU runs a grid's
// steps one after another on a core, over scratch allocated once; on
// this card every block pays its own launch, shared memory and first
// load round trip.  So these launches put on the card only the blocks
// it holds at once, at most one a group of G queries (the grid comes
// from `persistent_grid` in bench/probes.py: min(B / G, SMs x resident
// blocks an SM)), and block b walks the groups b, b + grid, b + 2 grid,
// ...: query j of its walk is query j % G of group b + (j / G) grid.

// How many queries block blockIdx.x walks.
__device__ __forceinline__ int walk_len(int n_groups, int G) {
  return G * ((n_groups - (int)blockIdx.x + (int)gridDim.x - 1) /
              (int)gridDim.x);
}
// Query j of block blockIdx.x's walk.
__device__ __forceinline__ long long walk_query(int j, int G) {
  return ((long long)blockIdx.x + (long long)(j / G) * gridDim.x) * G +
         j % G;
}

// ---------------------------------------------------------------------
// probe_floor: the step floor.  Each query writes meta[q, 0] across 128
// lanes, in B1's layout (three [1, 128] outputs: doc lanes, zero scores,
// zero counts, with the fmeta row read as B1's spec copies it) or in one
// fused [3, 128] int32 output.  Bound: the output bytes (384 lanes a
// query).  Persistent blocks of 128 threads, read ahead a warp at a
// time: warp w takes queries w, w + 4, w + 8, ... of its block's walk,
// 32 at once; lane l loads meta[q, 0] (and the fmeta row) of the
// batch's query l, so a load's round trip is paid once for 32 queries,
// not once a query, and the warp then stores each query's three rows,
// 3 x 512 B in 16-byte stores, its value passed by shuffles.  No block
// barrier.  The sink's flag is read at the start and only in B1's
// layout: a load at a block's tail costs every block its round trip
// (it made the fused arm 0.0009 us a query at B = 8,192 against 0.0007
// without it).  The `any` kernel adds B1's four window arrays as unused
// arguments and is launched with the 196,608 bytes of dynamic shared
// memory that curany_kernel's VMEM scratch takes: one block an SM, as
// the TPU's scratch is one allocation a core, each walking B / 132
// queries.

struct FloorArgs {
  const int* meta;
  int meta_cols;
  const float* fmeta;
  int* out0;
  float* out_s;
  int* out_c;
  int fused, G, n_groups;
};

// 16-byte store p (0-95) of query q's three rows.
__device__ __forceinline__ void floor_store16(const FloorArgs& a, long long q,
                                              int x, int p) {
  if (a.fused) {
    reinterpret_cast<int4*>(a.out0 + q * 3 * BLK)[p] = make_int4(x, x, x, x);
  } else if (p < 32) {
    reinterpret_cast<int4*>(a.out0 + q * BLK)[p] = make_int4(x, x, x, x);
  } else if (p < 64) {
    reinterpret_cast<float4*>(a.out_s + q * BLK)[p - 32] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    reinterpret_cast<int4*>(a.out_c + q * BLK)[p - 64] = make_int4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void floor_body(const FloorArgs& a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int NW = BLK / 32;
  const int flag = a.fused ? 0 : sink_flag();  // read early: off the tail
  unsigned snk = 0;
  for (int k0 = 0;; k0 += 32) {
    // this lane's query of the walk, and its group (no division at G = 1)
    const int j = warp + NW * (k0 + lane);
    const int jg = a.G == 1 ? j : j / a.G;
    const long long g = blockIdx.x + (long long)jg * gridDim.x;
    const bool live = g < a.n_groups;  // the live lanes are a prefix
    const unsigned m = __ballot_sync(FULL_MASK, live);
    if (!m) break;
    int q = 0, v = 0;
    if (live) {
      q = (int)(g * a.G + (j - jg * a.G));
      v = a.meta[(long long)q * a.meta_cols];
      if (!a.fused)
        snk ^= __float_as_uint(a.fmeta[q * 3LL]) ^
               __float_as_uint(a.fmeta[q * 3LL + 1]) ^
               __float_as_uint(a.fmeta[q * 3LL + 2]);
    }
    const int n = __popc(m);
    for (int i = 0; i < n; ++i) {
      const long long qq = __shfl_sync(FULL_MASK, q, i);
      const int x = __shfl_sync(FULL_MASK, v, i);
      floor_store16(a, qq, x, lane);
      floor_store16(a, qq, x, 32 + lane);
      floor_store16(a, qq, x, 64 + lane);
    }
  }
  if (flag) g_sink[blockIdx.x & 1023] = snk;
}

__global__ void __launch_bounds__(BLK) probe_floor_kernel(FloorArgs a) {
  floor_body(a);
}

__global__ void __launch_bounds__(BLK)
    probe_floor_any_kernel(FloorArgs a, const void* a0, const void* a1,
                           const void* a2, const void* a3) {
  floor_body(a);
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
// arms.  `staged`: every window goes through the TMA ring in tiles of
// `tile` rows (a stage holds one tile of d and the same rows of f, two
// bulk copies of nr x 512 B at win_row(...) x 512, a short last tile
// armed with its own bytes).  The producer runs S tiles ahead across
// window and query boundaries, so the next query's windows are in
// flight while this one is reduced.  The launcher shares an SM's
// shared memory among the blocks a grid of B / G puts on it and takes
// the widest tile (64, 32 or 16 rows) of which three stages fit in a
// block's share, then as many stages as fit: fewer blocks an SM get
// wider tiles, so a wait on a stage covers more bytes.  Tiles, not
// whole windows: two of gdma's widest windows take (72 + 264) x 128 x
// 8 B = 344 KB, past the 227 KB a block may hold.  The only block-wide
// barriers are the consumers' one a query (the sum's fold) or one a
// window (the column max's).  `direct`: no staging, 16-byte loads
// straight into registers, GW_UNROLL of them issued before any is
// used; the unused f loads of the two-window mode are folded into the
// sink so that they are issued at all.  The pair shows whether staging
// pays on this card.

constexpr int GW_THREADS = 256;
constexpr int GW_WARPS = GW_THREADS / 32;
// the staged arm's widest tile, rows (a timing build may define another)
#ifndef PROBE_GW_TILE_MAX
#define PROBE_GW_TILE_MAX 64
#endif
constexpr int GW_TILES[] = {64, 32, 16};  // the tile rows it picks from
constexpr int GW_UNROLL = 4;

struct GwinArgs {
  const int* meta;
  int meta_cols;
  const int* d;
  const float* f;
  long long n_rows;
  int* out;
  int G, colmax, rows0, rows1;
  int stages, tile;  // the staged arm's ring: stages, rows a tile
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

// The staged arm's walk over its tiles: query g of the block, window w,
// rows [r0, r0 + nr) of it.  Producer and consumers each keep one.
struct GwinWalk {
  int g = 0, w = 0, r0 = 0;
  __device__ __forceinline__ int rows(const GwinArgs& a) const {
    return w ? a.rows1 : a.rows0;
  }
  __device__ __forceinline__ int nr(const GwinArgs& a) const {
    return min(a.tile, rows(a) - r0);
  }
  // true where the tile just walked was its window's last
  __device__ __forceinline__ bool next(const GwinArgs& a) {
    r0 += a.tile;
    if (r0 < rows(a)) return false;
    r0 = 0;
    if (a.colmax && !w) {
      w = 1;
    } else {
      w = 0;
      ++g;
    }
    return true;
  }
};

// RING_CWARPS consumer warps reduce; the last warp's lane 0 produces.
// Consumer thread t: sum mode, the 16-byte groups t, t + 128, ... of a
// tile; column-max mode, columns 4 (t % 32) .. + 3 of the tile's rows
// t / 32, t / 32 + 4, ...
__global__ void __launch_bounds__(RING_THREADS, 4)
    probe_gwin_staged(GwinArgs a) {
  extern __shared__ __align__(128) unsigned char gw_ring[];
  __shared__ __align__(8) unsigned long long full[RING_MAX_STAGES];
  __shared__ __align__(8) unsigned long long empty[RING_MAX_STAGES];
  __shared__ unsigned red_i[2][RING_CWARPS];
  __shared__ float red_f[2][RING_CWARPS];
  __shared__ __align__(16) int red_m[2][RING_CWARPS][BLK];
  const int tid = threadIdx.x, S = a.stages;
  const int tile_b = a.tile * BLK * 4;  // a stage: d's rows, then f's
  const int n = a.G * ((a.rows0 + a.tile - 1) / a.tile +
                       (a.colmax ? (a.rows1 + a.tile - 1) / a.tile : 0));
  const long long q0 = (long long)blockIdx.x * a.G;
  ring_init(full, empty, S);
  __syncthreads();

  if (tid >= RING_CTHREADS) {  // the producer warp
    if (tid == RING_CTHREADS) {
      GwinWalk wk;
      long long srow = 0;
      int s = 0;
      unsigned par = 0;
      for (int i = 0; i < n; ++i) {
        if (wk.r0 == 0)
          srow = win_row(a.meta[(q0 + wk.g) * a.meta_cols + wk.w],
                         wk.rows(a), a.n_rows);
        const unsigned bytes = (unsigned)wk.nr(a) * BLK * 4;
        if (i >= S) mbar_wait(&empty[s], par ^ 1u);
        unsigned char* st = gw_ring + (size_t)s * 2 * tile_b;
        const long long off = (srow + wk.r0) * BLK;
        mbar_expect_tx(&full[s], 2 * bytes);
        bulk_g2s(st, a.d + off, bytes, &full[s]);
        bulk_g2s(st + tile_b, a.f + off, bytes, &full[s]);
        wk.next(a);
        if (++s == S) {
          s = 0;
          par ^= 1u;
        }
      }
    }
    return;
  }

  GwinWalk wk;
  int s = 0;
  unsigned par = 0;
  unsigned isum = 0;
  float fsum = 0.0f;
  int roff = 0;
  int4 mx = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
  unsigned acc = 0;  // column-max mode: column tid's sum of maxima
  const int c4 = tid & 31, rg = tid >> 5;
  for (int i = 0; i < n; ++i) {
    const long long q = q0 + wk.g;
    const int r0 = wk.r0, nr = wk.nr(a), w = wk.w, g = wk.g;
    if (!a.colmax && r0 == 0) roff = a.meta[q * a.meta_cols + 1];
    mbar_wait(&full[s], par);
    const unsigned char* st = gw_ring + (size_t)s * 2 * tile_b;
    const int4* sd = reinterpret_cast<const int4*>(st);
    if (!a.colmax) {
      const float4* sf = reinterpret_cast<const float4*>(st + tile_b);
      for (int c = tid; c < nr * (BLK / 4); c += RING_CTHREADS) {
        const int4 dv = sd[c];
        const float4 fv = sf[c];
        const int l = r0 * BLK + c * 4;
        if (l >= roff) { isum += (unsigned)dv.x; fsum += fv.x; }
        if (l + 1 >= roff) { isum += (unsigned)dv.y; fsum += fv.y; }
        if (l + 2 >= roff) { isum += (unsigned)dv.z; fsum += fv.z; }
        if (l + 3 >= roff) { isum += (unsigned)dv.w; fsum += fv.w; }
      }
    } else {
      for (int r = rg; r < nr; r += RING_CWARPS) {
        const int4 v = sd[r * (BLK / 4) + c4];
        mx.x = max(mx.x, v.x);
        mx.y = max(mx.y, v.y);
        mx.z = max(mx.z, v.z);
        mx.w = max(mx.w, v.w);
      }
    }
    ring_release(&empty[s]);
    if (++s == S) {
      s = 0;
      par ^= 1u;
    }
    if (!wk.next(a)) continue;
    // the window's last tile: fold it (buffers alternate by query, or
    // by window, so one consumer barrier a fold suffices)
    if (!a.colmax) {
      isum = warp_sum_u(isum);
      fsum = warp_sum_f(fsum);
      if ((tid & 31) == 0) {
        red_i[g & 1][rg] = isum;
        red_f[g & 1][rg] = fsum;
      }
      consumer_sync();
      unsigned si = 0;
      float sfs = 0.0f;
      for (int h = 0; h < RING_CWARPS; ++h) {
        si += red_i[g & 1][h];
        sfs += red_f[g & 1][h];
      }
      // astype(int32) truncates toward zero, as __float2int_rz does
      a.out[q * BLK + tid] =
          static_cast<int>(si + (unsigned)__float2int_rz(sfs));
      isum = 0;
      fsum = 0.0f;
    } else {
      *reinterpret_cast<int4*>(&red_m[w][rg][c4 * 4]) = mx;
      consumer_sync();
      int wm = red_m[w][0][tid];
      for (int h = 1; h < RING_CWARPS; ++h) wm = max(wm, red_m[w][h][tid]);
      acc = w ? acc + (unsigned)wm : (unsigned)wm;
      if (w) {
        int* o = a.out + q * 3 * BLK;
        o[tid] = (int)acc;
        o[BLK + tid] = (int)acc;
        o[2 * BLK + tid] = (int)acc;
      }
      mx = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
    }
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
// probe_gcols: one 32-row int32 window a query (at meta[q, 0]); out
// [1, 128] f32 = the window's column sums, taken in f32 over 8-row
// tiles (each tile's rows in order, then the tiles in order, as the TPU
// kernel's loop adds them), times the f32 weight whose bits are
// meta[q, 1].  With integer values below 2^24 / 32 every sum is exact
// in any order, so the output equals the plain version's and the TPU's
// bit for bit.
//
// Bound: the window bytes (16 KB a query).  The TPU kernel
// double-buffers each query's window (make_async_copy, two DMA
// semaphores); here persistent blocks run the TMA ring of probe_gwin: a
// stage holds one query's window, one cp.async.bulk of 32 x 512 B from
// row win_row(meta[q, 0]), its `full` barrier armed with exactly those
// bytes.  The producer warp runs S windows ahead across query and group
// boundaries: its 32 lanes read the starts of the next 32 queries of
// the walk at once, and lane 0 issues their copies.  Each of the 128
// consumer threads sums its column from the stage and multiplies by the
// weight, which its warp read ahead the same way; then the warp
// releases the stage.  S comes from ring_plan (the SM's shared memory
// split among the blocks the grid puts there).  A bulk copy reads L2
// and never L1, so where windows repeat (gstep2's 8,192 windows over
// 2,040 rows) loads that hit L1 beat the ring; on windows that do not
// repeat the two read at the same rate (PERF.md §5).

constexpr int GC_ROWS = 32;
constexpr int GC_TILE = 8;
constexpr int GC_STAGE_BYTES = GC_ROWS * BLK * 4;  // a stage: one window

struct GcolsArgs {
  const int* meta;  // [B, 2]: window start, weight bits
  const int* d;
  long long n_rows;
  float* out;
  int G, n_groups, stages;
};

__global__ void __launch_bounds__(RING_THREADS, 4)
    probe_gcols_ring(GcolsArgs a) {
  extern __shared__ __align__(128) unsigned char gc_ring[];
  __shared__ __align__(8) unsigned long long full[RING_MAX_STAGES];
  __shared__ __align__(8) unsigned long long empty[RING_MAX_STAGES];
  const int tid = threadIdx.x, lane = tid & 31, S = a.stages;
  const int nq = walk_len(a.n_groups, a.G);
  ring_init(full, empty, S);
  __syncthreads();
  int s = 0;
  unsigned par = 0;

  if (tid >= RING_CTHREADS) {  // the producer warp; lane 0 issues
    for (int j0 = 0; j0 < nq; j0 += 32) {
      const int start =
          j0 + lane < nq ? a.meta[2 * walk_query(j0 + lane, a.G)] : 0;
      const int n = min(32, nq - j0);
      for (int i = 0; i < n; ++i) {
        const int st = __shfl_sync(FULL_MASK, start, i);
        if (lane == 0) {
          if (j0 + i >= S) mbar_wait(&empty[s], par ^ 1u);
          mbar_expect_tx(&full[s], GC_STAGE_BYTES);
          bulk_g2s(gc_ring + (size_t)s * GC_STAGE_BYTES,
                   a.d + win_row(st, GC_ROWS, a.n_rows) * BLK,
                   GC_STAGE_BYTES, &full[s]);
        }
        if (++s == S) {
          s = 0;
          par ^= 1u;
        }
      }
    }
    return;
  }

  for (int j0 = 0; j0 < nq; j0 += 32) {
    const int wbits =
        j0 + lane < nq ? a.meta[2 * walk_query(j0 + lane, a.G) + 1] : 0;
    const int n = min(32, nq - j0);
    for (int i = 0; i < n; ++i) {
      const float w = __int_as_float(__shfl_sync(FULL_MASK, wbits, i));
      mbar_wait(&full[s], par);
      const int* st =
          reinterpret_cast<const int*>(gc_ring + (size_t)s * GC_STAGE_BYTES);
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < GC_ROWS / GC_TILE; ++t) {
        float sum = 0.0f;
#pragma unroll
        for (int r = 0; r < GC_TILE; ++r)
          sum += (float)st[(t * GC_TILE + r) * BLK + tid];
        acc += sum;
      }
      ring_release(&empty[s]);
      a.out[walk_query(j0 + i, a.G) * BLK + tid] = acc * w;
      if (++s == S) {
        s = 0;
        par ^= 1u;
      }
    }
  }
}

// ---------------------------------------------------------------------
// probe_variant: B1's grid step in three modes, one block a query.
//   empty  reads its meta and fmeta rows, writes zero outputs;
//   load   adds the window loads: every byte of the slots' windows
//          (doc, freq, mask for each slot, doc length for slot 0; rows
//          W / 128 + R_EXTRA from start // 128) once, through the TMA
//          ring in tiles of VA_TILE rows (three or four bulk copies a
//          tile, their bytes summed into one expect_tx);
//   phase  adds, over the pivot window (slot 0) as its tiles arrive,
//          the in-range & qmask test and BM25 in the JAX probe's
//          operation order, and keeps only a running top-k: each
//          consumer warp appends the lanes that beat its k-th so far
//          (one ballot a round of 32 lanes, no serial step) to its own
//          candidate buffer in shared memory, (score, lane) pairs;
//          when more than cap - 32 are held, each is ranked by counting
//          the pairs before it (lanes are unique, so ranks are) and the
//          best k move to the buffer's other half, the k-th becoming
//          the bar.  At the end the warps' buffers are ranked together
//          and each of the best k reads its doc id back from the pivot
//          window (ties to the lowest lane).  Slots past the valid
//          lanes give (INT32_MAX, NEG_INF), B1's filler.
// The counts output is zero in every mode, as in the probe.  Bound: the
// window bytes (552,960 a query at (8192, 32768)).  Tiles, not whole
// windows: those bytes are past the 227 KB a block may hold.  A stage
// is 16 KB (4 arrays x 8 rows); the launcher sets S (three at least)
// so that the grid's blocks share the SMs' shared memory, the
// candidate buffers (4 warps x 2 halves x cap x 8 B, cap = max(2k, 64)
// + 32: 6 KB at k = 16) beside the ring: at B = 512, four blocks an SM
// with three stages each.  Nothing of the pivot is kept beyond its
// tile, so the pivot's width no longer bounds the kernel.

constexpr int VA_THREADS = 256;  // the empty mode
constexpr int VA_TILE = 8;
constexpr int VA_MAX_T = 4;
constexpr int VA_ARRAYS = 4;
constexpr int VA_ARRAY_BYTES = VA_TILE * BLK * 4;
constexpr int VA_STAGE_BYTES = VA_ARRAYS * VA_ARRAY_BYTES;
constexpr int VA_MAX_K = BLK;

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
  int stages;  // the ring of the load and phase modes
  int cap;     // the phase mode's candidate buffers, pairs a half
};

__global__ void __launch_bounds__(VA_THREADS)
    probe_variant_empty(VariantArgs a) {
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  const int* mrow = a.meta + q * 3 * a.T;
  const float* frow = a.fmeta + q * (a.T + 1);
  unsigned snk = 0;
  if (tid < 3 * a.T) snk = (unsigned)mrow[tid];
  if (tid <= a.T) snk ^= __float_as_uint(frow[tid]);
  sink(snk);
  if (tid < BLK) {
    a.out_docs[q * BLK + tid] = 0;
    a.out_scores[q * BLK + tid] = 0.0f;
    a.out_counts[q * BLK + tid] = 0;
  }
}

// (s, l) ranks before (ts, tl): higher score, or the same and a lower
// lane.
__device__ __forceinline__ bool va_better(float s, int l, float ts, int tl) {
  return s > ts || (s == ts && l < tl);
}

// A consumer warp's candidates: two halves of `cap` (score, lane) pairs
// in shared memory, `n` held in the current one; (ts, tl) is the bar, the
// k-th best kept so far, or (NEG_INF, INT_MAX) until k are kept.
struct VaBuf {
  float* s;  // the current half; the other is s + cap (lanes: l, l + cap)
  int* l;
  int n, cap, k, side;  // side: which half is current
  float ts;
  int tl;

  // Every lane offers its (valid, score, lane); those that pass the bar
  // are appended, in lane order.  All 32 lanes call.
  __device__ __forceinline__ void offer(bool valid, float sc, int ln) {
    const int lane = threadIdx.x & 31;
    const bool c = valid && va_better(sc, ln, ts, tl);
    const unsigned m = __ballot_sync(FULL_MASK, c);
    if (c) {
      const int at = n + __popc(m & ((1u << lane) - 1u));
      s[at] = sc;
      l[at] = ln;
    }
    n += __popc(m);
    if (n > cap - 32) keep_best();
  }

  // The best min(n, k) held pairs, at their ranks, in the other half.
  __device__ __forceinline__ void keep_best() {
    __syncwarp();
    const int lane = threadIdx.x & 31;
    const int sign = side ? -1 : 1;
    float* s2 = s + sign * cap;
    int* l2 = l + sign * cap;
    for (int e = lane; e < n; e += 32) {
      const float cs = s[e];
      const int cl = l[e];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += va_better(s[j], l[j], cs, cl);
      if (rank < k) {
        s2[rank] = cs;
        l2[rank] = cl;
      }
    }
    __syncwarp();
    s = s2;
    l = l2;
    side ^= 1;
    n = min(n, k);
    if (n == k) {
      ts = s[k - 1];
      tl = l[k - 1];
    }
  }
};

// RING_CWARPS consumer warps; the last warp's lane 0 produces.  The
// consumers wait for every tile (the load mode only releases it); in the
// phase mode consumer thread t scores the pivot tile's 16-byte groups
// t, t + 128, ... (4 lanes each).
__global__ void __launch_bounds__(RING_THREADS, 4)
    probe_variant_ring(VariantArgs a) {
  extern __shared__ __align__(128) unsigned char va_ring[];
  __shared__ __align__(8) unsigned long long full[RING_MAX_STAGES];
  __shared__ __align__(8) unsigned long long empty[RING_MAX_STAGES];
  __shared__ int n_valid[RING_CWARPS], n_half[RING_CWARPS];
  const int tid = threadIdx.x, S = a.stages;
  const long long q = blockIdx.x;
  const int* mrow = a.meta + q * 3 * a.T;
  int n = 0;
  for (int t = 0; t < a.T; ++t) n += (a.rows[t] + VA_TILE - 1) / VA_TILE;
  ring_init(full, empty, S);
  __syncthreads();

  if (tid >= RING_CTHREADS) {  // the producer warp
    if (tid == RING_CTHREADS) {
      int s = 0, i = 0;
      unsigned par = 0;
      for (int t = 0; t < a.T; ++t) {
        const long long srow = win_row(mrow[t], a.rows[t], a.n_rows);
        const int n_arr = t == 0 ? 4 : 3;
        for (int r0 = 0; r0 < a.rows[t]; r0 += VA_TILE, ++i) {
          const unsigned bytes =
              (unsigned)min(VA_TILE, a.rows[t] - r0) * BLK * 4;
          const long long off = (srow + r0) * BLK;
          const void* src[VA_ARRAYS] = {a.docs + off, a.tfs + off,
                                        a.masks + off, a.dl + off};
          if (i >= S) mbar_wait(&empty[s], par ^ 1u);
          unsigned char* st = va_ring + (size_t)s * VA_STAGE_BYTES;
          mbar_expect_tx(&full[s], n_arr * bytes);
#pragma unroll
          for (int arr = 0; arr < VA_ARRAYS; ++arr)
            if (arr < n_arr)
              bulk_g2s(st + arr * VA_ARRAY_BYTES, src[arr], bytes, &full[s]);
          if (++s == S) {
            s = 0;
            par ^= 1u;
          }
        }
      }
    }
    return;
  }

  const int start0 = mrow[0], len0 = mrow[a.T], qmask0 = mrow[2 * a.T];
  const float avgdl = a.fmeta[q * (a.T + 1) + a.T];
  const int rr = ((start0 % BLK) + BLK) % BLK;  // Python's start % 128
  const int t0_tiles = (a.rows[0] + VA_TILE - 1) / VA_TILE;
  const int wp = tid >> 5, ln = tid & 31;
  // the candidate buffers follow the ring: [warp][half][cap] scores,
  // then the same of lanes
  float* bs = reinterpret_cast<float*>(va_ring + (size_t)S * VA_STAGE_BYTES);
  int* bl = reinterpret_cast<int*>(bs + RING_CWARPS * 2 * a.cap);
  VaBuf top;
  top.s = bs + wp * 2 * a.cap;
  top.l = bl + wp * 2 * a.cap;
  top.n = 0;
  top.cap = a.cap;
  top.k = a.k;
  top.side = 0;
  top.ts = NEG_INF;
  top.tl = INT_MAX;
  int s = 0;
  unsigned par = 0;
  for (int i = 0; i < n; ++i) {
    mbar_wait(&full[s], par);
    if (a.mode == 2 && i < t0_tiles) {
      const unsigned char* st = va_ring + (size_t)s * VA_STAGE_BYTES;
      const float4* stf =
          reinterpret_cast<const float4*>(st + VA_ARRAY_BYTES);
      const int4* smsk =
          reinterpret_cast<const int4*>(st + 2 * VA_ARRAY_BYTES);
      const float4* sdl =
          reinterpret_cast<const float4*>(st + 3 * VA_ARRAY_BYTES);
      const int r0 = i * VA_TILE;
      const int nr = min(VA_TILE, a.rows[0] - r0);
      // nr x 32 groups: a multiple of 32, so every lane of a warp runs
      // the same trips and the warp's ballots see all 32
      for (int c = tid; c < nr * (BLK / 4); c += RING_CTHREADS) {
        const float4 tv = stf[c];
        const int4 mv = smsk[c];
        const float4 lv = sdl[c];
        const float tfv[4] = {tv.x, tv.y, tv.z, tv.w};
        const int mskv[4] = {mv.x, mv.y, mv.z, mv.w};
        const float dlv[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lane = r0 * BLK + c * 4 + j;
          const bool valid = lane >= rr && lane < rr + len0 &&
                             (mskv[j] & qmask0) != 0;
          const float norm =
              1.2f * (0.25f + 0.75f * dlv[j] / fmaxf(avgdl, 1e-9f));
          const float score = 2.0f * tfv[j] * 2.2f / (tfv[j] + norm);
          top.offer(valid, score, lane);
        }
      }
    }
    ring_release(&empty[s]);
    if (++s == S) {
      s = 0;
      par ^= 1u;
    }
  }

  int* od = a.out_docs + q * BLK;
  float* os = a.out_scores + q * BLK;
  int* oc = a.out_counts + q * BLK;
  oc[tid] = 0;
  if (a.mode == 1) {
    od[tid] = 0;
    os[tid] = 0.0f;
    return;
  }
  if (top.n > a.k) top.keep_best();
  if (ln == 0) {
    n_valid[wp] = top.n;
    n_half[wp] = top.side;
  }
  consumer_sync();
  int nv = 0;
  for (int w = 0; w < RING_CWARPS; ++w) nv += n_valid[w];
  nv = min(nv, a.k);
  // rank every warp's kept pairs among all of them; the best k take
  // their doc ids from the pivot window
  const int* pdocs =
      a.docs + win_row(start0, a.rows[0], a.n_rows) * BLK;
  for (int c = tid; c < RING_CWARPS * a.k; c += RING_CTHREADS) {
    const int w = c / a.k, e = c - w * a.k;
    if (e >= n_valid[w]) continue;
    const int off = (w * 2 + n_half[w]) * a.cap + e;
    const float cs = bs[off];
    const int cl = bl[off];
    int rank = 0;
    for (int w2 = 0; w2 < RING_CWARPS; ++w2) {
      const int base = (w2 * 2 + n_half[w2]) * a.cap;
      for (int j = 0; j < n_valid[w2]; ++j)
        rank += va_better(bs[base + j], bl[base + j], cs, cl);
    }
    if (rank < a.k) {
      od[rank] = pdocs[cl];
      os[rank] = cs;
    }
  }
  if (tid >= nv) {
    od[tid] = INT_MAX;
    os[tid] = NEG_INF;
  }
}

// A ring kernel's stages: the SM's shared memory split among the
// blocks a grid of `blocks` puts on each SM (at most `max_per_sm`), less
// each block's reserve, static shared memory and `extra` dynamic bytes
// beside the ring, is that block's share.  Of the `n_sizes` stage sizes
// `sizes` (widest first) the first of which three stages fit in the
// share, else the last; then as many stages as fit, three at least,
// RING_MAX_STAGES at most and no more than a block may hold.  Fills
// `plan` = [stages, dynamic shared bytes, the size's index]; returns a
// CUDA error.
template <typename K>
cudaError_t ring_plan(K kernel, int blocks, const int* sizes, int n_sizes,
                      int extra, int max_per_sm, int* plan) {
  int dev = 0, n_sm = 0, per_sm_smem = 0, optin = 0, reserve = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &per_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &reserve, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  const int per_sm = std::max(
      1, std::min(max_per_sm, (blocks + n_sm - 1) / std::max(1, n_sm)));
  const int fixed = (int)fa.sharedSizeBytes + extra;
  const int budget = per_sm_smem / per_sm - reserve - fixed;
  int i = 0;
  while (i + 1 < n_sizes && budget / sizes[i] < 3) ++i;
  const int most = (optin - fixed) / sizes[i];
  const int S =
      std::max(std::min({budget / sizes[i], most, RING_MAX_STAGES}), 3);
  if (S > most) return cudaErrorInvalidConfiguration;
  plan[0] = S;
  plan[1] = S * sizes[i] + extra;
  plan[2] = i;
  return cudaSuccess;
}

// probe_variant's candidate buffers: pairs a half, and the bytes of
// the four warps' two halves (the phase mode only).
__host__ __device__ constexpr int va_cap(int k) {
  return (2 * k > 64 ? 2 * k : 64) + 32;
}
constexpr int va_buf_bytes(int k, int mode) {
  return mode == 2 ? RING_CWARPS * 2 * va_cap(k) * 8 : 0;
}

// The staged gwin arm's stage sizes, widest tile first (up to
// PROBE_GW_TILE_MAX rows), and how many there are.
int gw_stage_sizes(int* sizes) {
  int n = 0;
  for (int rows : GW_TILES)
    if (rows <= PROBE_GW_TILE_MAX) sizes[n++] = 2 * rows * BLK * 4;
  return n;
}

// Opt a ring kernel in to `smem` bytes of dynamic shared memory and the
// largest shared-memory carveout.
template <typename K>
cudaError_t ring_attrs(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` and returns cudaGetLastError() (0 =
// launched).  Every pointer is a device pointer but `rows` (host).

// With `anys` (four pointers, host array) the `any` kernel, launched
// with `smem` bytes of dynamic shared memory; `grid` persistent blocks,
// 1 to B / G.
int rs_probe_floor_launch(const void* meta, int meta_cols, const void* fmeta,
                          void* out0, void* out_s, void* out_c, int fused,
                          int G, int B, const void* const* anys, int smem,
                          int grid, void* stream) {
  if (G < 1 || B % G != 0 || meta_cols < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (grid < 1 || grid > B / G) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FloorArgs a;
  a.meta = static_cast<const int*>(meta);
  a.meta_cols = meta_cols;
  a.fmeta = static_cast<const float*>(fmeta);
  a.out0 = static_cast<int*>(out0);
  a.out_s = static_cast<float*>(out_s);
  a.out_c = static_cast<int*>(out_c);
  a.fused = fused;
  a.G = G;
  a.n_groups = B / G;
  if (anys) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_floor_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    probe_floor_any_kernel<<<grid, BLK, smem, st>>>(a, anys[0], anys[1],
                                                    anys[2], anys[3]);
  } else {
    probe_floor_kernel<<<grid, BLK, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The staged arm runs the TMA ring (see ring_plan).
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
  a.stages = a.tile = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged) {
    int plan[3], sizes[3];
    const int n_sizes = gw_stage_sizes(sizes);
    cudaError_t e =
        ring_plan(probe_gwin_staged, B / G, sizes, n_sizes, 0, 4, plan);
    if (e == cudaSuccess) e = ring_attrs(probe_gwin_staged, plan[1]);
    if (e != cudaSuccess) return (int)e;
    a.stages = plan[0];
    a.tile = sizes[plan[2]] / (2 * BLK * 4);
    probe_gwin_staged<<<B / G, RING_THREADS, plan[1], st>>>(a);
  } else {
    probe_gwin_direct<<<B / G, GW_THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The TMA ring (see ring_plan; its stages from the B / G groups), on
// `grid` persistent blocks, 1 to B / G.  d 16-byte aligned.
int rs_probe_gcols_launch(const void* meta, const void* d, long long n_rows,
                          void* out, int B, int G, int grid, void* stream) {
  if (G < 1 || B % G != 0 || n_rows < GC_ROWS)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (grid < 1 || grid > B / G) return (int)cudaErrorInvalidValue;
  int plan[3];
  cudaError_t e =
      ring_plan(probe_gcols_ring, B / G, &GC_STAGE_BYTES, 1, 0, 4, plan);
  if (e == cudaSuccess) e = ring_attrs(probe_gcols_ring, plan[1]);
  if (e != cudaSuccess) return (int)e;
  GcolsArgs a;
  a.meta = static_cast<const int*>(meta);
  a.d = static_cast<const int*>(d);
  a.n_rows = n_rows;
  a.out = static_cast<float*>(out);
  a.G = G;
  a.n_groups = B / G;
  a.stages = plan[0];
  probe_gcols_ring<<<grid, RING_THREADS, plan[1],
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The load (1) and phase (2) modes run the TMA ring (see ring_plan);
// k at most 128.
int rs_probe_variant_launch(const void* meta, const void* fmeta,
                            const void* docs, const void* tfs,
                            const void* masks, const void* dl,
                            long long n_rows, int T, const int* rows, int k,
                            int mode, void* out_docs, void* out_scores,
                            void* out_counts, int B, void* stream) {
  if (T < 1 || T > VA_MAX_T || k < 1 || k > VA_MAX_K || mode < 0 || mode > 2)
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
  a.stages = 0;
  a.cap = va_cap(k);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    probe_variant_empty<<<B, VA_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  int plan[3];
  cudaError_t e = ring_plan(probe_variant_ring, B, &VA_STAGE_BYTES, 1,
                            va_buf_bytes(k, mode), 4, plan);
  if (e == cudaSuccess) e = ring_attrs(probe_variant_ring, plan[1]);
  if (e != cudaSuccess) return (int)e;
  a.stages = plan[0];
  probe_variant_ring<<<B, RING_THREADS, plan[1], st>>>(a);
  return (int)cudaGetLastError();
}

// The ring of a launch of `blocks` blocks (kernel 0: the staged gwin
// arm, B / G blocks; 1: probe_variant's load mode (k = 0) or phase mode
// at k, B blocks; 2: probe_gcols, `blocks` = its B / G groups): `out` =
// [stages, tile rows, dynamic shared bytes, static shared bytes,
// resident blocks an SM, registers a thread, local (spill) bytes a
// thread].  Returns a CUDA error.
int rs_probe_ring_info(int kernel, int blocks, int k, int* out) {
  if (kernel < 0 || kernel > 2 || blocks < 1 || k < 0 || k > VA_MAX_K)
    return (int)cudaErrorInvalidValue;
  int plan[3], sizes[3], tile;
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e;
  if (kernel == 0) {
    e = ring_plan(probe_gwin_staged, blocks, sizes, gw_stage_sizes(sizes), 0,
                  4, plan);
    tile = sizes[plan[2]] / (2 * BLK * 4);
    if (e == cudaSuccess) e = ring_attrs(probe_gwin_staged, plan[1]);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, probe_gwin_staged);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_gwin_staged, RING_THREADS, plan[1]);
  } else if (kernel == 1) {
    e = ring_plan(probe_variant_ring, blocks, &VA_STAGE_BYTES, 1,
                  va_buf_bytes(k, k ? 2 : 1), 4, plan);
    tile = VA_TILE;
    if (e == cudaSuccess) e = ring_attrs(probe_variant_ring, plan[1]);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, probe_variant_ring);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_variant_ring, RING_THREADS, plan[1]);
  } else {
    e = ring_plan(probe_gcols_ring, blocks, &GC_STAGE_BYTES, 1, 0, 4, plan);
    tile = GC_ROWS;
    if (e == cudaSuccess) e = ring_attrs(probe_gcols_ring, plan[1]);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, probe_gcols_ring);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_gcols_ring, RING_THREADS, plan[1]);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = plan[0];
  out[1] = tile;
  out[2] = plan[1];
  out[3] = (int)fa.sharedSizeBytes;
  out[4] = per_sm;
  out[5] = fa.numRegs;
  out[6] = (int)fa.localSizeBytes;
  return (int)cudaSuccess;
}

// What a persistent grid is sized from (kernel 0: probe_floor; 1: its
// `any` kernel at `smem` dynamic bytes; 2: probe_gcols, at the ring a
// launch of `n_groups` groups gets): `out` = [SMs, blocks of the kernel
// an SM holds at once].  Returns a CUDA error.
int rs_probe_resident(int kernel, int n_groups, int smem, int* out) {
  if (kernel < 0 || kernel > 2 || n_groups < 1 || smem < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (kernel == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_floor_kernel, BLK, 0);
  } else if (kernel == 1) {
    e = cudaFuncSetAttribute(probe_floor_any_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_floor_any_kernel, BLK, smem);
  } else {
    int plan[3];
    e = ring_plan(probe_gcols_ring, n_groups, &GC_STAGE_BYTES, 1, 0, 4, plan);
    if (e == cudaSuccess) e = ring_attrs(probe_gcols_ring, plan[1]);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_gcols_ring, RING_THREADS, plan[1]);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = n_sm;
  out[1] = per_sm;
  return (int)cudaSuccess;
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
