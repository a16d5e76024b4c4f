// Batched BM25 term-query intersection for Hopper (sm_90a), kernel B1.
//
// Replaces the Pallas TPU kernel `redisearch_tpu/ops/intersect.py`
// `_kernel` / `_kernel_query` (with its helpers `_member_pass`,
// `_extract_pass`; `pallas_call` at :1455), in its top-k and raw modes.
// It computes what `_xla_impl` computes, in the same floating-point
// operation order, so that its results are bit-identical with the plain
// torch version `intersect_plain` (build with --fmad=false and no
// fast-math: a fused multiply-add or an approximate division would round
// differently and could flip score ties).
//
// Bound: bytes.  A pivot phase reads its window's live postings once,
// 16 B a lane (doc, freq, mask, doc length), the member ranges it tests
// against (the doc of each probed member posting; freq and mask only
// where a doc is found), the meta row, and writes k lanes
// (top-k mode) or its whole section (raw mode).  The work is a few
// integer and f32 operations a byte, far below any compute rate.  The
// narrow groups of the main path do not reach that bound (PERF.md §6):
// the and2 group averages 352 live pivot postings and 0.15 matches a
// query, and its time splits into a fixed cost a query (meta, output
// filler, barriers), the pivot's loads and scores, and, the largest
// part, the member tests' binary searches.
//
// Design: one thread block per query (blocks walk queries blockIdx.x,
// blockIdx.x + gridDim.x, ...), in one of four shapes chosen at launch
// (B1_*_SHAPE below: narrow, mid and wide top-k, raw).
//   * Tiles.  Each pivot phase runs over its live lanes in tiles of
//     threads x lanes-a-thread, kept in registers (doc, doc length,
//     score, a valid bit); every load of a tile is issued before any is
//     used.  Nothing is pivot-sized: the top-k state is a fixed
//     shared-memory buffer, so a pivot of 131,072 lanes
//     (`MAX_W_MEMBER`) costs the same memory as one of 2,048, and there
//     is no global scratch.
//   * Member tests.  Each valid lane finds its doc's lower bound in the
//     member slot's live range by a binary search whose steps run for
//     all of a thread's lanes at once (the step count depends only on
//     the range), so their probes overlap; freq and mask are read only
//     where the doc is found, all of a tile's at once.  The search runs
//     in global memory (the member ranges stay in L1 and L2 across a
//     query's tiles) and crosses no barrier.  Staging the tile's member
//     sub-range in shared memory with cp.async was measured slower on
//     the main path's groups, the wide one included: its barriers and
//     copies cost more than the probes they save (PERF.md §6).
//   * A top-k that does not rescan.  The phase's running top-k (score
//     desc, lowest lane on ties) sits at the front of a shared buffer.
//     A tile appends only its lanes that beat the running k-th entry
//     (all valid lanes while fewer than k are held), one atomic a warp.
//     If the buffer then holds at most a block's threads of entries,
//     each entry is ranked by counting the entries before it; otherwise
//     a radix select over 64-bit keys (an order-preserving code of the
//     score, -0.0 folded into +0.0 so that the two tie as in the twin's
//     sort, above the complement of the lane) finds the k-th key in
//     8-bit digits over a shared histogram, from the first digit on
//     which the keys differ and stopping at the digit that settles it,
//     and the k entries at or above it are ranked among themselves.
//     Keys are unique, so the tie rule stays exact.  Phases of at most k
//     matches never select: they only rank.  The doc of each entry is
//     kept beside it.  No pass re-reads the phase's lanes, as k block-wide
//     arg-max passes would.  A warp-level select (a sorted list a warp, kept by a
//     bitonic sort of each 32 candidates and a merge, the lists ranked
//     against each other at the phase's end) was built and measured: no
//     faster on the narrow groups and slower on the wide one, with more
//     spills, so the shared buffer stays.
//   * Raw mode (plan[P_RAW], the FT.AGGREGATE GROUPBY path) keeps the
//     Pallas kernel's raw contract: per pivot phase a section of
//     W/128 + R_EXTRA rows of 128 lanes, lane j = posting
//     (start/128)*128 + j, live in [start%128, start%128 + len).  Its
//     tiles run the same member tests and write every lane straight to
//     the output (filler where dead).
//
// Built by redisearch_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface (ptxas reports registers and spills);
// loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// plan descriptor layout (mirrors ops/intersect.py _plan_array)
constexpr int PLAN_LEN = 128;
constexpr int P_T = 0, P_K = 1, P_PIVOT_G = 2, P_NGROUPS = 3, P_NDENSE = 4,
              P_NPIV = 5;
constexpr int P_WS = 6;      // window bucket per slot, 8 entries
constexpr int P_PIV = 14;    // pivot slots in phase order, 8 entries
constexpr int P_GRP = 22;    // groups: flag, src, nslots, slots[8]
constexpr int GRP_REC = 11;
constexpr int P_DNS = 110;   // dense predicates: flag, aux src, nv, meta col
constexpr int DNS_REC = 4;
constexpr int P_RAW = 120;   // 1 = raw mode
constexpr int BLK = 128;
constexpr int R_EXTRA = 8;   // raw sections: W / 128 + R_EXTRA rows
constexpr int MAX_W_PIVOT = 32768;   // past it a launch takes the wide shape

constexpr int MAX_AUX = 4;
constexpr int MAX_META = 64;
constexpr int MAX_FMETA = 32;
constexpr int KMAX = 64;
constexpr unsigned FULL = 0xffffffffu;

// The block shapes: threads, lanes a thread takes per tile, blocks an SM
// at least.  A query's time is a chain of tiles, so a batch that leaves
// the card's SMs short of blocks wants large tiles, and a batch that
// fills them wants many small blocks.  Chosen at launch from the pivot
// bucket and the batch, as measured over every group of the main path's
// eight families (PERF.md): pivots of at most NARROW_W lanes take the
// narrow shape where the batch has at least FILL_BLOCKS queries an SM,
// else the mid one; wider pivots take the mid shape where it has at
// least FEW_BLOCKS queries an SM, else (and past MAX_W_PIVOT always) the
// wide one, whose large tiles shorten a long pivot's chain.  A timing
// build (bench/ab.py) may define a shape before including this file.
#ifndef B1_NARROW_SHAPE
#define B1_NARROW_SHAPE 128, 2, 12
#endif
#ifndef B1_MID_SHAPE
#define B1_MID_SHAPE 256, 4, 4
#endif
#ifndef B1_RAW_SHAPE
#define B1_RAW_SHAPE 256, 2, 4
#endif
#ifndef B1_WIDE_SHAPE
#define B1_WIDE_SHAPE 512, 4, 1
#endif
// Timing builds only (bench/ab.py): 1 takes out the member tests and the
// top-k or raw output, 2 every live lane.  Their results are wrong.
#ifndef B1_TIME_PART
#define B1_TIME_PART 0
#endif
constexpr int NARROW_W = 2048;
constexpr int FILL_BLOCKS = 8;
constexpr int FEW_BLOCKS = 2;

constexpr int REQ = 0, NOT_ = 1;   // OPT = 2 is the remaining case
constexpr int INF_DOC = 2147483647;
constexpr float NEG_INF = -3.4e38f;
constexpr float K1 = 1.2f;
constexpr float K1P1 = 2.2f;        // K1 + 1.0, rounded to f32 once
constexpr float BM_B = 0.75f;
constexpr float ONE_MINUS_B = 0.25f;

struct Plan {
  int v[PLAN_LEN];
};

struct Args {
  const int* meta;
  const float* fmeta;
  const int* doc_ids;
  const float* freqs;
  const int* masks;
  const float* dl;
  const int* aux[MAX_AUX];
  long long aux_n[MAX_AUX];
  long long n_post;
  int* out_docs;
  float* out_scores;
  int* out_counts;
  int n_meta;
  int n_fmeta;
  int out_cols;
  int B;
};

// BM25STD in `_xla_impl`'s operation order:
//   norm = K1 * ((1 - B) + (B * dl) / max(avgdl, 1e-9))
//   score = ((w * tf) * (K1 + 1)) / (tf + norm)
__device__ __forceinline__ float bm25(float tf, float w, float dl,
                                      float avgdl) {
  float norm = K1 * (ONE_MINUS_B + (BM_B * dl) / fmaxf(avgdl, 1e-9f));
  return ((w * tf) * K1P1) / (tf + norm);
}

// `lax.dynamic_slice` clamps a window start into [0, n - W]
__device__ __forceinline__ long long clamp_start(long long st, long long n,
                                                 int W) {
  long long hi = n - W;
  if (hi < 0) hi = 0;
  return st < 0 ? 0 : (st > hi ? hi : st);
}

// Order key of a top-k entry, larger first: an order-preserving code of
// the score (-0.0 folded into +0.0, which compare equal), then the lower
// lane.  Unique per lane.
__device__ __forceinline__ unsigned long long topk_key(float s, int lane) {
  const unsigned u = __float_as_uint(s + 0.0f);
  const unsigned c = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)c << 32) | (unsigned)(~lane);
}

// whether entry (s, l) comes before entry (s2, l2) in the output
__device__ __forceinline__ bool before(float s, int l, float s2, int l2) {
  return s > s2 || (s == s2 && l < l2);
}

template <int THREADS, int LPT>
struct B1 {
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TILE = THREADS * LPT;   // pivot lanes per tile
  static constexpr int RANK_N = THREADS;       // at most this many: rank

  struct Smem {
    int plan[PLAN_LEN];
    int meta[MAX_META];
    float fmeta[MAX_FMETA];
    const int* aux[MAX_AUX];
    long long aux_n[MAX_AUX];
    // top-k mode: the running top-k (sorted) then the tile's candidates;
    // during a tile's member tests [KMAX, KMAX + TILE) of buf_sc holds
    // each lane's group sum
    float buf_sc[KMAX + TILE];
    int buf_lane[KMAX + TILE];
    int buf_doc[KMAX + TILE];
    float top_sc[KMAX];
    int top_lane[KMAX];
    int top_doc[KMAX];
    unsigned hist[256];
    int red_a[WARPS];
    unsigned long long red_k[2 * WARPS];
    int n_buf;
    int n_sel;
    int sel_bin;
    int sel_above;
    int sel_cnt;
  };

  // Membership of slot u (text postings when src < 0, else the doc
  // window array aux[src]) for this thread's valid lanes (bits of
  // vmask): calls on_lane(j, hit, tf) for each valid lane j (hit = found
  // and, for text, mask-valid; tf its freq, 0 without a hit) and returns
  // the hits as bits.  The lanes search the slot's live range in global
  // memory; no barrier is crossed.
  template <class F>
  static __device__ __forceinline__ unsigned member_pass(
      const Smem& sm, const Args& a, int T, int u, int src,
      const int (&pd)[LPT], unsigned vmask, F on_lane) {
    const int Wu = sm.plan[P_WS + u];
    const long long stu =
        clamp_start(sm.meta[u], src < 0 ? a.n_post : sm.aux_n[src], Wu);
    const int n = min(max(sm.meta[T + u], 0), Wu);
    const int* md = (src < 0 ? a.doc_ids : sm.aux[src]) + stu;
    // lower bounds of the lanes' docs in md[0, n), one step for every
    // lane at a time (the step count depends on n alone), so the lanes'
    // probes overlap: md[pos] is the last entry below the doc, or 0
    int pos[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) pos[j] = 0;
    for (int len = vmask ? n : 0; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if ((vmask >> j) & 1u)
          pos[j] = __ldg(md + pos[j] + half) < pd[j] ? pos[j] + half : pos[j];
      len -= half;
    }
    // the docs found; then, for text, every found posting's mask and
    // freq loads at once (one latency for the tile, not one a lane)
    unsigned found = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (!((vmask >> j) & 1u) || n == 0) continue;
      if (__ldg(md + pos[j]) < pd[j]) ++pos[j];
      if (pos[j] < n && __ldg(md + pos[j]) == pd[j]) found |= 1u << j;
    }
    const int qm = sm.meta[2 * T + u];
    int mk[LPT];
    float tf[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const bool f = src < 0 && ((found >> j) & 1u);
      mk[j] = f ? __ldg(a.masks + stu + pos[j]) : 0;
      tf[j] = f ? __ldg(a.freqs + stu + pos[j]) : 0.0f;
    }
    unsigned hits = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (!((vmask >> j) & 1u)) continue;
      const bool hit = ((found >> j) & 1u) && (src >= 0 || (mk[j] & qm) != 0);
      if (hit) hits |= 1u << j;
      on_lane(j, hit, hit ? tf[j] : 0.0f);
    }
    return hits;
  }

  // Rank the m entries of (src_sc, src_lane, src_doc) and write the
  // first min(k, m) in output order to the dst arrays.  The caller
  // synchronises after.
  static __device__ __forceinline__ void rank_into(
      const float* src_sc, const int* src_lane, const int* src_doc, int m,
      int k, float* dst_sc, int* dst_lane, int* dst_doc) {
    for (int t = threadIdx.x; t < m; t += THREADS) {
      const float s = src_sc[t];
      const int l = src_lane[t];
      int rank = 0;
      for (int e = 0; e < m; ++e)
        rank += before(src_sc[e], src_lane[e], s, l) ? 1 : 0;
      if (rank < k) {
        dst_sc[rank] = s;
        dst_lane[rank] = l;
        dst_doc[rank] = src_doc[t];
      }
    }
  }

  // One tile's step of the phase top-k: append the valid lanes that beat
  // the running k-th entry, then keep the best k at the buffer's front,
  // sorted.  Every thread of the block calls it; it ends synchronised.
  static __device__ __forceinline__ void topk_tile(Smem& sm, int k,
                                                   unsigned vmask,
                                                   const float (&sc)[LPT],
                                                   const int (&pd)[LPT],
                                                   int t0) {
    const int n_r = sm.n_buf;
    const bool full = n_r >= k;
    const float thr_s = full ? sm.buf_sc[k - 1] : 0.0f;
    const int thr_l = full ? sm.buf_lane[k - 1] : 0;
    __syncthreads();   // every thread has read n_buf before it grows
    const int wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int lane = t0 + j * THREADS + threadIdx.x;
      const bool take = ((vmask >> j) & 1u) &&
                        (!full || before(sc[j], lane, thr_s, thr_l));
      // one atomic a warp: the leader reserves the warp's slots
      const unsigned ball = __ballot_sync(FULL, take);
      if (ball == 0u) continue;
      const int leader = __ffs(ball) - 1;
      int base = 0;
      if (wl == leader) base = atomicAdd(&sm.n_buf, __popc(ball));
      base = __shfl_sync(FULL, base, leader);
      if (take) {
        const int at = base + __popc(ball & ((1u << wl) - 1u));
        sm.buf_sc[at] = sc[j];
        sm.buf_lane[at] = lane;
        sm.buf_doc[at] = pd[j];
      }
    }
    __syncthreads();
    const int n = sm.n_buf;
    if (n == n_r) return;
    if (n <= RANK_N) {
      rank_into(sm.buf_sc, sm.buf_lane, sm.buf_doc, n, k, sm.top_sc,
                sm.top_lane, sm.top_doc);
      __syncthreads();
      const int m = min(k, n);
      for (int i = threadIdx.x; i < m; i += THREADS) {
        sm.buf_sc[i] = sm.top_sc[i];
        sm.buf_lane[i] = sm.top_lane[i];
        sm.buf_doc[i] = sm.top_doc[i];
      }
      if (threadIdx.x == 0) sm.n_buf = m;
      __syncthreads();
      return;
    }
    // radix select of the k-th largest key, 8 bits a pass from the top,
    // from the first digit on which the keys differ (scores share their
    // sign and most of their exponent: their passes would count every
    // key into one bin)
    unsigned long long kmin = ~0ull, kmax = 0ull;
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const unsigned long long key = topk_key(sm.buf_sc[e], sm.buf_lane[e]);
      kmin = key < kmin ? key : kmin;
      kmax = key > kmax ? key : kmax;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long a0 = __shfl_xor_sync(FULL, kmin, off);
      const unsigned long long b0 = __shfl_xor_sync(FULL, kmax, off);
      kmin = a0 < kmin ? a0 : kmin;
      kmax = b0 > kmax ? b0 : kmax;
    }
    if (wl == 0) {
      sm.red_k[threadIdx.x >> 5] = kmin;
      sm.red_k[WARPS + (threadIdx.x >> 5)] = kmax;
    }
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) {
      kmin = sm.red_k[w] < kmin ? sm.red_k[w] : kmin;
      kmax = sm.red_k[WARPS + w] > kmax ? sm.red_k[WARPS + w] : kmax;
    }
    // digits every key shares (keys are unique: at most 7)
    const int same = __clzll((long long)(kmin ^ kmax)) / 8;
    unsigned long long pmask = same ? ~0ull << (64 - 8 * same) : 0ull;
    unsigned long long prefix = kmin & pmask;
    int rem = k;
    for (int shift = 56 - 8 * same; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < 256; i += THREADS) sm.hist[i] = 0u;
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += THREADS) {
        const unsigned long long key =
            topk_key(sm.buf_sc[e], sm.buf_lane[e]);
        if ((key & pmask) == prefix)
          atomicAdd(&sm.hist[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        // lane L holds bins 255 - 8L down to 248 - 8L
        const int L = threadIdx.x;
        unsigned c[8];
        unsigned s = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          c[b] = sm.hist[255 - 8 * L - b];
          s += c[b];
        }
        unsigned inc = s;
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned y = __shfl_up_sync(FULL, inc, off);
          if (L >= off) inc += y;
        }
        unsigned above = inc - s;
        if (above < (unsigned)rem && (unsigned)rem <= inc) {
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            if (above + c[b] >= (unsigned)rem) {
              sm.sel_bin = 255 - 8 * L - b;
              sm.sel_above = (int)above;
              sm.sel_cnt = (int)c[b];
              break;
            }
            above += c[b];
          }
        }
      }
      __syncthreads();
      rem -= sm.sel_above;
      prefix |= (unsigned long long)sm.sel_bin << shift;
      pmask |= 0xffull << shift;
      if (sm.sel_cnt == rem) break;   // the whole boundary bin is taken
    }
    // the k entries at or above the boundary, unsorted, then ranked
    if (threadIdx.x == 0) sm.n_sel = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const unsigned long long key = topk_key(sm.buf_sc[e], sm.buf_lane[e]);
      if ((key & pmask) >= prefix) {
        const int at = atomicAdd(&sm.n_sel, 1);
        sm.top_sc[at] = sm.buf_sc[e];
        sm.top_lane[at] = sm.buf_lane[e];
        sm.top_doc[at] = sm.buf_doc[e];
      }
    }
    __syncthreads();
    rank_into(sm.top_sc, sm.top_lane, sm.top_doc, k, k, sm.buf_sc,
              sm.buf_lane, sm.buf_doc);
    if (threadIdx.x == 0) sm.n_buf = k;
    __syncthreads();
  }

  static __device__ __forceinline__ void run(const Plan& plan,
                                             const Args& a) {
    __shared__ Smem sm;

    for (int i = threadIdx.x; i < PLAN_LEN; i += THREADS)
      sm.plan[i] = plan.v[i];
    if (threadIdx.x < MAX_AUX) {
      sm.aux[threadIdx.x] = a.aux[threadIdx.x];
      sm.aux_n[threadIdx.x] = a.aux_n[threadIdx.x];
    }
    const int tid = threadIdx.x;
    const bool raw = plan.v[P_RAW] != 0;
    // lane j's group sum: gadd[j * THREADS]
    float* gadd = sm.buf_sc + KMAX + tid;

    for (int q = blockIdx.x; q < a.B; q += gridDim.x) {
      __syncthreads();   // the previous query is done with shared state
      for (int i = tid; i < a.n_meta; i += THREADS)
        sm.meta[i] = a.meta[(long long)q * a.n_meta + i];
      for (int i = tid; i < a.n_fmeta; i += THREADS)
        sm.fmeta[i] = a.fmeta[(long long)q * a.n_fmeta + i];

      int* od = a.out_docs + (long long)q * a.out_cols;
      float* os = a.out_scores + (long long)q * a.out_cols;
      if (!raw) {   // raw mode writes every lane of its sections below
        for (int i = tid; i < a.out_cols; i += THREADS) {
          od[i] = INF_DOC;
          os[i] = NEG_INF;
        }
      }
      __syncthreads();

      const int T = sm.plan[P_T];
      const int k = sm.plan[P_K];
      const int pivot_g = sm.plan[P_PIVOT_G];
      const int n_groups = sm.plan[P_NGROUPS];
      const int n_dense = sm.plan[P_NDENSE];
      const int n_piv = sm.plan[P_NPIV];
      const float avgdl = sm.fmeta[T];
      int total = 0;
      long long out_off = 0;   // raw mode: this phase's section

      for (int pi = 0; pi < n_piv; ++pi) {
        const int p = sm.plan[P_PIV + pi];
        const int Wp = sm.plan[P_WS + p];
        const int qmp = sm.meta[2 * T + p];
        const float twp = sm.fmeta[p];
        // candidate lane i reads posting stp + i; live lanes are
        // [live_lo, live_hi).  Top-k: the clamped window's first len
        // lanes.  Raw: whole rows from the start's row (a len past the
        // section's lanes changes nothing, so it is clamped to them).
        long long stp;
        int live_lo, live_hi, n_lanes;
        if (raw) {
          const int st = sm.meta[p];
          stp = (long long)(st >= 0 ? st / BLK : -((-st + BLK - 1) / BLK)) *
                BLK;
          n_lanes = Wp + R_EXTRA * BLK;
          live_lo = (int)(st - stp);
          live_hi = live_lo + min(max(sm.meta[T + p], 0), n_lanes);
        } else {
          stp = clamp_start(sm.meta[p], a.n_post, Wp);
          live_lo = 0;
          live_hi = min(max(sm.meta[T + p], 0), Wp);
          n_lanes = live_hi;
        }
        __syncthreads();   // the previous phase's output is written
        if (tid == 0) sm.n_buf = 0;
        __syncthreads();   // before any thread's first top-k step reads it
        int my_cnt = 0;

        for (int t0 = 0; t0 < n_lanes; t0 += TILE) {
          // the tile's pivot postings: every load issued before any is
          // used, then the scores and the dense predicates
          int pd[LPT];
          float dl[LPT], sc[LPT];
          unsigned vmask = 0;
          {
            int mk[LPT];
            float fr[LPT];
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              const int i = t0 + j * THREADS + tid;
              const bool live = B1_TIME_PART != 2 && i < n_lanes &&
                                i >= live_lo && i < live_hi;
              const long long gi = stp + (live ? i : 0);
              pd[j] = live ? __ldg(a.doc_ids + gi) : INF_DOC;
              dl[j] = live ? __ldg(a.dl + gi) : 0.0f;
              mk[j] = live ? __ldg(a.masks + gi) : 0;
              fr[j] = live ? __ldg(a.freqs + gi) : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              const bool valid = (mk[j] & qmp) != 0;
              sc[j] = valid ? bm25(fr[j], twp, dl[j], avgdl) : 0.0f;
              if (valid) vmask |= 1u << j;
            }
          }
          // dense posting-aligned TAG code predicates, in order
          for (int di = 0; di < n_dense; ++di) {
            const int o = P_DNS + di * DNS_REC;
            const int fl = sm.plan[o], src = sm.plan[o + 1];
            const int nv = sm.plan[o + 2], mcol = sm.plan[o + 3];
            const long long stc =
                raw ? stp : clamp_start(sm.meta[p], sm.aux_n[src], Wp);
            const float dconst = sm.fmeta[T + 1 + di];
            int cw[LPT];
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              const int i = t0 + j * THREADS + tid;
              cw[j] = ((vmask >> j) & 1u) ? __ldg(sm.aux[src] + stc + i) : 0;
            }
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              if (!((vmask >> j) & 1u)) continue;
              bool hitd = false;
              for (int v = 0; v < nv; ++v) hitd |= (cw[j] == sm.meta[mcol + v]);
              if (fl == REQ) {
                if (!hitd) vmask &= ~(1u << j);
                sc[j] = sc[j] + (hitd ? dconst : 0.0f);
              } else if (fl == NOT_) {
                if (hitd) vmask &= ~(1u << j);
              } else {
                sc[j] = sc[j] + (hitd ? dconst : 0.0f);
              }
            }
          }
          if (B1_TIME_PART != 1 && vmask != 0u) {
            // pivot-group siblings: earlier ones own their docs
            // (dedup+fold), later ones fold their score in
            for (int pj = 0; pj < n_piv; ++pj) {
              if (pj == pi) continue;
              const int u = sm.plan[P_PIV + pj];
              const float wu = sm.fmeta[u];
              const unsigned hits = member_pass(
                  sm, a, T, u, -1, pd, vmask,
                  [&](int j, bool hit, float tf) {
                    sc[j] = sc[j] +
                            (hit ? bm25(tf, wu, dl[j], avgdl) : 0.0f);
                  });
              if (pj < pi) vmask &= ~hits;
            }
            // the other groups, in order
            for (int g = 0; g < n_groups; ++g) {
              if (g == pivot_g) continue;
              const int o = P_GRP + g * GRP_REC;
              const int fl = sm.plan[o], gsrc = sm.plan[o + 1];
              const int ns = sm.plan[o + 2];
              unsigned ghit = 0;
#pragma unroll
              for (int j = 0; j < LPT; ++j) gadd[j * THREADS] = 0.0f;
              for (int js = 0; js < ns; ++js) {
                const int u = sm.plan[o + 3 + js];
                const float wu = sm.fmeta[u];
                ghit |= member_pass(
                    sm, a, T, u, gsrc, pd, vmask,
                    [&](int j, bool hit, float tf) {
                      if (gsrc < 0)
                        gadd[j * THREADS] =
                            gadd[j * THREADS] +
                            (hit ? bm25(tf, wu, dl[j], avgdl) : 0.0f);
                    });
              }
              // doc-window (tag) groups score their leaf constant once
              const float leaf = sm.fmeta[sm.plan[o + 3]];
              if (fl != NOT_) {
#pragma unroll
                for (int j = 0; j < LPT; ++j) {
                  if (!((vmask >> j) & 1u)) continue;
                  const float ga =
                      gsrc >= 0 ? (((ghit >> j) & 1u) ? leaf : 0.0f)
                                : gadd[j * THREADS];
                  sc[j] = sc[j] + ga;
                }
              }
              if (fl == REQ) vmask &= ghit;
              else if (fl == NOT_) vmask &= ~ghit;
            }
          }

          my_cnt += __popc(vmask);
          if (B1_TIME_PART == 1) {   // keep the pivot's loads and scores
            my_cnt += (sc[0] == 1.2345f ? 1 : 0) + (pd[LPT - 1] == 7 ? 1 : 0);
            vmask = 0u;
          }
          if (raw) {
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              const int i = t0 + j * THREADS + tid;
              if (i >= n_lanes) continue;
              const bool live = i >= live_lo && i < live_hi;
              const bool v = live && ((vmask >> j) & 1u);
              od[out_off + i] = v ? pd[j] : INF_DOC;
              os[out_off + i] = v ? sc[j] : NEG_INF;
            }
          } else {
            topk_tile(sm, k, vmask, sc, pd, t0);
          }
        }

        // block-wide match count of this phase
        int cnt = my_cnt;
        for (int off = 16; off > 0; off >>= 1)
          cnt += __shfl_xor_sync(FULL, cnt, off);
        if ((tid & 31) == 0) sm.red_a[tid >> 5] = cnt;
        __syncthreads();
        cnt = 0;
        for (int w = 0; w < WARPS; ++w) cnt += sm.red_a[w];
        total += cnt;
        if (!raw) {   // the phase's top-k lanes; later lanes keep the filler
          const int m = min(k, sm.n_buf);
          for (int i = tid; i < m; i += THREADS) {
            od[pi * k + i] = sm.buf_doc[i];
            os[pi * k + i] = sm.buf_sc[i];
          }
        }
        out_off += n_lanes;
      }
      if (tid == 0) a.out_counts[q] = total;
    }
  }
};

template <int THREADS, int LPT, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
intersect_kernel(const Plan plan, const Args a) {
  B1<THREADS, LPT>::run(plan, a);
}

template <int THREADS, int LPT, int MIN_BLOCKS>
int launch(const Plan& plan, const Args& a, int grid, cudaStream_t st) {
  intersect_kernel<THREADS, LPT, MIN_BLOCKS>
      <<<grid, THREADS, 0, st>>>(plan, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// Every pointer is a device pointer except `plan_host`, the int32[128]
// descriptor, which travels by value in the kernel's parameters.  Raw
// mode takes the raw block shape; top-k mode the narrow, mid or wide one
// by the pivot bucket and the batch (see B1_NARROW_SHAPE).
int rs_intersect_launch(const void* meta, int n_meta, const void* fmeta,
                        int n_fmeta, const void* doc_ids, const void* freqs,
                        const void* masks, const void* dl, long long n_post,
                        const void* const* aux_p, const long long* aux_n,
                        const void* plan_host, void* out_docs,
                        void* out_scores, void* out_counts, int out_cols,
                        int B, int grid, void* stream) {
  if (n_meta > MAX_META || n_fmeta > MAX_FMETA || grid < 1)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  memcpy(plan.v, plan_host, sizeof(plan.v));
  if (plan.v[P_K] < 1 || plan.v[P_K] > KMAX)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.meta = static_cast<const int*>(meta);
  a.fmeta = static_cast<const float*>(fmeta);
  a.doc_ids = static_cast<const int*>(doc_ids);
  a.freqs = static_cast<const float*>(freqs);
  a.masks = static_cast<const int*>(masks);
  a.dl = static_cast<const float*>(dl);
  for (int i = 0; i < MAX_AUX; ++i) {
    a.aux[i] = static_cast<const int*>(aux_p[i]);
    a.aux_n[i] = aux_n[i];
  }
  a.n_post = n_post;
  a.out_docs = static_cast<int*>(out_docs);
  a.out_scores = static_cast<float*>(out_scores);
  a.out_counts = static_cast<int*>(out_counts);
  a.n_meta = n_meta;
  a.n_fmeta = n_fmeta;
  a.out_cols = out_cols;
  a.B = B;
  int w_piv = 0;
  for (int pi = 0; pi < plan.v[P_NPIV]; ++pi)
    w_piv = w_piv > plan.v[P_WS + plan.v[P_PIV + pi]]
                ? w_piv
                : plan.v[P_WS + plan.v[P_PIV + pi]];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan.v[P_RAW]) return launch<B1_RAW_SHAPE>(plan, a, grid, st);
  static int n_sm = 0;   // the card's SMs, read once
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (w_piv <= NARROW_W)
    return B >= FILL_BLOCKS * n_sm ? launch<B1_NARROW_SHAPE>(plan, a, grid, st)
                                   : launch<B1_MID_SHAPE>(plan, a, grid, st);
  if (w_piv > MAX_W_PIVOT || B < FEW_BLOCKS * n_sm)
    return launch<B1_WIDE_SHAPE>(plan, a, grid, st);
  return launch<B1_MID_SHAPE>(plan, a, grid, st);
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
