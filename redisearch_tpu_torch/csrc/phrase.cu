// Batched exact / in-order slop phrase search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `redisearch_tpu/ops/intersect.py`
// `_phrase_kernel` (with its helpers `_member_min_ge` and
// `_member_pass`).  It computes what `_xla_phrase_impl`, its XLA twin,
// computes, in the same floating-point operation order, so that its
// results are bit-identical with the plain torch version `phrase_plain`
// (build with --fmad=false and no fast-math, as for intersect.cu).
//
// Semantics (T = 2..4 terms, position keys doc * stride + pos, each
// term's keys sorted):
//   * chain: every live key of term 0 is an anchor; each later term j
//     advances to its smallest key >= anchor; the key must exist, lie in
//     the anchor's doc, and the running span sum(found - anchor - 1) must
//     stay <= max(slop, 0).  An equal key is accepted (span -1), so a
//     repeated term matches every doc that holds it;
//   * fold: a doc of term 0's posting window is a hit when one of its
//     keys survived the chain and every slot has postings (validity
//     reads positions only);
//   * score: slot 0 adds BM25 where its posting is mask-valid, each later
//     slot adds BM25 at its own posting of the doc where mask-valid, in
//     slot order, all with slot 0's doc length.  A hit with no
//     mask-valid slot scores 0.0 and still counts;
//   * top-k (k <= 64, score desc, lowest lane on ties) with
//     (INT32_MAX, -3.4e38) filler plus the hit count, or, in raw mode,
//     the masked (doc, score) lanes of term 0's section: Ws[0] / 128 +
//     R_EXTRA rows of 128 lanes, lane j = posting (start/128)*128 + j.
//
// Design (a simple, correct first version; the TPU's 128x128
// pair-predicated tiles and VMEM DMAs exist because gathers are slow
// there, and are not carried over):
//   * one thread block per query, blocks walking queries blockIdx.x,
//     blockIdx.x + gridDim.x, ...;
//   * chain: threads stride over term 0's live key window; a thread runs
//     one key's whole chain in registers, one lower_bound over term j's
//     live keys (in global memory) per step; each warp's 32 results
//     become one word of a shared-memory bitmap (__ballot_sync), 131,072
//     keys in 16 KB;
//   * fold: threads stride over term 0's live postings; two lower_bounds
//     over term 0's keys bound the doc's keys, and a scan of those bits
//     decides the hit.  When no key survived (most queries of a random
//     phrase mix), the fold is skipped;
//   * top-k: the scores go to this block's row of a global scratch
//     (docs are re-read from the posting window), then min(k, hits)
//     block-wide arg-max passes, as in intersect.cu.  Raw mode writes
//     every lane of its section straight to the output, no scratch.
//
// What bounds it on this card: the dependent global-memory probes of
// the chain, (T-1) * log2(PW) per key of term 0, then the fold's two
// searches per posting, and the serial arg-max passes (a block-wide
// reduction and two barriers per extracted hit).  Later work: staging
// the key windows in shared memory, merge-path chains over the sorted
// windows instead of per-key searches, pivoting 2-term exact phrases on
// the smaller key window where positions are not clamped, and a
// warp-level top-k.
//
// Built by redisearch_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// parameter block layout (mirrors ops/intersect.py _phrase_params)
constexpr int PRM_LEN = 16;
constexpr int P_T = 0, P_STRIDE = 1, P_SLOP = 2, P_K = 3, P_RAW = 4,
              P_OUT_COLS = 5, P_SCR_COLS = 6, P_B = 7;
constexpr int P_WS = 8;     // posting window bucket per slot, 4 entries
constexpr int P_PWS = 12;   // key window bucket per slot, 4 entries

constexpr int MAX_T = 4;
constexpr int MAX_PW = 131072;          // term 0's keys: the bitmap size
constexpr int BLK = 128;
constexpr int R_EXTRA = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

constexpr int INF_KEY = 2147483647;
constexpr float NEG_INF = -3.4e38f;
constexpr float K1 = 1.2f;
constexpr float K1P1 = 2.2f;        // K1 + 1.0, rounded to f32 once
constexpr float BM_B = 0.75f;
constexpr float ONE_MINUS_B = 0.25f;

struct Params {
  int v[PRM_LEN];
};

struct Args {
  const int* meta;      // [B, 5T]
  const float* fmeta;   // [B, T + 1]
  const int* doc_ids;
  const float* freqs;
  const int* masks;
  const float* dl;
  const int* poskeys;
  long long n_post;
  long long n_keys;
  int* out_docs;
  float* out_scores;
  int* out_counts;
  float* scr;           // [grid, scr_cols] top-k scores scratch
};

// BM25STD in `_xla_phrase_impl`'s operation order (see intersect.cu)
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

// first index in a[0, n) whose value is >= x (a ascending)
__device__ __forceinline__ int lower_bound(const int* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// whether any bit of [lo, hi) is set
__device__ __forceinline__ bool any_bit(const unsigned* bits, int lo,
                                        int hi) {
  while (lo < hi) {
    const int w = lo >> 5, b = lo & 31;
    const int nb = min(hi - lo, 32 - b);
    unsigned m = bits[w] >> b;
    if (nb < 32) m &= (1u << nb) - 1u;
    if (m) return true;
    lo += nb;
  }
  return false;
}

__global__ void __launch_bounds__(THREADS)
phrase_kernel(const Params prm, const Args a) {
  __shared__ unsigned s_ok[MAX_PW / 32];   // chain survivors of term 0
  __shared__ int s_meta[5 * MAX_T];
  __shared__ float s_fmeta[MAX_T + 1];
  __shared__ long long s_kst[MAX_T];       // key window starts (clamped)
  __shared__ int s_kn[MAX_T];              // live keys per term
  __shared__ long long s_mst[MAX_T];       // posting window starts
  __shared__ int s_mn[MAX_T];              // live postings per slot
  __shared__ float s_red_s[WARPS];
  __shared__ int s_red_i[WARPS];
  __shared__ int s_cnt;
  __shared__ int s_any;

  const int T = prm.v[P_T];
  const int stride = prm.v[P_STRIDE];
  const int slop = max(prm.v[P_SLOP], 0);
  const int k = prm.v[P_K];
  const bool raw = prm.v[P_RAW] != 0;
  const int out_cols = prm.v[P_OUT_COLS];
  const int B = prm.v[P_B];
  const int W0 = prm.v[P_WS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ss = raw ? nullptr
                  : a.scr + (long long)blockIdx.x * prm.v[P_SCR_COLS];

  for (int q = blockIdx.x; q < B; q += gridDim.x) {
    __syncthreads();   // the previous query is done with shared state
    if (tid < 5 * T) s_meta[tid] = a.meta[(long long)q * 5 * T + tid];
    if (tid < T + 1) s_fmeta[tid] = a.fmeta[(long long)q * (T + 1) + tid];
    if (tid == 0) s_any = 0;
    __syncthreads();
    if (tid < T) {
      const int PW = prm.v[P_PWS + tid], W = prm.v[P_WS + tid];
      s_kst[tid] = clamp_start(s_meta[3 * T + tid], a.n_keys, PW);
      s_kn[tid] = min(max(s_meta[4 * T + tid], 0), PW);
      s_mst[tid] = clamp_start(s_meta[tid], a.n_post, W);
      s_mn[tid] = min(max(s_meta[T + tid], 0), W);
    }
    int* od = a.out_docs + (long long)q * out_cols;
    float* os = a.out_scores + (long long)q * out_cols;
    if (!raw) {   // raw mode writes every lane of its section below
      for (int i = tid; i < out_cols; i += THREADS) {
        od[i] = INF_KEY;
        os[i] = NEG_INF;
      }
    }
    __syncthreads();

    // ---- chain over term 0's live keys, one key per thread
    const int* keys0 = a.poskeys + s_kst[0];
    const int n0 = s_kn[0];
    unsigned seen = 0;
    for (int base = 0; base < n0; base += THREADS) {
      const int i = base + tid;
      bool ok = false;
      if (i < n0) {
        int anchor = keys0[i];   // live keys are >= 0: / is jnp's //
        ok = anchor != INF_KEY;
        const int doc0 = anchor / stride;
        int span = 0;
        for (int j = 1; j < T && ok; ++j) {
          const int* kj = a.poskeys + s_kst[j];
          const int nj = s_kn[j];
          const int at = lower_bound(kj, nj, anchor);
          const int found = at < nj ? kj[at] : INF_KEY;
          ok = found != INF_KEY && found >= anchor &&
               found / stride == doc0;
          if (ok) {
            span += found - anchor - 1;   // same doc: |step| < stride
            ok = span <= slop;
            anchor = found;
          }
        }
      }
      const unsigned word = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) s_ok[(base >> 5) + warp] = word;
      seen |= word;
    }
    if (lane == 0 && seen) s_any = 1;
    __syncthreads();

    // ---- fold to term 0's postings, score
    bool anylen = true;
    for (int t = 0; t < T; ++t) anylen = anylen && s_meta[T + t] > 0;
    const bool possible = anylen && s_any != 0;
    // posting lane i reads stp + i; live lanes are [live_lo, live_hi).
    // Top-k: the clamped window's first len lanes.  Raw: whole rows
    // from the start's row.
    long long stp;
    int live_lo, live_hi, n_lanes;
    if (raw) {
      const int st = s_meta[0];
      stp = (long long)(st >= 0 ? st / BLK : -((-st + BLK - 1) / BLK)) * BLK;
      n_lanes = W0 + R_EXTRA * BLK;
      live_lo = (int)(st - stp);
      live_hi = live_lo + min(max(s_meta[T], 0), n_lanes);
    } else {
      stp = s_mst[0];
      live_lo = 0;
      live_hi = s_mn[0];
      n_lanes = possible ? live_hi : 0;
    }
    const float avgdl = s_fmeta[T];
    int my_cnt = 0;
    for (int i = tid; i < n_lanes; i += THREADS) {
      bool hit = false;
      int pd = INF_KEY;
      float score = 0.0f;
      if (possible && i >= live_lo && i < live_hi) {
        const long long gi = stp + i;
        pd = a.doc_ids[gi];
        const long long key_lo = (long long)pd * stride;
        hit = any_bit(s_ok, lower_bound(keys0, n0, key_lo),
                      lower_bound(keys0, n0, key_lo + stride));
        if (hit) {
          const float dl = a.dl[gi];
          score = (a.masks[gi] & s_meta[2 * T]) != 0
                      ? bm25(a.freqs[gi], s_fmeta[0], dl, avgdl)
                      : 0.0f;
          for (int u = 1; u < T; ++u) {
            const long long stu = s_mst[u];
            const int nu = s_mn[u];
            const int lo = lower_bound(a.doc_ids + stu, nu, pd);
            const bool h = lo < nu && a.doc_ids[stu + lo] == pd &&
                           (a.masks[stu + lo] & s_meta[2 * T + u]) != 0;
            score = score + (h ? bm25(a.freqs[stu + lo], s_fmeta[u], dl,
                                      avgdl)
                               : 0.0f);
          }
        }
      }
      if (raw) {
        od[i] = hit ? pd : INF_KEY;
        os[i] = hit ? score : NEG_INF;
      } else {
        ss[i] = hit ? score : NEG_INF;
      }
      my_cnt += hit ? 1 : 0;
    }

    // block-wide hit count
    for (int off = 16; off > 0; off >>= 1)
      my_cnt += __shfl_down_sync(0xffffffffu, my_cnt, off);
    if (lane == 0) s_red_i[warp] = my_cnt;
    __syncthreads();
    if (tid == 0) {
      int c = 0;
      for (int w = 0; w < WARPS; ++w) c += s_red_i[w];
      s_cnt = c;
      a.out_counts[q] = c;
    }
    __syncthreads();
    if (raw) continue;

    // top-k: min(k, hits) arg-max passes; later lanes keep the filler
    const int n_take = min(k, s_cnt);
    for (int e = 0; e < n_take; ++e) {
      float bs = -INFINITY;
      int bi = INF_KEY;
      for (int i = tid; i < n_lanes; i += THREADS) {
        const float s = ss[i];
        if (s > bs) { bs = s; bi = i; }   // i ascends: ties keep lowest
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float os_ = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (os_ > bs || (os_ == bs && oi < bi)) { bs = os_; bi = oi; }
      }
      if (lane == 0) { s_red_s[warp] = bs; s_red_i[warp] = bi; }
      __syncthreads();
      if (tid == 0) {
        bs = s_red_s[0];
        bi = s_red_i[0];
        for (int w = 1; w < WARPS; ++w) {
          const float ws = s_red_s[w];
          const int wi = s_red_i[w];
          if (ws > bs || (ws == bs && wi < bi)) { bs = ws; bi = wi; }
        }
        od[e] = a.doc_ids[stp + bi];
        os[e] = bs;
        ss[bi] = NEG_INF;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  Every
// pointer is a device pointer except `params_host`, the int32[16]
// parameter block, which travels by value in the kernel's parameters.
int rs_phrase_launch(const void* meta, const void* fmeta,
                     const void* doc_ids, const void* freqs,
                     const void* masks, const void* dl, long long n_post,
                     const void* poskeys, long long n_keys,
                     const void* params_host, void* out_docs,
                     void* out_scores, void* out_counts, void* scr,
                     int grid, void* stream) {
  Params prm;
  memcpy(prm.v, params_host, sizeof(prm.v));
  const int T = prm.v[P_T];
  if (T < 2 || T > MAX_T || prm.v[P_PWS] > MAX_PW || prm.v[P_STRIDE] < 1 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.meta = static_cast<const int*>(meta);
  a.fmeta = static_cast<const float*>(fmeta);
  a.doc_ids = static_cast<const int*>(doc_ids);
  a.freqs = static_cast<const float*>(freqs);
  a.masks = static_cast<const int*>(masks);
  a.dl = static_cast<const float*>(dl);
  a.poskeys = static_cast<const int*>(poskeys);
  a.n_post = n_post;
  a.n_keys = n_keys;
  a.out_docs = static_cast<int*>(out_docs);
  a.out_scores = static_cast<float*>(out_scores);
  a.out_counts = static_cast<int*>(out_counts);
  a.scr = static_cast<float*>(scr);
  phrase_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      prm, a);
  return (int)cudaGetLastError();
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
