// Batched BM25 term-query intersection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `redisearch_tpu/ops/intersect.py`
// `_kernel` / `_kernel_query` (with its helpers `_member_pass`,
// `_extract_pass`).  It computes what `_xla_impl` computes, in the same
// floating-point operation order, so that its results are bit-identical
// with the plain torch version `intersect_plain` (build with
// --fmad=false and no fast-math: a fused multiply-add or an approximate
// division would round differently and could flip score ties).
//
// Design (a simple, correct first version):
//   * one thread block per query; blocks walk queries blockIdx.x,
//     blockIdx.x + gridDim.x, ... and each owns one pivot-sized row of a
//     global scratch that the wrapper allocates;
//   * per pivot phase, the threads stride over the pivot window's live
//     postings, read at their flat offsets (no 128-lane row alignment:
//     that existed only for the TPU's DMA granule);
//   * membership of every other slot is a binary search over that
//     slot's live doc-sorted posting range, which stays in global memory
//     (a 131072-entry member window is 512 KB, beyond shared memory);
//     found AND mask-valid is a hit, as in `_xla_impl`;
//   * the masked (doc, score) lanes go to the scratch row, the block
//     counts the valid lanes, then min(k, count) block-wide arg-max
//     passes (score desc, lowest window position = lowest doc on ties)
//     fill lanes [phase*k, phase*k + k); the rest keep the
//     (INT32_MAX, -3.4e38) filler.
//   * raw mode (plan[P_RAW], the FT.AGGREGATE GROUPBY path) keeps the
//     Pallas kernel's raw contract: per pivot phase a section of
//     W/128 + R_EXTRA rows of 128 lanes, lane j = posting
//     (start/128)*128 + j, live in [start%128, start%128 + len).  The
//     threads stride over the section's lanes, evaluate the live ones
//     exactly as in top-k mode and write every lane straight to the
//     output (filler where dead); the arg-max passes and the scratch are
//     skipped.  The row-aligned layout is kept although this kernel
//     reads flat offsets: the caller slices posting-aligned group
//     columns at the same rows.
//
// What bounds it on this card: the latency of the dependent
// global-memory probes of the binary searches (log2(W) per member slot
// per candidate), and the serial top-k passes (one block-wide reduction
// and two barriers per extracted hit).  Left to later work: staging the
// pivot window in shared memory, merge-path membership over sorted
// windows instead of per-candidate searches, and warp-level top-k.
//
// Built by redisearch_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; loaded with ctypes.

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

constexpr int MAX_AUX = 4;
constexpr int MAX_META = 64;
constexpr int MAX_FMETA = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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
  int* scr_docs;
  float* scr_scores;
  int n_meta;
  int n_fmeta;
  int out_cols;
  int scr_cols;
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

// first index in a[0, n) whose value is >= x (a ascending)
__device__ __forceinline__ int lower_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
intersect_kernel(const Plan plan, const Args a) {
  __shared__ int s_plan[PLAN_LEN];
  __shared__ int s_meta[MAX_META];
  __shared__ float s_fmeta[MAX_FMETA];
  __shared__ const int* s_aux[MAX_AUX];
  __shared__ long long s_aux_n[MAX_AUX];
  __shared__ float s_red_s[WARPS];
  __shared__ int s_red_i[WARPS];
  __shared__ int s_cnt;

  for (int i = threadIdx.x; i < PLAN_LEN; i += THREADS)
    s_plan[i] = plan.v[i];
  if (threadIdx.x < MAX_AUX) {
    s_aux[threadIdx.x] = a.aux[threadIdx.x];
    s_aux_n[threadIdx.x] = a.aux_n[threadIdx.x];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool raw = plan.v[P_RAW] != 0;
  // top-k mode: this block's pivot-sized scratch row (raw mode has none)
  int* sd = raw ? nullptr : a.scr_docs + (long long)blockIdx.x * a.scr_cols;
  float* ss =
      raw ? nullptr : a.scr_scores + (long long)blockIdx.x * a.scr_cols;

  for (int q = blockIdx.x; q < a.B; q += gridDim.x) {
    __syncthreads();   // the previous query is done with shared state
    for (int i = threadIdx.x; i < a.n_meta; i += THREADS)
      s_meta[i] = a.meta[(long long)q * a.n_meta + i];
    for (int i = threadIdx.x; i < a.n_fmeta; i += THREADS)
      s_fmeta[i] = a.fmeta[(long long)q * a.n_fmeta + i];
    int* od = a.out_docs + (long long)q * a.out_cols;
    float* os = a.out_scores + (long long)q * a.out_cols;
    if (!raw) {   // raw mode writes every lane of its sections below
      for (int i = threadIdx.x; i < a.out_cols; i += THREADS) {
        od[i] = INF_DOC;
        os[i] = NEG_INF;
      }
    }
    __syncthreads();

    const int T = s_plan[P_T];
    const int k = s_plan[P_K];
    const int pivot_g = s_plan[P_PIVOT_G];
    const int n_groups = s_plan[P_NGROUPS];
    const int n_dense = s_plan[P_NDENSE];
    const int n_piv = s_plan[P_NPIV];
    const float avgdl = s_fmeta[T];
    int total = 0;
    long long out_off = 0;   // raw mode: this phase's section

    for (int pi = 0; pi < n_piv; ++pi) {
      const int p = s_plan[P_PIV + pi];
      const int Wp = s_plan[P_WS + p];
      const int qmp = s_meta[2 * T + p];
      const float twp = s_fmeta[p];
      // candidate lane i reads posting stp + i; live lanes are
      // [live_lo, live_hi).  Top-k: the clamped window's first len
      // lanes.  Raw: whole rows from the start's row (a len past the
      // section's lanes changes nothing, so it is clamped to them).
      long long stp;
      int live_lo, live_hi, n_lanes;
      if (raw) {
        const int st = s_meta[p];
        stp = (long long)(st >= 0 ? st / BLK : -((-st + BLK - 1) / BLK)) *
              BLK;
        n_lanes = Wp + R_EXTRA * BLK;
        live_lo = (int)(st - stp);
        live_hi = live_lo + min(max(s_meta[T + p], 0), n_lanes);
      } else {
        stp = clamp_start(s_meta[p], a.n_post, Wp);
        live_lo = 0;
        live_hi = min(max(s_meta[T + p], 0), Wp);
        n_lanes = live_hi;
      }
      int my_cnt = 0;

      for (int i = threadIdx.x; i < n_lanes; i += THREADS) {
        if (i < live_lo || i >= live_hi) {   // raw mode only
          od[out_off + i] = INF_DOC;
          os[out_off + i] = NEG_INF;
          continue;
        }
        const long long gi = stp + i;
        const int pd = a.doc_ids[gi];
        const float dl = a.dl[gi];
        bool valid = (a.masks[gi] & qmp) != 0;
        float score = valid ? bm25(a.freqs[gi], twp, dl, avgdl) : 0.0f;

        // dense posting-aligned TAG code predicates
        for (int di = 0; di < n_dense && valid; ++di) {
          const int o = P_DNS + di * DNS_REC;
          const int fl = s_plan[o], src = s_plan[o + 1];
          const int nv = s_plan[o + 2], mcol = s_plan[o + 3];
          const long long stc =
              raw ? stp : clamp_start(s_meta[p], s_aux_n[src], Wp);
          const int cw = s_aux[src][stc + i];
          bool hitd = false;
          for (int v = 0; v < nv; ++v) hitd |= (cw == s_meta[mcol + v]);
          const float dconst = s_fmeta[T + 1 + di];
          if (fl == REQ) {
            valid = valid && hitd;
            score = score + (hitd ? dconst : 0.0f);
          } else if (fl == NOT_) {
            valid = valid && !hitd;
          } else {
            score = score + (hitd ? dconst : 0.0f);
          }
        }

        // pivot-group siblings: earlier ones own their docs (dedup+fold),
        // later ones fold their score in
        for (int pj = 0; pj < n_piv && valid; ++pj) {
          if (pj == pi) continue;
          const int u = s_plan[P_PIV + pj];
          const int Wu = s_plan[P_WS + u];
          const long long stu = clamp_start(s_meta[u], a.n_post, Wu);
          const int lenu = min(max(s_meta[T + u], 0), Wu);
          const int* md = a.doc_ids + stu;
          const int lo = lower_bound(md, lenu, pd);
          const bool hit = lo < lenu && md[lo] == pd &&
                           (a.masks[stu + lo] & s_meta[2 * T + u]) != 0;
          const float tf = hit ? a.freqs[stu + lo] : 0.0f;
          score = score + (hit ? bm25(tf, s_fmeta[u], dl, avgdl) : 0.0f);
          if (pj < pi) valid = valid && !hit;
        }

        // the other groups, in order
        for (int g = 0; g < n_groups && valid; ++g) {
          if (g == pivot_g) continue;
          const int o = P_GRP + g * GRP_REC;
          const int fl = s_plan[o], gsrc = s_plan[o + 1];
          const int ns = s_plan[o + 2];
          bool ghit = false;
          float gadd = 0.0f;
          for (int j = 0; j < ns; ++j) {
            const int u = s_plan[o + 3 + j];
            const int Wu = s_plan[P_WS + u];
            if (gsrc < 0) {
              const long long stu = clamp_start(s_meta[u], a.n_post, Wu);
              const int lenu = min(max(s_meta[T + u], 0), Wu);
              const int* md = a.doc_ids + stu;
              const int lo = lower_bound(md, lenu, pd);
              const bool hit = lo < lenu && md[lo] == pd &&
                               (a.masks[stu + lo] & s_meta[2 * T + u]) != 0;
              const float tf = hit ? a.freqs[stu + lo] : 0.0f;
              ghit = ghit || hit;
              gadd = gadd + (hit ? bm25(tf, s_fmeta[u], dl, avgdl) : 0.0f);
            } else {
              const long long stu = clamp_start(s_meta[u], s_aux_n[gsrc], Wu);
              const int lenu = min(max(s_meta[T + u], 0), Wu);
              const int* md = s_aux[gsrc] + stu;
              const int lo = lower_bound(md, lenu, pd);
              ghit = ghit || (lo < lenu && md[lo] == pd);
            }
          }
          // doc-window (tag) groups score their leaf constant once
          if (gsrc >= 0) gadd = ghit ? s_fmeta[s_plan[o + 3]] : 0.0f;
          if (fl == REQ) {
            valid = valid && ghit;
            score = score + gadd;
          } else if (fl == NOT_) {
            valid = valid && !ghit;
          } else {
            score = score + gadd;
          }
        }

        if (raw) {
          od[out_off + i] = valid ? pd : INF_DOC;
          os[out_off + i] = valid ? score : NEG_INF;
        } else {
          sd[i] = valid ? pd : INF_DOC;
          ss[i] = valid ? score : NEG_INF;
        }
        my_cnt += valid ? 1 : 0;
      }

      // block-wide match count of this phase
      for (int off = 16; off > 0; off >>= 1)
        my_cnt += __shfl_down_sync(0xffffffffu, my_cnt, off);
      if (lane == 0) s_red_i[warp] = my_cnt;
      __syncthreads();
      if (threadIdx.x == 0) {
        int c = 0;
        for (int w = 0; w < WARPS; ++w) c += s_red_i[w];
        s_cnt = c;
      }
      __syncthreads();
      const int cnt = s_cnt;
      total += cnt;
      out_off += n_lanes;
      if (raw) continue;

      // top-k: min(k, cnt) arg-max passes; later lanes keep the filler
      const int n_take = min(k, cnt);
      for (int e = 0; e < n_take; ++e) {
        float bs = -INFINITY;
        int bi = INF_DOC;
        for (int i = threadIdx.x; i < n_lanes; i += THREADS) {
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
        if (threadIdx.x == 0) {
          bs = s_red_s[0];
          bi = s_red_i[0];
          for (int w = 1; w < WARPS; ++w) {
            const float ws = s_red_s[w];
            const int wi = s_red_i[w];
            if (ws > bs || (ws == bs && wi < bi)) { bs = ws; bi = wi; }
          }
          od[pi * k + e] = sd[bi];
          os[pi * k + e] = bs;
          ss[bi] = NEG_INF;
        }
        __syncthreads();
      }
    }
    if (threadIdx.x == 0) a.out_counts[q] = total;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// Every pointer is a device pointer except `plan_host`, the int32[128]
// descriptor, which travels by value in the kernel's parameters.
int rs_intersect_launch(const void* meta, int n_meta, const void* fmeta,
                        int n_fmeta, const void* doc_ids, const void* freqs,
                        const void* masks, const void* dl, long long n_post,
                        const void* const* aux_p, const long long* aux_n,
                        const void* plan_host, void* out_docs,
                        void* out_scores, void* out_counts, int out_cols,
                        void* scr_docs, void* scr_scores, int scr_cols,
                        int B, int grid, void* stream) {
  if (n_meta > MAX_META || n_fmeta > MAX_FMETA || grid < 1)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  memcpy(plan.v, plan_host, sizeof(plan.v));
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
  a.scr_docs = static_cast<int*>(scr_docs);
  a.scr_scores = static_cast<float*>(scr_scores);
  a.n_meta = n_meta;
  a.n_fmeta = n_fmeta;
  a.out_cols = out_cols;
  a.scr_cols = scr_cols;
  a.B = B;
  intersect_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      plan, a);
  return (int)cudaGetLastError();
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
