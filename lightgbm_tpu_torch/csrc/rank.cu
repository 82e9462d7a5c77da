// LambdaRank (NDCG) gradients over each query's own documents, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this gradient with
// dense XLA ops (lightgbm_tpu/objectives/rank.py), padding every query to
// the longest and building [block, qmax, qmax] pair matrices.  On this
// card that formulation does ~60x more cells than there are document
// pairs (MSLR-WEB30K: 18,919 queries padded to 1,251 documents are 29.6 G
// cells; the queries' own n^2 sum to 0.47 G) in ~69 small launches a
// block of ten queries, ~130,000 a call.  This kernel works over each
// query's contiguous rows at the query's own length, in two kernel
// launches a call.
//
// The function (objectives/rank.py's plain version, step for step), per
// query in descending score order, ties in document order: for each pair
// (hi, lo) with label(hi) > label(lo),
//   delta = s_hi - s_lo
//   dndcg = ((gain_hi - gain_lo) * |disc_hi - disc_lo|) * inv_max_dcg,
//           then / (0.01 + |delta|) when the query's best and worst
//           scores differ
//   sig   = (1 / (1 + (float)exp((double)((2 * delta) * sigmoid)))) * 2
//   lam   = -sig * dndcg, added to hi and subtracted from lo
//   hess  = (2 * dndcg) * (sig * (2 - sig)), added to both
// Each step is one exactly rounded float32 operation (the __f*_rn
// intrinsics, so nvcc contracts nothing into an FMA), exp runs in float64
// and rounds once; a document's row sum, column sum and hessian sum are
// float64 and round once to float32, as the plain version's f64 sums do.
// The caller multiplies by the row weights.
//
// Bound on this card: the pair arithmetic.  About 20 float32 operations
// a pair of different labels (portbench/cost.py's PAIR_FLOPS): 143.6 M
// pairs at MSLR's shape, 43 us at 66.9 TFLOP/s; the bytes (score and
// label read, two outputs written, 16 a row) are 11 us.  The design:
//   - Work items, not queries, are the grid: item (lo, n, i0, q) is the
//     documents [i0, i0 + kThreads) of query q, whose n rows start at lo.
//     The host lists the items once (objectives/rank.py init), longest
//     query first, so the 1,251-document query does not start last, and
//     a long query spreads over several SMs.
//   - Within a query the host visits the documents in label order
//     (`perm`), so a warp's lanes mostly share a label and take the same
//     branch for each partner; the rows are read and written through
//     perm, in document order.
//   - rank_position: a document's place in score order by counting,
//     #{j : s_j > s_i} + #{j : s_j == s_i, row_j < row_i}, which is the
//     plain version's stable descending argsort, ties and the all-zero
//     first iteration included.  It writes the discount at that place.
//   - rank_pairs: each thread owns one document and loops over every
//     partner of another label, with its document as the pair's high or
//     low end.  Every pair is evaluated twice, once from each end: no
//     atomics, no scatter back from score order, and the same bits on
//     every run.  best != worst comes from a block max/min.
//   - Partners are read in tiles of kTile documents through shared
//     memory, so a query of any length runs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // documents of an item
constexpr int kTile = 1024;     // partners staged in shared memory at once
constexpr int kWarps = kThreads / 32;

struct Item {
  int lo, n, i0, q;
};

struct Args {
  const float* score;        // [N] document order
  const int* perm;           // [N] visiting order -> row
  const int* label;          // [N] label of perm[k]
  const float* gain;         // [N] label_gain[label of perm[k]]
  const Item* items;
  const float* inv_max_dcg;  // [nq]
  const float* discount;     // [qmax]
  float sigmoid;
  float* disc;               // [N] scratch: discount at perm[k]'s place
  float* lambdas;            // [N] out, document order
  float* hessians;           // [N] out, document order
};

__global__ void __launch_bounds__(kThreads) rank_position(const Args a) {
  __shared__ float ts[kTile];
  __shared__ int tr[kTile];
  const Item it = a.items[blockIdx.x];
  const int k = it.i0 + threadIdx.x;
  const bool own = k < it.n;
  const int* perm = a.perm + it.lo;
  int r = 0;
  float s = 0.0f;
  if (own) {
    r = perm[k];
    s = a.score[r];
  }
  int pos = 0;
  for (int t0 = 0; t0 < it.n; t0 += kTile) {
    const int m = min(kTile, it.n - t0);
    __syncthreads();
    for (int u = threadIdx.x; u < m; u += kThreads) {
      const int ru = perm[t0 + u];
      tr[u] = ru;
      ts[u] = a.score[ru];
    }
    __syncthreads();
    if (own) {
      for (int u = 0; u < m; ++u)
        pos += (ts[u] > s) | ((ts[u] == s) & (tr[u] < r));
    }
  }
  if (own) a.disc[it.lo + k] = a.discount[pos];
}

__device__ __forceinline__ void pair_term(float s_hi, float s_lo, float g_hi,
                                          float g_lo, float d_hi, float d_lo,
                                          float inv, bool regular,
                                          float sigmoid, float& lam,
                                          float& hess) {
  const float delta = __fsub_rn(s_hi, s_lo);
  float dndcg = __fmul_rn(
      __fmul_rn(__fsub_rn(g_hi, g_lo), fabsf(__fsub_rn(d_hi, d_lo))), inv);
  if (regular) dndcg = __fdiv_rn(dndcg, __fadd_rn(0.01f, fabsf(delta)));
  const float e = __double2float_rn(
      exp((double)__fmul_rn(__fmul_rn(2.0f, delta), sigmoid)));
  // torch's 2.0 / t is t.reciprocal() * 2.0
  const float sig = __fmul_rn(__frcp_rn(__fadd_rn(1.0f, e)), 2.0f);
  lam = __fmul_rn(-sig, dndcg);
  hess = __fmul_rn(__fmul_rn(2.0f, dndcg),
                   __fmul_rn(sig, __fsub_rn(2.0f, sig)));
}

__global__ void __launch_bounds__(kThreads) rank_pairs(const Args a) {
  __shared__ float ts[kTile];
  __shared__ float tg[kTile];
  __shared__ float td[kTile];
  __shared__ int tl[kTile];
  __shared__ float wmax[kWarps], wmin[kWarps];
  const Item it = a.items[blockIdx.x];
  const int* perm = a.perm + it.lo;

  // the query's best and worst scores
  float mx = -INFINITY, mn = INFINITY;
  for (int u = threadIdx.x; u < it.n; u += kThreads) {
    const float v = a.score[perm[u]];
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  if ((threadIdx.x & 31) == 0) {
    wmax[threadIdx.x >> 5] = mx;
    wmin[threadIdx.x >> 5] = mn;
  }
  __syncthreads();
  mx = wmax[0];
  mn = wmin[0];
  for (int w = 1; w < kWarps; ++w) {
    mx = fmaxf(mx, wmax[w]);
    mn = fminf(mn, wmin[w]);
  }
  const bool regular = mx != mn;

  const int k = it.i0 + threadIdx.x;
  const bool own = k < it.n;
  const float inv = a.inv_max_dcg[it.q];
  float s = 0.0f, g = 0.0f, d = 0.0f;
  int l = 0;
  if (own) {
    s = a.score[perm[k]];
    l = a.label[it.lo + k];
    g = a.gain[it.lo + k];
    d = a.disc[it.lo + k];
  }
  double row = 0.0, col = 0.0, hrow = 0.0, hcol = 0.0;
  for (int t0 = 0; t0 < it.n; t0 += kTile) {
    const int m = min(kTile, it.n - t0);
    __syncthreads();
    for (int u = threadIdx.x; u < m; u += kThreads) {
      const int v = it.lo + t0 + u;
      ts[u] = a.score[perm[t0 + u]];
      tl[u] = a.label[v];
      tg[u] = a.gain[v];
      td[u] = a.disc[v];
    }
    __syncthreads();
    if (!own) continue;
    for (int u = 0; u < m; ++u) {
      const int lu = tl[u];
      if (lu == l) continue;
      float lam, hess;
      if (l > lu) {
        pair_term(s, ts[u], g, tg[u], d, td[u], inv, regular, a.sigmoid,
                  lam, hess);
        row += (double)lam;
        hrow += (double)hess;
      } else {
        pair_term(ts[u], s, tg[u], g, td[u], d, inv, regular, a.sigmoid,
                  lam, hess);
        col += (double)lam;
        hcol += (double)hess;
      }
    }
  }
  if (own) {
    const int r = perm[k];
    a.lambdas[r] = __double2float_rn(row - col);
    a.hessians[r] = __double2float_rn(hrow + hcol);
  }
}

}  // namespace

extern "C" {

// One call: rank_position then rank_pairs, both over the n_items items
// (int32 quadruples lo, n, i0, q; item_docs documents an item, which must
// be kThreads; i0 a multiple of it, every row of every query covered
// once).  perm, label and gain are in the visiting order, score and the
// outputs in document order; disc is float32 scratch of N entries;
// discount holds at least the longest query's length.
int lgbm_rank_gradients(const void* score, const void* perm,
                        const void* label, const void* gain,
                        const void* items, int n_items, int item_docs,
                        const void* inv_max_dcg, const void* discount,
                        float sigmoid, void* disc, void* lambdas,
                        void* hessians, void* stream) {
  if (n_items < 0 || item_docs != kThreads)
    return (int)cudaErrorInvalidValue;
  if (n_items == 0) return (int)cudaSuccess;
  Args a;
  a.score = static_cast<const float*>(score);
  a.perm = static_cast<const int*>(perm);
  a.label = static_cast<const int*>(label);
  a.gain = static_cast<const float*>(gain);
  a.items = static_cast<const Item*>(items);
  a.inv_max_dcg = static_cast<const float*>(inv_max_dcg);
  a.discount = static_cast<const float*>(discount);
  a.sigmoid = sigmoid;
  a.disc = static_cast<float*>(disc);
  a.lambdas = static_cast<float*>(lambdas);
  a.hessians = static_cast<float*>(hessians);
  cudaStream_t st = (cudaStream_t)stream;
  rank_position<<<n_items, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank_pairs<<<n_items, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
