// Leaf-batched gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py::_hist_kernel
// (launched by _hist_pallas_raw_fn, :86-158), which builds
//   acc[f, b, 3*c + k] = sum over rows with bin[f, row] == b and
//                        cid[row] == c of val[k, row]
// (k = grad, hess, count) as one-hot x value matmuls on the MXU.  The TPU
// needs that matmul form and its bf16 hi/lo operand split because its
// vector unit has no scatter; the H100 has shared-memory atomics, so this
// kernel scatters each row straight into a block-private histogram.
//
// Bound on this card: bytes.  One pass reads the uint8 bin matrix
// (F bytes per row) plus the per-row side band (grad, hess, cid: 12 bytes
// per row in the float mode, 3 + 4 in the int8 mode) once, and writes
// F*B*3C accumulators.  At the main-path shape (F=28, N=1M, C=1) that is
// about 40 MB.  Design: blockIdx.x picks a block of Fb features whose
// [Fb, B, 3C] accumulator fills at most the 227 KB of dynamic shared
// memory (the analogue of feature_block's VMEM budget, :176-183);
// blockIdx.y picks a contiguous chunk of rows.  Threads stride the chunk so
// each feature row is read coalesced, add into shared memory, and the block
// adds its partial into the global accumulator with one atomic per nonzero
// cell.  Two instantiations:
//   float: f32 grad/hess, count 1.0 per row, f32 accumulation.  Atomic
//          order varies run to run, so sums agree with a sequential sum to
//          f32 rounding, not bitwise.
//   int8:  int8 quantized levels (ops/hist_cuda.quantize_values), int32
//          accumulation: order-free and bitwise.
// Bins are read as uint8, so values >= 128 need no masking (the TPU kernel
// carries them as int8 and masks with & 255, :79); bins >= B are dropped.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ bins, long long ld,
            const float* __restrict__ grad, const float* __restrict__ hess,
            const int8_t* __restrict__ q, long long qld,
            const int32_t* __restrict__ cid, int n, int num_f, int fb,
            int num_b, int num_c, int rows_per_block, void* out) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sh = reinterpret_cast<Acc*>(smem_raw);
  const int f0 = blockIdx.x * fb;
  const int nf = min(fb, num_f - f0);
  const int k3 = 3 * num_c;
  const int cells = nf * num_b * k3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = Acc(0);
  __syncthreads();

  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min((long long)n, r0 + rows_per_block);
  const uint8_t* fbase = bins + (long long)f0 * ld;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int c = cid[r];
    if (c < 0 || c >= num_c) continue;
    Acc v0, v1, v2;
    if constexpr (kInt8) {
      v0 = q[r];
      v1 = q[qld + r];
      v2 = q[2 * qld + r];
    } else {
      v0 = grad[r];
      v1 = hess[r];
      v2 = 1.0f;
    }
    for (int f = 0; f < nf; ++f) {
      const int b = fbase[(long long)f * ld + r];
      if (b >= num_b) continue;
      Acc* cell = sh + ((long long)f * num_b + b) * k3 + 3 * c;
      atomicAdd(cell, v0);
      atomicAdd(cell + 1, v1);
      atomicAdd(cell + 2, v2);
    }
  }
  __syncthreads();

  Acc* o = reinterpret_cast<Acc*>(out) + (long long)f0 * num_b * k3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const Acc v = sh[i];
    if (v != Acc(0)) atomicAdd(o + i, v);
  }
}

template <bool kInt8>
int launch(const uint8_t* bins, long long ld, const float* grad,
           const float* hess, const int8_t* q, long long qld,
           const int32_t* cid, int n, int num_f, int num_b, int num_c,
           int num_sms, void* out, cudaStream_t stream) {
  const size_t cell_bytes = 4;
  const size_t out_bytes = (size_t)num_f * num_b * 3 * num_c * cell_bytes;
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || num_f <= 0) return (int)cudaGetLastError();
  // features per block: the largest count whose accumulator fits shared
  // memory, balanced over the blocks
  const size_t per_feature = (size_t)num_b * 3 * num_c * cell_bytes;
  int fb_max = (int)(kMaxSmem / per_feature);
  if (fb_max < 1) return (int)cudaErrorInvalidValue;
  const int nfb = (num_f + fb_max - 1) / fb_max;
  const int fb = (num_f + nfb - 1) / nfb;
  const size_t smem = (size_t)fb * per_feature;
  // rows: enough chunks for about two blocks per SM, at least 8192 rows
  // each so the per-block flush stays small next to the row work
  long long target = (2LL * num_sms + nfb - 1) / nfb;
  if (target < 1) target = 1;
  long long rows = (n + target - 1) / target;
  if (rows < 8192) rows = 8192;
  rows = (rows + kThreads - 1) / kThreads * kThreads;
  const int chunks = (int)((n + rows - 1) / rows);
  err = cudaFuncSetAttribute(hist_kernel<kInt8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nfb, chunks);
  hist_kernel<kInt8><<<grid, kThreads, smem, stream>>>(
      bins, ld, grad, hess, q, qld, cid, n, num_f, fb, num_b, num_c,
      (int)rows, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out: [num_f, num_b, 3 * num_c] float32.  bins: row f starts at
// bins + f * ld.  Rows with cid outside [0, num_c) are skipped.
int lgbm_hist_f32(const void* bins, long long ld, const void* grad,
                  const void* hess, const void* cid, int n, int num_f,
                  int num_b, int num_c, int num_sms, void* out,
                  void* stream) {
  return launch<false>(static_cast<const uint8_t*>(bins), ld,
                       static_cast<const float*>(grad),
                       static_cast<const float*>(hess), nullptr, 0,
                       static_cast<const int32_t*>(cid), n, num_f, num_b,
                       num_c, num_sms, out, (cudaStream_t)stream);
}

// q: [3, qld] int8 quantized (grad, hess, ok) levels.  out: int32.
int lgbm_hist_i8(const void* bins, long long ld, const void* q,
                 long long qld, const void* cid, int n, int num_f,
                 int num_b, int num_c, int num_sms, void* out,
                 void* stream) {
  return launch<true>(static_cast<const uint8_t*>(bins), ld, nullptr,
                      nullptr, static_cast<const int8_t*>(q), qld,
                      static_cast<const int32_t*>(cid), n, num_f, num_b,
                      num_c, num_sms, out, (cudaStream_t)stream);
}

}  // extern "C"
