// Stable in-segment row partition of the plane pane, for Hopper (sm_90a).
//
// Replaces the TPU kernels lightgbm_tpu/ops/compact.py::
// _partition_kernel_overlap (:186, the default) and its serialized twin
// _partition_kernel (:118), which are bit-identical by construction
// (:201-204).  Given a pane seg [R, W] (int8 bytes: F bin rows, the f32
// grad/hess byte planes, validity) and mask3 [W]: lanes [delta,
// delta+cnt) are reordered so the left rows (mask3 == 1) come first in
// their original order, then the right rows in theirs; every other lane is
// copied byte for byte.  The TPU version compacts with prefix-sum and
// one-hot selection matmuls because its vector unit cannot scatter lanes;
// here each lane's destination is computed directly.
//
// Bound on this card: bytes.  The pane is read once and written once:
// 2*R*W bytes (R = 40, W = 1M lanes at the main-path width: 80 MB).
// Design: three launches on one stream.
//   1. part_count: one block per 1024-lane tile counts its left and right
//      lanes (__syncthreads_count).
//   2. part_scan: one block turns the per-tile counts into exclusive tile
//      offsets for both streams.
//   3. part_scatter: each tile ranks its lanes with warp ballots and popc
//      plus a scan over the 32 warp totals, then moves each lane's R-byte
//      column to its destination: coalesced reads, and writes that land
//      in contiguous runs per stream.
// The output is a separate buffer, so no lane is overwritten before it is
// read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;  // lanes per block, one per thread

__device__ __forceinline__ bool in_segment(long long l, int delta, int cnt) {
  return l >= delta && l < (long long)delta + cnt;
}

__global__ void __launch_bounds__(kTile)
part_count(const int8_t* __restrict__ mask, int w, int delta, int cnt,
           int* __restrict__ counts) {
  const long long l = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool in = l < w && in_segment(l, delta, cnt);
  const bool left = in && mask[l] == 1;
  const int nl = __syncthreads_count(left);
  const int nr = __syncthreads_count(in && !left);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = nl;
    counts[2 * blockIdx.x + 1] = nr;
  }
}

__global__ void __launch_bounds__(kTile)
part_scan(const int* __restrict__ counts, int nb, int* __restrict__ offs) {
  __shared__ int sl[kTile];
  __shared__ int sr[kTile];
  const int tid = threadIdx.x;
  const int per = (nb + kTile - 1) / kTile;
  const int b0 = min(nb, tid * per);
  const int b1 = min(nb, b0 + per);
  int tl = 0, tr = 0;
  for (int b = b0; b < b1; ++b) {
    tl += counts[2 * b];
    tr += counts[2 * b + 1];
  }
  sl[tid] = tl;
  sr[tid] = tr;
  __syncthreads();
  for (int s = 1; s < kTile; s <<= 1) {  // inclusive Hillis-Steele scan
    const int al = tid >= s ? sl[tid - s] : 0;
    const int ar = tid >= s ? sr[tid - s] : 0;
    __syncthreads();
    sl[tid] += al;
    sr[tid] += ar;
    __syncthreads();
  }
  int el = sl[tid] - tl, er = sr[tid] - tr;
  for (int b = b0; b < b1; ++b) {
    offs[2 * b] = el;
    offs[2 * b + 1] = er;
    el += counts[2 * b];
    er += counts[2 * b + 1];
  }
}

__global__ void __launch_bounds__(kTile)
part_scatter(const int8_t* __restrict__ src, long long ld,
             const int8_t* __restrict__ mask, int8_t* __restrict__ dst,
             int rows, int w, int delta, int cnt, int plcnt,
             const int* __restrict__ offs) {
  __shared__ int warp_l[kTile / 32];
  __shared__ int warp_r[kTile / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long l = (long long)blockIdx.x * kTile + tid;
  const bool valid = l < w;
  const bool in = valid && in_segment(l, delta, cnt);
  const bool left = in && mask[l] == 1;
  const bool right = in && !left;
  const unsigned bl = __ballot_sync(0xffffffffu, left);
  const unsigned br = __ballot_sync(0xffffffffu, right);
  const unsigned below = (1u << lane) - 1u;
  if (lane == 0) {
    warp_l[warp] = __popc(bl);
    warp_r[warp] = __popc(br);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 32 warp totals
    const int vl = warp_l[lane], vr = warp_r[lane];
    int il = vl, ir = vr;
    for (int s = 1; s < 32; s <<= 1) {
      const int ul = __shfl_up_sync(0xffffffffu, il, s);
      const int ur = __shfl_up_sync(0xffffffffu, ir, s);
      if (lane >= s) {
        il += ul;
        ir += ur;
      }
    }
    warp_l[lane] = il - vl;
    warp_r[lane] = ir - vr;
  }
  __syncthreads();
  if (!valid) return;
  long long dest = l;
  if (left) {
    dest = (long long)delta + offs[2 * blockIdx.x] + warp_l[warp] +
           __popc(bl & below);
  } else if (right) {
    dest = (long long)delta + plcnt + offs[2 * blockIdx.x + 1] +
           warp_r[warp] + __popc(br & below);
  }
  for (int r = 0; r < rows; ++r) {
    dst[(long long)r * w + dest] = src[(long long)r * ld + l];
  }
}

}  // namespace

extern "C" {

// src: row r of the pane segment starts at src + r * ld; dst: [rows, w]
// contiguous.  scratch: 4 * ceil(w / 1024) int32.
int lgbm_partition(const void* src, long long ld, const void* mask,
                   void* dst, int rows, int w, int delta, int cnt,
                   int plcnt, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (w + kTile - 1) / kTile;
  if (nb == 0) return (int)cudaGetLastError();
  int* counts = static_cast<int*>(scratch);
  int* offs = counts + 2 * nb;
  const int8_t* m = static_cast<const int8_t*>(mask);
  part_count<<<nb, kTile, 0, s>>>(m, w, delta, cnt, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  part_scan<<<1, kTile, 0, s>>>(counts, nb, offs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  part_scatter<<<nb, kTile, 0, s>>>(static_cast<const int8_t*>(src), ld, m,
                                    static_cast<int8_t*>(dst), rows, w,
                                    delta, cnt, plcnt, offs);
  return (int)cudaGetLastError();
}

}  // extern "C"
