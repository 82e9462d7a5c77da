// Stable in-segment row partition of the plane pane, for Hopper (sm_90a).
//
// Replaces the TPU kernels lightgbm_tpu/ops/compact.py::
// _partition_kernel_overlap (:186, the default) and its serialized twin
// _partition_kernel (:118), which are bit-identical by construction
// (:201-204).  The pane keeps one lane per row in R byte rows (F bin rows,
// the f32 grad/hess byte planes, validity).  A split reorders the parent's
// lanes [0, cnt) of a segment so the rows that go left come first in their
// original order, then the rows that go right in theirs.  The TPU version
// compacts a bucketed width around the segment with prefix-sum and one-hot
// selection matmuls, because its vector unit cannot scatter lanes; here
// each lane's destination is computed directly, over the segment's own
// lanes and nothing else.
//
// One kernel, templated on where a lane's side comes from:
//   pane:  right when its byte in the pane's row `feat`, read as uint8, is
//          > thr (the grower's split; the mask is never materialised);
//   pane16, pane32: the same on a 16-bit or 32-bit bin (max_bin > 256, or
//          a feature of more than 65,536 bins): byte k of the bin in row
//          `feat + k * plane` (the pane keeps a bin's bytes F rows apart),
//          thr up to 65535 or 2^31 - 1, compared unsigned.  The JAX
//          package's compacted grower keys on the low byte alone there
//          (lightgbm_tpu/ops/compact.py:463), a fault of its own (ROADMAP
//          C3); the rows moved are the same byte rows either way;
//   mask:  left when mask3 == 1 (compact.py's contract; -1 marks lanes
//          outside the segment, which the caller does not pass).
// Source and destination are different buffers (the grower double-buffers
// its pane), so no lane is overwritten before it is read, and only the
// segment's lanes of the destination are written.
//
// Bound on this card: bytes.  Each of the segment's R*cnt bytes is read
// once and written once, 2*R*cnt bytes: 80 MB at the root of the main
// path (R = 40, cnt = 1M; R = 72 with 16-bit bins; R = 48 for 8 features
// of 32-bit bins), 24 us at 3.35 TB/s.
// Most splits are parents of a few thousand lanes, where the launch floor
// bounds instead.  The design:
//   - Tiles of 4096 lanes, 16 per thread, one 16-byte load per pane row.
//     The tile grid starts at the 16-byte boundary at or below the
//     segment's first lane; ragged or misaligned vectors are read byte by
//     byte.  blockIdx.x picks the tile and blockIdx.y a group of pane rows,
//     so a one-tile segment still spreads its rows over several SMs.
//     The wrapper picks the rows per block so that small segments still
//     give the card a few hundred blocks.
//   - One launch (partition_move) for a segment of up to a few tiles: each
//     block ranks its lanes with popc and a warp-shuffle scan, and counts
//     the left lanes of the other tiles itself (one 16-byte load per
//     thread and tile).  A longer segment takes two launches:
//     partition_count writes each tile's left count, then every
//     partition_move block sums its predecessors' counts and the total.
//     No scan kernel, no flags between blocks, no memset.
//   - The loads of a block's first rows are issued before its ranks are
//     known.  Each thread computes its 16 lanes' staging offsets once and
//     then moves each byte with a shift and a shared-memory store.
//   - Each block stages its rows in shared memory in partitioned order: the
//     tile's left run, then its right run, each placed at the offset that
//     is congruent modulo 16 with its destination in device memory.  Both
//     runs then leave as aligned 16-byte stores, and only their ragged
//     ends are stored byte by byte.
//   - The segment's left count goes to device memory; the host reads it
//     after the launch is queued.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                // lanes per thread: one vector
constexpr int kTile = kThreads * kLanes;  // lanes per block
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = kTile + 32;     // a staged row: two runs + pads
constexpr int kBatch = 4;                 // rows loaded before staging
constexpr int kMaxSmem = 232448;          // 227 KB per block on sm_90
// dynamic shared memory of partition_move: the rest of kMaxSmem after
// its static part[3][kWarps]
constexpr int kMaxStage = kMaxSmem - 3 * kWarps * (int)sizeof(int);
constexpr int kPane = 0, kMask = 1, kPane16 = 2, kPane32 = 4;

struct Args {
  const uint8_t* src;  // the segment's lane 0; row r at src + r * lds
  long long lds;
  uint8_t* dst;        // the same lane of the destination
  long long ldd;
  const uint8_t* key;  // pane: src + feat * lds;  mask: mask3 at lane 0
  long long key_ld;    // pane16/32: byte k of a bin at key + k * key_ld
  unsigned thr;
  int rows, cnt;
  int shift;           // src % 16: tile 0 starts at lane -shift
  int tiles, group;    // the launch plan (ops/compact.plan)
  int* counts;         // [tiles] left lanes per tile from partition_count;
                       // null: each partition_move block counts them
  int* left;           // out: the segment's left lanes
};

// Bytes of lanes [l0, l0 + 16) at p (the address of lane l0), packed
// little-endian into w.  Lanes outside [0, n) are never read; they stay 0.
__device__ __forceinline__ void load16(const uint8_t* p, long long l0, int n,
                                       uint32_t (&w)[4]) {
  if (l0 >= 0 && l0 + kLanes <= n
      && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (l0 + k >= 0 && l0 + k < n)
      w[k >> 2] |= (uint32_t)p[k] << (8 * (k & 3));
  }
}

// Bit k: lane l0 + k lies in the segment and goes left.
template <int kSrc>
__device__ __forceinline__ unsigned left_bits(const Args& a, long long l0) {
  // byte planes of the key: the pane16/32 bins' bytes, little-endian
  constexpr int kPlanes = kSrc == kPane32 ? 4 : kSrc == kPane16 ? 2 : 1;
  unsigned b[kLanes] = {};
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    uint32_t w[4];
    load16(a.key + p * a.key_ld + l0, l0, a.cnt, w);
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      b[k] |= ((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) << (8 * p);
  }
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const bool left = kSrc == kMask ? b[k] == 1u : b[k] <= a.thr;
    if (left && l0 + k >= 0 && l0 + k < a.cnt) m |= 1u << k;
  }
  return m;
}

// Staging offsets of one destination row: the left run at al, the right
// run at ar >= al + nl, each congruent modulo 16 with its destination.
__device__ __forceinline__ void run_offsets(const uint8_t* drow,
                                            long long lstart,
                                            long long rstart, int nl,
                                            int& al, int& ar) {
  al = (int)(reinterpret_cast<uintptr_t>(drow + lstart) & 15);
  ar = al + nl
       + (int)((reinterpret_cast<uintptr_t>(drow + rstart) - al - nl) & 15);
}

template <int kSrc>
__global__ void __launch_bounds__(kThreads) partition_count(const Args a) {
  __shared__ int warp_n[kWarps];
  const long long l0 =
      (long long)blockIdx.x * kTile - a.shift + kLanes * threadIdx.x;
  int n = __popc(left_bits<kSrc>(a, l0));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) n += __shfl_xor_sync(0xffffffffu, n, s);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_n[w];
    a.counts[blockIdx.x] = t;
  }
}

// Loads rows [r, r + n) of the source's lanes [l0, l0 + 16), n <= kBatch.
__device__ __forceinline__ void load_rows(const Args& a, int r, int n,
                                          long long l0,
                                          uint32_t (&w)[kBatch][4]) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (j < n) load16(a.src + (long long)(r + j) * a.lds + l0, l0, a.cnt, w[j]);
  }
}

// Staged offset of each of this thread's 16 lanes in one row: a left lane
// at al + its left rank, a right lane at ar + its right rank, a lane
// outside the segment at the row's last byte, which no run reaches.
__device__ __forceinline__ void lane_offsets(unsigned m, int lrank, int i0,
                                            int lo, int hi, int al, int ar,
                                            int (&pos)[kLanes]) {
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int i = i0 + k;
    const int lr = lrank + __popc(m & ((1u << k) - 1u));
    pos[k] = i < lo || i >= hi ? kRowBytes - 1
             : (m >> k) & 1u   ? al + lr
                               : ar + (i - lo - lr);
  }
}

// at most 64 registers, so four blocks fit an SM
template <int kSrc>
__global__ void __launch_bounds__(kThreads, 4) partition_move(const Args a) {
  extern __shared__ __align__(16) uint8_t stage[];  // [group][kRowBytes]
  // per warp: its left lanes; its share of the tile counts before this
  // tile, and of all tile counts
  __shared__ int part[3][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * kTile - a.shift;
  const long long l0 = t0 + kLanes * tid;
  const int r0 = blockIdx.y * a.group;
  const int g = min(a.group, a.rows - r0);
  // the first rows do not depend on the sides: their loads go out first
  uint32_t w[kBatch][4];
  load_rows(a, r0, min(kBatch, g), l0, w);
  // this thread's lanes of every tile when the block counts them itself,
  // else of its own tile
  const bool self_count = a.tiles > 1 && a.counts == nullptr;
  unsigned m = 0;
  int before = 0, all = 0;
  if (self_count) {
#pragma unroll 4
    for (int t = 0; t < a.tiles; ++t) {
      const unsigned bits = left_bits<kSrc>(
          a, (long long)t * kTile - a.shift + kLanes * tid);
      const int c = __popc(bits);
      if (t == (int)blockIdx.x) m = bits;
      if (t < (int)blockIdx.x) before += c;
      all += c;
    }
  } else {
    m = left_bits<kSrc>(a, l0);
  }

  const int mine = __popc(m);
  int x = mine;  // inclusive scan over the warp
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, s);
    if (lane >= s) x += y;
  }
  if (a.tiles > 1) {
    if (!self_count) {  // the tile counts of partition_count
      for (int i = tid; i < a.tiles; i += kThreads) {
        const int c = a.counts[i];
        all += c;
        if (i < (int)blockIdx.x) before += c;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, s);
      all += __shfl_xor_sync(0xffffffffu, all, s);
    }
  }
  if (lane == 31) part[0][warp] = x;
  if (lane == 0) {
    part[1][warp] = before;
    part[2][warp] = all;
  }
  __syncthreads();
  int wbase = 0, nl = 0;
  before = all = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    if (v < warp) wbase += part[0][v];
    nl += part[0][v];
    before += part[1][v];
    all += part[2][v];
  }
  if (a.tiles == 1) all = nl;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) *a.left = all;

  // the tile's segment lanes are tile-local [lo, hi); vb segment lanes
  // lie before the tile
  const int lo = (int)max(0LL, -t0);
  const int hi = (int)min((long long)kTile, (long long)a.cnt - t0);
  const int nr = hi - lo - nl;
  const long long vb = max(0LL, t0);
  const long long lstart = before;               // the left run's lane
  const long long rstart = all + vb - before;    // the right run's lane
  const int lrank = wbase + x - mine;  // the tile's left lanes before mine

  // Where every destination row lies on the same 16-byte grid (the
  // pane's), one set of offsets serves all rows; else each row has its own
  const bool one_grid = (a.ldd & 15) == 0;
  int al, ar, pos[kLanes];
  run_offsets(a.dst + (long long)r0 * a.ldd, lstart, rstart, nl, al, ar);
  lane_offsets(m, lrank, kLanes * tid, lo, hi, al, ar, pos);
  for (int j0 = 0; j0 < g; j0 += kBatch) {
    const int n = min(kBatch, g - j0);
    if (j0 > 0) load_rows(a, r0 + j0, n, l0, w);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j >= n) break;
      if (!one_grid) {
        run_offsets(a.dst + (long long)(r0 + j0 + j) * a.ldd, lstart, rstart,
                    nl, al, ar);
        lane_offsets(m, lrank, kLanes * tid, lo, hi, al, ar, pos);
      }
      uint8_t* q = stage + (j0 + j) * kRowBytes;
#pragma unroll
      for (int k = 0; k < kLanes; ++k)
        q[pos[k]] = (uint8_t)(w[j][k >> 2] >> (8 * (k & 3)));
    }
  }
  __syncthreads();

  // each row's left and right runs as 16-byte chunks of the staged row:
  // task (j, c) is chunk c of row j, stepped without a division per task
  const int cl = (nl + 30) >> 4, per_row = cl + ((nr + 30) >> 4);
  const int dj = kThreads / per_row, dc = kThreads - dj * per_row;
  int j = tid / per_row, c = tid - j * per_row;
  while (j < g) {
    uint8_t* drow = a.dst + (long long)(r0 + j) * a.ldd;
    run_offsets(drow, lstart, rstart, nl, al, ar);
    const uint8_t* srow = stage + j * kRowBytes;
    int q0, q1, cs;
    uint8_t* base;  // 16-aligned: destination of staged offset 0
    if (c < cl) {
      cs = 16 * c;
      q0 = max(cs, al);
      q1 = min(cs + 16, al + nl);
      base = drow + lstart - al;
    } else {
      cs = 16 * ((ar >> 4) + c - cl);
      q0 = max(cs, ar);
      q1 = min(cs + 16, ar + nr);
      base = drow + rstart - ar;
    }
    if (q1 - q0 == 16) {
      *reinterpret_cast<uint4*>(base + cs) =
          *reinterpret_cast<const uint4*>(srow + cs);
    } else {
      for (int q = q0; q < q1; ++q) base[q] = srow[q];
    }
    j += dj;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++j;
    }
  }
}

// The dynamic shared-memory limit is raised once per instantiation and
// device, not on every launch.
template <int kSrc>
cudaError_t raise_smem_limit() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(partition_move<kSrc>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxStage);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int kSrc>
int launch(const Args& a, cudaStream_t stream) {
  if (a.cnt <= 0 || a.rows <= 0 || a.group < 1
      || (long long)a.group * kRowBytes > kMaxStage
      || (long long)a.tiles
             != ((long long)a.cnt + a.shift + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit<kSrc>();
  if (err != cudaSuccess) return (int)err;
  if (a.tiles > 1 && a.counts != nullptr) {
    partition_count<kSrc><<<a.tiles, kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (a.rows + a.group - 1) / a.group;
  partition_move<kSrc><<<dim3(a.tiles, groups), kThreads,
                         a.group * kRowBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* src, long long lds, void* dst, long long ldd,
               int rows, int cnt, int tiles, int group, void* counts,
               void* left) {
  Args a = {};
  a.src = static_cast<const uint8_t*>(src);
  a.lds = lds;
  a.dst = static_cast<uint8_t*>(dst);
  a.ldd = ldd;
  a.rows = rows;
  a.cnt = cnt;
  a.shift = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  a.tiles = tiles;
  a.group = group;
  a.counts = static_cast<int*>(counts);
  a.left = static_cast<int*>(left);
  return a;
}

}  // namespace

extern "C" {

// Every entry: src and dst are the segment's first lane in the source and
// the destination (row r at src + r * lds, dst + r * ldd), which must not
// overlap; cnt >= 1.  tiles = ceil((cnt + src % 16) / 4096) and group
// (pane rows per block) are the launch plan of ops/compact.plan; counts is
// int32 scratch of `tiles` entries for a count pass (a second launch), or
// null; left receives the segment's left count (int32).

// The grower's split: a lane goes right when its bin is > thr (unsigned):
// its key_bytes (1, 2 or 4) bytes, little-endian, byte k in row feat + k *
// plane.
int lgbm_partition_pane(const void* src, long long lds, void* dst,
                        long long ldd, int rows, int cnt, int feat,
                        int plane, int key_bytes, unsigned thr, int tiles,
                        int group, void* counts, void* left, void* stream) {
  if (feat < 0 || plane < 0 || (key_bytes != 1 && key_bytes != 2
                                && key_bytes != 4)
      || (long long)feat + (long long)(key_bytes - 1) * plane >= rows)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(src, lds, dst, ldd, rows, cnt, tiles, group, counts,
                     left);
  a.key = a.src + (long long)feat * lds;
  a.key_ld = (long long)plane * lds;
  a.thr = thr;
  if (key_bytes == 4) return launch<kPane32>(a, (cudaStream_t)stream);
  if (key_bytes == 2) return launch<kPane16>(a, (cudaStream_t)stream);
  return launch<kPane>(a, (cudaStream_t)stream);
}

// compact.py's contract: a lane goes left when mask[lane] == 1 (mask is
// the segment's first lane of mask3).
int lgbm_partition_mask(const void* src, long long lds, void* dst,
                        long long ldd, const void* mask, int rows, int cnt,
                        int tiles, int group, void* counts, void* left,
                        void* stream) {
  Args a = make_args(src, lds, dst, ldd, rows, cnt, tiles, group, counts,
                     left);
  a.key = static_cast<const uint8_t*>(mask);
  return launch<kMask>(a, (cudaStream_t)stream);
}

}  // extern "C"
