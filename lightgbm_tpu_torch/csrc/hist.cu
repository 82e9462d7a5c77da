// Leaf-batched gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py::_hist_kernel
// (launched by _hist_pallas_raw_fn, :86-158), which builds
//   acc[f, b, 3*c + k] = sum over rows with bin[f, row] == b and
//                        cid[row] == c of val[k, row]
// (k = grad, hess, count) as one-hot x value matmuls on the MXU.  The TPU
// needs that matmul form because its vector unit has no scatter; the H100
// has shared-memory atomics, so this kernel scatters each row straight into
// a block-private histogram.  Rows with cid outside [0, C) and bins >= B
// are dropped.
//
// Bound on this card: bytes, in principle.  A pass must read the bin
// matrix (F bytes per row, 2F with 16-bit bins) and the per-row side band
// once, and write
// F*B*3C accumulators: about 40 MB at the root of the main path (F=28,
// N=1M, C=1), 12 us at 3.35 TB/s.  In practice two things bound it:
//   - the shared-memory atomics, all native 32-bit integer adds: three
//     per row and feature in the int8 mode, five in the float mode (two
//     of them wait on the value another returns);
//   - the main path launches the kernel once per leaf, mostly on children
//     of a few thousand rows, so what bounds a tree is how much of the card
//     each small launch fills and what each block pays around its rows.
// The design, per cost:
//   - Fill the card at every size.  blockIdx.x picks a small group of g
//     features (about 1,024 cells of accumulator: 4 features at C=1, one
//     feature at wide C), blockIdx.y a chunk of rows; the wrapper
//     (ops/hist_cuda.plan) sizes chunks for up to 8 resident blocks per SM
//     with a floor of one row tile, and gives each thread 16 rows of a
//     feature only where that still fills every SM, else 4, so a child of
//     4,000 rows runs on 112 blocks and short per-thread atomic chains.
//   - Small per-block overhead.  Each block zeroes and flushes only its
//     group's [g, B, C] cells, adding nonzero cells into the global
//     output (the float mode: its fixed-point sums) with one atomic each.
//   - Order-free integer atomics in the float mode.  Each staged row's
//     f32 (grad, hess) becomes a 64-bit fixed-point integer,
//     round(v * 2^e), with one exponent e per tree (ops/hist_cuda.
//     fixed_exponent: 62 - ceil(log2(N * max |v|)), so no cell of N rows
//     can pass 2^62).  Integer sums do not depend on the order of their
//     terms, so every run gives the same bits, as the TPU kernel's fixed
//     grid order does.  The card has no native 64-bit add on shared
//     memory (it compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64),
//     so a shared cell keeps each 64-bit sum as two 32-bit words, added
//     with native 32-bit atomics: the low word first, whose returned old
//     value shows whether it wrapped, then the high word with that carry
//     (add_fixed); the words' sums are exact whatever the order.  Blocks
//     add their cells into 64-bit global sums (a native global atomic),
//     and each cell becomes f32 once, at write-out (a second small
//     kernel, as blocks add into the global sums in no fixed order).  The
//     grid step is 2^-62 * N * max|v|: 2^-42 of the largest term at N =
//     1M, finer than an f32 sum's own rounding.  A cell is 20 bytes (two
//     sums of two words and a 4-byte count), not the 12 of f32 sums, and
//     a row adds five 32-bit atomics, not one 64-bit compare-and-swap
//     loop and one 32-bit atomic.  Where shared memory
//     allows (narrow C) a block keeps two copies of its accumulator, one
//     per warp parity, so no two warps contend for the same cells; the
//     copies are summed in shared memory before the flush.  A dropped row
//     adds zeros rather than diverge around the atomics.
//   - Wide loads, side band once.  Each thread reads its rows of one
//     feature as one 16- or 4-byte load (rows start at an arbitrary lane,
//     so the tile origin is shifted to the 16-byte boundary and unaligned
//     or partial vectors are read byte by byte).  Each row tile's side band
//     (values and column id) is staged in shared memory once and read by
//     every feature of the group; it is padded one word per vector, so the
//     32 lanes of a warp, a vector apart, read 32 distinct banks.
//   - Wide C (one block per SM fits): 512 threads per block, not 256.
//   - Accumulators larger than shared memory (16-bit bins: B = 1023 at
//     C = 42, B = 50,000 at C = 1).  A feature's B*C cells are cut into
//     `slices` contiguous ranges of at most 192 KB each; blockIdx.x picks a
//     feature group and a slice, and a block adds only the rows whose
//     (bin, column) cell falls in its slice.  Each slice re-reads the rows,
//     so a pass reads its input `slices` times; every accumulator up to
//     192 KB takes one slice (B <= 256 at C <= 64 in the int8 mode; in the
//     float mode at C <= 38, and two slices at the depth-wise widths).
// Three modes:
//   float: f32 grad/hess, count 1 per row, 64-bit fixed-point
//          accumulation at the caller's exponent: bitwise the same on
//          every run, and within the grid step per row of an exact sum.
//   int8:  int8 quantized levels (ops/hist_cuda.quantize_values), int32
//          accumulation: order-free and bitwise.
//   pane:  the float mode read straight from a slice of the compacted
//          grower's plane pane (ops/compact.py): f32 grad and hess are
//          assembled from their four little-endian byte planes (bit-equal
//          to Tensor.view(float32)), and the validity plane gives column 0
//          or "dropped".  C = 1.  Fixed point as the float mode.
// and the bin layouts: uint8 rows, uint16 rows (the 16-bit bin matrix of
// max_bin > 256, read as 2-byte elements, 16 rows a 32-byte load), uint32
// rows (the 32-bit matrix of a feature with more than 65,536 bins, 4-byte
// elements, 4 rows a 16-byte load), and, for the pane entry, 16-bit and
// 32-bit bins as two or four byte planes (the low bytes in the pane's bin
// rows, byte k plane_off * k bytes further on).  Bins are read unsigned,
// so values >= 128 need no masking (the TPU kernel carries uint8 bins as
// int8 and masks with & 255, :79; it has no 16-bit or 32-bit mode: the
// JAX package computes B > 256 outside Pallas, ops/histogram.py:34-56).
//
// Accumulators far larger than shared memory (32-bit bins: B > 65,536).
// At B = 131,072 a feature's cells are 2.6 MB in the float mode at C = 1
// and 66 MB in the int8 mode at C = 42: slices of 192 KB would read every
// row 8 to 560 times (on the H100 the sliced plan took 3 to 38 times the
// global adds' time at F = 8, N = 1M, C = 1 to 42; PERF.md).  Such a pass
// (copies = 0 in the launch plan) keeps no accumulator in shared memory:
// each kept row adds straight into the global sums with native global
// atomics (int8: three 32-bit adds into the int32 output; float, pane:
// two 64-bit fixed-point adds and a 32-bit count), so each row is read
// once and the bins spread the adds over millions of cells; the side band
// is still staged once a tile for the block's g features.  The sums stay
// order-free integers, so the result is the sliced kernel's bit for bit.
// Offsets into the output are 64-bit: F * B * 3C cells pass 2^31 bytes
// at F = 8, B = 131,072, C = 42.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr int kFloat = 0, kInt8 = 1, kPane = 2;
// bin layouts: uint8 rows, uint16 rows, 16-bit bins as lo/hi byte planes,
// uint32 rows, 32-bit bins as four byte planes
constexpr int kU8 = 1, kU16 = 2, kPlanes16 = 3, kU32 = 4, kPlanes32 = 5;

// bytes of one bin element in the matrix (the pane's planes are bytes)
template <int kBin>
__host__ __device__ constexpr int elem_bytes() {
  return kBin == kU16 ? 2 : kBin == kU32 ? 4 : 1;
}

struct Args {
  const uint8_t* bins;   // bin row f starts at element f * ld of bins
  long long ld;          // in elements (bytes, 2 for kU16, 4 for kU32)
  long long plane_off;   // kPlanes16/32: byte plane k of a row lies
                         // k * plane_off bytes after its low bytes
  const float* grad;     // float
  const float* hess;
  const int8_t* q;       // int8: [3, qld] levels
  long long qld;
  const int32_t* cid;    // float, int8
  const uint8_t* planes; // pane: grad byte planes at planes + k * ld,
                         // hess at + (4 + k) * ld, validity at + 8 * ld
  int n, num_f, num_b, num_c;
  int g;                 // features per block
  int slices;            // cell slices per feature (blocks per group)
  int slice_cells;       // (bin, column) cells per slice, the last fewer
  int copies;            // private accumulator copies per block; 0: none,
                         // the block adds into the global sums
  int tile;              // rows per staged tile, a multiple of 16
  int shift;             // rows start at -shift: bins + r is 16-aligned
                         // at every tile start
  long long chunk;       // rows per block, a multiple of tile
  void* out;             // int8: the int32 output
  const int* exponent;   // float, pane: the fixed-point exponent e
  unsigned long long* fsum;  // float, pane: [cells][2] fixed-point sums
  int* fcnt;                 //   and [cells] counts, cells = F * B * C
};

// The accumulator's bytes per (bin, column) cell and copy: int8 three
// int32; float and pane two 64-bit fixed-point sums (as two 32-bit words
// each) and an int32 count.
template <int kMode>
__host__ __device__ constexpr int cell_bytes() {
  return kMode == kInt8 ? 12 : 20;
}

// Side-band index of tile row i: one pad word per kVec rows, so lanes
// kVec rows apart read words kVec + 1 apart, in 32 distinct banks.
template <int kVec>
__device__ __forceinline__ int padded(int i) { return i + i / kVec; }

// kBytes bytes at src, packed little-endian into w; bytes outside [lo, hi)
// are left 0xFF and never read.
template <int kBytes>
__device__ __forceinline__ void load_bytes(const uint8_t* src, int lo, int hi,
                                           uint32_t (&w)[kBytes / 4]) {
  constexpr int kAlign = kBytes < 16 ? kBytes : 16;
  if (lo <= 0 && hi >= kBytes
      && (reinterpret_cast<uintptr_t>(src) & (kAlign - 1)) == 0) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int q = 0; q < kBytes / 16; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(src)[q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(src);
    }
    return;
  }
  // ragged head or tail, or a row stride off the vector boundary
#pragma unroll
  for (int k = 0; k < kBytes / 4; ++k) w[k] = 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < kBytes; ++k) {
    if (k >= lo && k < hi) {
      w[k >> 2] = (w[k >> 2] & ~(0xFFu << (8 * (k & 3))))
                  | (uint32_t)src[k] << (8 * (k & 3));
    }
  }
}

// Bins of rows [0, kVec) of a bin row, rows outside [lo, hi) undefined;
// row is the address of the first row's (low) byte.
template <int kBin, int kVec>
__device__ __forceinline__ void load_bins(const Args& a, const uint8_t* row,
                                          int lo, int hi, int (&b)[kVec]) {
  if constexpr (kBin == kU16) {
    uint32_t w[kVec / 2];
    load_bytes<2 * kVec>(row, 2 * lo, 2 * hi, w);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      b[k] = (int)((w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
  } else if constexpr (kBin == kU32) {
    uint32_t w[kVec];
    load_bytes<4 * kVec>(row, 4 * lo, 4 * hi, w);
#pragma unroll
    for (int k = 0; k < kVec; ++k) b[k] = (int)w[k];  // < 2^31: the carry
  } else {
    constexpr int kPlanes =
        kBin == kPlanes16 ? 2 : kBin == kPlanes32 ? 4 : 1;
    uint32_t w[kVec / 4];
#pragma unroll
    for (int k = 0; k < kVec; ++k) b[k] = 0;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      load_bytes<kVec>(row + p * a.plane_off, lo, hi, w);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        b[k] |= (int)(((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) << (8 * p));
    }
  }
}

// round(v * 2^e) as a two's-complement 64-bit integer, scale = 2^e: the
// product of an f32 and a power of two is exact in f64, and the rounding
// to an integer (to nearest even) is the only one.
__device__ __forceinline__ unsigned long long to_fixed(float v,
                                                       double scale) {
  return (unsigned long long)__double2ll_rn((double)v * scale);
}

// Adds the 64-bit v to the sum held as words lohi[0] (low, unsigned) and
// lohi[1] (high) with two native 32-bit atomics: the low word's old value
// shows whether this add wrapped it, and the high word takes v's high
// word plus that carry.  Once every add is in, lohi[1] * 2^32 + lohi[0]
// is the exact sum (it stays within 2^62), in whatever order they came.
__device__ __forceinline__ void add_fixed(unsigned* lohi,
                                          unsigned long long v) {
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(lohi, lo);
  atomicAdd(lohi + 1, (unsigned)(v >> 32) + (old + lo < old ? 1u : 0u));
}

// The 64-bit value of a sum held as two words (add_fixed).
__device__ __forceinline__ unsigned long long join_fixed(const unsigned* w) {
  return (unsigned long long)w[1] << 32 | w[0];
}

// A fixed-point sum back to f32, inv = 2^-e: one rounding, to 24 bits,
// then an exact scaling (f32 denormals aside).
__device__ __forceinline__ float from_fixed(unsigned long long s,
                                            double inv) {
  return (float)((double)__ll2float_rn((long long)s) * inv);
}

// kGlobal: no accumulator in shared memory (copies = 0, one slice); each
// kept row adds straight into the global sums (the header says when).
template <int kMode, int kVec, int kBin, bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads) hist_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group = blockIdx.x / a.slices;
  const int f0 = group * a.g;
  const int nf = min(a.g, a.num_f - f0);
  // (bin, column) cells per feature
  const long long fcells = (long long)a.num_b * a.num_c;
  // this block's slice of each feature's cells: [k0, k0 + kc)
  const long long k0 =
      (long long)(blockIdx.x - group * a.slices) * a.slice_cells;
  const int kc = (int)min((long long)a.slice_cells, fcells - k0);
  const int cells = nf * kc;             // per copy
  // accumulator, cell_bytes per cell and copy.  int8: int
  // [copies][cells][3].  float, pane: fixed-point (grad, hess) sums as
  // (low, high) words [copies][cells][4], then int counts [copies][cells]
  int* acc = reinterpret_cast<int*>(smem_raw);
  unsigned* sums = reinterpret_cast<unsigned*>(smem_raw);
  int* counts = reinterpret_cast<int*>(sums + 4 * a.copies * cells);
  // side band, structure of arrays of padded(tile) elements each:
  //   float, pane: sg, sh (fixed point, 8 bytes), then sc (column or -1);
  //   int8: sc packs (q0, q1, q2, column or 0xFF) as bytes
  const long long acc_bytes =
      kGlobal ? 0
              : ((long long)a.copies * a.g * a.slice_cells
                     * cell_bytes<kMode>() + 15) / 16 * 16;
  const int pt = padded<kVec>(a.tile);
  unsigned long long* sg =
      reinterpret_cast<unsigned long long*>(smem_raw + acc_bytes);
  unsigned long long* sh = sg + pt;
  int* sc = kMode == kInt8 ? reinterpret_cast<int*>(sg)
                           : reinterpret_cast<int*>(sh + pt);
  if constexpr (!kGlobal) {
    for (int i = threadIdx.x; i < a.copies * cells * cell_bytes<kMode>() / 4;
         i += blockDim.x)
      acc[i] = 0;
  }
  const int copy = kGlobal ? 0 : (threadIdx.x >> 5) % a.copies;
  double scale = 0.0;  // 2^e
  if constexpr (kMode != kInt8) scale = ldexp(1.0, *a.exponent);

  const long long c0 = -(long long)a.shift + (long long)blockIdx.y * a.chunk;
  const long long c1 = min((long long)a.n, c0 + a.chunk);
  for (long long t0 = c0; t0 < c1; t0 += a.tile) {
    const int tn = (int)min((long long)a.tile, c1 - t0);
    __syncthreads();  // zeroing done / previous tile consumed
    for (int i = threadIdx.x; i < tn; i += blockDim.x) {
      const long long r = t0 + i;
      const int p = padded<kVec>(i);
      if (r < 0) {
        sc[p] = -1;  // before the segment: dropped, adds zeros
        if constexpr (kMode != kInt8) sg[p] = sh[p] = 0;
        continue;
      }
      if constexpr (kMode == kPane) {
        const uint8_t* pl = a.planes + r;
        uint32_t ug = 0, uh = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ug |= (uint32_t)pl[k * a.ld] << (8 * k);
          uh |= (uint32_t)pl[(4 + k) * a.ld] << (8 * k);
        }
        const bool ok = pl[8 * a.ld] == 1;
        sg[p] = ok ? to_fixed(__uint_as_float(ug), scale) : 0;
        sh[p] = ok ? to_fixed(__uint_as_float(uh), scale) : 0;
        sc[p] = ok ? 0 : -1;
      } else {
        const int c = a.cid[r];
        const bool ok = c >= 0 && c < a.num_c;
        if constexpr (kMode == kInt8) {
          sc[p] = (int)((uint32_t)(uint8_t)a.q[r]
                        | (uint32_t)(uint8_t)a.q[a.qld + r] << 8
                        | (uint32_t)(uint8_t)a.q[2 * a.qld + r] << 16
                        | (uint32_t)(ok ? c : 0xFF) << 24);
        } else {
          sg[p] = ok ? to_fixed(a.grad[r], scale) : 0;
          sh[p] = ok ? to_fixed(a.hess[r], scale) : 0;
          sc[p] = ok ? c : -1;
        }
      }
    }
    __syncthreads();

    const int vecs = (tn + kVec - 1) / kVec;
    for (int s = threadIdx.x; s < nf * vecs; s += blockDim.x) {
      const int fi = s / vecs;
      const int j = s - fi * vecs;
      const long long r0 = t0 + kVec * j;
      int bv[kVec];
      const long long e0 = (long long)(f0 + fi) * a.ld + r0;  // element
      load_bins<kBin, kVec>(a, a.bins + e0 * elem_bytes<kBin>(),
                            (int)max(0LL, -r0), tn - kVec * j, bv);
      // global mode: the feature's first output cell
      const long long gbase = (long long)(f0 + fi) * fcells;
      const int fbase = copy * cells + fi * kc;
      const int base = (kVec + 1) * j;
      const int kmax = min(kVec, tn - kVec * j);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (k >= kmax) break;
        const int b = bv[k];
        if ((unsigned)b >= (unsigned)a.num_b) continue;
        const int side = sc[base + k];
        if constexpr (kGlobal) {
          if constexpr (kMode == kInt8) {
            const int c = (int)((uint32_t)side >> 24);
            if (c == 0xFF) continue;
            int* o = reinterpret_cast<int*>(a.out)
                     + 3 * (gbase + (long long)b * a.num_c + c);
            atomicAdd(o, (int)(int8_t)(side & 0xFF));
            atomicAdd(o + 1, (int)(int8_t)((side >> 8) & 0xFF));
            atomicAdd(o + 2, (int)(int8_t)((side >> 16) & 0xFF));
          } else {
            if (side < 0) continue;  // dropped: nothing to add
            const long long o = gbase + (long long)b * a.num_c + side;
            atomicAdd(a.fsum + 2 * o, sg[base + k]);
            atomicAdd(a.fsum + 2 * o + 1, sh[base + k]);
            atomicAdd(a.fcnt + o, 1);
          }
        } else if constexpr (kMode == kInt8) {
          const int c = (int)((uint32_t)side >> 24);
          if (c == 0xFF) continue;
          const long long lk = (long long)b * a.num_c + c - k0;
          if (lk < 0 || lk >= kc) continue;  // another slice
          int* cell = acc + 3 * (fbase + (int)lk);
          atomicAdd(cell, (int)(int8_t)(side & 0xFF));
          atomicAdd(cell + 1, (int)(int8_t)((side >> 8) & 0xFF));
          atomicAdd(cell + 2, (int)(int8_t)((side >> 16) & 0xFF));
        } else {
          // a dropped row (side -1) adds its staged zeros to column 0, as
          // a branch around the atomics costs more than the atomics
          const long long lk = (long long)b * a.num_c + max(side, 0) - k0;
          if (lk < 0 || lk >= kc) continue;  // another slice
          const int local = (int)lk;
          const int cell = fbase + local;
          add_fixed(sums + 4 * cell, sg[base + k]);
          add_fixed(sums + 4 * cell + 2, sh[base + k]);
          atomicAdd(counts + cell, side >= 0 ? 1 : 0);
        }
      }
    }
  }
  if constexpr (kGlobal) return;  // every add went to the global sums
  __syncthreads();

  // merge the copies; add each nonzero cell into the output
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int fi = i / kc;
    const long long o0 =
        ((long long)(f0 + fi) * fcells + k0 + (i - fi * kc)) * 3;
    if constexpr (kMode == kInt8) {
      int* o = reinterpret_cast<int*>(a.out) + o0;
      for (int k = 0; k < 3; ++k) {
        int v = 0;
        for (int cp = 0; cp < a.copies; ++cp) v += acc[3 * (cp * cells + i) + k];
        if (v != 0) atomicAdd(o + k, v);
      }
    } else {
      int n = 0;
      unsigned long long g = 0, h = 0;
      for (int cp = 0; cp < a.copies; ++cp) {
        const int cell = cp * cells + i;
        n += counts[cell];
        g += join_fixed(sums + 4 * cell);
        h += join_fixed(sums + 4 * cell + 2);
      }
      if (n == 0) continue;  // no kept row: the sums are 0 too
      const long long o = o0 / 3;
      atomicAdd(a.fsum + 2 * o, g);
      atomicAdd(a.fsum + 2 * o + 1, h);
      atomicAdd(a.fcnt + o, n);
    }
  }
}

// The float modes' write-out: each cell's fixed-point sums to f32 once,
// counts to f32, into out [cells][3].
__global__ void fixed_to_f32(const unsigned long long* fsum,
                             const int* fcnt, const int* exponent,
                             long long cells, float* out) {
  const double inv = ldexp(1.0, -*exponent);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < cells; i += (long long)gridDim.x * blockDim.x) {
    out[3 * i] = from_fixed(fsum[2 * i], inv);
    out[3 * i + 1] = from_fixed(fsum[2 * i + 1], inv);
    out[3 * i + 2] = (float)fcnt[i];
  }
}

// The dynamic shared-memory limit is raised once per instantiation and
// device, not on every launch.
template <int kMode, int kVec, int kBin, bool kGlobal>
cudaError_t raise_smem_limit() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(hist_kernel<kMode, kVec, kBin, kGlobal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// vec (rows per thread and load: 16 or 4), threads (per block), groups
// (feature groups), chunks, smem: the launch plan of ops/hist_cuda.plan.
template <int kMode, int kVec, int kBin, bool kGlobal>
int launch_vec(const Args& a, int threads, int groups, int chunks, int smem,
               cudaStream_t stream) {
  cudaError_t err = raise_smem_limit<kMode, kVec, kBin, kGlobal>();
  if (err != cudaSuccess) return (int)err;
  hist_kernel<kMode, kVec, kBin, kGlobal>
      <<<dim3(groups * a.slices, chunks), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kMode, int kBin, bool kGlobal = false>
int launch_bin(const Args& a, int vec, int threads, int groups, int chunks,
               int smem, cudaStream_t stream) {
  if (vec == 16)
    return launch_vec<kMode, 16, kBin, kGlobal>(a, threads, groups, chunks,
                                                smem, stream);
  if (vec == 4)
    return launch_vec<kMode, 4, kBin, kGlobal>(a, threads, groups, chunks,
                                               smem, stream);
  return (int)cudaErrorInvalidValue;
}

// bin: the layout, kU8, kU16 or kU32 (float, int8), kU8, kPlanes16 or
// kPlanes32 (pane); copies = 0 (32-bit layouts only) accumulates in
// global memory
template <int kMode>
int scatter(const Args& a, int bin, int vec, int threads, int groups,
            int chunks, int smem, cudaStream_t stream) {
  if (a.n <= 0 || a.num_f <= 0) return (int)cudaGetLastError();
  const bool global = a.copies == 0;
  if (smem > kMaxSmem || threads % 64 != 0 || threads > kMaxThreads
      || a.tile % 16 != 0 || a.chunk % a.tile != 0
      || (long long)groups * a.g < a.num_f || a.slices < 1
      || a.slice_cells < 1 || a.copies < 0
      || (long long)a.slices * a.slice_cells < (long long)a.num_b * a.num_c
      || (global && a.slices != 1)
      || (long long)chunks * a.chunk < (long long)a.n + a.shift)
    return (int)cudaErrorInvalidValue;
  constexpr int wide = kMode == kPane ? kPlanes32 : kU32;
  if (bin == wide) {
    if (global)
      return launch_bin<kMode, wide, true>(a, vec, threads, groups, chunks,
                                           smem, stream);
    return launch_bin<kMode, wide>(a, vec, threads, groups, chunks, smem,
                                   stream);
  }
  if (global) return (int)cudaErrorInvalidValue;
  if (bin == kU8)
    return launch_bin<kMode, kU8>(a, vec, threads, groups, chunks, smem,
                                  stream);
  if (bin == (kMode == kPane ? kPlanes16 : kU16))
    return launch_bin<kMode, kMode == kPane ? kPlanes16 : kU16>(
        a, vec, threads, groups, chunks, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// Zeroes the sums, scatters, and (float, pane) writes the f32 output.
template <int kMode>
int launch(Args a, int bin, int vec, int threads, int groups, int chunks,
           int smem, cudaStream_t stream) {
  const long long cells = (long long)a.num_f * a.num_b * a.num_c;
  cudaError_t err = kMode == kInt8
      ? cudaMemsetAsync(a.out, 0, (size_t)cells * 12, stream)
      : cudaMemsetAsync(a.fsum, 0, (size_t)cells * 20, stream);
  if (err != cudaSuccess) return (int)err;
  const int rc = scatter<kMode>(a, bin, vec, threads, groups, chunks, smem,
                                stream);
  if (rc != 0 || kMode == kInt8) return rc;
  const long long want = (cells + 255) / 256;
  const int blocks = want < 1 ? 1 : want > 4096 ? 4096 : (int)want;
  fixed_to_f32<<<blocks, 256, 0, stream>>>(
      a.fsum, a.fcnt, a.exponent, cells, static_cast<float*>(a.out));
  return (int)cudaGetLastError();
}

// float, pane: scratch holds the fixed-point sums [cells][2] (8 bytes
// each), then the counts [cells] (4 bytes each), cells = num_f * num_b *
// num_c; exponent is one int32 on the device.
void set_fixed(Args& a, const void* exponent, void* scratch) {
  a.exponent = static_cast<const int*>(exponent);
  a.fsum = static_cast<unsigned long long*>(scratch);
  a.fcnt = reinterpret_cast<int*>(
      a.fsum + 2 * (long long)a.num_f * a.num_b * a.num_c);
}

Args make_args(const void* bins, long long ld, int n, int num_f, int num_b,
               int num_c, int g, int copies, int tile, int shift,
               long long chunk, int slices, int slice_cells, void* out) {
  Args a = {};
  a.bins = static_cast<const uint8_t*>(bins);
  a.ld = ld;
  a.n = n;
  a.num_f = num_f;
  a.num_b = num_b;
  a.num_c = num_c;
  a.g = g;
  a.slices = slices;
  a.slice_cells = slice_cells;
  a.copies = copies;
  a.tile = tile;
  a.shift = shift;
  a.chunk = chunk;
  a.out = out;
  return a;
}

}  // namespace

extern "C" {

// Every entry: bin row f starts at element f * ld of bins, and bins is
// shift rows past a 16-byte boundary; out is [num_f, num_b, 3 * num_c],
// every cell written here.  bin is the layout (1: uint8, 2: uint16, 4:
// uint32 bins below 2^31).  The arguments vec .. slice_cells are the
// launch plan of ops/hist_cuda.plan (copies = 0: global accumulation, for
// 32-bit bins).

// float32: rows with cid outside [0, num_c) are skipped.  exponent and
// scratch: set_fixed's; out: f32.
int lgbm_hist_f32(const void* bins, long long ld, const void* grad,
                  const void* hess, const void* cid, int n, int num_f,
                  int num_b, int num_c, int shift, int bin, int vec,
                  int threads, int g, int copies, int tile, long long chunk,
                  int groups, int chunks, int smem, int slices,
                  int slice_cells, const void* exponent, void* scratch,
                  void* out, void* stream) {
  Args a = make_args(bins, ld, n, num_f, num_b, num_c, g, copies, tile,
                     shift, chunk, slices, slice_cells, out);
  set_fixed(a, exponent, scratch);
  a.grad = static_cast<const float*>(grad);
  a.hess = static_cast<const float*>(hess);
  a.cid = static_cast<const int32_t*>(cid);
  return launch<kFloat>(a, bin, vec, threads, groups, chunks, smem,
                        (cudaStream_t)stream);
}

// q: [3, qld] int8 quantized (grad, hess, ok) levels; num_c <= 255.
// out: int32.
int lgbm_hist_i8(const void* bins, long long ld, const void* q,
                 long long qld, const void* cid, int n, int num_f,
                 int num_b, int num_c, int shift, int bin, int vec,
                 int threads, int g, int copies, int tile, long long chunk,
                 int groups, int chunks, int smem, int slices,
                 int slice_cells, void* out, void* stream) {
  // a staged row carries its column id in one byte, 0xFF for "dropped"
  if (num_c > 255) return (int)cudaErrorInvalidValue;
  Args a = make_args(bins, ld, n, num_f, num_b, num_c, g, copies, tile,
                     shift, chunk, slices, slice_cells, out);
  a.q = static_cast<const int8_t*>(q);
  a.qld = qld;
  a.cid = static_cast<const int32_t*>(cid);
  return launch<kInt8>(a, bin, vec, threads, groups, chunks, smem,
                       (cudaStream_t)stream);
}

// Plane-pane slice: bins = the pane's first bin row used, at the segment's
// first lane (row stride ld bytes); planes = the pane's grad plane 0 at the
// same lane.  bin_bytes: 1, 2 or 4, the byte planes of a bin; byte k of a
// bin lies k * plane_off bytes after its low byte.  float32, num_c must be
// 1; exponent and scratch as lgbm_hist_f32's.
int lgbm_hist_pane(const void* bins, long long ld, long long plane_off,
                   int bin_bytes, const void* planes, int n, int num_f,
                   int num_b, int num_c, int shift, int vec, int threads,
                   int g, int copies, int tile, long long chunk, int groups,
                   int chunks, int smem, int slices, int slice_cells,
                   const void* exponent, void* scratch, void* out,
                   void* stream) {
  if (num_c != 1 || (bin_bytes != 1 && bin_bytes != 2 && bin_bytes != 4))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(bins, ld, n, num_f, num_b, num_c, g, copies, tile,
                     shift, chunk, slices, slice_cells, out);
  set_fixed(a, exponent, scratch);
  a.plane_off = plane_off;
  a.planes = static_cast<const uint8_t*>(planes);
  return launch<kPane>(a,
                       bin_bytes == 4 ? kPlanes32
                       : bin_bytes == 2 ? kPlanes16 : kU8,
                       vec, threads, groups, chunks, smem,
                       (cudaStream_t)stream);
}

}  // extern "C"
