// Ring-attention block kernels for Hopper (sm_90a): one ring step's
// forward, dq and dk/dv.
//
// Replaces, in paddle_tpu/kernels/flash_attention.py:
//   ring_fwd_step -> _fa_ring_fwd_kernel (:506, via ring_block_fwd :644)
//   ring_dq_step  -> _fa_ring_dq_kernel  (:551, via ring_block_dq  :668)
//   ring_dkv_step -> _fa_ring_dkv_kernel (:592, via ring_block_dkv :693)
// Same functions. A ring hop attends the local q [BH, Sq, D] against the
// held k/v block [BH, Sk, D]; (q_off, k_off) are the global positions of
// their first rows. A key is visible to a q row (causal) when
// k_off + key <= q_off + row. scale = 1/sqrt(D), natural exp:
//   forward: out [BH, Sq, D] in q's dtype and lse [BH, Sq] f32 = m + log l
//            (online softmax); a row that sees no key of the block gives
//            out = 0 and lse = -1e30, so the caller's lse merge gives it
//            zero weight;
//   dq:      dq [BH, Sq, D] f32 = scale * sum_keys ds k, with
//            p = exp(s - lse), ds = p * (dO v^T - delta), lse and delta
//            the caller's (global) rows;
//   dk/dv:   dk [BH, Sk, D] f32 = scale * ds^T q and dv f32 = p^T dO.
// Roundings as in the reference: p to v's (dO's) dtype before p v (p^T dO),
// ds to q's dtype before ds k and ds^T q; dq, dk, dv stay f32 because the
// caller sums them over the hops.
//
// Global offsets drive the trip counts: the forward and dq loops over key
// tiles stop at the last tile the q tile's last row can see, the dk/dv loop
// over q tiles starts at the first tile whose last row sees the key tile.
// Both bounds are computed per tile from the offsets, which need not lie on
// the tile grid, and every score is masked by global position, so the
// bounds only skip work. A hop wholly in the future runs zero iterations
// and is treated as a hop that sees no key. Ragged Sq and Sk are masked in
// the kernels: rows and keys past the end are zero-filled on the way in
// and never written.
//
// Every entry takes a ring step: every slot of the ring that lies on this
// device, in one launch (ring_fwd_step, ring_dq_step, ring_dkv_step). Each
// slot has its own q, k, v (and dO, lse, delta) and offsets; all share
// BH, Sq, Sk, D and the dtype. Their epilogues do what the reference does
// around the hop kernel (paddle_tpu/parallel/sp.py:191-276), so the hop's
// own outputs never reach device memory:
//   ring_fwd_step merges the hop into the slot's running f32 accumulators
//     (o [BH, Sq, D], lse [BH, Sq]) as sp.py:214-218 does:
//       lse' = logaddexp(lse, lse_hop),
//       o'   = o exp(lse - lse') + o_hop exp(lse_hop - lse'),
//     with o_hop kept in f32 (the reference rounds it to q's dtype first).
//     `first`: nothing is read; the hop's (o, lse) is written, which is the
//     merge into (0, -1e30). `last`: out = o' in q's dtype is written
//     instead of o (lse' still is). A row that sees no key of the hop leaves
//     its accumulators bit-unchanged (the merge with lse_hop = -1e30 gives
//     the same up to f32 rounding); under `first` it gets o = 0 and
//     lse = -1e30;
//   ring_dq_step adds the hop's dq into the slot's f32 dq accumulator
//     [BH, Sq, D] (sp.py:259-261), which the caller zeroes once before the
//     ring; a q tile that sees no key of its hop leaves it untouched. One
//     CTA owns each q tile: no atomics, deterministic;
//   ring_dkv_step adds the hop's scale ds^T q and p^T dO into the slot's
//     rotating f32 dk/dv accumulators [BH, Sk, D] (stores them under
//     `first`). One CTA owns each key tile: no atomics, deterministic.
//
// Bound on the H100: at the ERNIE-base path shape (BH = 96, Sq = Sk = 128,
// D = 64, bf16, non-causal) one slot-hop is ~0.4 GFLOP (0.4 us at 989
// TFLOP/s) against 4.7 MB of q/k/v plus 6.3 MB of f32 o read and written
// for the merged forward (3.3 us at 3.35 TB/s), 6.3 MB of bf16 inputs plus
// 6.3 MB of f32 dq read and written for dq (3.8 us), and 6.3 MB of bf16
// inputs plus 12.6 MB of f32 dk/dv read and written for dk/dv (5.6 us):
// bound by bytes, so the design keeps the hop's outputs in registers and
// merges them in the epilogue, and covers the slots of a step in one
// launch (768 forward CTAs at the sp hop, 192 for each of its four slots).
//
// bf16 and fp16 at D = 64 and 128 (every main path): warp-specialised
// wgmma kernels on csrc/hopper.cuh, after flash_fwd.cu and flash_bwd.cu,
// each one template over the element type T (Elem<T>: the .bf16 or .f16
// products, the TMA data type, the rounding of p and ds):
//   * forward: one CTA per (bh, 64-row q tile, slot); one consumer
//     warpgroup and one producer thread issuing TMA loads: Q once, K and V
//     tiles of 128 keys through mbarrier stages (3 at D = 64, 2 CTAs per
//     SM; 2 at D = 128) into 128-byte-swizzled shared memory; S = Q K^T and
//     O += P V on wgmma (P from registers, V MN-major); the online softmax
//     in base 2, lse kept in natural-log units;
//   * dq: the template of csrc/dq_wgmma.cuh (shared with flash_bwd.cu's dq
//     pass): one CTA per (bh, q tile, slot), Q and dO once, K and V tiles
//     of 64 keys streamed by TMA; s, dp and dq += ds k on wgmma; the
//     epilogue adds into the f32 accumulator, every value read first;
//   * dk/dv: one CTA per (bh, 128-key tile, slot), two consumer warpgroups
//     of 64 keys and one producer warp: K, V once, Q, dO, lse and delta of
//     64-row q blocks through two TMA stages; s^T, dp^T, dv += p^T dO and
//     dk += ds^T q on wgmma;
//   * per-slot tensor maps and pointers live in one __grid_constant__
//     argument: at most kMaxSlots slots per launch (the 4 KB parameter
//     space), the wrapper raises above that.
// Masks and trip counts come from the global offsets, which need not lie on
// any tile grid: every score is masked by global position (hidden scores
// give p = 0 exactly), the loop bounds only skip work, and a hop wholly in
// the future runs zero iterations and loads nothing.
// D = 256 bf16 / fp16 and fp32 keep the simple kernels below behind the
// same slot tables and epilogues (no main path runs them):
//   * bf16 / fp16: tiles of 64 q rows x 64 keys on mma.sync m16n8k16 (T in,
//     f32 accumulate); forward and dq: one CTA per (bh, 64-row q tile), a loop
//     over key tiles, the score fragments re-packed in registers as the A
//     operand of the next product; dk/dv: one CTA per (bh, 64-key tile),
//     each warp computes s^T = k q^T for its 16 keys, a loop over q tiles.
//     At D = 256 the dq and dk/dv CTAs have 8 warps, two per row group,
//     each accumulating half of the head dimension;
//   * fp32: the same algorithm on plain FMA in 32 x 32 tiles (TF32 tensor
//     cores keep ~3 digits, against a 1e-4 tolerance).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libring_attention.so ring_attention.cu -lcuda

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dq_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxSlots = 4;  // slots of one ring step per launch

// ---------------------------------------------------------------------------
// the slot tables of a ring step
// ---------------------------------------------------------------------------
struct FwdSlot {
  const void *q, *k, *v;  // [bh, Sq, D], [bh, Sk, D] x 2
  float* o;    // running f32 out [bh, Sq, D]; unused when first && last
  float* lse;             // running f32 lse [bh, Sq]
  void* out;              // [bh, Sq, D] in q's dtype, written when last
  int q_off, k_off;
};

struct DkvSlot {
  const void *q, *k, *v, *dout;  // q, dout [bh, Sq, D]; k, v [bh, Sk, D]
  const float *lse, *delta;      // [bh, Sq]
  float *dk, *dv;                // rotating f32 accumulators [bh, Sk, D]
  int q_off, k_off;
};

struct DqSlot {
  const void *q, *k, *v, *dout;  // q, dout [bh, Sq, D]; k, v [bh, Sk, D]
  const float *lse, *delta;      // [bh, Sq]
  float* dq;                     // the f32 accumulator [bh, Sq, D]
  int q_off, k_off;
};

struct FwdTable {
  FwdSlot s[kMaxSlots];
};

struct DqTable {
  DqSlot s[kMaxSlots];
};

struct DkvTable {
  DkvSlot s[kMaxSlots];
};

// the wgmma kernels' tables: a tensor map per operand and slot
struct FwdMaps {
  CUtensorMap q, k, v;
};

struct DkvMaps {
  CUtensorMap q, k, v, dout;
};

struct FwdWgParams {
  FwdMaps maps[kMaxSlots];
  FwdSlot s[kMaxSlots];
};

struct DkvWgParams {
  DkvMaps maps[kMaxSlots];
  DkvSlot s[kMaxSlots];
};

using DqWgParams = dq_wgmma::Params<kMaxSlots>;

static_assert(sizeof(DkvWgParams) + 64 <= 4096,
              "a launch's slots must fit the 4 KB parameter space");
static_assert(sizeof(DqWgParams) + 64 <= 4096,
              "a launch's slots must fit the 4 KB parameter space");

// ---------------------------------------------------------------------------
// the forward's merge into the running accumulators (sp.py:214-218)
// ---------------------------------------------------------------------------
// What one q row does with its hop result: o' = o * w_old + acc * w_new
// (acc the hop's unnormalised sum, so w_new carries 1 / l), lse' = lse.
// `lo` is the running lse (read only when !first), `lse_hop` the hop's
// natural-log lse, -1e30 for a row that saw no key.
struct RowMerge {
  float w_old, w_new, lse;
  bool write_o;    // o (or, when last, out) is written
  bool write_lse;  // lse is written
};

__device__ __forceinline__ RowMerge row_merge(float lo, float lse_hop,
                                              float inv_l, int first,
                                              int last) {
  const bool seen = lse_hop > kMask;
  RowMerge m;
  if (first) {  // the merge into (0, -1e30)
    m.w_old = 0.f;
    m.w_new = seen ? inv_l : 0.f;
    m.lse = seen ? lse_hop : kMask;
    m.write_o = m.write_lse = true;
  } else if (!seen) {  // the accumulators stay as they are
    m.w_old = 1.f;
    m.w_new = 0.f;
    m.lse = lo;
    m.write_o = last;  // only out, the accumulator cast
    m.write_lse = false;
  } else {
    const float mx = fmaxf(lo, lse_hop);
    m.lse = mx + log1pf(expf(-fabsf(lo - lse_hop)));
    m.w_old = expf(lo - m.lse);
    m.w_new = expf(lse_hop - m.lse) * inv_l;
    m.write_o = m.write_lse = true;
  }
  return m;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = hopper::Elem<T>::pack(x, y);
}

// The merge epilogue of a q tile held in the mma / wgmma accumulator
// layout: acc[4n + 2h + e] is (row row0 + 8h, column 8n + 2t + e) of the
// hop's unnormalised output, lse_hop[h] and inv_l[h] its rows' lse and
// 1 / l. Every lane of the warp calls it (the running lse is read by lane
// t = 0 of each quad and shuffled to the other three).
// The epilogues below read every running value they need before they
// store any: a load after a store through another pointer (o and out, dk
// and dv) cannot be moved ahead of it by the compiler, and a chain of such
// pairs costs one round trip to device memory each.

// dk or dv of the key rows key0 + 8h, h in [h0, h0 + kRows), in the mma /
// wgmma accumulator layout (acc[4n + 2h + e] is key key0 + 8h, column
// col + 8n + e): acc * s stored under `first`, else added to the slot's
// running values. kRows rows are read at once (registers allowing).
template <int DW, int kRows>
__device__ __forceinline__ void add_rows(float* dst, const float* acc,
                                         float s, int h0, int key0, int Sk,
                                         size_t kbase, int D, int col,
                                         int first) {
  float2 old[kRows][DW / 8];
#pragma unroll
  for (int hh = 0; hh < kRows; ++hh) {
    const int key = key0 + 8 * (h0 + hh);
#pragma unroll
    for (int n = 0; n < DW / 8; ++n)
      old[hh][n] = !first && key < Sk
                       ? *reinterpret_cast<const float2*>(
                             dst + (kbase + key) * D + col + 8 * n)
                       : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int hh = 0; hh < kRows; ++hh) {
    const int h = h0 + hh, key = key0 + 8 * h;
    if (key >= Sk) continue;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n)
      store2(dst + (kbase + key) * D + col + 8 * n,
             fmaf(acc[4 * n + 2 * h], s, old[hh][n].x),
             fmaf(acc[4 * n + 2 * h + 1], s, old[hh][n].y));
  }
}

// both accumulators of a key tile's fragment: dk = scale ds^T q, dv = p^T dO
template <int DW, int kRows>
__device__ __forceinline__ void add_dkv_fragment(const DkvSlot& sl,
                                                 const float* acc_dk,
                                                 const float* acc_dv,
                                                 int key0, int Sk,
                                                 size_t kbase, int D, int col,
                                                 float scale, int first) {
#pragma unroll
  for (int h0 = 0; h0 < 2; h0 += kRows) {
    add_rows<DW, kRows>(sl.dk, acc_dk, scale, h0, key0, Sk, kbase, D, col,
                        first);
    add_rows<DW, kRows>(sl.dv, acc_dv, 1.f, h0, key0, Sk, kbase, D, col,
                        first);
  }
}

// the running o of q rows row0 + 8h, h in [h0, h0 + kRows), at this
// thread's columns (zeros under `first` and past Sq)
template <int D, int kRows>
__device__ __forceinline__ void load_o_rows(float2 (&old)[kRows][D / 8],
                                            const FwdSlot& sl, int h0,
                                            int row0, int t, int Sq,
                                            size_t rbase, int first) {
#pragma unroll
  for (int hh = 0; hh < kRows; ++hh) {
    const int row = row0 + 8 * (h0 + hh);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      old[hh][n] = !first && row < Sq
                       ? *reinterpret_cast<const float2*>(
                             sl.o + (rbase + row) * D + 2 * t + 8 * n)
                       : make_float2(0.f, 0.f);
  }
}

// the running lse of the thread's two rows, read by lane t = 0 of each
// quad (0 under `first` and past Sq)
__device__ __forceinline__ void load_lse_rows(float (&lo)[2],
                                              const FwdSlot& sl, int row0,
                                              int t, int Sq, size_t rbase,
                                              int first) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lo[h] = (!first && t == 0 && row < Sq) ? sl.lse[rbase + row] : 0.f;
  }
}

// what each of the thread's two rows does with its hop, the running lse
// shuffled from lane t = 0 of the quad (every lane of the warp calls it)
__device__ __forceinline__ void row_merges(RowMerge (&m)[2],
                                           const float (&lo)[2],
                                           const float (&lse_hop)[2],
                                           const float (&inv_l)[2], int lane,
                                           int first, int last) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    m[h] = row_merge(__shfl_sync(0xffffffffu, lo[h], lane & ~3), lse_hop[h],
                     inv_l[h], first, last);
}

// o' = o w_old + acc w_new for rows row0 + 8h, h in [h0, h0 + kRows), in
// the mma / wgmma accumulator layout (acc[4n + 2h + e] is row row0 + 8h,
// column 8n + 2t + e), written to o, or when last to out; and lse'
template <int D, int kRows, typename OutT>
__device__ __forceinline__ void merge_rows(const float* acc,
                                           const float2 (&old)[kRows][D / 8],
                                           const RowMerge (&m)[2], int h0,
                                           int row0, int t, int Sq,
                                           size_t rbase, const FwdSlot& sl,
                                           int last) {
#pragma unroll
  for (int hh = 0; hh < kRows; ++hh) {
    const int h = h0 + hh, row = row0 + 8 * h;
    if (row >= Sq) continue;
    if (m[h].write_o) {
      const size_t off = (rbase + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float x = fmaf(old[hh][n].x, m[h].w_old,
                             acc[4 * n + 2 * h] * m[h].w_new);
        const float y = fmaf(old[hh][n].y, m[h].w_old,
                             acc[4 * n + 2 * h + 1] * m[h].w_new);
        if (last)
          store2(static_cast<OutT*>(sl.out) + off + 8 * n, x, y);
        else
          store2(sl.o + off + 8 * n, x, y);
      }
    }
    if (m[h].write_lse && t == 0) sl.lse[rbase + row] = m[h].lse;
  }
}

// The merge epilogue of a q tile held in the mma / wgmma accumulator
// layout, lse_hop[h] and inv_l[h] the hop's lse and 1 / l of its two rows;
// the running o is read kRows rows at a time.
template <int D, int kRows, typename OutT>
__device__ __forceinline__ void merge_fragment(const float* acc,
                                               const float (&lse_hop)[2],
                                               const float (&inv_l)[2],
                                               int row0, int t, int lane,
                                               int Sq, size_t rbase,
                                               const FwdSlot& sl, int first,
                                               int last) {
  float lo[2];
  load_lse_rows(lo, sl, row0, t, Sq, rbase, first);
  RowMerge m[2];
  row_merges(m, lo, lse_hop, inv_l, lane, first, last);
#pragma unroll
  for (int h0 = 0; h0 < 2; h0 += kRows) {
    float2 old[kRows][D / 8];
    load_o_rows<D, kRows>(old, sl, h0, row0, t, Sq, rbase, first);
    merge_rows<D, kRows, OutT>(acc, old, m, h0, row0, t, Sq, rbase, sl,
                               last);
  }
}

// ---------------------------------------------------------------------------
// tile bounds from the global offsets
// ---------------------------------------------------------------------------

// the key-tile trip count and the per-tile mask test of csrc/dq_wgmma.cuh
using dq_wgmma::key_tiles;
using dq_wgmma::tile_needs_mask;

// first q tile (of bq rows, n_qb in all) whose last row sees key k0
__device__ __forceinline__ int first_q_tile(int k0, int bq, int n_qb,
                                            int q_off, int k_off,
                                            int causal) {
  if (!causal) return 0;
  const long long x = (long long)k_off + k0 - q_off;
  if (x <= 0) return 0;
  const long long qb = x / bq;
  return qb < n_qb ? (int)qb : n_qb;
}

__device__ __forceinline__ bool visible(int row, int Sq, int key, int Sk,
                                        int q_off, int k_off, int causal) {
  return row < Sq && key < Sk &&
         (!causal || (long long)k_off + key <= (long long)q_off + row);
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores through mma.sync
// ---------------------------------------------------------------------------
constexpr int kB = 64;  // q rows and keys per tile

template <int D>
struct MmaCfg {
  static constexpr int DW = D > 128 ? 128 : D;  // head-dim columns per warp
  static constexpr int kWarps = 4 * (D / DW);   // 4 row groups x D / DW
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int TS = D + 8;   // row stride of the [64][D] tiles
};
constexpr int kFwdThreads = 128;  // the forward keeps 4 warps at every D

using hopper::mma_16816;
using hopper::Elem;

// two neighbouring elements of one row (the row-major fragment read)
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two elements of one column, rows r and r + 1 (the transposed read)
template <typename T>
__device__ __forceinline__ uint32_t ld_col2(const T* p, int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
}

// A fragment of a 16 x 16 step from row-major rows (p = row g, column 2t)
template <typename T>
__device__ __forceinline__ void ld_a(uint32_t a[4], const T* p, int stride) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// A fragment of the 16-column step kk from a 16 x 64 accumulator (the
// fragments of n-tiles 2kk and 2kk+1), rounded to T
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t a[4], float (*c)[4], int kk) {
  a[0] = Elem<T>::pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = Elem<T>::pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = Elem<T>::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = Elem<T>::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// stage rows [row0, row0 + 64) of an [n, D] matrix into a tile with rows
// padded by 8 (so a warp's fragment reads hit distinct banks); rows past n
// read as zeros
template <int D, int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int n, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int TS = D + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kB * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * TS + c) = val;
  }
}

template <int D>
constexpr int fwd_mma_smem_bytes() {
  // Q and K tiles [64][D+8], V^T tile [D][64+8]
  return (2 * kB * (D + 8) + D * (kB + 8)) * 2;
}

template <int D>
constexpr int bwd_mma_smem_bytes() {
  // Q, dO, K, V tiles [64][D+8], and (dk/dv) the lse and delta rows
  return 4 * kB * (D + 8) * 2 + 2 * kB * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
ring_fwd_mma_kernel(const __grid_constant__ FwdTable tab, int Sq, int Sk,
                    int causal, int first, int last, float scale) {
  const FwdSlot& sl = tab.s[blockIdx.z];
  const T* __restrict__ q = static_cast<const T*>(sl.q);
  const T* __restrict__ k = static_cast<const T*>(sl.k);
  const T* __restrict__ v = static_cast<const T*>(sl.v);
  const int q_off = sl.q_off, k_off = sl.k_off;
  constexpr int QS = D + 8;   // row stride of the Q and K tiles
  constexpr int VS = kB + 8;  // row stride of the V^T tile
  constexpr int CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kB * QS;
  T* sVt = sK + kB * QS;

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qi * kB;
  const size_t qbase = (size_t)blockIdx.y * Sq * D;
  const size_t kbase = (size_t)blockIdx.y * Sk * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates

  load_tile<D, kFwdThreads>(sQ, q + qbase, q0, Sq, tid);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's two rows: g and g + 8 of the warp's 16
  float m_run[2] = {kMask, kMask};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
  const int row0 = q0 + warp * 16 + g;

  const int n_kb = (Sk + kB - 1) / kB;
  const int kb_end = key_tiles(q0, kB, kB, n_kb, q_off, k_off, causal);
  const T* qw = sQ + (warp * 16 + g) * QS + 2 * t;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kB * CH; i += kFwdThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < Sk) {
        const size_t off = kbase + (size_t)(k0 + r) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + r * QS + c) = kv;
      const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * VS + r] = ve[e];
    }
    __syncthreads();

    // s = q k^T for the warp's 16 rows x 64 keys
    float s[kB / 8][4];
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ld_a(a, qw + kk * 16, QS);
#pragma unroll
      for (int j = 0; j < kB / 8; ++j) {
        const T* kp = sK + (j * 8 + g) * QS + kk * 16 + 2 * t;
        mma_16816<T>(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    // scale; hidden scores become -1e30 and, below, p = 0 exactly (so a
    // row that sees none of the keys keeps l = 0)
    const bool need_mask =
        tile_needs_mask(q0, kB, Sq, k0, kB, Sk, q_off, k_off, causal);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (need_mask &&
            !visible(row0 + (e >> 1) * 8, Sq, k0 + j * 8 + 2 * t + (e & 1),
                     Sk, q_off, k_off, causal))
          x = kMask;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = expf(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x <= kMask ? 0.f : expf(x - mx[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p v: the score accumulator of key tiles 2kk, 2kk+1 is the A
    // fragment of the 16-key step kk (p rounded to v's dtype)
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t a[4];
      pack_a<T>(a, s, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const T* vp = sVt + (n * 8 + g) * VS + kk * 16 + 2 * t;
        mma_16816<T>(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // merged for every row, also when the loop ran zero times
  float lse_hop[2], inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lse_hop[h] = l > 0.f ? m_run[h] + logf(l) : kMask;
    inv_l[h] = l > 0.f ? 1.f / l : 0.f;
  }
  merge_fragment<D, 1, T>(&acc[0][0], lse_hop, inv_l, row0, t, lane, Sq,
                             (size_t)blockIdx.y * Sq, sl, first, last);
}

template <typename T, int D>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads)
ring_dq_mma_kernel(const __grid_constant__ DqTable tab, int Sq, int Sk,
                   int causal, float scale) {
  const DqSlot& sl = tab.s[blockIdx.z];
  const T* __restrict__ q = static_cast<const T*>(sl.q);
  const T* __restrict__ k = static_cast<const T*>(sl.k);
  const T* __restrict__ v = static_cast<const T*>(sl.v);
  const T* __restrict__ dout = static_cast<const T*>(sl.dout);
  const float* __restrict__ lse = sl.lse;
  const float* __restrict__ delta = sl.delta;
  const int q_off = sl.q_off, k_off = sl.k_off;
  using C = MmaCfg<D>;
  constexpr int TS = C::TS, DW = C::DW, NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kB * TS;
  T* sK = sdO + kB * TS;
  T* sV = sK + kB * TS;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qb * kB;
  const int n_kb = (Sk + kB - 1) / kB;
  const int kb_end = key_tiles(q0, kB, kB, n_kb, q_off, k_off, causal);
  // a q tile that sees no key of the hop leaves its accumulator as it is
  if (kb_end == 0) return;
  const size_t qbase = (size_t)blockIdx.y * Sq * D;
  const size_t kbase = (size_t)blockIdx.y * Sk * D;
  const size_t rbase = (size_t)blockIdx.y * Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;
  const int d0 = (warp >> 2) * DW;

  load_tile<D, NT>(sQ, q + qbase, q0, Sq, tid);
  load_tile<D, NT>(sdO, dout + qbase, q0, Sq, tid);
  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = q0 + rg * 16 + g;
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row0 + h * 8 < Sq;
    lr[h] = ok ? lse[rbase + row0 + h * 8] : 0.f;
    dl[h] = ok ? delta[rbase + row0 + h * 8] : 0.f;
  }

  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const T* qw = sQ + (rg * 16 + g) * TS + 2 * t;
  const T* ow = sdO + (rg * 16 + g) * TS + 2 * t;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the previous K/V tile is consumed (Q, dO staged)
    load_tile<D, NT>(sK, k + kbase, k0, Sk, tid);
    load_tile<D, NT>(sV, v + kbase, k0, Sk, tid);
    __syncthreads();

    // s = q k^T and dp = dO v^T: the warp's 16 q rows x 64 keys
    float s[kB / 8][4], dp[kB / 8][4];
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ld_a(aq, qw + kk * 16, TS);
      ld_a(ao, ow + kk * 16, TS);
#pragma unroll
      for (int j = 0; j < kB / 8; ++j) {
        const T* kp = sK + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_16816<T>(s[j], aq, ld32(kp), ld32(kp + 8));
        const T* vp = sV + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_16816<T>(dp[j], ao, ld32(vp), ld32(vp + 8));
      }
    }

    const bool need_mask =
        tile_needs_mask(q0, kB, Sq, k0, kB, Sk, q_off, k_off, causal);
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = 0.f;
        if (!need_mask || visible(row0 + h * 8, Sq, k0 + j * 8 + 2 * t + (e & 1),
                                  Sk, q_off, k_off, causal))
          p = expf(s[j][e] * scale - lr[h]);
        s[j][e] = p * (dp[j][e] - dl[h]);  // ds
      }

    // dq += ds k over the tile's 64 keys (ds rounded to q's dtype)
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t a[4];
      pack_a<T>(a, s, kk);
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        const T* kp = sK + (kk * 16 + 2 * t) * TS + d0 + n * 8 + g;
        mma_16816<T>(acc[n], a, ld_col2(kp, TS), ld_col2(kp + 8 * TS, TS));
      }
    }
  }

  // dq * scale added into the accumulator, every value read first
  float2 old[2][DW / 8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n)
      old[h][n] = row < Sq ? *reinterpret_cast<const float2*>(
                                 sl.dq + qbase + (size_t)row * D + d0 +
                                 2 * t + n * 8)
                           : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row < Sq) {
      float* out = sl.dq + qbase + (size_t)row * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < DW / 8; ++n)
        *reinterpret_cast<float2*>(out + n * 8) =
            make_float2(fmaf(acc[n][2 * h], scale, old[h][n].x),
                        fmaf(acc[n][2 * h + 1], scale, old[h][n].y));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads)
ring_dkv_mma_kernel(const __grid_constant__ DkvTable tab, int Sq, int Sk,
                    int causal, int first, float scale) {
  const DkvSlot& sl = tab.s[blockIdx.z];
  const T* __restrict__ q = static_cast<const T*>(sl.q);
  const T* __restrict__ k = static_cast<const T*>(sl.k);
  const T* __restrict__ v = static_cast<const T*>(sl.v);
  const T* __restrict__ dout = static_cast<const T*>(sl.dout);
  const float* __restrict__ lse = sl.lse;
  const float* __restrict__ delta = sl.delta;
  const int q_off = sl.q_off, k_off = sl.k_off;
  using C = MmaCfg<D>;
  constexpr int TS = C::TS, DW = C::DW, NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kB * TS;
  T* sQ = sV + kB * TS;
  T* sdO = sQ + kB * TS;
  float* sL = reinterpret_cast<float*>(sdO + kB * TS);  // lse
  float* sDl = sL + kB;                                  // delta

  const int k0 = blockIdx.x * kB;
  const size_t qbase = (size_t)blockIdx.y * Sq * D;
  const size_t kbase = (size_t)blockIdx.y * Sk * D;
  const size_t rbase = (size_t)blockIdx.y * Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int rg = warp & 3;                // row group: 16 keys
  const int d0 = (warp >> 2) * DW;        // this warp's head-dim columns

  load_tile<D, NT>(sK, k + kbase, k0, Sk, tid);
  load_tile<D, NT>(sV, v + kbase, k0, Sk, tid);

  float acc_dk[DW / 8][4], acc_dv[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  const T* kw = sK + (rg * 16 + g) * TS + 2 * t;
  const T* vw = sV + (rg * 16 + g) * TS + 2 * t;
  const int n_qb = (Sq + kB - 1) / kB;
  const int qb_begin = first_q_tile(k0, kB, n_qb, q_off, k_off, causal);

  for (int qb = qb_begin; qb < n_qb; ++qb) {
    const int q0 = qb * kB;
    __syncthreads();  // the previous q tile is consumed
    load_tile<D, NT>(sQ, q + qbase, q0, Sq, tid);
    load_tile<D, NT>(sdO, dout + qbase, q0, Sq, tid);
    for (int i = tid; i < kB; i += NT) {
      const bool ok = q0 + i < Sq;
      sL[i] = ok ? lse[rbase + q0 + i] : 0.f;
      sDl[i] = ok ? delta[rbase + q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T: the warp's 16 keys x 64 q rows
    float st[kB / 8][4], dpt[kB / 8][4];
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ld_a(ak, kw + kk * 16, TS);
      ld_a(av, vw + kk * 16, TS);
#pragma unroll
      for (int j = 0; j < kB / 8; ++j) {
        const T* qp = sQ + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_16816<T>(st[j], ak, ld32(qp), ld32(qp + 8));
        const T* op = sdO + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_16816<T>(dpt[j], av, ld32(op), ld32(op + 8));
      }
    }

    // p^T and ds^T; hidden pairs get p = 0 exactly
    const bool need_mask =
        tile_needs_mask(q0, kB, Sq, k0, kB, Sk, q_off, k_off, causal);
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        float p = 0.f;
        if (!need_mask || visible(q0 + ql, Sq, k0 + rg * 16 + g + (e >> 1) * 8,
                                  Sk, q_off, k_off, causal))
          p = expf(st[j][e] * scale - sL[ql]);
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sDl[ql]);
      }

    // dv += p^T dO (p rounded to dO's dtype) and dk += ds^T q (ds rounded
    // to q's dtype), over the tile's 64 q rows
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t ap[4], as[4];
      pack_a<T>(ap, st, kk);
      pack_a<T>(as, dpt, kk);
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        const int col = d0 + n * 8 + g;
        const T* op = sdO + (kk * 16 + 2 * t) * TS + col;
        mma_16816<T>(acc_dv[n], ap, ld_col2(op, TS),
                       ld_col2(op + 8 * TS, TS));
        const T* qp = sQ + (kk * 16 + 2 * t) * TS + col;
        mma_16816<T>(acc_dk[n], as, ld_col2(qp, TS),
                       ld_col2(qp + 8 * TS, TS));
      }
    }
  }

  // stored under `first` (also when the loop ran zero times), else added;
  // a hop that saw no q row leaves the accumulators as they are
  if (!first && qb_begin >= n_qb) return;
  add_dkv_fragment<DW, 1>(sl, &acc_dk[0][0], &acc_dv[0][0], k0 + rg * 16 + g,
                          Sk, (size_t)blockIdx.y * Sk, D, d0 + 2 * t, scale,
                          first);
}

// ---------------------------------------------------------------------------
// fp32: the same algorithm on plain FMA
// ---------------------------------------------------------------------------
constexpr int kFB = 32;         // q rows and keys per tile
constexpr int kFThreads = 128;  // 4 neighbouring lanes per row

template <int D>
constexpr int fwd_f32_smem_bytes() {
  // Q and K tiles [32][D+1] (odd stride: conflict-free dot products), V
  // tile [32][D], P tile [32][32+1]
  return (2 * kFB * (D + 1) + kFB * D + kFB * (kFB + 1)) * 4;
}

template <int D>
constexpr int dq_f32_smem_bytes() {
  return (4 * kFB * (D + 1) + kFB * (kFB + 1)) * 4;  // Q, dO, K, V, ds
}

template <int D>
constexpr int dkv_f32_smem_bytes() {
  // K, V, Q, dO tiles, p and ds tiles [32][32+1], lse and delta rows
  return (4 * kFB * (D + 1) + 2 * kFB * (kFB + 1) + 2 * kFB) * 4;
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int n, int tid) {
  for (int i = tid; i < kFB * D; i += kFThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        row0 + r < n ? src[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
ring_fwd_f32_kernel(const __grid_constant__ FwdTable tab, int Sq, int Sk,
                    int causal, int first, int last, float scale) {
  const FwdSlot& sl = tab.s[blockIdx.z];
  const float* __restrict__ q = static_cast<const float*>(sl.q);
  const float* __restrict__ k = static_cast<const float*>(sl.k);
  const float* __restrict__ v = static_cast<const float*>(sl.v);
  const int q_off = sl.q_off, k_off = sl.k_off;
  constexpr int QS = D + 1;
  constexpr int PS = kFB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kFB * QS;
  float* sV = sK + kFB * QS;
  float* sP = sV + kFB * D;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int q0 = qi * kFB;
  const size_t qbase = (size_t)blockIdx.y * Sq * D;
  const size_t kbase = (size_t)blockIdx.y * Sk * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;  // row r, the 4 threads of a row
  const int qrow = q0 + r;

  load_tile_f32<D>(sQ, q + qbase, q0, Sq, tid);

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m_run = kMask, l_run = 0.f;

  const int n_kb = (Sk + kFB - 1) / kFB;
  const int kb_end = key_tiles(q0, kFB, kFB, n_kb, q_off, k_off, causal);
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kFB;
    __syncthreads();
    for (int i = tid; i < kFB * D; i += kFThreads) {
      const int rr = i / D, c = i % D;
      const bool ok = k0 + rr < Sk;
      const size_t off = kbase + (size_t)(k0 + rr) * D + c;
      sK[rr * QS + c] = ok ? k[off] : 0.f;
      sV[rr * D + c] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    float s[kFB / 4];
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < kFB / 4; ++j) {
      const int key = sub + 4 * j;
      const float* qr = sQ + r * QS;
      const float* kr = sK + key * QS;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float x = dot * scale;
      if (!visible(qrow, Sq, k0 + key, Sk, q_off, k_off, causal)) x = kMask;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m_run - mx);
    m_run = mx;
    l_run *= alpha;
#pragma unroll
    for (int j = 0; j < kFB / 4; ++j) {
      const float p = s[j] <= kMask ? 0.f : expf(s[j] - mx);
      l_run += p;
      sP[r * PS + sub + 4 * j] = p;
    }
    __syncwarp();  // a row's p is written and read by its own 4 lanes
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int d = sub + 4 * i;
      float a = acc[i] * alpha;
#pragma unroll 8
      for (int key = 0; key < kFB; ++key)
        a = fmaf(sP[r * PS + key], sV[key * D + d], a);
      acc[i] = a;
    }
  }

  // merged for every row, also when the loop ran zero times; the running
  // lse is read by the row's first lane and shuffled to the other three
  float l = l_run;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const size_t rrow = (size_t)blockIdx.y * Sq + qrow;
  float lo = (!first && sub == 0 && qrow < Sq) ? sl.lse[rrow] : 0.f;
  lo = __shfl_sync(0xffffffffu, lo, (tid & 31) & ~3);
  if (qrow < Sq) {
    const RowMerge m = row_merge(lo, l > 0.f ? m_run + logf(l) : kMask,
                                 l > 0.f ? 1.f / l : 0.f, first, last);
    float* dst = last ? static_cast<float*>(sl.out) : sl.o;
    if (m.write_o) {
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const size_t off = qbase + (size_t)qrow * D + sub + 4 * i;
        float x = acc[i] * m.w_new;
        if (!first) x = fmaf(sl.o[off], m.w_old, x);
        dst[off] = x;
      }
    }
    if (m.write_lse && sub == 0) sl.lse[rrow] = m.lse;
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
ring_dq_f32_kernel(const __grid_constant__ DqTable tab, int Sq, int Sk,
                   int causal, float scale) {
  const DqSlot& sl = tab.s[blockIdx.z];
  const float* __restrict__ q = static_cast<const float*>(sl.q);
  const float* __restrict__ k = static_cast<const float*>(sl.k);
  const float* __restrict__ v = static_cast<const float*>(sl.v);
  const float* __restrict__ dout = static_cast<const float*>(sl.dout);
  const float* __restrict__ lse = sl.lse;
  const float* __restrict__ delta = sl.delta;
  const int q_off = sl.q_off, k_off = sl.k_off;
  constexpr int TS = D + 1, PS = kFB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + kFB * TS;
  float* sK = sdO + kFB * TS;
  float* sV = sK + kFB * TS;
  float* sDS = sV + kFB * TS;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * kFB;
  const int n_kb = (Sk + kFB - 1) / kFB;
  const int kb_end = key_tiles(q0, kFB, kFB, n_kb, q_off, k_off, causal);
  // a q tile that sees no key of the hop leaves its accumulator as it is
  if (kb_end == 0) return;
  const size_t qbase = (size_t)blockIdx.y * Sq * D;
  const size_t kbase = (size_t)blockIdx.y * Sk * D;
  const size_t rbase = (size_t)blockIdx.y * Sq;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int qrow = q0 + r;

  load_tile_f32<D>(sQ, q + qbase, q0, Sq, tid);
  load_tile_f32<D>(sdO, dout + qbase, q0, Sq, tid);
  const float lr = qrow < Sq ? lse[rbase + qrow] : 0.f;
  const float dl = qrow < Sq ? delta[rbase + qrow] : 0.f;

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kFB;
    __syncthreads();
    load_tile_f32<D>(sK, k + kbase, k0, Sk, tid);
    load_tile_f32<D>(sV, v + kbase, k0, Sk, tid);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kFB / 4; ++j) {
      const int kl = sub + 4 * j;
      const float* qr = sQ + r * TS;
      const float* orow = sdO + r * TS;
      const float* kr = sK + kl * TS;
      const float* vr = sV + kl * TS;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(orow[d], vr[d], dp);
      }
      float p = 0.f;
      if (visible(qrow, Sq, k0 + kl, Sk, q_off, k_off, causal))
        p = expf(s * scale - lr);
      sDS[r * PS + kl] = p * (dp - dl);
    }
    __syncwarp();  // a row's ds is written and read by its own 4 lanes
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      float a = acc[i];
#pragma unroll 8
      for (int kl = 0; kl < kFB; ++kl)
        a = fmaf(sDS[r * PS + kl], sK[kl * TS + sub + 4 * i], a);
      acc[i] = a;
    }
  }

  // dq * scale added into the accumulator, every value read first
  if (qrow < Sq) {
    float* dst = sl.dq + qbase + (size_t)qrow * D + sub;
    float old[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) old[i] = dst[4 * i];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dst[4 * i] = fmaf(acc[i], scale, old[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
ring_dkv_f32_kernel(const __grid_constant__ DkvTable tab, int Sq, int Sk,
                    int causal, int first, float scale) {
  const DkvSlot& sl = tab.s[blockIdx.z];
  const float* __restrict__ q = static_cast<const float*>(sl.q);
  const float* __restrict__ k = static_cast<const float*>(sl.k);
  const float* __restrict__ v = static_cast<const float*>(sl.v);
  const float* __restrict__ dout = static_cast<const float*>(sl.dout);
  const float* __restrict__ lse = sl.lse;
  const float* __restrict__ delta = sl.delta;
  const int q_off = sl.q_off, k_off = sl.k_off;
  constexpr int TS = D + 1, PS = kFB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kFB * TS;
  float* sQ = sV + kFB * TS;
  float* sdO = sQ + kFB * TS;
  float* sP = sdO + kFB * TS;  // [q][key]
  float* sDS = sP + kFB * PS;  // [q][key]
  float* sL = sDS + kFB * PS;
  float* sDl = sL + kFB;

  const int k0 = blockIdx.x * kFB;
  const size_t qbase = (size_t)blockIdx.y * Sq * D;
  const size_t kbase = (size_t)blockIdx.y * Sk * D;
  const size_t rbase = (size_t)blockIdx.y * Sq;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;  // row r, its 4 neighbouring lanes

  load_tile_f32<D>(sK, k + kbase, k0, Sk, tid);
  load_tile_f32<D>(sV, v + kbase, k0, Sk, tid);

  // this thread accumulates key k0 + r, head-dim columns sub + 4 i
  float acc_dk[D / 4], acc_dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  const int n_qb = (Sq + kFB - 1) / kFB;
  const int qb_begin = first_q_tile(k0, kFB, n_qb, q_off, k_off, causal);
  for (int qb = qb_begin; qb < n_qb; ++qb) {
    const int q0 = qb * kFB;
    __syncthreads();
    load_tile_f32<D>(sQ, q + qbase, q0, Sq, tid);
    load_tile_f32<D>(sdO, dout + qbase, q0, Sq, tid);
    if (tid < kFB) {
      const bool ok = q0 + tid < Sq;
      sL[tid] = ok ? lse[rbase + q0 + tid] : 0.f;
      sDl[tid] = ok ? delta[rbase + q0 + tid] : 0.f;
    }
    __syncthreads();

    // p and ds of q row q0 + r against keys sub + 4 j
    const int qrow = q0 + r;
#pragma unroll
    for (int j = 0; j < kFB / 4; ++j) {
      const int kl = sub + 4 * j;
      const float* qr = sQ + r * TS;
      const float* orow = sdO + r * TS;
      const float* kr = sK + kl * TS;
      const float* vr = sV + kl * TS;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(orow[d], vr[d], dp);
      }
      float p = 0.f;
      if (visible(qrow, Sq, k0 + kl, Sk, q_off, k_off, causal))
        p = expf(s * scale - sL[r]);
      sP[r * PS + kl] = p;
      sDS[r * PS + kl] = p * (dp - sDl[r]);
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T q for key k0 + r
#pragma unroll 4
    for (int ql = 0; ql < kFB; ++ql) {
      const float p = sP[ql * PS + r], ds = sDS[ql * PS + r];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        acc_dv[i] = fmaf(p, sdO[ql * TS + sub + 4 * i], acc_dv[i]);
        acc_dk[i] = fmaf(ds, sQ[ql * TS + sub + 4 * i], acc_dk[i]);
      }
    }
  }

  // stored under `first`, else added (a hop that saw no q row adds nothing)
  const int key = k0 + r;
  if (key < Sk && (first || qb_begin < n_qb)) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const size_t off = kbase + (size_t)key * D + sub + 4 * i;
      float x = acc_dk[i] * scale, y = acc_dv[i];
      if (!first) {
        x += sl.dk[off];
        y += sl.dv[off];
      }
      sl.dk[off] = x;
      sl.dv[off] = y;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16, D = 64 and 128: warp-specialised wgmma fed by TMA
// ---------------------------------------------------------------------------
template <int D>
struct WgFwdCfg {
  static constexpr int kM = 64;   // q rows per CTA: one consumer warpgroup
  static constexpr int kN = 128;  // keys per K or V tile
  // K/V stages: at D = 64 three fit two CTAs in an SM (as flash_fwd.cu);
  // D = 128 takes two
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kThreads = 256;  // consumer + producer warpgroups
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kTileBytes = kN * D * 2;
  // Q, the K ring, the V ring, the barriers; +1024 aligns the base
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 128 +
                               1024;
};

// one key tile of the online softmax in base 2, in place: s holds q k^T on
// entry and p = exp2(s * s2scale - m) on exit. Hidden scores (keys past
// Sk, and with `causal` keys after the row in global order: key > row +
// diag, diag = q_off - k_off) become -inf and so p = 0 exactly: a row that
// has seen no key keeps m = -1e30 and l = 0.
template <int kN>
__device__ __forceinline__ void ring_softmax(float (&s)[kN / 2],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2],
                                             float s2scale, int k0, int Sk,
                                             int row0, long long diag,
                                             int causal, bool need_mask,
                                             int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int h = (i >> 1) & 1;
    if (need_mask) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (key >= Sk || (causal && (long long)key > row0 + 8 * h + diag))
        s[i] = -INFINITY;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mx[h] = fmaxf(m_run[h], mx[h] * s2scale);  // base-2 domain from here
    alpha[h] = exp2f(m_run[h] - mx[h]);
    m_run[h] = mx[h];
    l_run[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2f(fmaf(s[i], s2scale, -m_run[h]));
    s[i] = p;
    l_run[h] += p;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256, 2)
ring_fwd_wgmma_kernel(const __grid_constant__ FwdWgParams prm, int Sq,
                      int Sk, int causal, int first, int last,
                      float s2scale) {
  using namespace hopper;
  using C = WgFwdCfg<D>;
  constexpr int kM = C::kM, kN = C::kN, ST = C::kStages, NH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;  // stage st at + st * kTileBytes
  const uint32_t sV = sK + ST * C::kTileBytes;
  // barriers: Q full, then per stage K full, V full, K/V empty
  const uint32_t full_q = sV + ST * C::kTileBytes;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * ST,
                 empty = full_v + 8 * ST;

  const int bh = blockIdx.x;
  const FwdSlot& sl = prm.s[blockIdx.z];
  const FwdMaps& maps = prm.maps[blockIdx.z];
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;  // heaviest tiles first
  const int n_kb = (Sk + kN - 1) / kN;
  const int kb_end = key_tiles(q0, kM, kN, n_kb, sl.q_off, sl.k_off, causal);
  const long long diag = (long long)sl.q_off - sl.k_off;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, 1);  // the consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread loads Q, then keeps the K/V ring full, key
    // tiles from the last one the q tile sees; nothing for a future hop
    reg_dealloc<24>();
    if (threadIdx.x == 128 && kb_end > 0) {
      mbar_arrive_expect_tx(full_q, C::kQBytes);
      for (int h = 0; h < NH; ++h)
        tma_load_3d(sQ + h * kM * 128, &maps.q, full_q, h * 64, q0, bh);
      for (int it = 0; it < kb_end; ++it) {
        const int kb = kb_end - 1 - it, st = it % ST;
        mbar_wait(empty + 8 * st, ((it / ST) & 1) ^ 1);
        const uint32_t k_tile = sK + st * C::kTileBytes;
        const uint32_t v_tile = sV + st * C::kTileBytes;
        mbar_arrive_expect_tx(full_k + 8 * st, C::kTileBytes);
        for (int h = 0; h < NH; ++h)
          tma_load_3d(k_tile + h * kN * 128, &maps.k, full_k + 8 * st,
                      h * 64, kb * kN, bh);
        mbar_arrive_expect_tx(full_v + 8 * st, C::kTileBytes);
        for (int h = 0; h < NH; ++h)
          tma_load_3d(v_tile + h * kN * 128, &maps.v, full_v + 8 * st,
                      h * 64, kb * kN, bh);
      }
    }
    return;
  }

  // consumer warpgroup: q rows q0 .. q0 + 63
  reg_alloc<232>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
  const int row0 = q0 + warp * 16 + g;    // and row0 + 8

  const size_t rbase = (size_t)bh * Sq;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kMask, kMask};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
  // the running o, read once: at D = 64 its loads are in flight under the
  // mainloop (D = 128 has no registers to spare for it there)
  float2 old[2][D / 8];
  float lo[2];
  load_lse_rows(lo, sl, row0, t, Sq, rbase, first);
  if constexpr (D == 64)
    load_o_rows<D, 2>(old, sl, 0, row0, t, Sq, rbase, first);

  if (kb_end > 0) {
    float s[kN / 2];
    uint32_t pa[kN / 16][4];  // p of the previous tile, the PV A operand
    float alpha[2];
    mbar_wait(full_q, 0);

    // s = q k^T for the tile in stage st: 64 rows x 128 keys, one group
    auto issue_scores = [&](int st) {
      const uint32_t k_tile = sK + st * C::kTileBytes;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, kN, 0, 0>(
            s, desc_kmajor(sQ + (kk >> 2) * kM * 128 + (kk & 3) * 32),
            desc_kmajor(k_tile + (kk >> 2) * kN * 128 + (kk & 3) * 32));
      wgmma_commit();
    };
    // acc += p v for the tile in stage st: p from registers, v MN-major
    auto issue_pv = [&](int st) {
      const uint32_t v_tile = sV + st * C::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<T, D, 1>(acc, pa[kk],
                       desc_mnmajor(v_tile + kk * 2048, kN * 128));
      wgmma_commit();
    };
    auto softmax = [&](int it) {
      const int k0 = (kb_end - 1 - it) * kN;
      ring_softmax<kN>(s, m_run, l_run, alpha, s2scale, k0, Sk, row0, diag,
                       causal,
                       tile_needs_mask(q0, kM, Sq, k0, kN, Sk, sl.q_off,
                                       sl.k_off, causal),
                       t);
    };

    mbar_wait(full_k, 0);
    issue_scores(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) hopper::pack_a<T>(pa[kk], s, kk);

    // steady state: tile it's scores and softmax run while the previous
    // tile's PV product is in flight
    for (int it = 1; it < kb_end; ++it) {
      const int st = it % ST, pst = (it - 1) % ST;
      mbar_wait(full_k + 8 * st, (it / ST) & 1);
      issue_scores(st);
      mbar_wait(full_v + 8 * pst, ((it - 1) / ST) & 1);
      issue_pv(pst);
      wgmma_wait<1>();  // the scores are in
      fence_regs(s);
      softmax(it);
      wgmma_wait<0>();  // the previous PV product is in
      fence_regs(acc);
      if (tid == 0) mbar_arrive(empty + 8 * pst);  // the stage is consumed
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) hopper::pack_a<T>(pa[kk], s, kk);
    }
    {
      const int it = kb_end - 1, st = it % ST;
      mbar_wait(full_v + 8 * st, (it / ST) & 1);
      wgmma_fence();
      issue_pv(st);
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(empty + 8 * st);
    }
  }

  // merged for every row, also when the hop saw nothing
  float lse_hop[2], inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lse_hop[h] = l > 0.f ? m_run[h] * kLn2 + logf(l) : kMask;
    inv_l[h] = l > 0.f ? 1.f / l : 0.f;
  }
  if constexpr (D != 64)
    load_o_rows<D, 2>(old, sl, 0, row0, t, Sq, rbase, first);
  RowMerge m[2];
  row_merges(m, lo, lse_hop, inv_l, lane, first, last);
  merge_rows<D, 2, T>(acc, old, m, 0, row0, t, Sq, rbase, sl, last);
}

template <int D>
struct WgDkvCfg {
  static constexpr int kN = 128;        // keys per CTA: 64 per consumer
  static constexpr int kM = 64;         // q rows per streamed block
  static constexpr int kStages = 2;     // q blocks in flight
  static constexpr int kThreads = 384;  // consumer, consumer, producer
  static constexpr int kKVBytes = kN * D * 2;  // the K (or V) tile
  static constexpr int kQBytes = kM * D * 2;   // one Q (or dO) tile
  static constexpr int kOffV = kKVBytes;
  static constexpr int kOffQ = 2 * kKVBytes;
  static constexpr int kOffDO = kOffQ + kStages * kQBytes;
  static constexpr int kOffL = kOffDO + kStages * kQBytes;   // lse * log2(e)
  static constexpr int kOffDl = kOffL + kStages * kM * 4;    // delta
  static constexpr int kOffBar = kOffDl + kStages * kM * 4;
  static constexpr int kSmem = kOffBar + 64 + 1024;  // +1024 aligns the base
};

template <typename T, int D>
__global__ void __launch_bounds__(384, 1)
ring_dkv_wgmma_kernel(const __grid_constant__ DkvWgParams prm, int Sq,
                      int Sk, int causal, int first, float scale) {
  using namespace hopper;
  using C = WgDkvCfg<D>;
  constexpr int kN = C::kN, kM = C::kM, ST = C::kStages, NH = D / 64;
  const int bh = blockIdx.x;
  const DkvSlot& sl = prm.s[blockIdx.z];
  const DkvMaps& maps = prm.maps[blockIdx.z];
  const int k0 = blockIdx.y * kN;
  const int n_qb = (Sq + kM - 1) / kM;
  // q blocks before this one see none of the keys
  const int qb_begin = first_q_tile(k0, kM, n_qb, sl.q_off, sl.k_off, causal);
  const int n_it = n_qb - qb_begin;
  // a hop that sees none of these keys adds nothing
  if (!first && n_it == 0) return;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (sb - raw);  // the same bytes, generic
  const uint32_t sK = sb, sV = sb + C::kOffV;
  const uint32_t sQ = sb + C::kOffQ, sDO = sb + C::kOffDO;  // + st * kQBytes
  float* sL = reinterpret_cast<float*>(base + C::kOffL);    // [st][kM]
  float* sDl = reinterpret_cast<float*>(base + C::kOffDl);
  // barriers: K/V full, then per stage q-block full and empty
  const uint32_t full_kv = sb + C::kOffBar;
  const uint32_t full = full_kv + 8, empty = full + 8 * ST;

  const size_t rbase = (size_t)bh * Sq;
  const long long diag = (long long)sl.q_off - sl.k_off;
  const float s2scale = scale * kLog2e;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full + 8 * st, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * st, 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer warp: K and V once, then Q, dO, lse and delta per q block
    reg_dealloc<40>();
    if (threadIdx.x < 288 && n_it > 0) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(full_kv, 2 * C::kKVBytes);
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(sK + h * kN * 128, &maps.k, full_kv, h * 64, k0, bh);
          tma_load_3d(sV + h * kN * 128, &maps.v, full_kv, h * 64, k0, bh);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int q0 = (qb_begin + it) * kM, st = it % ST;
        mbar_wait(empty + 8 * st, ((it / ST) & 1) ^ 1);
        for (int r = lane; r < kM; r += 32) {
          const bool ok = q0 + r < Sq;
          sL[st * kM + r] = ok ? sl.lse[rbase + q0 + r] * kLog2e : 0.f;
          sDl[st * kM + r] = ok ? sl.delta[rbase + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full + 8 * st, 2 * C::kQBytes);
          for (int h = 0; h < NH; ++h) {
            tma_load_3d(sQ + st * C::kQBytes + h * kM * 128, &maps.q,
                        full + 8 * st, h * 64, q0, bh);
            tma_load_3d(sDO + st * C::kQBytes + h * kM * 128, &maps.dout,
                        full + 8 * st, h * 64, q0, bh);
          }
        } else {
          mbar_arrive(full + 8 * st);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: keys k0 + 64 wg .. + 63
  reg_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
  const int key0 = k0 + wg * 64 + warp * 16 + g;  // and key0 + 8
  const uint32_t k_rows = sK + wg * 64 * 128, v_rows = sV + wg * 64 * 128;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  if (n_it > 0) mbar_wait(full_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qb_begin + it) * kM, st = it % ST;
    const uint32_t q_tile = sQ + st * C::kQBytes;
    const uint32_t do_tile = sDO + st * C::kQBytes;
    mbar_wait(full + 8 * st, (it / ST) & 1);

    // s^T = k q^T and dp^T = v dO^T: 64 keys x 64 q rows
    float s[kM / 2], dp[kM / 2];
#pragma unroll
    for (int i = 0; i < kM / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk >> 2) * kN * 128 + (kk & 3) * 32;
      const uint32_t b_off = (kk >> 2) * kM * 128 + (kk & 3) * 32;
      wgmma_ss<T, kM, 0, 0>(s, desc_kmajor(k_rows + a_off),
                         desc_kmajor(q_tile + b_off));
      wgmma_ss<T, kM, 0, 0>(dp, desc_kmajor(v_rows + a_off),
                         desc_kmajor(do_tile + b_off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p^T and ds^T; hidden pairs (keys or q rows past the ends, with
    // `causal` keys after the row in global order) get p = 0 exactly
    const float* L = sL + st * kM;
    const float* Dl = sDl + st * kM;
    const bool need_mask =
        tile_needs_mask(q0, kM, Sq, k0, kN, Sk, sl.q_off, sl.k_off, causal);
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(Dl + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int qrow = q0 + 8 * j + 2 * t + e;
          float p = exp2f(s[i] * s2scale - (e ? l2.y : l2.x));
          if (need_mask) {
            const int key = key0 + 8 * h;
            if (key >= Sk || qrow >= Sq ||
                (causal && (long long)key > qrow + diag))
              p = 0.f;
          }
          s[i] = p;
          dp[i] = p * (dp[i] - (e ? d2.y : d2.x));
        }
    }

    // dv += p^T dO and dk += ds^T q: A from registers, B MN-major
    uint32_t pa[kM / 16][4], da[kM / 16][4];
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk) {
      hopper::pack_a<T>(pa[kk], s, kk);
      hopper::pack_a<T>(da[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk) {
      wgmma_rs<T, D, 1>(acc_dv, pa[kk],
                     desc_mnmajor(do_tile + kk * 2048, kM * 128));
      wgmma_rs<T, D, 1>(acc_dk, da[kk],
                     desc_mnmajor(q_tile + kk * 2048, kM * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    if (tid == 0) mbar_arrive(empty + 8 * st);  // Q, dO consumed
  }

  // stored under `first`, else added into the rotating accumulators
  add_dkv_fragment<D, 2>(sl, acc_dk, acc_dv, key0, Sk, (size_t)bh * Sk, D,
                         2 * t, scale, first);
}

// the dq step: csrc/dq_wgmma.cuh's template over the slots of a ring step,
// adding into each slot's f32 accumulator
template <typename T, int D>
__global__ void __launch_bounds__(dq_wgmma::Cfg<D>::kThreads,
                                  dq_wgmma::Cfg<D>::kMinBlocks)
ring_dq_wgmma_kernel(const __grid_constant__ DqWgParams prm, int Sq, int Sk,
                     int causal, float scale) {
  dq_wgmma::run<T, D, true>(prm.maps[blockIdx.z], prm.s[blockIdx.z], Sq, Sk,
                         causal, scale);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct StepArgs {  // what the slots of a ring step share
  int n, bh, Sq, Sk, causal, first, last;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// bf16 / fp16 (T): the wgmma kernel, or the mma.sync one at D = 256
template <typename T, int D>
cudaError_t launch_fwd_step_16(const FwdTable& tab, const StepArgs& a) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (D != 256) {
    using C = WgFwdCfg<D>;
    FwdWgParams prm;
    for (int i = 0; i < a.n; ++i) {
      const FwdSlot& sl = tab.s[i];
      if (encode_bhsd_map<T>(&prm.maps[i].q, sl.q, a.bh, a.Sq, D, C::kM) ||
          encode_bhsd_map<T>(&prm.maps[i].k, sl.k, a.bh, a.Sk, D, C::kN) ||
          encode_bhsd_map<T>(&prm.maps[i].v, sl.v, a.bh, a.Sk, D, C::kN))
        return cudaErrorInvalidValue;
      prm.s[i] = sl;
    }
    auto kernel = ring_fwd_wgmma_kernel<T, D>;
    cudaError_t err = prepare(kernel, C::kSmem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.bh, (a.Sq + C::kM - 1) / C::kM, a.n);
    kernel<<<grid, C::kThreads, C::kSmem, a.stream>>>(
        prm, a.Sq, a.Sk, a.causal, a.first, a.last, kLog2e * scale);
  } else {
    const int smem = fwd_mma_smem_bytes<D>();
    auto kernel = ring_fwd_mma_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + kB - 1) / kB, a.bh, a.n);
    kernel<<<grid, kFwdThreads, smem, a.stream>>>(
        tab, a.Sq, a.Sk, a.causal, a.first, a.last, scale);
  }
  return cudaGetLastError();
}

// dtype: 0 fp32, 1 bf16, 2 fp16
template <int D>
cudaError_t launch_fwd_step(const FwdTable& tab, const StepArgs& a,
                            int dtype) {
  if (dtype == 1) return launch_fwd_step_16<__nv_bfloat16, D>(tab, a);
  if (dtype == 2) return launch_fwd_step_16<__half, D>(tab, a);
  if (dtype != 0) return cudaErrorInvalidValue;
  const int smem = fwd_f32_smem_bytes<D>();
  auto kernel = ring_fwd_f32_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kFB - 1) / kFB, a.bh, a.n);
  kernel<<<grid, kFThreads, smem, a.stream>>>(tab, a.Sq, a.Sk, a.causal,
                                              a.first, a.last,
                                              1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_step_16(const DkvTable& tab, const StepArgs& a) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (D != 256) {
    using C = WgDkvCfg<D>;
    DkvWgParams prm;
    for (int i = 0; i < a.n; ++i) {
      const DkvSlot& sl = tab.s[i];
      if (encode_bhsd_map<T>(&prm.maps[i].q, sl.q, a.bh, a.Sq, D, C::kM) ||
          encode_bhsd_map<T>(&prm.maps[i].k, sl.k, a.bh, a.Sk, D, C::kN) ||
          encode_bhsd_map<T>(&prm.maps[i].v, sl.v, a.bh, a.Sk, D, C::kN) ||
          encode_bhsd_map<T>(&prm.maps[i].dout, sl.dout, a.bh, a.Sq, D,
                             C::kM))
        return cudaErrorInvalidValue;
      prm.s[i] = sl;
    }
    auto kernel = ring_dkv_wgmma_kernel<T, D>;
    cudaError_t err = prepare(kernel, C::kSmem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.bh, (a.Sk + C::kN - 1) / C::kN, a.n);
    kernel<<<grid, C::kThreads, C::kSmem, a.stream>>>(
        prm, a.Sq, a.Sk, a.causal, a.first, scale);
  } else {
    const int smem = bwd_mma_smem_bytes<D>();
    auto kernel = ring_dkv_mma_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sk + kB - 1) / kB, a.bh, a.n);
    kernel<<<grid, MmaCfg<D>::kThreads, smem, a.stream>>>(
        tab, a.Sq, a.Sk, a.causal, a.first, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_step(const DkvTable& tab, const StepArgs& a,
                            int dtype) {
  if (dtype == 1) return launch_dkv_step_16<__nv_bfloat16, D>(tab, a);
  if (dtype == 2) return launch_dkv_step_16<__half, D>(tab, a);
  if (dtype != 0) return cudaErrorInvalidValue;
  const int smem = dkv_f32_smem_bytes<D>();
  auto kernel = ring_dkv_f32_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + kFB - 1) / kFB, a.bh, a.n);
  kernel<<<grid, kFThreads, smem, a.stream>>>(tab, a.Sq, a.Sk, a.causal,
                                              a.first,
                                              1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_step_16(const DqTable& tab, const StepArgs& a) {
  if constexpr (D != 256) {
    DqWgParams prm;
    for (int i = 0; i < a.n; ++i) {
      const DqSlot& sl = tab.s[i];
      if (dq_wgmma::encode_maps<T, D>(&prm.maps[i], sl.q, sl.k, sl.v,
                                      sl.dout, a.bh, a.Sq, a.Sk))
        return cudaErrorInvalidValue;
      prm.s[i] = dq_wgmma::Slot{sl.lse, sl.delta, sl.dq, sl.q_off, sl.k_off};
    }
    return dq_wgmma::launch<D>(ring_dq_wgmma_kernel<T, D>, prm, a.n, a.bh,
                               a.Sq, a.Sk, a.causal, a.stream);
  } else {
    const int smem = bwd_mma_smem_bytes<D>();
    auto kernel = ring_dq_mma_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + kB - 1) / kB, a.bh, a.n);
    kernel<<<grid, MmaCfg<D>::kThreads, smem, a.stream>>>(
        tab, a.Sq, a.Sk, a.causal, 1.0f / sqrtf((float)D));
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_dq_step(const DqTable& tab, const StepArgs& a,
                           int dtype) {
  if (dtype == 1) return launch_dq_step_16<__nv_bfloat16, D>(tab, a);
  if (dtype == 2) return launch_dq_step_16<__half, D>(tab, a);
  if (dtype != 0) return cudaErrorInvalidValue;
  const int smem = dq_f32_smem_bytes<D>();
  auto kernel = ring_dq_f32_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kFB - 1) / kFB, a.bh, a.n);
  kernel<<<grid, kFThreads, smem, a.stream>>>(tab, a.Sq, a.Sk, a.causal,
                                              1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

bool bad_shape(int n, int bh, int Sq, int Sk) {
  return n < 1 || n > kMaxSlots || bh < 1 || bh > 65535 || Sq < 1 || Sk < 1;
}

}  // namespace

// q, dout: [bh, Sq, D]; k, v: [bh, Sk, D]; contiguous, 16-byte aligned, one
// dtype (dtype: 0 fp32, 1 bf16, 2 fp16). lse, delta: [bh, Sq] f32.
// q_off, k_off: global positions of the first q row and the first key.
// Each entry launches on `stream` and returns a cudaError_t.

// A ring step's forward over n <= kMaxSlots slots: ptrs holds, per slot,
// q, k, v, o (f32 [bh, Sq, D], unused when first and last), lse (f32
// [bh, Sq]), out ([bh, Sq, D] in the input dtype, written when last);
// offs holds q_off, k_off per slot.
extern "C" int ring_fwd_step(const void* const* ptrs, const int* offs, int n,
                             int bh, int Sq, int Sk, int D, int dtype,
                             int causal, int first, int last, void* stream) {
  if (bad_shape(n, bh, Sq, Sk)) return (int)cudaErrorInvalidValue;
  FwdTable tab{};
  for (int i = 0; i < n; ++i) {
    const void* const* p = ptrs + 6 * i;
    tab.s[i] = FwdSlot{p[0], p[1], p[2],
                       static_cast<float*>(const_cast<void*>(p[3])),
                       static_cast<float*>(const_cast<void*>(p[4])),
                       const_cast<void*>(p[5]), offs[2 * i], offs[2 * i + 1]};
  }
  const StepArgs a{n, bh, Sq, Sk, causal, first, last,
                   static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64:
      return (int)launch_fwd_step<64>(tab, a, dtype);
    case 128:
      return (int)launch_fwd_step<128>(tab, a, dtype);
    case 256:
      return (int)launch_fwd_step<256>(tab, a, dtype);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// A ring step's dk/dv over n <= kMaxSlots slots: ptrs holds, per slot, q,
// k, v, dout, lse, delta, dk, dv (f32 [bh, Sk, D], stored when first, else
// added to); offs holds q_off, k_off per slot.
extern "C" int ring_dkv_step(const void* const* ptrs, const int* offs, int n,
                             int bh, int Sq, int Sk, int D, int dtype,
                             int causal, int first, void* stream) {
  if (bad_shape(n, bh, Sq, Sk)) return (int)cudaErrorInvalidValue;
  DkvTable tab{};
  for (int i = 0; i < n; ++i) {
    const void* const* p = ptrs + 8 * i;
    tab.s[i] = DkvSlot{p[0], p[1], p[2], p[3],
                       static_cast<const float*>(p[4]),
                       static_cast<const float*>(p[5]),
                       static_cast<float*>(const_cast<void*>(p[6])),
                       static_cast<float*>(const_cast<void*>(p[7])),
                       offs[2 * i], offs[2 * i + 1]};
  }
  const StepArgs a{n, bh, Sq, Sk, causal, first, 0,
                   static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64:
      return (int)launch_dkv_step<64>(tab, a, dtype);
    case 128:
      return (int)launch_dkv_step<128>(tab, a, dtype);
    case 256:
      return (int)launch_dkv_step<256>(tab, a, dtype);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// A ring step's dq over n <= kMaxSlots slots: ptrs holds, per slot, q, k,
// v, dout, lse, delta, dq (the f32 accumulator [bh, Sq, D], added to);
// offs holds q_off, k_off per slot.
extern "C" int ring_dq_step(const void* const* ptrs, const int* offs, int n,
                            int bh, int Sq, int Sk, int D, int dtype,
                            int causal, void* stream) {
  if (bad_shape(n, bh, Sq, Sk)) return (int)cudaErrorInvalidValue;
  DqTable tab{};
  for (int i = 0; i < n; ++i) {
    const void* const* p = ptrs + 7 * i;
    tab.s[i] = DqSlot{p[0], p[1], p[2], p[3],
                      static_cast<const float*>(p[4]),
                      static_cast<const float*>(p[5]),
                      static_cast<float*>(const_cast<void*>(p[6])),
                      offs[2 * i], offs[2 * i + 1]};
  }
  const StepArgs a{n, bh, Sq, Sk, causal, 0, 0,
                   static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64:
      return (int)launch_dq_step<64>(tab, a, dtype);
    case 128:
      return (int)launch_dq_step<128>(tab, a, dtype);
    case 256:
      return (int)launch_dq_step<256>(tab, a, dtype);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
