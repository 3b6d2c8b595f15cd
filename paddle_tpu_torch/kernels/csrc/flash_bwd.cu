// Flash-attention backward for Hopper (sm_90a): three attention entry
// points over one tile function, and the two passes around them.
//
// Replaces, in paddle_tpu/kernels/flash_attention.py:
//   flash_bwd_fused -> _fa_bwd_fused_kernel (:732, via _flash_bwd_fused_bhsd)
//   flash_bwd_dq    -> _fa_bwd_dq_kernel    (:239, via _flash_bwd_bhsd)
//   flash_bwd_dkv   -> _fa_bwd_dkv_kernel   (:280, via _flash_bwd_bhsd)
// Same function: from q, k, v, dO [BH, S, D], lse [BH, S] (f32, natural
// log) and delta = rowsum(dO * O) [BH, S] (f32; the reference computes it
// in XLA, `_delta` :209), per (q, k) tile (_bwd_tile_pds, :216):
//   s  = q k^T * scale * log2(e), causal keys past the query masked
//   p  = exp2(s - lse * log2(e))
//   dp = dO v^T
//   ds = p * (dp - delta), rounded to the input dtype before the products
// and dq = ds k * scale, dk = ds^T q * scale, dv = p^T dO (p rounded to the
// input dtype for that product).
//
// Bound on the H100: at the training shape (B=8, H=12, S=1024, D=64, bf16,
// causal) the five products are 10 * D FLOPs per visible (q, k) pair,
// ~32 GFLOP (0.033 ms at 989 TFLOP/s), against ~88 MB of q, k, v, dO read
// and dq, dk, dv written (0.026 ms at 3.35 TB/s): bound by operations, so
// the design keeps the S x S tiles in registers and shared memory and feeds
// the products to the tensor cores.
//
// bf16 and fp16 at D = 64 and 128 (every main path): the dk/dv pass and
// the fused form are one warp-specialised wgmma template
// (flash_bwd_kv_wgmma_kernel, over the element type T of csrc/hopper.cuh's
// Elem<T>, kFused selecting the dq shares), so the two forms' dk and dv are
// bit-equal:
//   * one CTA per (bh, 128-key block), the longest causal q loops first;
//     two consumer warpgroups of 64 keys each and one producer warp:
//     K and V arrive once by TMA; Q and dO tiles of 64-row q blocks (from
//     the first block that sees the keys) stream by TMA through a ring of
//     two stages with full and empty mbarriers, lse * log2(e) and delta
//     copied beside them by the producer's lanes; 3-D tensor maps zero-fill
//     the ragged tail of a head;
//   * s^T = k q^T and dp^T = v dO^T on wgmma m64n64k16, both operands in
//     shared memory (K-major as they lie); p^T and ds^T are formed in the
//     accumulator registers and re-packed to T as the A operands of
//     dv += p^T dO and dk += ds^T q (wgmma from registers, dO and q read
//     MN-major with the transpose flag): no operand is transposed by hand;
//   * fused: the TPU carries dq in VMEM along a sequential grid axis; CTAs
//     on Hopper run in parallel. Each warpgroup writes its ds^T rows to a
//     128-byte-swizzled shared tile (32-bit stores that hit 32 distinct
//     banks), a named barrier joins the two halves, and each warpgroup
//     computes half of dq's columns over all 128 keys (wgmma, ds read
//     MN-major, k MN-major): half the atomic traffic of splitting by keys.
//     Lanes t and t ^ 1 swap rows so that each adds four columns with one
//     float4 atomicAdd into a zeroed f32 [BH, S, D] workspace. The order
//     of those additions varies from run to run: this form is not
//     deterministic. The ds tile is double-buffered, so the warpgroups are
//     at most one q block apart;
//   * the wrapper's passes around it are kernels of this file: flash_bwd_prep
//     (delta and the zeroed workspace in one pass over dO and O) and
//     flash_bwd_dq_cast (dq = workspace * scale in the input dtype).
// The dq pass (flash_bwd_dq) at bf16 / fp16, D = 64 and 128, is the
// template of
// csrc/dq_wgmma.cuh, which ring_attention.cu's dq step shares: one CTA per
// (bh, q tile of 64 rows), the longest causal loops first; Q and dO
// once and K, V tiles of 64 keys streamed by TMA; s = q k^T, dp = dO v^T
// and dq += ds k on wgmma (ds from registers, k MN-major); dq * scale
// stored in T. One CTA per q tile and no atomics: deterministic.
// fp16: ds = p * (dp - delta) is rounded to fp16 before its products, as
// the Pallas kernel rounds it to the input dtype; under a large loss scale
// it, and the dq of the fused form's cast, may overflow 65504 to inf. No
// value is clamped: the Pallas kernel clamps none, and a loss scaler must
// see the inf to skip the step.
// D = 256 and fp32 keep the mma.sync and FMA kernels below:
//   * tiles of 64 q rows x 64 keys (bf16 / fp16, m16n8k16 .bf16 / .f16) or
//     32 x 32 (fp32); the dq pass is
//     one CTA per (bh, 64-row q block), a loop over the key blocks up to
//     the diagonal, dq in f32 registers: deterministic; at D = 256 the
//     dk/dv pass and the fused form are one CTA per (bh, 64-key block)
//     (the fused form adding its dq shares with scalar f32 atomics) with
//     8 warps, two per 16-key group, each accumulating half of the head
//     dimension (a 16 x 256 f32 accumulator per warp does not fit in
//     registers);
//   * the transposed operands are read as two 16-bit values per fragment
//     register; tile rows are padded by 8 elements, so a warp's reads hit
//     distinct banks;
//   * ragged S: rows and keys past S are zero-filled and masked in the
//     kernel, never written.
// fp32 inputs run the same algorithm on plain FMA: TF32 tensor cores keep
// ~3 digits, against a 1e-4 tolerance.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu -lcuda

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dq_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16 / fp16 on mma.sync: the dq and dk/dv passes at D = 256
// ---------------------------------------------------------------------------
constexpr int kB = 64;  // q rows and keys per tile

template <int D>
struct MmaCfg {
  static constexpr int DW = D > 128 ? 128 : D;  // head-dim columns per warp
  static constexpr int kWarps = 4 * (D / DW);   // 4 row groups x D / DW
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int TS = D + 8;   // row stride of the [64][D] tiles
  static constexpr int PS = kB + 8;  // row stride of the [64][64] ds tile
};

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
// score fragments of n-tiles 2kk and 2kk+1), rounded to T
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t a[4], float (*c)[4], int kk) {
  a[0] = Elem<T>::pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = Elem<T>::pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = Elem<T>::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = Elem<T>::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// stage rows [row0, row0 + 64) of a [S, D] matrix into a padded tile;
// rows past S read as zeros
template <int D, int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int S, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int TS = D + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kB * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * TS + c) = val;
  }
}

template <int D>
constexpr int mma_kv_smem_bytes() {
  // K, V, Q, dO tiles [64][D+8], ds tile [64][64+8], lse and delta rows
  return (4 * kB * (D + 8) + kB * (kB + 8)) * 2 + 2 * kB * 4;
}

template <int D>
constexpr int mma_dq_smem_bytes() {
  return 4 * kB * (D + 8) * 2;  // Q, dO, K, V tiles
}

// dk/dv pass; with kFused also the dq shares, added into dq_ws (f32)
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads)
flash_bwd_kv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ dq_ws, int S,
                        int causal, float scale) {
  using C = MmaCfg<D>;
  constexpr int TS = C::TS, PS = C::PS, DW = C::DW, NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kB * TS;
  T* sQ = sV + kB * TS;
  T* sdO = sQ + kB * TS;
  T* sDS = sdO + kB * TS;  // ds as [q][key]
  float* sL = reinterpret_cast<float*>(sDS + kB * PS);  // lse * log2(e)
  float* sDl = sL + kB;                                  // delta

  const int kb = blockIdx.x;  // the longest causal q loops start first
  const int k0 = kb * kB;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int rg = warp & 3;                // row group: 16 keys (or q rows)
  const int d0 = (warp >> 2) * DW;        // this warp's head-dim columns
  const float s2scale = scale * kLog2e;

  load_tile<D, NT>(sK, k + base, k0, S, tid);
  load_tile<D, NT>(sV, v + base, k0, S, tid);

  float acc_dk[DW / 8][4], acc_dv[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  const T* kw = sK + (rg * 16 + g) * TS + 2 * t;
  const T* vw = sV + (rg * 16 + g) * TS + 2 * t;
  const int n_qb = (S + kB - 1) / kB;
  // q blocks before k0 see none of these keys (tiles are square)
  const int qb_begin = causal ? kb : 0;

  for (int qb = qb_begin; qb < n_qb; ++qb) {
    const int q0 = qb * kB;
    __syncthreads();  // the previous q tile is consumed
    load_tile<D, NT>(sQ, q + base, q0, S, tid);
    load_tile<D, NT>(sdO, dout + base, q0, S, tid);
    for (int i = tid; i < kB; i += NT) {
      const bool ok = q0 + i < S;
      sL[i] = ok ? lse[rbase + q0 + i] * kLog2e : 0.f;
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

    // p^T and ds^T; masked: causal keys after the query, keys and q rows
    // past S (their zero rows would give p = exp2(-lse2) otherwise)
    const bool need_mask =
        (causal && q0 < k0 + kB - 1) || q0 + kB > S || k0 + kB > S;
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        float p = exp2f(st[j][e] * s2scale - sL[ql]);
        if (need_mask) {
          const int key = k0 + rg * 16 + g + (e >> 1) * 8;
          const int qrow = q0 + ql;
          if (key >= S || qrow >= S || (causal && key > qrow)) p = 0.f;
        }
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sDl[ql]);
      }

    // dv += p^T dO and dk += ds^T q, over the tile's 64 q rows
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

    if constexpr (kFused) {
      // ds back to [q][key] in shared memory (one copy per key group)
      if (d0 == 0) {
#pragma unroll
        for (int j = 0; j < kB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sDS[(j * 8 + 2 * t + (e & 1)) * PS + rg * 16 + g +
                (e >> 1) * 8] = hopper::Elem<T>::round(dpt[j][e]);
      }
      __syncthreads();
      // this CTA's share of dq = ds k: the warp's 16 q rows x DW columns,
      // added into the f32 workspace
      uint32_t a[kB / 16][4];
      const T* dsw = sDS + (rg * 16 + g) * PS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk) ld_a(a[kk], dsw + kk * 16, PS);
      const int row = q0 + rg * 16 + g;
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kB / 16; ++kk) {
          const T* kp = sK + (kk * 16 + 2 * t) * TS + d0 + n * 8 + g;
          mma_16816<T>(c, a[kk], ld_col2(kp, TS), ld_col2(kp + 8 * TS, TS));
        }
        float* out = dq_ws + base + d0 + n * 8 + 2 * t;
        if (row < S) {
          atomicAdd(out + (size_t)row * D, c[0]);
          atomicAdd(out + (size_t)row * D + 1, c[1]);
        }
        if (row + 8 < S) {
          atomicAdd(out + (size_t)(row + 8) * D, c[2]);
          atomicAdd(out + (size_t)(row + 8) * D + 1, c[3]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + rg * 16 + g + h * 8;
    if (key < S) {
      const size_t off = base + (size_t)key * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + n * 8) = Elem<T>::pack(
            acc_dk[n][2 * h] * scale, acc_dk[n][2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
            Elem<T>::pack(acc_dv[n][2 * h], acc_dv[n][2 * h + 1]);
      }
    }
  }
}

// dq pass of the two-pass form at D = 256: no atomics
template <typename T, int D>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int causal, float scale) {
  using C = MmaCfg<D>;
  constexpr int TS = C::TS, DW = C::DW, NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kB * TS;
  T* sK = sdO + kB * TS;
  T* sV = sK + kB * TS;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qb * kB;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;
  const int d0 = (warp >> 2) * DW;
  const float s2scale = scale * kLog2e;

  load_tile<D, NT>(sQ, q + base, q0, S, tid);
  load_tile<D, NT>(sdO, dout + base, q0, S, tid);
  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = q0 + rg * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row0 + h * 8 < S;
    lse2[h] = ok ? lse[rbase + row0 + h * 8] * kLog2e : 0.f;
    dl[h] = ok ? delta[rbase + row0 + h * 8] : 0.f;
  }

  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const T* qw = sQ + (rg * 16 + g) * TS + 2 * t;
  const T* ow = sdO + (rg * 16 + g) * TS + 2 * t;
  const int n_kb = (S + kB - 1) / kB;
  const int kb_end = causal ? min(n_kb, qb + 1) : n_kb;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the previous K/V tile is consumed (Q, dO staged)
    load_tile<D, NT>(sK, k + base, k0, S, tid);
    load_tile<D, NT>(sV, v + base, k0, S, tid);
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
        (causal && k0 + kB - 1 > q0) || k0 + kB > S || q0 + kB > S;
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(s[j][e] * s2scale - lse2[h]);
        if (need_mask) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = row0 + h * 8;
          if (key >= S || row >= S || (causal && key > row)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[h]);  // ds
      }

    // dq += ds k over the tile's 64 keys
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

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row < S) {
      T* out = dq + base + (size_t)row * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < DW / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + n * 8) =
            Elem<T>::pack(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the same algorithm on plain FMA
// ---------------------------------------------------------------------------
constexpr int kFB = 32;  // q rows and keys per tile
constexpr int kFThreads = 128;  // 4 threads per row

template <int D>
constexpr int f32_kv_smem_bytes() {
  // K, V, Q, dO tiles [32][D+1] (odd stride: conflict-free dot products),
  // p and ds tiles [32][32+1], lse and delta rows
  return (4 * kFB * (D + 1) + 2 * kFB * (kFB + 1) + 2 * kFB) * 4;
}

template <int D>
constexpr int f32_dq_smem_bytes() {
  return (4 * kFB * (D + 1) + kFB * (kFB + 1)) * 4;  // Q, dO, K, V, ds
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int S, int tid) {
  for (int i = tid; i < kFB * D; i += kFThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        row0 + r < S ? src[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

template <int D, bool kFused>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_kv_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dq_ws, int S, int causal,
                        float scale) {
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

  const int kb = blockIdx.x, k0 = kb * kFB;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;  // row r, its 4 neighbouring lanes
  const float s2scale = scale * kLog2e;

  load_tile_f32<D>(sK, k + base, k0, S, tid);
  load_tile_f32<D>(sV, v + base, k0, S, tid);

  // this thread accumulates key k0 + r, head-dim columns sub + 4 i
  float acc_dk[D / 4], acc_dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  const int n_qb = (S + kFB - 1) / kFB;
  const int qb_begin = causal ? kb : 0;
  for (int qb = qb_begin; qb < n_qb; ++qb) {
    const int q0 = qb * kFB;
    __syncthreads();
    load_tile_f32<D>(sQ, q + base, q0, S, tid);
    load_tile_f32<D>(sdO, dout + base, q0, S, tid);
    if (tid < kFB) {
      const bool ok = q0 + tid < S;
      sL[tid] = ok ? lse[rbase + q0 + tid] * kLog2e : 0.f;
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
      float p = exp2f(s * s2scale - sL[r]);
      const int key = k0 + kl;
      if (key >= S || qrow >= S || (causal && key > qrow)) p = 0.f;
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

    if constexpr (kFused) {
      // this CTA's share of dq for row q0 + r, added into the workspace
      if (qrow < S) {
        for (int i = 0; i < D / 4; ++i) {
          const int d = sub + 4 * i;
          float a = 0.f;
#pragma unroll 8
          for (int kl = 0; kl < kFB; ++kl)
            a = fmaf(sDS[r * PS + kl], sK[kl * TS + d], a);
          atomicAdd(dq_ws + base + (size_t)qrow * D + d, a);
        }
      }
    }
  }

  const int key = k0 + r;
  if (key < S) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      dk[base + (size_t)key * D + sub + 4 * i] = acc_dk[i] * scale;
      dv[base + (size_t)key * D + sub + 4 * i] = acc_dv[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int causal,
                        float scale) {
  constexpr int TS = D + 1, PS = kFB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + kFB * TS;
  float* sK = sdO + kFB * TS;
  float* sV = sK + kFB * TS;
  float* sDS = sV + kFB * TS;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * kFB;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int qrow = q0 + r;
  const float s2scale = scale * kLog2e;

  load_tile_f32<D>(sQ, q + base, q0, S, tid);
  load_tile_f32<D>(sdO, dout + base, q0, S, tid);
  const float lse2 = qrow < S ? lse[rbase + qrow] * kLog2e : 0.f;
  const float dl = qrow < S ? delta[rbase + qrow] : 0.f;

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  const int n_kb = (S + kFB - 1) / kFB;
  const int kb_end = causal ? min(n_kb, qb + 1) : n_kb;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kFB;
    __syncthreads();
    load_tile_f32<D>(sK, k + base, k0, S, tid);
    load_tile_f32<D>(sV, v + base, k0, S, tid);
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
      float p = exp2f(s * s2scale - lse2);
      const int key = k0 + kl;
      if (key >= S || qrow >= S || (causal && key > qrow)) p = 0.f;
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

  if (qrow < S) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      dq[base + (size_t)qrow * D + sub + 4 * i] = acc[i] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16, D = 64 and 128: the dk/dv pass (and the fused dq shares) on
// wgmma fed by TMA
// ---------------------------------------------------------------------------
template <int D>
struct WgBwdCfg {
  static constexpr int kN = 128;        // keys per CTA: 64 per consumer
  static constexpr int kM = 64;         // q rows per streamed block
  static constexpr int kStages = 2;     // q blocks in flight
  static constexpr int kThreads = 384;  // consumer, consumer, producer
  static constexpr int kKVBytes = kN * D * 2;  // the K (or V) tile
  static constexpr int kQBytes = kM * D * 2;   // one Q (or dO) tile
  static constexpr int kDSBytes = kN * kM * 2;  // one ds^T tile [key][q]
  static constexpr int kOffV = kKVBytes;
  static constexpr int kOffQ = 2 * kKVBytes;
  static constexpr int kOffDO = kOffQ + kStages * kQBytes;
  static constexpr int kOffDS = kOffDO + kStages * kQBytes;
  static constexpr int kOffL = kOffDS + 2 * kDSBytes;   // lse * log2(e)
  static constexpr int kOffDl = kOffL + kStages * kM * 4;  // delta
  static constexpr int kOffBar = kOffDl + kStages * kM * 4;
  static constexpr int kSmem = kOffBar + 64 + 1024;  // +1024 aligns the base
};

template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(384, 1)
flash_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, float* __restrict__ dq_ws,
                          int S, int causal, float scale) {
  using namespace hopper;
  using C = WgBwdCfg<D>;
  constexpr int kN = C::kN, kM = C::kM, ST = C::kStages, NH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (sb - raw);  // the same bytes, generic
  const uint32_t sK = sb, sV = sb + C::kOffV;
  const uint32_t sQ = sb + C::kOffQ, sDO = sb + C::kOffDO;  // + st * kQBytes
  const uint32_t sDS = sb + C::kOffDS;                      // + buf * kDSBytes
  float* sL = reinterpret_cast<float*>(base + C::kOffL);    // [st][kM]
  float* sDl = reinterpret_cast<float*>(base + C::kOffDl);
  // barriers: K/V full, then per stage q-block full and empty
  const uint32_t full_kv = sb + C::kOffBar;
  const uint32_t full = full_kv + 8, empty = full + 8 * ST;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kN;  // the longest causal q loops start first
  const int n_qb = (S + kM - 1) / kM;
  // q blocks before k0 see none of these keys
  const int qb_begin = causal ? k0 / kM : 0;
  const int n_it = n_qb - qb_begin;
  const size_t rbase = (size_t)bh * S;
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
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(full_kv, 2 * C::kKVBytes);
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(sK + h * kN * 128, &tm_k, full_kv, h * 64, k0, bh);
          tma_load_3d(sV + h * kN * 128, &tm_v, full_kv, h * 64, k0, bh);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int q0 = (qb_begin + it) * kM, st = it % ST;
        mbar_wait(empty + 8 * st, ((it / ST) & 1) ^ 1);
        for (int r = lane; r < kM; r += 32) {
          const bool ok = q0 + r < S;
          sL[st * kM + r] = ok ? lse[rbase + q0 + r] * kLog2e : 0.f;
          sDl[st * kM + r] = ok ? delta[rbase + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full + 8 * st, 2 * C::kQBytes);
          for (int h = 0; h < NH; ++h) {
            tma_load_3d(sQ + st * C::kQBytes + h * kM * 128, &tm_q,
                        full + 8 * st, h * 64, q0, bh);
            tma_load_3d(sDO + st * C::kQBytes + h * kM * 128, &tm_do,
                        full + 8 * st, h * 64, q0, bh);
          }
        } else {
          mbar_arrive(full + 8 * st);
        }
      }
    }
  } else {
    // consumer warpgroup wg: keys k0 + 64 wg .. + 63
    reg_alloc<232>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
    const int key0 = k0 + wg * 64 + warp * 16 + g;  // and key0 + 8
    const int kl0 = wg * 64 + warp * 16 + g;        // the same, in the CTA
    const uint32_t k_rows = sK + wg * 64 * 128, v_rows = sV + wg * 64 * 128;

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    mbar_wait(full_kv, 0);

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

      // p^T and ds^T; masked: causal keys after the query, keys and q rows
      // past S (their zero rows would give p = exp2(-lse2) otherwise)
      const float* L = sL + st * kM;
      const float* Dl = sDl + st * kM;
      const bool need_mask =
          (causal && q0 < k0 + kN - 1) || q0 + kM > S || k0 + kN > S;
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
              if (key >= S || qrow >= S || (causal && key > qrow)) p = 0.f;
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

      if constexpr (kFused) {
        // ds^T to shared memory as [key][q] (128-byte swizzle), then this
        // warpgroup's half of the columns of dq = ds k over all 128 keys
        const uint32_t ds_tile = sDS + (it & 1) * C::kDSBytes;
        unsigned char* ds_ptr = base + C::kOffDS + (it & 1) * C::kDSBytes;
#pragma unroll
        for (int j = 0; j < kM / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kl = kl0 + 8 * h;
            *reinterpret_cast<uint32_t*>(ds_ptr + kl * 128 +
                                         ((j ^ (kl & 7)) << 4) + 4 * t) =
                Elem<T>::pack(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
          }
        fence_proxy_async();
        named_barrier(1, 256);  // both halves of ds^T are written

        float dq[D / 4];
#pragma unroll
        for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
        // B = k[:, this half of D]: at D = 64 32 columns inside the atom,
        // at D = 128 the warpgroup's 64-column box
        const uint32_t k_cols = sK + (D == 64 ? wg * 64 : wg * kN * 128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_ss<T, D / 2, 1, 1>(
              dq, desc_mnmajor(ds_tile + kk * 2048, 8192),
              desc_mnmajor(k_cols + kk * 2048, kN * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(acc_dk);
        fence_regs(acc_dv);
        if (tid == 0) mbar_arrive(empty + 8 * st);  // Q, dO consumed

        // add into the f32 workspace, 4 columns per atomic: lanes t and
        // t ^ 1 swap the rows they do not keep
        const int c0 = wg * (D / 2);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          const bool odd = t & 1;
          const float sx = odd ? dq[4 * n] : dq[4 * n + 2];
          const float sy = odd ? dq[4 * n + 1] : dq[4 * n + 3];
          const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
          const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
          const int row = q0 + warp * 16 + g + (odd ? 8 : 0);
          const int col = c0 + 8 * n + 2 * t - (odd ? 2 : 0);
          const float4 val =
              odd ? make_float4(rx, ry, dq[4 * n + 2], dq[4 * n + 3])
                  : make_float4(dq[4 * n], dq[4 * n + 1], rx, ry);
          if (row < S)
            atomicAdd(reinterpret_cast<float4*>(
                          dq_ws + (rbase + row) * D + col), val);
        }
      } else {
        wgmma_wait<0>();
        fence_regs(acc_dk);
        fence_regs(acc_dv);
        if (tid == 0) mbar_arrive(empty + 8 * st);  // Q, dO consumed
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key < S) {
        const size_t off = (rbase + key) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
              Elem<T>::pack(acc_dk[4 * n + 2 * h] * scale,
                       acc_dk[4 * n + 2 * h + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
              Elem<T>::pack(acc_dv[4 * n + 2 * h], acc_dv[4 * n + 2 * h + 1]);
        }
      }
    }
  }
}

template <typename T, int D, bool kFused>
cudaError_t launch_kv_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, void* dq_ws,
                            int bh, int S, int causal, cudaStream_t stream) {
  using C = WgBwdCfg<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (encode_bhsd_map<T>(&tm_q, q, bh, S, D, C::kM) ||
      encode_bhsd_map<T>(&tm_k, k, bh, S, D, C::kN) ||
      encode_bhsd_map<T>(&tm_v, v, bh, S, D, C::kN) ||
      encode_bhsd_map<T>(&tm_do, dout, bh, S, D, C::kM))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_kv_wgmma_kernel<T, D, kFused>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (S + C::kN - 1) / C::kN);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dq_ws), S, causal,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// the dq pass at bf16 / fp16, D = 64 and 128: csrc/dq_wgmma.cuh's
// template, dq stored in T
template <typename T, int D>
__global__ void __launch_bounds__(dq_wgmma::Cfg<D>::kThreads,
                                  dq_wgmma::Cfg<D>::kMinBlocks)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ dq_wgmma::Params<1> prm,
                          int Sq, int Sk, int causal, float scale) {
  dq_wgmma::run<T, D, false>(prm.maps[0], prm.s[0], Sq, Sk, causal, scale);
}

template <typename T, int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int S,
                            int causal, cudaStream_t stream) {
  dq_wgmma::Params<1> prm;
  if (dq_wgmma::encode_maps<T, D>(&prm.maps[0], q, k, v, dout, bh, S, S))
    return cudaErrorInvalidValue;
  prm.s[0] = dq_wgmma::Slot{static_cast<const float*>(lse),
                            static_cast<const float*>(delta), dq, 0, 0};
  return dq_wgmma::launch<D>(flash_bwd_dq_wgmma_kernel<T, D>, prm, 1, bh, S,
                             S, causal, stream);
}

// ---------------------------------------------------------------------------
// the passes around the backward kernels
// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in f32 (the reference computes it in XLA: _delta
// :209), and, for the fused form, the zeroed dq workspace, in one pass:
// one group of lanes per row, 16 bytes per lane and load
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                      float* __restrict__ delta, float* __restrict__ dq_ws,
                      int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // 16-byte chunks per row
  constexpr int kLanes = kChunks < 32 ? kChunks : 32;
  const int lane = threadIdx.x % kLanes;
  const int row = (blockIdx.x * 256 + threadIdx.x) / kLanes;
  float acc = 0.f;
  if (row < rows) {
    const size_t base = (size_t)row * D;
#pragma unroll
    for (int c = lane; c < kChunks; c += kLanes) {
      const uint4 a = *reinterpret_cast<const uint4*>(dout + base + c * kVec);
      const uint4 b = *reinterpret_cast<const uint4*>(o + base + c * kVec);
      const T* x = reinterpret_cast<const T*>(&a);
      const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc = fmaf(static_cast<float>(x[e]), static_cast<float>(y[e]), acc);
    }
    if (dq_ws != nullptr) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = lane; c < D / 4; c += kLanes)
        reinterpret_cast<float4*>(dq_ws + base)[c] = zero;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) delta[row] = acc;
}

// dq = workspace * scale in the input dtype, four elements per thread
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dq_cast_kernel(const float* __restrict__ dq_ws, T* __restrict__ dq,
                         size_t n4, float scale) {
  for (size_t i = blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * 256) {
    const float4 x = reinterpret_cast<const float4*>(dq_ws)[i];
    dq[4 * i] = static_cast<T>(x.x * scale);
    dq[4 * i + 1] = static_cast<T>(x.y * scale);
    dq[4 * i + 2] = static_cast<T>(x.z * scale);
    dq[4 * i + 3] = static_cast<T>(x.w * scale);
  }
}

template <typename T, int D>
cudaError_t launch_prep(const void* dout, const void* o, void* delta,
                        void* dq_ws, int rows, cudaStream_t stream) {
  constexpr int kChunks = D * (int)sizeof(T) / 16;
  constexpr int kLanes = kChunks < 32 ? kChunks : 32;
  const int blocks = (int)(((size_t)rows * kLanes + 255) / 256);
  flash_bwd_prep_kernel<T, D><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o),
      static_cast<float*>(delta), static_cast<float*>(dq_ws), rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;  // dq: the f32 workspace for the fused form
  int bh, S;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// bf16 / fp16 (T): the wgmma kernels, or the mma.sync ones at D = 256
template <typename T, int D, bool kFused>
cudaError_t launch_kv_16(const Args& a, int causal) {
  if constexpr (D != 256) {
    return launch_kv_wgmma<T, D, kFused>(a.q, a.k, a.v, a.dout, a.lse,
                                         a.delta, a.dk, a.dv, a.dq, a.bh, a.S,
                                         causal, a.stream);
  } else {
    const int smem = mma_kv_smem_bytes<D>();
    auto kernel = flash_bwd_kv_mma_kernel<T, D, kFused>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.S + kB - 1) / kB, a.bh);
    kernel<<<grid, MmaCfg<D>::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        static_cast<float*>(a.dq), a.S, causal, 1.0f / sqrtf((float)D));
    return cudaGetLastError();
  }
}

// dtype: 0 fp32, 1 bf16, 2 fp16
template <int D, bool kFused>
cudaError_t launch_kv(const Args& a, int dtype, int causal) {
  if (dtype == 1) return launch_kv_16<__nv_bfloat16, D, kFused>(a, causal);
  if (dtype == 2) return launch_kv_16<__half, D, kFused>(a, causal);
  if (dtype != 0) return cudaErrorInvalidValue;
  const int smem = f32_kv_smem_bytes<D>();
  auto kernel = flash_bwd_kv_f32_kernel<D, kFused>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kFB - 1) / kFB, a.bh);
  kernel<<<grid, kFThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      static_cast<float*>(a.dq), a.S, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_16(const Args& a, int causal) {
  if constexpr (D != 256) {
    return launch_dq_wgmma<T, D>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq,
                                 a.bh, a.S, causal, a.stream);
  } else {
    const int smem = mma_dq_smem_bytes<D>();
    auto kernel = flash_bwd_dq_mma_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.S + kB - 1) / kB, a.bh);
    kernel<<<grid, MmaCfg<D>::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dq), a.S, causal, 1.0f / sqrtf((float)D));
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_dq(const Args& a, int dtype, int causal) {
  if (dtype == 1) return launch_dq_16<__nv_bfloat16, D>(a, causal);
  if (dtype == 2) return launch_dq_16<__half, D>(a, causal);
  if (dtype != 0) return cudaErrorInvalidValue;
  const int smem = f32_dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_f32_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kFB - 1) / kFB, a.bh);
  kernel<<<grid, kFThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.S, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

enum Kind { kKindFused, kKindDkv, kKindDq };

int dispatch(Kind kind, const Args& a, int D, int dtype, int causal) {
  if (a.bh < 1 || a.bh > 65535 || a.S < 1) return (int)cudaErrorInvalidValue;
#define PT_BWD_CASE(DIM)                                                    \
  case DIM:                                                                 \
    if (kind == kKindFused) return (int)launch_kv<DIM, true>(a, dtype, causal); \
    if (kind == kKindDkv) return (int)launch_kv<DIM, false>(a, dtype, causal); \
    return (int)launch_dq<DIM>(a, dtype, causal);
  switch (D) {
    PT_BWD_CASE(64)
    PT_BWD_CASE(128)
    PT_BWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PT_BWD_CASE
}

// the passes around the kernels, by element type: 0 fp32, 1 bf16, 2 fp16
template <int D>
cudaError_t launch_prep_of(int dtype, const void* dout, const void* o,
                           void* delta, void* dq_ws, int rows,
                           cudaStream_t stream) {
  if (dtype == 1)
    return launch_prep<__nv_bfloat16, D>(dout, o, delta, dq_ws, rows, stream);
  if (dtype == 2)
    return launch_prep<__half, D>(dout, o, delta, dq_ws, rows, stream);
  if (dtype == 0)
    return launch_prep<float, D>(dout, o, delta, dq_ws, rows, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dq_cast(const void* dq_ws, void* dq, size_t n4, float scale,
                           cudaStream_t stream) {
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  flash_bwd_dq_cast_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dq_ws), static_cast<T*>(dq), n4, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: [bh, S, D] contiguous and 16-byte aligned, one dtype
// (dtype: 0 fp32, 1 bf16, 2 fp16); lse, delta: [bh, S] f32. Each entry
// launches on `stream` and returns a cudaError_t.

// dq_ws: [bh, S, D] f32, zeroed by the caller, receives dq / scale (f32);
// dk, dv in the input dtype.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq_ws, void* dk,
                               void* dv, int bh, int S, int D, int dtype,
                               int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq_ws, dk, dv, bh, S,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kKindFused, a, D, dtype, causal);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int S, int D, int dtype, int causal,
                             void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, S,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kKindDkv, a, D, dtype, causal);
}

// dq in the input dtype
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int S, int D,
                            int dtype, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, S,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kKindDq, a, D, dtype, causal);
}

// delta: [bh, S] f32 <- rowsum(dout * o); dq_ws: [bh, S, D] f32 set to zero
// when not null (the fused form's workspace).
extern "C" int flash_bwd_prep(const void* dout, const void* o, void* delta,
                              void* dq_ws, int bh, int S, int D, int dtype,
                              void* stream) {
  if (bh < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = bh * S;
  switch (D) {
    case 64:
      return (int)launch_prep_of<64>(dtype, dout, o, delta, dq_ws, rows, st);
    case 128:
      return (int)launch_prep_of<128>(dtype, dout, o, delta, dq_ws, rows, st);
    case 256:
      return (int)launch_prep_of<256>(dtype, dout, o, delta, dq_ws, rows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dq [bh, S, D] in the input dtype <- dq_ws * (1 / sqrt(D)), the fused
// form's workspace scaled and cast (fp16: a value past 65504 becomes inf,
// as the cast of the Pallas kernel's f32 scratch does).
extern "C" int flash_bwd_dq_cast(const void* dq_ws, void* dq, int bh, int S,
                                 int D, int dtype, void* stream) {
  if (bh < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n4 = (size_t)bh * S * D / 4;
  const float scale = 1.0f / sqrtf((float)D);
  if (dtype == 1)
    return (int)launch_dq_cast<__nv_bfloat16>(dq_ws, dq, n4, scale, st);
  if (dtype == 2) return (int)launch_dq_cast<__half>(dq_ws, dq, n4, scale, st);
  if (dtype == 0) return (int)launch_dq_cast<float>(dq_ws, dq, n4, scale, st);
  return (int)cudaErrorInvalidValue;
}
