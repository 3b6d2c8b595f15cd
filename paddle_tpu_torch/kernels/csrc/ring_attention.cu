// Ring-attention block kernels for Hopper (sm_90a): one ring hop's forward,
// dq and dk/dv.
//
// Replaces, in paddle_tpu/kernels/flash_attention.py:
//   ring_fwd -> _fa_ring_fwd_kernel (:506, via ring_block_fwd :644)
//   ring_dq  -> _fa_ring_dq_kernel  (:551, via ring_block_dq  :668)
//   ring_dkv -> _fa_ring_dkv_kernel (:592, via ring_block_dkv :693)
// Same functions. A ring hop attends the local q [BH, Sq, D] against the
// held k/v block [BH, Sk, D]; (q_off, k_off) are the global positions of
// their first rows. A key is visible to a q row (causal) when
// k_off + key <= q_off + row. scale = 1/sqrt(D), natural exp:
//   ring_fwd: out [BH, Sq, D] in q's dtype and lse [BH, Sq] f32 = m + log l
//             (online softmax); a row that sees no key of the block gives
//             out = 0 and lse = -1e30, so the caller's lse merge gives it
//             zero weight;
//   ring_dq:  dq [BH, Sq, D] f32 = scale * sum_keys ds k, with
//             p = exp(s - lse), ds = p * (dO v^T - delta), lse and delta
//             the caller's (global) rows;
//   ring_dkv: dk [BH, Sk, D] f32 = scale * ds^T q and dv f32 = p^T dO.
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
// and still writes its outputs (0, and -1e30 for lse). Ragged Sq and Sk are
// masked in the kernels: rows and keys past the end are zero-filled on the
// way in and never written.
//
// Bound on the H100: at the ERNIE-base path shape (BH = 96, Sq = Sk = 128,
// D = 64, bf16, non-causal) one hop is ~0.4 GFLOP (0.4 us at 989 TFLOP/s)
// against 6.3 MB for the forward (1.9 us at 3.35 TB/s): a hop that small is
// bound by its bytes and, below that, by its launch. At long shards (S =
// 1024 per shard) the hops are bound by operations, as rows 1-4 are.
// Design (right and simple first; wgmma, TMA and pipelining are later
// work), the tiles of flash_fwd.cu and flash_bwd.cu:
//   * bf16: tiles of 64 q rows x 64 keys on mma.sync m16n8k16 (bf16 in, f32
//     accumulate); forward and dq: one CTA per (bh, 64-row q tile), a loop
//     over key tiles, the score fragments re-packed in registers as the A
//     operand of the next product; dk/dv: one CTA per (bh, 64-key tile),
//     each warp computes s^T = k q^T for its 16 keys, a loop over q tiles.
//     At D = 256 the dq and dk/dv CTAs have 8 warps, two per row group,
//     each accumulating half of the head dimension.
//   * dq has one CTA per q tile and dk/dv one per key tile: no atomics, so
//     the ring is deterministic.
//   * fp32: the same algorithm on plain FMA in 32 x 32 tiles (TF32 tensor
//     cores keep ~3 digits, against a 1e-4 tolerance).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libring_attention.so ring_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kMask = -1e30f;

// ---------------------------------------------------------------------------
// tile bounds from the global offsets
// ---------------------------------------------------------------------------

// number of key tiles (of bk keys, n_kb in all) that rows [q0, q0 + bq) of
// the local q can see: the last row sees the keys below q_off + q0 + bq -
// k_off
__device__ __forceinline__ int key_tiles(int q0, int bq, int bk, int n_kb,
                                         int q_off, int k_off, int causal) {
  if (!causal) return n_kb;
  const long long vis = (long long)q_off + q0 + bq - k_off;
  if (vis <= 0) return 0;
  const long long n = (vis + bk - 1) / bk;
  return n < n_kb ? (int)n : n_kb;
}

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

// whether some (row, key) of the tile pair is hidden: past the ends, or a
// key after the row in global order
__device__ __forceinline__ bool tile_needs_mask(int q0, int bq, int Sq,
                                                int k0, int bk, int Sk,
                                                int q_off, int k_off,
                                                int causal) {
  return q0 + bq > Sq || k0 + bk > Sk ||
         (causal && (long long)k_off + k0 + bk - 1 > (long long)q_off + q0);
}

__device__ __forceinline__ bool visible(int row, int Sq, int key, int Sk,
                                        int q_off, int k_off, int causal) {
  return row < Sq && key < Sk &&
         (!causal || (long long)k_off + key <= (long long)q_off + row);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------
constexpr int kB = 64;  // q rows and keys per tile

template <int D>
struct Bf16Cfg {
  static constexpr int DW = D > 128 ? 128 : D;  // head-dim columns per warp
  static constexpr int kWarps = 4 * (D / DW);   // 4 row groups x D / DW
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int TS = D + 8;   // row stride of the [64][D] tiles
};
constexpr int kFwdThreads = 128;  // the forward keeps 4 warps at every D

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring elements of one row (the row-major fragment read)
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two elements of one column, rows r and r + 1 (the transposed read)
__device__ __forceinline__ uint32_t ld_col2(const bf16* p, int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
}

// A fragment of a 16 x 16 step from row-major rows (p = row g, column 2t)
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* p,
                                     int stride) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// A fragment of the 16-column step kk from a 16 x 64 accumulator (the
// fragments of n-tiles 2kk and 2kk+1), rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t a[4], float (*c)[4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// stage rows [row0, row0 + 64) of an [n, D] matrix into a tile with rows
// padded by 8 (so a warp's fragment reads hit distinct banks); rows past n
// read as zeros
template <int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int n, int tid) {
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
constexpr int fwd_bf16_smem_bytes() {
  // Q and K tiles [64][D+8], V^T tile [D][64+8]
  return (2 * kB * (D + 8) + D * (kB + 8)) * 2;
}

template <int D>
constexpr int bwd_bf16_smem_bytes() {
  // Q, dO, K, V tiles [64][D+8], and (dk/dv) the lse and delta rows
  return 4 * kB * (D + 8) * 2 + 2 * kB * 4;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
ring_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int q_off,
                     int k_off, int causal, float scale) {
  constexpr int QS = D + 8;   // row stride of the Q and K tiles
  constexpr int VS = kB + 8;  // row stride of the V^T tile
  constexpr int CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kB * QS;
  bf16* sVt = sK + kB * QS;

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
  const bf16* qw = sQ + (warp * 16 + g) * QS + 2 * t;
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
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
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
        const bf16* kp = sK + (j * 8 + g) * QS + kk * 16 + 2 * t;
        mma_bf16_16816(s[j], a, ld32(kp), ld32(kp + 8));
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
      pack_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vp = sVt + (n * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16_16816(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // written for every row, also when the loop ran zero times
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lsafe = fmaxf(l, 1e-30f);
    const int row = row0 + h * 8;
    if (row < Sq) {
      bf16* orow = o + qbase + (size_t)row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * h] / lsafe, acc[n][2 * h + 1] / lsafe);
      if (t == 0)
        lse[(size_t)blockIdx.y * Sq + row] =
            l > 0.f ? m_run[h] + logf(lsafe) : kMask;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Bf16Cfg<D>::kThreads)
ring_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, int q_off, int k_off, int causal,
                    float scale) {
  using C = Bf16Cfg<D>;
  constexpr int TS = C::TS, DW = C::DW, NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kB * TS;
  bf16* sK = sdO + kB * TS;
  bf16* sV = sK + kB * TS;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qb * kB;
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

  const bf16* qw = sQ + (rg * 16 + g) * TS + 2 * t;
  const bf16* ow = sdO + (rg * 16 + g) * TS + 2 * t;
  const int n_kb = (Sk + kB - 1) / kB;
  const int kb_end = key_tiles(q0, kB, kB, n_kb, q_off, k_off, causal);

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
        const bf16* kp = sK + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_bf16_16816(s[j], aq, ld32(kp), ld32(kp + 8));
        const bf16* vp = sV + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_bf16_16816(dp[j], ao, ld32(vp), ld32(vp + 8));
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
      pack_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        const bf16* kp = sK + (kk * 16 + 2 * t) * TS + d0 + n * 8 + g;
        mma_bf16_16816(acc[n], a, ld_col2(kp, TS), ld_col2(kp + 8 * TS, TS));
      }
    }
  }

  // written for every row, also when the loop ran zero times
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row < Sq) {
      float* out = dq + qbase + (size_t)row * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < DW / 8; ++n)
        *reinterpret_cast<float2*>(out + n * 8) =
            make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Bf16Cfg<D>::kThreads)
ring_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int q_off,
                     int k_off, int causal, float scale) {
  using C = Bf16Cfg<D>;
  constexpr int TS = C::TS, DW = C::DW, NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kB * TS;
  bf16* sQ = sV + kB * TS;
  bf16* sdO = sQ + kB * TS;
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

  const bf16* kw = sK + (rg * 16 + g) * TS + 2 * t;
  const bf16* vw = sV + (rg * 16 + g) * TS + 2 * t;
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
        const bf16* qp = sQ + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_bf16_16816(st[j], ak, ld32(qp), ld32(qp + 8));
        const bf16* op = sdO + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_bf16_16816(dpt[j], av, ld32(op), ld32(op + 8));
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
      pack_a(ap, st, kk);
      pack_a(as, dpt, kk);
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        const int col = d0 + n * 8 + g;
        const bf16* op = sdO + (kk * 16 + 2 * t) * TS + col;
        mma_bf16_16816(acc_dv[n], ap, ld_col2(op, TS),
                       ld_col2(op + 8 * TS, TS));
        const bf16* qp = sQ + (kk * 16 + 2 * t) * TS + col;
        mma_bf16_16816(acc_dk[n], as, ld_col2(qp, TS),
                       ld_col2(qp + 8 * TS, TS));
      }
    }
  }

  // written for every key, also when the loop ran zero times
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + rg * 16 + g + h * 8;
    if (key < Sk) {
      const size_t off = kbase + (size_t)key * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        *reinterpret_cast<float2*>(dk + off + n * 8) = make_float2(
            acc_dk[n][2 * h] * scale, acc_dk[n][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dv + off + n * 8) =
            make_float2(acc_dv[n][2 * h], acc_dv[n][2 * h + 1]);
      }
    }
  }
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
ring_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, int q_off,
                    int k_off, int causal, float scale) {
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

  float l = l_run;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float lsafe = fmaxf(l, 1e-30f);
  if (qrow < Sq) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      o[qbase + (size_t)qrow * D + sub + 4 * i] = acc[i] / lsafe;
    if (sub == 0)
      lse[(size_t)blockIdx.y * Sq + qrow] =
          l > 0.f ? m_run + logf(lsafe) : kMask;
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
ring_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int Sq, int Sk, int q_off, int k_off, int causal,
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

  const int n_kb = (Sk + kFB - 1) / kFB;
  const int kb_end = key_tiles(q0, kFB, kFB, n_kb, q_off, k_off, causal);
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

  if (qrow < Sq) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      dq[qbase + (size_t)qrow * D + sub + 4 * i] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
ring_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int Sq, int Sk, int q_off,
                    int k_off, int causal, float scale) {
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

  const int key = k0 + r;
  if (key < Sk) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      dk[kbase + (size_t)key * D + sub + 4 * i] = acc_dk[i] * scale;
      dv[kbase + (size_t)key * D + sub + 4 * i] = acc_dv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *dk, *dv;  // o: out (forward) or dq
  void* lse_out;      // forward only
  int bh, Sq, Sk, q_off, k_off, causal;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t launch_fwd(const Args& a, int is_bf16) {
  const float scale = 1.0f / sqrtf((float)D);
  if (is_bf16) {
    const int smem = fwd_bf16_smem_bytes<D>();
    auto kernel = ring_fwd_bf16_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + kB - 1) / kB, a.bh);
    kernel<<<grid, kFwdThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
        static_cast<float*>(a.lse_out), a.Sq, a.Sk, a.q_off, a.k_off,
        a.causal, scale);
  } else {
    const int smem = fwd_f32_smem_bytes<D>();
    auto kernel = ring_fwd_f32_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + kFB - 1) / kFB, a.bh);
    kernel<<<grid, kFThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o),
        static_cast<float*>(a.lse_out), a.Sq, a.Sk, a.q_off, a.k_off,
        a.causal, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, int is_bf16) {
  const float scale = 1.0f / sqrtf((float)D);
  if (is_bf16) {
    const int smem = bwd_bf16_smem_bytes<D>();
    auto kernel = ring_dq_bf16_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + kB - 1) / kB, a.bh);
    kernel<<<grid, Bf16Cfg<D>::kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.o), a.Sq, a.Sk, a.q_off, a.k_off, a.causal,
        scale);
  } else {
    const int smem = dq_f32_smem_bytes<D>();
    auto kernel = ring_dq_f32_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + kFB - 1) / kFB, a.bh);
    kernel<<<grid, kFThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.o), a.Sq, a.Sk, a.q_off, a.k_off, a.causal,
        scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, int is_bf16) {
  const float scale = 1.0f / sqrtf((float)D);
  if (is_bf16) {
    const int smem = bwd_bf16_smem_bytes<D>();
    auto kernel = ring_dkv_bf16_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sk + kB - 1) / kB, a.bh);
    kernel<<<grid, Bf16Cfg<D>::kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Sk,
        a.q_off, a.k_off, a.causal, scale);
  } else {
    const int smem = dkv_f32_smem_bytes<D>();
    auto kernel = ring_dkv_f32_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sk + kFB - 1) / kFB, a.bh);
    kernel<<<grid, kFThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Sk,
        a.q_off, a.k_off, a.causal, scale);
  }
  return cudaGetLastError();
}

enum Kind { kKindFwd, kKindDq, kKindDkv };

int dispatch(Kind kind, const Args& a, int D, int is_bf16) {
  if (a.bh < 1 || a.bh > 65535 || a.Sq < 1 || a.Sk < 1)
    return (int)cudaErrorInvalidValue;
#define PT_RING_CASE(DIM)                                             \
  case DIM:                                                           \
    if (kind == kKindFwd) return (int)launch_fwd<DIM>(a, is_bf16);    \
    if (kind == kKindDq) return (int)launch_dq<DIM>(a, is_bf16);      \
    return (int)launch_dkv<DIM>(a, is_bf16);
  switch (D) {
    PT_RING_CASE(64)
    PT_RING_CASE(128)
    PT_RING_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PT_RING_CASE
}

}  // namespace

// q, dout: [bh, Sq, D]; k, v: [bh, Sk, D]; contiguous, 16-byte aligned, one
// dtype (is_bf16: 1 for bf16, 0 for fp32). lse, delta: [bh, Sq] f32.
// q_off, k_off: global positions of the first q row and the first key.
// Each entry launches on `stream` and returns a cudaError_t.

// out: [bh, Sq, D] in the input dtype; lse_out: [bh, Sq] f32
extern "C" int ring_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse_out, int bh, int Sq, int Sk,
                        int D, int q_off, int k_off, int is_bf16, int causal,
                        void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, nullptr,
         lse_out, bh, Sq, Sk, q_off, k_off, causal,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kKindFwd, a, D, is_bf16);
}

// dq: [bh, Sq, D] f32
extern "C" int ring_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int bh, int Sq, int Sk, int D, int q_off,
                       int k_off, int is_bf16, int causal, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, bh, Sq,
         Sk, q_off, k_off, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(kKindDq, a, D, is_bf16);
}

// dk, dv: [bh, Sk, D] f32
extern "C" int ring_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int Sq, int Sk, int D,
                        int q_off, int k_off, int is_bf16, int causal,
                        void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, nullptr, bh, Sq, Sk,
         q_off, k_off, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(kKindDkv, a, D, is_bf16);
}
