// The dq pass of flash attention on Hopper (sm_90a), one template for two
// kernels: the two-pass backward's dq (flash_bwd.cu, flash_bwd_dq) and a
// ring step's dq (ring_attention.cu, ring_dq_step).
//
// Both compute, for one q tile against keys [0, Sk) of k and v,
//   s  = q k^T,  p = exp2(s * scale * log2(e) - lse * log2(e)),
//   dp = dO v^T, ds = p * (dp - delta),  dq = scale * ds k,
// with lse and delta the caller's rows (the ring's global ones), p and ds
// rounded to the element type T (bf16 or fp16, csrc/hopper.cuh's Elem<T>)
// before their products, hidden keys at p = 0 exactly. A
// key is hidden when it lies past Sk or, with `causal`, after the row in
// global order: k_off + key > q_off + row. The two-pass form passes
// (q_off, k_off) = (0, 0) and Sq = Sk = S.
//
// Design (csrc/hopper.cuh's layout contract and mbarrier waits):
//   * one CTA per (bh, q tile of 64 rows[, slot]), two CTAs per SM: one
//     consumer warpgroup and one producer warpgroup whose first thread
//     issues the TMA loads: Q and dO once, then K and V tiles of kN = 64
//     keys through a ring of mbarrier stages (3 at D = 64, 2 at D = 128),
//     from key tile 0 to the last one the q tile sees. 3-D tensor maps
//     zero-fill rows past the end of a head. setmaxnreg hands the
//     producer's registers to the consumer (24/232);
//   * s = Q K^T and dp = dO V^T on wgmma m64n64k16 with both operands in
//     shared memory, K-major as they lie; p and ds are formed in the
//     accumulator registers and re-packed to T as the register A
//     operand of dq += ds K, K read MN-major with the transpose flag: no
//     operand is transposed by hand. The next tile's s and dp are issued
//     while this tile's dq product runs;
//   * lse * log2(e) and delta of a thread's two rows live in registers;
//   * masks and trip counts come from the global offsets, which need not
//     lie on any tile grid: every score of a tile that may hold a hidden
//     key is masked by global position, and the loop stops at the last key
//     tile the q tile's last row sees. A q tile that sees no key loads
//     nothing;
//   * the epilogue (kAccumulate): dq * scale is added into the slot's f32
//     accumulator [BH, Sq, D]; every running value is read before any
//     store (at D = 64 the loads are issued before the mainloop, at
//     D = 128 after it, all of them before the first store). A q tile that
//     sees no key leaves its accumulator untouched. Otherwise dq * scale is
//     stored in T;
//   * one CTA owns each q tile and loops over the keys in one order: no
//     atomics, the result repeats bitwise.
#pragma once

#include "hopper.cuh"

namespace dq_wgmma {

constexpr float kLog2e = 1.4426950408889634f;

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

// whether some (row, key) of the tile pair is hidden: past the ends, or a
// key after the row in global order
__device__ __forceinline__ bool tile_needs_mask(int q0, int bq, int Sq,
                                                int k0, int bk, int Sk,
                                                int q_off, int k_off,
                                                int causal) {
  return q0 + bq > Sq || k0 + bk > Sk ||
         (causal && (long long)k_off + k0 + bk - 1 > (long long)q_off + q0);
}

// a slot's tensor maps ([BH, S, D] of T, boxes of 64 columns: q and dout of
// kM rows, k and v of kN rows) and the rest of what it reads and writes
struct Maps {
  CUtensorMap q, k, v, dout;
};

struct Slot {
  const float *lse, *delta;  // [BH, Sq] f32
  void* dq;  // f32 accumulator [BH, Sq, D] (kAccumulate), else dq in T
  int q_off, k_off;
};

template <int NS>
struct Params {
  Maps maps[NS];
  Slot s[NS];
};

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "the wgmma dq pass takes D 64 or 128");
  static constexpr int kM = 64;  // q rows per CTA
  static constexpr int kN = 64;  // keys per K or V tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kThreads = 256;   // consumer and producer warpgroups
  static constexpr int kMinBlocks = 2;   // CTAs per SM
  static constexpr int kQBytes = kM * D * 2;         // Q (or dO) of the CTA
  static constexpr int kTileBytes = kN * D * 2;      // one K (or V) tile
  static constexpr int kOffDO = kQBytes;
  static constexpr int kOffK = 2 * kQBytes;  // + st * kTileBytes
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffBar = kOffV + kStages * kTileBytes;
  static constexpr int kSmem = kOffBar + 64 + 1024;  // +1024 aligns the base
};

// the f32 accumulator of rows row0 + 8h at this thread's columns (zeros
// past Sq)
template <int D>
__device__ __forceinline__ void load_acc(float2 (&old)[2][D / 8],
                                         const float* dst, int row0, int t,
                                         int Sq, size_t rbase) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      old[h][n] = row < Sq ? *reinterpret_cast<const float2*>(
                                 dst + (rbase + row) * D + 8 * n + 2 * t)
                           : make_float2(0.f, 0.f);
  }
}

// One CTA of the dq pass: q rows from tile blockIdx.y (the last tiles, the
// longest causal loops, first), head blockIdx.x. Every thread calls it.
template <typename T, int D, bool kAccumulate>
__device__ __forceinline__ void run(const Maps& maps, const Slot& sl, int Sq,
                                    int Sk, int causal, float scale) {
  using namespace hopper;
  using C = Cfg<D>;
  constexpr int kM = C::kM, kN = C::kN, ST = C::kStages, NH = D / 64;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int n_kb = (Sk + kN - 1) / kN;
  const int n_it = key_tiles(q0, kM, kN, n_kb, sl.q_off, sl.k_off, causal);
  // a q tile that sees no key leaves its accumulator as it is
  if (kAccumulate && n_it == 0) return;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sb = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = sb, sDO = sb + C::kOffDO;
  const uint32_t sK = sb + C::kOffK, sV = sb + C::kOffV;  // + st * tile
  // barriers: Q/dO full, then per stage K/V full and K/V empty
  const uint32_t full_q = sb + C::kOffBar;
  const uint32_t full = full_q + 8, empty = full + 8 * ST;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 1);  // the consumer's arrival
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 1) {
    // producer: one thread loads Q and dO, then keeps the K/V ring full
    reg_dealloc<24>();
    if (threadIdx.x == 128 && n_it > 0) {
      mbar_arrive_expect_tx(full_q, 2 * C::kQBytes);
      for (int h = 0; h < NH; ++h) {
        tma_load_3d(sQ + h * kM * 128, &maps.q, full_q, h * 64, q0, bh);
        tma_load_3d(sDO + h * kM * 128, &maps.dout, full_q, h * 64, q0, bh);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % ST;
        mbar_wait(empty + 8 * st, ((it / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * st, 2 * C::kTileBytes);
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(sK + st * C::kTileBytes + h * kN * 128, &maps.k,
                      full + 8 * st, h * 64, it * kN, bh);
          tma_load_3d(sV + st * C::kTileBytes + h * kN * 128, &maps.v,
                      full + 8 * st, h * 64, it * kN, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup: q rows q0 .. q0 + 63
  reg_alloc<232>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const size_t rbase = (size_t)bh * Sq;
  const long long diag = (long long)sl.q_off - sl.k_off;
  const float s2scale = scale * kLog2e;
  float* acc_dst = static_cast<float*>(sl.dq);

  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse2[h] = row < Sq ? sl.lse[rbase + row] * kLog2e : 0.f;
    dl[h] = row < Sq ? sl.delta[rbase + row] : 0.f;
  }
  // the running accumulator: at D = 64 its loads are in flight under the
  // mainloop (D = 128 has no registers to spare for it there)
  float2 old[2][D / 8];
  if constexpr (kAccumulate && D == 64)
    load_acc<D>(old, acc_dst, row0, t, Sq, rbase);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (n_it > 0) {
    const uint32_t q_rows = sQ, do_rows = sDO;
    float s[kN / 2], dp[kN / 2];
    uint32_t da[kN / 16][4];  // ds of the tile, the A operand of ds K

    // s = q k^T and dp = dO v^T for the tile in stage st: 64 rows x kN keys
    auto issue_sdp = [&](int st) {
      const uint32_t k_tile = sK + st * C::kTileBytes;
      const uint32_t v_tile = sV + st * C::kTileBytes;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk >> 2) * kM * 128 + (kk & 3) * 32;
        const uint32_t b_off = (kk >> 2) * kN * 128 + (kk & 3) * 32;
        wgmma_ss<T, kN, 0, 0>(s, desc_kmajor(q_rows + a_off),
                              desc_kmajor(k_tile + b_off));
        wgmma_ss<T, kN, 0, 0>(dp, desc_kmajor(do_rows + a_off),
                              desc_kmajor(v_tile + b_off));
      }
      wgmma_commit();
    };

    mbar_wait(full_q, 0);
    mbar_wait(full, 0);
    issue_sdp(0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % ST, k0 = it * kN;
      wgmma_wait<0>();  // this tile's s and dp, the previous dq product
      fence_regs(s);
      fence_regs(dp);
      fence_regs(acc);
      if (it > 0 && tid == 0)
        mbar_arrive(empty + 8 * ((it - 1) % ST));  // that tile is consumed

      // p and ds; hidden keys get p = 0 exactly
      const bool need_mask = tile_needs_mask(q0, kM, Sq, k0, kN, Sk,
                                             sl.q_off, sl.k_off, causal);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = exp2f(fmaf(s[i], s2scale, -lse2[h]));
        if (need_mask) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (key >= Sk || (causal && (long long)key > row0 + 8 * h + diag))
            p = 0.f;
        }
        dp[i] = p * (dp[i] - dl[h]);
      }
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) pack_a<T>(da[kk], dp, kk);

      // dq += ds k: ds from registers, k MN-major
      const uint32_t k_tile = sK + st * C::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<T, D, 1>(acc, da[kk], desc_mnmajor(k_tile + kk * 2048,
                                                    kN * 128));
      wgmma_commit();
      if (it + 1 < n_it) {  // the next tile's s and dp under this product
        const int nst = (it + 1) % ST;
        mbar_wait(full + 8 * nst, ((it + 1) / ST) & 1);
        issue_sdp(nst);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  if constexpr (kAccumulate) {
    // dq * scale added into the accumulator, every value read first
    if constexpr (D != 64) load_acc<D>(old, acc_dst, row0, t, Sq, rbase);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= Sq) continue;
      float* dst = acc_dst + (rbase + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(fmaf(acc[4 * n + 2 * h], scale, old[h][n].x),
                        fmaf(acc[4 * n + 2 * h + 1], scale, old[h][n].y));
    }
  } else {
    // dq * scale in T (zeros for a tile that saw no key)
    T* out = static_cast<T*>(sl.dq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= Sq) continue;
      T* dst = out + (rbase + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            Elem<T>::pack(acc[4 * n + 2 * h] * scale,
                     acc[4 * n + 2 * h + 1] * scale);
    }
  }
}

// host: the slot's tensor maps for a [bh, Sq, D] q / dout and [bh, Sk, D]
// k / v; 0 or the driver's CUresult
template <typename T, int D>
inline int encode_maps(Maps* m, const void* q, const void* k, const void* v,
                       const void* dout, int bh, int Sq, int Sk) {
  using C = Cfg<D>;
  int r = encode_bhsd_map<T>(&m->q, q, bh, Sq, D, C::kM);
  if (!r) r = encode_bhsd_map<T>(&m->k, k, bh, Sk, D, C::kN);
  if (!r) r = encode_bhsd_map<T>(&m->v, v, bh, Sk, D, C::kN);
  if (!r) r = encode_bhsd_map<T>(&m->dout, dout, bh, Sq, D, C::kM);
  return r;
}

// host: launch `kernel` (a __global__ that calls run<T, D, ...> with slot
// blockIdx.z of prm) over n slots of [bh, Sq] q rows
template <int D, typename Kernel, typename P>
inline cudaError_t launch(Kernel kernel, const P& prm, int n, int bh, int Sq,
                          int Sk, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (Sq + C::kM - 1) / C::kM, n);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      prm, Sq, Sk, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace dq_wgmma
