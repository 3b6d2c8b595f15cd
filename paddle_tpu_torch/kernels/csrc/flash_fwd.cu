// Flash-attention forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/flash_attention.py::_fa_kernel (reached
// through _flash_fwd_bhsd). Same function: q/k/v [BH, S, D] -> out
// [BH, S, D] in the input dtype and lse [BH, 1, S] in f32 natural-log
// units, scale 1/sqrt(D), online softmax in base 2 (log2 e folded into the
// scale), causal keys past the diagonal masked to -1e30 and whole key
// tiles past it skipped by the loop bound, ragged S masked in the kernel.
//
// Bound on the H100: at the serving shape (B=4, H=12, S=1024, D=64, bf16,
// causal) the pass needs ~6.4 GFLOP (6.5 us at 989 TFLOP/s) and moves
// ~25 MB (7.6 us at 3.35 TB/s): it sits at the ridge, so the S x S scores
// stay on chip, the products must reach the tensor cores at wgmma's rate
// and the loads must hide under them.
//
// bf16 at D = 64 and 128 (every main path): the warp-specialised wgmma
// kernel.
//   * one CTA per (bh, q tile), the heaviest causal tiles launched first;
//     consumer warpgroups of 64 q rows each and one producer warpgroup
//     whose single thread issues every TMA load (registers move from the
//     producer to the consumers with setmaxnreg). D = 128: two consumers
//     (128-row tiles), one CTA per SM. D = 64: one consumer and two CTAs
//     per SM: there the softmax (one exp2 per score against a 64-deep
//     product) bounds a tile, and the second CTA hides each one's
//     prologue (Q and the first K/V tile) and epilogue;
//   * Q is loaded once by TMA into a 128-byte-swizzled tile; K and V tiles
//     of 128 keys stream through a ring of three stages, each with its own
//     full barrier for K and for V and one empty barrier, so the next
//     tile is in flight while the consumers compute; 3-D tensor maps
//     ([BH, S, D]) zero-fill the ragged tail of a head instead of reading
//     the next head's rows;
//   * S = Q K^T on wgmma m64n128k16 with both operands in shared memory
//     (K is K-major as it lies); O += P V on wgmma m64nDk16 with P from
//     registers (the score accumulator re-packed to bf16 in place) and V
//     read MN-major with the transpose flag: no transposition anywhere;
//   * within a warpgroup the products overlap the softmax: tile i's
//     scores are issued with tile i - 1's PV product, and tile i's
//     softmax runs while that product is in flight; the two consumer
//     warpgroups interleave on the tensor cores besides;
//   * key tiles run from the diagonal (or ragged) tile down, so only the
//     first one is masked; f32 running (m, l) and the O accumulator stay
//     in registers; out (bf16) and lse are written from the registers.
// D = 256 bf16 keeps the mma.sync kernel and fp32 the FMA kernel below (the
// dispatcher admits fp32 from S = 4096; H100 tensor cores have no exact-fp32
// mode): no main path runs them, and a 64 x 256 f32 accumulator per
// warpgroup leaves no registers for the scores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu -lcuda

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMask = -1e30f;
constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// bf16, D = 256: tensor cores through mma.sync
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;  // q rows per CTA (16 per warp)
constexpr int kBK = 64;  // keys per staged tile

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using hopper::pack_bf16;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
constexpr int bf16_smem_bytes() {
  // Q and K tiles [64][D+8], V^T tile [D][64+8]; the +8 pads rows so the
  // fragment reads of one warp hit 32 distinct banks
  return (2 * kBQ * (D + 8) + D * (kBK + 8)) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int causal, float s2scale) {
  constexpr int QS = D + 8;    // row stride of the Q and K tiles
  constexpr int VS = kBK + 8;  // row stride of the V^T tile
  constexpr int CH = D / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * QS;
  __nv_bfloat16* sVt = sK + kBK * QS;

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qi * kBQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(sQ + r * QS + c) = val;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's two rows: g and g + 8 of the warp's 16
  float m_run[2] = {kMask, kMask};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
  const int row0 = q0 + warp * 16 + g;

  const int n_kb = (S + kBK - 1) / kBK;
  const int kb_end = causal ? min(n_kb, (q0 + kBQ + kBK - 1) / kBK) : n_kb;
  const __nv_bfloat16* qw = sQ + (warp * 16 + g) * QS + 2 * t;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < S) {
        const size_t off = base + (size_t)(k0 + r) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + r * QS + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * VS + r] = ve[e];
    }
    __syncthreads();

    // s = q k^T for the warp's 16 rows x 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a[0] = ld32(qw + kk * 16);
      a[1] = ld32(qw + 8 * QS + kk * 16);
      a[2] = ld32(qw + kk * 16 + 8);
      a[3] = ld32(qw + 8 * QS + kk * 16 + 8);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * QS + kk * 16 + 2 * t;
        mma_bf16_16816(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    // scale into the base-2 domain; mask the diagonal tile and ragged keys
    const bool need_mask = (k0 + kBK > S) || (causal && k0 + kBK - 1 > q0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * s2scale;
        if (need_mask) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= S || (causal && col > row)) x = kMask;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mx[e >> 1]);
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
    // fragment of the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp = sVt + (n * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16_16816(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lsafe = fmaxf(l, 1e-30f);
    const int row = row0 + h * 8;
    if (row < S) {
      __nv_bfloat16* orow = o + base + (size_t)row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * h] / lsafe, acc[n][2 * h + 1] / lsafe);
      if (t == 0)
        lse[(size_t)blockIdx.y * S + row] = m_run[h] * kLn2 + logf(lsafe);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the same online softmax on plain FMA
// ---------------------------------------------------------------------------
constexpr int kFBQ = 32;  // q rows per CTA (4 threads per row)
constexpr int kFBK = 32;  // keys per staged tile

template <int D>
constexpr int f32_smem_bytes() {
  // Q and K tiles [32][D+1] (odd stride: conflict-free dot products),
  // V tile [32][D], P tile [32][32+1]
  return (2 * kFBQ * (D + 1) + kFBK * D + kFBQ * (kFBK + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int causal,
                     float s2scale) {
  constexpr int QS = D + 1;
  constexpr int PS = kFBK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kFBQ * QS;
  float* sV = sK + kFBK * QS;
  float* sP = sV + kFBK * D;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int q0 = qi * kFBQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;  // row r, the 4 threads of a row
  const int qpos = q0 + r;                // are neighbouring lanes

  for (int i = tid; i < kFBQ * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    sQ[rr * QS + c] = (q0 + rr < S) ? q[base + (size_t)(q0 + rr) * D + c] : 0.f;
  }

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m_run = kMask, l_run = 0.f;

  const int n_kb = (S + kFBK - 1) / kFBK;
  const int kb_end = causal ? min(n_kb, (q0 + kFBQ + kFBK - 1) / kFBK) : n_kb;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kFBK;
    __syncthreads();
    for (int i = tid; i < kFBK * D; i += kThreads) {
      const int rr = i / D, c = i % D;
      const bool ok = k0 + rr < S;
      const size_t off = base + (size_t)(k0 + rr) * D + c;
      sK[rr * QS + c] = ok ? k[off] : 0.f;
      sV[rr * D + c] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    float s[kFBK / 4];
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < kFBK / 4; ++j) {
      const int key = sub + 4 * j;
      const float* qr = sQ + r * QS;
      const float* kr = sK + key * QS;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float x = dot * s2scale;
      const int col = k0 + key;
      if (col >= S || (causal && col > qpos)) x = kMask;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f(m_run - mx);
    m_run = mx;
    l_run *= alpha;
#pragma unroll
    for (int j = 0; j < kFBK / 4; ++j) {
      const float p = exp2f(s[j] - mx);
      l_run += p;
      sP[r * PS + sub + 4 * j] = p;
    }
    __syncwarp();  // a row's p is written and read by its own 4 lanes
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int d = sub + 4 * i;
      float a = acc[i] * alpha;
#pragma unroll 8
      for (int key = 0; key < kFBK; ++key)
        a = fmaf(sP[r * PS + key], sV[key * D + d], a);
      acc[i] = a;
    }
  }

  float l = l_run;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float lsafe = fmaxf(l, 1e-30f);
  if (qpos < S) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      o[base + (size_t)qpos * D + sub + 4 * i] = acc[i] / lsafe;
    if (sub == 0)
      lse[(size_t)blockIdx.y * S + qpos] = m_run * kLn2 + logf(lsafe);
  }
}

// ---------------------------------------------------------------------------
// bf16, D = 64 and 128: warp-specialised wgmma fed by TMA
// ---------------------------------------------------------------------------
template <int D>
struct WgCfg {
  // D = 64: one consumer warpgroup of 64 q rows and two CTAs per SM (the
  // softmax, not the tensor cores, bounds a tile there, and a second CTA
  // hides each CTA's prologue and epilogue); D = 128: two consumers of 64
  // rows in one CTA per SM
  static constexpr int kConsumers = D == 64 ? 1 : 2;
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kM = 64 * kConsumers;  // q rows per CTA
  static constexpr int kN = 128;              // keys per K or V tile
  // K/V stages: the PV product of tile i - 1 and the scores of tile i
  // hold two while the producer fills the third
  static constexpr int kStages = 3;
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + producer
  // registers per thread after the hand-off: the producer's and the
  // consumers' together fill the SM's 64K registers
  static constexpr int kProducerRegs = D == 64 ? 24 : 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kTileBytes = kN * D * 2;
  // Q, the K ring, the V ring, the barriers; +1024 aligns the base
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 128 +
                               1024;
};

// one tile of the online softmax, in place: s holds q k^T on entry and p
// = exp2(s * s2scale - m) on exit, m the running row max in the base-2
// domain; (m_run, l_run) are updated and alpha gets the factor the output
// accumulator must be scaled by. Keys past S and, when causal, past the
// row are masked (only the diagonal or ragged tile has any).
template <int kN>
__device__ __forceinline__ void online_softmax(float (&s)[kN / 2],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&alpha)[2],
                                               float s2scale, int k0, int S,
                                               int causal, int q0, int row0,
                                               int t) {
  const bool need_mask = (k0 + kN > S) || (causal && k0 + kN - 1 > q0);
  // the row max of the unscaled scores (s2scale > 0), masked ones at -1e30
  float mx[2] = {kMask, kMask};
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int h = (i >> 1) & 1;
    if (need_mask) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (col >= S || (causal && col > row0 + 8 * h)) s[i] = kMask;
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
  // p = exp2(s * s2scale - m): the scale folded into one FFMA
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2f(fmaf(s[i], s2scale, -mx[h]));
    s[i] = p;
    l_run[h] += p;
  }
}

template <int D>
__global__ void __launch_bounds__(WgCfg<D>::kThreads, WgCfg<D>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int S, int causal, float s2scale) {
  using namespace hopper;
  using C = WgCfg<D>;
  constexpr int kM = C::kM, kN = C::kN, ST = C::kStages, NH = D / 64;
  constexpr int NC = C::kConsumers;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;  // stage st at + st * kTileBytes
  const uint32_t sV = sK + ST * C::kTileBytes;
  // barriers: Q full, then per stage K full, V full, K/V empty
  const uint32_t full_q = sV + ST * C::kTileBytes;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * ST,
                 empty = full_v + 8 * ST;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;  // heaviest tiles first
  const int n_kb = (S + kN - 1) / kN;
  const int kb_end = causal ? min(n_kb, (q0 + kM + kN - 1) / kN) : n_kb;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, NC);  // one arrival per consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: one thread keeps the ring full, key tiles from the last
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 128 * NC) {
      mbar_arrive_expect_tx(full_q, C::kQBytes);
      for (int h = 0; h < NH; ++h)
        tma_load_3d(sQ + h * kM * 128, &tm_q, full_q, h * 64, q0, bh);
      for (int it = 0; it < kb_end; ++it) {
        const int kb = kb_end - 1 - it, st = it % ST;
        mbar_wait(empty + 8 * st, ((it / ST) & 1) ^ 1);
        const uint32_t k_tile = sK + st * C::kTileBytes;
        const uint32_t v_tile = sV + st * C::kTileBytes;
        mbar_arrive_expect_tx(full_k + 8 * st, C::kTileBytes);
        for (int h = 0; h < NH; ++h)
          tma_load_3d(k_tile + h * kN * 128, &tm_k, full_k + 8 * st, h * 64,
                      kb * kN, bh);
        mbar_arrive_expect_tx(full_v + 8 * st, C::kTileBytes);
        for (int h = 0; h < NH; ++h)
          tma_load_3d(v_tile + h * kN * 128, &tm_v, full_v + 8 * st, h * 64,
                      kb * kN, bh);
      }
    }
  } else {
    // consumer warpgroup wg: q rows q0 + 64 wg .. + 63
    reg_alloc<C::kConsumerRegs>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
    const int row0 = q0 + wg * 64 + warp * 16 + g;  // and row0 + 8
    const uint32_t q_rows = sQ + wg * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kMask, kMask};
    float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
    float s[kN / 2];
    uint32_t pa[kN / 16][4];  // p of the previous tile, the PV A operand
    mbar_wait(full_q, 0);

    // s = q k^T for the tile in stage st: 64 rows x 128 keys, issued and
    // committed as one group
    auto issue_scores = [&](int st) {
      const uint32_t k_tile = sK + st * C::kTileBytes;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kN, 0, 0>(
            s, desc_kmajor(q_rows + (kk >> 2) * kM * 128 + (kk & 3) * 32),
            desc_kmajor(k_tile + (kk >> 2) * kN * 128 + (kk & 3) * 32));
      wgmma_commit();
    };
    // acc += p v for the tile in stage st: p from registers, v MN-major
    auto issue_pv = [&](int st) {
      const uint32_t v_tile = sV + st * C::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<D, 1>(acc, pa[kk],
                       desc_mnmajor(v_tile + kk * 2048, kN * 128));
      wgmma_commit();
    };

    // tile 0 (the diagonal or ragged one, the only one masked)
    mbar_wait(full_k, 0);
    issue_scores(0);
    wgmma_wait<0>();
    fence_regs(s);
    float alpha[2];
    online_softmax<kN>(s, m_run, l_run, alpha, s2scale, (kb_end - 1) * kN,
                       S, causal, q0, row0, t);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) pack_a(pa[kk], s, kk);

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
      online_softmax<kN>(s, m_run, l_run, alpha, s2scale,
                         (kb_end - 1 - it) * kN, S, causal, q0, row0, t);
      wgmma_wait<0>();  // the previous PV product is in
      fence_regs(acc);
      if (tid == 0) mbar_arrive(empty + 8 * pst);  // the stage is consumed
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) pack_a(pa[kk], s, kk);
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

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float lsafe = fmaxf(l, 1e-30f);
      const int row = row0 + 8 * h;
      if (row < S) {
        __nv_bfloat16* orow = o + ((size_t)bh * S + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              pack_bf16(acc[4 * n + 2 * h] / lsafe,
                        acc[4 * n + 2 * h + 1] / lsafe);
        if (t == 0) lse[(size_t)bh * S + row] = m_run[h] * kLn2 + logf(lsafe);
      }
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int S, int causal,
                         cudaStream_t stream) {
  using C = WgCfg<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (encode_bhsd_map(&tm_q, q, bh, S, D, C::kM) ||
      encode_bhsd_map(&tm_k, k, bh, S, D, C::kN) ||
      encode_bhsd_map(&tm_v, v, bh, S, D, C::kN))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (S + C::kM - 1) / C::kM);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, causal, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int S, int is_bf16, int causal,
                   cudaStream_t stream) {
  const float s2scale = kLog2e / sqrtf((float)D);
  if (is_bf16) {
    if constexpr (D != 256) {
      return launch_wgmma<D>(q, k, v, o, lse, bh, S, causal, stream);
    } else {
      const int smem = bf16_smem_bytes<D>();
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_bf16_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      dim3 grid((S + kBQ - 1) / kBQ, bh);
      flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S,
          causal, s2scale);
    }
  } else {
    const int smem = f32_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    dim3 grid((S + kFBQ - 1) / kFBQ, bh);
    flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), S, causal, s2scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, S, D] contiguous, 16-byte aligned; lse: [bh, S] f32.
// is_bf16: 1 for bf16 tensors, 0 for fp32. Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int S, int D, int is_bf16,
                         int causal, void* stream) {
  if (bh < 1 || bh > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, o, lse, bh, S, is_bf16, causal, st);
    case 128:
      return (int)launch<128>(q, k, v, o, lse, bh, S, is_bf16, causal, st);
    case 256:
      return (int)launch<256>(q, k, v, o, lse, bh, S, is_bf16, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
