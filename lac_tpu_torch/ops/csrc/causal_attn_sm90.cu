// Causal softmax attention on Hopper's tensor cores (sm_90a), bf16 inputs at
// head dim 64 or 128: K10 (forward), K11 (dK, dV) and K12 (dQ) redesigned
// around wgmma, TMA and mbarriers. f32 inputs keep the scalar kernels of
// causal_attn.cu (tensor cores on f32 would mean TF32).
//
//   K10 causal_attn_fwd_sm90_kernel<D>      O = softmax(Q K^T scale, causal) V,
//                                           lse = m + log(l) per query row
//   K11 causal_attn_bwd_dkv_sm90_kernel<D>  dK = scale dS^T Q, dV = P^T dO
//   K12 causal_attn_bwd_dq_sm90_kernel<D>   dQ = (scale dS) K
//
// They replace, as causal_attn.cu's do, the library Pallas kernels that
// lac_tpu's training prefill reaches (lac_tpu/models/transformer.py:706-768;
// JAX 0.9.0 jax/experimental/pallas/ops/tpu/): K10 flash_attention.py
// _flash_attention_impl :589 and splash_attention_kernel.py
// _splash_attention_forward :895; K11 _flash_attention_bwd_dkv :941 and
// _splash_attention_bwd_dkv :1857; K12 _flash_attention_bwd_dq :1287 (its
// kernel _flash_attention_dq_kernel :1146) and _splash_attention_bwd_dq
// :1405. The function is causal_attn.cu's, to which the plain versions in
// ops/attention.py hold all three:
//   s = q_i . k_j scale (j <= i, else -inf);  lse_i = log sum_j exp(s_ij);
//   P = exp(s - lse);  O = P V;  dV = P^T dO;  dP = dO V^T;
//   dS = P o (dP - di);  dK = scale dS^T Q,  dQ = scale dS K,
//   di = sum_d O o dO (the caller's).
// Rounding follows JAX's flash kernel: the operands of the second products
// are rounded to bf16 where it rounds them (p.astype(v.dtype) before P V,
// flash_attention.py:470-471; p.T.astype(do.dtype) before dV, :900;
// ds.T.astype(do.dtype) before dK, :918; ds.astype(k.dtype) before dQ,
// :1258). The reference scales dS in f32 before it rounds it (:913-914 for
// dK, :1247-1248 for dQ). K12 does exactly that, one multiply in registers
// before the pack; K11 scales the f32 dK after its product instead: the same
// bits where the scale is a power of two, as at D 64 and in splash's scale
// 1, one bf16 rounding apart at D 128. Everything else is f32: scores,
// the row statistics (l sums the f32 probabilities), dP, dS and every
// accumulator; outputs are rounded once to bf16 (dQ as the reference's
// dq_scratch, :1283). exp is exp2 with log2(e) folded into the scale and
// into lse.
//
// Bound on this card at the training shape (B 64, H 8, S 1024, D 64): 2
// (K10), 4 (K11) and 3 (K12) causal products of B H D S (S + 1) flops at
// 989 TFLOP/s bf16, against 50-80 MB of traffic (chip_smoke.py derives
// both); K10 is bound by bytes only just, K11 and K12 by operations.
//
// Design. A block is three warpgroups, 384 threads: warpgroups 0 and 1
// consume (wgmma, softmax, epilogue), each owning 64 rows of the block's
// tile; warpgroup 2 produces, and of it only lane 0 of warp 0 issues TMA
// (and, in K11, warp 0 stages lse and di). setmaxnreg gives the consumers
// 240 registers a thread and leaves the producer 24. Tiles reach shared
// memory by TMA into a ring of stages, each guarded by a "full" mbarrier
// (the producer's arrival with the expected bytes) and an "empty" one (all
// 256 consumer threads arrive once their wgmma reading the stage has
// retired), so the next tile's load overlaps this tile's math.
// - K10: a block per (b, h, 128-query tile), the heaviest (last) tiles
//   first. Q is loaded once; K and V tiles of 128 keys go through 2 stages.
//   S = Q K^T is wgmma m64n128k16 with A = Q and B = K, both K-major from
//   shared memory; the online softmax runs in registers (a row lives in one
//   thread quad: its max is 2 shuffles; l is summed per thread and reduced
//   once at the end); P is packed to bf16 A fragments in registers and
//   O += P V is wgmma m64n64k16 per 64 columns of D with B = V, MN-major
//   (transpose flag). The loop stops at the diagonal tile, the only one
//   masked.
// - K11: a block per (b, h, 128-key tile), walking the 64-query tiles from
//   the diagonal down, so every dK and dV row has one writer and no atomics
//   are needed: a run's bits do not depend on scheduling. K and V are
//   loaded once; Q, dO, lse and di of a query tile go through 2 stages.
//   S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 from shared memory;
//   P^T = exp(S^T scale - lse) and dS^T = P^T o (dP^T - di) in registers;
//   dV += P^T dO and dK += dS^T Q take A from registers as bf16 and B (dO,
//   Q) MN-major from shared memory. dV's product is issued before dP^T's,
//   so S^T and P's f32 values are dead by the time dS^T is formed and D 128
//   fits 240 registers: dK and dV hold 128 f32 a thread there.
// - K12: K11 with the roles of queries and keys swapped. A block per (b, h,
//   128-query tile), the heaviest first, as K10; each dQ row has one writer,
//   so no atomics. Q and dO of the tile are loaded once, lse and di of a
//   thread's two rows go into registers; K and V tiles go through 2 stages
//   up to the diagonal: 128 keys at D 64, 64 keys at D 128 (there dQ alone
//   is 64 f32 a thread, and S and dP of 128 keys would be 64 more each).
//   S = Q K^T and dP = dO V^T are issued together (wgmma from shared
//   memory, both K-major); P = exp(S scale - lse) and scale dS = scale P o
//   (dP - di) in registers, dS packed to bf16 A fragments; dQ += dS K is
//   wgmma m64n64k16 per 64 columns of D with B = the same K tile read
//   MN-major (transpose flag), as K10 reads V. Only tiles that reach past a
//   warpgroup's first row are masked, and a warpgroup skips a tile wholly
//   above its rows (at D 128 the diagonal 128 rows span two key tiles).
//
// The trouble spots, and what this design does about each:
// 1. TMA descriptors: built on the host for every launch by
//    cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint (the
//    library is not linked with -lcuda), and passed as
//    `const __grid_constant__ CUtensorMap` kernel parameters. Each operand
//    is a 4-D map {D, S, H, B} with byte strides (ss, sh, sb), which takes
//    the [B, H, S, D] and [B, S, H, D] storage orders alike; rows past S
//    arrive as zeros, which handles the ragged last tile. TMA needs strides
//    that are multiples of 16 bytes and a 16-byte-aligned base: the Python
//    wrapper (ops/attention.py, tma_strides) checks both and raises.
// 2. Swizzle: a D-64 bf16 row is 128 bytes, one 128-byte swizzle row; D 128
//    is loaded as two 64-column boxes, each its own swizzled tile, and a
//    K-major product steps into the second box after 4 k-steps. The wgmma
//    descriptors use the same 128-byte layout, and every box starts on a
//    1024-byte boundary (the dynamic shared memory is aligned by hand).
// 3. Register fragments: the masks, the row statistics and the f32-to-bf16
//    repack all index the wgmma accumulator layout (sm90.cuh), never the
//    scalar kernels' 16 x 16 thread grid.
// 4. wgmma ordering: wgmma_fence before every batch of wgmma (the first that
//    reads registers written by ordinary code included), commit, then
//    wait_group and fence_regs before any accumulator is read.
// 5. Tile edges: 128-row query or key tiles against 128-key, 64-key or
//    64-query stages; chip_smoke.py's phase 1 and tests/test_torch_gpu.py
//    hold all three kernels to their plain versions at S = 1, 63, 64, 65,
//    127, 128, 129, 257, 1000 and 1024.
//
// Layout: q, k, v, o, dO, dq, dk, dv are bf16 [B, H, S, D] with D
// contiguous and byte strides (ss, sh, sb); lse and di are [B, H, S] f32.
// Built by ops/_build.py with the other csrc/*.cu files; each entry point
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after its launch (1000 + a CUresult if a tensor map
// could not be made).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kWG = 128;               // threads of a warpgroup
constexpr int kThreads = 3 * kWG;      // two consumer warpgroups, one producer
constexpr int kConsumers = 2 * kWG;
constexpr int kBox = 64;               // bf16 columns of one swizzled box
constexpr int kRowBytes = 2 * kBox;    // 128
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// K10: 128 queries a block (64 a consumer warpgroup), 128 keys a stage.
constexpr int kFwdM = 128, kFwdN = 128;
// K11: 128 keys a block (64 a consumer warpgroup), 64 queries a stage.
constexpr int kBwdN = 128, kBwdM = 64;
// K12: 128 queries a block (64 a consumer warpgroup); keys a stage:
template <int D> __host__ __device__ constexpr int dq_keys() { return D == 64 ? 128 : 64; }
constexpr int kDqM = 128;

template <int D> constexpr int fwd_smem() {
  return 1024 + kFwdM * D * 2 + kStages * 2 * kFwdN * D * 2 + (1 + 2 * kStages) * 8;
}
template <int D> constexpr int dkv_smem() {
  return 1024 + 2 * kBwdN * D * 2 + kStages * (2 * kBwdM * D * 2 + 2 * kBwdM * 4) +
         (1 + 2 * kStages) * 8;
}
template <int D> constexpr int dq_smem() {
  return 1024 + 2 * kDqM * D * 2 + kStages * 2 * dq_keys<D>() * D * 2 + (1 + 2 * kStages) * 8;
}

// The dynamic shared memory, moved up to a 1024-byte boundary.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t s = smem_u32(raw);
  return raw + ((1024 - (s & 1023)) & 1023);
}

// max over the 4 threads of a quad (one accumulator row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

// Accumulator pairs (d[4j + 2 half], d[4j + 2 half + 1]) of `acc`, a 64 x 64
// block of columns c0 .., as bf16 pairs into row `row` (half 0) and row + 8
// (half 1) of `out`, a row stride `ss` elements; rows at or past S skipped.
__device__ __forceinline__ void store_rows(bf16* out, long long ss, int row, int S, int c0,
                                           const float (&acc)[32], float mul0, float mul1) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= S) continue;
    const float mul = half ? mul1 : mul0;
    bf16* dst = out + r * ss + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// K10  causal_attn_fwd_sm90
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
causal_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                            float* __restrict__ lse, int H, int S, long long ss, long long sh,
                            long long sb, float scale_log2) {
  constexpr int NB = D / kBox;             // boxes of a row
  constexpr int kQ = kFwdM * D * 2;        // bytes of the Q tile
  constexpr int kKV = kFwdN * D * 2;       // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = aligned_smem(smem_raw);
  uint8_t* skv = sq + kQ;                  // stage s: K at 2 s kKV, V at (2 s + 1) kKV
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + kStages * 2 * kKV);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int nq = (S + kFwdM - 1) / kFwdM;
  const int qt = nq - 1 - blockIdx.x;      // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * kFwdM;
  const int nkv = (q0 + kFwdM + kFwdN - 1) / kFwdN;  // key tiles up to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWG) {
      tma_prefetch_map(&mq);
      tma_prefetch_map(&mk);
      tma_prefetch_map(&mv);
      mbar_arrive_expect_tx(q_full, kQ);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_load_4d(sq + nb * kFwdM * kRowBytes, &mq, q_full, nb * kBox, q0, h, b);
      for (int kt = 0; kt < nkv; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * kKV);
        uint8_t* sk = skv + 2 * st * kKV;
        uint8_t* sv = sk + kKV;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(sk + nb * kFwdN * kRowBytes, &mk, &full[st], nb * kBox, kt * kFwdN, h, b);
          tma_load_4d(sv + nb * kFwdN * kRowBytes, &mv, &full[st], nb * kBox, kt * kFwdN, h, b);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % kWG, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const uint32_t sq_wg = smem_u32(sq) + 64 * wg * kRowBytes;

    float acc[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max, log2 domain
    float l[2] = {0.f, 0.f};               // this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < nkv; ++kt) {
      const int st = kt % kStages;
      const int k0 = kt * kFwdN;
      mbar_wait(&full[st], (kt / kStages) & 1);
      const uint32_t sk = smem_u32(skv + 2 * st * kKV);
      const uint32_t sv = sk + kKV;

      // S = Q K^T over D in k-steps of 16
      float s[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(s, desc_sw128(sq_wg + (kk / 4) * kFwdM * kRowBytes + off),
                 desc_sw128(sk + (kk / 4) * kFwdN * kRowBytes + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // mask (the diagonal tile only), scale into the log2 domain, row max
      const bool diag = kt == nkv - 1;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int half = (i % 4) / 2;
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        float x = s[i] * scale_log2;
        if (diag && col > row0 + 8 * half) x = -INFINITY;
        s[i] = x;
        mx[half] = fmaxf(mx[half], x);
      }
      // every row keeps key k0 <= row in each tile it visits, so mn is
      // finite; the first tile's alpha is exp2(-inf) = 0
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float mn = fmaxf(m[half], quad_max(mx[half]));
        alpha[half] = exp2f(m[half] - mn);
        m[half] = mn;
        l[half] *= alpha[half];
      }
      // P = exp2(x - m) in f32 into l; packed to bf16 A fragments for P V
      uint32_t pa[kFwdN / 16][4];
#pragma unroll
      for (int c = 0; c < kFwdN / 16; ++c) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * c + 2 * r;      // d[i], d[i + 1]: row half (r % 2)
          const int half = r % 2;
          const float p0 = exp2f(s[i] - m[half]);
          const float p1 = exp2f(s[i + 1] - m[half]);
          l[half] += p0 + p1;
          pa[c][r] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[nb][i] *= alpha[(i % 4) / 2];

      // O += P V: k over the tile's keys (16 rows of V a step), 64 columns
      // of D a wgmma
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kFwdN / 16; ++c)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          wgmma_rs_tb(acc[nb], pa[c],
                      desc_sw128(sv + nb * kFwdN * kRowBytes + c * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
      mbar_arrive(&empty[st]);
    }

    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float lt = quad_sum(l[half]);
      inv[half] = 1.f / lt;
      const int r = row0 + 8 * half;
      if (lane % 4 == 0 && r < S) lse[(long long)bh * S + r] = m[half] * kLn2 + logf(lt);
    }
    bf16* ob = o + b * sb + h * sh;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) store_rows(ob, ss, row0, S, nb * kBox, acc[nb], inv[0], inv[1]);
  }
}

// ---------------------------------------------------------------------------
// K11  causal_attn_bwd_dkv_sm90
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
causal_attn_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                const __grid_constant__ CUtensorMap mdo,
                                const float* __restrict__ lse, const float* __restrict__ di,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S,
                                long long ss, long long sh, long long sb, float scale,
                                float scale_log2) {
  constexpr int NB = D / kBox;
  constexpr int kKV = kBwdN * D * 2;       // bytes of the K or V tile
  constexpr int kQ = kBwdM * D * 2;        // bytes of one Q or dO tile
  constexpr int kStage = 2 * kQ;          // Q, dO of one stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = aligned_smem(smem_raw);
  uint8_t* sv = sk + kKV;
  uint8_t* stages = sv + kKV;              // stage s at s kStage: Q, then dO
  float* rowv = reinterpret_cast<float*>(stages + kStages * kStage);  // stage s: lse, di
  uint64_t* bars = reinterpret_cast<uint64_t*>(rowv + kStages * 2 * kBwdM);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int nq = (S + kBwdM - 1) / kBwdM;
  const int kt = blockIdx.x;               // the first tiles have the most work
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * kBwdN;
  const int qt0 = k0 / kBwdM;              // the first query tile with a query >= k0
  const long long rows = (long long)bh * S;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);             // the producer warp's 32 lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == 2 * kWG / 32) {
      if (lane == 0) {
        tma_prefetch_map(&mq);
        tma_prefetch_map(&mdo);
        mbar_arrive_expect_tx(kv_full, 2 * kKV);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(sk + nb * kBwdN * kRowBytes, &mk, kv_full, nb * kBox, k0, h, b);
          tma_load_4d(sv + nb * kBwdN * kRowBytes, &mv, kv_full, nb * kBox, k0, h, b);
        }
      }
      for (int qt = qt0; qt < nq; ++qt) {
        const int i = qt - qt0, st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        uint8_t* sq = stages + st * kStage;
        uint8_t* sdo = sq + kQ;
        float* slse = rowv + st * 2 * kBwdM;
        float* sdi = slse + kBwdM;
        // lse in the log2 domain and di of the tile's queries; 0 past S
        for (int r = lane; r < kBwdM; r += 32) {
          const int q = qt * kBwdM + r;
          slse[r] = q < S ? lse[rows + q] * kLog2e : 0.f;
          sdi[r] = q < S ? di[rows + q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], 2 * kQ);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            tma_load_4d(sq + nb * kBwdM * kRowBytes, &mq, &full[st], nb * kBox, qt * kBwdM, h, b);
            tma_load_4d(sdo + nb * kBwdM * kRowBytes, &mdo, &full[st], nb * kBox, qt * kBwdM,
                        h, b);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % kWG, warp = t / 32, lane = t % 32;
    const int key0 = k0 + 64 * wg + 16 * warp + lane / 4;  // and key0 + 8
    const uint32_t sk_wg = smem_u32(sk) + 64 * wg * kRowBytes;
    const uint32_t sv_wg = smem_u32(sv) + 64 * wg * kRowBytes;

    float dka[NB][32], dva[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[nb][i] = dva[nb][i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int qt = qt0; qt < nq; ++qt) {
      const int it = qt - qt0, st = it % kStages;
      const int q0 = qt * kBwdM;
      mbar_wait(&full[st], (it / kStages) & 1);
      uint8_t* stage = stages + st * kStage;
      const uint32_t sq = smem_u32(stage);
      const uint32_t sdo = sq + kQ;
      const float* slse = rowv + st * 2 * kBwdM;
      const float* sdi = slse + kBwdM;

      // S^T = K Q^T: rows keys, columns the tile's 64 queries
      float sT[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(sT, desc_sw128(sk_wg + (kk / 4) * kBwdN * kRowBytes + off),
                 desc_sw128(sq + (kk / 4) * kBwdM * kRowBytes + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);

      // P^T = exp2(S^T scale log2e - lse log2e), 0 where query < key or past S
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i % 4) / 2;
        const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int q = q0 + c;
        sT[i] = (q >= key0 + 8 * half && q < S) ? exp2f(sT[i] * scale_log2 - slse[c]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[c][r] = pack_bf16(sT[8 * c + 2 * r], sT[8 * c + 2 * r + 1]);

      // dV += P^T dO (bf16 P^T, as the reference rounds it), then
      // dP^T = V dO^T, both in flight together
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          wgmma_rs_tb(dva[nb], pa[c],
                      desc_sw128(sdo + nb * kBwdM * kRowBytes + c * 16 * kRowBytes));
      float dpT[32];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(dpT, desc_sw128(sv_wg + (kk / 4) * kBwdN * kRowBytes + off),
                 desc_sw128(sdo + (kk / 4) * kBwdM * kRowBytes + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpT);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(dva[nb]);

      // dS^T = P^T o (dP^T - di), packed to bf16 (as the reference rounds it)
      uint32_t dsa[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * c + 2 * r;
          const int col = 8 * (i / 4) + 2 * (lane % 4);
          dsa[c][r] = pack_bf16(sT[i] * (dpT[i] - sdi[col]),
                                sT[i + 1] * (dpT[i + 1] - sdi[col + 1]));
        }

      // dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          wgmma_rs_tb(dka[nb], dsa[c],
                      desc_sw128(sq + nb * kBwdM * kRowBytes + c * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(dka[nb]);
      mbar_arrive(&empty[st]);
    }

    const long long base = b * sb + h * sh;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      store_rows(dk + base, ss, key0, S, nb * kBox, dka[nb], scale, scale);
      store_rows(dv + base, ss, key0, S, nb * kBox, dva[nb], 1.f, 1.f);
    }
  }
}

// ---------------------------------------------------------------------------
// K12  causal_attn_bwd_dq_sm90
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
causal_attn_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mdo,
                               const float* __restrict__ lse, const float* __restrict__ di,
                               bf16* __restrict__ dq, int H, int S, long long ss, long long sh,
                               long long sb, float scale, float scale_log2) {
  constexpr int NB = D / kBox;
  constexpr int N = dq_keys<D>();          // keys a stage
  constexpr int kQ = kDqM * D * 2;         // bytes of the Q or dO tile
  constexpr int kKV = N * D * 2;           // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = aligned_smem(smem_raw);
  uint8_t* sdo = sq + kQ;
  uint8_t* skv = sdo + kQ;                 // stage s: K at 2 s kKV, V at (2 s + 1) kKV
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + kStages * 2 * kKV);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int nq = (S + kDqM - 1) / kDqM;
  const int qt = nq - 1 - blockIdx.x;      // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * kDqM;
  const int nkv = (min(S, q0 + kDqM) + N - 1) / N;  // key tiles up to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWG) {
      tma_prefetch_map(&mk);
      tma_prefetch_map(&mv);
      mbar_arrive_expect_tx(q_full, 2 * kQ);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(sq + nb * kDqM * kRowBytes, &mq, q_full, nb * kBox, q0, h, b);
        tma_load_4d(sdo + nb * kDqM * kRowBytes, &mdo, q_full, nb * kBox, q0, h, b);
      }
      for (int kt = 0; kt < nkv; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * kKV);
        uint8_t* sk = skv + 2 * st * kKV;
        uint8_t* sv = sk + kKV;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(sk + nb * N * kRowBytes, &mk, &full[st], nb * kBox, kt * N, h, b);
          tma_load_4d(sv + nb * N * kRowBytes, &mv, &full[st], nb * kBox, kt * N, h, b);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % kWG, warp = t / 32, lane = t % 32;
    const int first = q0 + 64 * wg;                    // this warpgroup's first row
    const int row0 = first + 16 * warp + lane / 4;     // and row0 + 8
    const uint32_t sq_wg = smem_u32(sq) + 64 * wg * kRowBytes;
    const uint32_t sdo_wg = smem_u32(sdo) + 64 * wg * kRowBytes;

    // lse in the log2 domain and di of the thread's two rows; 0 past S
    float lse2[2], dir[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      lse2[half] = r < S ? lse[(long long)bh * S + r] * kLog2e : 0.f;
      dir[half] = r < S ? di[(long long)bh * S + r] : 0.f;
    }

    float dqa[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[nb][i] = 0.f;

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < nkv; ++kt) {
      const int st = kt % kStages;
      const int k0 = kt * N;
      mbar_wait(&full[st], (kt / kStages) & 1);
      if (k0 > first + 63) {               // wholly above this warpgroup's rows
        mbar_arrive(&empty[st]);
        continue;
      }
      const uint32_t sk = smem_u32(skv + 2 * st * kKV);
      const uint32_t sv = sk + kKV;

      // S = Q K^T and dP = dO V^T over D in k-steps of 16, in flight together
      float s[N / 2], dp[N / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(s, desc_sw128(sq_wg + (kk / 4) * kDqM * kRowBytes + off),
                 desc_sw128(sk + (kk / 4) * N * kRowBytes + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(dp, desc_sw128(sdo_wg + (kk / 4) * kDqM * kRowBytes + off),
                 desc_sw128(sv + (kk / 4) * N * kRowBytes + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = exp2(S scale log2e - lse log2e), 0 where key > query or past S;
      // scale dS = scale P o (dP - di) in f32, packed to bf16 A fragments
      // (the reference's ds * sm_scale, then ds.astype(k.dtype))
      const bool masked = k0 + N - 1 > first;
      uint32_t dsa[N / 16][4];
#pragma unroll
      for (int c = 0; c < N / 16; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * c + 2 * r;     // d[i], d[i + 1]: row half (r % 2)
          const int half = r % 2;
          const int row = row0 + 8 * half;
          const int col = k0 + 8 * (i / 4) + 2 * (lane % 4);
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool keep = (!masked || col + e <= row) && row < S;
            const float p = keep ? exp2f(s[i + e] * scale_log2 - lse2[half]) : 0.f;
            ds[e] = p * (dp[i + e] - dir[half]) * scale;
          }
          dsa[c][r] = pack_bf16(ds[0], ds[1]);
        }

      // dQ += dS K: k over the tile's keys (16 rows of K a step), 64 columns
      // of D a wgmma
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < N / 16; ++c)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          wgmma_rs_tb(dqa[nb], dsa[c], desc_sw128(sk + nb * N * kRowBytes + c * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(dqa[nb]);
      mbar_arrive(&empty[st]);
    }

    bf16* dqb = dq + b * sb + h * sh;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) store_rows(dqb, ss, row0, S, nb * kBox, dqa[nb], 1.f, 1.f);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int S, long long ss, long long sh, long long sb, float scale,
               cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = sm90_host::make_map(&mq, q, B, H, S, D, ss, sh, sb, kFwdM))) return rc;
  if ((rc = sm90_host::make_map(&mk, k, B, H, S, D, ss, sh, sb, kFwdN))) return rc;
  if ((rc = sm90_host::make_map(&mv, v, B, H, S, D, ss, sh, sb, kFwdN))) return rc;
  constexpr int bytes = fwd_smem<D>();
  auto kern = causal_attn_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kFwdM - 1) / kFwdM, B * H);
  // element strides for the output's plain stores
  kern<<<grid, kThreads, bytes, stream>>>(mq, mk, mv, (bf16*)o, (float*)lse, H, S, ss / 2,
                                          sh / 2, sb / 2, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, void* dk, void* dv, int B, int H, int S, long long ss,
               long long sh, long long sb, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc;
  if ((rc = sm90_host::make_map(&mq, q, B, H, S, D, ss, sh, sb, kBwdM))) return rc;
  if ((rc = sm90_host::make_map(&mk, k, B, H, S, D, ss, sh, sb, kBwdN))) return rc;
  if ((rc = sm90_host::make_map(&mv, v, B, H, S, D, ss, sh, sb, kBwdN))) return rc;
  if ((rc = sm90_host::make_map(&mdo, dout, B, H, S, D, ss, sh, sb, kBwdM))) return rc;
  constexpr int bytes = dkv_smem<D>();
  auto kern = causal_attn_bwd_dkv_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBwdN - 1) / kBwdN, B * H);
  kern<<<grid, kThreads, bytes, stream>>>(mq, mk, mv, mdo, (const float*)lse, (const float*)di,
                                          (bf16*)dk, (bf16*)dv, H, S, ss / 2, sh / 2, sb / 2,
                                          scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* di, void* dq, int B, int H, int S, long long ss, long long sh,
              long long sb, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc;
  if ((rc = sm90_host::make_map(&mq, q, B, H, S, D, ss, sh, sb, kDqM))) return rc;
  if ((rc = sm90_host::make_map(&mk, k, B, H, S, D, ss, sh, sb, dq_keys<D>()))) return rc;
  if ((rc = sm90_host::make_map(&mv, v, B, H, S, D, ss, sh, sb, dq_keys<D>()))) return rc;
  if ((rc = sm90_host::make_map(&mdo, dout, B, H, S, D, ss, sh, sb, kDqM))) return rc;
  constexpr int bytes = dq_smem<D>();
  auto kern = causal_attn_bwd_dq_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kDqM - 1) / kDqM, B * H);
  kern<<<grid, kThreads, bytes, stream>>>(mq, mk, mv, mdo, (const float*)lse, (const float*)di,
                                          (bf16*)dq, H, S, ss / 2, sh / 2, sb / 2, scale,
                                          scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ss, sh, sb: byte strides of a position, a head and a batch, shared by
// every [B, H, S, D] operand (multiples of 16, checked by the caller)
int lac_attn_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                      int H, int S, int D, long long ss, long long sh, long long sb,
                      float scale, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, H, S, ss, sh, sb, scale, (cudaStream_t)stream);
  if (D == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, H, S, ss, sh, sb, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

int lac_attn_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* di, void* dk, void* dv, int B, int H,
                          int S, int D, long long ss, long long sh, long long sb, float scale,
                          void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, di, dk, dv, B, H, S, ss, sh, sb, scale,
                          (cudaStream_t)stream);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, di, dk, dv, B, H, S, ss, sh, sb, scale,
                           (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

int lac_attn_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* di, void* dq, int B, int H, int S, int D,
                         long long ss, long long sh, long long sb, float scale, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, di, dq, B, H, S, ss, sh, sb, scale,
                         (cudaStream_t)stream);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, di, dq, B, H, S, ss, sh, sb, scale,
                          (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
