// Causal softmax attention for Hopper (sm_90a), forward and backward: the
// kernels of the training path's fused attention.
//
//   K10 causal_attn_fwd_kernel      O = softmax(Q K^T * scale, causal) V, and
//                                   lse = m + log(l) per query row
//   K11 causal_attn_bwd_dkv_kernel  dK, dV
//   K12 causal_attn_bwd_dq_kernel   dQ
//
// They replace the library Pallas kernels that lac_tpu's training prefill
// reaches (lac_tpu/models/transformer.py:706-768), in
// jax/experimental/pallas/ops/tpu/ of JAX 0.9.0:
//   flash_attention.py  _flash_attention_impl :589 (pallas_call :758),
//                       _flash_attention_bwd_dkv :941 (:1121),
//                       _flash_attention_bwd_dq :1287 (:1456);
//   splash_attention_kernel.py  _splash_attention_forward :895 (:1137),
//                       _splash_attention_bwd_dq :1405 (:1635),
//                       _splash_attention_bwd_dkv :1857 (:2196).
// splash is the same function with the scale folded into q before the call
// (transformer.py:715), so it runs these kernels with scale 1. The plain
// PyTorch versions in ops/attention.py repeat this arithmetic in f32.
//
// The math, per (batch, head), rows i (queries) and columns j (keys), j <= i:
//   s = q_i . k_j * scale;  lse_i = log sum_j exp(s_ij);  P = exp(s - lse)
//   O = P V;  dV = P^T dO;  dP = dO V^T;  dS = P o (dP - di);
//   dQ = scale * dS K;  dK = scale * dS^T Q,  with di = sum_d O o dO (the
// caller's, in f32, as the library computes it outside its kernels).
// A masked score is -inf before the exponential, so it adds exactly 0.
//
// Which inputs run here: f32 inputs only. bf16 K10-K12 run on the tensor
// cores (causal_attn_sm90.cu); f32 stays on these kernels because tensor
// cores on f32 inputs mean TF32, which the f32 tolerance of 1e-4 does not
// admit.
//
// Bound on this card for f32 inputs: the operations, 2, 4 and 3 causal
// products of B H D S (S + 1) flops each at the CUDA cores' f32 rate,
// against the traffic (derived in chip_smoke.py). These kernels are the
// simple version: every product is scalar f32 FMAs from shared memory, so
// they are bound by shared-memory loads and FMA issue.
//
// Design: a block is 256 threads, a 16 x 16 grid (ty, tx), and works on
// 64-row tiles. Every product of two tiles in shared memory (f32, rows
// padded by one float so no two threads of a half-warp hit one bank) gives
// each thread the 4 rows ty + 16 i and the columns tx + 16 j of its result,
// in registers. A score row thus lies in the 16 threads of one half-warp,
// so its max and sum are 4 shuffles, and the online softmax rescales the
// thread's own output rows with no other exchange.
// - K10: a block per (b, h, query tile); the key tiles up to the diagonal
//   pass through shared memory, with an online softmax (m, l per row).
//   Tiles above the diagonal are skipped; the diagonal tile is masked.
// - K11: a block per (b, h, key tile); it walks the query tiles from the
//   diagonal on, recomputes P from lse, and sums dV and dK in registers.
// - K12: a block per (b, h, query tile); it walks the key tiles up to the
//   diagonal and sums dQ in registers.
// The split needs no atomics, so every run gives the same bits.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, H, S, D] with D contiguous,
// batch stride H S D and element strides (sh, ss) for head and position,
// so both [B, H, S, D] and [B, S, H, D] storage pass without a copy; lse
// and di are [B, H, S] f32. Any S; the last tile is ragged (rows past S
// load as 0 and are not written). D is 64 or 128. All sums and statistics
// are f32.
//
// Built by ops/_build.py with the other csrc/*.cu files into one library
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3) and bound
// with ctypes. Each entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError() after its launch. No PyTorch
// header is included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                  // rows of a query or key tile
constexpr int kSide = 16;                  // the thread grid is kSide x kSide
constexpr int kThreads = kSide * kSide;    // 256
constexpr int kRows = kTile / kSide;       // 4 rows a thread
constexpr int kPitchT = kTile + 1;         // row pitch of a [64][64] tile
constexpr unsigned kAll = 0xFFFFFFFFu;


// max and sum over the 16 threads of a half-warp (one score row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kAll, x, off);
  return x;
}

// Rows r0 .. r0 + 63 of one (b, h) slice into a [64][D + 1] f32 tile in
// shared memory; rows at or past S load as 0. Neighbouring threads read
// neighbouring elements of a row.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          long long base, long long ss, int r0, int S) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int s = r0 + r;
    dst[r * (D + 1) + c] = s < S ? src[base + s * ss + c] : 0.f;
  }
}

// acc[i][j] += sum_{k < K} A(ty + 16 i, k) * B(k, tx + 16 j), with
// A(r, k) = a[r * lda + k] (a[k * lda + r] when AT) and
// B(k, c) = b[k * ldb + c] (b[c * ldb + k] when BT).
template <int NI, int NJ, int K, bool AT, bool BT>
__device__ __forceinline__ void tile_fma(float (&acc)[NI][NJ], const float* __restrict__ a,
                                         int lda, const float* __restrict__ b, int ldb) {
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[NI], bv[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = ty + kSide * i;
      av[i] = AT ? a[k * lda + r] : a[r * lda + k];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + kSide * j;
      bv[j] = BT ? b[c * ldb + k] : b[k * ldb + c];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// Shared-memory floats of each kernel, for D.
constexpr int fwd_floats(int d) { return 3 * kTile * (d + 1) + kTile * kPitchT; }
constexpr int dkv_floats(int d) { return 4 * kTile * (d + 1) + 2 * kTile * kPitchT + 2 * kTile; }
constexpr int dq_floats(int d) { return 4 * kTile * (d + 1) + kTile * kPitchT; }

// ---------------------------------------------------------------------------
// K10  causal_attn_fwd
// Replaces the forward Pallas kernels of flash attention
// (_flash_attention_impl, flash_attention.py:589, pallas_call :758) and of
// splash attention (_splash_attention_forward, splash_attention_kernel.py:895,
// pallas_call :1137). Grid: (query tiles, B * H); the heaviest tiles (the
// last, with the most key tiles under them) are started first.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
causal_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                       int H, int S, long long sh, long long ss, float scale) {
  constexpr int P = D + 1;
  constexpr int NJ = D / kSide;
  extern __shared__ float smem[];
  float* sq = smem;                 // [64][P] queries
  float* sk = sq + kTile * P;       // [64][P] keys
  float* sv = sk + kTile * P;       // [64][P] values
  float* sp = sv + kTile * P;       // [64][kPitchT] probabilities of this key tile

  const int nq = (S + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = (long long)b * H * S * D + h * sh;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int q0 = qt * kTile;

  load_tile<D>(sq, q, base, ss, q0, S);
  float acc[kRows][NJ];
  zero(acc);
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers of sk, sv, sp are done
    load_tile<D>(sk, k, base, ss, k0, S);
    load_tile<D>(sv, v, base, ss, k0, S);
    __syncthreads();
    float s[kRows][kRows];
    zero(s);
    tile_fma<kRows, kRows, D, false, true>(s, sq, P, sk, P);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kSide * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int col = k0 + tx + kSide * j;
        s[i][j] = (col <= row && col < S) ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      // every row has an unmasked key in every tile it visits (key k0 <= row
      // and k0 < S), so mn is finite; the first tile's alpha is exp(-inf) = 0
      const float mn = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        sp[(ty + kSide * i) * kPitchT + tx + kSide * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_fma<kRows, NJ, kTile, false, false>(acc, sp, kPitchT, sv, P);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kSide * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[base + row * ss + tx + kSide * j] = acc[i][j] / l[i];
    if (tx == 0) lse[(long long)bh * S + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// K11  causal_attn_bwd_dkv
// Replaces _flash_attention_bwd_dkv (flash_attention.py:941, pallas_call
// :1121) and _splash_attention_bwd_dkv (splash_attention_kernel.py:1857,
// pallas_call :2196). Grid: (key tiles, B * H); key tile kt visits query
// tiles kt .. nq - 1, so the first tiles are the heaviest and start first.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
causal_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           float* __restrict__ dk, float* __restrict__ dv, int H, int S,
                           long long sh, long long ss, float scale) {
  constexpr int P = D + 1;
  constexpr int NJ = D / kSide;
  extern __shared__ float smem[];
  float* sk = smem;                 // [64][P] keys of this block
  float* sv = sk + kTile * P;       // [64][P] values of this block
  float* sq = sv + kTile * P;       // [64][P] queries of the current tile
  float* sdo = sq + kTile * P;      // [64][P] dO of the current tile
  float* sp = sdo + kTile * P;      // [64][kPitchT] P, [query][key]
  float* sds = sp + kTile * kPitchT;  // [64][kPitchT] dS, [query][key]
  float* slse = sds + kTile * kPitchT;  // [64]
  float* sdi = slse + kTile;            // [64]

  const int nq = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = (long long)b * H * S * D + h * sh;
  const long long row0 = (long long)bh * S;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int k0 = kt * kTile;

  load_tile<D>(sk, k, base, ss, k0, S);
  load_tile<D>(sv, v, base, ss, k0, S);
  float dk_acc[kRows][NJ], dv_acc[kRows][NJ];  // rows: keys ty + 16 i
  zero(dk_acc);
  zero(dv_acc);

  for (int qt = kt; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's readers of sq, sdo, sp, sds are done
    load_tile<D>(sq, q, base, ss, q0, S);
    load_tile<D>(sdo, dout, base, ss, q0, S);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      slse[threadIdx.x] = row < S ? lse[row0 + row] : 0.f;
      sdi[threadIdx.x] = row < S ? di[row0 + row] : 0.f;
    }
    __syncthreads();
    float s[kRows][kRows], dp[kRows][kRows];  // rows: queries, columns: keys
    zero(s);
    zero(dp);
    tile_fma<kRows, kRows, D, false, true>(s, sq, P, sk, P);
    tile_fma<kRows, kRows, D, false, true>(dp, sdo, P, sv, P);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kSide * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kSide * j, col = k0 + c;
        const float p = (col <= row && row < S) ? expf(s[i][j] * scale - slse[r]) : 0.f;
        sp[r * kPitchT + c] = p;
        sds[r * kPitchT + c] = p * (dp[i][j] - sdi[r]);
      }
    }
    __syncthreads();
    tile_fma<kRows, NJ, kTile, true, false>(dv_acc, sp, kPitchT, sdo, P);
    tile_fma<kRows, NJ, kTile, true, false>(dk_acc, sds, kPitchT, sq, P);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty + kSide * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long at = base + row * ss + tx + kSide * j;
      dk[at] = dk_acc[i][j] * scale;
      dv[at] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// K12  causal_attn_bwd_dq
// Replaces _flash_attention_bwd_dq (flash_attention.py:1287, pallas_call
// :1456) and _splash_attention_bwd_dq (splash_attention_kernel.py:1405,
// pallas_call :1635). Grid: (query tiles, B * H), heaviest first as in K10.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
causal_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dq, int H, int S, long long sh, long long ss,
                          float scale) {
  constexpr int P = D + 1;
  constexpr int NJ = D / kSide;
  extern __shared__ float smem[];
  float* sq = smem;                 // [64][P] queries of this block
  float* sdo = sq + kTile * P;      // [64][P] dO of this block
  float* sk = sdo + kTile * P;      // [64][P] keys of the current tile
  float* sv = sk + kTile * P;       // [64][P] values of the current tile
  float* sds = sv + kTile * P;      // [64][kPitchT] dS, [query][key]

  const int nq = (S + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = (long long)b * H * S * D + h * sh;
  const long long row0 = (long long)bh * S;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int q0 = qt * kTile;

  load_tile<D>(sq, q, base, ss, q0, S);
  load_tile<D>(sdo, dout, base, ss, q0, S);
  float lse_r[kRows], di_r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kSide * i;
    lse_r[i] = row < S ? lse[row0 + row] : 0.f;
    di_r[i] = row < S ? di[row0 + row] : 0.f;
  }
  float acc[kRows][NJ];  // rows: queries ty + 16 i
  zero(acc);

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers of sk, sv, sds are done
    load_tile<D>(sk, k, base, ss, k0, S);
    load_tile<D>(sv, v, base, ss, k0, S);
    __syncthreads();
    float s[kRows][kRows], dp[kRows][kRows];
    zero(s);
    zero(dp);
    tile_fma<kRows, kRows, D, false, true>(s, sq, P, sk, P);
    tile_fma<kRows, kRows, D, false, true>(dp, sdo, P, sv, P);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kSide * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kSide * j, col = k0 + c;
        const float p = (col <= row && row < S) ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sds[r * kPitchT + c] = p * (dp[i][j] - di_r[i]);
      }
    }
    __syncthreads();
    tile_fma<kRows, NJ, kTile, false, false>(acc, sds, kPitchT, sk, P);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kSide * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[base + row * ss + tx + kSide * j] = acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// Launches: one instantiation per D, of the f32 kernels.
// ---------------------------------------------------------------------------

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int S, long long sh, long long ss, float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * fwd_floats(D);
  auto kern = causal_attn_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kern<<<grid, kThreads, bytes, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                          (float*)o, (float*)lse, H, S, sh, ss, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, void* dk, void* dv, int B, int H, int S, long long sh,
               long long ss, float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * dkv_floats(D);
  auto kern = causal_attn_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kern<<<grid, kThreads, bytes, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                          (const float*)dout, (const float*)lse, (const float*)di,
                                          (float*)dk, (float*)dv, H, S, sh, ss, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* di, void* dq, int B, int H, int S, long long sh, long long ss,
              float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * dq_floats(D);
  auto kern = causal_attn_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kern<<<grid, kThreads, bytes, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                          (const float*)dout, (const float*)lse, (const float*)di,
                                          (float*)dq, H, S, sh, ss, scale);
  return (int)cudaGetLastError();
}

// D -> the instantiation; any other D, or an empty shape, is
// cudaErrorInvalidValue
#define LAC_ATTN_DISPATCH(FN, ...)                                              \
  if (S <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;            \
  if (D == 64) return FN<64>(__VA_ARGS__);                                      \
  if (D == 128) return FN<128>(__VA_ARGS__);                                    \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// f32 only: bf16 K10-K12 are causal_attn_sm90.cu's
int lac_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                 int S, int D, long long sh, long long ss, float scale, void* stream) {
  LAC_ATTN_DISPATCH(launch_fwd, q, k, v, o, lse, B, H, S, sh, ss, scale,
                    (cudaStream_t)stream)
}

int lac_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, void* dk, void* dv, int B, int H, int S,
                     int D, long long sh, long long ss, float scale, void* stream) {
  LAC_ATTN_DISPATCH(launch_dkv, q, k, v, dout, lse, di, dk, dv, B, H, S, sh, ss, scale,
                    (cudaStream_t)stream)
}

int lac_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* di, void* dq, int B, int H, int S, int D,
                    long long sh, long long ss, float scale, void* stream) {
  LAC_ATTN_DISPATCH(launch_dq, q, k, v, dout, lse, di, dq, B, H, S, sh, ss, scale,
                    (cudaStream_t)stream)
}

// dynamic shared-memory bytes a block of kernel `which` (10, 11, 12) uses at
// head dim D; 0 for anything else
int lac_attn_smem_bytes(int which, int D) {
  if (D != 64 && D != 128) return 0;
  const int f = which == 10 ? fwd_floats(D) : which == 11 ? dkv_floats(D)
              : which == 12 ? dq_floats(D) : 0;
  return (int)sizeof(float) * f;
}

}  // extern "C"
