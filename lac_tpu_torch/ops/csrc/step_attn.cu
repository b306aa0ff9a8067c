// The cached decode step's attention for Hopper (sm_90a): one query position
// of every lane against the layer's K/V cache and the step's fresh K/V.
//
//   step_attn_kernel   o = softmax(q [K_cache; k] * scale) [V_cache; v]
//
// It replaces no TPU kernel: lac_tpu's cached step is plain jnp that XLA
// fuses (lac_tpu/models/transformer.py, the prefill=False branch of
// _attention), with no pallas_call. It was added because the port's torch
// route (models/transformer.py, _attend_float) copied the layer's whole
// cache slice, live or not, into a new f32 tensor for K and for V at every
// step and layer, then ran some 20 small kernels over the copies: the
// copies took over a third of the card's time in a coding call.
//
// The math, per lane b, KV head g and each of its R query heads r (heads
// g R + r), over the live cache slots w < L = min(pos, W) and the fresh
// row, index L:
//   s_w = (q . k_w) * scale, f32 dots of the stored values;
//   p = softmax(s) in f32, over the L + 1 scores, each p_w rounded to T;
//   o = sum_w p_w v_w in f32, rounded once to T.
// The slots w >= L are those the float route masks to -inf, whose
// probabilities are exactly 0 there: skipping them is the same math.
// ops/step_attention.py's plain version is that route.
//
// Bound on this card: the bytes. A block reads its live K/V rows once (2 L
// Dh elements) and the FLOPs are 4 R Dh a row, far under the tensor cores'
// line, so the kernel is built to stream the live rows at the HBM rate.
//
// Design: one block of 256 threads per (b, g) and group of at most 8 of
// g's query heads (R <= 8: one group, all of them; R = 12: two of 6), so a
// block holds its queries in registers and only R > 8 reads a KV head's
// rows more than once. A thread owns one 16-byte chunk of a row (8 bf16
// or 4 f32 values): tpr threads, the row's chunks rounded up to a power of
// two up to 32, hold a row, the last chunk masked where Dh does not fill
// it, and a warp loads 32 / tpr neighbouring rows: each row's Dh *
// sizeof(T) bytes are contiguous in the cache's [B, W, KVH, Dh] layout,
// read in place, 16 bytes a load where every row starts 16-byte aligned
// and a value a load where one does not (a head dim such as 100 in bf16).
// L comes from pos in device memory, so a captured graph serves every
// position at its width.
//   1. The group's queries' chunks sit in registers. Each thread loads 4
//      rows' chunks before it uses them (4 x 16 bytes in flight), takes
//      the partial dots, sums them over its row's threads by shuffles and
//      writes the scaled scores, [G][W + 1] f32, to shared memory, or,
//      where they do not fit it (G (W + 1) over the device's shared memory
//      a block, W past 58,000 on the H100 at one query head), to the
//      block's slice of a scratch buffer in global memory, the same math.
//   2. A warp per query head: the row's max, exp and sum by shuffles, then
//      the probabilities rounded to T, in place.
//   3. Each thread sums p_w v_w over its rows into G x 16 bytes of f32
//      accumulators; the rows of a warp are summed by shuffles, the warps'
//      sums in warp order through shared memory, then rounded to T.
// Every sum runs in an order fixed by the shapes (never by the grouping or
// by where the scores live), with no atomics, so two calls give the same
// bits and the encoder and the decoder agree.
//
// Layout: q [B, 1, H, Dh], k and v [B, 1, KVH, Dh] with element strides
// for a lane and a head (the projections' or RoPE's views, no copy); the
// cache slices [B, W, KVH, Dh] contiguous; o [B, 1, H, Dh] contiguous. T is
// bf16 or f32; a row is at most 512 bytes (Dh 256 in bf16, 128 in f32),
// one warp's chunks. Few instantiations (lac_step_attn lists them), since
// the LM path's first call waits for this file's build: bf16's aligned rows
// at a group of one query head (MHA) and of 2-8 (GQA, MQA), f32's at 1-8,
// and one kernel a type for unaligned rows, a value a load and no unrolling.
// With two more, for groups of 2 and 4, the build took 6.1 s on the H100's
// host against 4.85 s.
//
// Built by ops/_build.py with the other csrc/*.cu files into one library
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3) and bound
// with ctypes. lac_step_attn_scratch says what scratch a launch needs;
// lac_step_attn launches on the given stream, does not synchronise, and
// returns cudaGetLastError() after its launch. No PyTorch header is
// included.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // rows a thread loads before it uses them
constexpr int kMaxGroup = 8;    // query heads a block
constexpr int kMaxRowBytes = 512;  // 32 chunks of 16 bytes: a warp's
constexpr size_t kDefaultSmem = 48 * 1024;  // without cudaFuncSetAttribute
constexpr unsigned kAll = 0xFFFFFFFFu;

// 16 bytes of T, widened to f32
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void load16(const float* p, float (&x)[N]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  }
  __device__ static float widen(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load16(const __nv_bfloat16* p, float (&x)[N]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of its f32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  __device__ static float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

// the chunk at p, of which nv > 0 values lie in the row: VEC, one 16-byte
// load (the rows aligned, every chunk whole), else a value a load. The
// choice is the kernel's template argument, not a test at each load: with
// the test inside the row loops the 64-lane, Dh 64 step took 1.45x the time
// on the H100, its loads no longer in flight together.
template <bool VEC, typename T>
__device__ __forceinline__ void load(const T* p, float (&x)[Chunk<T>::N], int nv) {
  using C = Chunk<T>;
  if constexpr (VEC) {
    C::load16(p, x);
  } else {
#pragma unroll
    for (int e = 0; e < C::N; ++e) x[e] = e < nv ? C::widen(p[e]) : 0.f;
  }
}

template <typename T, int MAXR, bool VEC>
__global__ void __launch_bounds__(kThreads)
step_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ ck, const T* __restrict__ cv,
                 const long long* __restrict__ pos, T* __restrict__ o,
                 float* __restrict__ scratch, int kvh, int R, int G, int ng, int W, int D,
                 int tpr_log, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                 long long v_sb, long long v_sh, float scale) {
  using C = Chunk<T>;
  constexpr int N = C::N;
  constexpr int U = VEC ? kUnroll : 1;  // the unaligned rows' kernel, kept small
  extern __shared__ float smem[];
  const int bg = blockIdx.x / ng, rg = blockIdx.x % ng;
  const int b = bg / kvh, g = bg % kvh;
  const int r0 = rg * G, Rb = R - r0 < G ? R - r0 : G;  // the block's query heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tpr = 1 << tpr_log;
  const int c = lane & (tpr - 1);          // the thread's chunk of a row
  const int nv = D - c * N;                // its values in the row
  const bool has = nv > 0;                 // (none: a masked chunk)
  const int j = tid >> tpr_log;            // its row within a pass
  const int rows = kThreads >> tpr_log;    // rows a pass
  const long long p = *pos;
  const int live = p < W ? (int)p : W;     // cache slots w < min(pos, W)
  const int n = live + 1;                  // and the fresh row, index live
  const int pitch = W + 1;
  const long long c_sw = (long long)kvh * D;
  const long long c_at = (long long)b * W * c_sw + (long long)g * D + c * N;
  const T* k_row = k + b * k_sb + g * k_sh + c * N;
  const T* v_row = v + b * v_sb + g * v_sh + c * N;
  float* sc = scratch ? scratch + (long long)blockIdx.x * G * pitch : smem;  // the scores

  // 1. scores
  float qx[MAXR][N];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < Rb && has) {
      load<VEC>(q + b * q_sb + (long long)(g * R + r0 + r) * q_sh + c * N, qx[r], nv);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) qx[r][e] = 0.f;
    }
  }
  for (int base = 0; base < n; base += rows * U) {
    float x[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = base + u * rows + j;
      if (has && w < live) {
        load<VEC>(ck + c_at + w * c_sw, x[u], nv);
      } else if (has && w == live) {
        load<VEC>(k_row, x[u], nv);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) x[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = base + u * rows + j;
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r >= Rb) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) s = fmaf(qx[r][e], x[u][e], s);
        for (int off = tpr >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(kAll, s, off);
        if (c == 0 && w < n) sc[r * pitch + w] = s * scale;
      }
    }
  }
  __syncthreads();

  // 2. softmax, a warp per query head; lane i % 32 owns score i throughout
  for (int r = warp; r < Rb; r += kWarps) {
    float* row = sc + r * pitch;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, row[i]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kAll, m, off));
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(row[i] - m);
      row[i] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kAll, sum, off);
    for (int i = lane; i < n; i += 32) row[i] = C::round(row[i] / sum);
  }
  __syncthreads();

  // 3. the probabilities times V
  float acc[MAXR][N];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[r][e] = 0.f;
  }
  for (int base = 0; base < n; base += rows * U) {
    float x[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = base + u * rows + j;
      if (has && w < live) {
        load<VEC>(cv + c_at + w * c_sw, x[u], nv);
      } else if (has && w == live) {
        load<VEC>(v_row, x[u], nv);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) x[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = base + u * rows + j;
      if (w < n) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r >= Rb) break;
          const float pr = sc[r * pitch + w];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[r][e] = fmaf(pr, x[u][e], acc[r][e]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r >= Rb) break;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      for (int off = tpr; off < 32; off <<= 1) acc[r][e] += __shfl_xor_sync(kAll, acc[r][e], off);
    }
  }
  __syncthreads();  // every probability read: the scores' memory takes the warps' sums
  if (lane < tpr) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r >= Rb) break;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (e < nv) smem[(warp * Rb + r) * D + c * N + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  T* out = o + (((long long)b * kvh + g) * R + r0) * D;
  for (int i = tid; i < Rb * D; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[w * Rb * D + i];
    out[i] = C::store(s);
  }
}

// How a launch at these shapes runs: G query heads a block in ng groups,
// the scores in shared memory or (global) in a scratch buffer of
// scratch_floats, and the block's dynamic shared memory: the scores
// [G][W + 1] unless global, then the warps' sums [kWarps][G][D] in the
// same bytes. Returns false where the kernel does not take the shapes.
struct Plan {
  int G, ng, tpr_log;
  bool global;
  size_t smem;
  long long scratch_floats;
};

bool plan(int B, int kvh, int R, int W, int D, int bf16, Plan* out) {
  const int row_bytes = D * (bf16 ? 2 : 4);
  if (B <= 0 || kvh <= 0 || W <= 0 || R < 1 || D < 1 || row_bytes > kMaxRowBytes) return false;
  int max_smem = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return false;
  Plan& p = *out;
  p.ng = (R + kMaxGroup - 1) / kMaxGroup;
  p.G = (R + p.ng - 1) / p.ng;
  p.tpr_log = 0;
  while ((16 << p.tpr_log) < row_bytes) ++p.tpr_log;
  const size_t scores = sizeof(float) * p.G * ((size_t)W + 1);
  const size_t sums = sizeof(float) * kWarps * p.G * D;
  p.global = scores > (size_t)max_smem;
  p.smem = p.global || sums > scores ? sums : scores;
  p.scratch_floats = p.global ? (long long)B * kvh * p.ng * p.G * ((long long)W + 1) : 0;
  return p.scratch_floats <= INT_MAX;
}

template <typename T, int MAXR, bool VEC>
int launch(const Plan& pl, const void* q, const void* k, const void* v, const void* ck,
           const void* cv, const void* pos, void* o, void* scratch, int B, int kvh, int R,
           int W, int D, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
           long long v_sb, long long v_sh, float scale, cudaStream_t stream) {
  auto kern = step_attn_kernel<T, MAXR, VEC>;
  // Set at every launch that needs it: the attribute belongs to the
  // current device's context, and setting it is allowed during a capture.
  if (pl.smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<B * kvh * pl.ng, kThreads, pl.smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv, (const long long*)pos,
      (T*)o, pl.global ? (float*)scratch : nullptr, kvh, R, pl.G, pl.ng, W, D, pl.tpr_log,
      q_sb, q_sh, k_sb, k_sh, v_sb, v_sh, scale);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The f32 values of global scratch that lac_step_attn needs at these shapes
// on the current device for its scores: 0 where they fit a block's shared
// memory; -1 where the kernel does not take the shapes (B, KVH, W or R
// under 1, a row over 512 bytes).
int lac_step_attn_scratch(int B, int kvh, int R, int W, int D, int bf16) {
  Plan pl;
  return plan(B, kvh, R, W, D, bf16, &pl) ? (int)pl.scratch_floats : -1;
}

// bf16 != 0: T is bf16, else f32. scratch: lac_step_attn_scratch's f32
// values, or null where it said 0. Shapes the kernel does not take are
// cudaErrorInvalidValue, as is a missing scratch buffer.
int lac_step_attn(const void* q, const void* k, const void* v, const void* ck, const void* cv,
                  const void* pos, void* o, void* scratch, int B, int kvh, int R, int W, int D,
                  int bf16, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                  long long v_sb, long long v_sh, float scale, void* stream) {
  Plan pl;
  if (!plan(B, kvh, R, W, D, bf16, &pl) || (pl.global && !scratch))
    return (int)cudaErrorInvalidValue;
  const int n = bf16 ? 8 : 4;  // a chunk's values
  const int vec = D % n == 0 && q_sb % n == 0 && q_sh % n == 0 && k_sb % n == 0 &&
                  k_sh % n == 0 && v_sb % n == 0 && v_sh % n == 0 && aligned(q) &&
                  aligned(k) && aligned(v) && aligned(ck) && aligned(cv);
  const cudaStream_t s = (cudaStream_t)stream;
#define LAC_STEP_ATTN(T, MAXR, VEC)                                                           \
  return launch<T, MAXR, VEC>(pl, q, k, v, ck, cv, pos, o, scratch, B, kvh, R, W, D, q_sb,  \
                              q_sh, k_sb, k_sh, v_sb, v_sh, scale, s)
  // five instantiations: bf16's aligned rows at one query head a block and
  // at up to 8, f32's at up to 8 (the tiny configs'), and an unaligned one
  // a type
  if (bf16) {
    if (!vec) LAC_STEP_ATTN(__nv_bfloat16, kMaxGroup, false);
    if (pl.G == 1) LAC_STEP_ATTN(__nv_bfloat16, 1, true);
    LAC_STEP_ATTN(__nv_bfloat16, kMaxGroup, true);
  }
  if (!vec) LAC_STEP_ATTN(float, kMaxGroup, false);
  LAC_STEP_ATTN(float, kMaxGroup, true);
#undef LAC_STEP_ATTN
}

}  // extern "C"
