// order0c byte codec kernels for Hopper (sm_90a): the joint-byte model's
// forward pass (K8) and the fused model + rANS-32/16 decoder (K9). Encode
// chains K8 with K2 (rans32_encode_kernel, o0n_rans32.cu), unchanged.
//
// Ports the order0c kernels of lac_tpu/ops/pallas_rans.py. The bitstream is
// the spec of lac_tpu_torch/coder/rans.py and models/functional.py
// (Order0CDF); the plain PyTorch versions in ops/rans_kernels.py repeat
// this arithmetic and the tests hold both to the JAX package.
//
// The model: each lane holds a CDF state st[0..255] pre-scaled to [0, M],
// M = 2^16 - 256, with st[0] = 0 and an implicit st[256] = M. Byte s codes
// as [st[s] + s, st[s+1] + s + 1), so the total is 2^16 and every width is
// at least 1. After each byte, every entry k <= s moves st - (st >> r) and
// every other entry st + ((M - st) >> r), with r = rate_at(rate, t) on the
// global step t. Unlike the nibble models, a step reads and moves all 256
// entries, so the kernels are bound by integer work, not by their bytes.
//
// Design: one warp codes one lane, and each thread holds 8 neighbouring
// entries (k = 8 * laneid + i) in registers, so no step touches memory for
// the model. The boundary table st[k] + k is strictly increasing, so
// "k <= s" is one compare per entry, the interval's ends are a warp max
// (over entries <= s) and a warp min (over the rest, 2^16 if none), and the
// decoder's symbol is a warp sum of the per-thread counts, each one
// redux.sync instruction. x and the word pointer are the same in every
// thread of the warp. Symbols come in, and results go out, 32 steps at a
// time: thread j loads or stores step t0 + j, and a shuffle hands each step
// its symbol, so no step waits on a global load. The decoder loads its next
// word as soon as the pointer moves, a refill or more before it is needed.
//
// The TPU kernels' storage choices are not carried over, since they are not
// part of the bitstream (docs/DESIGN.md:205-216): no pair-packed word FIFO,
// no per-window roll, no 2048-lane sub-kernels and no VMEM gate. A lane
// reads its words through its own pointer and reads 0 past cap, so the one
// decode kernel covers every cap, where the reference switches to its
// chunked kernel with a per-chunk window gather.
//
// Layout: symbols, intervals and decoded bytes are time-major [T, B]; word
// rows are lane-major [B, cap].
//
// Built by ops/_build.py, with the other csrc/*.cu files, into one library
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes. Each entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError() after its launch.
// No PyTorch header is included.

#include <cstdint>
#include <cuda_runtime.h>

#include "nib_model.cuh"  // rate_at

namespace {

using lac_nib::rate_at;

constexpr int kV = 256;                 // the byte alphabet
constexpr int kM = (1 << 16) - kV;      // 65280: state range
constexpr int kTop = 1 << 16;           // coder total
constexpr int kPer = kV / 32;           // entries a thread holds
constexpr int kLanes = 8;               // coding lanes (warps) a block
constexpr int kThreads = 32 * kLanes;
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ void state_init(int (&st)[kPer], int k0) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) st[i] = ((k0 + i) * kM) >> 8;  // (k * M) / V
}

// shift toward the one-hot CDF of byte s at rate r
__device__ __forceinline__ void state_update(int (&st)[kPer], int k0, int s, int r) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    st[i] = k0 + i <= s ? st[i] - (st[i] >> r) : st[i] + ((kM - st[i]) >> r);
}

// ---------------------------------------------------------------------------
// K8  o0c_intervals
// Replaces _intervals_kernel (lac_tpu/ops/pallas_rans.py:113-141), called
// through o0c_encode_intervals (:144, pallas_call :157).
// Bound on this card: integer work, about 1,035 ops a symbol (the update of
// 255 moving entries, 4 each), against 9 bytes of traffic a symbol. The
// counts are derived in chip_smoke.py. Design: see above; all T steps run,
// the zero padding past a lane's length included, as the reference does (K2
// reads only steps below the length).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
o0c_intervals_kernel(const uint8_t* __restrict__ syms, int T, int B, int rate,
                     int32_t* __restrict__ lo_out, int32_t* __restrict__ fr_out) {
  const int ln = threadIdx.x & 31;
  const int b = blockIdx.x * kLanes + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const int k0 = kPer * ln;
  int st[kPer];
  state_init(st, k0);
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int tt = t0 + ln;
    const int mine = tt < T ? syms[(size_t)tt * B + b] : 0;
    const int nstep = min(32, T - t0);
    int my_lo = 0, my_fr = 0;
    for (int j = 0; j < nstep; ++j) {
      const int s = __shfl_sync(kAll, mine, j);
      int lo_c = 0, hi_c = kTop;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = st[i] + k0 + i;
        if (k0 + i <= s) lo_c = e;      // increasing: the last one is st[s] + s
        else hi_c = min(hi_c, e);       // the first one is st[s+1] + s + 1
      }
      const int lo = __reduce_max_sync(kAll, lo_c);
      const int hi = __reduce_min_sync(kAll, hi_c);
      if (ln == j) {
        my_lo = lo;
        my_fr = hi - lo;
      }
      state_update(st, k0, s, rate_at(rate, t0 + j));
    }
    if (tt < T) {
      lo_out[(size_t)tt * B + b] = my_lo;
      fr_out[(size_t)tt * B + b] = my_fr;
    }
  }
}

// ---------------------------------------------------------------------------
// K9  o0c_decode
// Replaces _decode_fused_kernel (lac_tpu/ops/pallas_rans.py:377-438), called
// through _decode_fused (:449, pallas_call :465) from o0c_rans32_decode
// (:563), and _decode_chunk_kernel (:493-541), called through
// _decode_chunk_call (:544, pallas_call :547), which o0c_rans32_decode takes
// when _fused_vmem_ok (:441) refuses the cap.
// Bound on this card: integer work, about 1,068 ops a symbol (K8's update
// and the search), against about 1.4 bytes of traffic a symbol. Design: see
// above. A lane steps only below its length and writes 0 after it.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
o0c_decode_kernel(const uint16_t* __restrict__ words, const int32_t* __restrict__ lengths,
                  int T, int B, int cap, int rate, uint8_t* __restrict__ syms) {
  const int ln = threadIdx.x & 31;
  const int b = blockIdx.x * kLanes + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const int k0 = kPer * ln;
  const int n = min(max(lengths[b], 0), T);
  const uint16_t* row = words + (size_t)b * cap;
  uint32_t x = ((uint32_t)(cap > 0 ? row[0] : 0) << 16) | (uint32_t)(cap > 1 ? row[1] : 0);
  int pos = 2;
  uint32_t next = pos < cap ? row[pos] : 0u;
  int st[kPer];
  state_init(st, k0);
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int nstep = min(32, n - t0);
    int my_sym = 0;
    for (int j = 0; j < nstep; ++j) {
      const int slot = (int)(x & 0xFFFFu);
      int cnt = 0, lo_c = 0, hi_c = kTop;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = st[i] + k0 + i;
        const bool le = e <= slot;
        cnt += le;
        lo_c = le ? e : lo_c;
        hi_c = le ? hi_c : min(hi_c, e);
      }
      const int s = __reduce_add_sync(kAll, cnt) - 1;
      const int lo = __reduce_max_sync(kAll, lo_c);
      const int hi = __reduce_min_sync(kAll, hi_c);
      x = (uint32_t)(hi - lo) * (x >> 16) + (uint32_t)(slot - lo);
      if (x < (1u << 16)) {
        x = (x << 16) | next;
        ++pos;
        next = pos < cap ? row[pos] : 0u;
      }
      if (ln == j) my_sym = s;
      state_update(st, k0, s, rate_at(rate, t0 + j));
    }
    const int tt = t0 + ln;
    if (tt < T) syms[(size_t)tt * B + b] = (uint8_t)my_sym;  // 0 from n on
  }
}

}  // namespace

extern "C" {

int lac_o0c_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                      void* stream) {
  const int grid = (B + kLanes - 1) / kLanes;
  o0c_intervals_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)syms, T, B, rate, (int32_t*)lo, (int32_t*)fr);
  return (int)cudaGetLastError();
}

int lac_o0c_decode(const void* words, const void* lengths, void* syms, int T, int B,
                   int cap, int rate, void* stream) {
  const int grid = (B + kLanes - 1) / kLanes;
  o0c_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)words, (const int32_t*)lengths, T, B, cap, rate, (uint8_t*)syms);
  return (int)cudaGetLastError();
}

}  // extern "C"
