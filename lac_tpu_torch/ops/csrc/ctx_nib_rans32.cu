// order1n byte codec kernels for Hopper (sm_90a): the model's forward pass
// (K4) and its fused model + decoder (K5). The rANS encode that follows a
// forward pass is K2 (rans32_encode in o0n_rans32.cu), which all three
// nibble codecs share. order2n's kernels, K6 and K7, are in o2n_rans32.cu.
//
// Ports the order1n kernels of lac_tpu/ops/pallas_rans.py. The spec is
// models/functional.py (Order1NibCDF); the plain PyTorch versions in
// ops/rans_kernels.py step the same model, and the tests hold both to the
// JAX package.
//
// As in o0n_rans32.cu, one thread codes one lane (one block of the file)
// from its first symbol to its last; symbols, intervals and decoded bytes
// are time-major [T, B]; word rows are lane-major [B, cap] and a lane reads
// 0 past cap. The TPU kernels' storage tricks (pair-packed tables, tree
// selects, the staged word FIFO, the 2048-lane sub-kernels) are not carried
// over: they are not part of the bitstream (docs/DESIGN.md:205-216).
//
// What differs from order0n is the context tables. The hi row is picked by
// the previous byte's hi nibble prev_h (16 contexts); the lo row by h
// (order1n, 16 contexts) or by h*4 + (prev_h >> 2) (order2n, 64 contexts),
// computed before prev_h moves on. Both rows adapt on their own context's
// visit count, not on the step. The template is over the number of lo
// contexts; only order1n's instantiation is launched.
//
// Each lane's state lives in dynamic shared memory, the lane the fastest
// index, so the 32 lanes of a warp touch 32 neighbouring u16s (two lanes a
// bank at most): hi tables [16 ctx x 16 states][kLanes] u16, lo tables
// [kLoCtx x 16][kLanes] u16, visit counts [16][kLanes] and [kLoCtx][kLanes]
// u8. A count saturates at 255 and does not wrap: the rate stops growing at
// a count of 128, so a saturated count gives the true count's rate. With 32
// lanes a block that is 33,792 bytes (order1n).
//
// Built by ops/_build.py with the other csrc/*.cu files into one library,
// bound with ctypes. Each entry point launches on the given stream, does not
// synchronise, and returns the first non-zero cudaError_t of its set-up and
// launch. No PyTorch header is included.

#include <cstdint>
#include <cuda_runtime.h>

#include "nib_model.cuh"

namespace {

using namespace lac_nib;

constexpr int kLanes = 32;  // lanes (threads) per block

// One lane's column of the tables in shared memory, initialised uniform.
template <int kLoCtx>
struct CtxTables {
  static constexpr int kHiRows = kNV * kNV;     // 16 contexts x 16 states
  static constexpr int kLoRows = kLoCtx * kNV;
  static constexpr int kBytes = kLanes * ((kHiRows + kLoRows) * 2 + kNV + kLoCtx);

  uint16_t* hi;
  uint16_t* lo;
  uint8_t* hi_cnt;
  uint8_t* lo_cnt;

  __device__ CtxTables(unsigned char* smem, int tid) {
    uint16_t* t16 = reinterpret_cast<uint16_t*>(smem);
    uint8_t* t8 = smem + 2 * (kHiRows + kLoRows) * kLanes;
    hi = t16 + tid;
    lo = t16 + kHiRows * kLanes + tid;
    hi_cnt = t8 + tid;
    lo_cnt = t8 + kNV * kLanes + tid;
    for (int r = 0; r < kHiRows; ++r) hi[r * kLanes] = (uint16_t)((r & 15) << (kNSB - 4));
    for (int r = 0; r < kLoRows; ++r) lo[r * kLanes] = (uint16_t)((r & 15) << (kNSB - 4));
    for (int c = 0; c < kNV; ++c) hi_cnt[c * kLanes] = 0;
    for (int c = 0; c < kLoCtx; ++c) lo_cnt[c * kLanes] = 0;
  }
};

// the lo context of byte (h, .) after a byte whose hi nibble was ph
template <int kLoCtx>
__device__ __forceinline__ int lo_ctx(int h, int ph) {
  return kLoCtx == kNV ? h : h * 4 + (ph >> 2);
}

// row c of a table column: its state k sits at row[k * kLanes]
__device__ __forceinline__ uint16_t* row_of(uint16_t* col, int c) {
  return col + c * kNV * kLanes;
}

__device__ __forceinline__ void load_row(const uint16_t* row, int st[kNV]) {
#pragma unroll
  for (int k = 0; k < kNV; ++k) st[k] = row[k * kLanes];
}

// move a row toward nibble `nib` at rate r and store it back
__device__ __forceinline__ void store_update(uint16_t* row, const int st[kNV], int nib, int r) {
#pragma unroll
  for (int k = 0; k < kNV; ++k) row[k * kLanes] = (uint16_t)nib_update(st[k], k, nib, r);
}

// the visit count of context c before this visit; counts the visit, saturating
__device__ __forceinline__ int visit(uint8_t* col, int c) {
  uint8_t* p = col + c * kLanes;
  const int v = *p;
  *p = (uint8_t)(v + (v < 255));
  return v;
}

// coding interval [lo, hi) of nibble n in a row (static indices only)
__device__ __forceinline__ void interval(const int st[kNV], int n, int& lo, int& hi) {
  lo = 0;
  hi = 256;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int e = eff(st[k], k);
    if (k == n) lo = e;
    if (k == n + 1) hi = e;
  }
}

// ---------------------------------------------------------------------------
// K4 o1n_intervals (kLoCtx 16)
// Replaces _o1n_intervals_kernel (lac_tpu/ops/pallas_rans.py:1044-1107),
// called through o1n_encode_intervals (:1110, pallas_call :1120).
// Bound on this card: each lane is a chain of T dependent model updates, so
// the kernel is bound by that per-lane serial dependence (latency), not by
// its 9 bytes of traffic per symbol. Design: a step reads the hi row that
// prev_h picks and the lo row that its context picks from shared memory,
// takes both intervals with static indices, and writes both rows and two
// visit counts back. Reads of syms and writes of lo/fr are coalesced.
// ---------------------------------------------------------------------------
template <int kLoCtx>
__global__ void __launch_bounds__(kLanes)
ctx_intervals_kernel(const uint8_t* __restrict__ syms, int T, int B, int rate,
                     int32_t* __restrict__ lo_out, int32_t* __restrict__ fr_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kLanes + tid;
  if (b >= B) return;
  const CtxTables<kLoCtx> m(smem, tid);

  int ph = 0;
  for (int t = 0; t < T; ++t) {
    const size_t at = (size_t)t * B + b;
    const int s = syms[at];
    const int h = s >> 4, l = s & 15;
    const int lc = lo_ctx<kLoCtx>(h, ph);
    uint16_t* hrow = row_of(m.hi, ph);
    uint16_t* lrow = row_of(m.lo, lc);
    int sth[kNV], stl[kNV];
    load_row(hrow, sth);
    load_row(lrow, stl);
    int loh, hih, lol, hil;
    interval(sth, h, loh, hih);
    interval(stl, l, lol, hil);
    const int fh = hih - loh;
    lo_out[at] = (loh << 8) + fh * lol;
    fr_out[at] = fh * (hil - lol);
    // both rows adapt on their context's visit count
    store_update(hrow, sth, h, rate_at(rate, visit(m.hi_cnt, ph)));
    store_update(lrow, stl, l, rate_at(rate, visit(m.lo_cnt, lc)));
    ph = h;
  }
}

// ---------------------------------------------------------------------------
// K5 o1n_decode (kLoCtx 16)
// Replaces _o1n_decode_fused_kernel (lac_tpu/ops/pallas_rans.py:1148-1226),
// called through _o1n_decode_fused (:1240) / o1n_rans32_decode (:1254);
// pallas_call in _nib_decode_call (:951).
// Bound on this card: per-lane serial dependence (each symbol's search needs
// the state the previous symbol left, and the lo row is known only once the
// hi nibble is found), then the uncoalesced reads of each lane's word row.
// Design: as K3, the hi nibble is found by counting boundaries <= slot >> 8
// and the lo nibble by counting f_h-scaled boundaries <= the remainder, both
// without branches; the rows come from shared memory as in K4/K6. A lane
// steps only while t < its length, so prev_h and the counts move only on
// active steps, and it writes 0 past its length.
// ---------------------------------------------------------------------------
template <int kLoCtx>
__global__ void __launch_bounds__(kLanes)
ctx_decode_kernel(const uint16_t* __restrict__ words, const int32_t* __restrict__ lengths,
                  int T, int B, int cap, int rate, uint8_t* __restrict__ syms) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kLanes + tid;
  if (b >= B) return;
  const CtxTables<kLoCtx> m(smem, tid);

  const int n = min(max(lengths[b], 0), T);
  const uint16_t* wrow = words + (size_t)b * cap;
  uint32_t x = ((uint32_t)(cap > 0 ? wrow[0] : 0) << 16) | (uint32_t)(cap > 1 ? wrow[1] : 0);
  int pos = 2;
  int ph = 0;
  for (int t = 0; t < n; ++t) {
    const int slot = (int)(x & 0xFFFFu);
    const int thr = slot >> 8;
    uint16_t* hrow = row_of(m.hi, ph);
    int sth[kNV];
    load_row(hrow, sth);
    int h = -1, loh = 0, hih = 256;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int e = eff(sth[k], k);
      const bool le = e <= thr;
      h += le;
      loh = le ? e : loh;
      hih = (!le && e < hih) ? e : hih;
    }
    const int fh = hih - loh;
    const int r = slot - (loh << 8);
    const int lc = lo_ctx<kLoCtx>(h, ph);
    uint16_t* lrow = row_of(m.lo, lc);
    int stl[kNV];
    load_row(lrow, stl);
    int l = -1, lo_s = 0, hi_s = fh << 8;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int sc = fh * eff(stl[k], k);
      const bool le = sc <= r;
      l += le;
      lo_s = le ? sc : lo_s;
      hi_s = (!le && sc < hi_s) ? sc : hi_s;
    }
    x = (uint32_t)(hi_s - lo_s) * (x >> 16) + (uint32_t)(r - lo_s);
    if (x < (1u << 16)) {
      const uint32_t w = pos < cap ? wrow[pos] : 0u;
      x = (x << 16) | w;
      ++pos;
    }
    syms[(size_t)t * B + b] = (uint8_t)((h << 4) | l);
    store_update(hrow, sth, h, rate_at(rate, visit(m.hi_cnt, ph)));
    store_update(lrow, stl, l, rate_at(rate, visit(m.lo_cnt, lc)));
    ph = h;
  }
  for (int t = n; t < T; ++t) syms[(size_t)t * B + b] = 0;
}

template <int kLoCtx>
int launch_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                     void* stream) {
  constexpr int smem = CtxTables<kLoCtx>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      ctx_intervals_kernel<kLoCtx>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + kLanes - 1) / kLanes;
  ctx_intervals_kernel<kLoCtx><<<grid, kLanes, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)syms, T, B, rate, (int32_t*)lo, (int32_t*)fr);
  return (int)cudaGetLastError();
}

template <int kLoCtx>
int launch_decode(const void* words, const void* lengths, void* syms, int T, int B, int cap,
                  int rate, void* stream) {
  constexpr int smem = CtxTables<kLoCtx>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      ctx_decode_kernel<kLoCtx>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + kLanes - 1) / kLanes;
  ctx_decode_kernel<kLoCtx><<<grid, kLanes, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)words, (const int32_t*)lengths, T, B, cap, rate, (uint8_t*)syms);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the launch shape of these kernels: lanes a block, and shared bytes a
// block for order1n's lo_ctx = 16 lo contexts (-1 for another count)
int lac_ctx_lanes() { return kLanes; }

int lac_ctx_shared_bytes(int lo_ctx) { return lo_ctx == 16 ? CtxTables<16>::kBytes : -1; }

int lac_o1n_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                      void* stream) {
  return launch_intervals<16>(syms, lo, fr, T, B, rate, stream);
}

int lac_o1n_decode(const void* words, const void* lengths, void* syms, int T, int B,
                   int cap, int rate, void* stream) {
  return launch_decode<16>(words, lengths, syms, T, B, cap, rate, stream);
}

}  // extern "C"
