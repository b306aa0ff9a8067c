// order0n byte codec kernels for Hopper (sm_90a): the model's forward pass,
// rANS-32/16 encode with word compaction, and the fused model + decoder.
//
// Ports the order0n kernels of lac_tpu/ops/pallas_rans.py. The bitstream is
// the spec of lac_tpu_torch/coder/rans.py and models/functional.py
// (Order0NibCDF); the plain PyTorch versions in ops/rans_kernels.py repeat
// this arithmetic and the tests hold both to the JAX package.
//
// One thread codes one lane (one block of the file) from its first symbol to
// its last. The TPU kernels' storage tricks are not carried over, since they
// are not part of the bitstream (docs/DESIGN.md:205-216): there is no
// pair-packed word FIFO (a thread keeps a pointer into its own word row),
// no tree select (a thread indexes its context row directly), no packed-pair
// lo tables (states are u16 in shared memory) and no f32 quotient fix-up
// (plain u32 division gives the same quotient).
//
// Layout: symbols, intervals and decoded bytes are time-major [T, B], so the
// 32 threads of a warp touch 32 neighbouring addresses at every step. Word
// rows are lane-major [B, cap]: each thread walks its own row, which is not
// coalesced across the warp (K2 turns its rows with the whole warp).
//
// Built by ops/_build.py, with the other csrc/*.cu files, into one library with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes. Each entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError() after its launch.
// No PyTorch header is included.

#include <cstdint>
#include <cuda_runtime.h>

#include "nib_model.cuh"

namespace {

using namespace lac_nib;

constexpr int kModelThreads = 64;      // lanes per block in the model kernels

// Each thread's 16 lo-nibble tables (16 x 16 u16 states) live in one column
// of this shared array: element [c*16 + k][threadIdx.x]. Neighbouring
// threads read neighbouring u16s, so the accesses are free of bank
// conflicts. 256 * 64 * 2 bytes = 32 KB per block.
using LoTables = uint16_t[kNV * kNV][kModelThreads];

__device__ __forceinline__ void lo_tables_init(LoTables& sl, int tid) {
#pragma unroll 4
  for (int r = 0; r < kNV * kNV; ++r) sl[r][tid] = (uint16_t)((r & 15) << (kNSB - 4));
}

// ---------------------------------------------------------------------------
// K1  o0n_intervals
// Replaces _o0n_intervals_kernel (lac_tpu/ops/pallas_rans.py:742-791), called
// through o0n_encode_intervals (:794, pallas_call :804).
// Bound on this card: each lane is a chain of T dependent model updates, so
// the kernel is bound by that per-lane serial dependence (latency), not by
// its 9 bytes of traffic per symbol. Design: the hi table (16 states) and
// the visit counts stay in registers with every index static; only the one
// 16-entry lo row picked by the hi nibble is read and written back in shared
// memory per step. Reads of syms and writes of lo/fr are coalesced.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kModelThreads)
o0n_intervals_kernel(const uint8_t* __restrict__ syms, int T, int B, int rate,
                     int32_t* __restrict__ lo_out, int32_t* __restrict__ fr_out) {
  __shared__ LoTables sl;
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kModelThreads + tid;
  lo_tables_init(sl, tid);
  if (b >= B) return;

  int sh[kNV], cnt[kNV];
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    sh[k] = k << (kNSB - 4);
    cnt[k] = 0;
  }
  for (int t = 0; t < T; ++t) {
    const size_t at = (size_t)t * B + b;
    const int s = syms[at];
    const int h = s >> 4, l = s & 15;
    int loh = 0, hih = 256, c = 0;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int e = eff(sh[k], k);
      if (k == h) { loh = e; c = cnt[k]; }
      if (k == h + 1) hih = e;
    }
    const int fh = hih - loh;
    uint16_t* row = &sl[h * kNV][tid];
    int st[kNV];
#pragma unroll
    for (int k = 0; k < kNV; ++k) st[k] = row[k * kModelThreads];
    int lol = 0, hil = 256;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int e = eff(st[k], k);
      if (k == l) lol = e;
      if (k == l + 1) hil = e;
    }
    lo_out[at] = (loh << 8) + fh * lol;
    fr_out[at] = fh * (hil - lol);
    // hi table on the global-step schedule, lo table on its visit count
    const int rh = rate_at(rate, t), rl = rate_at(rate, c);
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      sh[k] = nib_update(sh[k], k, h, rh);
      row[k * kModelThreads] = (uint16_t)nib_update(st[k], k, l, rl);
      cnt[k] += (k == h);
    }
  }
}

// ---------------------------------------------------------------------------
// K2  rans32_encode
// Replaces _rans32_enc_kernel (lac_tpu/ops/pallas_rans.py:179-234), called
// through rans32_encode_dense (:237, pallas_call :249), together with the
// XLA pass compact_words (:271-310) that follows it there.
// Out per lane: [x >> 16, x & 0xFFFF, emitted words in ascending t], zeros
// after them, and nwords = 2 + every emitted word, even past cap.
// Bound on this card: by its bytes (8 a symbol of intervals, the words), but
// each lane is a serial chain through x, one u32 divide a symbol, and B
// lanes are B threads: at B = 8192 that is 256 warps for 528 schedulers, so
// nothing hides the chain's latency and the kernel takes about T times one
// step of the chain. What the design keeps off that chain:
// - One warp a block (32 lanes), so that B = 8192 fills 256 blocks and every
//   SM has work; each lane starts at its own n - 1 and walks t down.
// - The loads: a lane stages its own next steps of lo and fr into shared
//   memory with cp.async (4 bytes a copy, zero-filled past its length, a
//   pointer walking down by B a step, no branch), a ring of kEncodeStages
//   stages of kEncodeChunk steps, up to 3 stages in flight. TMA or
//   cp.async.bulk would work where B % 4 == 0 (16-byte row strides), but
//   would need a second path for any other B and for lanes whose lengths
//   differ inside one box; the 32 lanes' 4-byte copies of one step already
//   coalesce to one 128-byte transaction where lengths agree, so one path
//   was kept. Each lane reads only what it staged itself, so
//   cp.async.wait_group orders it and no barrier is needed.
// - The emission: a compare, selects and a predicated store, no branch.
//   The words are written back to front into a ring over row[2, cap), so no
//   dense [T, B] grid is stored and no second pass over T is needed.
// - The turn of the ring (the newest word to row[2]: a move down when the
//   words fit, a rotation by three reversals when they overflowed cap) is
//   done by the whole warp, one lane's row at a time, so that the 32
//   threads read and write 32 neighbouring words. A __syncwarp first makes
//   each lane's ring writes visible to the other lanes.
// On the card (chip_smoke.py, PERF.md section 6) the staging and the branch-
// free step took the step from the loads' latency to the chain's, and the
// warp's turn took the uncoalesced per-lane move off the end.
// ---------------------------------------------------------------------------
constexpr int kEncodeLanes = 32;    // lanes a block
constexpr int kEncodeChunk = 16;    // steps a stage
constexpr int kEncodeStages = 4;    // stages in the ring
constexpr unsigned kWarp = 0xFFFFFFFFu;

// 4 bytes from global to shared memory, asynchronously; 0 written (and
// nothing read) when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lane's next kEncodeChunk steps of lo and fr (the rows at plo, pfr,
// then B lower each step; `left` steps remain) into column `lane` of one
// stage's [step][lane] arrays, as one commit group.
__device__ __forceinline__ void stage_chunk(uint32_t (*slo)[kEncodeLanes],
                                            uint32_t (*sfr)[kEncodeLanes],
                                            const int32_t*& plo, const int32_t*& pfr, int& left,
                                            int B, int lane) {
#pragma unroll
  for (int r = 0; r < kEncodeChunk; ++r) {
    const bool valid = r < left;
    cp_async4(&slo[r][lane], plo, valid);
    cp_async4(&sfr[r][lane], pfr, valid);
    plo -= valid ? B : 0;
    pfr -= valid ? B : 0;
  }
  left = max(left - kEncodeChunk, 0);
  cp_async_commit();
}

// The ring ring[0, C) of one lane turned so that its newest word, at slot
// p, comes first, by the 32 threads of the warp: e words at ring[C - e, C)
// move down to ring[0, e) (forward in runs of 32 x kRun, each run read
// before it is written, so the overlap is safe) and the rest becomes 0; or,
// when the words overflowed (e >= C), a rotation left by p as three
// reversals, each thread swapping disjoint pairs.
__device__ void turn_ring(uint16_t* ring, int C, int e, int p, int lane) {
  constexpr int kRun = 16;
  if (e < C) {
    const int src = C - e;
    for (int base = 0; base < e; base += 32 * kRun) {
      uint16_t v[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const int i = base + 32 * k + lane;
        v[k] = i < e ? ring[src + i] : 0;
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const int i = base + 32 * k + lane;
        if (i < e) ring[i] = v[k];
      }
      __syncwarp();
    }
    for (int i = e + lane; i < C; i += 32) ring[i] = 0;
  } else if (p != 0) {
    const int seg[3][2] = {{0, p}, {p, C}, {0, C}};
    for (int s = 0; s < 3; ++s) {
      const int i0 = seg[s][0], j0 = seg[s][1];
      for (int k = lane; k < (j0 - i0) / 2; k += 32) {
        const uint16_t a = ring[i0 + k];
        ring[i0 + k] = ring[j0 - 1 - k];
        ring[j0 - 1 - k] = a;
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kEncodeLanes)
rans32_encode_kernel(const int32_t* __restrict__ lo_in, const int32_t* __restrict__ fr_in,
                     const int32_t* __restrict__ lengths, int T, int B, int cap,
                     uint16_t* __restrict__ words, int32_t* __restrict__ nwords) {
  // [stage][step of the stage][lane]: a lane's column, free of bank conflicts
  __shared__ uint32_t slo[kEncodeStages][kEncodeChunk][kEncodeLanes];
  __shared__ uint32_t sfr[kEncodeStages][kEncodeChunk][kEncodeLanes];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kEncodeLanes + lane;
  const bool live = b < B;  // every thread stays for the warp's turn of the rings
  const int n = live ? min(max(lengths[b], 0), T) : 0;
  uint16_t* row = words + (size_t)(live ? b : 0) * cap;
  uint16_t* ring = row + 2;
  const int C = cap - 2;

  // step i codes t = n - 1 - i
  const size_t top = n > 0 ? (size_t)(n - 1) * B + b : 0;
  const int32_t* plo = lo_in + top;
  const int32_t* pfr = fr_in + top;
  int left = n;
  const int chunks = (n + kEncodeChunk - 1) / kEncodeChunk;
#pragma unroll
  for (int c = 0; c < kEncodeStages - 1; ++c) stage_chunk(slo[c], sfr[c], plo, pfr, left, B, lane);

  uint32_t x = 1u << 16;
  int e = 0, p = C;  // emitted count; ring slot of the newest word
  for (int c = 0; c < chunks; ++c) {
    // the stage chunk c + 3 lands in was read by this lane at chunk c - 1
    const int ahead = (c + kEncodeStages - 1) % kEncodeStages;
    stage_chunk(slo[ahead], sfr[ahead], plo, pfr, left, B, lane);
    cp_async_wait<kEncodeStages - 1>();  // chunk c has landed
    const int st = c % kEncodeStages;
    const int steps = min(kEncodeChunk, n - c * kEncodeChunk);
#pragma unroll 4
    for (int r = 0; r < steps; ++r) {
      const uint32_t f = sfr[st][r][lane];
      const uint32_t lo = slo[st][r][lane];
      const bool renorm = (x >> 16) >= f;  // x >= f << 16, in 32 bits
      const int pn = (p == 0 ? C : p) - 1;
      if (renorm && C > 0) ring[pn] = (uint16_t)(x & 0xFFFFu);
      p = renorm && C > 0 ? pn : p;
      e += renorm;
      x = renorm ? x >> 16 : x;
      x = ((x / f) << 16) + (x % f) + lo;
    }
  }
  cp_async_wait<0>();
  if (C > 0) {
    __syncwarp();  // every lane's ring writes are seen by the whole warp
    for (int j = 0; j < kEncodeLanes; ++j) {
      const int ej = __shfl_sync(kWarp, e, j), pj = __shfl_sync(kWarp, p, j);
      const int bj = blockIdx.x * kEncodeLanes + j;
      if (bj < B) turn_ring(words + (size_t)bj * cap + 2, C, ej, pj, lane);
    }
  }
  if (live) {
    row[0] = (uint16_t)(x >> 16);
    row[1] = (uint16_t)(x & 0xFFFFu);
    nwords[b] = 2 + e;
  }
}

// ---------------------------------------------------------------------------
// K3  o0n_decode
// Replaces _o0n_decode_fused_kernel (lac_tpu/ops/pallas_rans.py:849-918),
// called through _o0n_decode_fused (:1012) / o0n_rans32_decode (:1024),
// pallas_call in _nib_decode_call (:951).
// Bound on this card: per-lane serial dependence (each symbol's search needs
// the state the previous symbol left), then the uncoalesced reads of each
// lane's word row. Design: as K1, the hi table and counts stay in registers
// and one lo row per step is touched in shared memory; the hi nibble is
// found by counting boundaries <= slot >> 8 and the lo nibble by counting
// f_h-scaled boundaries <= the remainder, both without branches. A lane
// reads its next word through its own pointer (0 past cap, as the TPU's
// zero padding gives), and writes 0 past its length.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kModelThreads)
o0n_decode_kernel(const uint16_t* __restrict__ words, const int32_t* __restrict__ lengths,
                  int T, int B, int cap, int rate, uint8_t* __restrict__ syms) {
  __shared__ LoTables sl;
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kModelThreads + tid;
  lo_tables_init(sl, tid);
  if (b >= B) return;

  const int n = min(max(lengths[b], 0), T);
  const uint16_t* row = words + (size_t)b * cap;
  uint32_t x = ((uint32_t)(cap > 0 ? row[0] : 0) << 16) | (uint32_t)(cap > 1 ? row[1] : 0);
  int pos = 2;
  int sh[kNV], cnt[kNV];
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    sh[k] = k << (kNSB - 4);
    cnt[k] = 0;
  }
  for (int t = 0; t < n; ++t) {
    const int slot = (int)(x & 0xFFFFu);
    const int thr = slot >> 8;
    int h = -1, loh = 0, hih = 256, c = 0;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int e = eff(sh[k], k);
      const bool le = e <= thr;
      h += le;
      loh = le ? e : loh;
      c = le ? cnt[k] : c;
      hih = (!le && e < hih) ? e : hih;
    }
    const int fh = hih - loh;
    const int r = slot - (loh << 8);
    uint16_t* lrow = &sl[h * kNV][tid];
    int st[kNV];
#pragma unroll
    for (int k = 0; k < kNV; ++k) st[k] = lrow[k * kModelThreads];
    int l = -1, lo_s = 0, hi_s = fh << 8;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int sc = fh * eff(st[k], k);
      const bool le = sc <= r;
      l += le;
      lo_s = le ? sc : lo_s;
      hi_s = (!le && sc < hi_s) ? sc : hi_s;
    }
    x = (uint32_t)(hi_s - lo_s) * (x >> 16) + (uint32_t)(r - lo_s);
    if (x < (1u << 16)) {
      const uint32_t w = pos < cap ? row[pos] : 0u;
      x = (x << 16) | w;
      ++pos;
    }
    syms[(size_t)t * B + b] = (uint8_t)((h << 4) | l);
    const int rh = rate_at(rate, t), rl = rate_at(rate, c);
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      sh[k] = nib_update(sh[k], k, h, rh);
      lrow[k * kModelThreads] = (uint16_t)nib_update(st[k], k, l, rl);
      cnt[k] += (k == h);
    }
  }
  for (int t = n; t < T; ++t) syms[(size_t)t * B + b] = 0;
}

}  // namespace

extern "C" {

int lac_o0n_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                      void* stream) {
  const int grid = (B + kModelThreads - 1) / kModelThreads;
  o0n_intervals_kernel<<<grid, kModelThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)syms, T, B, rate, (int32_t*)lo, (int32_t*)fr);
  return (int)cudaGetLastError();
}

int lac_rans32_encode(const void* lo, const void* fr, const void* lengths, void* words,
                      void* nwords, int T, int B, int cap, void* stream) {
  const int grid = (B + kEncodeLanes - 1) / kEncodeLanes;
  rans32_encode_kernel<<<grid, kEncodeLanes, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lo, (const int32_t*)fr, (const int32_t*)lengths, T, B, cap,
      (uint16_t*)words, (int32_t*)nwords);
  return (int)cudaGetLastError();
}

int lac_o0n_decode(const void* words, const void* lengths, void* syms, int T, int B,
                   int cap, int rate, void* stream) {
  const int grid = (B + kModelThreads - 1) / kModelThreads;
  o0n_decode_kernel<<<grid, kModelThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)words, (const int32_t*)lengths, T, B, cap, rate, (uint8_t*)syms);
  return (int)cudaGetLastError();
}

}  // extern "C"
