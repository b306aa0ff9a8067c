// rANS-32/16 encode with word compaction for Hopper (sm_90a): K2, the
// encode every byte codec chains after its intervals kernel (K1, K4, K6 in
// nib_rans32.cu; K8 in o0c_rans32.cu).
//
// Ports rans32_encode_dense and compact_words of lac_tpu/ops/pallas_rans.py.
// The bitstream is the spec of lac_tpu_torch/coder/rans.py; the plain
// PyTorch version in ops/rans_kernels.py repeats this arithmetic and the
// tests hold both to the JAX package.
//
// Layout: intervals are time-major [T, B], so the 32 threads of a warp
// touch 32 neighbouring addresses at every step. Word rows are lane-major
// [B, cap] (the warp turns its rows together, below).
//
// Built by ops/_build.py, with the other csrc/*.cu files, into one library with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes. The entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError() after its launch.
// No PyTorch header is included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

extern "C" {

int lac_rans32_encode(const void* lo, const void* fr, const void* lengths, void* words,
                      void* nwords, int T, int B, int cap, void* stream) {
  const int grid = (B + kEncodeLanes - 1) / kEncodeLanes;
  rans32_encode_kernel<<<grid, kEncodeLanes, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lo, (const int32_t*)fr, (const int32_t*)lengths, T, B, cap,
      (uint16_t*)words, (int32_t*)nwords);
  return (int)cudaGetLastError();
}

}  // extern "C"
