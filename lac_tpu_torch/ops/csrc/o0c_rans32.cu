// order0c byte codec kernels for Hopper (sm_90a): the joint-byte model's
// forward pass (K8) and the fused model + rANS-32/16 decoder (K9). Encode
// chains K8 with K2 (rans32_encode_kernel, rans32_encode.cu), unchanged.
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
// global step t. A step reads and moves all 256 entries, so the kernels are
// bound by the instructions they issue for each entry, not by their bytes.
//
// Packed pairs. A thread holds neighbouring entries in registers, two to a
// 32-bit word (entry k0 + 2p in the low half of word p, k0 + 2p + 1 in the
// high half), so one instruction moves two entries. Every entry stays in
// [0, M] and st + k <= 65535, so each fits its half, and no carry or borrow
// crosses a half:
// - q = st in a half that moves down, M - st in one that moves up (a lop3 of
//   st and M - st on the pair's down mask; M - st >= 0);
// - t = (q >> r) & (0xFFFF >> r in each half): the whole-word shift drags r
//   bits of the high half into the low half's top, and the mask clears them
//   (it is 0 from r = 16 on, where every shifted half is 0);
// - st + (t ^ down) - down: in a down half (down = 0xFFFF) that is
//   st + 0xFFFF - t - 0xFFFF = st - t, elsewhere st + t. Each half of the
//   true sum lies in [0, M], so the 32-bit sum is the pair, whatever the
//   carries on the way. At r = 0 it gives 0 and M, the one-hot CDF.
// A pair's step is five instructions: M - st as an IMAD, the lop3 for q,
// the shift, one lop3 for (t & mask) ^ down, one IADD3. The kernels'
// integer pipe is their limit, and ptxas turns a multiply by a literal 1
// into an IADD3 on it, so the multiplier of M - st is a 1 it cannot see
// (Units).
//
// A state copy in shared memory. Each coding lane also keeps its state in
// shared memory, written once a step (16 bytes a thread for each 4 pairs,
// double buffered), with st[256] = M after it, so that reading an entry at
// a lane-uniform k is one 2-byte load, where the registers would need a
// select over a thread's pairs and a shuffle.
//
// K8 (intervals): one warp codes one lane, 8 entries a thread. The step's
// byte is known before the step, so nothing of the model waits on another
// step but the update itself. A pair's down mask (0xFFFF in each half whose
// k <= s) is one IMAD and one prmt: s * 0x10001 plus the pair's constant
// 0x7FFF8000 - k * 0x10001 leaves 0x8000 + s - k in the low half and
// 0x8000 + s - (k + 1) in the high one (s - k is in [-255, 255], so no half
// borrows), and prmt's sign-replicating selector spreads each half's bit 15
// over the half. The thread that stores step t0 + j reads st[s] and
// st[s+1] from the copy itself, off the model's chain.
//
// K9 (decode): half a warp codes one lane, 16 entries a thread, two lanes
// a warp: the search, the coder and the loop cost the same for 16 entries
// as for 8. The search takes two ballots. The owner of the slot is the last
// thread of the half whose first boundary st[16i] + 16i is <= slot (a
// prefix, since the boundaries increase). The half's 16 lanes then load the
// owner's 16 boundaries from the copy, and the count c of those <= slot
// gives s = 16 * owner + c - 1; lanes c - 1 and c hold the interval's ends
// (entry 16 * owner + 16 after the last: st[256] = M gives 2^16 after byte
// 255). No warp reduction sits on the chain through x. The down masks come
// from a table in shared memory, row n for a thread whose first n entries
// are <= s. Both halves run the longer lane's steps, so that every ballot
// and shuffle has the whole warp; a half past its own length writes 0, and
// a half past B reads no word.
//
// Symbols come in, and results go out, 32 steps at a time: each thread
// loads or stores its own steps, and a shuffle (K8) or a select (K9) hands
// each step its value. The rate is fixed over each 16 steps (its thresholds
// 16, 32, 64 and 128 are multiples of 16), so the shift and its mask are
// made once per 16 steps. Steps run two a turn, so that each copy's buffer
// is fixed. The decoder loads its next word as soon as the pointer moves, a
// refill or more before it is needed.
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

namespace {

// adaptive_rate (models/functional.py): the base rate, slowed as the step
// grows
__device__ __forceinline__ int rate_at(int base, int t) {
  return base + (t >= 16) + (t >= 32) + (t >= 64) + (t >= 128);
}

constexpr int kV = 256;                            // the byte alphabet
constexpr int kM = (1 << 16) - kV;                 // 65280: state range
constexpr uint32_t kMM = (uint32_t)kM * 0x10001u;  // M in both halves
constexpr int kRow = 2 * (kV / 2 + 4);             // halves of a state copy: 256, M, padding to 16 B
constexpr int kThreads = 256;                      // a block
constexpr unsigned kAll = 0xFFFFFFFFu;

// (a & b) ^ c, one lop3
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a * b + c, an IMAD: on the FMA pipe, which the kernels' logic leaves idle
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 0xFFFF in each half of x whose bit 15 is set, else 0
__device__ __forceinline__ uint32_t half_signs(uint32_t x) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, 0xBB99;" : "=r"(d) : "r"(x), "r"(0u));
  return d;
}

// 1 and -1 that the compiler cannot see (a shuffle of blockDim.x /
// kThreads), so that a multiply-add by them stays an IMAD
struct Units {
  uint32_t one, neg;
};

__device__ __forceinline__ Units units() {
  const uint32_t one = __shfl_sync(kAll, blockDim.x / kThreads, 0);
  return {one, 0u - one};
}

// the shift of the 16 steps from t on, and what survives it in each half
struct Shift {
  int r;
  uint32_t mask;
};

__device__ __forceinline__ Shift shift_at(int rate, int t) {
  const int r = rate_at(rate, t);
  return {min(r, 16), r < 16 ? (0xFFFFu >> r) * 0x10001u : 0u};
}

// the initial state, (k * M) / V, of entries k0 .. k0 + 2W - 1
template <int W>
__device__ __forceinline__ void state_init(uint32_t (&st)[W], int k0) {
#pragma unroll
  for (int p = 0; p < W; ++p) {
    const uint32_t k = (uint32_t)(k0 + 2 * p);
    st[p] = ((k * kM) >> 8) | ((((k + 1) * kM) >> 8) << 16);
  }
}

// shift toward the one-hot CDF of the step's byte: the halves of `down`
// (0xFFFF where k <= s) toward 0, the rest toward M (see above)
template <int W>
__device__ __forceinline__ void state_update(uint32_t (&st)[W], const uint32_t (&down)[W],
                                             Shift sh, Units u) {
#pragma unroll
  for (int p = 0; p < W; ++p) {
    const uint32_t q = (st[p] & down[p]) | (mad(st[p], u.neg, kMM) & ~down[p]);  // st, or M - st
    st[p] = st[p] + and_xor(q >> sh.r, sh.mask, down[p]) - down[p];
  }
}

// entries k0 .. k0 + 2W - 1 into a lane's state copy, 16 bytes a store
template <int W>
__device__ __forceinline__ void state_store(uint16_t* copy, int k0, const uint32_t (&st)[W]) {
#pragma unroll
  for (int p = 0; p < W; p += 4)
    *reinterpret_cast<uint4*>(copy + k0 + 2 * p) = make_uint4(st[p], st[p + 1], st[p + 2], st[p + 3]);
}

// ---------------------------------------------------------------------------
// K8  o0c_intervals
// Replaces _intervals_kernel (lac_tpu/ops/pallas_rans.py:113-141), called
// through o0c_encode_intervals (:144, pallas_call :157).
// Bound on this card: integer work, the update of 255 moving 16-bit entries
// a symbol, against 9 bytes of traffic a symbol (derived in chip_smoke.py).
// Design: see above; one warp a lane, 8 entries a thread. All T steps run,
// the zero padding past a lane's length included, as the reference does
// (K2 reads only steps below the length).
// ---------------------------------------------------------------------------
constexpr int kIPer = 8;                 // entries a thread
constexpr int kIWords = kIPer / 2;       // packed pairs a thread
constexpr int kILanes = kThreads / 32;   // coding lanes a block

// one step of K8: `cur` holds the state before it, `nxt` gets the state
// after; thread j, which stores step t0 + j, keeps st[s] and st[s+1]
__device__ __forceinline__ void intervals_step(uint32_t (&st)[kIWords],
                                               const uint32_t (&off)[kIWords], int mine, int j,
                                               int ln, Shift sh, Units u, const uint16_t* cur,
                                               uint16_t* nxt, int& lo_st, int& hi_st) {
  const int s = __shfl_sync(kAll, mine, j);
  if (ln == j) {
    lo_st = cur[mine];
    hi_st = cur[mine + 1];  // st[256] = M after byte 255
  }
  uint32_t down[kIWords];
#pragma unroll
  for (int p = 0; p < kIWords; ++p) down[p] = half_signs(mad((uint32_t)s, 0x10001u, off[p]));
  state_update(st, down, sh, u);
  state_store(nxt, kIPer * ln, st);
  __syncwarp();  // the copy is whole before the next step reads it
}

__global__ void __launch_bounds__(kThreads)
o0c_intervals_kernel(const uint8_t* __restrict__ syms, int T, int B, int rate,
                     int32_t* __restrict__ lo_out, int32_t* __restrict__ fr_out) {
  __shared__ __align__(16) uint16_t copies[kILanes][2][kRow];
  const int ln = threadIdx.x & 31;
  const int b = blockIdx.x * kILanes + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  uint16_t(*copy)[kRow] = copies[threadIdx.x >> 5];
  const int k0 = kIPer * ln;
  const Units u = units();
  uint32_t st[kIWords], off[kIWords];
  state_init(st, k0);
  // the down masks' constants, through u.one so that ptxas keeps four
  // multiply-adds and does not rewrite three of them as adds to the first
#pragma unroll
  for (int p = 0; p < kIWords; ++p)
    off[p] = 0x7FFF8000u - ((uint32_t)k0 + (uint32_t)(2 * p) * u.one) * 0x10001u;
  if (ln == 0) copy[0][kV] = copy[1][kV] = kM;
  state_store(copy[0], k0, st);
  __syncwarp();
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int tt = t0 + ln;
    const int mine = tt < T ? syms[(size_t)tt * B + b] : 0;
    const int nstep = min(32, T - t0);
    int lo_st = 0, hi_st = 0;
    for (int h = 0; h < nstep; h += 16) {
      const Shift sh = shift_at(rate, t0 + h);
      const int end = min(h + 16, nstep);
#pragma unroll 1
      for (int j = h; j < end; j += 2) {  // t0 and h are even: copy[0] is before step j
        intervals_step(st, off, mine, j, ln, sh, u, copy[0], copy[1], lo_st, hi_st);
        if (j + 1 < end)
          intervals_step(st, off, mine, j + 1, ln, sh, u, copy[1], copy[0], lo_st, hi_st);
      }
    }
    if (tt < T) {
      lo_out[(size_t)tt * B + b] = lo_st + mine;
      fr_out[(size_t)tt * B + b] = hi_st - lo_st + 1;
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
// Bound on this card: integer work, K8's update and the search, against
// about 1.4 bytes of traffic a symbol. Design: see above; half a warp a
// lane, 16 entries a thread. A lane steps only below its length and writes
// 0 after it.
// ---------------------------------------------------------------------------
constexpr int kDPer = 16;                // entries a thread
constexpr int kDWords = kDPer / 2;       // packed pairs a thread
constexpr int kDLanes = kThreads / 16;   // coding lanes a block

// row n: the down masks of a thread whose first n entries are <= s (word
// p: the low half if n > 2p, the high half if n > 2p + 1)
struct DownMasks {
  uint4 row[kDPer + 1][kDWords / 4];
};

__device__ __forceinline__ void down_masks_init(DownMasks& dm) {
  const int i = threadIdx.x;
  if (i < (kDPer + 1) * kDWords) {
    const int n = i / kDWords, p = i % kDWords;
    reinterpret_cast<uint32_t*>(&dm.row[n][0])[p] =
        (n > 2 * p ? 0xFFFFu : 0u) | (n > 2 * p + 1 ? 0xFFFF0000u : 0u);
  }
  __syncthreads();
}

// a lane's rANS decoder: its state, its words and its next word
struct Decoder {
  uint32_t x, next;
  int pos, cap;
  const uint16_t* row;
};

// one step of K9 for the lane of the half `half` (a ballot mask): `cur`
// holds the state before it, `nxt` gets the state after; returns the byte
__device__ __forceinline__ int decode_step(uint32_t (&st)[kDWords], const DownMasks& dm,
                                           Decoder& dec, int hl, unsigned half, Shift sh,
                                           Units u, const uint16_t* cur, uint16_t* nxt) {
  const int k0 = kDPer * hl;
  const uint32_t slot = dec.x & 0xFFFFu;
  // the owner: the last thread whose first boundary st[k0] + k0 is <= slot;
  // (st[k0] + k0) << 16 is the low half of word 0 moved up by the multiply,
  // plus k0 << 16, and the sum stays below 2^32
  const unsigned owners =
      __ballot_sync(kAll, st[0] * 0x10000u + ((uint32_t)k0 << 16) <= slot << 16) & half;
  const int base = kDPer * (__popc(owners) - 1);  // the owner's first k
  const uint32_t e = (uint32_t)cur[base + hl] + (uint32_t)(base + hl);
  const uint32_t after = (uint32_t)cur[base + kDPer] + (uint32_t)(base + kDPer);
  const int c = __popc(__ballot_sync(kAll, e <= slot) & half);  // 1 .. 16
  const uint32_t lo = __shfl_sync(kAll, e, c - 1, 16);
  const uint32_t next_e = __shfl_sync(kAll, e, c, 16);
  const uint32_t hi = c < kDPer ? next_e : after;
  dec.x = (hi - lo) * (dec.x >> 16) + (slot - lo);
  if (dec.x < (1u << 16)) {
    dec.x = (dec.x << 16) | dec.next;
    ++dec.pos;
    dec.next = dec.pos < dec.cap ? dec.row[dec.pos] : 0u;
  }
  const int s = base + c - 1;
  uint32_t down[kDWords];
  const int n = min(max(s + 1 - k0, 0), kDPer);
#pragma unroll
  for (int p = 0; p < kDWords; p += 4) {
    const uint4 d = dm.row[n][p / 4];
    down[p] = d.x;
    down[p + 1] = d.y;
    down[p + 2] = d.z;
    down[p + 3] = d.w;
  }
  state_update(st, down, sh, u);
  state_store(nxt, k0, st);
  __syncwarp();  // the copy is whole before the next step reads it
  return s;
}

__global__ void __launch_bounds__(kThreads)
o0c_decode_kernel(const uint16_t* __restrict__ words, const int32_t* __restrict__ lengths,
                  int T, int B, int cap, int rate, uint8_t* __restrict__ syms) {
  // the mask table and the lanes' state copies, in one block of shared memory
  __shared__ __align__(16) struct {
    DownMasks dm;
    uint16_t copies[kDLanes][2][kRow];
  } shared;
  down_masks_init(shared.dm);
  const int ln = threadIdx.x & 31, hl = ln & 15, hf = ln >> 4;
  const int b0 = blockIdx.x * kDLanes + 2 * (threadIdx.x >> 5);
  if (b0 >= B) return;  // the whole warp
  const int b = b0 + hf;
  const bool live = b < B;
  const unsigned half = 0xFFFFu << (16 * hf);
  uint16_t(*copy)[kRow] = shared.copies[2 * (threadIdx.x >> 5) + hf];
  const Units u = units();
  const int n = live ? min(max(lengths[b], 0), T) : 0;
  const int steps = max(n, __shfl_xor_sync(kAll, n, 16));  // the warp's longer lane
  Decoder dec;
  dec.row = words + (size_t)(live ? b : 0) * cap;
  dec.cap = live ? cap : 0;
  dec.x = ((uint32_t)(dec.cap > 0 ? dec.row[0] : 0) << 16) |
          (uint32_t)(dec.cap > 1 ? dec.row[1] : 0);
  dec.pos = 2;
  dec.next = dec.pos < dec.cap ? dec.row[dec.pos] : 0u;
  uint32_t st[kDWords];
  state_init(st, kDPer * hl);
  if (hl == 0) copy[0][kV] = copy[1][kV] = kM;
  state_store(copy[0], kDPer * hl, st);
  __syncwarp();
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int nstep = min(32, steps - t0);
    int sym0 = 0, sym1 = 0;  // steps t0 + hl and t0 + 16 + hl; 0 from n on
    for (int h = 0; h < nstep; h += 16) {
      const Shift sh = shift_at(rate, t0 + h);
      const int end = min(h + 16, nstep);
#pragma unroll 1
      for (int j = h; j < end; j += 2) {  // t0 and h are even: copy[0] is before step j
        int s = decode_step(st, shared.dm, dec, hl, half, sh, u, copy[0], copy[1]);
        if (hl == j - h && t0 + j < n) (h ? sym1 : sym0) = s;
        if (j + 1 < end) {
          s = decode_step(st, shared.dm, dec, hl, half, sh, u, copy[1], copy[0]);
          if (hl == j + 1 - h && t0 + j + 1 < n) (h ? sym1 : sym0) = s;
        }
      }
    }
    if (live && t0 + hl < T) syms[(size_t)(t0 + hl) * B + b] = (uint8_t)sym0;
    if (live && t0 + 16 + hl < T) syms[(size_t)(t0 + 16 + hl) * B + b] = (uint8_t)sym1;
  }
}

}  // namespace

extern "C" {

int lac_o0c_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                      void* stream) {
  const int grid = (B + kILanes - 1) / kILanes;
  o0c_intervals_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)syms, T, B, rate, (int32_t*)lo, (int32_t*)fr);
  return (int)cudaGetLastError();
}

int lac_o0c_decode(const void* words, const void* lengths, void* syms, int T, int B,
                   int cap, int rate, void* stream) {
  const int grid = (B + kDLanes - 1) / kDLanes;
  o0c_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)words, (const int32_t*)lengths, T, B, cap, rate, (uint8_t*)syms);
  return (int)cudaGetLastError();
}

}  // extern "C"
