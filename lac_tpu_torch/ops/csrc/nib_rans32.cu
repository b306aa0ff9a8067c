// The nibble models' byte codec kernels for Hopper (sm_90a): the forward
// pass (K1, K4, K6) and the fused model + rANS-32/16 decoder (K3, K5, K7) of
// order0n, order1n and order2n, one template over the number of hi rows,
// kHiRows (1 for order0n, 16 for order1n and order2n), and of lo contexts,
// kLoCtx (16 for order0n and order1n, 64 for order2n). Encode chains K1, K4
// or K6 with K2 (rans32_encode_kernel, rans32_encode.cu), unchanged.
//
// Ports the nibble models' kernels of lac_tpu/ops/pallas_rans.py. The spec
// is models/functional.py (Order0NibCDF, Order1NibCDF, Order2NibCDF); the
// plain PyTorch versions in ops/rans_kernels.py step the same models, and
// the tests hold both to the JAX package.
//
// The model. A byte s = 16h + l codes as P(h) P(l | h). Each lane holds
// kHiRows hi rows (order1n and order2n pick one by the previous byte's hi
// nibble ph; order0n has one: hi_ctx below) and kLoCtx lo rows (picked by h
// in order0n and order1n, by h*4 + (ph >> 2) in order2n: lo_ctx below) of
// 17 nibble states st[0..16] in [0, 2^15], st[0] = 0 and st[16] = 2^15
// always (entry 0 moves toward 0 from 0, entry 16 toward 2^15 from 2^15).
// Nibble k's coding boundary is
// eff(st[k], k) = ((st[k] * 240) >> 15) + k, and a byte's interval is the
// hi interval composed with the lo one scaled by the hi width. After each
// byte both rows move toward their nibble's one-hot CDF (st - (st >> r) for
// k <= nibble, st + ((2^15 - st) >> r) above), each at the rate of its own
// row's visit count: r = rate_at(base, count).
//
// What bounds a lane: its steps are a chain, since a step may read the row
// the step before it wrote; the first port ran that chain on one thread a
// lane, about 1,400 cycles a step (16 loads, all 16 boundaries of each row,
// 32 updates and stores, the visit counts, a global load on the chain),
// with two warps an SM to hide it. Here the work of a step is spread over a
// group of 4 threads, and the card's limit is what those threads issue,
// most of it on the INT32 pipe (16 lanes a cycle a scheduler), far above
// the 9 bytes of global traffic a symbol (K4, K6) or about 1.4 (K5, K7). 4
// threads a lane issue the fewest instructions a lane-step that still give
// each scheduler two warps at block 4096 (62 lanes an SM): 8 threads a
// lane, or 2, were slower on the card (order2n).
//
// A group of threads a lane. Thread j of the group holds words 2j and
// 2j + 1 of each row the step uses, two 16-bit states a word (st[2p] in the
// low half of word p, st[2p + 1] in the high half), so one instruction
// moves two states. Every state stays in [0, 2^15], so the update of K8
// and K9 (o0c_rans32.cu) carries over with M = 2^15 in each half: q = st in
// a half that moves down, 2^15 - st in one that moves up; t = (q >> r) &
// mask (the mask clears what the whole-word shift drags from the high half
// into the low one); st + (t ^ down) - down. The down mask of a word
// (0xFFFF in each half whose k <= nibble) is one multiply-add and one prmt.
// Where an add or a shift can be a multiply-add, it is one (as in K8): the
// FMA pipe takes it, beside the busy INT32 pipe.
//
// The visit counts sit in the tables too: st[0] is always 0, so its half
// holds the row's count instead (a storage choice the bitstream does not
// see, docs/DESIGN.md:205-216), and a row's load brings its count to
// thread 0, which hands both rows' counts to its group with one shuffle.
// A count stops at 128, where the rate stops growing, and then
// eff(count, 0) = (128 * 240) >> 15 = 0 = eff(st[0], 0), so the boundaries
// read the half as st[0] without a mask. After the update thread 0 puts the
// count back into the half (one prmt on a per-thread selector that is the
// identity for the other threads). order0n's hi row adapts at the step's
// rate, rate_at(base, t); it is its lane's one hi row, visited at every
// step, so its visit count before step t is t, and its count half carries
// the step, capped at 128 like any count: the same rate, with no logic of
// its own.
//
// Tables. A row is 8 words (32 bytes); a warp's lanes keep their rows
// interleaved, [row][lane of the warp][word], so the words a warp reads at
// once lie in distinct banks whatever rows its lanes pick. A block is one
// warp, 8 lanes. A lane's tables are kHiRows + kLoCtx rows: order2n's 80
// rows are 2,560 bytes, 20,480 a block (K7 adds a 1,040-byte table), and an
// SM holds 10 such blocks (228 KB less 1 KB a block), 80 lanes; order1n's
// 32 rows are 1,024 bytes, 8,192 a block (K5 9,232), so an SM holds 25 K4
// blocks or 22 K5 blocks, 200 or 176 lanes; order0n's 17 rows are 544
// bytes, 4,352 a block (K3 5,392), so the SM's limit of 32 blocks binds
// before shared memory does: 256 lanes.
//
// Each thread reads and writes only its own words of a row, so no warp
// barrier orders the tables: a thread's shared-memory accesses keep their
// order. A row the next step also uses stays in registers (and is stored
// once it leaves them); the loads of the next step's rows are issued a step
// ahead, before this step's stores, and are dropped for a row that repeats.
// Hi rows (below kHiRows) and lo rows (from kHiRows) never alias. order0n's
// one hi row repeats at every step, known at compile time, so it stays in
// registers from step 0 on: no hi row is loaded, stored or selected in its
// loops. In order0n and order1n the lo row repeats whenever two
// neighbouring bytes share a hi nibble; K3, K5 and K7 load and store the lo
// row every step, which program order keeps right when it repeats.
//
// K1, K4, K6 (intervals): the step's byte is known before the step, so the
// interval needs only st[n] and st[n+1] of each row: the thread that holds
// st[n] forms the pair from its words and its neighbour's first word, and
// one shuffle hands the pair to the group. Thread j keeps the pairs of step
// t0 + j and turns them into (lo, fr) once every 4 steps. Symbols come 16
// steps at a time, byte i of a thread's word holding step t0 + 4i + j,
// loaded 16 steps ahead.
//
// K3, K5, K7 (decode): each nibble is found by one ballot over the group: the
// owner of the slot is the last thread whose first boundary is <= it (a
// prefix, since boundaries increase), and the owner's boundaries, counted,
// give the nibble and its interval, handed to the group in one shuffle
// (row_search). The lo nibble's boundaries are scaled by f_h; the search
// compares them unscaled with floor(r / f_h), which a table of 2^31 / f
// gives exactly. The lo row and that table entry are loaded as soon as h
// is known, the next hi row (picked by h in order1n and order2n) too. Each
// step loads the word at the lane's pointer as it starts and takes it at
// its end if the state needs a refill: the load has the step's search to
// arrive, and no step waits on
// a load of the step before (loading at a refill, for the next one, put
// that wait on every step after a refill: 16 % slower on the card).
//
// Every shuffle and vote names the whole warp (a ballot's bits are then
// masked to the group): with a mask known only at run time, the compiler
// checks the named threads' convergence before each one (MATCH.ANY and
// REDUX.OR, then a branch), and those checks cost more than the step. So
// the groups of a warp step together: the decoders run the warp's longest
// lane, a group past its lane's length stepping on without effect (it
// writes 0 for those steps), and a group past B (in the grid's last warp)
// codes nothing, reads no symbol or word and writes nothing. Steps go 4 at
// a time with no branch among them (the last 4 may run past T, writing
// nothing), so that the compiler can lay a step's row updates into the
// waits of the next step's search.
//
// Layout: symbols, intervals and decoded bytes are time-major [T, B]; word
// rows are lane-major [B, cap], and a lane reads 0 past cap.
//
// Built by ops/_build.py with the other csrc/*.cu files into one library,
// bound with ctypes. Each entry point launches on the given stream, does
// not synchronise, and returns cudaGetLastError() after its launch. No
// PyTorch header is included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kG = 4;                         // threads a lane, two words of a row each
constexpr int kL = 32 / kG;                   // lanes a warp, and a block
constexpr int kRowWords = 8;                  // 16 states a row, two a word
constexpr int kRowStride = kL * kRowWords;    // words from one row to the next
constexpr int kRcp = 260;                     // K5's, K7's table of 2^31 / f, f = 1 .. 256, padded
// a block's tables, kHiRows hi rows then kLoCtx lo rows; the decoders add
// the table of 2^31 / f
template <int kHiRows, int kLoCtx>
constexpr int kTableBytes = (kHiRows + kLoCtx) * kRowStride * 4;
template <int kHiRows, int kLoCtx>
constexpr int kDecodeBytes = kTableBytes<kHiRows, kLoCtx> + kRcp * 4;
constexpr uint32_t kTop = 0x8000u;            // 2^15: st[16], and M of the update
constexpr uint32_t kTopPair = 0x80008000u;    // 2^15 in both halves
constexpr uint32_t kCountMax = 128;           // a count stops where the rate does
constexpr unsigned kAll = 0xFFFFFFFFu;

// prmt.b32 in its default mode: byte i of the result is the byte of {b, a}
// that nibble i of s names, its sign spread over it if bit 3 of the nibble is
// set
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// a * b + c, and the high word of a * b plus c: IMADs, on the FMA pipe, which
// the kernels' logic on the INT32 pipe leaves idle
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the coding boundary ((st * 240) >> 15) + k of the state st in the low or
// the high half of a word: the high word of (st << 16) * 480, plus k, in one
// IMAD
__device__ __forceinline__ uint32_t eff_lo(uint32_t w, uint32_t k) {
  return mad_hi(w << 16, 480u, k);
}

__device__ __forceinline__ uint32_t eff_hi(uint32_t w, uint32_t k) {
  return mad_hi(w & 0xFFFF0000u, 480u, k);
}

// the shift of a row visited c times (c <= 128), and what survives it in
// each half: rate_at(base, c) = base + (c >= 16) + (c >= 32) + (c >= 64) +
// (c >= 128) is base + the bit length of c >> 4; a shift of 16 empties a
// half, as any larger one does
struct Shift {
  uint32_t r, mask;
};

__device__ __forceinline__ Shift shift_of(int base, uint32_t c) {
  const uint32_t r = (uint32_t)min(base + 32 - __clz((int)(c >> 4)), 16);
  return {r, mad(0xFFFFu >> r, 0x10001u, 0u)};
}

// What a thread knows of its place: its words of row 0, the constants of
// its words, its group.
struct Thread {
  uint32_t* row0;   // this thread's two words of row 0 in its warp's tables
  uint32_t off[2];  // 0x7FFF8000 - k * 0x10001 for each word's first state k
  uint32_t k[4];    // its states' indices, 4j .. 4j + 3
  uint32_t neg;     // -1, which the compiler cannot see, so that a
                    // multiply-add by it stays an IMAD
  uint32_t sel0;    // prmt selector that puts the count into word 0 (thread 0)
  unsigned grp;     // the group's lanes of the warp, to mask a ballot
  int j;            // index in the group
  bool last;        // the group's last thread (st[16] follows its words)
  bool live;        // its lane is below B

  __device__ uint32_t* row(int r) const { return row0 + r * kRowStride; }
};

__device__ __forceinline__ void load_row(const uint32_t* p, uint32_t (&w)[2]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  w[0] = v.x;
  w[1] = v.y;
}

__device__ __forceinline__ void store_row(uint32_t* p, const uint32_t (&w)[2]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// the hi row of a byte after a byte whose hi nibble was ph: ph in order1n
// and order2n; in order0n the one row 0, so that two steps' hi rows are the
// same at compile time
template <int kHiRows>
__device__ __forceinline__ uint32_t hi_ctx(uint32_t ph) {
  static_assert(kHiRows == 1 || kHiRows == 16, "order0n, or order1n and order2n");
  return kHiRows == 1 ? 0u : ph;
}

// the lo context of byte (h, .) after a byte whose hi nibble was ph: h in
// order0n and order1n, h*4 + (ph >> 2) in order2n; its row is kHiRows + that
template <int kLoCtx>
__device__ __forceinline__ uint32_t lo_ctx(uint32_t h, uint32_t ph) {
  static_assert(kLoCtx == 16 || kLoCtx == 64, "order0n and order1n, or order2n");
  return kLoCtx == 16 ? h : h * 4u + (ph >> 2);
}

// one warp a block: the place of thread `ln`, whose lane is b, and its
// tables initialised uniform (st[k] = k << 11, count 0)
template <int kHiRows, int kLoCtx>
__device__ __forceinline__ Thread thread_init(uint32_t* tables, int ln, int b, int B) {
  Thread th;
  th.live = b < B;
  th.j = ln % kG;
  th.grp = 0xFu << (ln & ~(kG - 1));
  th.last = th.j == kG - 1;
  th.sel0 = th.j == 0 ? 0x3254u : 0x3210u;
  th.neg = 0u - __shfl_sync(kAll, blockDim.x >> 5, 0);
  th.row0 = tables + (ln / kG) * kRowWords + th.j * 2;
  uint32_t init[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) th.k[i] = (uint32_t)(4 * th.j + i);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t k = th.k[2 * i];
    th.off[i] = 0x7FFF8000u - k * 0x10001u;
    init[i] = (k << 11) | ((k + 1u) << 27);
  }
#pragma unroll
  for (int r = 0; r < kHiRows + kLoCtx; ++r) store_row(th.row(r), init);
  return th;
}

// move a row toward nibble n at shift sh and count its visit: c is its
// count before the visit
__device__ __forceinline__ void row_update(uint32_t (&w)[2], const Thread& th, uint32_t n,
                                           Shift sh, uint32_t c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // 0x8000 + n - k in the low half, 0x8000 + n - (k + 1) in the high one
    const uint32_t down = prmt(mad(n, 0x10001u, th.off[i]), 0u, 0xBB99u);
    const uint32_t st = w[i];
    const uint32_t q = (st & down) | (mad(st, th.neg, kTopPair) & ~down);  // st, or 2^15 - st
    w[i] = st + (((q >> sh.r) & sh.mask) ^ down) - down;
  }
  w[0] = prmt(w[0], min(c + 1u, kCountMax), th.sel0);
}

// both rows' visit counts, from thread 0: the first's in the low half
__device__ __forceinline__ uint32_t counts(const uint32_t (&a)[2], const uint32_t (&b)[2]) {
  return __shfl_sync(kAll, prmt(a[0], b[0], 0x5410u), 0, kG);
}

// ---------------------------------------------------------------------------
// K1  o0n_intervals (kHiRows 1, kLoCtx 16)
// Replaces _o0n_intervals_kernel (lac_tpu/ops/pallas_rans.py:742-791),
// called through o0n_encode_intervals (:794, pallas_call :804).
// K4  o1n_intervals (kHiRows 16, kLoCtx 16)
// Replaces _o1n_intervals_kernel (lac_tpu/ops/pallas_rans.py:1044-1107),
// called through o1n_encode_intervals (:1110, pallas_call :1120).
// K6  o2n_intervals (kHiRows 16, kLoCtx 64)
// Replaces _o2n_intervals_kernel (lac_tpu/ops/pallas_rans.py:1277-1341),
// called through o2n_encode_intervals (:1344, pallas_call :1353).
// Bound on this card: the instructions a lane-step issues on the INT32 pipe
// (the two rows' updates, the interval's pairs, the counts), against 9
// bytes of global traffic a symbol. Design: see above. All T steps run, the
// zero padding past a lane's length included, as the reference does (K2
// reads only steps below the length).
// ---------------------------------------------------------------------------

// (st[n], st[n+1]) of a row, as the low and high half of a word, to every
// thread of the group: the owner of st[n] forms it from its words and its
// neighbour's first word (2^15 after the last thread)
__device__ __forceinline__ uint32_t row_pair(const uint32_t (&w)[2], uint32_t n,
                                             const Thread& th) {
  const uint32_t down = __shfl_down_sync(kAll, w[0], 1, kG);  // every thread shuffles
  const uint32_t nb = th.last ? kTop : down;
  const bool second = n & 2u;  // st[n] is in the owner's second word
  return __shfl_sync(kAll, __funnelshift_r(second ? w[1] : w[0], second ? nb : w[1],
                                           (n & 1u) * 16u),
                     (int)(n >> 2), kG);
}

template <int kHiRows, int kLoCtx>
__global__ void __launch_bounds__(32)
nib_intervals_kernel(const uint8_t* __restrict__ syms, int T, int B, int rate,
                     int32_t* __restrict__ lo_out, int32_t* __restrict__ fr_out) {
  extern __shared__ __align__(16) uint32_t tables[];
  const int ln = threadIdx.x & 31;
  const int b = blockIdx.x * kL + ln / kG;
  const Thread th = thread_init<kHiRows, kLoCtx>(tables, ln, b, B);
  constexpr int kChunk = 4 * kG;  // steps a word of symbols covers

  // byte i of the word: the symbol of step t0 + G i + j (0 from T on)
  const uint8_t* col = syms + b;
  auto chunk = [&](int t0) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + kG * i + th.j;
      if (th.live && t < T) v |= (uint32_t)col[(size_t)t * B] << (8 * i);
    }
    return v;
  };
  uint32_t cur = chunk(0), nxt = chunk(kChunk);

  // step 0: after ph = 0, its rows (the hi row is row 0 in every model)
  uint32_t s = __shfl_sync(kAll, cur, 0, kG) & 0xFFu;
  uint32_t ph = 0, h = s >> 4, l = s & 15u, lrow = kHiRows + lo_ctx<kLoCtx>(h, 0u);
  uint32_t rh[2], rl[2];
  load_row(th.row(0), rh);
  load_row(th.row((int)lrow), rl);

  for (int t0 = 0; t0 < T; t0 += kG) {
    uint32_t keep_h = 0, keep_l = 0;  // the pairs of step t0 + j
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      // the next step's byte and rows; their loads go out now, and are not
      // made for a row this step uses (it stays in registers)
      const uint32_t sx = __shfl_sync(kAll, cur, u + 1 < kG ? u + 1 : 0, kG);
      const uint32_t s1 = (u + 1 < kG ? sx : sx >> 8) & 0xFFu;
      const uint32_t lrow1 = kHiRows + lo_ctx<kLoCtx>(s1 >> 4, h);
      const bool same_h = hi_ctx<kHiRows>(h) == hi_ctx<kHiRows>(ph), same_l = lrow1 == lrow;
      uint32_t nh[2], nl[2];
      if (!same_h) load_row(th.row((int)hi_ctx<kHiRows>(h)), nh);
      if (!same_l) load_row(th.row((int)lrow1), nl);

      const uint32_t pair_h = row_pair(rh, h, th), pair_l = row_pair(rl, l, th);
      if (th.j == u) {
        keep_h = pair_h;
        keep_l = pair_l;
      }
      const uint32_t c = counts(rh, rl);
      row_update(rh, th, h, shift_of(rate, c & 0xFFFFu), c & 0xFFFFu);
      row_update(rl, th, l, shift_of(rate, c >> 16), c >> 16);
      if (!same_h) store_row(th.row((int)hi_ctx<kHiRows>(ph)), rh);
      if (!same_l) store_row(th.row((int)lrow), rl);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rh[i] = same_h ? rh[i] : nh[i];
        rl[i] = same_l ? rl[i] : nl[i];
      }
      ph = h;
      h = s1 >> 4;
      l = s1 & 15u;
      lrow = lrow1;
    }
    // step t0 + j's interval from its pairs: its byte is byte 0 of cur
    const int t = t0 + th.j;
    if (th.live && t < T) {
      const uint32_t sj = cur & 0xFFu, hj = sj >> 4, lj = sj & 15u;
      const uint32_t loh = eff_lo(keep_h, hj), fh = eff_hi(keep_h, hj + 1) - loh;
      const uint32_t lol = eff_lo(keep_l, lj), fl = eff_hi(keep_l, lj + 1) - lol;
      lo_out[(size_t)t * B + b] = (int32_t)((loh << 8) + fh * lol);
      fr_out[(size_t)t * B + b] = (int32_t)(fh * fl);
    }
    cur = __funnelshift_r(cur, nxt, 8);
    nxt >>= 8;
    if ((t0 / kG) % 4 == 3) nxt = chunk(t0 + kG + kChunk);  // cur holds t0 + G on
  }
}

// ---------------------------------------------------------------------------
// K3  o0n_decode (kHiRows 1, kLoCtx 16)
// Replaces _o0n_decode_fused_kernel (lac_tpu/ops/pallas_rans.py:849-918),
// called through _o0n_decode_fused (:1012) / o0n_rans32_decode (:1024);
// pallas_call in _nib_decode_call (:951).
// K5  o1n_decode (kHiRows 16, kLoCtx 16)
// Replaces _o1n_decode_fused_kernel (lac_tpu/ops/pallas_rans.py:1148-1226),
// called through _o1n_decode_fused (:1240) / o1n_rans32_decode (:1254);
// pallas_call in _nib_decode_call (:951).
// K7  o2n_decode (kHiRows 16, kLoCtx 64)
// Replaces _o2n_decode_fused_kernel (lac_tpu/ops/pallas_rans.py:1382-1462),
// called through _o2n_decode_fused (:1477) / o2n_rans32_decode (:1491);
// pallas_call in _nib_decode_call (:951).
// Bound on this card: each lane's chain (a step's slot needs the state the
// step before left, and the lo row is known only once h is), and what its
// steps issue on the INT32 pipe, against about 1.4 bytes of global traffic
// a symbol. Design: see above.
// ---------------------------------------------------------------------------

// the nibble a value falls in, and the boundaries either side of it
struct Found {
  uint32_t k, lo, hi;
};

// the last k whose boundary eff[k] is <= v (v <= 255; boundaries increase,
// and eff[0] = 0): the owner is the last thread whose first boundary is
// <= v. It counts its other three in one subtract, three 10-bit fields of
// v + 512 less e1, e2, e3, whose bit 9 stays set where e <= v; the count c
// picks the pair (eff[c], eff[c+1]) with one funnel shift out of its five
// boundaries at 9 bits each, and one shuffle hands (pair, c) to the group
__device__ __forceinline__ Found row_search(const uint32_t (&w)[2], uint32_t v,
                                            const Thread& th) {
  const uint32_t e0 = eff_lo(w[0], th.k[0]), e1 = eff_hi(w[0], th.k[1]);
  const uint32_t e2 = eff_lo(w[1], th.k[2]), e3 = eff_hi(w[1], th.k[3]);
  const uint32_t next_e = __shfl_down_sync(kAll, e0, 1, kG);  // every thread shuffles
  const uint32_t e4 = th.last ? 256u : next_e;
  const unsigned own = __ballot_sync(kAll, e0 <= v) & th.grp;
  const uint32_t fields = mad(e3, 1u << 20, mad(e2, 1u << 10, e1));
  const uint32_t le = mad(fields, th.neg, mad(v, 0x100401u, 0x20080200u));
  const uint32_t c = __popc(le & 0x20080200u);
  const uint32_t lo = mad(e3, 1u << 27, mad(e2, 1u << 18, mad(e1, 1u << 9, e0)));
  const uint32_t hi = mad(e4, 16u, e3 >> 5);
  const uint32_t pair = __funnelshift_r(lo, hi, c * 9u) & 0x3FFFFu;
  const int owner = __popc(own) - 1;
  const uint32_t got = __shfl_sync(kAll, pair | (c << 18), owner, kG);
  return {4u * (uint32_t)owner + (got >> 18), got & 511u, (got >> 9) & 511u};
}

template <int kHiRows, int kLoCtx>
__global__ void __launch_bounds__(32)
nib_decode_kernel(const uint16_t* __restrict__ words, const int32_t* __restrict__ lengths,
                  int T, int B, int cap, int rate, uint8_t* __restrict__ syms) {
  extern __shared__ __align__(16) uint32_t tables[];
  const int ln = threadIdx.x & 31;
  const int b = blockIdx.x * kL + ln / kG;
  const Thread th = thread_init<kHiRows, kLoCtx>(tables, ln, b, B);
  // rcp[f] = ceil(2^31 / f): floor(r / f) = the high word of 2r * rcp[f]
  // for r < 2^16 and f <= 256 (the error, under r / 2^31, is below the
  // 1 / f that separates r / f from the next integer)
  uint32_t* rcp = tables + (kHiRows + kLoCtx) * kRowStride;
#pragma unroll
  for (int i = 0; i < (kRcp + 31) / 32; ++i) {
    const uint32_t f = (uint32_t)(32 * i + ln);
    if (f >= 1 && f <= 256) rcp[f] = (0x80000000u + f - 1u) / f;
  }
  __syncwarp();

  const int n = th.live ? min(max(lengths[b], 0), T) : 0;
  const int steps = __reduce_max_sync(kAll, n);  // the warp's longest lane
  const uint16_t* wrow = words + (size_t)(th.live ? b : 0) * cap;
  const int rcap = th.live ? cap : 0;  // a lane past B reads no word
  uint32_t x = ((uint32_t)(rcap > 0 ? wrow[0] : 0) << 16) | (uint32_t)(rcap > 1 ? wrow[1] : 0);
  int pos = 2;
  uint32_t ph = 0;
  uint32_t rh[2];
  load_row(th.row(0), rh);

  for (int t0 = 0; t0 < T; t0 += kG) {
    uint32_t keep = 0;  // the byte of step t0 + j; 0 from n on
    if (t0 < steps) {  // the warp's lanes: 4 steps, no branch among them
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        const uint32_t next = pos < rcap ? wrow[pos] : 0u;  // for a refill at the end
        const uint32_t slot = x & 0xFFFFu;
        const Found fh = row_search(rh, slot >> 8, th);
        const uint32_t h = fh.k, f_h = fh.hi - fh.lo, r = slot - (fh.lo << 8);
        // the next step's hi row (row h in order1n and order2n): loaded now,
        // unless it is this one
        const bool same_h = hi_ctx<kHiRows>(h) == hi_ctx<kHiRows>(ph);
        uint32_t nh[2];
        if (!same_h) load_row(th.row((int)hi_ctx<kHiRows>(h)), nh);
        const int lrow = kHiRows + (int)lo_ctx<kLoCtx>(h, ph);
        uint32_t rl[2];
        load_row(th.row(lrow), rl);
        // the lo nibble: the last k with f_h * eff[k] <= r, so eff[k] <= r / f_h
        const Found fl = row_search(rl, __umulhi(2u * r, rcp[f_h]), th);
        const uint32_t lo_s = f_h * fl.lo;
        x = f_h * (fl.hi - fl.lo) * (x >> 16) + (r - lo_s);
        const bool refill = x < (1u << 16);
        x = refill ? mad(x, 1u << 16, next) : x;
        pos += refill;
        if (th.j == u && t0 + u < n) keep = (h << 4) | fl.k;

        const uint32_t c = counts(rh, rl);
        row_update(rh, th, h, shift_of(rate, c & 0xFFFFu), c & 0xFFFFu);
        row_update(rl, th, fl.k, shift_of(rate, c >> 16), c >> 16);
        if (!same_h) store_row(th.row((int)hi_ctx<kHiRows>(ph)), rh);
        store_row(th.row(lrow), rl);
#pragma unroll
        for (int i = 0; i < 2; ++i) rh[i] = same_h ? rh[i] : nh[i];
        ph = h;
      }
    }
    const int t = t0 + th.j;
    if (th.live && t < T) syms[(size_t)t * B + b] = (uint8_t)keep;
  }
}

template <int kHiRows, int kLoCtx>
int launch_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                     void* stream) {
  nib_intervals_kernel<kHiRows, kLoCtx>
      <<<(B + kL - 1) / kL, 32, kTableBytes<kHiRows, kLoCtx>, (cudaStream_t)stream>>>(
          (const uint8_t*)syms, T, B, rate, (int32_t*)lo, (int32_t*)fr);
  return (int)cudaGetLastError();
}

template <int kHiRows, int kLoCtx>
int launch_decode(const void* words, const void* lengths, void* syms, int T, int B, int cap,
                  int rate, void* stream) {
  nib_decode_kernel<kHiRows, kLoCtx>
      <<<(B + kL - 1) / kL, 32, kDecodeBytes<kHiRows, kLoCtx>, (cudaStream_t)stream>>>(
          (const uint16_t*)words, (const int32_t*)lengths, T, B, cap, rate, (uint8_t*)syms);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the launch shape of K1, K3-K7: lanes a block (kG threads each, one warp),
// and each kernel's dynamic shared bytes a block
int lac_nib_lanes() { return kL; }

int lac_o0n_intervals_shared_bytes() { return kTableBytes<1, 16>; }

int lac_o0n_decode_shared_bytes() { return kDecodeBytes<1, 16>; }

int lac_o1n_intervals_shared_bytes() { return kTableBytes<16, 16>; }

int lac_o1n_decode_shared_bytes() { return kDecodeBytes<16, 16>; }

int lac_o2n_intervals_shared_bytes() { return kTableBytes<16, 64>; }

int lac_o2n_decode_shared_bytes() { return kDecodeBytes<16, 64>; }

int lac_o0n_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                      void* stream) {
  return launch_intervals<1, 16>(syms, lo, fr, T, B, rate, stream);
}

int lac_o0n_decode(const void* words, const void* lengths, void* syms, int T, int B,
                   int cap, int rate, void* stream) {
  return launch_decode<1, 16>(words, lengths, syms, T, B, cap, rate, stream);
}

int lac_o1n_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                      void* stream) {
  return launch_intervals<16, 16>(syms, lo, fr, T, B, rate, stream);
}

int lac_o1n_decode(const void* words, const void* lengths, void* syms, int T, int B,
                   int cap, int rate, void* stream) {
  return launch_decode<16, 16>(words, lengths, syms, T, B, cap, rate, stream);
}

int lac_o2n_intervals(const void* syms, void* lo, void* fr, int T, int B, int rate,
                      void* stream) {
  return launch_intervals<16, 64>(syms, lo, fr, T, B, rate, stream);
}

int lac_o2n_decode(const void* words, const void* lengths, void* syms, int T, int B,
                   int cap, int rate, void* stream) {
  return launch_decode<16, 64>(words, lengths, syms, T, B, cap, rate, stream);
}

}  // extern "C"
