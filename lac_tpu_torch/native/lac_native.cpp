// Native host runtime for the lac_tpu byte path.
//
// Implements the shift-to-target CDF model + rANS-32/16 coder with EXACTLY
// the arithmetic of the Pallas kernels (ops/pallas_rans.py) and the NumPy
// spec (coder/rans.py): same init, same adaptive-rate schedule, same coder
// renormalization — so host- and TPU-produced containers are bit-identical
// and interchangeable (asserted in tests/test_native.py).
//
// This is the framework's CPU fast path (the reference's only native code
// was the external llama.cpp inference engine; here the native runtime is
// the block coder itself). OpenMP parallelizes across blocks.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o liblac_native.so lac_native.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int V = 256;

inline int rate_at(int base, int t) {
  return base + (t >= 16) + (t >= 32) + (t >= 64) + (t >= 128);
}

// The model state lives pre-scaled in the coder domain [0, M = 2^pb - V];
// coder cdf boundary of symbol k is st[k] + k (matches models.functional
// and ops/pallas_rans after the pre-scaled-state spec change).
struct Model {
  int32_t st[V];  // st[0] == 0 always; implicit st[V] == M
  void init(int32_t M) {
    for (int k = 0; k < V; k++) st[k] = (int32_t)(((int64_t)k * M) / V);
  }
  void update(int sym, int r, int32_t M) {
    for (int k = 0; k <= sym; k++) st[k] -= st[k] >> r;
    for (int k = sym + 1; k < V; k++) st[k] += (M - st[k]) >> r;
  }
};

inline void interval_of(const Model& m, int sym, int32_t M, int pb,
                        int32_t* lo, int32_t* fr) {
  int32_t l = m.st[sym] + sym;
  int32_t h = (sym + 1 >= V) ? (int32_t)(1 << pb) : (m.st[sym + 1] + sym + 1);
  *lo = l;
  *fr = h - l;
}

}  // namespace

extern "C" {

// Encode one block. words must have capacity n + 2. Returns word count
// (decode order: x_hi, x_lo, then emitted words by ascending position).
int o0c_encode_block(const uint8_t* data, int n, int rate, int pb,
                     uint16_t* words) {
  const int32_t M = (int32_t)((1 << pb) - V);
  std::vector<int32_t> lo(n), fr(n);
  Model m;
  m.init(M);
  for (int t = 0; t < n; t++) {
    interval_of(m, data[t], M, pb, &lo[t], &fr[t]);
    m.update(data[t], rate_at(rate, t), M);
  }
  // reverse-order rANS-32/16
  std::vector<uint16_t> emitted;  // emission order (t descending)
  emitted.reserve(n / 2 + 4);
  uint32_t x = 1u << 16;
  for (int t = n - 1; t >= 0; t--) {
    uint32_t f = (uint32_t)fr[t];
    uint32_t x_max = f << (32 - pb);
    if (x >= x_max) {
      emitted.push_back((uint16_t)(x & 0xFFFF));
      x >>= 16;
    }
    x = ((x / f) << pb) + (x % f) + (uint32_t)lo[t];
  }
  words[0] = (uint16_t)(x >> 16);
  words[1] = (uint16_t)(x & 0xFFFF);
  int nw = 2;
  for (int i = (int)emitted.size() - 1; i >= 0; i--) words[nw++] = emitted[i];
  return nw;
}

// Decode one block of n symbols from decode-ordered words.
void o0c_decode_block(const uint16_t* words, int n, int rate, int pb,
                      uint8_t* out) {
  const int32_t M = (int32_t)((1 << pb) - V);
  const uint32_t mask = (1u << pb) - 1;
  Model m;
  m.init(M);
  uint32_t x = ((uint32_t)words[0] << 16) | words[1];
  int pos = 2;
  for (int t = 0; t < n; t++) {
    int32_t slot = (int32_t)(x & mask);
    // binary search: largest s in [0, V-1] with eff(s) <= slot
    int lo_k = 0, hi_k = V;  // invariant: eff(lo_k) <= slot < eff(hi_k)
    while (hi_k - lo_k > 1) {
      int mid = (lo_k + hi_k) >> 1;
      int32_t eff = m.st[mid] + mid;
      if (eff <= slot)
        lo_k = mid;
      else
        hi_k = mid;
    }
    int s = lo_k;
    int32_t l, f;
    interval_of(m, s, M, pb, &l, &f);
    x = (uint32_t)f * (x >> pb) + (uint32_t)(slot - l);
    if (x < (1u << 16)) x = (x << 16) | words[pos++];
    out[t] = (uint8_t)s;
    m.update(s, rate_at(rate, t), M);
  }
}

// Batched, OpenMP-parallel over blocks. lengths[i] symbols per block;
// words_out is [nblocks, block_size + 2] row-major; nwords_out per block.
void o0c_encode_blocks(const uint8_t* data, const int32_t* offsets,
                       const int32_t* lengths, int nblocks, int cap, int rate,
                       int pb, uint16_t* words_out, int32_t* nwords_out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nblocks; i++) {
    nwords_out[i] = o0c_encode_block(data + offsets[i], lengths[i], rate, pb,
                                     words_out + (int64_t)i * cap);
  }
}

void o0c_decode_blocks(const uint16_t* words, const int32_t* lengths,
                       int nblocks, int cap, int rate, int pb,
                       const int32_t* out_offsets, uint8_t* out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nblocks; i++) {
    o0c_decode_block(words + (int64_t)i * cap, lengths[i], rate, pb,
                     out + out_offsets[i]);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// order0n: nibble-factorized model (codec 3; spec in models/functional.py
// Order0NibCDF and kernels in ops/pallas_rans.py). Two 8-bit nibble CDFs
// compose into one 16-bit rANS step per byte:
//   lo12 = (lo_h << 8) + f_h * lo_l,  f12 = f_h * f_l.
// States are 15-bit internally, scaled to the 8-bit coding domain per step.
// The rANS layer is byte-identical to o0c's (pb = 16).
// ---------------------------------------------------------------------------

namespace {

constexpr int NV = 16;
constexpr int32_t NS = 1 << 15;
constexpr int32_t NM = 256 - NV;  // 240

struct NibModel {
  int32_t sh[NV + 1];
  int32_t sl[NV][NV + 1];
  int32_t cnt[NV];
  void init() {
    for (int k = 0; k <= NV; k++) sh[k] = k * (NS / NV);
    for (int c = 0; c < NV; c++)
      for (int k = 0; k <= NV; k++) sl[c][k] = k * (NS / NV);
    for (int c = 0; c < NV; c++) cnt[c] = 0;
  }
  static inline int32_t eff(const int32_t* st, int k) {
    return ((st[k] * NM) >> 15) + k;
  }
  static inline void shift_update(int32_t* st, int nib, int r) {
    for (int k = 0; k <= nib; k++) st[k] -= st[k] >> r;
    for (int k = nib + 1; k <= NV; k++) st[k] += (NS - st[k]) >> r;
  }
  // composed (lo12, f12) of byte s at the current state
  inline void interval_of(int s, int32_t* lo12, int32_t* f12) const {
    const int h = s >> 4, l = s & 15;
    const int32_t loh = eff(sh, h), fh = eff(sh, h + 1) - loh;
    const int32_t lol = eff(sl[h], l), fl = eff(sl[h], l + 1) - lol;
    *lo12 = (loh << 8) + fh * lol;
    *f12 = fh * fl;
  }
  inline void update(int s, int base_rate, int t) {
    const int h = s >> 4, l = s & 15;
    shift_update(sh, h, rate_at(base_rate, t));
    shift_update(sl[h], l, rate_at(base_rate, cnt[h]));
    cnt[h]++;
  }
};

}  // namespace

extern "C" {

int o0n_encode_block(const uint8_t* data, int n, int rate, uint16_t* words) {
  constexpr int pb = 16;
  std::vector<int32_t> lo(n), fr(n);
  NibModel m;
  m.init();
  for (int t = 0; t < n; t++) {
    m.interval_of(data[t], &lo[t], &fr[t]);
    m.update(data[t], rate, t);
  }
  std::vector<uint16_t> emitted;
  emitted.reserve(n / 2 + 4);
  uint32_t x = 1u << 16;
  for (int t = n - 1; t >= 0; t--) {
    uint32_t f = (uint32_t)fr[t];
    uint32_t x_max = f << (32 - pb);
    if (x >= x_max) {
      emitted.push_back((uint16_t)(x & 0xFFFF));
      x >>= 16;
    }
    x = ((x / f) << pb) + (x % f) + (uint32_t)lo[t];
  }
  words[0] = (uint16_t)(x >> 16);
  words[1] = (uint16_t)(x & 0xFFFF);
  int nw = 2;
  for (int i = (int)emitted.size() - 1; i >= 0; i--) words[nw++] = emitted[i];
  return nw;
}

void o0n_decode_block(const uint16_t* words, int n, int rate, uint8_t* out) {
  constexpr int pb = 16;
  NibModel m;
  m.init();
  uint32_t x = ((uint32_t)words[0] << 16) | words[1];
  int pos = 2;
  for (int t = 0; t < n; t++) {
    const int32_t slot = (int32_t)(x & 0xFFFF);
    const int32_t sh8 = slot >> 8;
    int h = 0;
    while (h < NV - 1 && NibModel::eff(m.sh, h + 1) <= sh8) h++;
    const int32_t loh = NibModel::eff(m.sh, h);
    const int32_t fh = NibModel::eff(m.sh, h + 1) - loh;
    const int32_t r = slot - (loh << 8);
    int l = 0;
    while (l < NV - 1 && fh * NibModel::eff(m.sl[h], l + 1) <= r) l++;
    const int32_t lo_s = fh * NibModel::eff(m.sl[h], l);
    const int32_t f12 = fh * (NibModel::eff(m.sl[h], l + 1) - NibModel::eff(m.sl[h], l));
    x = (uint32_t)f12 * (x >> pb) + (uint32_t)(r - lo_s);
    if (x < (1u << 16)) x = (x << 16) | words[pos++];
    const int s = (h << 4) | l;
    out[t] = (uint8_t)s;
    m.update(s, rate, t);
  }
}

void o0n_encode_blocks(const uint8_t* data, const int32_t* offsets,
                       const int32_t* lengths, int nblocks, int cap, int rate,
                       uint16_t* words_out, int32_t* nwords_out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nblocks; i++) {
    nwords_out[i] = o0n_encode_block(data + offsets[i], lengths[i], rate,
                                     words_out + (int64_t)i * cap);
  }
}

void o0n_decode_blocks(const uint16_t* words, const int32_t* lengths,
                       int nblocks, int cap, int rate,
                       const int32_t* out_offsets, uint8_t* out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nblocks; i++) {
    o0n_decode_block(words + (int64_t)i * cap, lengths[i], rate,
                     out + out_offsets[i]);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// order1n: order-1 nibble factorization (spec in models/functional.py
// Order1NibCDF; kernels in ops/pallas_rans.py). The hi nibble is conditioned
// on the PREVIOUS byte's hi nibble, the lo nibble on the current hi nibble;
// both tables adapt on per-context visit counts. Coder layer identical.
// ---------------------------------------------------------------------------

namespace {

struct Nib1Model {
  int32_t sh[NV][NV + 1];
  int32_t sl[NV][NV + 1];
  int32_t cnth[NV];
  int32_t cntl[NV];
  int prev_h;
  void init() {
    for (int c = 0; c < NV; c++)
      for (int k = 0; k <= NV; k++) sh[c][k] = sl[c][k] = k * (NS / NV);
    for (int c = 0; c < NV; c++) cnth[c] = cntl[c] = 0;
    prev_h = 0;
  }
  inline void interval_of(int s, int32_t* lo12, int32_t* f12) const {
    const int h = s >> 4, l = s & 15;
    const int32_t loh = NibModel::eff(sh[prev_h], h);
    const int32_t fh = NibModel::eff(sh[prev_h], h + 1) - loh;
    const int32_t lol = NibModel::eff(sl[h], l);
    const int32_t fl = NibModel::eff(sl[h], l + 1) - lol;
    *lo12 = (loh << 8) + fh * lol;
    *f12 = fh * fl;
  }
  inline void update(int s, int base_rate) {
    const int h = s >> 4, l = s & 15;
    NibModel::shift_update(sh[prev_h], h, rate_at(base_rate, cnth[prev_h]));
    cnth[prev_h]++;
    NibModel::shift_update(sl[h], l, rate_at(base_rate, cntl[h]));
    cntl[h]++;
    prev_h = h;
  }
};

}  // namespace

extern "C" {

int o1n_encode_block(const uint8_t* data, int n, int rate, uint16_t* words) {
  constexpr int pb = 16;
  std::vector<int32_t> lo(n), fr(n);
  Nib1Model m;
  m.init();
  for (int t = 0; t < n; t++) {
    m.interval_of(data[t], &lo[t], &fr[t]);
    m.update(data[t], rate);
  }
  std::vector<uint16_t> emitted;
  emitted.reserve(n / 2 + 4);
  uint32_t x = 1u << 16;
  for (int t = n - 1; t >= 0; t--) {
    uint32_t f = (uint32_t)fr[t];
    uint32_t x_max = f << (32 - pb);
    if (x >= x_max) {
      emitted.push_back((uint16_t)(x & 0xFFFF));
      x >>= 16;
    }
    x = ((x / f) << pb) + (x % f) + (uint32_t)lo[t];
  }
  words[0] = (uint16_t)(x >> 16);
  words[1] = (uint16_t)(x & 0xFFFF);
  int nw = 2;
  for (int i = (int)emitted.size() - 1; i >= 0; i--) words[nw++] = emitted[i];
  return nw;
}

void o1n_decode_block(const uint16_t* words, int n, int rate, uint8_t* out) {
  constexpr int pb = 16;
  Nib1Model m;
  m.init();
  uint32_t x = ((uint32_t)words[0] << 16) | words[1];
  int pos = 2;
  for (int t = 0; t < n; t++) {
    const int32_t slot = (int32_t)(x & 0xFFFF);
    const int32_t sh8 = slot >> 8;
    const int32_t* hs = m.sh[m.prev_h];
    int h = 0;
    while (h < NV - 1 && NibModel::eff(hs, h + 1) <= sh8) h++;
    const int32_t loh = NibModel::eff(hs, h);
    const int32_t fh = NibModel::eff(hs, h + 1) - loh;
    const int32_t r = slot - (loh << 8);
    int l = 0;
    while (l < NV - 1 && fh * NibModel::eff(m.sl[h], l + 1) <= r) l++;
    const int32_t lo_s = fh * NibModel::eff(m.sl[h], l);
    const int32_t f12 =
        fh * (NibModel::eff(m.sl[h], l + 1) - NibModel::eff(m.sl[h], l));
    x = (uint32_t)f12 * (x >> pb) + (uint32_t)(r - lo_s);
    if (x < (1u << 16)) x = (x << 16) | words[pos++];
    const int s = (h << 4) | l;
    out[t] = (uint8_t)s;
    m.update(s, rate);
  }
}

void o1n_encode_blocks(const uint8_t* data, const int32_t* offsets,
                       const int32_t* lengths, int nblocks, int cap, int rate,
                       uint16_t* words_out, int32_t* nwords_out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nblocks; i++) {
    nwords_out[i] = o1n_encode_block(data + offsets[i], lengths[i], rate,
                                     words_out + (int64_t)i * cap);
  }
}

void o1n_decode_blocks(const uint16_t* words, const int32_t* lengths,
                       int nblocks, int cap, int rate,
                       const int32_t* out_offsets, uint8_t* out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nblocks; i++) {
    o1n_decode_block(words + (int64_t)i * cap, lengths[i], rate,
                     out + out_offsets[i]);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// order2n: order-2-lite nibble factorization (spec in models/functional.py
// Order2NibCDF; kernels in ops/pallas_rans.py). Hi nibble conditioned on the
// previous byte's hi nibble (as order1n); LO nibble on
// (current hi, previous hi >> 2) — 64 contexts. Coder layer identical.
// ---------------------------------------------------------------------------

namespace {

struct Nib2Model {
  int32_t sh[NV][NV + 1];
  int32_t sl[4 * NV][NV + 1];
  int32_t cnth[NV];
  int32_t cntl[4 * NV];
  int prev_h;
  void init() {
    for (int c = 0; c < NV; c++)
      for (int k = 0; k <= NV; k++) sh[c][k] = k * (NS / NV);
    for (int c = 0; c < 4 * NV; c++)
      for (int k = 0; k <= NV; k++) sl[c][k] = k * (NS / NV);
    for (int c = 0; c < NV; c++) cnth[c] = 0;
    for (int c = 0; c < 4 * NV; c++) cntl[c] = 0;
    prev_h = 0;
  }
  inline int lctx(int h) const { return h * 4 + (prev_h >> 2); }
  inline void interval_of(int s, int32_t* lo12, int32_t* f12) const {
    const int h = s >> 4, l = s & 15;
    const int32_t loh = NibModel::eff(sh[prev_h], h);
    const int32_t fh = NibModel::eff(sh[prev_h], h + 1) - loh;
    const int32_t* sr = sl[lctx(h)];
    const int32_t lol = NibModel::eff(sr, l);
    const int32_t fl = NibModel::eff(sr, l + 1) - lol;
    *lo12 = (loh << 8) + fh * lol;
    *f12 = fh * fl;
  }
  inline void update(int s, int base_rate) {
    const int h = s >> 4, l = s & 15;
    NibModel::shift_update(sh[prev_h], h, rate_at(base_rate, cnth[prev_h]));
    cnth[prev_h]++;
    const int lc = lctx(h);
    NibModel::shift_update(sl[lc], l, rate_at(base_rate, cntl[lc]));
    cntl[lc]++;
    prev_h = h;
  }
};

}  // namespace

extern "C" {

int o2n_encode_block(const uint8_t* data, int n, int rate, uint16_t* words) {
  constexpr int pb = 16;
  std::vector<int32_t> lo(n), fr(n);
  Nib2Model m;
  m.init();
  for (int t = 0; t < n; t++) {
    m.interval_of(data[t], &lo[t], &fr[t]);
    m.update(data[t], rate);
  }
  std::vector<uint16_t> emitted;
  emitted.reserve(n / 2 + 4);
  uint32_t x = 1u << 16;
  for (int t = n - 1; t >= 0; t--) {
    uint32_t f = (uint32_t)fr[t];
    uint32_t x_max = f << (32 - pb);
    if (x >= x_max) {
      emitted.push_back((uint16_t)(x & 0xFFFF));
      x >>= 16;
    }
    x = ((x / f) << pb) + (x % f) + (uint32_t)lo[t];
  }
  words[0] = (uint16_t)(x >> 16);
  words[1] = (uint16_t)(x & 0xFFFF);
  int nw = 2;
  for (int i = (int)emitted.size() - 1; i >= 0; i--) words[nw++] = emitted[i];
  return nw;
}

void o2n_decode_block(const uint16_t* words, int n, int rate, uint8_t* out) {
  constexpr int pb = 16;
  Nib2Model m;
  m.init();
  uint32_t x = ((uint32_t)words[0] << 16) | words[1];
  int pos = 2;
  for (int t = 0; t < n; t++) {
    const int32_t slot = (int32_t)(x & 0xFFFF);
    const int32_t sh8 = slot >> 8;
    const int32_t* hs = m.sh[m.prev_h];
    int h = 0;
    while (h < NV - 1 && NibModel::eff(hs, h + 1) <= sh8) h++;
    const int32_t loh = NibModel::eff(hs, h);
    const int32_t fh = NibModel::eff(hs, h + 1) - loh;
    const int32_t r = slot - (loh << 8);
    const int32_t* sr = m.sl[m.lctx(h)];
    int l = 0;
    while (l < NV - 1 && fh * NibModel::eff(sr, l + 1) <= r) l++;
    const int32_t lo_s = fh * NibModel::eff(sr, l);
    const int32_t f12 = fh * (NibModel::eff(sr, l + 1) - NibModel::eff(sr, l));
    x = (uint32_t)f12 * (x >> pb) + (uint32_t)(r - lo_s);
    if (x < (1u << 16)) x = (x << 16) | words[pos++];
    const int s = (h << 4) | l;
    out[t] = (uint8_t)s;
    m.update(s, rate);
  }
}

void o2n_encode_blocks(const uint8_t* data, const int32_t* offsets,
                       const int32_t* lengths, int nblocks, int cap, int rate,
                       uint16_t* words_out, int32_t* nwords_out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nblocks; i++) {
    nwords_out[i] = o2n_encode_block(data + offsets[i], lengths[i], rate,
                                     words_out + (int64_t)i * cap);
  }
}

void o2n_decode_blocks(const uint16_t* words, const int32_t* lengths,
                       int nblocks, int cap, int rate,
                       const int32_t* out_offsets, uint8_t* out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nblocks; i++) {
    o2n_decode_block(words + (int64_t)i * cap, lengths[i], rate,
                     out + out_offsets[i]);
  }
}

}  // extern "C"
