// The nibble models' per-state arithmetic, used by the order0n kernels
// (o0n_rans32.cu); order0c's (o0c_rans32.cu) take rate_at.
// The spec is lac_tpu_torch/models/functional.py.

#pragma once

namespace lac_nib {

constexpr int kNV = 16;                // nibble alphabet
constexpr int kNSB = 15;               // internal state bits
constexpr int kNS = 1 << kNSB;         // state total
constexpr int kNM = 256 - kNV;         // 240: 8-bit coding domain less the +k guard

// adaptive_rate: the base rate, slowed as the step or visit count grows
__device__ __forceinline__ int rate_at(int base, int t) {
  return base + (t >= 16) + (t >= 32) + (t >= 64) + (t >= 128);
}

// 15-bit state -> 8-bit coding boundary of nibble k
__device__ __forceinline__ int eff(int s, int k) { return ((s * kNM) >> kNSB) + k; }

// shift toward the one-hot CDF of nibble `nib` (k <= nib toward 0, else toward 2^15)
__device__ __forceinline__ int nib_update(int s, int k, int nib, int r) {
  return k <= nib ? s - (s >> r) : s + ((kNS - s) >> r);
}

}  // namespace lac_nib
