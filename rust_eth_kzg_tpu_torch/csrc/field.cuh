// Montgomery arithmetic over the BLS12-381 base field Fp and scalar field Fr,
// shared by every kernel of the port (one __device__ core, many entry points).
//
// Representation: a field element is N little-endian 32-bit limbs (Fp: 12,
// Fr: 8) in Montgomery form with R = 2^(32 N). Arrays are limb-major
// [N, lanes]: lane i keeps limb j at j * lanes + i, so a warp's 32 threads
// read 128 consecutive bytes per limb.
//
// Bounds: every value is kept fully reduced (< modulus). R = 2^384 leaves
// only 3 spare bits over p and R = 2^256 one over r, so the lazily reduced
// multiples of p that 15-bit limbs allow do not fit here. mont_mul takes
// a < 2p and b < p, computes the CIOS sum t < 2p and subtracts p once.
//
// The constants below are checked against constants.py by the CPU tests.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kzg {

__constant__ uint32_t FP_MOD[12] = {
    0xffffaaab, 0xb9feffff, 0xb153ffff, 0x1eabfffe, 0xf6b0f624, 0x6730d2a0,
    0xf38512bf, 0x64774b84, 0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
// R mod p (Montgomery one)
__constant__ uint32_t FP_ONE[12] = {
    0x0002fffd, 0x76090000, 0xc40c0002, 0xebf4000b, 0x53c758ba, 0x5f489857,
    0x70525745, 0x77ce5853, 0xa256ec6d, 0x5c071a97, 0xfa80e493, 0x15f65ec3};
// p - 2, the Fermat inversion exponent
__constant__ uint32_t FP_EXP[12] = {
    0xffffaaa9, 0xb9feffff, 0xb153ffff, 0x1eabfffe, 0xf6b0f624, 0x6730d2a0,
    0xf38512bf, 0x64774b84, 0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
// 3 b = 12 in Montgomery form (12 R mod p), the curve constant of the RCB formulas
__constant__ uint32_t FP_B3[12] = {
    0x0027552e, 0x44760000, 0x43480020, 0xdcb8009a, 0x4a6e8b59, 0x6f7ee9ce,
    0xc0a95bc6, 0xb10330b7, 0xfb1e54b7, 0x6140b1fc, 0x7f0bb4e1, 0x0381be09};
// beta R mod p: the GLV endomorphism phi(x, y) = (beta x, y) in Montgomery form
__constant__ uint32_t FP_BETA[12] = {
    0x8671f071, 0xcd03c9e4, 0x1fcda5d2, 0x5dab2246, 0xd3851b95, 0x587042af,
    0x01bacb9e, 0x8eb60ebe, 0x83d050d2, 0x03f97d6e, 0x54638741, 0x18f02065};

__constant__ uint32_t FR_MOD[8] = {
    0x00000001, 0xffffffff, 0xfffe5bfe, 0x53bda402,
    0x09a1d805, 0x3339d808, 0x299d7d48, 0x73eda753};
__constant__ uint32_t FR_ONE[8] = {
    0xfffffffe, 0x00000001, 0x00034802, 0x5884b7fa,
    0xecbc4ff5, 0x998c4fef, 0xacc5056f, 0x1824b159};
__constant__ uint32_t FR_EXP[8] = {
    0xffffffff, 0xfffffffe, 0xfffe5bfe, 0x53bda402,
    0x09a1d805, 0x3339d808, 0x299d7d48, 0x73eda753};

struct Fp {
  static constexpr int N = 12;
  static constexpr uint32_t N0 = 0xfffcfffdu;  // -p^-1 mod 2^32
  __device__ static __forceinline__ uint32_t mod(int i) { return FP_MOD[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return FP_ONE[i]; }
  __device__ static __forceinline__ uint32_t exp(int i) { return FP_EXP[i]; }
};

struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t N0 = 0xffffffffu;  // -r^-1 mod 2^32
  __device__ static __forceinline__ uint32_t mod(int i) { return FR_MOD[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return FR_ONE[i]; }
  __device__ static __forceinline__ uint32_t exp(int i) { return FR_EXP[i]; }
};

// out = (hi:t) - p if that is >= 0, else t. The value (hi:t) must be < 2p.
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t* out, const uint32_t* t, uint32_t hi) {
  constexpr int N = F::N;
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)t[j] - F::mod(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = s >> 63;
  }
  const bool use_d = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = use_d ? d[j] : t[j];
}

// CIOS Montgomery product: out = a b R^-1 mod p, a < 2p, b < p, out < p.
// out may alias a or b: it is written only after the last read.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[i] * b[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::N0;
    s = (uint64_t)m * F::mod(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * F::mod(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  reduce_once<F>(out, t, t[N]);
}

// out = a + b mod p (a, b < p)
template <class F>
__device__ __forceinline__ void add(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)v;
    c = v >> 32;
  }
  reduce_once<F>(out, s, (uint32_t)c);
}

// out = a - b mod p (a, b < p)
template <class F>
__device__ __forceinline__ void sub(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = v >> 63;
  }
  const uint32_t mask = 0u - (uint32_t)borrow;  // add p back on underflow
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t v = (uint64_t)d[j] + (F::mod(j) & mask) + c;
    out[j] = (uint32_t)v;
    c = v >> 32;
  }
}

template <class F>
__device__ __forceinline__ void set_one(uint32_t* out) {
#pragma unroll
  for (int j = 0; j < F::N; ++j) out[j] = F::one(j);
}

template <int N>
__device__ __forceinline__ void copy(uint32_t* out, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = a[j];
}

template <int N>
__device__ __forceinline__ void set_zero(uint32_t* out) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = 0;
}

// limb-major global memory: limb j of lane i at src[j * lanes + i]
template <int N>
__device__ __forceinline__ void load(uint32_t* x, const uint32_t* __restrict__ src,
                                     int64_t i, int64_t lanes) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = src[j * lanes + i];
}

template <int N>
__device__ __forceinline__ void store(uint32_t* __restrict__ dst, const uint32_t* x,
                                      int64_t i, int64_t lanes) {
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j * lanes + i] = x[j];
}

inline unsigned int grid_for(int64_t work, int threads) {
  return (unsigned int)((work + threads - 1) / threads);
}

}  // namespace kzg
