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
// R^3 2^GCD_OUTER mod p: the binary GCD of batch_inverse.cu leaves
// x^-1 2^-GCD_OUTER; one Montgomery product by this makes x^-1 R^2, the
// Montgomery form of the inverse of the element x holds
__constant__ uint32_t FP_INV_FIX[12] = {
    0x47dfe23f, 0x5aa83313, 0x472bcebd, 0xa72ed6ed, 0x81c4506a, 0xf1109f20,
    0xd7caf4f3, 0x1b33e91a, 0xd06473ac, 0x10ba6227, 0x42665e8f, 0x02679ad4};
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
__constant__ uint32_t FR_INV_FIX[8] = {
    0xceb832e8, 0x6020db85, 0xe2c245c8, 0x923b6c7f,
    0xc727ed30, 0x4a44517a, 0x53b6a5cd, 0x4ba85e75};

struct Fp {
  static constexpr int N = 12;
  static constexpr uint32_t N0 = 0xfffcfffdu;  // -p^-1 mod 2^32
  // outer iterations of batch_inverse.cu's binary GCD: ceil((2 * 381 - 1) / 31) + 1
  static constexpr int GCD_OUTER = 26;
  __device__ static __forceinline__ uint32_t mod(int i) { return FP_MOD[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return FP_ONE[i]; }
  __device__ static __forceinline__ uint32_t inv_fix(int i) { return FP_INV_FIX[i]; }
};

struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t N0 = 0xffffffffu;  // -r^-1 mod 2^32
  // ceil((2 * 255 - 1) / 31) + 1
  static constexpr int GCD_OUTER = 18;
  __device__ static __forceinline__ uint32_t mod(int i) { return FR_MOD[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return FR_ONE[i]; }
  __device__ static __forceinline__ uint32_t inv_fix(int i) { return FR_INV_FIX[i]; }
};

// --- PTX carry chains ---
// Every multi-word step below is a chain of sm_90 carry instructions
// (add.cc / addc, sub.cc / subc, mad.lo.cc / madc.lo.cc / madc.hi.cc). The
// carry flag is not a C++ value: it passes from one asm statement to the
// next. Each statement is volatile, so the compiler keeps them in program
// order, and nothing between two statements of a chain writes the flag
// (ptxas maps the flag of each chain to its own carry registers and may
// interleave independent chains). A statement without .cc ends a chain;
// where its carry is dropped the bounds below prove it zero.

// acc[j], acc[j + 1] = a[j] * bi (j even): the even-limb products, side by side
template <int N>
__device__ __forceinline__ void mul_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N; j += 2)
    asm volatile("mul.lo.u32 %0, %2, %3;\n\tmul.hi.u32 %1, %2, %3;"
                 : "=r"(acc[j]), "=r"(acc[j + 1])
                 : "r"(a[j]), "r"(bi));
}

// acc += sum over even j of a[j] bi W^j; the carry out is left in the flag
template <int N>
__device__ __forceinline__ void cmad_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(acc[0]), "+r"(acc[1])
               : "r"(a[0]), "r"(bi));
#pragma unroll
  for (int j = 2; j < N; j += 2)
    asm volatile("madc.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.cc.u32 %1, %2, %3, %1;"
                 : "+r"(acc[j]), "+r"(acc[j + 1])
                 : "r"(a[j]), "r"(bi));
}

// acc = (acc >> 64) + sum over even j of a[j] bi W^j + the carry flag
template <int N>
__device__ __forceinline__ void madc_n_rshift(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2)
    asm volatile("madc.lo.cc.u32 %0, %2, %3, %4;\n\tmadc.hi.cc.u32 %1, %2, %3, %5;"
                 : "=r"(acc[j]), "=r"(acc[j + 1])
                 : "r"(a[j]), "r"(bi), "r"(acc[j + 2]), "r"(acc[j + 3]));
  asm volatile("madc.lo.cc.u32 %0, %2, %3, 0;\n\tmadc.hi.u32 %1, %2, %3, 0;"
               : "=r"(acc[N - 2]), "=r"(acc[N - 1])
               : "r"(a[N - 2]), "r"(bi));
}

// One CIOS step on the split accumulator T = even + W odd (even[j] at
// weight W^j, odd[j] at W^(j + 1)): T = T / W + ai b, then T += mi p with
// mi = T[0] (-p^-1) mod W, so that even[0] becomes 0. Dividing by W is a
// change of roles: the caller swaps even and odd between steps, and the old
// even array, shifted two words, becomes the new odd one (madc_n_rshift).
// The even-limb and odd-limb products of a row are two carry chains with no
// data between them, so neither waits on the other's carries.
template <class F>
__device__ __forceinline__ void mad_n_redc(uint32_t* even, uint32_t* odd, const uint32_t* b,
                                           const uint32_t* m, uint32_t ai, bool first) {
  constexpr int N = F::N;
  if (first) {
    mul_n<N>(odd, b + 1, ai);
    mul_n<N>(even, b, ai);
  } else {
    asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(even[0]) : "r"(odd[1]));
    madc_n_rshift<N>(odd, b + 1, ai);
    cmad_n<N>(even, b, ai);
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(odd[N - 1]));
  }
  const uint32_t mi = even[0] * F::N0;
  cmad_n<N>(odd, m + 1, mi);
  cmad_n<N>(even, m, mi);
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(odd[N - 1]));
}

// out = (hi:t) - p if that is >= 0, else t. The value (hi:t) must be < 2p.
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t* out, const uint32_t* t, uint32_t hi) {
  constexpr int N = F::N;
  uint32_t d[N], sign;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d[0]) : "r"(t[0]), "r"(F::mod(0)));
#pragma unroll
  for (int j = 1; j < N; ++j)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d[j]) : "r"(t[j]), "r"(F::mod(j)));
  asm volatile("subc.u32 %0, %1, 0;" : "=r"(sign) : "r"(hi));  // all ones iff (hi:t) < p
  const bool keep = sign == 0xffffffffu;
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = keep ? t[j] : d[j];
}

// Montgomery product out = a b R^-1 mod p, a < 2p, b < p, out < p: CIOS in
// PTX carry chains over an even/odd split accumulator (the layout of
// Supranational's sppark, ff/mont_t.cuh). Each step multiplies the row b by
// one word of a. Bounds: after step i the state is t_i < b + p <= 2p, and
// the step's sum before the division by W is W t_i < W 2p <= W^(N + 1) for
// Fp (R > 4p) and for Fr (R > 2r) alike, so the N-word odd row never
// carries out and no spare word is needed; a (the word operand) may be
// anything below 2p. The result (a b + M p) / R < 2p (a b / R < 2p^2 / R < p)
// takes one subtraction. out may alias a or b: it is written only at the end.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t x[N], y[N], m[N], even[N], odd[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = a[j];
    y[j] = b[j];
    m[j] = F::mod(j);
  }
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mad_n_redc<F>(even, odd, y, m, x[i], i == 0);
    mad_n_redc<F>(odd, even, y, m, x[i + 1], false);
  }
  // t = T / W = even + (odd >> 32); odd[0] is 0 after the last step
  asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(even[0]) : "r"(odd[1]));
#pragma unroll
  for (int j = 1; j < N - 1; ++j)
    asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(even[j]) : "r"(odd[j + 1]));
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(even[N - 1]));
  reduce_once<F>(out, even, 0);
}

// out = a + b mod p (a, b < p)
template <class F>
__device__ __forceinline__ void add(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t s[N], hi;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(s[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int j = 1; j < N; ++j)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(s[j]) : "r"(a[j]), "r"(b[j]));
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(hi));
  reduce_once<F>(out, s, hi);
}

// out = a - b mod p (a, b < p)
template <class F>
__device__ __forceinline__ void sub(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t d[N], mask;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int j = 1; j < N; ++j)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d[j]) : "r"(a[j]), "r"(b[j]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(mask));  // all ones on underflow: add p back
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(out[0]) : "r"(d[0]), "r"(F::mod(0) & mask));
#pragma unroll
  for (int j = 1; j < N - 1; ++j)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(out[j]) : "r"(d[j]), "r"(F::mod(j) & mask));
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(out[N - 1]) : "r"(d[N - 1]), "r"(F::mod(N - 1) & mask));
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
