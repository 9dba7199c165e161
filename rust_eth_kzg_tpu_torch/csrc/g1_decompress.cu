// The device half of the verifier's G1 decompression, fused: one launch, one
// lane per thread, for ops/decompress.py::decompress_g1.
//
// Replaces, as the JAX package's rust_eth_kzg_tpu/ops/decompress.py::
// decompress_g1 composes them, the Pallas kernels mont_mul (field.pow_fixed:
// the square root, 608 dependent launches a verify on the port's plain
// route), g1_double and g1_add_mixed (curve.scalar_mul_static: the subgroup
// ladder, 128 doublings and 48 mixed additions). Per lane:
//   1. x to Montgomery form, rhs = x^3 + 4;
//   2. y = rhs^((p+1)/4) (p = 3 mod 4) by a 5-bit sliding window: 16 odd
//      powers in a per-thread table (local memory), then 375 squarings and
//      66 products along SQRT_STEPS, 458 products where square-and-multiply
//      takes 608;
//   3. on_curve = (y^2 == rhs);
//   4. the sign: y is the larger root iff its standard form is >=
//      (p - 1)/2 + 1; negate where that differs from the sort bit;
//   5. identity lanes: the point (0 : 1 : 0), both flags set;
//   6. in_subgroup: phi(P) == [z^2 - 1] P, phi(x, y) = (beta x, y): an
//      MSB-first double-and-add over the 128 bits of z^2 - 1 with curve.cuh's
//      g1_double and g1_add_mixed (the affine P added at the 48 set bits),
//      then the projective comparison of curve.equal.
// The formulas and their order are those of the plain route
// (decompress_g1_plain), so the point and both flags equal it on every
// lane, off-curve and non-subgroup lanes included.
//
// Bound on this card: the dependent chain. A verify decompresses 2 x padded
// lanes (256 for 128 cells, 2,048 for 1,024), a few warps, so the card is
// nearly idle and the time is one lane's chain: about 2,240 Montgomery
// products (458 for the root, 1,152 for the doublings, 624 for the
// additions, 4 to compare), each at the latency of field.cuh's product.
#include "curve.cuh"

using namespace kzg;

// R^2 mod p: mont_mul(x, R^2) = x R
__constant__ uint32_t FP_R2[12] = {
    0x1c341746, 0xf4df1f34, 0x09d104f1, 0x0a76e6a6, 0x4c95b6d5, 0x8de5476c,
    0x939d83c0, 0x67eb88a9, 0xb519952d, 0x9a793e85, 0x92cae3aa, 0x11988fe5};
// b = 4 in Montgomery form (4 R mod p)
__constant__ uint32_t FP_B[12] = {
    0x000cfff3, 0xaa270000, 0xfc34000a, 0x53cc0032, 0x6b0a807f, 0x478fe97a,
    0xe6ba24d7, 0xb1d37ebe, 0xbf78ab2f, 0x8ec9733b, 0x3d83de7e, 0x09d64551};
// (p - 1) / 2 + 1 in standard form: the least "larger" root
__constant__ uint32_t FP_HALF_PLUS_1[12] = {
    0xffffd556, 0xdcff7fff, 0x58a9ffff, 0x0f55ffff, 0x7b587b12, 0xb3986950,
    0x79c2895f, 0xb23ba5c2, 0x21a5d66b, 0x258dd3db, 0x1cbff34d, 0x0d0088f5};
// (p + 1) / 4 as a sliding 5-bit window, MSB first: (squarings, odd digit or
// 0) pairs; the first pair starts the accumulator at rhs^digit.
constexpr int SQRT_NSTEPS = 67;
__constant__ uint8_t SQRT_STEPS[2 * SQRT_NSTEPS] = {
    0, 13, 13, 17, 7, 15, 4, 5, 6, 7, 7, 23, 5, 31, 5, 25, 3, 5, 6, 13, 6, 9, 3, 3, 8, 27,
    3, 5, 6, 15, 6, 27, 3, 1, 8, 13, 7, 23, 5, 11, 6, 13, 6, 29, 4, 9, 8, 29, 4, 13, 7, 23,
    9, 19, 5, 25, 2, 3, 7, 5, 7, 9, 6, 23, 5, 29, 5, 19, 5, 19, 8, 13, 7, 21, 9, 15, 5, 13,
    3, 3, 8, 15, 3, 3, 7, 9, 9, 15, 6, 21, 6, 31, 5, 31, 5, 31, 4, 13, 3, 3, 8, 21, 7, 31,
    5, 31, 5, 31, 4, 15, 4, 7, 7, 31, 5, 29, 5, 31, 5, 31, 5, 31, 5, 31, 5, 31, 5, 31, 4, 13,
    6, 21, 5, 11};
// z^2 - 1 (z the BLS parameter), 128 bits, as two 64-bit words
constexpr uint64_t SUBGROUP_HI = 0xac45a4010001a402ull;
constexpr uint64_t SUBGROUP_LO = 0x00000000ffffffffull;

__device__ __forceinline__ void fp_const(uint32_t* o, const uint32_t* c) {
#pragma unroll
  for (int j = 0; j < L; ++j) o[j] = c[j];
}

__device__ __forceinline__ bool fp_eq(const uint32_t* a, const uint32_t* b) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) d |= a[j] ^ b[j];
  return d == 0;
}

__device__ __forceinline__ bool fp_is_zero(const uint32_t* a) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) d |= a[j];
  return d == 0;
}

// standard-form a >= FP_HALF_PLUS_1: no borrow out of a - c
__device__ __forceinline__ bool ge_half_plus_1(const uint32_t* a) {
  uint32_t d, borrow;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a[0]), "r"(FP_HALF_PLUS_1[0]));
#pragma unroll
  for (int j = 1; j < L; ++j)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a[j]), "r"(FP_HALF_PLUS_1[j]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(borrow));
  return borrow == 0;
}

// y = rhs^((p + 1) / 4)
__device__ __forceinline__ void fp_sqrt_candidate(uint32_t* y, const uint32_t* rhs) {
  uint32_t tab[16][L];  // rhs^(2k + 1)
  uint32_t sq[L];
  fp_mul(sq, rhs, rhs);
  copy<L>(tab[0], rhs);
#pragma unroll 1
  for (int k = 1; k < 16; ++k) fp_mul(tab[k], tab[k - 1], sq);
  copy<L>(y, tab[SQRT_STEPS[1] >> 1]);
#pragma unroll 1
  for (int s = 1; s < SQRT_NSTEPS; ++s) {
#pragma unroll 1
    for (int k = 0; k < SQRT_STEPS[2 * s]; ++k) fp_mul(y, y, y);
    const int d = SQRT_STEPS[2 * s + 1];
    if (d) fp_mul(y, y, tab[d >> 1]);
  }
}

__global__ void __launch_bounds__(64) g1_decompress_kernel(
    const uint32_t* __restrict__ x_std, const uint8_t* __restrict__ sort_bits,
    const uint8_t* __restrict__ inf, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, uint8_t* __restrict__ on_curve,
    uint8_t* __restrict__ in_subgroup, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool ident = inf[i] != 0;
  uint32_t x[L], y[L], t[L], rhs[L];
  load<L>(t, x_std, i, n);
  fp_const(y, FP_R2);
  fp_mul(x, t, y);  // x R
  fp_mul(t, x, x);
  fp_mul(rhs, x, t);
  fp_const(t, FP_B);
  fp_add(rhs, rhs, t);  // x^3 + 4
  fp_sqrt_candidate(y, rhs);
  fp_mul(t, y, y);
  const bool on = fp_eq(t, rhs);
  set_zero<L>(t);
  t[0] = 1;
  fp_mul(t, y, t);  // standard form of y
  const bool largest = ge_half_plus_1(t);
  if (largest != (sort_bits[i] != 0)) {
    set_zero<L>(t);
    fp_sub(y, t, y);
  }
  if (ident) {
    set_zero<L>(t);
    store<L>(ox, t, i, n);
    store<L>(oz, t, i, n);
    set_one<Fp>(t);
    store<L>(oy, t, i, n);
    on_curve[i] = 1;
    in_subgroup[i] = 1;
    return;
  }
  store<L>(ox, x, i, n);
  store<L>(oy, y, i, n);
  set_one<Fp>(t);
  store<L>(oz, t, i, n);
  on_curve[i] = on;

  // [z^2 - 1] P, MSB first from the identity, as curve.scalar_mul_static
  G1 acc;
  set_zero<L>(acc.x);
  set_one<Fp>(acc.y);
  set_zero<L>(acc.z);
#pragma unroll 1
  for (int bit = 127; bit >= 0; --bit) {
    g1_double(acc, acc);
    const uint64_t word = bit >= 64 ? SUBGROUP_HI : SUBGROUP_LO;
    if ((word >> (bit & 63)) & 1) g1_add_mixed(acc, acc, x, y);
  }
  // phi(P) = (beta x : y : 1) against acc, projectively: curve.equal
  uint32_t u[L], v[L];
  fp_const(t, FP_BETA);
  fp_mul(t, x, t);         // beta x
  fp_mul(u, t, acc.z);     // phi.x acc.z
  bool eq = fp_eq(u, acc.x);  // acc.x phi.z = acc.x
  fp_mul(v, y, acc.z);
  eq = eq && fp_eq(v, acc.y);
  const bool iq = fp_is_zero(acc.z);
  in_subgroup[i] = !iq && eq;
}

// x_std: [12, n] standard-form limbs (x < p); sort_bits, inf: [n] bytes.
// Out: x, y, z [12, n] Montgomery Fp; on_curve, in_subgroup [n] bytes.
extern "C" int kzg_g1_decompress(const void* x_std, const void* sort_bits, const void* inf,
                                 void* ox, void* oy, void* oz, void* on_curve,
                                 void* in_subgroup, long long n, void* stream) {
  const int threads = 64;
  g1_decompress_kernel<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x_std, (const uint8_t*)sort_bits, (const uint8_t*)inf, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)on_curve, (uint8_t*)in_subgroup, n);
  return (int)cudaGetLastError();
}
