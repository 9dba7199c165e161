// Elementwise Montgomery inverse over Fp or Fr, by a binary extended GCD
// (no Fermat exponentiation): one GCD a lane for small batches, one a block
// of 32 lanes behind Montgomery's trick for large ones.
//
// Replaces rust_eth_kzg_tpu/ops/pallas_kernels.py::batch_inverse_flat. The
// contract is the TPU kernel's: lane i of n belongs to block i mod C
// (C = ceil(n / 32)) at position i / C, and a zero lane makes its whole
// block zero (callers mask zero lanes first). On nonzero lanes the inverse
// is unique, so the output equals the plain version (Montgomery's trick
// and a Fermat power, ops/field.py::batch_inverse_plain) limb for limb.
//
// Bound on this card: the dependent chain. The Fermat power a^(p - 2) was
// ~570 dependent products (0.52 ms for Fp at 0.915 us a product) and the
// proofs of a blob are 128 lanes, so 4 threads did all the work.
//
// The GCD (T. Pornin, "Optimized Binary GCD for Modular Inversion", 2020,
// Algorithm 2, with k = 32): a = x, b = p, u = 1, v = 0, keeping
// a = u x 2^c and b = v x 2^c (mod p). Each of GCD_OUTER outer iterations
// - builds 64-bit approximations of a and b (their low 31 bits and the 33
//   bits below the top of max(a, b)), exact once both fit 64 bits;
// - runs 31 binary-GCD steps on them (a odd: swap if a < b, a = (a - b) / 2;
//   a even: a = a / 2), collecting the steps as a matrix [f0 g0; f1 g1]
//   with |f| + |g| <= 2^31;
// - applies it to the full values: a = |f0 a + g0 b| / 2^31, b = |f1 a +
//   g1 b| / 2^31 (exact), and u, v the same way mod p with one 32-bit
//   Montgomery step in place of the division (so c grows by 1).
// Every step brings len(a) + len(b) down by one, so after
// ceil((2 len(p) - 1) / 31) iterations a = 0 and b = gcd = 1 (GCD_OUTER has
// one more: an iteration at a = 0 keeps the invariant). Then x^-1 =
// v 2^GCD_OUTER, and the GCD runs on the stored value x = a R itself: the
// Montgomery form of a^-1 is R^2 x^-1 = mont_mul(v, R^3 2^GCD_OUTER). The
// steps depend on the value, so the time does too: every input here
// (commitments, proofs, the erasure denominators) is public.
// tests/test_torch_field.py holds a Python model of this exact algorithm
// (the same word sizes and step batching) against pow(x, -1, p).
//
// Two modes, chosen by the wrapper from n:
// - per lane: thread i inverts lane i by its own GCD, after checking the 32
//   lanes of its block for a zero (the contract's poisoning);
// - per block: thread c takes block c's prefix products (a scratch array
//   the wrapper allocates), one GCD of the total and a backward pass.
#include "field.cuh"

using namespace kzg;

namespace {

constexpr int STEPS = 31;  // binary-GCD steps an outer iteration (k - 1)

// 64-bit approximation of a: its low 31 bits and the 33 bits from bit
// n - 33 up, n = max(len(a), len(b), 64)
template <int N>
__device__ __forceinline__ uint64_t approx(const uint32_t* a, int n) {
  const int s = n - 33;
  const int limb = s >> 5, r = s & 31;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j == limb) lo = a[j];
    if (j == limb + 1) hi = a[j];
  }
  const uint64_t top = ((((uint64_t)hi << 32) | lo) >> r) & ((1ull << 33) - 1);
  return (a[0] & 0x7fffffffu) | (top << 31);
}

// out = |f a + g b| / 2^31 (exact); returns true where f a + g b < 0.
// |f| + |g| <= 2^31 and a, b < 2^(32 N): every partial sum fits an int64.
template <int N>
__device__ __forceinline__ bool lin_shift(uint32_t* out, const uint32_t* a, const uint32_t* b, int64_t f,
                                          int64_t g) {
  uint32_t t[N];
  int64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int64_t s = f * (int64_t)a[j] + g * (int64_t)b[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
#pragma unroll
  for (int j = 0; j < N - 1; ++j) out[j] = (t[j] >> 31) | (t[j + 1] << 1);
  out[N - 1] = (t[N - 1] >> 31) | (uint32_t)((uint64_t)c << 1);
  if (c >= 0) return false;
  // the value is out - 2^(32 N): negate over N words
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t d = 0ull - out[j] - borrow;
    out[j] = (uint32_t)d;
    borrow = (d >> 32) & 1;
  }
  return true;
}

// out = (f u + g v) 2^-32 mod p, in [0, p), for u, v < p: one Montgomery
// step by a word, then at most two additions of p and one subtraction
// (|f u + g v| < 2^31 p, so the step's result lies in (-1.5 p, 1.5 p)).
template <class F>
__device__ __forceinline__ void lin_mont(uint32_t* out, const uint32_t* u, const uint32_t* v, int64_t f,
                                         int64_t g) {
  constexpr int N = F::N;
  uint32_t t[N];
  int64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int64_t s = f * (int64_t)u[j] + g * (int64_t)v[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  // t + c 2^(32 N) + q p, with q zeroing the low word, over 2^32
  const uint32_t q = t[0] * F::N0;
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t s = (uint64_t)t[j] + (uint64_t)q * F::mod(j) + carry;
    if (j > 0) out[j - 1] = (uint32_t)s;
    carry = s >> 32;
  }
  int64_t top = (int64_t)carry + c;  // out[N - 1] and the sign above it
  out[N - 1] = (uint32_t)top;
  int64_t hi = top >> 32;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (hi < 0) {
      uint64_t cy = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint64_t s = (uint64_t)out[j] + F::mod(j) + cy;
        out[j] = (uint32_t)s;
        cy = s >> 32;
      }
      hi += (int64_t)cy;
    }
  }
  reduce_once<F>(out, out, 0);
}

// out = the Montgomery inverse of the element x holds (x^-1 R^2 mod p), or 0
// for x = 0 (then b ends at p, not 1).
template <class F>
__device__ __forceinline__ void gcd_inverse(uint32_t* out, const uint32_t* x) {
  constexpr int N = F::N;
  uint32_t a[N], b[N], u[N], v[N], na[N], nb[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = x[j];
    b[j] = F::mod(j);
    u[j] = j == 0;
    v[j] = 0;
  }
#pragma unroll 1
  for (int it = 0; it < F::GCD_OUTER; ++it) {
    int top = 1;
    uint32_t word = a[1] | b[1];
#pragma unroll
    for (int j = 2; j < N; ++j) {
      const uint32_t w = a[j] | b[j];
      if (w) {
        top = j;
        word = w;
      }
    }
    const int len = 32 * top + (word ? 32 - __clz(word) : 0);
    const int n = len > 64 ? len : 64;
    uint64_t xa = approx<N>(a, n), xb = approx<N>(b, n);
    int64_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll 1
    for (int s = 0; s < STEPS; ++s) {
      if (xa & 1) {
        if (xa < xb) {
          const uint64_t tx = xa;
          xa = xb;
          xb = tx;
          int64_t tf = f0;
          f0 = f1;
          f1 = tf;
          tf = g0;
          g0 = g1;
          g1 = tf;
        }
        xa = (xa - xb) >> 1;
        f0 -= f1;
        g0 -= g1;
      } else {
        xa >>= 1;
      }
      f1 += f1;
      g1 += g1;
    }
    if (lin_shift<N>(na, a, b, f0, g0)) {
      f0 = -f0;
      g0 = -g0;
    }
    if (lin_shift<N>(nb, a, b, f1, g1)) {
      f1 = -f1;
      g1 = -g1;
    }
    lin_mont<F>(a, u, v, f0, g0);  // a, b are free: they hold the new u, v
    lin_mont<F>(b, u, v, f1, g1);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      u[j] = a[j];
      v[j] = b[j];
      a[j] = na[j];
      b[j] = nb[j];
    }
  }
  bool one = b[0] == 1;
#pragma unroll
  for (int j = 1; j < N; ++j) one = one && b[j] == 0;
  if (!one) {
    set_zero<N>(out);
    return;
  }
  uint32_t fix[N];
#pragma unroll
  for (int j = 0; j < N; ++j) fix[j] = F::inv_fix(j);
  mont_mul<F>(out, v, fix);
}

template <class F>
__global__ void __launch_bounds__(128) batch_inverse_lanes_kernel(const uint32_t* __restrict__ a,
                                                                  uint32_t* __restrict__ out, int64_t n,
                                                                  int64_t c) {
  constexpr int N = F::N;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool poisoned = false;
#pragma unroll 1
  for (int k = 0; k < 32; ++k) {
    const int64_t idx = k * c + i % c;
    if (idx >= n) break;
    bool zero = true;
#pragma unroll
    for (int j = 0; j < N; ++j) zero = zero && a[j * n + idx] == 0;
    poisoned = poisoned || zero;
  }
  uint32_t x[N];
  if (poisoned) {
    set_zero<N>(x);
  } else {
    load<N>(x, a, i, n);
    gcd_inverse<F>(x, x);
  }
  store<N>(out, x, i, n);
}

template <class F>
__global__ void __launch_bounds__(128) batch_inverse_blocks_kernel(const uint32_t* __restrict__ a,
                                                                   uint32_t* __restrict__ out,
                                                                   uint32_t* __restrict__ scratch,
                                                                   int64_t n, int64_t c) {
  constexpr int N = F::N;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  const int64_t slots = 32 * c;
  uint32_t acc[N], x[N];
  set_one<F>(acc);
#pragma unroll 1
  for (int k = 0; k < 32; ++k) {
    const int64_t idx = k * c + col;
    store<N>(scratch, acc, idx, slots);
    if (idx < n) {
      load<N>(x, a, idx, n);
      mont_mul<F>(acc, acc, x);
    }
  }
  uint32_t inv[N];
  gcd_inverse<F>(inv, acc);
#pragma unroll 1
  for (int k = 31; k >= 0; --k) {
    const int64_t idx = k * c + col;
    if (idx < n) {
      load<N>(x, scratch, idx, slots);
      mont_mul<F>(x, inv, x);
      store<N>(out, x, idx, n);
      load<N>(x, a, idx, n);
      mont_mul<F>(inv, inv, x);
    }
  }
}

template <class F>
int launch(const void* a, void* out, void* scratch, long long n, int per_lane, cudaStream_t s) {
  const int threads = 128;
  const long long c = (n + 31) / 32;
  if (per_lane)
    batch_inverse_lanes_kernel<F><<<grid_for(n, threads), threads, 0, s>>>((const uint32_t*)a, (uint32_t*)out,
                                                                           n, c);
  else
    batch_inverse_blocks_kernel<F><<<grid_for(c, threads), threads, 0, s>>>(
        (const uint32_t*)a, (uint32_t*)out, (uint32_t*)scratch, n, c);
  return (int)cudaGetLastError();
}

}  // namespace

// field: 0 = Fr, 1 = Fp. a, out: [N, n]; scratch: [N, 32 * ceil(n / 32)]
// (read only per block). per_lane: 1 for a GCD a lane, 0 for one a block.
extern "C" int kzg_batch_inverse(int field, const void* a, void* out, void* scratch, long long n,
                                 int per_lane, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!per_lane && scratch == nullptr) return (int)cudaErrorInvalidValue;
  return field == 1 ? launch<Fp>(a, out, scratch, n, per_lane, s) : launch<Fr>(a, out, scratch, n, per_lane, s);
}
