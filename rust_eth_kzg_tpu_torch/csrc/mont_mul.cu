// Standalone Montgomery multiply, one lane per thread.
//
// Replaces rust_eth_kzg_tpu/ops/pallas_kernels.py::mont_mul (whose body,
// field.mont_mul_values, is inlined in every other TPU kernel). In the port it
// serves every field product outside a fused kernel: to/from Montgomery form,
// the 1/(2k) and 1/n scales, x z^-1 in batch normalization and the GLV
// endomorphism.
//
// Bound on this card: bytes. Fp reads 2 x 48 B and writes 48 B per lane for
// 300 32x32-bit products (2 N^2 + N); at 3.35 TB/s the bytes take longer than
// the products at the card's IMAD rate. One thread per lane with limb-major
// (coalesced) loads and stores is the whole design; the product itself is
// field.cuh's, PTX carry chains over an even/odd accumulator.
//
// A second entry point, the chain probe (kzg_mont_mul_chain), squares each
// lane k times in a row: x = x x, k dependent products. On one lane, the
// difference between k = 4096 and k = 1 over 4095 is the latency of one
// dependent product, the step that bounds every kernel built on a chain of
// products (g1_fft, batch_inverse, g1_decompress); on many lanes it gives the
// products per second. chip_smoke.py runs it; no path of the port does.
#include "field.cuh"

using namespace kzg;

template <class F>
__global__ void __launch_bounds__(256) mont_mul_kernel(const uint32_t* __restrict__ a,
                                                       const uint32_t* __restrict__ b,
                                                       uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::N], y[F::N];
  load<F::N>(x, a, i, n);
  load<F::N>(y, b, i, n);
  mont_mul<F>(x, x, y);
  store<F::N>(out, x, i, n);
}

// field: 0 = Fr, 1 = Fp. a, b, out: [N, n] limb-major. Returns cudaGetLastError().
extern "C" int kzg_mont_mul(int field, const void* a, const void* b, void* out, long long n,
                            void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 1)
    mont_mul_kernel<Fp><<<grid_for(n, threads), threads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  else
    mont_mul_kernel<Fr><<<grid_for(n, threads), threads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

template <class F>
__global__ void __launch_bounds__(256) mont_mul_chain_kernel(const uint32_t* __restrict__ a,
                                                             uint32_t* __restrict__ out,
                                                             int64_t n, int k) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::N];
  load<F::N>(x, a, i, n);
#pragma unroll 1
  for (int s = 0; s < k; ++s) mont_mul<F>(x, x, x);
  store<F::N>(out, x, i, n);
}

// field: 0 = Fr, 1 = Fp. a, out: [N, n] limb-major; out = a^(2^k) in Montgomery form.
extern "C" int kzg_mont_mul_chain(int field, const void* a, void* out, long long n, int k,
                                  void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 1)
    mont_mul_chain_kernel<Fp><<<grid_for(n, threads), threads, 0, s>>>(
        (const uint32_t*)a, (uint32_t*)out, n, k);
  else
    mont_mul_chain_kernel<Fr><<<grid_for(n, threads), threads, 0, s>>>(
        (const uint32_t*)a, (uint32_t*)out, n, k);
  return (int)cudaGetLastError();
}
