// Complete mixed G1 addition, projective p + affine q, one lane per thread.
//
// Replaces rust_eth_kzg_tpu/ops/pallas_kernels.py::g1_add_mixed (the body
// curve.add_mixed_values). Caller: the subgroup check of the verifier's
// point decompression, phi(P) == [z^2 - 1] P, whose ladder adds the affine
// decompressed point at every set bit of z^2 - 1 (2 x padded lanes a verify).
// The TPU kernel carries q's identity mask as limb rows; here it is one byte
// a lane, as in g1_add_affine.cu, and such a lane copies p through.
//
// Bound on this card: operations (13 Fp products against 5 x 48 B + 1 B in
// and 3 x 48 B out a lane). p may be the identity and may equal q: the
// formula is complete for affine q.
#include "curve.cuh"

using namespace kzg;

__global__ void __launch_bounds__(128) g1_add_mixed_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
    const uint32_t* __restrict__ qy, const uint8_t* __restrict__ qinf, uint32_t* __restrict__ rx,
    uint32_t* __restrict__ ry, uint32_t* __restrict__ rz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 p;
  load_g1(p, px, py, pz, i, n);
  if (qinf[i]) {
    store_g1(rx, ry, rz, p, i, n);
    return;
  }
  uint32_t x2[L], y2[L];
  load<L>(x2, qx, i, n);
  load<L>(y2, qy, i, n);
  G1 r;
  g1_add_mixed(r, p, x2, y2);
  store_g1(rx, ry, rz, r, i, n);
}

// p: x/y/z [12, n] Montgomery Fp; q: x/y [12, n] Montgomery Fp (canonical),
// inf [n] bytes, nonzero = identity.
extern "C" int kzg_g1_add_mixed(const void* px, const void* py, const void* pz, const void* qx,
                                const void* qy, const void* qinf, void* rx, void* ry, void* rz,
                                long long n, void* stream) {
  const int threads = 128;
  g1_add_mixed_kernel<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
      (const uint32_t*)qy, (const uint8_t*)qinf, (uint32_t*)rx, (uint32_t*)ry, (uint32_t*)rz, n);
  return (int)cudaGetLastError();
}
