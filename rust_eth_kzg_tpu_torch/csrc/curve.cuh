// G1 group law of BLS12-381 (y^2 = x^3 + 4) on projective coordinates, one
// lane per thread, on top of the Fp core of field.cuh. The formulas are
// transcribed from rust_eth_kzg_tpu/ops/curve.py (Renes-Costello-Batina 2015
// with a = 0, and the incomplete affine chord addition); every intermediate
// is fully reduced, so the canonical coordinates equal the JAX package's.
//
// Bound on this card: a complete addition holds two input points, one output
// and eight temporaries of 12 limbs (about 200 words) plus the CIOS
// accumulator, so register pressure, not arithmetic, sets the occupancy; the
// kernels cap blocks at 128 threads and accept what ptxas spills.
#pragma once

#include "field.cuh"

namespace kzg {

constexpr int L = Fp::N;

__device__ __forceinline__ void fp_mul(uint32_t* o, const uint32_t* a, const uint32_t* b) {
  mont_mul<Fp>(o, a, b);
}
__device__ __forceinline__ void fp_add(uint32_t* o, const uint32_t* a, const uint32_t* b) {
  add<Fp>(o, a, b);
}
__device__ __forceinline__ void fp_sub(uint32_t* o, const uint32_t* a, const uint32_t* b) {
  sub<Fp>(o, a, b);
}
__device__ __forceinline__ void fp_mul_b3(uint32_t* o, const uint32_t* a) {
  uint32_t b3[L];
#pragma unroll
  for (int j = 0; j < L; ++j) b3[j] = FP_B3[j];
  mont_mul<Fp>(o, a, b3);
}

struct G1 {
  uint32_t x[L], y[L], z[L];
};

__device__ __forceinline__ void load_g1(G1& p, const uint32_t* __restrict__ x,
                                        const uint32_t* __restrict__ y,
                                        const uint32_t* __restrict__ z, int64_t i, int64_t n) {
  load<L>(p.x, x, i, n);
  load<L>(p.y, y, i, n);
  load<L>(p.z, z, i, n);
}

__device__ __forceinline__ void store_g1(uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                         uint32_t* __restrict__ z, const G1& p, int64_t i,
                                         int64_t n) {
  store<L>(x, p.x, i, n);
  store<L>(y, p.y, i, n);
  store<L>(z, p.z, i, n);
}

// Complete projective addition (RCB Algorithm 7, a = 0): curve.add_values.
__device__ __forceinline__ void g1_add(G1& r, const G1& p, const G1& q) {
  uint32_t t0[L], t1[L], t2[L], t3[L], t4[L], ty[L], u[L], v[L];
  fp_mul(t0, p.x, q.x);
  fp_mul(t1, p.y, q.y);
  fp_mul(t2, p.z, q.z);
  fp_add(u, p.x, p.y);
  fp_add(v, q.x, q.y);
  fp_mul(t3, u, v);
  fp_sub(t3, t3, t0);
  fp_sub(t3, t3, t1);  // x1 y2 + x2 y1
  fp_add(u, p.y, p.z);
  fp_add(v, q.y, q.z);
  fp_mul(t4, u, v);
  fp_sub(t4, t4, t1);
  fp_sub(t4, t4, t2);  // y1 z2 + y2 z1
  fp_add(u, p.x, p.z);
  fp_add(v, q.x, q.z);
  fp_mul(ty, u, v);
  fp_sub(ty, ty, t0);
  fp_sub(ty, ty, t2);  // x1 z2 + x2 z1
  fp_add(u, t0, t0);
  fp_add(t0, u, t0);   // 3 x1 x2
  fp_mul_b3(t2, t2);   // 3b z1 z2
  fp_add(u, t1, t2);   // z3 = y1 y2 + 3b z1 z2
  fp_sub(t1, t1, t2);  // y1 y2 - 3b z1 z2
  fp_mul_b3(ty, ty);   // 3b (x1 z2 + x2 z1)
  fp_mul(v, t3, t1);
  fp_mul(t2, t4, ty);
  fp_sub(r.x, v, t2);
  fp_mul(v, t1, u);
  fp_mul(t2, ty, t0);
  fp_add(r.y, v, t2);
  fp_mul(v, u, t4);
  fp_mul(t2, t0, t3);
  fp_add(r.z, v, t2);
}

// Complete projective doubling (RCB Algorithm 9, a = 0): curve.double_values.
__device__ __forceinline__ void g1_double(G1& r, const G1& p) {
  uint32_t t0[L], t1[L], t2[L], x3[L], y3[L], z3[L];
  fp_mul(t0, p.y, p.y);
  fp_add(z3, t0, t0);
  fp_add(z3, z3, z3);
  fp_add(z3, z3, z3);  // 8 y^2
  fp_mul(t1, p.y, p.z);
  fp_mul(t2, p.z, p.z);
  fp_mul_b3(t2, t2);   // 3b z^2
  fp_mul(x3, t2, z3);
  fp_add(y3, t0, t2);
  fp_mul(z3, t1, z3);
  fp_add(t1, t2, t2);
  fp_add(t2, t1, t2);  // 9b z^2
  fp_sub(t0, t0, t2);  // y^2 - 9b z^2
  fp_mul(y3, t0, y3);
  fp_add(y3, y3, x3);
  fp_mul(t1, p.x, p.y);
  fp_mul(x3, t0, t1);
  fp_add(r.x, x3, x3);
  copy<L>(r.y, y3);
  copy<L>(r.z, z3);
}

// Complete mixed addition (RCB Algorithm 8, a = 0): q is affine (Z = 1), 13
// products (curve.add_mixed_values). p may be the identity and may equal q.
// A lane whose q is the identity returns p (the caller branches on its mask).
__device__ __forceinline__ void g1_add_mixed(G1& r, const G1& p, const uint32_t* x2,
                                             const uint32_t* y2) {
  uint32_t t0[L], t1[L], t3[L], t4[L], ty[L], u[L], v[L];
  fp_mul(t0, p.x, x2);
  fp_mul(t1, p.y, y2);
  fp_add(u, p.x, p.y);
  fp_add(v, x2, y2);
  fp_mul(t3, u, v);
  fp_sub(t3, t3, t0);
  fp_sub(t3, t3, t1);  // x1 y2 + x2 y1
  fp_mul(t4, y2, p.z);
  fp_add(t4, t4, p.y);  // y1 + y2 z1
  fp_mul(ty, x2, p.z);
  fp_add(ty, ty, p.x);  // x1 + x2 z1
  fp_add(u, t0, t0);
  fp_add(t0, u, t0);    // 3 x1 x2
  fp_mul_b3(v, p.z);    // 3b z1
  fp_add(u, t1, v);     // z3 = y1 y2 + 3b z1
  fp_sub(t1, t1, v);    // y1 y2 - 3b z1
  fp_mul_b3(ty, ty);    // 3b (x1 + x2 z1)
  fp_mul(v, t3, t1);
  uint32_t w[L];
  fp_mul(w, t4, ty);
  fp_sub(r.x, v, w);
  fp_mul(v, t1, u);
  fp_mul(w, ty, t0);
  fp_add(r.y, v, w);
  fp_mul(v, u, t4);
  fp_mul(w, t0, t3);
  fp_add(r.z, v, w);
}

// Affine + affine -> projective by the incomplete chord formula
// (curve.add_affine_values): u = y2 - y1, v = x2 - x1, Z3 = v^3,
// X3 = v (u^2 - v^2 (x1 + x2)), Y3 = u (x1 v^2 - (u^2 - v^2 (x1 + x2))) - y1 v^3.
// An identity operand passes the other one through; equal non-identity
// inputs give the invalid (0 : 0 : 0), which the callers rule out.
__device__ __forceinline__ void g1_add_affine(G1& r, const uint32_t* x1, const uint32_t* y1,
                                              bool ainf, const uint32_t* x2,
                                              const uint32_t* y2, bool binf) {
  if (ainf || binf) {
    if (ainf && binf) {
      set_zero<L>(r.x);
      set_one<Fp>(r.y);
      set_zero<L>(r.z);
    } else {
      // a select per limb, not a pointer select: that would put the
      // operands in local memory
#pragma unroll
      for (int j = 0; j < L; ++j) {
        r.x[j] = ainf ? x2[j] : x1[j];
        r.y[j] = ainf ? y2[j] : y1[j];
      }
      set_one<Fp>(r.z);
    }
    return;
  }
  uint32_t u[L], v[L], usq[L], vsq[L], w[L], t[L], s[L];
  fp_sub(u, y2, y1);
  fp_sub(v, x2, x1);
  fp_mul(usq, u, u);
  fp_mul(vsq, v, v);
  fp_mul(r.z, v, vsq);  // v^3
  fp_add(s, x1, x2);
  fp_mul(t, vsq, s);
  fp_sub(w, usq, t);  // x3 v^2
  fp_mul(r.x, v, w);
  fp_mul(t, x1, vsq);
  fp_sub(t, t, w);
  fp_mul(s, u, t);
  fp_mul(t, y1, r.z);
  fp_sub(r.y, s, t);
}

}  // namespace kzg
