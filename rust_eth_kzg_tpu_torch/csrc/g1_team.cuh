// G1 group operations run by a team of TEAM threads on points in shared
// memory, shared by the kernels whose dependent chains they shorten: the
// G1-FFT's GLV ladders (g1_fft.cu) and the fixed-base MSM's window-sum trees
// and Horner loop (fixed_base_msm.cu).
//
// A point is 3 L words (x, y, z, each L limbs) at any word address; a team's
// scratch W holds 12 field elements. In each product round every active
// thread of the team computes one mont_mul<Fp> on operands in shared memory
// and writes the product back; __syncwarp(mask) separates rounds, so `mask`
// names every thread of the calling warp that runs the same call. The RCB
// formulas are wide: addition is 2 rounds of 6 independent products,
// doubling 2 rounds of 4, once the products by the curve constant 3b = 12
// are done as 4 modular additions (every value is fully reduced, so 12 x by
// additions equals mont_mul(x, 12 R) limb for limb). The results equal the
// plain route (curve.add_plain, curve.double_plain) limb for limb.
#pragma once

#include "curve.cuh"

namespace kzg {

constexpr int TEAM = 8;  // threads a team

__device__ __forceinline__ void lds(uint32_t* r, const uint32_t* s) {
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] = s[j];
}

__device__ __forceinline__ void sts(uint32_t* s, const uint32_t* r) {
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = r[j];
}

// 12 x = 8 x + 4 x (the curve constant 3b) by four modular additions
__device__ __forceinline__ void fp_mul12(uint32_t* o, const uint32_t* x) {
  uint32_t x4[L], x8[L];
  fp_add(x4, x, x);
  fp_add(x4, x4, x4);
  fp_add(x8, x4, x4);
  fp_add(o, x8, x4);
}

__device__ __forceinline__ void fp_neg(uint32_t* o, const uint32_t* x) {
  uint32_t zero[L];
  set_zero<L>(zero);
  fp_sub(o, zero, x);
}

// Nibble k of `packed`: the per-rank operand tables below.
__device__ __forceinline__ int nib(uint32_t packed, int k) { return (packed >> (4 * k)) & 15; }

// R = P + Q, complete projective addition (RCB Algorithm 7, a = 0), run by
// one team on points in shared memory (R may be another block's). R may
// alias P or Q: it is written after the last read of both.
__device__ __noinline__ void team_add(uint32_t* R, const uint32_t* P, const uint32_t* Q, uint32_t* W,
                         int rank, unsigned mask) {
  // round 1: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
  //          m3 = (X1 + Y1)(X2 + Y2), m4 = (Y1 + Z1)(Y2 + Z2), my = (X1 + Z1)(X2 + Z2)
  if (rank < 6) {
    const int i = nib(0x010210, rank), j = nib(0x221000, rank);
    uint32_t a[L], b[L], u[L];
    lds(a, P + i * L);
    lds(b, Q + i * L);
    if (rank >= 3) {
      lds(u, P + j * L);
      fp_add(a, a, u);
      lds(u, Q + j * L);
      fp_add(b, b, u);
    }
    fp_mul(u, a, b);
    sts(W + rank * L, u);
  }
  __syncwarp(mask);
  // linear: t3 = m3 - t0 - t1, t4 = m4 - t1 - t2, 3b ty = 12 (my - t0 - t2),
  //         3 t0, z3 = t1 + 3b t2, t1n = t1 - 3b t2
  if (rank < 6) {
    uint32_t v[L], u[L];
    if (rank < 3) {
      lds(v, W + (3 + rank) * L);
      lds(u, W + nib(0x010, rank) * L);
      fp_sub(v, v, u);
      lds(u, W + nib(0x221, rank) * L);
      fp_sub(v, v, u);
      if (rank == 2) fp_mul12(v, v);
    } else if (rank == 3) {
      lds(u, W);
      fp_add(v, u, u);
      fp_add(v, v, u);
    } else {
      lds(u, W + 2 * L);
      fp_mul12(u, u);
      lds(v, W + L);
      if (rank == 4) fp_add(v, v, u);
      else fp_sub(v, v, u);
    }
    sts(W + (6 + rank) * L, v);
  }
  __syncwarp(mask);
  // round 2 over the linear values [t3, t4, 3b ty, 3 t0, z3, t1n] (slots 6-11):
  // a1 = t3 t1n, a2 = t4 3b ty, b1 = t1n z3, b2 = 3b ty 3 t0, c1 = z3 t4, c2 = 3 t0 t3
  if (rank < 6) {
    uint32_t a[L], b[L], u[L];
    lds(a, W + (6 + nib(0x342510, rank)) * L);
    lds(b, W + (6 + nib(0x013425, rank)) * L);
    fp_mul(u, a, b);
    sts(W + rank * L, u);
  }
  __syncwarp(mask);
  // X3 = a1 - a2, Y3 = b1 + b2, Z3 = c1 + c2
  if (rank < 3) {
    uint32_t v[L], u[L];
    lds(v, W + 2 * rank * L);
    lds(u, W + (2 * rank + 1) * L);
    if (rank == 0) fp_sub(v, v, u);
    else fp_add(v, v, u);
    sts(R + rank * L, v);
  }
  __syncwarp(mask);
}

// R = 2 P, complete projective doubling (RCB Algorithm 9, a = 0), by one
// team; R may alias P.
__device__ __noinline__ void team_double(uint32_t* R, const uint32_t* P, uint32_t* W, int rank,
                            unsigned mask) {
  // round 1: t0 = Y Y, t1 = Y Z, zz = Z Z, xy = X Y
  if (rank < 4) {
    uint32_t a[L], b[L], u[L];
    lds(a, P + nib(0x0211, rank) * L);
    lds(b, P + nib(0x1221, rank) * L);
    fp_mul(u, a, b);
    sts(W + rank * L, u);
  }
  __syncwarp(mask);
  // linear: t2 = 3b zz, z3 = 8 t0, y3 = t0 + t2, t0' = t0 - 3 t2 (slots 6-9)
  if (rank < 4) {
    uint32_t v[L], u[L];
    if (rank == 1) {
      lds(v, W);
      fp_add(v, v, v);
      fp_add(v, v, v);
      fp_add(v, v, v);
    } else {
      lds(u, W + 2 * L);
      fp_mul12(u, u);
      if (rank == 0) {
        copy<L>(v, u);
      } else {
        lds(v, W);
        if (rank == 2) {
          fp_add(v, v, u);
        } else {
          uint32_t w[L];
          fp_add(w, u, u);
          fp_add(w, w, u);
          fp_sub(v, v, w);
        }
      }
    }
    sts(W + (6 + rank) * L, v);
  }
  __syncwarp(mask);
  // round 2: x3 = t2 z3, z3' = t1 z3, m1 = t0' y3, m2 = t0' xy, into slots
  // 0-3 (each slot read in this round is read only by the rank that writes it)
  if (rank < 4) {
    uint32_t a[L], b[L], u[L];
    lds(a, W + nib(0x9916, rank) * L);
    lds(b, W + nib(0x3877, rank) * L);
    fp_mul(u, a, b);
    sts(W + rank * L, u);
  }
  __syncwarp(mask);
  // X3 = 2 m2, Y3 = m1 + x3, Z3 = z3'
  if (rank < 3) {
    uint32_t v[L], u[L];
    if (rank == 0) {
      lds(v, W + 3 * L);
      fp_add(v, v, v);
    } else if (rank == 1) {
      lds(v, W + 2 * L);
      lds(u, W);
      fp_add(v, v, u);
    } else {
      lds(v, W + L);
    }
    sts(R + rank * L, v);
  }
  __syncwarp(mask);
}

__device__ __forceinline__ void team_identity(uint32_t* R, int rank, unsigned mask) {
  if (rank < 3) {
    uint32_t v[L];
    if (rank == 1) set_one<Fp>(v);
    else set_zero<L>(v);
    sts(R + rank * L, v);
  }
  __syncwarp(mask);
}

}  // namespace kzg
