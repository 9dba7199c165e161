// Native host library of the PyTorch port: the BLS12-381 multi-pairing check
// that closes the verifier, the counterpart of the reference's native blst
// layer (its bls12_381 crate). The card runs the batched field, MSM, NTT and
// decompression work; this library runs only the pairing.
//
// The pairing part of the JAX package's csrc/kzg_host.cpp (the port keeps its
// own copies of what it needs; that library's point codecs and subgroup checks
// are left out, since the port decompresses on the card). 64-bit-limb
// Montgomery field arithmetic (CIOS), Fp2/Fp6/Fp12 towers (Fp2 = Fp[u]/(u^2+1),
// Fp6 = Fp2[v]/(v^3 - (1+u)), Fp12 = Fp6[w]/(w^2 - v)), a Miller loop over
// |z| = 0xd201000000010000 and an addition-chain final exponentiation.
// Held against the pure-Python oracle in utils/bls_host.py by the tests.
//
// Build (utils/native.py does it at first use, into _build/):
//   g++ -O3 -march=native -funroll-loops -shared -fPIC -o libkzg_host.so kzg_host.cpp

#include <cstdint>
#include <cstring>
#include <cstddef>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Fp: 381-bit prime field, 6x64-bit limbs, Montgomery form (R = 2^384)
// ---------------------------------------------------------------------------

struct fp { u64 v[6]; };

static const u64 P_LIMBS[6] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const u64 N0INV = 0x89f3fffcfffcfffdULL;
static const fp FP_ONE = {{0x760900000002fffdULL, 0xebf4000bc40c0002ULL,
                           0x5f48985753c758baULL, 0x77ce585370525745ULL,
                           0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL}};
static const fp FP_R2 = {{0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL,
                          0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL,
                          0x9a793e85b519952dULL, 0x11988fe592cae3aaULL}};
static const fp FP_ZERO = {{0, 0, 0, 0, 0, 0}};

// exponents (little-endian limbs, plain integers)
static const u64 EXP_PM2[6] = {0xb9feffffffffaaa9ULL, 0x1eabfffeb153ffffULL,
                               0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                               0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const u64 EXP_PM1D6[6] = {0x49aa7ffffffff1c7ULL, 0x051caaaa72e35555ULL,
                                 0xe688231ad3c82906ULL, 0xe613e1eb7deb831fULL,
                                 0x0c849bf3b5e1f223ULL, 0x045582fc5eeaa66fULL};
// hard part of the final exponentiation: (p^4 - p^2 + 1) / r
static const u64 EXP_HARD[20] = {
    0xe516c3f438e3ba79ULL, 0xfa9912aae208ccf1ULL, 0x905ce937335d5b68ULL,
    0xc71a2629b0dea236ULL, 0x83774940996754c8ULL, 0x21d160aeb6a1e799ULL,
    0x2ed0b283ed237db4ULL, 0x915c97f36c6f1821ULL, 0x67f17fcbde783765ULL,
    0x2378b9039096d1b7ULL, 0x7988f8761bdc51dcULL, 0x2076995003fc77a1ULL,
    0x827eca0ba621315bULL, 0xe5a72bce8d63cb9fULL, 0xf68f7764c28b6f8aULL,
    0x2f230063cf081517ULL, 0x94506632528d6a9aULL, 0xd3cde88eeb996ca3ULL,
    0xc0bd38c3195c899eULL, 0x000f686b3d807d01ULL};
static const u64 BLS_X = 0xd201000000010000ULL;  // |z|, z < 0

static inline int fp_cmp_p(const u64 t[6]) {  // t >= p ?
  for (int i = 5; i >= 0; i--) {
    if (t[i] > P_LIMBS[i]) return 1;
    if (t[i] < P_LIMBS[i]) return -1;
  }
  return 0;
}

static inline void fp_sub_p(u64 t[6]) {
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)t[i] - P_LIMBS[i] - (u64)borrow;
    t[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
}

static void fp_add(const fp &a, const fp &b, fp &o) {
  u128 carry = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)a.v[i] + b.v[i] + (u64)carry;
    o.v[i] = (u64)cur;
    carry = cur >> 64;
  }
  if (carry || fp_cmp_p(o.v) >= 0) fp_sub_p(o.v);
}

static void fp_sub(const fp &a, const fp &b, fp &o) {
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)a.v[i] - b.v[i] - (u64)borrow;
    o.v[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 6; i++) {
      u128 cur = (u128)o.v[i] + P_LIMBS[i] + (u64)carry;
      o.v[i] = (u64)cur;
      carry = cur >> 64;
    }
  }
}

static void fp_neg(const fp &a, fp &o) {
  bool zero = true;
  for (int i = 0; i < 6; i++) zero &= (a.v[i] == 0);
  if (zero) { o = a; return; }
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)P_LIMBS[i] - a.v[i] - (u64)borrow;
    o.v[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
}

static void fp_mul(const fp &a, const fp &b, fp &o) {
  u64 t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 6; i++) {
    u64 ai = a.v[i];
    u128 carry = 0;
    for (int j = 0; j < 6; j++) {
      u128 cur = (u128)ai * b.v[j] + t[j] + (u64)carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[6] + (u64)carry;
    t[6] = (u64)cur;
    t[7] += (u64)(cur >> 64);

    u64 m = t[0] * N0INV;
    carry = 0;
    for (int j = 0; j < 6; j++) {
      u128 cur2 = (u128)m * P_LIMBS[j] + t[j] + (u64)carry;
      t[j] = (u64)cur2;
      carry = cur2 >> 64;
    }
    cur = (u128)t[6] + (u64)carry;
    t[6] = (u64)cur;
    t[7] += (u64)(cur >> 64);
    for (int j = 0; j < 7; j++) t[j] = t[j + 1];
    t[7] = 0;
  }
  memcpy(o.v, t, 48);
  if (t[6] || fp_cmp_p(o.v) >= 0) fp_sub_p(o.v);
}

static inline void fp_sqr(const fp &a, fp &o) { fp_mul(a, a, o); }

static void fp_pow(const fp &a, const u64 *exp, int nlimbs, fp &o) {
  fp acc = FP_ONE;
  bool started = false;
  for (int i = nlimbs - 1; i >= 0; i--) {
    for (int b = 63; b >= 0; b--) {
      if (started) fp_sqr(acc, acc);
      if ((exp[i] >> b) & 1) {
        if (started) fp_mul(acc, a, acc);
        else { acc = a; started = true; }
      }
    }
  }
  o = started ? acc : FP_ONE;
}

static void fp_inv(const fp &a, fp &o) { fp_pow(a, EXP_PM2, 6, o); }

// bytes (48, big-endian, standard form) <-> Montgomery fp
static bool fp_from_bytes(const uint8_t *in, fp &o) {
  u64 t[6];
  for (int i = 0; i < 6; i++) {
    u64 w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | in[(5 - i) * 8 + j];
    t[i] = w;
  }
  if (fp_cmp_p(t) >= 0) return false;
  fp std_form;
  memcpy(std_form.v, t, 48);
  fp_mul(std_form, FP_R2, o);
  return true;
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2+1); xi = 1 + u
// ---------------------------------------------------------------------------

struct fp2 { fp c0, c1; };
static const fp2 FP2_ZERO = {FP_ZERO, FP_ZERO};
static const fp2 FP2_ONE = {FP_ONE, FP_ZERO};

static void fp2_add(const fp2 &a, const fp2 &b, fp2 &o) {
  fp_add(a.c0, b.c0, o.c0);
  fp_add(a.c1, b.c1, o.c1);
}
static void fp2_sub(const fp2 &a, const fp2 &b, fp2 &o) {
  fp_sub(a.c0, b.c0, o.c0);
  fp_sub(a.c1, b.c1, o.c1);
}
static void fp2_neg(const fp2 &a, fp2 &o) {
  fp_neg(a.c0, o.c0);
  fp_neg(a.c1, o.c1);
}
static void fp2_conj(const fp2 &a, fp2 &o) {
  o.c0 = a.c0;
  fp_neg(a.c1, o.c1);
}
static void fp2_mul(const fp2 &a, const fp2 &b, fp2 &o) {
  // Karatsuba: 3 base muls
  fp ac, bd, s, t;
  fp_mul(a.c0, b.c0, ac);
  fp_mul(a.c1, b.c1, bd);
  fp_add(a.c0, a.c1, s);
  fp_add(b.c0, b.c1, t);
  fp_mul(s, t, s);
  fp_sub(ac, bd, o.c0);
  fp_sub(s, ac, s);
  fp_sub(s, bd, o.c1);
}
static void fp2_sqr(const fp2 &a, fp2 &o) {
  // complex squaring: 2 base muls
  fp s, d, t;
  fp_add(a.c0, a.c1, s);
  fp_sub(a.c0, a.c1, d);
  fp_mul(a.c0, a.c1, t);
  fp_mul(s, d, o.c0);
  fp_add(t, t, o.c1);
}
static void fp2_mul_fp(const fp2 &a, const fp &b, fp2 &o) {
  fp_mul(a.c0, b, o.c0);
  fp_mul(a.c1, b, o.c1);
}
static void fp2_dbl(const fp2 &a, fp2 &o) {
  fp_add(a.c0, a.c0, o.c0);
  fp_add(a.c1, a.c1, o.c1);
}
static void fp2_mul_xi(const fp2 &a, fp2 &o) {  // * (1+u)
  fp t0, t1;
  fp_sub(a.c0, a.c1, t0);
  fp_add(a.c0, a.c1, t1);
  o.c0 = t0;
  o.c1 = t1;
}
static void fp2_inv(const fp2 &a, fp2 &o) {
  fp d, t0, t1;
  fp_sqr(a.c0, t0);
  fp_sqr(a.c1, t1);
  fp_add(t0, t1, d);
  fp_inv(d, d);
  fp_mul(a.c0, d, o.c0);
  fp_mul(a.c1, d, t0);
  fp_neg(t0, o.c1);
}
static void fp2_pow(const fp2 &a, const u64 *exp, int nlimbs, fp2 &o) {
  fp2 acc = FP2_ONE;
  for (int i = nlimbs - 1; i >= 0; i--)
    for (int b = 63; b >= 0; b--) {
      fp2_sqr(acc, acc);
      if ((exp[i] >> b) & 1) fp2_mul(acc, a, acc);
    }
  o = acc;
}
// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct fp6 { fp2 c0, c1, c2; };
struct fp12 { fp6 a, b; };
static const fp6 FP6_ZERO = {FP2_ZERO, FP2_ZERO, FP2_ZERO};
static const fp6 FP6_ONE = {FP2_ONE, FP2_ZERO, FP2_ZERO};
static const fp12 FP12_ONE = {FP6_ONE, FP6_ZERO};

static void fp6_add(const fp6 &x, const fp6 &y, fp6 &o) {
  fp2_add(x.c0, y.c0, o.c0);
  fp2_add(x.c1, y.c1, o.c1);
  fp2_add(x.c2, y.c2, o.c2);
}
static void fp6_sub(const fp6 &x, const fp6 &y, fp6 &o) {
  fp2_sub(x.c0, y.c0, o.c0);
  fp2_sub(x.c1, y.c1, o.c1);
  fp2_sub(x.c2, y.c2, o.c2);
}
static void fp6_neg(const fp6 &x, fp6 &o) {
  fp2_neg(x.c0, o.c0);
  fp2_neg(x.c1, o.c1);
  fp2_neg(x.c2, o.c2);
}
static void fp6_mul(const fp6 &x, const fp6 &y, fp6 &o) {
  // Karatsuba/Toom: 6 fp2 muls
  fp2 t0, t1, t2, s01, s12, s02, u01, u12, u02, r0, r1, r2;
  fp2_mul(x.c0, y.c0, t0);
  fp2_mul(x.c1, y.c1, t1);
  fp2_mul(x.c2, y.c2, t2);
  fp2_add(x.c1, x.c2, s12);
  fp2_add(y.c1, y.c2, u12);
  fp2_mul(s12, u12, s12);  // x1y1 + x1y2 + x2y1 + x2y2
  fp2_add(x.c0, x.c1, s01);
  fp2_add(y.c0, y.c1, u01);
  fp2_mul(s01, u01, s01);
  fp2_add(x.c0, x.c2, s02);
  fp2_add(y.c0, y.c2, u02);
  fp2_mul(s02, u02, s02);
  // c0 = t0 + xi*(s12 - t1 - t2)
  fp2_sub(s12, t1, r0);
  fp2_sub(r0, t2, r0);
  fp2_mul_xi(r0, r0);
  fp2_add(r0, t0, r0);
  // c1 = s01 - t0 - t1 + xi*t2
  fp2_sub(s01, t0, r1);
  fp2_sub(r1, t1, r1);
  fp2_mul_xi(t2, u12);
  fp2_add(r1, u12, r1);
  // c2 = s02 - t0 - t2 + t1
  fp2_sub(s02, t0, r2);
  fp2_sub(r2, t2, r2);
  fp2_add(r2, t1, r2);
  o.c0 = r0;
  o.c1 = r1;
  o.c2 = r2;
}
static void fp6_dbl(const fp6 &x, fp6 &o) {
  fp2_dbl(x.c0, o.c0);
  fp2_dbl(x.c1, o.c1);
  fp2_dbl(x.c2, o.c2);
}
static void fp6_mul_by_v(const fp6 &x, fp6 &o) {
  fp6 r;
  fp2_mul_xi(x.c2, r.c0);
  r.c1 = x.c0;
  r.c2 = x.c1;
  o = r;
}
static void fp6_inv(const fp6 &x, fp6 &o) {
  fp2 t0, t1, t2, s, d;
  fp2_sqr(x.c0, t0);
  fp2_mul(x.c1, x.c2, s);
  fp2_mul_xi(s, s);
  fp2_sub(t0, s, t0);
  fp2_sqr(x.c2, t1);
  fp2_mul_xi(t1, t1);
  fp2_mul(x.c0, x.c1, s);
  fp2_sub(t1, s, t1);
  fp2_sqr(x.c1, t2);
  fp2_mul(x.c0, x.c2, s);
  fp2_sub(t2, s, t2);
  // d = c0*t0 + xi*(c2*t1 + c1*t2)
  fp2 tmp;
  fp2_mul(x.c2, t1, tmp);
  fp2 tmp2;
  fp2_mul(x.c1, t2, tmp2);
  fp2_add(tmp, tmp2, tmp);
  fp2_mul_xi(tmp, tmp);
  fp2_mul(x.c0, t0, d);
  fp2_add(d, tmp, d);
  fp2_inv(d, d);
  fp2_mul(t0, d, o.c0);
  fp2_mul(t1, d, o.c1);
  fp2_mul(t2, d, o.c2);
}

static void fp12_mul(const fp12 &x, const fp12 &y, fp12 &o) {
  fp6 ac, bd, t, u1, u2;
  fp6_mul(x.a, y.a, ac);
  fp6_mul(x.b, y.b, bd);
  fp6_add(x.a, x.b, u1);
  fp6_add(y.a, y.b, u2);
  fp6_mul(u1, u2, t);
  fp12 r;
  fp6_mul_by_v(bd, r.a);
  fp6_add(ac, r.a, r.a);
  fp6_sub(t, ac, r.b);
  fp6_sub(r.b, bd, r.b);
  o = r;
}
static void fp12_sqr(const fp12 &x, fp12 &o) {
  // complex squaring over Fp6: 2 fp6 muls
  // (a+bw)^2 = (a+b)(a+vb) - ab - v*ab + (2ab)w
  fp6 ab, s, t;
  fp6_mul(x.a, x.b, ab);
  fp6_add(x.a, x.b, s);
  fp6_mul_by_v(x.b, t);
  fp6_add(x.a, t, t);
  fp6_mul(s, t, s);
  fp6_sub(s, ab, s);
  fp6_mul_by_v(ab, t);
  fp6_sub(s, t, o.a);
  fp6_dbl(ab, o.b);
}
static void fp12_conj(const fp12 &x, fp12 &o) {
  o.a = x.a;
  fp6_neg(x.b, o.b);
}
static void fp12_inv(const fp12 &x, fp12 &o) {
  fp6 asq, bsq, d;
  fp6_mul(x.a, x.a, asq);
  fp6_mul(x.b, x.b, bsq);
  fp6_mul_by_v(bsq, bsq);
  fp6_sub(asq, bsq, d);
  fp6_inv(d, d);
  fp6_mul(x.a, d, o.a);
  fp6_mul(x.b, d, d);
  fp6_neg(d, o.b);
}
static bool fp12_eq(const fp12 &x, const fp12 &y) {
  return memcmp(&x, &y, sizeof(fp12)) == 0;
}

// Frobenius in the w-basis: f = sum c_i w^i, f^p = sum conj(c_i) gamma^i w^i
static fp2 GAMMA_POWS[6];
static bool GAMMA_INIT = false;
static void init_gammas() {
  if (GAMMA_INIT) return;
  fp2 xi = {FP_ONE, FP_ONE};
  fp2 g;
  fp2_pow(xi, EXP_PM1D6, 6, g);
  GAMMA_POWS[0] = FP2_ONE;
  for (int i = 1; i < 6; i++) fp2_mul(GAMMA_POWS[i - 1], g, GAMMA_POWS[i]);
  GAMMA_INIT = true;
}
static void fp12_frobenius(const fp12 &x, fp12 &o) {
  init_gammas();
  const fp2 *c[6] = {&x.a.c0, &x.b.c0, &x.a.c1, &x.b.c1, &x.a.c2, &x.b.c2};
  fp2 *oc[6] = {&o.a.c0, &o.b.c0, &o.a.c1, &o.b.c1, &o.a.c2, &o.b.c2};
  for (int i = 0; i < 6; i++) {
    fp2 t;
    fp2_conj(*c[i], t);
    fp2_mul(t, GAMMA_POWS[i], *oc[i]);
  }
}

static void fp12_pow(const fp12 &x, const u64 *exp, int nlimbs, fp12 &o) {
  fp12 acc = FP12_ONE;
  bool started = false;
  for (int i = nlimbs - 1; i >= 0; i--)
    for (int b = 63; b >= 0; b--) {
      if (started) fp12_sqr(acc, acc);
      if ((exp[i] >> b) & 1) {
        if (started) fp12_mul(acc, x, acc);
        else { acc = x; started = true; }
      }
    }
  o = started ? acc : FP12_ONE;
}

// Pairing: projective Miller loop on the twist + cyclotomic final exp
//
// Optimal ate for BLS12-381. P in G1 is mapped to the twist E'(Fp12) via the
// M-type untwist phi(x,y) = (x*w^2, y*w^3), so every line is computed with
// Fp2 arithmetic through points of E'(Fp2) and evaluates to the sparse Fp12
// element  l0 + l1*w^2 + l2*w^3  =  (l0 + l1*v) + (l2*v)*w  (slots 1, v, vw).
// Doubling/addition steps use the homogeneous-projective formulas of
// eprint 2013/722 §4.3 (re-derived; Fp2-subfield scale factors are killed by
// the final exponentiation). Final exp: easy part, then the Hayashida-
// Hayasaka-Teruya chain (eprint 2020/875) computing f^(3(p^4-p^2+1)/r) with
// Granger-Scott cyclotomic squarings. Replaces the reference's blst
// multi_miller_loop/final_exp (bls12_381 crate).
// ---------------------------------------------------------------------------

struct line_t { fp2 l0, l1, l2; };   // l0 + l1*w^2 + l2*w^3
struct G2Proj { fp2 X, Y, Z; };      // homogeneous projective on the twist

// x * (b0 + b1*v), 5 fp2 muls
static void fp6_mul_by_01(const fp6 &x, const fp2 &b0, const fp2 &b1, fp6 &o) {
  fp2 t0, t1, t2, s, u;
  fp2_mul(x.c0, b0, t0);
  fp2_mul(x.c1, b1, t1);
  fp2_add(x.c0, x.c1, s);
  fp2_add(b0, b1, u);
  fp2_mul(s, u, s);           // x0b0 + x0b1 + x1b0 + x1b1
  fp2_mul(x.c2, b1, t2);
  fp2_mul_xi(t2, t2);
  fp6 r;
  fp2_add(t0, t2, r.c0);      // x0b0 + xi*x2b1
  fp2_sub(s, t0, r.c1);
  fp2_sub(r.c1, t1, r.c1);    // x0b1 + x1b0
  fp2_mul(x.c2, b0, t2);
  fp2_add(t1, t2, r.c2);      // x1b1 + x2b0
  o = r;
}
// x * (b1*v), 3 fp2 muls
static void fp6_mul_by_1(const fp6 &x, const fp2 &b1, fp6 &o) {
  fp6 r;
  fp2_mul(x.c2, b1, r.c0);
  fp2_mul_xi(r.c0, r.c0);
  fp2_mul(x.c0, b1, r.c1);
  fp2_mul(x.c1, b1, r.c2);
  o.c0 = r.c0;
  o.c1 = r.c1;
  o.c2 = r.c2;
}
// f *= (l0 + l1*v) + (l2*v)*w   (sparse, 13 fp2 muls)
static void fp12_mul_by_line(fp12 &f, const line_t &l) {
  fp6 t0, t1, t2, s;
  fp2 b01;
  fp6_mul_by_01(f.a, l.l0, l.l1, t0);
  fp6_mul_by_1(f.b, l.l2, t1);
  fp6_add(f.a, f.b, s);
  fp2_add(l.l1, l.l2, b01);
  fp6_mul_by_01(s, l.l0, b01, t2);   // (a+b)(la+lb)
  fp6_mul_by_v(t1, s);
  fp6_add(t0, s, f.a);               // a*la + v*(b*lb)
  fp6_sub(t2, t0, f.b);
  fp6_sub(f.b, t1, f.b);             // a*lb + b*la
}

// 3*b' = 12*(1+u) in Montgomery form, computed on demand
static void fp2_three_b_twist(fp2 &o) {
  fp twelve;
  fp_add(FP_ONE, FP_ONE, twelve);          // 2
  fp_add(twelve, FP_ONE, twelve);          // 3
  fp_add(twelve, twelve, o.c0);            // 6
  fp_add(o.c0, o.c0, twelve);              // 12
  o.c0 = twelve;
  o.c1 = twelve;
}

// T <- 2T, line through T evaluated at P=(px,py)
static void dbl_step(G2Proj &T, const fp &px, const fp &py, line_t &l) {
  fp2 A, B, C, E, FF, H, XX, EE, t;
  fp2_mul(T.X, T.Y, A);                    // XY
  fp2_sqr(T.Y, B);                         // Y^2
  fp2_sqr(T.Z, C);                         // Z^2
  fp2 threeb;
  fp2_three_b_twist(threeb);
  fp2_mul(C, threeb, E);                   // 3b'Z^2
  fp2_dbl(E, FF);
  fp2_add(FF, E, FF);                      // 9b'Z^2
  fp2_add(T.Y, T.Z, H);
  fp2_sqr(H, H);
  fp2_sub(H, B, H);
  fp2_sub(H, C, H);                        // 2YZ
  fp2_sqr(T.X, XX);                        // X^2
  fp2_sqr(E, EE);                          // E^2
  // line: l0 = B - E, l1 = -3X^2 * px, l2 = H * py
  fp2_sub(B, E, l.l0);
  fp2_dbl(XX, t);
  fp2_add(t, XX, t);                       // 3X^2
  fp2_neg(t, t);
  fp2_mul_fp(t, px, l.l1);
  fp2_mul_fp(H, py, l.l2);
  // point: X3 = 2XY(B-F), Y3 = (B+F)^2 - 12E^2, Z3 = 4BH  (scale 4)
  fp2 r0, r1, r2;
  fp2_sub(B, FF, t);
  fp2_mul(A, t, r0);
  fp2_dbl(r0, r0);
  fp2_add(B, FF, t);
  fp2_sqr(t, r1);
  fp2_dbl(EE, t);
  fp2_add(t, EE, t);                       // 3E^2
  fp2_dbl(t, t);                           // 6E^2
  fp2_dbl(t, t);                           // 12E^2
  fp2_sub(r1, t, r1);
  fp2_mul(B, H, r2);
  fp2_dbl(r2, r2);
  fp2_dbl(r2, r2);
  T.X = r0;
  T.Y = r1;
  T.Z = r2;
}

// T <- T + Q (Q affine on the twist), line through T,Q evaluated at P
static void add_step(G2Proj &T, const fp2 &qx, const fp2 &qy, const fp &px,
                     const fp &py, line_t &l) {
  fp2 theta, lam, C, D, E, FF, G, H, t;
  fp2_mul(qy, T.Z, t);
  fp2_sub(T.Y, t, theta);                  // Y - y2*Z
  fp2_mul(qx, T.Z, t);
  fp2_sub(T.X, t, lam);                    // X - x2*Z
  fp2_sqr(theta, C);
  fp2_sqr(lam, D);
  fp2_mul(lam, D, E);                      // lam^3
  fp2_mul(T.Z, C, FF);                     // Z*theta^2
  fp2_mul(T.X, D, G);                      // X*lam^2
  fp2_add(E, FF, H);
  fp2_sub(H, G, H);
  fp2_sub(H, G, H);                        // E + F - 2G
  // line: l0 = theta*x2 - lam*y2, l1 = -theta*px, l2 = lam*py
  fp2 u0, u1;
  fp2_mul(theta, qx, u0);
  fp2_mul(lam, qy, u1);
  fp2_sub(u0, u1, l.l0);
  fp2_neg(theta, t);
  fp2_mul_fp(t, px, l.l1);
  fp2_mul_fp(lam, py, l.l2);
  // point: X3 = lam*H, Y3 = theta*(G-H) - Y*E, Z3 = Z*E
  fp2 r0, r1, r2;
  fp2_mul(lam, H, r0);
  fp2_sub(G, H, t);
  fp2_mul(theta, t, r1);
  fp2_mul(T.Y, E, t);
  fp2_sub(r1, t, r1);
  fp2_mul(T.Z, E, r2);
  T.X = r0;
  T.Y = r1;
  T.Z = r2;
}

// shared-accumulator multi-Miller loop: f = prod_i f_{z,Q_i}(P_i)
static void miller_loop_multi(const fp *pxs, const fp *pys, const fp2 *qxs,
                              const fp2 *qys, size_t n, fp12 &o) {
  fp12 f = FP12_ONE;
  G2Proj *T = new G2Proj[n];
  for (size_t i = 0; i < n; i++) {
    T[i].X = qxs[i];
    T[i].Y = qys[i];
    T[i].Z = FP2_ONE;
  }
  int top = 63;
  while (!((BLS_X >> top) & 1)) top--;
  line_t l;
  for (int b = top - 1; b >= 0; b--) {
    fp12_sqr(f, f);
    for (size_t i = 0; i < n; i++) {
      dbl_step(T[i], pxs[i], pys[i], l);
      fp12_mul_by_line(f, l);
    }
    if ((BLS_X >> b) & 1) {
      for (size_t i = 0; i < n; i++) {
        add_step(T[i], qxs[i], qys[i], pxs[i], pys[i], l);
        fp12_mul_by_line(f, l);
      }
    }
  }
  delete[] T;
  // z < 0: conjugate
  fp12_conj(f, o);
}

// Granger-Scott squaring in the cyclotomic subgroup (9 fp2 squarings)
static void fp12_cyc_sqr(const fp12 &x, fp12 &o) {
  fp2 t0, t1, t2, t3, t4, t5, t6, t7, t8, s;
  fp2_sqr(x.b.c1, t0);
  fp2_sqr(x.a.c0, t1);
  fp2_add(x.b.c1, x.a.c0, s);
  fp2_sqr(s, t6);
  fp2_sub(t6, t0, t6);
  fp2_sub(t6, t1, t6);          // 2*x0*x4
  fp2_sqr(x.a.c2, t2);
  fp2_sqr(x.b.c0, t3);
  fp2_add(x.a.c2, x.b.c0, s);
  fp2_sqr(s, t7);
  fp2_sub(t7, t2, t7);
  fp2_sub(t7, t3, t7);          // 2*x2*x3
  fp2_sqr(x.b.c2, t4);
  fp2_sqr(x.a.c1, t5);
  fp2_add(x.b.c2, x.a.c1, s);
  fp2_sqr(s, t8);
  fp2_sub(t8, t4, t8);
  fp2_sub(t8, t5, t8);
  fp2_mul_xi(t8, t8);           // 2*x1*x5*xi
  fp2_mul_xi(t0, t0);
  fp2_add(t0, t1, t0);          // x0^2 + xi*x4^2
  fp2_mul_xi(t2, t2);
  fp2_add(t2, t3, t2);          // x3^2 + xi*x2^2
  fp2_mul_xi(t4, t4);
  fp2_add(t4, t5, t4);          // x1^2 + xi*x5^2
  fp12 r;
  fp2_sub(t0, x.a.c0, s);
  fp2_dbl(s, s);
  fp2_add(s, t0, r.a.c0);
  fp2_sub(t2, x.a.c1, s);
  fp2_dbl(s, s);
  fp2_add(s, t2, r.a.c1);
  fp2_sub(t4, x.a.c2, s);
  fp2_dbl(s, s);
  fp2_add(s, t4, r.a.c2);
  fp2_add(t8, x.b.c0, s);
  fp2_dbl(s, s);
  fp2_add(s, t8, r.b.c0);
  fp2_add(t6, x.b.c1, s);
  fp2_dbl(s, s);
  fp2_add(s, t6, r.b.c1);
  fp2_add(t7, x.b.c2, s);
  fp2_dbl(s, s);
  fp2_add(s, t7, r.b.c2);
  o = r;
}

// f^z for the (negative) BLS seed z, f in the cyclotomic subgroup
static void fp12_expt(const fp12 &x, fp12 &o) {
  fp12 acc = x;
  int top = 63;
  while (!((BLS_X >> top) & 1)) top--;
  for (int b = top - 1; b >= 0; b--) {
    fp12_cyc_sqr(acc, acc);
    if ((BLS_X >> b) & 1) fp12_mul(acc, x, acc);
  }
  fp12_conj(acc, o);  // z < 0
}

static void final_exponentiation(const fp12 &f, fp12 &o) {
  // easy part: f^((p^6-1)(p^2+1))
  fp12 m, t0, t1, t2;
  fp12_conj(f, t0);
  fp12_inv(f, t1);
  fp12_mul(t0, t1, m);          // f^(p^6-1)
  fp12_frobenius(m, t0);
  fp12_frobenius(t0, t0);
  fp12_mul(t0, m, m);           // ^(p^2+1); m is now cyclotomic
  // hard part (HHT, eprint 2020/875): m^(3(p^4-p^2+1)/r)
  //   = m^3 * m^((x-1)^2 (x+p) (x^2+p^2-1))
  fp12_cyc_sqr(m, t0);          // m^2
  fp12_expt(m, t1);             // m^x
  fp12_conj(m, t2);             // m^-1
  fp12_mul(t1, t2, t1);         // m^(x-1)
  fp12_expt(t1, t2);            // m^(x(x-1))
  fp12_conj(t1, t1);
  fp12_mul(t1, t2, t1);         // m^((x-1)^2)
  fp12_expt(t1, t2);            // m^((x-1)^2 x)
  fp12_frobenius(t1, t1);       // m^((x-1)^2 p)
  fp12_mul(t1, t2, t1);         // m^((x-1)^2 (x+p))
  fp12_mul(m, t0, o);           // m^3
  fp12_expt(t1, t0);            // m^((x-1)^2 (x+p) x)
  fp12_expt(t0, t2);            // m^((x-1)^2 (x+p) x^2)
  fp12_frobenius(t1, t0);
  fp12_frobenius(t0, t0);       // m^((x-1)^2 (x+p) p^2)
  fp12_conj(t1, t1);            // m^(-(x-1)^2 (x+p))
  fp12_mul(t1, t2, t1);         // m^((x-1)^2 (x+p) (x^2-1))
  fp12_mul(t1, t0, t1);         // m^((x-1)^2 (x+p) (x^2+p^2-1))
  fp12_mul(o, t1, o);
}

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// prod_i e(P_i, Q_i) == 1 ?  g1s: n*96 bytes (x||y), g2s: n*192 bytes
// (x0||x1||y0||y1), skip[i] nonzero to skip (identity inputs). Returns 1 if
// the pairing product is one, 0 otherwise, negative on malformed input.
int kzg_pairing_check(const uint8_t *g1s, const uint8_t *g2s,
                      const uint8_t *skip, size_t n) {
  fp *pxs = new fp[n];
  fp *pys = new fp[n];
  fp2 *qxs = new fp2[n];
  fp2 *qys = new fp2[n];
  size_t m = 0;
  for (size_t i = 0; i < n; i++) {
    if (skip && skip[i]) continue;
    bool ok = fp_from_bytes(g1s + 96 * i, pxs[m]) &&
              fp_from_bytes(g1s + 96 * i + 48, pys[m]) &&
              fp_from_bytes(g2s + 192 * i, qxs[m].c0) &&
              fp_from_bytes(g2s + 192 * i + 48, qxs[m].c1) &&
              fp_from_bytes(g2s + 192 * i + 96, qys[m].c0) &&
              fp_from_bytes(g2s + 192 * i + 144, qys[m].c1);
    if (!ok) {
      delete[] pxs; delete[] pys; delete[] qxs; delete[] qys;
      return -3;
    }
    m++;
  }
  fp12 f = FP12_ONE, result;
  if (m) miller_loop_multi(pxs, pys, qxs, qys, m, f);
  delete[] pxs; delete[] pys; delete[] qxs; delete[] qys;
  final_exponentiation(f, result);
  return fp12_eq(result, FP12_ONE) ? 1 : 0;
}

// Internal consistency check, callable from tests: validates the optimized
// final exponentiation (HHT chain + cyclotomic squarings) against the plain
// square-and-multiply hard part (EXP_HARD), and the cyclotomic squaring
// against the generic fp12 squaring, on a Miller-loop output. The HHT chain
// computes the 3rd power of the plain hard part (cofactor 3), so the plain
// result is cubed before comparison. Returns 1 on success.
int kzg_pairing_selftest(const uint8_t *g1_xy96, const uint8_t *g2_xyxy192) {
  fp px, py;
  fp2 qx, qy;
  if (!fp_from_bytes(g1_xy96, px) || !fp_from_bytes(g1_xy96 + 48, py))
    return -3;
  if (!fp_from_bytes(g2_xyxy192, qx.c0) ||
      !fp_from_bytes(g2_xyxy192 + 48, qx.c1) ||
      !fp_from_bytes(g2_xyxy192 + 96, qy.c0) ||
      !fp_from_bytes(g2_xyxy192 + 144, qy.c1))
    return -3;
  fp12 f;
  miller_loop_multi(&px, &py, &qx, &qy, 1, f);
  // easy part
  fp12 m, t0, t1;
  fp12_conj(f, t0);
  fp12_inv(f, t1);
  fp12_mul(t0, t1, m);
  fp12_frobenius(m, t0);
  fp12_frobenius(t0, t0);
  fp12_mul(t0, m, m);
  // cyclotomic squaring vs generic squaring
  fp12 cs, gs;
  fp12_cyc_sqr(m, cs);
  fp12_sqr(m, gs);
  if (!fp12_eq(cs, gs)) return 0;
  // optimized full final exp vs plain hard part cubed
  fp12 fast, plain, plain3;
  final_exponentiation(f, fast);
  fp12_pow(m, EXP_HARD, 20, plain);
  fp12_sqr(plain, plain3);
  fp12_mul(plain3, plain, plain3);
  if (!fp12_eq(fast, plain3)) return 0;
  return 1;
}

}  // extern "C"
