// The whole fixed-base MSM of ops/msm.py::fixed_base_msm in one source, two
// launches: the signed digits, the table reads, the window sums and the
// Horner loop over the windows of one Lim-Lee chain.
//
// Replaces, on every fixed-base MSM (the FK20 prover's 128 slot MSMs, the
// commit key's MSM, the verifier's 64-point commitment MSM),
// rust_eth_kzg_tpu/ops/msm.py::fixed_base_msm (:369) with ::_window_sums
// (:334) and ::signed_digits, i.e. the per-level launches of
// rust_eth_kzg_tpu/ops/pallas_kernels.py::g1_add_affine (:210), ::g1_add
// (:163) and ::g1_double (:176) that those run on, and the torch glue between
// them (the table gathers, the negations and identity selects, the digit
// carries). g1_add.cu and g1_double.cu stay for their other callers;
// g1_add_affine.cu, whose one caller in the package this was, stays as the
// standalone port of :210.
//
// Bound on this card: operations. A window sum of K = chains * P lanes is one
// level of K/2 chord additions (8 products) and a tree of complete additions
// (12 products: the teams' team_add, whose products by 3b are additions);
// each output point then takes (wpc - 1) (window doublings of 8 products +
// 1 addition). Reads are one 96 B table entry a live lane, against about 10
// products (6,000 IMADs) a live lane. Horner's chain (64 doublings and 8
// additions at window 8) is the floor when there are few output points.
//
// Design:
// - Launch 1, one block of 128 threads per (output point, window slot,
//   split g). Each thread makes the post-chord point j = g + G k of its
//   window sum: for both lanes l = j and j + K/2 the signed digit of window
//   c wpc + t (chain c = l / P) of scalar l % P, from the Montgomery scalar
//   by one Fr product by 1 and the carry loop of signed_digits; the table
//   entry |d| - 1 read from the limb-major tables, y negated for d < 0, the
//   identity for d = 0 or an identity base point; then the chord addition.
//   The block sums its points by halving (curve.reduce_sum's order: point k
//   += point k + h), each addition one team of 8 threads (g1_team.cuh; the
//   block's 16 teams take a level's additions in turns). A thread's whole
//   g1_add (curve.cuh) would hold about 190 registers, 2 blocks an SM, and
//   leave the narrow top levels to a warp or less; with teams the launch
//   fits 128 registers, 4 blocks an SM, and a level of 64 additions takes 4
//   rounds of 2 products. G = 1 unless the window sum has more than 256
//   lanes (the commit key's 16,384): then G blocks each take the points
//   j = g (mod G), which is exactly the subtree that reduce_sum builds at
//   width G.
// - Launch 2, one block per 16 output points (per output point when G > 1):
//   the G partial sums of each window by halving, then Horner, one team of
//   8 threads an output point (2 product rounds a doubling, 2 an addition).
// Every value is fully reduced and every addition is the plain route's, in
// its order, so the output equals msm.fixed_base_msm_plain limb for limb.
#include "g1_team.cuh"

using namespace kzg;

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4;   // window-sum blocks an SM: ptxas keeps the launch at 128 registers
constexpr int TEAMS = THREADS / TEAM;
constexpr int PW = 3 * L;       // words of a point in global memory (x, y, z)
constexpr int PS = PW + 1;      // in shared memory: one pad word, against bank conflicts
constexpr int TEAM_W = 12 * L;  // a team's 12 scratch elements (team_add, team_double)

struct Msm {
  const uint32_t* scalars;  // [8, n_out * P] Montgomery Fr, fully reduced
  const uint32_t* tx;       // [12, n_inst * K * D] affine multiples, limb-major
  const uint32_t* ty;
  const uint8_t* base_inf;  // [n_inst * K]
  uint32_t* partials;       // [n_out, wpc, G, PW]
  uint32_t* rx;             // [12, n_out] each
  uint32_t* ry;
  uint32_t* rz;
  int64_t n_out, n_inst;
  int P, wpc, n_win, window;
  int K, chord, M, G, S;    // lanes a window sum; chord level; post-chord points; blocks and points a window sum
};

// v[i] for a run-time i, without indexing the array (which would put it in
// local memory)
__device__ __forceinline__ uint32_t pick(const uint32_t* v, int i) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < Fr::N; ++q) r = q == i ? v[q] : r;
  return r;
}

// Signed digit `wi` of scalar s (msm.signed_digits for one window): the
// standard form by one Fr product by 1, then the windows 0..wi with their
// carries.
__device__ __forceinline__ int signed_digit(const Msm& m, int64_t s, int wi) {
  uint32_t a[Fr::N], one[Fr::N], v[Fr::N];
  load<Fr::N>(a, m.scalars, s, m.n_out * m.P);
  set_zero<Fr::N>(one);
  one[0] = 1;
  mont_mul<Fr>(v, a, one);
  const int half = 1 << (m.window - 1), full = 1 << m.window;
  int carry = 0, d = 0;
  for (int q = 0; q <= wi; ++q) {
    const int lo = q * m.window;
    int u = 0;
    if (lo < 32 * Fr::N) {
      const int limb = lo >> 5, off = lo & 31;
      uint32_t bits = pick(v, limb) >> off;
      if (off + m.window > 32 && limb + 1 < Fr::N) bits |= pick(v, limb + 1) << (32 - off);
      u = (int)(bits & (uint32_t)(full - 1));
    }
    const int e = u + carry;
    carry = e > half;
    d = carry ? e - full : e;
  }
  return d;
}

// The affine table point of lane l (chain l / P, point l % P) in window slot t
// of output point o; returns true for the identity (digit 0 or an identity
// base point), whose x and y are left unread.
__device__ __forceinline__ bool lane_point(const Msm& m, int64_t o, int t, int l, uint32_t* x, uint32_t* y) {
  const int wi = (l / m.P) * m.wpc + t;
  const int d = wi < m.n_win ? signed_digit(m, o * m.P + l % m.P, wi) : 0;
  const int64_t row = (o % m.n_inst) * m.K + l;
  if (d == 0 || m.base_inf[row]) return true;
  const int64_t dd = (int64_t)1 << (m.window - 1);
  const int64_t e = row * dd + (d < 0 ? -d : d) - 1;
  load<L>(x, m.tx, e, m.n_inst * m.K * dd);
  load<L>(y, m.ty, e, m.n_inst * m.K * dd);
  if (d < 0) fp_neg(y, y);
  return false;
}

__device__ __forceinline__ void set_identity(G1& r) {
  set_zero<L>(r.x);
  set_one<Fp>(r.y);
  set_zero<L>(r.z);
}

__device__ __forceinline__ void sts_point(uint32_t* s, const G1& p) {
  sts(s, p.x);
  sts(s + L, p.y);
  sts(s + 2 * L, p.z);
}

// __syncwarp mask of this thread's warp when threads [0, active) of the block
// take part
__device__ __forceinline__ unsigned prefix_mask(int active) {
  const int live = active - (int)(threadIdx.x & ~31u);
  return live >= 32 ? 0xffffffffu : ((1u << live) - 1u);
}

// In-place halving sums over `nsets` sets of n points each (n a power of
// two), curve.reduce_sum's order: point k += point k + h for h = n/2 .. 1;
// set s, point k at pts + (s n + k) PS; the sum ends in point 0. Each
// addition is one team's team_add; the block's teams take a level's
// additions in turns. Every thread of the block calls it.
__device__ void tree_sum(uint32_t* pts, int nsets, int n, uint32_t* W) {
  const int team = threadIdx.x / TEAM, rank = threadIdx.x % TEAM;
  for (int h = n >> 1; h >= 1; h >>= 1) {
    const int adds = nsets * h;
    for (int a0 = 0; a0 < adds; a0 += TEAMS) {
      const int a = a0 + team;
      if (a < adds) {
        uint32_t* p = pts + ((a / h) * n + a % h) * PS;
        const int live = adds - a0 < TEAMS ? adds - a0 : TEAMS;
        team_add(p, p, p + h * PS, W + team * TEAM_W, rank, prefix_mask(live * TEAM));
      }
    }
    __syncthreads();
  }
}

// Launch 1: block b = (o wpc + t) G + g sums the points j = g (mod G) of the
// window sum of output point o, window slot t, into partials[b].
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fixed_base_msm_windows_kernel(Msm m) {
  __shared__ uint32_t pts[THREADS * PS];
  __shared__ uint32_t W[TEAMS * TEAM_W];
  const int64_t b = blockIdx.x;
  const int g = (int)(b % m.G);
  const int t = (int)((b / m.G) % m.wpc);
  const int64_t o = b / ((int64_t)m.G * m.wpc);
  const int k = threadIdx.x;
  if (k < m.S) {
    const int j = g + m.G * k;
    G1 r;
    if (j >= m.M) {
      set_identity(r);  // reduce_sum's padding to a power of two
    } else if (m.chord) {
      uint32_t x1[L], y1[L], x2[L], y2[L];
      const bool i1 = lane_point(m, o, t, j, x1, y1);
      const bool i2 = lane_point(m, o, t, j + m.M, x2, y2);
      g1_add_affine(r, x1, y1, i1, x2, y2, i2);
    } else if (lane_point(m, o, t, j, r.x, r.y)) {
      set_identity(r);
    } else {
      set_one<Fp>(r.z);
    }
    sts_point(pts + k * PS, r);
  }
  __syncthreads();
  tree_sum(pts, 1, m.S, W);
  if (threadIdx.x < PW) m.partials[b * PW + threadIdx.x] = pts[threadIdx.x];
}

// Launch 2: block b takes output points b opb .. b opb + opb - 1: the G
// partials of each window by halving, then Horner over the wpc window sums,
// one team an output point.
__global__ void __launch_bounds__(THREADS) fixed_base_msm_horner_kernel(Msm m, int opb) {
  extern __shared__ uint32_t smem[];
  const int G = m.G, wpc = m.wpc;
  const int64_t o0 = (int64_t)blockIdx.x * opb;
  const int nvalid = m.n_out - o0 < opb ? (int)(m.n_out - o0) : opb;
  uint32_t* pts = smem;                       // [opb, wpc, G] points
  uint32_t* W = pts + opb * wpc * G * PS;     // TEAMS scratch areas
  uint32_t* acc_all = W + TEAMS * TEAM_W;     // opb accumulators
  for (int i = threadIdx.x; i < nvalid * wpc * G * PW; i += blockDim.x)
    pts[(i / PW) * PS + i % PW] = m.partials[o0 * wpc * G * PW + i];
  __syncthreads();
  if (G > 1) tree_sum(pts, nvalid * wpc, G, W);
  const int team = threadIdx.x / TEAM, rank = threadIdx.x % TEAM;
  if (team >= nvalid) return;
  const unsigned mask = prefix_mask(nvalid * TEAM);
  uint32_t* acc = acc_all + team * PS;
  uint32_t* Wt = W + team * TEAM_W;
  const uint32_t* ws = pts + team * wpc * G * PS;  // window t's sum at ws + t G PS
  for (int w = rank; w < PW; w += TEAM) acc[w] = ws[(wpc - 1) * G * PS + w];
  __syncwarp(mask);
  for (int t = wpc - 2; t >= 0; --t) {
    for (int i = 0; i < m.window; ++i) team_double(acc, acc, Wt, rank, mask);
    team_add(acc, acc, ws + t * G * PS, Wt, rank, mask);
  }
  const int64_t o = o0 + team;
  for (int w = rank; w < PW; w += TEAM) {
    uint32_t* dst = w < L ? m.rx : (w < 2 * L ? m.ry : m.rz);
    dst[(int64_t)(w % L) * m.n_out + o] = acc[w];
  }
}

}  // namespace

// scalars: [8, n_out * P] Montgomery Fr (output point o = lead * n_inst +
// instance takes scalars o P .. o P + P - 1); tx, ty: [12, n_inst, K, D]
// (K = chains P, D = 2^(window - 1)); base_inf: [n_inst, K] bytes;
// partials: n_out * wpc * G * 36 words of scratch; rx, ry, rz: [12, n_out].
// chord, M, G, S: ops/kernels.py::fixed_base_split(K). Returns
// cudaErrorInvalidValue, and launches nothing, unless S and G are powers of
// two, S at most THREADS and S G at least M: the block's shared points and
// both halving sums need that.
extern "C" int kzg_fixed_base_msm(const void* scalars, const void* tx, const void* ty,
                                  const void* base_inf, void* partials, void* rx, void* ry,
                                  void* rz, long long n_out, long long n_inst, int P, int chains,
                                  int wpc, int n_win, int window, int chord, int M, int G, int S,
                                  void* stream) {
  const auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (!pow2(S) || !pow2(G) || S > THREADS || (long long)S * G < M || M < 1)
    return (int)cudaErrorInvalidValue;
  Msm m;
  m.scalars = (const uint32_t*)scalars;
  m.tx = (const uint32_t*)tx;
  m.ty = (const uint32_t*)ty;
  m.base_inf = (const uint8_t*)base_inf;
  m.partials = (uint32_t*)partials;
  m.rx = (uint32_t*)rx;
  m.ry = (uint32_t*)ry;
  m.rz = (uint32_t*)rz;
  m.n_out = n_out;
  m.n_inst = n_inst;
  m.P = P;
  m.wpc = wpc;
  m.n_win = n_win;
  m.window = window;
  m.K = chains * P;
  m.chord = chord;
  m.M = M;
  m.G = G;
  m.S = S;
  cudaStream_t st = (cudaStream_t)stream;
  fixed_base_msm_windows_kernel<<<(unsigned)(n_out * wpc * G), THREADS, 0, st>>>(m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int opb = G == 1 ? TEAMS : 1;
  const size_t smem = sizeof(uint32_t) * ((size_t)opb * wpc * G * PS + TEAMS * TEAM_W + (size_t)opb * PS);
  err = cudaFuncSetAttribute(fixed_base_msm_horner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fixed_base_msm_horner_kernel<<<(unsigned)((n_out + opb - 1) / opb), THREADS, smem, st>>>(m, opb);
  return (int)cudaGetLastError();
}
