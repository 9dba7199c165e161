// The whole G1 FFT in one launch: every stage of the decimation-in-time
// transform of ops/ntt.py::Domain._dit_g1 over every row of the batch, with
// each twiddle multiplication w^pos t run as the GLV ladder of
// ops/curve.py::scalar_mul_glv.
//
// Replaces, on every G1 transform, rust_eth_kzg_tpu/ops/ntt.py::Domain._dit_g1
// (:232) with rust_eth_kzg_tpu/ops/curve.py::scalar_mul_glv (:368), i.e. the
// per-step launches of rust_eth_kzg_tpu/ops/pallas_kernels.py::g1_add (:163)
// and ::g1_double (:176) that those run on. g1_add.cu and g1_double.cu stay
// for their other callers.
//
// Bound on this card: the dependent chain, not throughput. A 128-point row
// is 6 ladder stages of 64 ladders; each ladder is a table of 16 points
// {a P1 + b P2} and 65 steps of (2 doublings + 1 addition), every step
// depending on the one before. One thread per ladder would run 32 dependent
// Montgomery products a step.
//
// Design:
// - A team of 8 threads runs one ladder, its state in shared memory (the
//   16-entry table, the accumulator, the RCB temporaries). In each product
//   round every active thread computes one mont_mul<Fp> on operands in
//   shared memory and writes the product back; __syncwarp separates rounds.
//   The RCB formulas are wide: addition is 2 rounds of 6 independent
//   products, doubling 2 rounds of 4, once the products by the curve
//   constant 3b = 12 are done as 4 modular additions (every value is fully
//   reduced, so 12 x by additions equals mont_mul(x, 12 R) limb for limb).
//   A ladder step is 6 product rounds instead of 32 dependent products.
//   The team's addition and doubling live in g1_team.cuh, shared with
//   fixed_base_msm.cu.
// - One thread-block cluster runs one row. At n = 128 the cluster is 8
//   blocks of 8 teams (64 threads); each block holds 16 of the row's points
//   in shared memory. From the stage whose butterfly span reaches past a
//   block's slice, a team reads and writes its pair's points in the other
//   blocks' shared memory (cluster.map_shared_rank); cluster.sync()
//   separates the stages. n < 16 uses a cluster of one block.
// - The bit reversal is folded into the first load; the output is written
//   in natural order. Stage 0 (twiddle 1) is a plain add and subtract.
// Every value is fully reduced and the formulas are the plain route's, so
// the output equals the plain route (curve.scalar_mul_glv over the per-op
// formulas) limb for limb.
#include <cooperative_groups.h>

#include "g1_team.cuh"

namespace cg = cooperative_groups;
using namespace kzg;

namespace {

constexpr int NDIG = 65;            // joint GLV digits, MSB first
constexpr int PT = 3 * L;           // words per point (x, y, z)
constexpr int MAX_CLUSTER = 8;      // portable cluster size
constexpr int POINTS_PER_BLOCK = 16;

// A team's scratch in shared memory, in 32-bit words.
constexpr int TAB = 0;              // 16 points: entry 4 a + b = a P1 + b P2
constexpr int ACC = TAB + 16 * PT;  // ladder accumulator
constexpr int PA = ACC + PT;        // butterfly input a
constexpr int PTW = PA + PT;        // butterfly input t
constexpr int PNEG = PTW + PT;      // -(w^pos t)
constexpr int P1 = PNEG + PT;       // P1, 2 P1, 3 P1 while the table is built
constexpr int P1_2 = P1 + PT;
constexpr int P1_3 = P1_2 + PT;
constexpr int WRK = P1_3 + PT;      // 12 elements: products (0-5), linear values (6-11)
constexpr int DIG = WRK + 12 * L;   // 65 digits and the two signs, as bytes
constexpr int TEAM_WORDS = DIG + (NDIG + 2 + 3) / 4;

// ACC = k PTW for the team's scalar k, given as its joint digits and signs in
// DIG (curve.scalar_mul_glv, step for step).
__device__ void team_glv(uint32_t* S, int rank, unsigned mask) {
  uint32_t* W = S + WRK;
  const uint8_t* dig = reinterpret_cast<const uint8_t*>(S + DIG);
  // P1 = +-t, table entry 1 = P2 = +-phi(t) = (beta x, +-y, z), entry 0 = identity
  if (rank < 6) {
    const int c = rank % 3;
    uint32_t v[L];
    lds(v, S + PTW + c * L);
    if (rank < 3) {
      if (c == 1 && dig[NDIG]) fp_neg(v, v);
      sts(S + P1 + c * L, v);
    } else {
      if (c == 0) {
        uint32_t beta[L];
#pragma unroll
        for (int j = 0; j < L; ++j) beta[j] = FP_BETA[j];
        fp_mul(v, v, beta);
      } else if (c == 1 && dig[NDIG + 1]) {
        fp_neg(v, v);
      }
      sts(S + TAB + PT + c * L, v);
    }
  }
  __syncwarp(mask);
  team_identity(S + TAB, rank, mask);
  team_double(S + P1_2, S + P1, W, rank, mask);
  team_double(S + TAB + 2 * PT, S + TAB + PT, W, rank, mask);
  team_add(S + P1_3, S + P1_2, S + P1, W, rank, mask);
  team_add(S + TAB + 3 * PT, S + TAB + 2 * PT, S + TAB + PT, W, rank, mask);
  for (int a = 1; a < 4; ++a) {
    const uint32_t* pa = S + P1 + (a - 1) * PT;
    for (int b = 0; b < 4; ++b) team_add(S + TAB + (4 * a + b) * PT, S + TAB + b * PT, pa, W, rank, mask);
  }
  team_identity(S + ACC, rank, mask);
  for (int i = 0; i < NDIG; ++i) {
    team_double(S + ACC, S + ACC, W, rank, mask);
    team_double(S + ACC, S + ACC, W, rank, mask);
    team_add(S + ACC, S + ACC, S + TAB + dig[i] * PT, W, rank, mask);
  }
}

// One cluster per row; `cluster` blocks of n / cluster points; a team per
// butterfly pair of each stage.
__global__ void __launch_bounds__(4 * POINTS_PER_BLOCK * 4) g1_fft_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint8_t* __restrict__ digits,
    const uint8_t* __restrict__ neg1, const uint8_t* __restrict__ neg2,
    uint32_t* __restrict__ rx, uint32_t* __restrict__ ry, uint32_t* __restrict__ rz,
    int64_t rows, int log_n) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << log_n;
  const int half = n >> 1;
  const int nblk = (int)cluster.num_blocks();
  const int P = n / nblk;  // points per block
  const int c = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / nblk;
  const int64_t lanes = rows * n;
  const int team = threadIdx.x / TEAM;
  const int rank = threadIdx.x % TEAM;
  const unsigned wbase = threadIdx.x & ~31u;
  const unsigned live = min(32u, blockDim.x - wbase);
  const unsigned mask = live == 32 ? 0xffffffffu : ((1u << live) - 1u);
  uint32_t* pts = smem;
  uint32_t* S = smem + P * PT + team * TEAM_WORDS;

  // point l of block c is input column bitrev(c P + l)
  for (int w = threadIdx.x; w < P * PT; w += blockDim.x) {
    const int l = w / PT, k = w % PT;
    const int col = (int)(__brev((unsigned)(c * P + l)) >> (32 - log_n));
    const uint32_t* src = k < L ? px : (k < 2 * L ? py : pz);
    pts[w] = src[(int64_t)(k % L) * lanes + row * n + col];
  }
  cluster.sync();

  const int k = c * (P / 2) + team;  // this team's butterfly pair
  for (int s = 0; s < log_n; ++s) {
    const int h = 1 << s;
    const int j = k & (h - 1);
    const int i0 = ((k >> s) << (s + 1)) + j;
    const int i1 = i0 + h;
    uint32_t* a = cluster.map_shared_rank(pts, i0 / P) + (i0 % P) * PT;
    uint32_t* t = cluster.map_shared_rank(pts, i1 / P) + (i1 % P) * PT;
    for (int w = rank; w < PT; w += TEAM) {
      S[PA + w] = a[w];
      S[PTW + w] = t[w];
    }
    const uint32_t* wt = S + PTW;
    if (s > 0) {
      uint8_t* dig = reinterpret_cast<uint8_t*>(S + DIG);
      const uint8_t* src = digits + (int64_t)(s - 1) * NDIG * half + j;
      for (int i = rank; i < NDIG; i += TEAM) dig[i] = src[(int64_t)i * half];
      if (rank == 0) {
        dig[NDIG] = neg1[(s - 1) * half + j];
        dig[NDIG + 1] = neg2[(s - 1) * half + j];
      }
      __syncwarp(mask);
      team_glv(S, rank, mask);
      wt = S + ACC;
    }
    __syncwarp(mask);
    if (rank < 3) {
      uint32_t v[L];
      lds(v, wt + rank * L);
      if (rank == 1) fp_neg(v, v);
      sts(S + PNEG + rank * L, v);
    }
    __syncwarp(mask);
    team_add(a, S + PA, wt, S + WRK, rank, mask);
    team_add(t, S + PA, S + PNEG, S + WRK, rank, mask);
    cluster.sync();
  }

  for (int w = threadIdx.x; w < P * PT; w += blockDim.x) {
    const int l = w / PT, kk = w % PT;
    uint32_t* dst = kk < L ? rx : (kk < 2 * L ? ry : rz);
    dst[(int64_t)(kk % L) * lanes + row * n + c * P + l] = pts[w];
  }
}

}  // namespace

// Each coordinate: [12, rows, n] limb-major Montgomery Fp, n = 2^log_n,
// 2 <= n <= 512. digits: uint8 [log_n - 1, 65, n / 2]; neg1, neg2: uint8
// [log_n - 1, n / 2] (ops/ntt.py::Domain._stage_digits).
extern "C" int kzg_g1_fft(const void* px, const void* py, const void* pz, const void* digits,
                          const void* neg1, const void* neg2, void* rx, void* ry, void* rz,
                          long long rows, int log_n, void* stream) {
  const int n = 1 << log_n;
  const int nblk = n / POINTS_PER_BLOCK < 1 ? 1 : (n / POINTS_PER_BLOCK > MAX_CLUSTER ? MAX_CLUSTER : n / POINTS_PER_BLOCK);
  const int P = n / nblk;
  const size_t smem = sizeof(uint32_t) * ((size_t)P * PT + (size_t)(P / 2) * TEAM_WORDS);
  cudaError_t err = cudaFuncSetAttribute(g1_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * nblk));
  cfg.blockDim = dim3((unsigned)(4 * P));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, g1_fft_kernel, (const uint32_t*)px, (const uint32_t*)py,
                           (const uint32_t*)pz, (const uint8_t*)digits, (const uint8_t*)neg1,
                           (const uint8_t*)neg2, (uint32_t*)rx, (uint32_t*)ry, (uint32_t*)rz,
                           (int64_t)rows, log_n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
