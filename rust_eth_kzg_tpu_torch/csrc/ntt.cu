// A whole NTT over Fr in one call: every stage of the radix-2 transform of
// ops/ntt.py::Domain over every row of the batch, natural order in and out,
// with the per-point scales of ifft (1/n) and of the coset transforms (g^k
// on the input, (1/n) g^-k on the output) fused into its loads and stores.
//
// Replaces rust_eth_kzg_tpu/ops/pallas_kernels.py::field_butterfly (:243) as
// rust_eth_kzg_tpu/ops/ntt.py::Domain._dit composes it (one launch a stage,
// behind a bit-reversal gather), with the mont_mul (:365) launches of the
// 1/n and coset scales. csrc/field_butterfly.cu stays as the standalone port
// of one stage.
//
// Bound on this card: operations at the main path's sizes (n / 2 log n Fr
// products a row against 64 B a point moved), and, for a small transform,
// the launch: the staged route paid one launch a stage. A 4,096-point row is
// 24,576 products, about 51 us of one SM's multipliers, and an 8,192-point
// row 111 us, so one block a row would take longer at B = 1 than the staged
// launches spread over the card did; an 8,192-point row (256 KB) does not
// fit one block's shared memory either.
//
// Design:
// - A pass transforms lines of m <= 1,024 points, each inside one block's
//   shared memory: the line is loaded bit-reversed (the input scale
//   applied on the way in), log m decimation-in-time stages run between
//   __syncthreads, one butterfly a thread a stage, and the line is stored
//   in natural order (the output scale, or a twiddle, applied on the way
//   out). A block holds 512 points (1,024 for m = 1,024): 8 lines of 64, 4
//   of 128 or one of 512.
// - Up to 1,024 points a row is one pass: one launch.
// - Above, the four-step split n = n1 n2 (n1 = 64, up to n2 = 1,024): pass 1
//   transforms the n2 strided columns x[n2 j1 + j2] of length n1 and
//   multiplies output k1 of column j2 by w^(j2 k1); pass 2 transforms the n1
//   contiguous rows of length n2 and writes output k2 of row k1 to
//   k1 + n1 k2, i.e. transposed into natural order. 4,096 = 64 x 64 and
//   8,192 = 64 x 128 are two launches of 8 to 16 blocks a row.
// - Threads that neighbour in a block read and write neighbouring addresses
//   (along the line where its stride is 1, across lines where it is not).
// Every value is fully reduced, so the output equals the staged plain route
// (Domain._dit_plain) limb for limb.
#include "field.cuh"

using namespace kzg;

namespace {

constexpr int NL = Fr::N;
constexpr int MAX_LOG_LINE = 10;  // lines of up to 1,024 points
constexpr int BLOCK_POINTS = 512;  // points a block holds for lines up to 512

struct Pass {
  int log_n;           // the whole transform; roots[k] = w^k for k < n
  int log_m;           // the lines this pass transforms
  int log_lines_row;   // log of the lines in one row (n / m)
  int log_lines_block; // log of the lines in one block
  int64_t lines;       // lines over all rows
  // in a row, point i of line c is read at c col_in + i step_in, and output
  // k of line c is written at c col_out + k step_out
  int64_t col_in, step_in, col_out, step_out;
  int twiddle;         // output k of line c times w^(c k)
};

__device__ __forceinline__ int bitrev(int i, int bits) {
  return bits ? (int)(__brev((unsigned)i) >> (32 - bits)) : 0;
}

// point e of a block -> (line in the block, index in the line); the fast
// index follows the unit stride of global memory
__device__ __forceinline__ void split(int e, bool line_fast, const Pass& p, int& l, int& i) {
  if (line_fast) {
    l = e & ((1 << p.log_lines_block) - 1);
    i = e >> p.log_lines_block;
  } else {
    l = e >> p.log_m;
    i = e & ((1 << p.log_m) - 1);
  }
}

__global__ void __launch_bounds__(512) ntt_pass_kernel(const uint32_t* __restrict__ x,
                                                       uint32_t* __restrict__ y,
                                                       const uint32_t* __restrict__ roots,
                                                       const uint32_t* __restrict__ pre,
                                                       const uint32_t* __restrict__ post,
                                                       int64_t lanes, Pass p) {
  __shared__ uint32_t s[NL << MAX_LOG_LINE];  // limb j of block point e at s[j E + e]
  const int points = 1 << (p.log_lines_block + p.log_m);
  const int64_t n = (int64_t)1 << p.log_n;
  const int64_t line0 = (int64_t)blockIdx.x << p.log_lines_block;
  const int64_t row_mask = ((int64_t)1 << p.log_lines_row) - 1;
  uint32_t v[NL], w[NL];

  const bool fast_in = p.step_in != 1;
  for (int e = threadIdx.x; e < points; e += blockDim.x) {
    int l, i;
    split(e, fast_in, p, l, i);
    const int64_t line = line0 + l;
    if (line >= p.lines) continue;
    const int64_t off = (line & row_mask) * p.col_in + i * p.step_in;
    load<NL>(v, x, (line >> p.log_lines_row) * n + off, lanes);
    if (pre) {
      load<NL>(w, pre, off, n);
      mont_mul<Fr>(v, v, w);
    }
    const int at = (l << p.log_m) + bitrev(i, p.log_m);
#pragma unroll
    for (int j = 0; j < NL; ++j) s[j * points + at] = v[j];
  }
  __syncthreads();

  const int half_m = (1 << p.log_m) >> 1;
  for (int st = 0; st < p.log_m; ++st) {
    const int h = 1 << st;
    for (int b = threadIdx.x; b < points / 2; b += blockDim.x) {
      const int l = b / half_m;
      const int jj = b - l * half_m;
      const int pos = jj & (h - 1);
      const int ia = (l << p.log_m) + ((jj >> st) << (st + 1)) + pos;
      const int ib = ia + h;
      uint32_t a[NL], t[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        a[j] = s[j * points + ia];
        v[j] = s[j * points + ib];
      }
      load<NL>(w, roots, (int64_t)pos << (p.log_n - 1 - st), n);
      mont_mul<Fr>(v, v, w);
      add<Fr>(t, a, v);
      sub<Fr>(a, a, v);
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        s[j * points + ia] = t[j];
        s[j * points + ib] = a[j];
      }
    }
    __syncthreads();
  }

  const bool fast_out = p.step_out != 1;
  for (int e = threadIdx.x; e < points; e += blockDim.x) {
    int l, k;
    split(e, fast_out, p, l, k);
    const int64_t line = line0 + l;
    if (line >= p.lines) continue;
    const int64_t c = line & row_mask;
    const int at = (l << p.log_m) + k;
#pragma unroll
    for (int j = 0; j < NL; ++j) v[j] = s[j * points + at];
    if (p.twiddle) {
      load<NL>(w, roots, c * k, n);
      mont_mul<Fr>(v, v, w);
    }
    const int64_t off = c * p.col_out + k * p.step_out;
    if (post) {
      load<NL>(w, post, off, n);
      mont_mul<Fr>(v, v, w);
    }
    store<NL>(y, v, (line >> p.log_lines_row) * n + off, lanes);
  }
}

int launch(const Pass& p, const uint32_t* x, uint32_t* y, const uint32_t* roots,
           const uint32_t* pre, const uint32_t* post, int64_t lanes, cudaStream_t s) {
  const int points = 1 << (p.log_lines_block + p.log_m);
  const int threads = points / 2 < 32 ? 32 : points / 2;
  const int64_t blocks = (p.lines + (1 << p.log_lines_block) - 1) >> p.log_lines_block;
  ntt_pass_kernel<<<(unsigned)blocks, threads, 0, s>>>(x, y, roots, pre, post, lanes, p);
  return (int)cudaGetLastError();
}

Pass make_pass(int log_n, int log_m, int64_t rows) {
  Pass p{};
  p.log_n = log_n;
  p.log_m = log_m;
  p.log_lines_row = log_n - log_m;
  const int log_points = log_m > 9 ? log_m : 9;  // BLOCK_POINTS = 2^9
  p.log_lines_block = log_points - log_m;
  p.lines = rows << p.log_lines_row;
  return p;
}

}  // namespace

// x, y, scratch: [8, rows, 2^log_n] Montgomery Fr, limb-major; roots: [8, n]
// with roots[k] = w^k; pre, post: [8, n] or null. log_n1 = 0: one pass (n up
// to 1,024); else the four-step split with n1 = 2^log_n1 and n2 = n / n1,
// both at most 1,024, through scratch. Returns cudaGetLastError().
extern "C" int kzg_ntt(const void* x, void* y, void* scratch, const void* roots, const void* pre,
                       const void* post, long long rows, int log_n, int log_n1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int log_n2 = log_n - log_n1;
  if (rows < 0 || log_n < 0 || log_n1 < 0 || log_n2 < 0 || log_n1 > MAX_LOG_LINE || log_n2 > MAX_LOG_LINE ||
      (log_n1 > 0 && (log_n2 == 0 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)rows << log_n;
  const uint32_t* in = (const uint32_t*)x;
  uint32_t* out = (uint32_t*)y;
  const uint32_t* w = (const uint32_t*)roots;
  if (log_n1 == 0) {
    Pass p = make_pass(log_n, log_n, rows);
    p.step_in = p.step_out = 1;
    return launch(p, in, out, w, (const uint32_t*)pre, (const uint32_t*)post, lanes, s);
  }
  const int64_t n1 = (int64_t)1 << log_n1, n2 = (int64_t)1 << log_n2;
  uint32_t* mid = (uint32_t*)scratch;
  Pass p1 = make_pass(log_n, log_n1, rows);  // the n2 columns of length n1
  p1.col_in = p1.col_out = 1;
  p1.step_in = p1.step_out = n2;
  p1.twiddle = 1;
  int rc = launch(p1, in, mid, w, (const uint32_t*)pre, nullptr, lanes, s);
  if (rc != 0) return rc;
  Pass p2 = make_pass(log_n, log_n2, rows);  // the n1 rows of length n2, written transposed
  p2.col_in = n2;
  p2.step_in = 1;
  p2.col_out = 1;
  p2.step_out = n1;
  return launch(p2, mid, out, w, nullptr, (const uint32_t*)post, lanes, s);
}
