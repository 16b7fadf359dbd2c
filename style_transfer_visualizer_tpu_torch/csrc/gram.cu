// Raw Gram matrix F^T F of a (P, C) float32 block, plus the clamped and
// normalized G = min(raw, clamp) / n, for Hopper.
//
// Replaces the Pallas TPU kernel `_gram_accumulate_kernel` (with its
// driver `_raw_gram`) of style_transfer_visualizer_tpu/ops/pallas_gram.py.
// On the TPU the grid walks the 512-row pixel tiles in order and carries
// the C x C sum in VMEM scratch from one step to the next. Blocks on a
// GPU run in parallel and in no order, so the sum over P is split
// instead, deterministically and without float atomics:
//
//   stage 1 (gram_partial_kernel): a grid of (T(T+1)/2, S) blocks for
//     T = C/64 tiles a side; block (t, s) takes the t-th tile pair
//     (i <= j) of the upper triangle, sums F[p, i-tile]^T F[p, j-tile]
//     over the s-th contiguous range of pixel rows into a 64 x 64
//     register tile (4 x 4 per thread) and writes it to workspace[s]
//     (S, C, C). G is symmetric, so the tiles below the diagonal are
//     never computed;
//   stage 2 (gram_reduce_kernel): each element sums its S partials in
//     fixed order, reading the mirrored element below the diagonal
//     tiles, writes raw, and fuses the clamp and the scale into the
//     write of G. The wrapper keeps raw for the backward's mask.
//
// Bound on the H100 SXM: the symmetric product needs P*C*(C+1) flops
// against 4*P*C bytes read, so at the VGG widths (C = 64..512) the
// kernel is bound by fp32 operations (67 TFLOP/s outside the tensor
// cores): the five Grams of a 512x512 step are about 4.6 GFLOP, about
// 0.07 ms. The split over P keeps all 132 SMs busy even at C = 64,
// where there is one tile pair; 16 pixel rows of both operand tiles are
// staged in shared memory per stage, so each thread reads 8 values from
// shared memory per 16 fused multiply-adds.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;         // output tile edge
constexpr int kBK = 16;        // pixel rows per stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ f, float* __restrict__ ws,
                    long long p, int c, long long rows_per_split) {
  __shared__ __align__(16) float a_s[kBK][kT];
  __shared__ __align__(16) float b_s[kBK][kT];

  const int tid = threadIdx.x;
  // Tile pair number blockIdx.x -> (bi, bj) with bi <= bj, row by row.
  const int tiles = (c + kT - 1) / kT;
  int bi = 0;
  int rem = static_cast<int>(blockIdx.x);
  while (rem >= tiles - bi) {
    rem -= tiles - bi;
    ++bi;
  }
  const int i0 = bi * kT;
  const int j0 = (bi + rem) * kT;
  const long long p_begin =
      static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long p_end =
      p_begin + rows_per_split < p ? p_begin + rows_per_split : p;

  const int lr = tid >> 4;        // staged row 0..15
  const int lc = (tid & 15) * 4;  // staged column 0..60
  const int ti = tid >> 4;
  const int tj = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }

  for (long long p0 = p_begin; p0 < p_end; p0 += kBK) {
    const long long r = p0 + lr;
    const bool row_ok = r < p_end;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = i0 + lc + j;
      const int cj = j0 + lc + j;
      a_s[lr][lc + j] = (row_ok && ci < c) ? f[r * c + ci] : 0.f;
      b_s[lr][lc + j] = (row_ok && cj < c) ? f[r * c + cj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ti * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tj * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
      }
    }
    __syncthreads();
  }

  float* dst = ws + static_cast<long long>(blockIdx.y) * c * c;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = i0 + ti * 4 + x;
    if (i >= c) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int j = j0 + tj * 4 + y;
      if (j < c) dst[static_cast<long long>(i) * c + j] = acc[x][y];
    }
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ ws,
                                   float* __restrict__ raw,
                                   float* __restrict__ g, int c, int splits,
                                   float clamp, float norm) {
  const long long cc = static_cast<long long>(c) * c;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= cc) return;
  // Stage 1 wrote only the tiles on and above the diagonal.
  const int i = static_cast<int>(idx / c);
  const int j = static_cast<int>(idx % c);
  const long long src = i / kT <= j / kT
                            ? idx
                            : static_cast<long long>(j) * c + i;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += ws[k * cc + src];
  raw[idx] = s;
  g[idx] = fminf(s, clamp) / norm;
}

}  // namespace

// Launch both stages on `stream` (two kernel launches); returns
// cudaGetLastError() (0 on success). `ws` holds `splits` * c * c
// floats; the split ranges are `rows_per_split` rows long and must
// cover all p rows.
extern "C" int gram_forward(const float* f, float* ws, float* raw, float* g,
                            long long p, int c, int splits,
                            long long rows_per_split, float clamp,
                            float norm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>((c + kT - 1) / kT);
  const dim3 grid(tiles * (tiles + 1) / 2, static_cast<unsigned>(splits));
  gram_partial_kernel<<<grid, kThreads, 0, s>>>(f, ws, p, c, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cc = static_cast<long long>(c) * c;
  const unsigned blocks = static_cast<unsigned>((cc + 255) / 256);
  gram_reduce_kernel<<<blocks, 256, 0, s>>>(ws, raw, g, c, splits, clamp,
                                            norm);
  return static_cast<int>(cudaGetLastError());
}
