// 3x3 SAME convolution + bias + optional ReLU on NHWC float32, for Hopper.
//
// Replaces the Pallas TPU kernel `_conv_kernel` (with its driver
// `_run_conv`) of style_transfer_visualizer_tpu/ops/pallas_conv.py. The
// same kernel serves the forward conv and the frozen-backbone input
// gradient: the wrapper launches it on the ReLU-masked gradient with
// the flipped stencil, no bias and no ReLU.
//
// What it computes, for x (N,H,W,Cin), w9 (9,Cin,Cout), b (Cout):
//   out[p, o] = act(b[o] + sum_{tap, c} x[p + shift(tap), c] * w9[tap, c, o])
// with zeros outside the image (SAME padding) and act = ReLU or identity.
//
// Design: an implicit GEMM, M = N*H*W pixels, N = Cout, K = 9*Cin. One
// block of 256 threads computes a 128-pixel x 64-channel output tile and
// keeps it in registers, 8 x 4 fp32 accumulators per thread. The K loop
// walks the 9 taps and, within each, Cin in chunks of 8; each chunk of
// the shifted input tile and of the stencil is staged in shared memory
// (two buffers, so the next chunk's global loads overlap the current
// chunk's products, one barrier per chunk). SAME padding comes from
// bounds checks on the shifted pixel: no padded copy of the image is
// made. The epilogue adds the bias and applies the ReLU before the one
// write of the output.
//
// Bound on the H100 SXM: the VGG convs do 2*9*Cin*Cout flops per pixel,
// far more than their bytes (every input read once, every output
// written once), so this fp32 kernel is bound by operations: at 512x512
// the 13 convs up to layer 28 are 189.3 GFLOP, about 2.8 ms at the
// 67 TFLOP/s of fp32 outside the tensor cores. The register tile is
// what makes it operation-bound rather than shared-memory-bound: each
// thread reads 12 values from shared memory for 32 fused multiply-adds.
// Tensor cores (wgmma with TMA loads) are the next step and would move
// the bound to 495 TFLOP/s (TF32).
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 8;        // input channels per stage
constexpr int kTM = 8;        // pixels per thread
constexpr int kTN = 4;        // channels per thread
constexpr int kThreads = 256; // (kBM / kTM) * (kBN / kTN)

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w9,
               const float* __restrict__ bias, float* __restrict__ out,
               int n, int h, int w, int cin, int cout, int relu) {
  __shared__ __align__(16) float a_s[2][kBK][kBM];
  __shared__ __align__(16) float b_s[2][kBK][kBN];

  const int tid = threadIdx.x;
  const long long hw = static_cast<long long>(h) * w;
  const long long m_total = hw * n;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // Global-load roles: A (shifted input) — one pixel, 4 channels;
  // B (stencil) — one input channel, 2 output channels.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const long long a_pix = m0 + a_row;
  const bool a_pix_ok = a_pix < m_total;
  int a_img = 0;
  int a_y = 0;
  int a_x = 0;
  if (a_pix_ok) {
    a_img = static_cast<int>(a_pix / hw);
    const long long rem = a_pix - static_cast<long long>(a_img) * hw;
    a_y = static_cast<int>(rem / w);
    a_x = static_cast<int>(rem - static_cast<long long>(a_y) * w);
  }
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 2;

  // Compute role: 8 consecutive pixels x 4 consecutive channels.
  const int tm = tid >> 4;
  const int tn = tid & 15;

  const int kchunks = (cin + kBK - 1) / kBK;
  const int steps = 9 * kchunks;

  float a_reg[4];
  float b_reg[2];

  auto load_global = [&](int step) {
    const int tap = step / kchunks;
    const int c0 = (step - tap * kchunks) * kBK;
    const int iy = a_y + tap / 3 - 1;
    const int ix = a_x + tap % 3 - 1;
    const bool ok = a_pix_ok && iy >= 0 && iy < h && ix >= 0 && ix < w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + a_k + j;
      a_reg[j] = 0.f;
      if (ok && c < cin) {
        const long long pix =
            (static_cast<long long>(a_img) * h + iy) * w + ix;
        a_reg[j] = x[pix * cin + c];
      }
    }
    const int kc = c0 + b_k;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + b_n + j;
      b_reg[j] = 0.f;
      if (kc < cin && o < cout) {
        b_reg[j] = w9[(static_cast<long long>(tap) * cin + kc) * cout + o];
      }
    }
  };
  auto store_shared = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a_s[buf][a_k + j][a_row] = a_reg[j];
#pragma unroll
    for (int j = 0; j < 2; ++j) b_s[buf][b_k][b_n + j] = b_reg[j];
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  load_global(0);
  store_shared(0);
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const bool more = step + 1 < steps;
    if (more) load_global(step + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&a_s[cur][kk][tm * kTM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[cur][kk][tm * kTM + 4]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&b_s[cur][kk][tn * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) store_shared(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long pix = m0 + tm * kTM + i;
    if (pix >= m_total) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int o = n0 + tn * kTN + j;
      if (o >= cout) continue;
      float v = acc[i][j] + (bias != nullptr ? bias[o] : 0.f);
      if (relu) v = fmaxf(v, 0.f);
      out[pix * cout + o] = v;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). `bias`
// may be null (the backward pass).
extern "C" int conv3x3_forward(const float* x, const float* w9,
                               const float* bias, float* out, int n, int h,
                               int w, int cin, int cout, int relu,
                               void* stream) {
  const long long m = static_cast<long long>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  conv3x3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w9, bias, out, n, h, w, cin, cout, relu);
  return static_cast<int>(cudaGetLastError());
}
