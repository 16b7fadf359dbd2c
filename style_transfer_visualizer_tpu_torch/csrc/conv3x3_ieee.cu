// 3x3 SAME convolution + bias + optional ReLU on NHWC float32 in IEEE
// fp32 on the CUDA cores: the `highest` precision tier (the forward of
// the first two VGG blocks at `mixed`). The `high` and `default` tiers
// run conv3x3.cu on the tensor cores.
//
// Replaces, at lax.Precision.HIGHEST, the Pallas TPU kernel
// `_conv_kernel` (with its driver `_run_conv`) of
// style_transfer_visualizer_tpu/ops/pallas_conv.py. As conv3x3.cu, it
// serves the forward conv and the frozen-backbone input gradient: the
// wrapper launches it on the output gradient with the flipped stencil,
// no bias, no ReLU and, when the forward fused its ReLU, the forward's
// output as a mask (the gradient counts only where out > 0).
//
// What it computes, for x (N,H,W,Cin), w9 (9,Cin,Cout), b (Cout):
//   out[p, o] = act(b[o] + sum_{tap, c} x[p + shift(tap), c] * w9[tap, c, o])
// with zeros outside the image (SAME padding): one fp32 FMA per product,
// in the order tap, then c, for every output. So each output's sum does
// not depend on where its pixel lies or on the batch: a batch of images
// gets each image's output alone, bit for bit, with no split over K.
// It reads the unsplit fp32 stencil w9, (9*Cin, Cout) row-major.
//
// Design: an implicit GEMM, M = N*H*W pixels, N = Cout, K = 9*Cin. One
// block of 256 threads computes a 128-pixel x 64-channel output tile and
// keeps it in registers, 8 x 4 fp32 accumulators per thread. The K loop
// walks the 9 taps and, within each, Cin in chunks of 8; each chunk of
// the shifted (and masked) input tile and of the stencil is staged in
// shared memory (two buffers, so the next chunk's global loads overlap
// the current chunk's products, one barrier per chunk). SAME padding
// comes from bounds checks on the shifted pixel. The epilogue adds the
// bias and applies the ReLU before the one write of the output.
//
// Bound on the H100 SXM: 2*9*Cin*Cout flops per pixel at the 67 TFLOP/s
// of fp32 FMA outside the tensor cores, far above the bytes except for
// conv 0 (Cin = 3) and its backward (Cout = 3). The register tile is
// what keeps it from being bound by shared memory: each thread reads 12
// values from shared memory for 32 FMAs.
#include "tf32x3.cuh"

namespace {

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 8;         // input channels per stage
constexpr int kTM = 8;         // pixels per thread
constexpr int kTN = 4;         // channels per thread
constexpr int kThreads = 256;  // (kBM / kTM) * (kBN / kTN)

__global__ void __launch_bounds__(kThreads)
conv3x3_ieee_kernel(const float* __restrict__ x,
                    const float* __restrict__ mask,
                    const float* __restrict__ w9,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int n, int h, int w, int cin, int cout, int relu,
                    unsigned long long* launches) {
  __shared__ __align__(16) float a_s[2][kBK][kBM];
  __shared__ __align__(16) float b_s[2][kBK][kBN];
  tf32x3::count_launch(launches);

  const int tid = threadIdx.x;
  const long long hw = static_cast<long long>(h) * w;
  const long long m_total = hw * n;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // Global-load roles: A (shifted input) - one pixel, 4 channels;
  // B (stencil) - one input channel, 2 output channels.
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
    const long long pix = (static_cast<long long>(a_img) * h + iy) * w + ix;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + a_k + j;
      a_reg[j] = 0.f;
      if (ok && c < cin) {
        const long long idx = pix * cin + c;
        a_reg[j] = x[idx];
        if (mask != nullptr && !(mask[idx] > 0.f)) a_reg[j] = 0.f;
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

// Launch on `stream`; returns 0 or a cudaError_t. `bias` and `mask` may
// be null; each run adds one to `*launches`.
extern "C" int conv3x3_ieee_forward(const float* x, const float* mask,
                                    const float* w9, const float* bias,
                                    float* out, int n, int h, int w, int cin,
                                    int cout, int relu,
                                    unsigned long long* launches, int device,
                                    void* stream) {
  // The calling thread (autograd's, for the backward) may have another
  // current device.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long m = static_cast<long long>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  conv3x3_ieee_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, mask, w9, bias, out, n, h, w, cin, cout, relu, launches);
  return static_cast<int>(cudaGetLastError());
}
