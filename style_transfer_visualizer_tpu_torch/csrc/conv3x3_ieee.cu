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
// with zeros outside the image (SAME padding): one fp32 FMA per product.
// Every output's sum runs in one fixed order: K chunks of 4 * quads
// input channels; within a chunk its channel quads; within a quad the
// tap column dx, then the tap row dy, then the quad's 4 channels. The
// order depends on neither the pixel nor the batch, and a split over K
// is planned per image (as if N = 1) and its partials summed in split
// order: a batch of images gets each image's output alone, bit for bit.
//
// Bound on the H100 SXM: 2*9*Cin*Cout flops per pixel at the 67 TFLOP/s
// of fp32 FMA on the CUDA cores, far above the bytes except for conv 0
// (Cin = 3) and its input gradient (Cout = 3), which are bound by bytes.
// To come near it the CUDA cores must issue an FFMA almost every cycle:
// each thread keeps an 8 x 8 tile of accumulators (8 pixels of one
// column by 8 channels) and reads, for 12 K steps of 64 FMAs each, 10
// float4 of A (a column of 10 slab pixels, 4 channels, serving the
// three tap rows) and 24 float4 of B from shared memory.
//
// Design: an implicit GEMM, M = pixels, N = Cout, K = 9*Cin. A block
// computes a rows x cols rectangle of one image (BM pixels) by BN output
// channels; the launch plan (ops/conv3x3.py, ieee_plan) picks the tile,
// the chunk, the ring depth and the split over K per shape:
//   - BN = 128 (256 threads, BM = 128), BN = 64 (256 threads, BM = 256),
//     and a narrow BN = 8 for Cout <= 8 (128 threads, BM = 1024).
//   - A comes as a halo'd slab: for a chunk of input channels (8, two
//     quads; one quad of 4 for Cin <= 4, so Cin = 3 runs 36 K steps of
//     which 27 are real) the (rows+2) x (cols+2) box of x at
//     (y0-1, x0-1), zero outside the image and beyond Cin, loaded once
//     with cp.async (16-byte copies; 4-byte ones when Cin % 4 != 0) and
//     used by all nine taps: tap (dy, dx) reads slab pixel
//     (r+dy)(cols+2) + c+dx. The slab is laid out
//     [channel quad][pixel][4], so a thread reads 4 channels of a pixel
//     as one float4 at any tap's offset, and a warp's neighbouring
//     pixels fall in neighbouring banks. With a mask, the mask's slab is
//     loaded beside it and each thread zeroes the elements it copied
//     once they land, before the chunk's barrier.
//   - B, the chunk's stencil rows (9 taps x 8 channel slots x BN, zero
//     beyond Cin or Cout), is loaded beside A with 16-byte cp.async
//     (4-byte when Cout % 4 != 0).
//   - a ring of `stages` chunks in shared memory, cp.async groups, one
//     barrier per chunk (72 K steps): the loads of chunk i + stages - 1
//     are issued before chunk i's products.
//   - when one image's tiles cannot fill the SMs (the 32x32 layers at
//     512x512), K is split over blocks by chunks; each block writes its
//     partial tile and the last to finish a tile sums the partials in
//     split order (no float atomics), then runs the epilogue.
// The epilogue adds the bias and applies the ReLU in registers, then
// writes each output once.
#include "tf32x3.cuh"

namespace {

using tf32x3::count_launch;
using tf32x3::smem_u32;

constexpr int kBK = 8;              // channel slots of a chunk
constexpr int kTM = 8;              // pixels per thread
constexpr int kTN = 8;              // output channels per thread
constexpr int kSmemLimit = 232448;  // a block's dynamic shared memory

struct IeeeArgs {
  const float* x;
  const float* mask;  // null when unmasked
  const float* w9;    // (9 * Cin, Cout) row-major
  const float* bias;  // null in the backward
  float* out;
  int n, h, w, cin, cout, relu;
  int rows, cols, tiles_y, tiles_x, ch_tiles;
  int quads;      // channel quads of a chunk: 2, or 1 when Cin <= 4
  int chunks;     // K chunks of a tile
  int slab_px;    // pixels of one channel quad of an A slab (padded)
  int stages;     // ring depth
  int stage_floats, mask_off, b_off;  // a stage's size and offsets
  int vec_a;      // A by 16-byte copies (Cin % 4 == 0, aligned)
  int vec_b;      // B by 16-byte copies (Cout % 4 == 0, aligned)
  // Split K: block b works on tile b / splits and K chunks
  // [q * split_chunks, (q + 1) * split_chunks) for q = b % splits.
  int splits, split_chunks;
  float* ws;      // splits > 1: a partial tile per block
  int* counters;  // splits > 1: one zeroed int per tile
  unsigned long long* launches;
};

// ---- cp.async: `ok` false zero-fills the destination (src not read).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// This thread's copies of the chunk `stages - 1` groups back (the ring
// holds 2 or 3 stages) have landed.
__device__ __forceinline__ void wait_chunk(int stages) {
  if (stages == 2) {
    cp_wait<0>();
  } else {
    cp_wait<1>();
  }
}

struct Tile {
  int img, y0, x0, n0;
};

// Output tile `t`: channel tile fastest, so the blocks working at one
// time share their input pixels in L2.
__device__ __forceinline__ Tile tile_at(const IeeeArgs& a, int t, int bn) {
  const int ch = t % a.ch_tiles;
  t /= a.ch_tiles;
  const int tx = t % a.tiles_x;
  t /= a.tiles_x;
  const int ty = t % a.tiles_y;
  return {t / a.tiles_y, ty * a.rows, tx * a.cols, ch * bn};
}

// Global index of slab pixel p of tile `tl`, or -1 outside the image.
__device__ __forceinline__ long long slab_pixel(const IeeeArgs& a,
                                                const Tile& tl, int p) {
  const int pitch = a.cols + 2;
  const int y = tl.y0 - 1 + p / pitch;
  const int x = tl.x0 - 1 + p % pitch;
  if (y < 0 || y >= a.h || x < 0 || x >= a.w) return -1;
  return (static_cast<long long>(tl.img) * a.h + y) * a.w + x;
}

// Issue the copies of K chunk `ch` of tile `tl` into stage `st`:
//   A at st[0 ..): [quads][slab_px][4]; the mask's slab at
//   st[mask_off ..), the same layout; B at st[b_off ..): [9 * 8][BN],
//   row tap * 8 + k for the chunk's channel slot k.
// A copy's element e is the thread's own: mask_chunk reads it back.
template <int BN, int THREADS>
__device__ __forceinline__ void load_chunk(const IeeeArgs& a, const Tile& tl,
                                           int ch, float* st) {
  const int tid = threadIdx.x;
  const bool masked = a.mask != nullptr;
  const int c0 = ch * 4 * a.quads;
  const int px = (a.rows + 2) * (a.cols + 2);
  if (a.vec_a) {
    // Element e: slab pixel e / quads, channel quad e % quads (a
    // pixel's chunk by neighbouring threads).
    for (int e = tid; e < a.quads * px; e += THREADS) {
      const int p = a.quads == 2 ? e >> 1 : e;
      const int q = a.quads == 2 ? e & 1 : 0;
      const long long pix = slab_pixel(a, tl, p);
      const bool ok = pix >= 0 && c0 + 4 * q < a.cin;
      const long long off = ok ? pix * a.cin + c0 + 4 * q : 0;
      const int dst = (q * a.slab_px + p) * 4;
      cp16(st + dst, a.x + off, ok);
      if (masked) cp16(st + a.mask_off + dst, a.mask + off, ok);
    }
  } else {
    // Element e: slab pixel e / (4 quads), channel slot e % (4 quads).
    const int slots = 4 * a.quads;
    for (int e = tid; e < slots * px; e += THREADS) {
      const int p = e / slots;
      const int k = e - p * slots;
      const long long pix = slab_pixel(a, tl, p);
      const bool ok = pix >= 0 && c0 + k < a.cin;
      const long long off = ok ? pix * a.cin + c0 + k : 0;
      const int dst = ((k >> 2) * a.slab_px + p) * 4 + (k & 3);
      cp4(st + dst, a.x + off, ok);
      if (masked) cp4(st + a.mask_off + dst, a.mask + off, ok);
    }
  }
  // B: row r = tap * 8 + k is w9 row tap * Cin + c0 + k, zero beyond
  // Cin, Cout or the chunk's 4 * quads slots (those rows are not read).
  float* bs = st + a.b_off;
  const int slots = 4 * a.quads;
  if (a.vec_b) {
    constexpr int kQ = BN / 4;
    for (int e = tid; e < 9 * kBK * kQ; e += THREADS) {
      const int r = e / kQ;
      const int o4 = e % kQ;
      const int k = r % kBK;
      const int o = tl.n0 + 4 * o4;
      const bool ok = k < slots && c0 + k < a.cin && o < a.cout;
      const long long off =
          ok ? static_cast<long long>((r / kBK) * a.cin + c0 + k) * a.cout +
                   o
             : 0;
      cp16(bs + r * BN + 4 * o4, a.w9 + off, ok);
    }
  } else {
    for (int e = tid; e < 9 * kBK * BN; e += THREADS) {
      const int r = e / BN;
      const int k = r % kBK;
      const int o = tl.n0 + e % BN;
      const bool ok = k < slots && c0 + k < a.cin && o < a.cout;
      const long long off =
          ok ? static_cast<long long>((r / kBK) * a.cin + c0 + k) * a.cout +
                   o
             : 0;
      cp4(bs + e, a.w9 + off, ok);
    }
  }
}

// Zero this thread's own copies of A where the mask is not > 0 (the
// elements load_chunk gave it, which its wait has seen land).
template <int THREADS>
__device__ __forceinline__ void mask_chunk(const IeeeArgs& a, float* st) {
  const int tid = threadIdx.x;
  const float* ms = st + a.mask_off;
  const int px = (a.rows + 2) * (a.cols + 2);
  if (a.vec_a) {
    for (int e = tid; e < a.quads * px; e += THREADS) {
      const int p = a.quads == 2 ? e >> 1 : e;
      const int q = a.quads == 2 ? e & 1 : 0;
      const int dst = (q * a.slab_px + p) * 4;
      float4 v = *reinterpret_cast<const float4*>(st + dst);
      const float4 m = *reinterpret_cast<const float4*>(ms + dst);
      if (!(m.x > 0.f)) v.x = 0.f;
      if (!(m.y > 0.f)) v.y = 0.f;
      if (!(m.z > 0.f)) v.z = 0.f;
      if (!(m.w > 0.f)) v.w = 0.f;
      *reinterpret_cast<float4*>(st + dst) = v;
    }
  } else {
    const int slots = 4 * a.quads;
    for (int e = tid; e < slots * px; e += THREADS) {
      const int p = e / slots;
      const int k = e - p * slots;
      const int dst = ((k >> 2) * a.slab_px + p) * 4 + (k & 3);
      if (!(ms[dst] > 0.f)) st[dst] = 0.f;
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The chunk's products. This thread's pixels are 8 neighbouring rows
// of one column, so tap (dy, dx) reads slab rows r0 + dy .. r0 + dy + 7
// of column c + dx. For each channel quad and tap column dx, the 10
// slab pixels of rows r0 .. r0 + 9 are read once (10 float4, 4
// channels each) and serve the three tap rows dy: K runs quad, dx, dy,
// then the quad's 4 channels.
template <int BN>
__device__ __forceinline__ void compute_chunk(const IeeeArgs& a,
                                              const float* st, int pos0,
                                              int tn,
                                              float (&acc)[kTM][kTN]) {
  const float4* as = reinterpret_cast<const float4*>(st);
  const float4* bs = reinterpret_cast<const float4*>(st + a.b_off);
  const int pitch = a.cols + 2;
  // The narrow tile (one warp an SM sub-partition) runs faster with the
  // dx loop rolled; the wide tiles with it unrolled (measured).
  constexpr int kDxUnroll = BN == 8 ? 1 : 3;
#pragma unroll 1
  for (int q = 0; q < a.quads; ++q) {
#pragma unroll kDxUnroll
    for (int dx = 0; dx < 3; ++dx) {
      float4 av[kTM + 2];
      const float4* col = as + q * a.slab_px + pos0 + dx;
#pragma unroll
      for (int i = 0; i < kTM + 2; ++i) av[i] = col[i * pitch];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4* brow =
              bs + ((dy * 3 + dx) * kBK + q * 4 + cc) * (BN / 4);
          const float4 b0 = brow[tn];
          const float4 b1 = brow[BN / 8 + tn];
          const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float ai = lane_of(av[i + dy], cc);
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
            }
          }
        }
      }
    }
  }
}

// Split K: write this block's partial tile, take a ticket, and if this
// is the tile's last block, replace `acc` by the sum of the tile's
// partials in split order. Returns whether the caller runs the epilogue.
template <int THREADS>
__device__ __forceinline__ bool sum_splits(const IeeeArgs& a, int tile,
                                           float (&acc)[kTM][kTN],
                                           int* flag) {
  const int tid = threadIdx.x;
  float* mine = a.ws + static_cast<long long>(blockIdx.x) * kTM * kTN *
                           THREADS;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      mine[(i * kTN + j) * THREADS + tid] = acc[i][j];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *flag = atomicAdd(&a.counters[tile], 1) == a.splits - 1;
    if (*flag) a.counters[tile] = 0;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
  const float* first = a.ws + static_cast<long long>(tile) * a.splits *
                                  kTM * kTN * THREADS;
  for (int q = 0; q < a.splits; ++q) {
    const float* src =
        first + static_cast<long long>(q) * kTM * kTN * THREADS;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc[i][j] += __ldcg(src + (i * kTN + j) * THREADS + tid);
      }
    }
  }
  return true;
}

// BN output channels by BM = THREADS * 64 / BN pixels a block. Thread
// (tm, tn) holds the pixels of column c = tm % cols, rows r0 + i with
// r0 = 8 * (tm / cols) (i < 8; rows is a multiple of 8), and channels
// 4 tn + j, BN / 2 + 4 tn + j (j < 4); a warp is 32 / LN pixel
// columns by LN channel groups, so its A loads read neighbouring
// pixels and its B loads one 128-byte row.
template <int BN, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_ieee_kernel(const IeeeArgs a) {
  constexpr int kTns = BN / kTN;
  constexpr int kLn = kTns < 8 ? kTns : 8;
  constexpr int kLm = 32 / kLn;
  constexpr int kWm = (THREADS / 32) / (kTns / kLn);
  static_assert(kWm * kLm * kTM * BN == THREADS * kTM * kTN, "thread tile");

  extern __shared__ __align__(128) float smem[];
  count_launch(a.launches);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tm = (warp % kWm) * kLm + lane / kLn;
  const int tn = (warp / kWm) * kLn + lane % kLn;

  const int tile = blockIdx.x / a.splits;
  const int k0 = (blockIdx.x % a.splits) * a.split_chunks;
  const int nk = min(a.chunks, k0 + a.split_chunks) - k0;
  const Tile tl = tile_at(a, tile, BN);

  const int c = tm % a.cols;
  const int r0 = kTM * (tm / a.cols);
  // Slab pixel of this thread's first pixel (at tap (0, 0)).
  const int pos0 = r0 * (a.cols + 2) + c;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  for (int s = 0; s < a.stages - 1; ++s) {
    if (s < nk) {
      load_chunk<BN, THREADS>(a, tl, k0 + s, smem + s * a.stage_floats);
    }
    cp_commit();
  }
  for (int it = 0; it < nk; ++it) {
    wait_chunk(a.stages);
    float* st = smem + (it % a.stages) * a.stage_floats;
    if (a.mask != nullptr) mask_chunk<THREADS>(a, st);
    // Every thread's copies of chunk `it` have landed (and are masked),
    // and every thread is done with chunk it - 1, whose slot refills.
    __syncthreads();
    const int next = it + a.stages - 1;
    if (next < nk) {
      load_chunk<BN, THREADS>(a, tl, k0 + next,
                              smem + (next % a.stages) * a.stage_floats);
    }
    cp_commit();
    compute_chunk<BN>(a, st, pos0, tn, acc);
  }

  if (a.splits > 1 &&
      !sum_splits<THREADS>(
          a, tile, acc,
          reinterpret_cast<int*>(smem + a.stages * a.stage_floats))) {
    return;
  }

  // ---- epilogue: bias, ReLU, one write of each output
  const bool vec_out = (a.cout & 3) == 0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int y = tl.y0 + r0 + i;
    const int x = tl.x0 + c;
    if (y >= a.h || x >= a.w) continue;
    float* dst = a.out +
                 ((static_cast<long long>(tl.img) * a.h + y) * a.w + x) *
                     a.cout;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o0 = tl.n0 + half * (BN / 2) + 4 * tn;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + j;
        v[j] = acc[i][half * 4 + j];
        if (a.bias != nullptr && o < a.cout) v[j] += a.bias[o];
        if (a.relu) v[j] = fmaxf(v[j], 0.f);
      }
      if (vec_out && o0 < a.cout) {
        *reinterpret_cast<float4*>(dst + o0) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (o0 + j < a.cout) dst[o0 + j] = v[j];
        }
      }
    }
  }
}

template <int BN, int THREADS>
int launch(const IeeeArgs& args, int blocks, int smem_bytes,
           cudaStream_t stream) {
  // The opt-in to the most dynamic shared memory is made once per
  // instantiation.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv3x3_ieee_kernel<BN, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  conv3x3_ieee_kernel<BN, THREADS>
      <<<blocks, THREADS, smem_bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// Launch on `stream`; returns 0 or a cudaError_t. The plan (bn, threads,
// rows x cols, quads, chunks, slab_px, stages and the stage layout,
// splits, blocks, smem_bytes) comes from ops/conv3x3.py's ieee_plan.
// With splits > 1, `ws` holds a partial tile per block and `counters`
// one zeroed int per output tile (left zeroed). `bias` and `mask` may
// be null. Each run adds one to `*launches`. A plan this file has no
// kernel for, or whose parts do not fit, is refused.
extern "C" int conv3x3_ieee_forward(
    const float* x, const float* mask, const float* w9, const float* bias,
    float* out, int n, int h, int w, int cin, int cout, int relu, int bn,
    int threads, int rows, int cols, int quads, int chunks, int slab_px,
    int stages, int stage_floats, int mask_off, int b_off, int splits,
    int split_chunks, int blocks, int smem_bytes, float* ws, int* counters,
    unsigned long long* launches, int device, void* stream) {
  // The calling thread (autograd's, for the backward) may have another
  // current device.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int bm = threads * kTM * kTN / bn;
  const int tiles_y = (h + rows - 1) / rows;
  const int tiles_x = (w + cols - 1) / cols;
  const int ch_tiles = (cout + bn - 1) / bn;
  const long long grid =
      static_cast<long long>(n) * tiles_y * tiles_x * ch_tiles * splits;
  const int a_floats = 4 * quads * slab_px;
  const bool bad =
      rows * cols != bm || rows % kTM != 0 || grid != blocks ||
      stages < 2 || stages > 3 || quads < 1 || quads > kBK / 4 ||
      chunks * 4 * quads < cin || slab_px < (rows + 2) * (cols + 2) ||
      b_off < (mask != nullptr ? mask_off + a_floats : a_floats) ||
      (mask != nullptr && mask_off < a_floats) ||
      stage_floats < b_off + 9 * kBK * bn ||
      smem_bytes < stages * stage_floats * 4 + 16 ||
      smem_bytes > kSmemLimit ||
      (splits > 1 && (ws == nullptr || counters == nullptr));
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_a = cin % 4 == 0 && aligned16(x) &&
                     (mask == nullptr || aligned16(mask));
  const IeeeArgs args{x,       mask,     w9,           bias,     out,
                      n,       h,        w,            cin,      cout,
                      relu,    rows,     cols,         tiles_y,  tiles_x,
                      ch_tiles, quads,   chunks,       slab_px,  stages,
                      stage_floats, mask_off, b_off,   vec_a ? 1 : 0,
                      (cout % 4 == 0) && aligned16(w9) ? 1 : 0,
                      splits,  split_chunks, ws,       counters, launches};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128 && threads == 256) {
    return launch<128, 256>(args, blocks, smem_bytes, s);
  }
  if (bn == 64 && threads == 256) {
    return launch<64, 256>(args, blocks, smem_bytes, s);
  }
  if (bn == 8 && threads == 128) {
    return launch<8, 128>(args, blocks, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
