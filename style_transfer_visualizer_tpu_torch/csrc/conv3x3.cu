// 3x3 SAME convolution + bias + optional ReLU on NHWC float32, on
// Hopper's tensor cores in 3xTF32 (see tf32x3.cuh): the `high` precision
// tier. The `default` tier's TF32 conv is conv3x3_tf32.cu, the
// `highest` tier's IEEE fp32 conv conv3x3_ieee.cu.
//
// Replaces the Pallas TPU kernel `_conv_kernel` (with its driver
// `_run_conv`) of style_transfer_visualizer_tpu/ops/pallas_conv.py. The
// same kernel serves the forward conv and the frozen-backbone input
// gradient: the wrapper launches it on the output gradient with the
// flipped stencil, no bias, no ReLU and, when the forward fused its
// ReLU, the forward's output as a mask (A is zeroed where out <= 0).
//
// What it computes, for x (N,H,W,Cin) and the packed stencil B
// (Cout, Kp), B[o, tap*Cin + c] = w9[tap, c, o], zero for
// k >= 9*Cin up to Kp (a multiple of 32):
//   out[p, o] = act(b[o] + sum_{tap, c} x[p + shift(tap), c] * B[o, k])
// with zeros outside the image (SAME padding). The wrapper packs B once
// per layer, split into tf32 hi and lo halves (models/vgg19.py).
//
// Design: an implicit GEMM, M = pixels, N = Cout, K = Kp. An output
// tile is 128 pixels (a rows x cols rectangle of one image; cols = 128
// at W >= 128) by BN channels; persistent blocks walk the tiles.
//   - A comes in slabs of 32 input channels. When Cin % 32 == 0 a slab
//     is the halo'd tile: one TMA box (1, rows+2, cols+2, 32) of x at
//     (y0-1, x0-1), zero-filled outside the image (negative coordinates
//     included, so SAME padding is free), which serves all nine taps:
//     tap (dy, dx) reads pixel row (r+dy)(cols+2) + c+dx of it. The
//     mask, when there is one, comes as the same box. The nine taps of
//     a slab are nine K steps of 32. Loading the halo once instead of a
//     box per tap cuts A's traffic from L2 about threefold (the halo
//     tile keeps its 128-byte rows, so the swizzle holds at any tap's
//     row offset). Otherwise (Cin = 3 of the first layer, odd test widths)
//     the producer warpgroup gathers each K step's 128 x 32 slab with
//     plain loads (masking, zero-padding K): one K step per slab.
//   - B comes per K step: two 32 x BN TMA boxes, hi and lo.
//   - two rings of shared-memory slots guarded by mbarriers, one for A
//     slabs and one for B steps. One producer thread issues the TMA
//     loads; two consumer warpgroups (threads 0..255), 64 pixel rows
//     each, read their A fragments from the slab, mask them, split them
//     into tf32 hi/lo in registers and issue per k8 slice the three
//     wgmma m64nBNk8 of 3xTF32 against B hi/lo in the slot (K-major,
//     128-byte swizzle). Each K step's products go to a fresh tile
//     that is added to the running sum in registers (tf32x3.cuh).
//   - when the tiles cannot fill the SMs, K is split over blocks by
//     slabs; each block writes its partial tile and the last to finish
//     a tile sums the partials in fixed order (no float atomics).
// Slots are 1024-byte aligned: the swizzle's period. The epilogue adds
// the bias and applies the ReLU in registers, then writes each output
// once.
//
// Bound on the H100 SXM: 2*9*Cin*Cout flops per pixel, far above the
// bytes, so the VGG convs are bound by operations; 3xTF32 issues three
// tf32 products, 495/3 = 165 TFLOP/s effective. Conv 0's forward (Cin
// = 3) and backward (Cout = 3) are bound by bytes. What holds the
// kernel back from that bound is each consumer warpgroup's work
// between its K steps' products (barrier waits, fragment loads and
// splits, the wait for the products, the promotion): the tensor cores
// idle while both warpgroups do it.
#define TF32X3_HOST
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBM = 128;             // output pixels per block
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kSmemLimit = 232448;  // a block's dynamic shared memory
// Registers per thread after setmaxnreg: 128 * 64 + 256 * 216 of the
// SM's 64K.
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs = 216;

struct ConvArgs {
  const float* x;     // gathered path only
  const float* mask;  // gathered path only; null when unmasked
  const float* bias;  // null in the backward
  float* out;
  int n, h, w, cin, cout;
  int rows, cols, tiles_y, tiles_x, ch_tiles, tiles;
  int halo;           // A slabs by TMA with a halo (Cin % 32 == 0)
  int slabs, taps;    // A slabs per tile, K steps per slab (9 or 1)
  int a_stages, b_stages, a_slot_bytes;
  int relu, has_mask;
  // Split K: work item w is tile w / splits and A slabs
  // [q * split_slabs, (q + 1) * split_slabs) for q = w % splits. With
  // splits > 1 each item writes its partial tile to ws (one per item)
  // and takes a ticket from its tile's counter; the last to arrive sums
  // the tile's partials in split order and runs the epilogue.
  int splits, split_slabs;
  float* ws;
  int* counters;
  unsigned long long* launches;  // count_launch's counter
};

struct Work {
  int tile, c0, c1;  // output tile, A slab range
};

__device__ __forceinline__ Work work_at(const ConvArgs& args, int w) {
  const int q = w % args.splits;
  const int c0 = q * args.split_slabs;
  return {w / args.splits, c0, min(args.slabs, c0 + args.split_slabs)};
}

// Output tile `t`: channel tile fastest, so the blocks working at one
// time share their input pixels in L2.
struct Tile {
  int img, y0, x0, n0;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(const ConvArgs& args, int t) {
  const int ch = t % args.ch_tiles;
  t /= args.ch_tiles;
  const int tx = t % args.tiles_x;
  t /= args.tiles_x;
  const int ty = t % args.tiles_y;
  return {t / args.tiles_y, ty * args.rows, tx * args.cols, ch * BN};
}

// The shared-memory plan: A slots, B slots, then the four barrier
// arrays and the split-K ticket. A B slot holds the hi box and the lo
// box after it.
template <int BN>
struct Smem {
  uint8_t* a;
  uint8_t* b;
  uint64_t* a_full;
  uint64_t* a_empty;
  uint64_t* b_full;
  uint64_t* b_empty;
  int* flag;
  int a_slot;  // bytes of an A slot (slab, then the mask's slab)
  static constexpr int kBBytes = BN * kRowFloats * 4;  // hi (or lo) box
  static constexpr int kBSlot = 2 * kBBytes;

  __device__ Smem(uint8_t* base, const ConvArgs& args)
      : a(base),
        b(base + args.a_stages * args.a_slot_bytes),
        a_full(reinterpret_cast<uint64_t*>(b + args.b_stages * kBSlot)),
        a_empty(a_full + args.a_stages),
        b_full(a_empty + args.a_stages),
        b_empty(b_full + args.b_stages),
        flag(reinterpret_cast<int*>(b_empty + args.b_stages)),
        a_slot(args.a_slot_bytes) {}

  __device__ float* slab(int slot) const {
    return reinterpret_cast<float*>(a + slot * a_slot);
  }
  __device__ uint8_t* b_hi(int slot) const { return b + slot * kBSlot; }
  __device__ uint8_t* b_lo(int slot) const { return b_hi(slot) + kBBytes; }
};

// Pixel rows of an A slab: (cols + 2) * (rows + 2) with a halo, 128
// (one K step's gathered slab) without. Mask slab right after, aligned.
__device__ __forceinline__ int slab_rows(const ConvArgs& args) {
  return args.halo ? (args.cols + 2) * (args.rows + 2) : kBM;
}

// Gather the A slab of K step `k0` for tile `tl` with the producer
// warpgroup's 128 threads: element (pixel m, k), masked, zero outside
// the image and beyond 9*Cin. Loads go out in batches of 4.
__device__ __forceinline__ void gather_a(const ConvArgs& args, const Tile& tl,
                                         int k0, float* a, int pt) {
  constexpr int kBatch = 4;
  const int k_real = 9 * args.cin;
  for (int i0 = pt; i0 < kBM * kRowFloats; i0 += 128 * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 128 * u;
      const int m = i / kRowFloats;
      const int k = k0 + i % kRowFloats;
      const int tap = k / args.cin;
      const int c = k - tap * args.cin;
      const int y = tl.y0 + m / args.cols + tap / 3 - 1;
      const int x = tl.x0 + m % args.cols + tap % 3 - 1;
      v[u] = 0.f;
      if (k < k_real && y >= 0 && y < args.h && x >= 0 && x < args.w) {
        const long long idx =
            ((static_cast<long long>(tl.img) * args.h + y) * args.w + x) *
                args.cin + c;
        v[u] = args.x[idx];
        if (args.has_mask && !(args.mask[idx] > 0.f)) v[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 128 * u;
      a[swz(i / kRowFloats, i % kRowFloats)] = v[u];
    }
  }
}

template <int BN>
__device__ __forceinline__ void consume(const ConvArgs& args,
                                        const Smem<BN>& sm);

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_m,
                      const __grid_constant__ CUtensorMap map_bhi,
                      const __grid_constant__ CUtensorMap map_blo,
                      const ConvArgs args) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // Offset from the array itself (not via an integer address) so that
  // the compiler keeps the accesses as shared-memory loads and stores.
  const Smem<BN> sm(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023), args);
  const int tid = threadIdx.x;
  count_launch(args.launches);
  if (tid == 0) {
    for (int s = 0; s < args.a_stages; ++s) {
      bar_init(&sm.a_full[s], args.halo ? 1 : 128);
      bar_init(&sm.a_empty[s], kConsumers);
    }
    for (int s = 0; s < args.b_stages; ++s) {
      bar_init(&sm.b_full[s], 1);
      bar_init(&sm.b_empty[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tid < kConsumers) {
    consume<BN>(args, sm);
    return;
  }
  // ---- producer warpgroup; its registers go to the consumers. The
  // rings run on across the block's work items, so the next tile's
  // loads overlap this tile's last products and its epilogue.
  regs_down<kProducerRegs>();
  const int pt = tid - kConsumers;
  if (args.halo && pt != 0) return;
  const bool mask_slab = args.halo && args.has_mask;
  const int slab_bytes = slab_rows(args) * kRowFloats * 4;
  const int mask_off = args.a_slot_bytes / (mask_slab ? 2 : 1);
  int ca = 0;  // A slabs issued
  int cb = 0;  // B steps issued
  for (int w = blockIdx.x; w < args.tiles * args.splits; w += gridDim.x) {
    const Work wk = work_at(args, w);
    const Tile tl = tile_at<BN>(args, wk.tile);
    for (int c = wk.c0; c < wk.c1; ++c, ++ca) {
      const int slot = ca % args.a_stages;
      const int round = ca / args.a_stages;
      if (round > 0) bar_wait(&sm.a_empty[slot], (round - 1) & 1);
      float* slab = sm.slab(slot);
      if (args.halo) {
        bar_arrive_tx(&sm.a_full[slot],
                      static_cast<uint32_t>(slab_bytes * (mask_slab ? 2 : 1)));
        tma_4d(slab, &map_x, &sm.a_full[slot], c * kRowFloats, tl.x0 - 1,
               tl.y0 - 1, tl.img);
        if (mask_slab) {
          tma_4d(reinterpret_cast<uint8_t*>(slab) + mask_off, &map_m,
                 &sm.a_full[slot], c * kRowFloats, tl.x0 - 1, tl.y0 - 1,
                 tl.img);
        }
      } else {
        gather_a(args, tl, c * kRowFloats, slab, pt);
        bar_arrive(&sm.a_full[slot]);
        if (pt != 0) continue;
      }
      for (int tap = 0; tap < args.taps; ++tap, ++cb) {
        const int bslot = cb % args.b_stages;
        const int bround = cb / args.b_stages;
        if (bround > 0) bar_wait(&sm.b_empty[bslot], (bround - 1) & 1);
        const int k0 =
            args.halo ? tap * args.cin + c * kRowFloats : c * kRowFloats;
        bar_arrive_tx(&sm.b_full[bslot], Smem<BN>::kBSlot);
        tma_2d(sm.b_hi(bslot), &map_bhi, &sm.b_full[bslot], k0, tl.n0);
        tma_2d(sm.b_lo(bslot), &map_blo, &sm.b_full[bslot], k0, tl.n0);
      }
    }
  }
}

// Split K: write this item's partial tile, take a ticket, and if this
// is the tile's last item, replace `acc` by the sum of the tile's
// partials in split order (whatever order they arrived in). Returns
// whether the caller runs the epilogue.
template <int BN>
__device__ __forceinline__ bool sum_splits(const ConvArgs& args, int w,
                                           int tile, float (&acc)[BN / 2],
                                           int row0, int row1, int tig,
                                           int* flag) {
  constexpr int kTile = kBM * BN;
  float* mine = args.ws + static_cast<long long>(w) * kTile;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(mine + row0 * BN + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(mine + row1 * BN + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __threadfence();
  named_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    *flag = atomicAdd(&args.counters[tile], 1) == args.splits - 1;
    if (*flag) args.counters[tile] = 0;
  }
  named_sync(1, kConsumers);
  if (!*flag) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const float* first =
      args.ws + static_cast<long long>(tile) * args.splits * kTile;
  for (int q = 0; q < args.splits; ++q) {
    const float* src = first + static_cast<long long>(q) * kTile;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      const float2 a =
          __ldcg(reinterpret_cast<const float2*>(src + row0 * BN + col));
      const float2 b =
          __ldcg(reinterpret_cast<const float2*>(src + row1 * BN + col));
      acc[4 * j] += a.x;
      acc[4 * j + 1] += a.y;
      acc[4 * j + 2] += b.x;
      acc[4 * j + 3] += b.y;
    }
  }
  return true;
}

// The consumer warpgroups' part of conv3x3_tc_kernel: per work item,
// the K loop on the tensor cores, then the epilogue.
template <int BN>
__device__ __forceinline__ void consume(const ConvArgs& args,
                                        const Smem<BN>& sm) {
  regs_up<kConsumerRegs>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
  const int row1 = row0 + 8;
  // Slab rows of this thread's two pixels at tap (0, 0); tap (dy, dx)
  // adds dy * (cols + 2) + dx.
  const int pitch = args.cols + 2;
  const int base0 =
      args.halo ? (row0 / args.cols) * pitch + row0 % args.cols : row0;
  const int base1 =
      args.halo ? (row1 / args.cols) * pitch + row1 % args.cols : row1;
  const bool mask_slab = args.halo && args.has_mask;
  const int mask_floats = args.a_slot_bytes / 8;  // half a slot, in floats
  const bool pairs = (args.cout & 1) == 0;
  float acc[BN / 2];
  float part[BN / 2];
  int ca = 0;
  int cb = 0;
  for (int w = blockIdx.x; w < args.tiles * args.splits; w += gridDim.x) {
    const Work wk = work_at(args, w);
    const Tile tl = tile_at<BN>(args, wk.tile);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int c = wk.c0; c < wk.c1; ++c, ++ca) {
      const int slot = ca % args.a_stages;
      bar_wait(&sm.a_full[slot], (ca / args.a_stages) & 1);
      const float* a = sm.slab(slot);
      const float* msk = a + mask_floats;
      for (int tap = 0; tap < args.taps; ++tap, ++cb) {
        const int bslot = cb % args.b_stages;
        bar_wait(&sm.b_full[bslot], (cb / args.b_stages) & 1);
        const int shift = args.halo ? (tap / 3) * pitch + tap % 3 : 0;
        const int r0 = base0 + shift;
        const int r1 = base1 + shift;
        uint32_t hi[4][4];
        uint32_t lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = kk * 8 + tig;
          const int off[4] = {swz(r0, k), swz(r1, k), swz(r0, k + 4),
                              swz(r1, k + 4)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = a[off[e]];
            if (mask_slab && !(msk[off[e]] > 0.f)) v = 0.f;
            split(v, hi[kk][e], lo[kk][e]);
          }
        }
        const uint64_t dhi = desc_k_major(sm.b_hi(bslot));
        const uint64_t dlo = desc_k_major(sm.b_lo(bslot));
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma3<BN>(part, hi[kk], lo[kk], dhi + 2 * kk, dlo + 2 * kk,
                   kk == 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(part);
        bar_arrive(&sm.b_empty[bslot]);
        promote(acc, part);
      }
      bar_arrive(&sm.a_empty[slot]);
    }

    if (args.splits > 1 && !sum_splits<BN>(args, w, wk.tile, acc, row0,
                                            row1, tig, sm.flag)) {
      continue;
    }

    // ---- epilogue: bias, ReLU, one write of each output
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = half ? row1 : row0;
      const int y = tl.y0 + m / args.cols;
      const int x = tl.x0 + m % args.cols;
      if (y >= args.h || x >= args.w) continue;
      float* dst = args.out +
                   ((static_cast<long long>(tl.img) * args.h + y) * args.w +
                    x) * args.cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = tl.n0 + 8 * j + 2 * tig;
        if (o >= args.cout) continue;
        float v0 = acc[4 * j + 2 * half];
        float v1 = acc[4 * j + 2 * half + 1];
        const bool two = o + 1 < args.cout;
        if (args.bias != nullptr) {
          v0 += args.bias[o];
          if (two) v1 += args.bias[o + 1];
        }
        if (args.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (two && pairs) {
          *reinterpret_cast<float2*>(dst + o) = make_float2(v0, v1);
        } else {
          dst[o] = v0;
          if (two) dst[o + 1] = v1;
        }
      }
    }
  }
}

template <int BN>
int launch(const CUtensorMap& mx, const CUtensorMap& mm,
           const CUtensorMap& mbhi, const CUtensorMap& mblo,
           const ConvArgs& args, int blocks, int smem_bytes,
           cudaStream_t stream) {
  // The opt-in to the most dynamic shared memory is made once per
  // instantiation.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv3x3_tc_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  conv3x3_tc_kernel<BN><<<blocks, kThreads, smem_bytes, stream>>>(
      mx, mm, mbhi, mblo, args);
  return static_cast<int>(cudaGetLastError());
}

int launch_bn(int bn, const CUtensorMap& mx, const CUtensorMap& mm,
              const CUtensorMap& mbhi, const CUtensorMap& mblo,
              const ConvArgs& args, int blocks, int smem_bytes,
              cudaStream_t stream) {
  switch (bn) {
    case 8:
      return launch<8>(mx, mm, mbhi, mblo, args, blocks, smem_bytes,
                       stream);
    case 64:
      return launch<64>(mx, mm, mbhi, mblo, args, blocks, smem_bytes,
                        stream);
    case 128:
      return launch<128>(mx, mm, mbhi, mblo, args, blocks, smem_bytes,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream` in 3xTF32; returns 0, a cudaError_t, or
// tf32x3::kTensorMapError + a driver code. The plan (bn, rows, cols,
// halo, slabs, taps, ring sizes, splits, blocks, smem_bytes) comes from
// ops/conv3x3.py's conv_plan; `blocks` persistent blocks walk the work
// items. With splits > 1, `ws` holds a 128 x bn partial tile per item
// and `counters` one zeroed int per output tile (left zeroed). `bias`
// and `mask` may be null. Each run adds one to `*launches`.
extern "C" int conv3x3_forward(const float* x, const float* mask,
                               const float* b_hi, const float* b_lo,
                               const float* bias, float* out, int n, int h,
                               int w, int cin, int cout, int k_pad, int relu,
                               int bn, int rows, int cols, int halo,
                               int slabs, int taps, int a_stages,
                               int b_stages, int a_slot_bytes, int splits,
                               int split_slabs, int blocks, int smem_bytes,
                               float* ws, int* counters,
                               unsigned long long* launches, int device,
                               void* stream) {
  // The calling thread (autograd's, for the backward) may have no
  // current context yet; the tensor-map encoder needs one.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles_y = (h + rows - 1) / rows;
  const int tiles_x = (w + cols - 1) / cols;
  const int ch_tiles = (cout + bn - 1) / bn;
  ConvArgs args{x,        mask,     bias,         out,        n,
                h,        w,        cin,          cout,       rows,
                cols,     tiles_y,  tiles_x,      ch_tiles,
                n * tiles_y * tiles_x * ch_tiles, halo,       slabs,
                taps,     a_stages, b_stages,     a_slot_bytes, relu,
                mask != nullptr,    splits,       split_slabs, ws,
                counters, launches};
  CUtensorMap mx{}, mm{}, mbhi{}, mblo{};
  int rc = 0;
  if (halo) {
    const cuuint64_t dims[4] = {
        static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w),
        static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(cin) * 4,
        static_cast<cuuint64_t>(w) * cin * 4,
        static_cast<cuuint64_t>(h) * w * cin * 4};
    const cuuint32_t box[4] = {kRowFloats, static_cast<cuuint32_t>(cols + 2),
                               static_cast<cuuint32_t>(rows + 2), 1};
    rc = make_map(&mx, x, 4, dims, strides, box);
    if (rc == 0 && mask != nullptr) {
      rc = make_map(&mm, mask, 4, dims, strides, box);
    }
  }
  const cuuint64_t bdims[2] = {static_cast<cuuint64_t>(k_pad),
                               static_cast<cuuint64_t>(cout)};
  const cuuint64_t bstrides[1] = {static_cast<cuuint64_t>(k_pad) * 4};
  const cuuint32_t bbox[2] = {kRowFloats, static_cast<cuuint32_t>(bn)};
  if (rc == 0) rc = make_map(&mbhi, b_hi, 2, bdims, bstrides, bbox);
  if (rc == 0) rc = make_map(&mblo, b_lo, 2, bdims, bstrides, bbox);
  if (rc != 0) return rc;
  return launch_bn(bn, mx, mm, mbhi, mblo, args, blocks, smem_bytes,
                   static_cast<cudaStream_t>(stream));
}
