// 3x3 SAME convolution + bias + optional ReLU on NHWC float32 in TF32 on
// Hopper's tensor cores: the `default` precision tier. Each product is
// tf32(x) * tf32(w) (both rounded to nearest, ties away, as cvt.rna),
// summed in fp32 (see tf32x3.cuh). The `high` tier's 3xTF32 conv is
// conv3x3.cu, the `highest` tier's IEEE fp32 conv conv3x3_ieee.cu.
//
// Replaces the Pallas TPU kernel `_conv_kernel` (with its driver
// `_run_conv`) of style_transfer_visualizer_tpu/ops/pallas_conv.py, as
// conv3x3.cu does: the forward conv, and the frozen-backbone input
// gradient (the output gradient, the flipped stencil, no bias or ReLU,
// masked where the forward's output is <= 0). The stencil is the packed
// K-major hi half (models/vgg19.pack_stencil): B[o, tap*Cin + c] =
// tf32(w9[tap, c, o]), zero up to Kp.
//
// Bound on the H100 SXM: 2*9*Cin*Cout flops a pixel at 495 TFLOP/s, so
// the VGG convs are bound by operations; conv 0's forward (Cin = 3) and
// backward (Cout = 3) by bytes. A design for one product a K step:
//   - implicit GEMM, M = pixels, N = Cout, K = Kp. An output tile is
//     BM = 128 * WM pixels (a rows x cols rectangle of one image) by BN
//     channels; two consumer warpgroups own WM 64-pixel sub-tiles each.
//     At WM = 2 each 16 KB B box (32 x 128) serves 256 pixels, which
//     halves B's bytes from L2 a flop against a 128-pixel tile.
//   - products stay in flight: the whole K range of a work item sums
//     in the wgmma accumulator; each K step's wgmma group is committed
//     and the warpgroup waits with wait_group 1, releasing the B slot
//     (and, after a slab's last tap, the A slab) of the group that
//     retired.
//   - A is prepared once per slab: when Cin % 32 == 0 the slab is the
//     halo'd tile of 32 channels by TMA, which serves all nine taps;
//     three warps of the producer warpgroup round it to tf32 in place
//     (and zero it where the mask, which TMA lands in one buffer beside
//     the ring, is <= 0) once, fence it for the async proxy and arrive
//     on the slab's ready barrier. Otherwise
//     (conv 0's Cin = 3, odd test widths) those warps gather each K
//     step's BM x 32 slab from device memory, with offsets stepped per
//     thread (no divide per element), rounded and masked as they store.
//   - the taps read A through shared-memory descriptors (SS) at the
//     tap's row offset when each 64-pixel sub-tile is one run of slab
//     rows (cols >= 64, and every gathered slab); the 128-byte swizzle
//     is the address's, so any row offset is read right with the
//     descriptor's base offset at 0. Narrower tiles (W <= 32) read A
//     from registers (RS), the next step's fragments loaded before the
//     current group is waited for.
//   - B comes per K step as one 32 x BN TMA box into a ring; one thread
//     of the producer warpgroup issues every TMA load.
//   - when the tiles cannot fill the SMs, K is split over blocks by
//     slabs, chosen per image; the last block to finish a tile sums
//     the partials in split order (no float atomics), so each image of
//     a batch gets its output alone, bit for bit.
// The plan (tile, WM, SS or RS, rings, split) is ops/conv3x3.tf32_plan.
#define TF32X3_HOST
#include "tf32x3.cuh"

#include <type_traits>

namespace {

using namespace tf32x3;

constexpr int kConsumers = 256;      // two warpgroups
constexpr int kPreparers = 96;       // warps 9-11: round, mask or gather A
constexpr int kThreads = kConsumers + 128;
constexpr int kSmemLimit = 232448;  // a block's dynamic shared memory
// Registers per thread after setmaxnreg. A block starts with 168 a
// thread (65536 / 384, in steps of 8); setmaxnreg.inc only takes what
// setmaxnreg.dec gave back, so the consumers' gain must be covered by
// the producers' loss, or the consumers wait forever. The preparers'
// gather keeps 16 loads in flight within 88.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 88;
constexpr int kConsumerRegs = 208;
static_assert(128 * (kLaunchRegs - kProducerRegs) >=
                  256 * (kConsumerRegs - kLaunchRegs),
              "setmaxnreg: the consumers would wait for registers forever");

struct ConvArgs {
  const float* x;     // gathered path only
  const float* mask;  // null when unmasked
  const float* bias;  // null in the backward
  float* out;
  int n, h, w, cin, cout;
  int rows, cols, pitch, tiles_y, tiles_x, ch_tiles, tiles;
  int halo;             // A slabs by TMA with a halo (Cin % 32 == 0)
  int mask_slab;        // the halo'd mask by TMA into the mask buffer
  int slabs, taps;      // A slabs per tile, K steps per slab (9 or 1)
  int slab_rows;        // pixel rows of a slab
  int a_stages, b_stages, a_slot_bytes;
  int relu;
  // Split K: work item w is tile w / splits and A slabs
  // [q * split_slabs, (q + 1) * split_slabs) for q = w % splits.
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

// The shared-memory plan: A slots, the mask buffer (a slot's size, when
// masked with a halo), B slots, then the barrier arrays, the mask
// buffer's two barriers and the split-K ticket.
template <int BN>
struct Smem {
  uint8_t* a;
  uint8_t* m;
  uint8_t* b;
  uint64_t* a_full;   // the slab's TMA landed (halo path)
  uint64_t* a_ready;  // the slab is rounded and masked
  uint64_t* a_empty;  // the consumers are done with the slab
  uint64_t* b_full;
  uint64_t* b_empty;
  uint64_t* m_full;   // the mask landed
  uint64_t* m_empty;  // the preparers are done with it
  int* flag;
  int a_slot;
  static constexpr int kBSlot = BN * kRowFloats * 4;  // one 32 x BN box

  __device__ Smem(uint8_t* base, const ConvArgs& args)
      : a(base),
        m(base + args.a_stages * args.a_slot_bytes),
        b(m + (args.mask_slab ? args.a_slot_bytes : 0)),
        a_full(reinterpret_cast<uint64_t*>(b + args.b_stages * kBSlot)),
        a_ready(a_full + args.a_stages),
        a_empty(a_ready + args.a_stages),
        b_full(a_empty + args.a_stages),
        b_empty(b_full + args.b_stages),
        m_full(b_empty + args.b_stages),
        m_empty(m_full + 1),
        flag(reinterpret_cast<int*>(m_empty + 1)),
        a_slot(args.a_slot_bytes) {}

  __device__ float* slab(int slot) const {
    return reinterpret_cast<float*>(a + slot * a_slot);
  }
  __device__ uint8_t* b_tile(int slot) const { return b + slot * kBSlot; }
};

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(__uint_as_float(to_tf32(v.x)),
                     __uint_as_float(to_tf32(v.y)),
                     __uint_as_float(to_tf32(v.z)),
                     __uint_as_float(to_tf32(v.w)));
}

// ---- the producer warpgroup's thread 0: every TMA load. A halo'd
// slab (and its mask) is issued while the slab before it is half way
// through its taps, once the slot two slabs back is free, so that it
// lands and is prepared before the consumers reach it; B goes one box
// per K step through its ring.
constexpr int kAheadTap = 4;

template <int BN>
__device__ __forceinline__ void load(const CUtensorMap& map_x,
                                     const CUtensorMap& map_m,
                                     const CUtensorMap& map_b,
                                     const ConvArgs& args,
                                     const Smem<BN>& sm) {
  const uint32_t slab_bytes = args.slab_rows * kRowFloats * 4;
  const int items = args.tiles * args.splits;
  // The next slab whose A is to be issued: work item aw, slab ac.
  int aw = blockIdx.x;
  int ac = aw < items ? work_at(args, aw).c0 : 0;
  int ca = 0;  // A slabs issued
  auto issue_a = [&]() {
    if (!args.halo || aw >= items) return;
    const Tile tl = tile_at<BN>(args, work_at(args, aw).tile);
    const int slot = ca % args.a_stages;
    const int round = ca / args.a_stages;
    if (round > 0) bar_wait(&sm.a_empty[slot], (round - 1) & 1);
    bar_arrive_tx(&sm.a_full[slot], slab_bytes);
    tma_4d(sm.slab(slot), &map_x, &sm.a_full[slot], ac * kRowFloats,
           tl.x0 - 1, tl.y0 - 1, tl.img);
    if (args.mask_slab) {
      if (ca > 0) bar_wait(sm.m_empty, (ca - 1) & 1);
      bar_arrive_tx(sm.m_full, slab_bytes);
      tma_4d(sm.m, &map_m, sm.m_full, ac * kRowFloats, tl.x0 - 1,
             tl.y0 - 1, tl.img);
    }
    ++ca;
    if (++ac >= work_at(args, aw).c1) {
      aw += gridDim.x;
      if (aw < items) ac = work_at(args, aw).c0;
    }
  };
  issue_a();
  int cb = 0;  // B steps issued
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Work wk = work_at(args, w);
    const Tile tl = tile_at<BN>(args, wk.tile);
    for (int c = wk.c0; c < wk.c1; ++c) {
      for (int tap = 0; tap < args.taps; ++tap, ++cb) {
        const int bslot = cb % args.b_stages;
        const int bround = cb / args.b_stages;
        if (bround > 0) bar_wait(&sm.b_empty[bslot], (bround - 1) & 1);
        const int k0 =
            args.halo ? tap * args.cin + c * kRowFloats : c * kRowFloats;
        bar_arrive_tx(&sm.b_full[bslot], Smem<BN>::kBSlot);
        tma_2d(sm.b_tile(bslot), &map_b, &sm.b_full[bslot], k0, tl.n0);
        if (tap == kAheadTap) issue_a();
      }
    }
  }
}

// Round a landed halo slab to tf32 in place, zeroing where the landed
// mask (the same box, so the same swizzled offsets) is <= 0. Preparer p
// takes 16-byte chunk p % 8 of slab rows p / 8, p / 8 + 12, ...
__device__ __forceinline__ void round_slab(const ConvArgs& args,
                                           float* slab, const float* mask,
                                           int p) {
  constexpr int kRowStep = kPreparers / 8;
  for (int r = p >> 3; r < args.slab_rows; r += kRowStep) {
    const int off = r * kRowFloats + 4 * (p & 7);
    float4 v = *reinterpret_cast<float4*>(slab + off);
    if (mask != nullptr) {
      const float4 m = *reinterpret_cast<const float4*>(mask + off);
      v.x = m.x > 0.f ? v.x : 0.f;
      v.y = m.y > 0.f ? v.y : 0.f;
      v.z = m.z > 0.f ? v.z : 0.f;
      v.w = m.w > 0.f ? v.w : 0.f;
    }
    *reinterpret_cast<float4*>(slab + off) = round4(v);
  }
}

// Gather K step `c`'s BM x 32 slab from device memory: element (pixel m,
// k) is x at pixel m shifted by tap k / Cin, channel k % Cin, masked,
// zero outside the image and beyond 9 * Cin, rounded to tf32. Preparer
// p takes pixels p, p + 96, ...; (tap, channel) step with k, 16 loads in
// flight at a time (the preparers' registers are few).
template <int WM>
__device__ __forceinline__ void gather(const ConvArgs& args, const Tile& tl,
                                       int c, float* slab, int p) {
  constexpr int kBM = 128 * WM;
  constexpr int kRun = 16;
  const int k0 = c * kRowFloats;
  const int tap0 = k0 / args.cin;
  const int ch0 = k0 - tap0 * args.cin;
  const int k_real = 9 * args.cin;
  const long long image = static_cast<long long>(tl.img) * args.h * args.w *
                          args.cin;
  const float* x = args.x + image;
  const float* mask = args.mask == nullptr ? nullptr : args.mask + image;
  for (int m = p; m < kBM; m += kPreparers) {
    const int py = tl.y0 + m / args.cols - 1;
    const int px = tl.x0 + m % args.cols - 1;
    int tap = tap0;
    int ch = ch0;
#pragma unroll 1
    for (int j0 = 0; j0 < kRowFloats; j0 += kRun) {
      float v[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int dy = tap / 3;
        const int y = py + dy;
        const int xx = px + tap - 3 * dy;
        const bool in = k0 + j0 + j < k_real && y >= 0 && y < args.h &&
                        xx >= 0 && xx < args.w;
        const int idx = (y * args.w + xx) * args.cin + ch;
        v[j] = in ? __ldg(x + idx) : 0.f;
        if (in && mask != nullptr && !(__ldg(mask + idx) > 0.f)) v[j] = 0.f;
        if (++ch == args.cin) {
          ch = 0;
          ++tap;
        }
      }
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) {
        *reinterpret_cast<float4*>(slab + swz(m, j0 + 4 * q)) =
            round4(make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                               v[4 * q + 3]));
      }
    }
  }
}

// ---- the producer warpgroup's warps 9-11: each A slab made ready once.
template <int BN, int WM>
__device__ __forceinline__ void prepare(const ConvArgs& args,
                                        const Smem<BN>& sm, int p) {
  int ca = 0;
  for (int w = blockIdx.x; w < args.tiles * args.splits; w += gridDim.x) {
    const Work wk = work_at(args, w);
    const Tile tl = tile_at<BN>(args, wk.tile);
    for (int c = wk.c0; c < wk.c1; ++c, ++ca) {
      const int slot = ca % args.a_stages;
      const int round = ca / args.a_stages;
      float* slab = sm.slab(slot);
      if (args.halo) {
        bar_wait(&sm.a_full[slot], round & 1);
        const float* mask = nullptr;
        if (args.mask_slab) {
          bar_wait(sm.m_full, ca & 1);
          mask = reinterpret_cast<const float*>(sm.m);
        }
        round_slab(args, slab, mask, p);
        if (args.mask_slab) bar_arrive(sm.m_empty);
      } else {
        if (round > 0) bar_wait(&sm.a_empty[slot], (round - 1) & 1);
        gather<WM>(args, tl, c, slab, p);
      }
      fence_async_smem();
      bar_arrive(&sm.a_ready[slot]);
    }
  }
}

// Split K: write this item's partial tile, take a ticket, and if this
// is the tile's last item, replace `acc` by the sum of the tile's
// partials in split order (whatever order they arrived in). Returns
// whether the caller runs the epilogue. Sub-tile wm of warpgroup wg
// holds tile rows wg * 64 * WM + wm * 64 + (row, row + 8).
template <int BN, int WM>
__device__ __forceinline__ bool sum_splits(const ConvArgs& args, int w,
                                           int tile,
                                           float (&acc)[WM][BN / 2],
                                           int row0, int tig, int* flag) {
  constexpr int kTile = 128 * WM * BN;
  float* mine = args.ws + static_cast<long long>(w) * kTile;
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) {
    const int r0 = row0 + wm * 64;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(mine + r0 * BN + col) =
          make_float2(acc[wm][4 * j], acc[wm][4 * j + 1]);
      *reinterpret_cast<float2*>(mine + (r0 + 8) * BN + col) =
          make_float2(acc[wm][4 * j + 2], acc[wm][4 * j + 3]);
    }
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
  for (int wm = 0; wm < WM; ++wm) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[wm][i] = 0.f;
  }
  const float* first =
      args.ws + static_cast<long long>(tile) * args.splits * kTile;
  for (int q = 0; q < args.splits; ++q) {
    const float* src = first + static_cast<long long>(q) * kTile;
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) {
      const int r0 = row0 + wm * 64;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * tig;
        const float2 a =
            __ldcg(reinterpret_cast<const float2*>(src + r0 * BN + col));
        const float2 b = __ldcg(
            reinterpret_cast<const float2*>(src + (r0 + 8) * BN + col));
        acc[wm][4 * j] += a.x;
        acc[wm][4 * j + 1] += a.y;
        acc[wm][4 * j + 2] += b.x;
        acc[wm][4 * j + 3] += b.y;
      }
    }
  }
  return true;
}

// A's fragments of one K step (RS): this thread's two pixels at slab
// rows r0 and r1 (the tap's), channels kk * 8 + tig (+ 4), as in mma_n8.
__device__ __forceinline__ void load_frag(uint32_t (&frag)[4][4],
                                          const float* a, int r0, int r1,
                                          int tig) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(a);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = kk * 8 + tig;
    frag[kk][0] = u[swz(r0, k)];
    frag[kk][1] = u[swz(r1, k)];
    frag[kk][2] = u[swz(r0, k + 4)];
    frag[kk][3] = u[swz(r1, k + 4)];
  }
}

// The consumer warpgroups: per work item, the K loop on the tensor
// cores with one group in flight behind the one issuing, then the
// epilogue. SS: A from the slab through descriptors; else RS (WM = 1).
template <int BN, int WM, bool SS>
__device__ __forceinline__ void consume(const ConvArgs& args,
                                        const Smem<BN>& sm) {
  regs_up<kConsumerRegs>();
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  // Tile row of this thread's first accumulator row.
  const int row0 = wg * 64 * WM + ((tid >> 5) & 3) * 16 + g;
  const int pitch = args.pitch;
  // Slab row of tile pixel m at tap (0, 0); tap (dy, dx) adds dy *
  // pitch + dx.
  auto slab_row = [&](int m) {
    return args.halo ? (m / args.cols) * pitch + m % args.cols : m;
  };
  int first[WM];  // SS: each sub-tile's first pixel
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) {
    first[wm] = slab_row(wg * 64 * WM + wm * 64);
  }
  const int base0 = slab_row(row0);  // RS: this thread's two pixels
  const int base1 = slab_row(row0 + 8);
  const bool pairs = (args.cout & 1) == 0;
  float acc[WM][BN / 2];
  uint32_t frag[2][4][4] = {};
  int ca = 0;  // A slabs consumed
  int cb = 0;  // B steps consumed
  for (int w = blockIdx.x; w < args.tiles * args.splits; w += gridDim.x) {
    const Work wk = work_at(args, w);
    const Tile tl = tile_at<BN>(args, wk.tile);
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[wm][i] = 0.f;
    }
    // The current step's slab and tap; the slots the group in flight
    // read, freed when it retires.
    int c = wk.c0;
    int tap = 0;
    int aslot = 0;
    const float* a = nullptr;
    int prev_b = -1;
    int prev_a = -1;
    auto tap_shift = [&](int t) {
      return args.halo ? (t / 3) * pitch + t % 3 : 0;
    };
    auto begin_slab = [&]() {
      aslot = ca % args.a_stages;
      bar_wait(&sm.a_ready[aslot], (ca / args.a_stages) & 1);
      a = sm.slab(aslot);
    };
    begin_slab();
    if constexpr (!SS) load_frag(frag[0], a, base0, base1, tig);
    // One K step, its fragments (RS) in frag[P]; the next step's go to
    // frag[P ^ 1], which the group that just retired read.
    auto step = [&](auto parity) {
      constexpr int P = decltype(parity)::value;
      const int bslot = cb % args.b_stages;
      bar_wait(&sm.b_full[bslot], (cb / args.b_stages) & 1);
      const uint64_t db = desc_k_major(sm.b_tile(bslot));
      const int shift = tap_shift(tap);
#pragma unroll
      for (int wm = 0; wm < WM; ++wm) fence_regs(acc[wm]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (SS) {
#pragma unroll
          for (int wm = 0; wm < WM; ++wm) {
            const uint64_t da =
                desc_k_major(a + (first[wm] + shift) * kRowFloats);
            mma_ss<BN>(acc[wm], da + 2 * kk, db + 2 * kk, 1);
          }
        } else {
          mma<BN>(acc[0], frag[P][kk], db + 2 * kk, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if constexpr (!SS) fence_frag(frag[P ^ 1]);
      if (prev_b >= 0) bar_arrive(&sm.b_empty[prev_b]);
      if (prev_a >= 0) {
        bar_arrive(&sm.a_empty[prev_a]);
        prev_a = -1;
      }
      prev_b = bslot;
      ++cb;
      if (++tap == args.taps) {
        prev_a = aslot;
        tap = 0;
        ++ca;
        if (++c < wk.c1) begin_slab();
      }
      if constexpr (!SS) {
        // The next step's fragments, before this group is waited for.
        if (c < wk.c1) {
          const int next = tap_shift(tap);
          load_frag(frag[P ^ 1], a, base0 + next, base1 + next, tig);
        }
      }
    };
    const int steps = (wk.c1 - wk.c0) * args.taps;
    for (int i = 0; i < steps; i += 2) {
      step(std::integral_constant<int, 0>{});
      if (i + 1 < steps) step(std::integral_constant<int, 1>{});
    }
    wgmma_wait<0>();
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) fence_regs(acc[wm]);
    if constexpr (!SS) {
      fence_frag(frag[0]);
      fence_frag(frag[1]);
    }
    if (prev_b >= 0) bar_arrive(&sm.b_empty[prev_b]);
    if (prev_a >= 0) bar_arrive(&sm.a_empty[prev_a]);

    if (args.splits > 1 &&
        !sum_splits<BN, WM>(args, w, wk.tile, acc, row0, tig, sm.flag)) {
      continue;
    }

    // ---- epilogue: bias, ReLU, one write of each output
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = row0 + wm * 64 + 8 * half;
        const int y = tl.y0 + m / args.cols;
        const int x = tl.x0 + m % args.cols;
        if (y >= args.h || x >= args.w) continue;
        float* dst = args.out +
                     ((static_cast<long long>(tl.img) * args.h + y) *
                          args.w + x) * args.cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int o = tl.n0 + 8 * j + 2 * tig;
          if (o >= args.cout) continue;
          float v0 = acc[wm][4 * j + 2 * half];
          float v1 = acc[wm][4 * j + 2 * half + 1];
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
}

template <int BN, int WM, bool SS>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_m,
                    const __grid_constant__ CUtensorMap map_b,
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
      bar_init(&sm.a_full[s], 1);
      bar_init(&sm.a_ready[s], kPreparers);
      bar_init(&sm.a_empty[s], kConsumers);
    }
    for (int s = 0; s < args.b_stages; ++s) {
      bar_init(&sm.b_full[s], 1);
      bar_init(&sm.b_empty[s], kConsumers);
    }
    bar_init(sm.m_full, 1);
    bar_init(sm.m_empty, kPreparers);
    bar_init_fence();
  }
  __syncthreads();

  if (tid < kConsumers) {
    consume<BN, WM, SS>(args, sm);
    return;
  }
  // ---- producer warpgroup; its registers go to the consumers. The
  // rings run on across the block's work items, so the next tile's
  // loads overlap this tile's last products and its epilogue.
  regs_down<kProducerRegs>();
  if (tid == kConsumers) {
    load<BN>(map_x, map_m, map_b, args, sm);
  } else if (tid >= kConsumers + 32) {
    prepare<BN, WM>(args, sm, tid - kConsumers - 32);
  }
}

template <int BN, int WM, bool SS>
int launch(const CUtensorMap& mx, const CUtensorMap& mm,
           const CUtensorMap& mb, const ConvArgs& args, int blocks,
           int smem_bytes, cudaStream_t stream) {
  // The opt-in to the most dynamic shared memory is made once per
  // instantiation.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv3x3_tf32_kernel<BN, WM, SS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  conv3x3_tf32_kernel<BN, WM, SS><<<blocks, kThreads, smem_bytes, stream>>>(
      mx, mm, mb, args);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations the plan picks from: SS at WM = 2 or 1, RS at 1.
template <int BN>
int launch_shape(int wm, int ss, const CUtensorMap& mx,
                 const CUtensorMap& mm, const CUtensorMap& mb,
                 const ConvArgs& args, int blocks, int smem_bytes,
                 cudaStream_t stream) {
  if (ss && wm == 2) {
    return launch<BN, 2, true>(mx, mm, mb, args, blocks, smem_bytes, stream);
  }
  if (ss && wm == 1) {
    return launch<BN, 1, true>(mx, mm, mb, args, blocks, smem_bytes, stream);
  }
  if (!ss && wm == 1) {
    return launch<BN, 1, false>(mx, mm, mb, args, blocks, smem_bytes,
                                stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch on `stream`; returns 0, a cudaError_t, or
// tf32x3::kTensorMapError + a driver code. The plan (bn, wm, ss, rows,
// cols, halo, slabs, taps, ring sizes, splits, blocks, smem_bytes)
// comes from ops/conv3x3.py's tf32_plan; a plan this file has no kernel
// for, or whose parts do not fit, is refused (cudaErrorInvalidValue).
// `blocks` persistent blocks walk the work items. With splits > 1, `ws`
// holds a (128 * wm) x bn partial tile per item and `counters` one
// zeroed int per output tile (left zeroed). `bias` and `mask` may be
// null. Each run adds one to `*launches`.
extern "C" int conv3x3_tf32_forward(
    const float* x, const float* mask, const float* b_hi, const float* bias,
    float* out, int n, int h, int w, int cin, int cout, int k_pad, int relu,
    int bn, int wm, int ss, int rows, int cols, int halo, int slabs,
    int taps, int a_stages, int b_stages, int a_slot_bytes, int splits,
    int split_slabs, int blocks, int smem_bytes, float* ws, int* counters,
    unsigned long long* launches, int device, void* stream) {
  const int slab_rows = halo ? (rows + 2) * (cols + 2) : 128 * wm;
  const bool fits =
      rows * cols == 128 * wm && a_stages >= 2 && b_stages >= 2 &&
      slab_rows * kRowFloats * 4 <= a_slot_bytes && a_slot_bytes % 1024 == 0 &&
      smem_bytes <= kSmemLimit &&
      (!ss || !halo || cols >= 64) && (halo || ss) &&
      k_pad % kRowFloats == 0 && k_pad >= 9 * cin;
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  // The calling thread (autograd's, for the backward) may have no
  // current context yet; the tensor-map encoder needs one.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles_y = (h + rows - 1) / rows;
  const int tiles_x = (w + cols - 1) / cols;
  const int ch_tiles = (cout + bn - 1) / bn;
  const ConvArgs args{x,
                      mask,
                      bias,
                      out,
                      n,
                      h,
                      w,
                      cin,
                      cout,
                      rows,
                      cols,
                      cols + 2,
                      tiles_y,
                      tiles_x,
                      ch_tiles,
                      n * tiles_y * tiles_x * ch_tiles,
                      halo,
                      halo && mask != nullptr,
                      slabs,
                      taps,
                      slab_rows,
                      a_stages,
                      b_stages,
                      a_slot_bytes,
                      relu,
                      splits,
                      split_slabs,
                      ws,
                      counters,
                      launches};
  CUtensorMap mx{}, mm{}, mb{};
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
  if (rc == 0) rc = make_map(&mb, b_hi, 2, bdims, bstrides, bbox);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8:
      return launch_shape<8>(wm, ss, mx, mm, mb, args, blocks, smem_bytes,
                             s);
    case 64:
      return launch_shape<64>(wm, ss, mx, mm, mb, args, blocks, smem_bytes,
                              s);
    case 128:
      return launch_shape<128>(wm, ss, mx, mm, mb, args, blocks,
                               smem_bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
