// Raw Gram matrices F_s^T F_s of a (S, P, C) float32 batch, plus the
// clamped and normalized G_s = min(raw_s, clamp) / n, in one launch for
// all S images, in one of three modes (the precision tiers of
// ops/precision.py): on Hopper's tensor cores in 3xTF32 (see tf32x3.cuh;
// gram_tc_kernel) or in TF32 (gram_tf32_kernel), or in IEEE fp32 on the
// CUDA cores (gram_ieee_kernel). All three share the kind of grid, the
// split over P and the fixed-order sum of the partial tiles described
// below; the IEEE kernel has its own block and plan.
//
// Replaces the Pallas TPU kernel `_gram_accumulate_kernel` (with its
// driver `_raw_gram`) of style_transfer_visualizer_tpu/ops/pallas_gram.py.
// On the TPU the grid walks the 512-row pixel tiles in order and carries
// the C x C sum in VMEM scratch. Blocks on a GPU run in parallel and in
// no order, so the sum over P is split, deterministically and without
// float atomics:
//
//   - block (t, s, b) of the (T(T+1)/2, splits, S) grid, T = C/64 tiles
//     a side, takes image b's t-th 64 x 64 tile pair (i <= j) of the
//     upper triangle (G is symmetric) and its s-th contiguous range of
//     pixel rows. F is read through a 3-D tensor map (C, P, S), so the
//     last slab of an image's range is zero-filled past row P and never
//     reads the next image's rows;
//   - a producer warp streams 32-row slabs of the two 64-channel
//     column blocks of F into a ring of shared-memory slots with TMA
//     (one slab when i == j), guarded by mbarriers;
//   - the consumer warpgroup computes F_i^T F_j: A = F_i^T goes through
//     the hi/lo split in registers, read transposed from the slot; B
//     must be K-major (pixels contiguous) for a tf32 wgmma, so one pass
//     splits and transposes the F_j slab into hi and lo tiles in shared
//     memory; then three wgmma m64n64k8 per k8 slice (3xTF32);
//   - the TF32 mode (one product, both operands rounded to tf32) keeps
//     its products in flight instead: 8 slabs of 64 rows (two K steps,
//     one wgmma group, a barrier round) accumulate in the wgmma
//     accumulator before one promotion (the tensor cores' fp32 sum
//     truncates, so a whole split range of up to 16K rows in one
//     accumulator drifts by 1e-4), the transposed B tile and A's
//     fragments are double-buffered so that slab s+1 is prepared while
//     slab s's products are in flight (wgmma.wait_group 1), and on a
//     diagonal pair A = B = F_i^T comes from that one tile through
//     descriptors; its last blocks write raw and G through a tile staged
//     in shared memory, rows and mirror rows on consecutive addresses
//     (the mirror's element-by-element stores lie a row apart, about
//     10 µs a launch);
//   - the IEEE mode (see gram_ieee_kernel) lands slabs through a
//     cp.async ring, keeps an 8 x 8 register tile a thread and issues
//     no product below a diagonal pair's diagonal;
//   - each block writes its partial tile to the workspace (per image
//     and pair); the sum of the partials is taken in two levels, each
//     in fixed order, so
//     that no single block reads all S of them: the splits form groups
//     of `group`; a block takes a ticket from its group's counter, and
//     the group's last block to arrive sums the group's partials in
//     split order into a group tile; it then takes a ticket from the
//     pair's counter, and the last group to arrive sums the group tiles
//     in group order, writes raw_b[i, j] and its mirror raw_b[j, i] (the
//     same value: raw is bit-symmetric) with the clamp and scale fused
//     into G. Each last block sets its counter back to 0 for the next
//     call. An image's blocks never touch another image's workspace,
//     counters or output, so each image's raw Gram is the one the
//     launch computes for that image alone (S = 1), bit for bit.
//
// Bound on the H100 SXM: the symmetric product needs P*C*(C+1) flops
// against 4*P*C bytes read: bound by bytes at C <= 128 and by the
// 3xTF32 rate (495/3 TFLOP/s) at C >= 256 (TF32: by bytes up to C = 512
// at 495 TFLOP/s; IEEE: by bytes at C = 64, by the 67 TFLOP/s of fp32
// FMA from C = 128).
#define TF32X3_HOST
#include "tf32x3.cuh"

#include <type_traits>

namespace {

using namespace tf32x3;

constexpr int kT = 64;            // output tile edge
constexpr int kKP = 32;           // pixel rows per slot
constexpr int kConsumers = 128;   // one warpgroup
constexpr int kThreads = kConsumers + 32;
constexpr int kSlabBytes = kKP * kT * 4;  // 32 rows x 64 channels
constexpr int kSubFloats = kKP * kRowFloats;  // one 32 x 32 TMA box

struct GramArgs {
  float* ws;       // (S, pairs, splits + groups, 64, 64) partial tiles
  int* counters;   // (S, pairs, groups + 1), 0 between calls
  float* raw;      // (S, C, C)
  float* g;        // (S, C, C)
  long long p, rows_per_split;
  int c, tiles, splits, group, groups, stages;
  float clamp, norm;
  unsigned long long* launches;  // count_launch's counter
};

constexpr int kTileFloats = kT * kT;

// The partial-tile sums below serve a 64 x 64 tile summed by kN
// threads: the tensor-core kernels' 128 consumers (the default), the
// IEEE kernel's 256 threads.
template <int kN>
constexpr int kVecsOf = kTileFloats / 4 / kN;

// Sum `count` tiles at `src` (kTileFloats apart) in index order; thread
// t holds float4s t, t + kN, ... of the tile.
template <int kN = kConsumers>
__device__ __forceinline__ void sum_tiles(const float* src, int count,
                                          float4 (&sum)[kVecsOf<kN>]) {
  constexpr int kV = kVecsOf<kN>;
  // Loads of 16 float4s a thread in flight: four tiles' at 4 float4s a
  // tile (the IEEE kernel's), two at 8 (the tensor-core kernels').
  constexpr int kUnroll = kV <= 4 ? 4 : 2;
  const int tid = threadIdx.x;
#pragma unroll
  for (int v = 0; v < kV; ++v) sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll kUnroll
  for (int t = 0; t < count; ++t) {
    const float4* tile =
        reinterpret_cast<const float4*>(src + static_cast<long long>(t) *
                                                  kTileFloats);
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const float4 x = __ldcg(tile + tid + v * kN);
      sum[v].x += x.x;
      sum[v].y += x.y;
      sum[v].z += x.z;
      sum[v].w += x.w;
    }
  }
}

// One ticket from `counter` for the consumer warpgroup: true for the
// block that arrives `expected`-th (and last); it resets the counter.
__device__ __forceinline__ bool last_to_arrive(int* counter, int expected,
                                               int* flag) {
  __threadfence();
  named_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    *flag = atomicAdd(counter, 1) == expected - 1;
    if (*flag) *counter = 0;
  }
  named_sync(1, kConsumers);
  if (!*flag) return false;
  __threadfence();
  return true;
}

// The TF32 and IEEE kernels' ticket among kN threads: the CTA's
// partial-tile writes come before thread 0's release-acquire add
// through the barrier (the release is cumulative), and the other
// blocks' writes before this CTA's reads through the acquire and the
// barrier after it; no fence of every thread.
template <int kN = kConsumers>
__device__ __forceinline__ bool last_to_arrive_acq_rel(int* counter,
                                                       int expected,
                                                       int* flag) {
  named_sync(1, kN);
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    *flag = old == expected - 1;
    if (*flag) *counter = 0;
  }
  named_sync(1, kN);
  return *flag;
}

// Element (pixel k, channel m) of a slab: two 32-channel boxes.
__device__ __forceinline__ int slab_off(int k, int m) {
  return (m >> 5) * kSubFloats + swz(k, m & 31);
}

// This block's tile pair (i0, j0) of the upper triangle, its image and
// its range [p_begin, p_end) of pixel rows.
struct Pair {
  int i0, j0, image;
  bool diag;
  long long p_begin, p_end;
};

__device__ __forceinline__ Pair pair_of_block(const GramArgs& args) {
  int bi = 0;
  int rem = static_cast<int>(blockIdx.x);
  while (rem >= args.tiles - bi) {
    rem -= args.tiles - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const long long p_begin =
      static_cast<long long>(blockIdx.y) * args.rows_per_split;
  const long long p_stop = p_begin + args.rows_per_split;
  return {bi * kT, bj * kT, static_cast<int>(blockIdx.z), bi == bj,
          p_begin, p_stop < args.p ? p_stop : args.p};
}

// This block's partial tile in the workspace (row-major 64 x 64).
__device__ __forceinline__ float* partial_tile(const GramArgs& args) {
  const int pair = static_cast<int>(blockIdx.z * gridDim.x + blockIdx.x);
  return args.ws + (static_cast<long long>(pair) *
                        (args.splits + args.groups) +
                    blockIdx.y) * kTileFloats;
}

// After the block's kN threads (the 128 consumers of a tensor-core
// kernel, the IEEE kernel's 256) wrote its partial tile: the two-level
// fixed-order sum, and the last block of the pair writes raw and G
// (both triangles). With `stage` (shared memory for a 64 x 65 tile;
// the TF32 and IEEE kernels'), the tickets are
// release-acquire adds and the last block writes through the staged
// tile, row by row (write_pair_staged), instead of element by element:
// kStaged. With kOneLevel (the IEEE kernel's), a plan of one group
// (`groups` 1) ends after the first level: its sum is the pair's.
template <bool kStaged = false, int kN = kConsumers, bool kOneLevel = false>
__device__ void sum_partials(const GramArgs& args, const Pair& pr,
                             int* flag, float* stage = nullptr);

// The 3xTF32 mode.
__global__ void __launch_bounds__(kThreads, 2)
gram_tc_kernel(const __grid_constant__ CUtensorMap map_f,
               const GramArgs args) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // Offset from the array itself (not via an integer address) so that
  // the compiler keeps the accesses as shared-memory loads and stores.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stages = args.stages;
  // Slots (F_i slab, F_j slab) then the transposed B hi and lo tiles.
  float* bt_hi = reinterpret_cast<float*>(smem + stages * 2 * kSlabBytes);
  float* bt_lo = bt_hi + kT * kRowFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(bt_hi + 2 * kT * kRowFloats);
  uint64_t* empty = full + stages;
  __shared__ int flag;
  count_launch(args.launches);

  const Pair pr = pair_of_block(args);
  const int image = pr.image;
  const bool diag = pr.diag;
  const int i0 = pr.i0;
  const int j0 = pr.j0;
  const long long p_begin = pr.p_begin;
  const int steps = static_cast<int>((pr.p_end - p_begin + kKP - 1) / kKP);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  auto slab_i = [&](int s) {
    return reinterpret_cast<float*>(smem + s * 2 * kSlabBytes);
  };
  auto slab_j = [&](int s) {
    return diag ? slab_i(s) : slab_i(s) + kT * kKP;
  };

  if (tid >= kConsumers) {
    // ---- producer: one thread issues the TMA loads
    if (tid != kConsumers) return;
    const uint32_t bytes = (diag ? 1 : 2) * kSlabBytes;
    for (int s = 0; s < steps; ++s) {
      const int slot = s % stages;
      const int round = s / stages;
      if (round > 0) bar_wait(&empty[slot], (round - 1) & 1);
      const int p0 = static_cast<int>(p_begin) + s * kKP;
      bar_arrive_tx(&full[slot], bytes);
      float* fi = slab_i(slot);
      tma_3d(fi, &map_f, &full[slot], i0, p0, image);
      tma_3d(fi + kSubFloats, &map_f, &full[slot], i0 + 32, p0, image);
      if (!diag) {
        float* fj = slab_j(slot);
        tma_3d(fj, &map_f, &full[slot], j0, p0, image);
        tma_3d(fj + kSubFloats, &map_f, &full[slot], j0 + 32, p0, image);
      }
    }
    return;
  }

  // ---- consumer warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = (tid >> 5) * 16 + g;
  const int row1 = row0 + 8;
  const int tn = tid & (kT - 1);  // transpose role: channel n of F_j
  const int tq = tid >> 6;        // and the k chunks tq, tq + 2, ...
  float acc[kT / 2];
  float part[kT / 2];
#pragma unroll
  for (int i = 0; i < kT / 2; ++i) acc[i] = 0.f;
  const uint64_t dhi = desc_k_major(bt_hi);
  const uint64_t dlo = desc_k_major(bt_lo);

  for (int s = 0; s < steps; ++s) {
    const int slot = s % stages;
    bar_wait(&full[slot], (s / stages) & 1);
    const float* fi = slab_i(slot);
    const float* fj = slab_j(slot);
    // B = F_j^T, K-major: bt[n][k] = split(F_j[k][n]), 4 k per store.
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int k = 4 * (tq + 2 * it);
      uint32_t h[4];
      uint32_t l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split(fj[slab_off(k + e, tn)], h[e], l[e]);
      }
      const int off = swz(tn, k);
      *reinterpret_cast<uint4*>(bt_hi + off) = make_uint4(h[0], h[1], h[2],
                                                          h[3]);
      *reinterpret_cast<uint4*>(bt_lo + off) = make_uint4(l[0], l[1], l[2],
                                                          l[3]);
    }
    // A = F_i^T from registers: element (m, k) is F_i[k][m].
    uint32_t hi[4][4];
    uint32_t lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = kk * 8 + tig;
      const int off[4] = {slab_off(c0, row0), slab_off(c0, row1),
                          slab_off(c0 + 4, row0), slab_off(c0 + 4, row1)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split(fi[off[e]], hi[kk][e], lo[kk][e]);
      }
    }
    fence_async_smem();
    named_sync(1, kConsumers);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma3<kT>(part, hi[kk], lo[kk], dhi + 2 * kk, dlo + 2 * kk, kk == 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    bar_arrive(&empty[slot]);
    promote(acc, part);
  }

  // ---- partial tile, then the two-level fixed-order sum
  float* mine = partial_tile(args);
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(mine + row0 * kT + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(mine + row1 * kT + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  sum_partials(args, pr, &flag);
}

// The TF32 mode: the one product tf32(F_i)^T tf32(F_j) a k8 slice, its
// products kept in flight. Slabs of 64 pixel rows (two 64 x 32 TMA boxes
// of F_i and of F_j); per slab, two K steps of 32 (eight wgmma m64n64k8)
// committed as one group. The transposed B tile and A's register
// fragments are double-buffered: right after slab s's group is issued
// and the one before it has retired (wait_group 1), slab s+1's F_j is
// transposed into the other tile and its F_i read into the other
// fragments, and its slot is handed back, so that TMA keeps two slabs in
// flight; a named barrier per slab publishes the tile. A = F_i^T comes
// from registers, or, on a diagonal pair, from the transposed tile
// itself through a descriptor, as B does. Every
// kPromote slabs the accumulator is added to the running sum in
// registers, rounded to nearest, and the next group starts it afresh.
constexpr int kKP1 = 64;                        // pixel rows per slab
constexpr int kSub1Floats = kKP1 * kRowFloats;  // one 64 x 32 TMA box
constexpr int kSlab1Bytes = kKP1 * kT * 4;      // 64 rows x 64 channels
constexpr int kBtFloats = kT * kRowFloats;      // 64 channels x 32 pixels
constexpr int kBt1Floats = (kKP1 / kRowFloats) * kBtFloats;  // one tile
constexpr int kPromote = 8;  // slabs a promotion (512 rows)

// Element (pixel k, channel m) of a 64-row slab.
__device__ __forceinline__ int slab1_off(int k, int m) {
  return (m >> 5) * kSub1Floats + swz(k, m & 31);
}

__global__ void __launch_bounds__(kThreads, 2)
gram_tf32_kernel(const __grid_constant__ CUtensorMap map_f,
                 const GramArgs args) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stages = args.stages;
  // Slots (F_i slab, F_j slab), then the two transposed tiles. With one
  // tile a side every pair is diagonal and a slot holds F_i alone (the
  // plan gives it twice the slots).
  const int slot_bytes = (args.tiles == 1 ? 1 : 2) * kSlab1Bytes;
  float* bt = reinterpret_cast<float*>(smem + stages * slot_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bt + 2 * kBt1Floats);
  uint64_t* empty = full + stages;
  __shared__ int flag;
  count_launch(args.launches);

  const Pair pr = pair_of_block(args);
  const bool diag = pr.diag;
  const int steps =
      static_cast<int>((pr.p_end - pr.p_begin + kKP1 - 1) / kKP1);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  auto slab_i = [&](int s) {
    return reinterpret_cast<float*>(smem + s * slot_bytes);
  };
  auto slab_j = [&](int s) {
    return diag ? slab_i(s) : slab_i(s) + kT * kKP1;
  };

  if (tid >= kConsumers) {
    // ---- producer: one thread issues the TMA loads
    if (tid != kConsumers) return;
    const uint32_t bytes = (diag ? 1 : 2) * kSlab1Bytes;
    for (int s = 0; s < steps; ++s) {
      const int slot = s % stages;
      const int round = s / stages;
      if (round > 0) bar_wait(&empty[slot], (round - 1) & 1);
      const int p0 = static_cast<int>(pr.p_begin) + s * kKP1;
      bar_arrive_tx(&full[slot], bytes);
      float* fi = slab_i(slot);
      tma_3d(fi, &map_f, &full[slot], pr.i0, p0, pr.image);
      tma_3d(fi + kSub1Floats, &map_f, &full[slot], pr.i0 + 32, p0,
             pr.image);
      if (!diag) {
        float* fj = slab_j(slot);
        tma_3d(fj, &map_f, &full[slot], pr.j0, p0, pr.image);
        tma_3d(fj + kSub1Floats, &map_f, &full[slot], pr.j0 + 32, p0,
               pr.image);
      }
    }
    return;
  }

  // ---- consumer warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = (tid >> 5) * 16 + g;
  const int row1 = row0 + 8;
  const int tn = tid & (kT - 1);  // transpose role: channel n of F_j
  const int tq = tid >> 6;        // and the pixel quads tq, tq + 2, ...
  float acc[kT / 2];
  float part[kT / 2];
#pragma unroll
  for (int i = 0; i < kT / 2; ++i) acc[i] = part[i] = 0.f;
  // A's fragments (as in mma_n8) of a slab's two K steps, for the slab
  // in flight and the next one.
  uint32_t frag[2][kKP1 / kRowFloats][4][4] = {};
  // Slab s made ready one slab ahead: F_j rounded and transposed into
  // tile s & 1 (tile[n][k] = tf32(F_j[k][n]), K-major in two 32-pixel
  // blocks, 4 pixels a store), F_i's fragments read into frag[P]; then
  // its slot goes back to the producer, so two slabs load while one
  // computes.
  auto prepare = [&](int s, auto parity) {
    constexpr int P = decltype(parity)::value;
    const int slot = s % stages;
    bar_wait(&full[slot], (s / stages) & 1);
    const float* fi = slab_i(slot);
    const float* fj = slab_j(slot);
    float* tile = bt + P * kBt1Floats;
#pragma unroll
    for (int it = 0; it < kKP1 / 8; ++it) {
      const int k = 4 * (tq + 2 * it);
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = to_tf32(fj[slab1_off(k + e, tn)]);
      *reinterpret_cast<uint4*>(tile + (k >> 5) * kBtFloats +
                                swz(tn, k & 31)) =
          make_uint4(h[0], h[1], h[2], h[3]);
    }
    if (!diag) {
#pragma unroll
      for (int c = 0; c < kKP1 / kRowFloats; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = c * kRowFloats + kk * 8 + tig;
          frag[P][c][kk][0] = to_tf32(fi[slab1_off(k, row0)]);
          frag[P][c][kk][1] = to_tf32(fi[slab1_off(k, row1)]);
          frag[P][c][kk][2] = to_tf32(fi[slab1_off(k + 4, row0)]);
          frag[P][c][kk][3] = to_tf32(fi[slab1_off(k + 4, row1)]);
        }
      }
    }
    bar_arrive(&empty[slot]);
  };
  // Slab s's two K steps from tile P and frag[P], one group; slab s + 1
  // is made ready while it is in flight.
  auto compute = [&](int s, auto parity) {
    constexpr int P = decltype(parity)::value;
    const float* tile = bt + P * kBt1Floats;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kKP1 / kRowFloats; ++c) {
      const uint64_t db = desc_k_major(tile + c * kBtFloats);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // The first product after a promotion starts the tile afresh.
        const int scale_d = c == 0 && kk == 0 && s % kPromote == 0 ? 0 : 1;
        if (diag) {
          mma_ss<kT>(part, db + 2 * kk, db + 2 * kk, scale_d);
        } else {
          mma<kT>(part, frag[P][c][kk], db + 2 * kk, scale_d);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    // Slab s - 1's group has retired: the other tile and fragments are
    // free.
    fence_frag(frag[P ^ 1][0]);
    fence_frag(frag[P ^ 1][1]);
    if (s + 1 < steps) prepare(s + 1, std::integral_constant<int, P ^ 1>{});
    if (s % kPromote == kPromote - 1 || s == steps - 1) {
      wgmma_wait<0>();
      fence_regs(part);
      promote(acc, part);
    }
    fence_async_smem();
    named_sync(1, kConsumers);
  };
  if (steps > 0) {
    prepare(0, std::integral_constant<int, 0>{});
    fence_async_smem();
    named_sync(1, kConsumers);
  }
  for (int s = 0; s < steps; s += 2) {
    compute(s, std::integral_constant<int, 0>{});
    if (s + 1 < steps) compute(s + 1, std::integral_constant<int, 1>{});
  }
  fence_frag(frag[0][0]);
  fence_frag(frag[0][1]);
  fence_frag(frag[1][0]);
  fence_frag(frag[1][1]);

  // ---- partial tile, then the two-level fixed-order sum
  float* mine = partial_tile(args);
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(mine + row0 * kT + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(mine + row1 * kT + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  // The ring is idle now: its first 16.6 KB stage the final tile.
  sum_partials<true>(args, pr, &flag, reinterpret_cast<float*>(smem));
}

// The IEEE fp32 mode on the CUDA cores: one fp32 FMA per product, no
// tensor-core instruction. Bound by the fp32 rate from C = 128 (by bytes
// at C = 64): the design keeps the FMA pipes fed and issues no product
// that the result does not use. A block of 256 threads (eight warps; at
// most 128 registers a thread, so two blocks and 16 warps an SM) takes a
// 64 x 64 tile pair, planned per shape by ops/gram.py (gram_plan, mode
// "ieee"):
//   - slabs of kIeeeSlab pixel rows of F_i and F_j (F_i alone on a
//     diagonal pair, where it serves as both operands) land in a ring
//     of `stages` slots by 16-byte cp.async copies, zero past the
//     split's last row and past C; each k-group copies and reads only
//     its own rows of a slab, so it waits at a barrier of its own
//     threads once a slab, the copies of slab s + stages - 1 issued
//     before slab s's products;
//   - thread (r, c) of a k-group keeps an 8 x 8 register tile, four 4 x
//     4 blocks: rows 4r .. 4r + 3 or 32 + 4r .. by columns 4c .. or 32 +
//     4c .., so a quarter warp's loads read one float4 of A (a
//     broadcast) and 8 neighbouring float4 of B; 4 float4 loads from
//     shared memory serve 64 FMAs. The 256 threads are four k-groups of
//     64, each on a quarter of every slab's rows, their register tiles
//     summed through shared memory in k-group order;
//   - a diagonal pair issues no product below the diagonal, and every
//     thread the same number: its block of the upper-right quadrant, and
//     one block of a diagonal quadrant, (r, c) of the upper-left where r
//     <= c, else (7 - r, 7 - c) of the lower-right, which lies above
//     the diagonal; the lower-right's 8 diagonal blocks, which no thread
//     took, are shared out, 2 elements a thread. Raw's lower triangle
//     is written from the upper, so it stays bit-symmetric;
//   - each output's sum runs over the split's rows in pixel order (its
//     k-group's rows, then the k-groups in order), the same in every
//     image, so a batch gives each image's Gram alone, bit for bit;
//   - the partial tile goes out through shared memory in coalesced
//     rows; the two-level sum's tickets are release-acquire adds, and
//     the last block writes raw and G through a staged tile
//     (write_pair_staged), as in the TF32 kernel; a plan of one group
//     (few splits) ends after the first level, one ticket and no group
//     tile on the way to the result.
constexpr int kIeeeThreads = 256;
// The most dynamic shared memory an IEEE plan asks for: two blocks an
// SM, 1 KB reserved for each.
constexpr int kIeeeSmemMax = 112 * 1024;

constexpr int kIeeeSlab = 64;  // pixel rows a slab

// Threads a k-group (8 a side), k-groups a block and a k-group's rows
// of a slab.
constexpr int kIeeeSide = kT / 8;
constexpr int kIeeeLanes = kIeeeSide * kIeeeSide;
constexpr int kIeeeGroups = kIeeeThreads / kIeeeLanes;
constexpr int kIeeeRows = kIeeeSlab / kIeeeGroups;

// The plan's layout: a slot's floats (F_i's slab, and F_j's unless every
// pair is diagonal) and the dynamic shared memory it needs (the ring;
// the k-groups' register tiles; the staged final tile).
__host__ __device__ constexpr int ieee_slot_floats(int tiles) {
  return (tiles == 1 ? 1 : 2) * kIeeeSlab * kT;
}

__host__ __device__ constexpr int ieee_smem_bytes(int tiles, int stages) {
  const int ring = stages * ieee_slot_floats(tiles) * 4;
  const int groups = kIeeeGroups * kTileFloats * 4;
  const int staged = kT * (kT + 1) * 4;
  const int most = ring > groups ? ring : groups;
  return most > staged ? most : staged;
}

// cp.async of 16 bytes; `ok` false zero-fills the destination.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// This thread's copies of the slab `stages - 1` groups back have landed.
__device__ __forceinline__ void wait_slab(int stages) {
  if (stages == 2) {
    cp_wait<0>();
  } else if (stages == 3) {
    cp_wait<1>();
  } else {
    cp_wait<2>();
  }
}

// Issue k-group kg's copies of rows p0 .. p0 + kIeeeSlab of image `img`
// into `slot`: its rows kg * kIeeeRows .. of F_i's slab [row][64]
// (channels i0 ..), then, off the diagonal, of F_j's; copy e (lane lt
// + kIeeeLanes * u) is row e / 16 of them, float4 e % 16, so
// neighbouring threads copy neighbouring 16 bytes.
__device__ __forceinline__ void ieee_load(const GramArgs& args,
                                          const Pair& pr, const float* img,
                                          int kg, int lt, long long p0,
                                          float* slot) {
  constexpr int kRowVecs = kT / 4;
  constexpr int kPer = kIeeeRows * kRowVecs / kIeeeLanes;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = lt + u * kIeeeLanes;
    const int row = kg * kIeeeRows + e / kRowVecs;
    const int col = 4 * (e % kRowVecs);
    const long long pix = p0 + row;
    const bool in_rows = pix < pr.p_end;
    const int ci = pr.i0 + col;
    const bool ok_i = in_rows && ci < args.c;
    cp16(slot + row * kT + col, img + (ok_i ? pix * args.c + ci : 0),
         ok_i);
    if (!pr.diag) {
      const int cj = pr.j0 + col;
      const bool ok_j = in_rows && cj < args.c;
      cp16(slot + (kIeeeSlab + row) * kT + col,
           img + (ok_j ? pix * args.c + cj : 0), ok_j);
    }
  }
}

__device__ __forceinline__ void fma1(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}

// acc[i][j] += a[i] * b[j]: one 4 x 4 block of the thread's tile.
__device__ __forceinline__ void fma_block(float (&acc)[4][4], const float4& a,
                                          const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) fma1(acc[i][j], av[i], bv[j]);
  }
}

// A thread's place in the tile: A and B offsets of its blocks within a
// slab row. Off the diagonal, blocks x = 2 * (row half) + (column half)
// at rows half * 32 + 4r, columns half * 32 + 4c. On it, the
// upper-right block (a_off[0], b_off[1]), the diagonal quadrant's block
// (a_off[1], b_off[0]) and the shared-out element(s) of the lower-right
// quadrant's diagonal blocks (row x_row, columns x_col ..).
struct IeeePlace {
  int a_off[2], b_off[2];
  int x_row, x_col;
};

// Diagonal elements of the lower-right quadrant a thread.
constexpr int kIeeeExtra = 16 / kIeeeSide;
constexpr int kIeeeHalf = kT / 2;

__device__ __forceinline__ IeeePlace ieee_place(int lt, int r, int c,
                                                bool diag) {
  constexpr int kN = kIeeeSide;
  constexpr int kHalf = kIeeeHalf;
  constexpr int kExtra = kIeeeExtra;
  IeeePlace pl;
  pl.a_off[0] = 4 * r;
  pl.b_off[1] = kHalf + 4 * c;
  if (!diag) {
    pl.a_off[1] = kHalf + 4 * r;
    pl.b_off[0] = 4 * c;
  } else if (r <= c) {
    pl.a_off[1] = 4 * r;
    pl.b_off[0] = 4 * c;
  } else {
    pl.a_off[1] = kHalf + 4 * (kN - 1 - r);
    pl.b_off[0] = kHalf + 4 * (kN - 1 - c);
  }
  const int m = lt / kN;                 // the lower-right's block m
  const int e = (lt % kN) * kExtra;      // its elements e .. e + kExtra
  pl.x_row = kHalf + 4 * m + e / 4;
  pl.x_col = kHalf + 4 * m + e % 4;
  return pl;
}

// One slab's products for this thread's k-group rows. Off the diagonal
// the four blocks acc[x]; on it acc[1] (upper right), acc[0] (the
// diagonal quadrant's block) and acc[2][0][0 .. kIeeeExtra) (the shared-out
// diagonal elements).
template <bool kDiag>
__device__ __forceinline__ void ieee_products(const float* as,
                                              const float* bs,
                                              const IeeePlace& pl,
                                              float (&acc)[4][4][4]) {
#pragma unroll 2
  for (int k = 0; k < kIeeeRows; ++k) {
    const float* ar = as + k * kT;
    const float* br = bs + k * kT;
    const float4 a0 = *reinterpret_cast<const float4*>(ar + pl.a_off[0]);
    const float4 a1 = *reinterpret_cast<const float4*>(ar + pl.a_off[1]);
    const float4 b0 = *reinterpret_cast<const float4*>(br + pl.b_off[0]);
    const float4 b1 = *reinterpret_cast<const float4*>(br + pl.b_off[1]);
    fma_block(acc[1], a0, b1);
    if (kDiag) {
      fma_block(acc[0], a1, b0);
      const float xa = ar[pl.x_row];
#pragma unroll
      for (int e = 0; e < kIeeeExtra; ++e) {
        fma1(acc[2][0][e], xa, br[pl.x_col + e]);
      }
    } else {
      fma_block(acc[0], a0, b0);
      fma_block(acc[2], a1, b0);
      fma_block(acc[3], a1, b1);
    }
  }
}

// Store this thread's blocks into its k-group's staged tile (row-major
// 64 x 64): off the diagonal its four blocks; on it the upper-right
// block, the diagonal quadrant's block, zeros for the blocks below the
// diagonal it stands for (the other diagonal quadrant's mirror, the
// lower-left), and its shared-out diagonal elements, so that every
// element of the tile is written once.
__device__ __forceinline__ void ieee_stage(float* tile, int r, int c,
                                           bool diag, const IeeePlace& pl,
                                           const float (&acc)[4][4][4]) {
  constexpr int kN = kIeeeSide;
  constexpr int kHalf = kIeeeHalf;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto put = [&](int row0, int col0, const float (*blk)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(tile + (row0 + i) * kT + col0) =
          blk == nullptr ? zero
                         : make_float4(blk[i][0], blk[i][1], blk[i][2],
                                       blk[i][3]);
    }
  };
  if (!diag) {
    put(4 * r, 4 * c, acc[0]);
    put(4 * r, kHalf + 4 * c, acc[1]);
    put(kHalf + 4 * r, 4 * c, acc[2]);
    put(kHalf + 4 * r, kHalf + 4 * c, acc[3]);
    return;
  }
  put(4 * r, kHalf + 4 * c, acc[1]);
  put(kHalf + 4 * r, 4 * c, nullptr);
  put(pl.a_off[1], pl.b_off[0], acc[0]);
  if (r < c) {
    put(kHalf + 4 * (kN - 1 - r), kHalf + 4 * (kN - 1 - c), nullptr);
  } else if (r > c) {
    put(4 * r, 4 * c, nullptr);
  }
#pragma unroll
  for (int e = 0; e < kIeeeExtra; ++e) {
    tile[pl.x_row * kT + pl.x_col + e] = acc[2][0][e];
  }
}

__global__ void __launch_bounds__(kIeeeThreads, 2)
gram_ieee_kernel(const float* __restrict__ f, const GramArgs args) {
  constexpr int kSlab = kIeeeSlab;
  constexpr int kGroups = kIeeeGroups;
  constexpr int kSide = kIeeeSide;  // threads a side of a k-group
  static_assert(kGroups <= 4, "named barriers 2 .. 5, one a k-group");
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  count_launch(args.launches);
  const Pair pr = pair_of_block(args);
  const int tid = threadIdx.x;
  const float* img = f + static_cast<long long>(pr.image) * args.p * args.c;
  // Thread map: k-group kg; within it warp w is lanes 4 rows x 8
  // columns of the k-group's kSide x kSide threads.
  const int kg = tid / kIeeeLanes;
  const int lt = tid % kIeeeLanes;
  const int w = lt >> 5;
  const int q = lt & 31;
  const int r = 4 * (w / (kSide / 8)) + (q >> 3);
  const int c = 8 * (w % (kSide / 8)) + (q & 7);
  const IeeePlace pl = ieee_place(lt, r, c, pr.diag);
  const int stages = args.stages;
  const int slot_floats = ieee_slot_floats(args.tiles);
  const int steps =
      static_cast<int>((pr.p_end - pr.p_begin + kSlab - 1) / kSlab);
  float acc[4][4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[x][i][j] = 0.f;
    }
  }
  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps) {
      ieee_load(args, pr, img, kg, lt, pr.p_begin + s * kSlab,
                       smem + s * slot_floats);
    }
    cp_commit();
  }
  const int row0 = kg * kIeeeRows;
  for (int s = 0; s < steps; ++s) {
    wait_slab(stages);
    // The k-group's copies of slab s have landed, and its threads are
    // done with slab s - 1, whose rows of the slot refill.
    named_sync(2 + kg, kIeeeLanes);
    const int next = s + stages - 1;
    if (next < steps) {
      ieee_load(args, pr, img, kg, lt,
                       pr.p_begin + static_cast<long long>(next) * kSlab,
                       smem + (next % stages) * slot_floats);
    }
    cp_commit();
    const float* as = smem + (s % stages) * slot_floats + row0 * kT;
    if (pr.diag) {
      ieee_products<true>(as, as, pl, acc);
    } else {
      ieee_products<false>(as, as + kSlab * kT, pl, acc);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // ---- partial tile: the k-groups' register tiles staged in shared
  // memory, summed in k-group order, written in coalesced float4s
  ieee_stage(smem + kg * kTileFloats, r, c, pr.diag, pl, acc);
  __syncthreads();
  {
    constexpr int kV = kVecsOf<kIeeeThreads>;
    const float4* staged = reinterpret_cast<const float4*>(smem);
    float4* mine = reinterpret_cast<float4*>(partial_tile(args));
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int e = tid + v * kIeeeThreads;
      float4 sum = staged[e];
#pragma unroll
      for (int g = 1; g < kGroups; ++g) {
        const float4 x = staged[g * kTileFloats / 4 + e];
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      mine[e] = sum;
    }
  }
  // The staged tiles are read before the first ticket's barrier; then
  // the same shared memory stages the final tile.
  sum_partials<true, kIeeeThreads, true>(args, pr, &flag, smem);
}

int launch_ieee(const float* f, const GramArgs& args, const dim3& grid,
                int smem_bytes, cudaStream_t stream) {
  const bool bad = args.rows_per_split % kIeeeSlab != 0 ||
                   args.stages < 2 || args.stages > 4 ||
                   smem_bytes < ieee_smem_bytes(args.tiles, args.stages) ||
                   smem_bytes > kIeeeSmemMax;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  // The opt-in to the most dynamic shared memory, and to a carveout of
  // all shared memory (two blocks an SM), once.
  static const cudaError_t opt_in = [] {
    const cudaError_t rc = cudaFuncSetAttribute(
        gram_ieee_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kIeeeSmemMax);
    if (rc != cudaSuccess) return rc;
    return cudaFuncSetAttribute(
        gram_ieee_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  gram_ieee_kernel<<<grid, kIeeeThreads, smem_bytes, stream>>>(f, args);
  return static_cast<int>(cudaGetLastError());
}

// The last block's write of a pair through shared memory: the summed
// tile staged at a pitch of 65 floats (its columns read without bank
// conflicts), then raw and G written row by row, each warp on
// consecutive addresses: rows i0 + r (for a diagonal pair the lower
// triangle taken from the upper, so raw stays bit-symmetric), then, off
// the diagonal, the mirror rows j0 + c.
template <int kN = kConsumers>
__device__ void write_pair_staged(const GramArgs& args, const Pair& pr,
                                  const float4 (&sum)[kVecsOf<kN>],
                                  float* stage) {
  constexpr int kV = kVecsOf<kN>;
  constexpr int kPitch = kT + 1;
  const int tid = threadIdx.x;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int idx = 4 * (tid + v * kN);
    float* row = stage + (idx / kT) * kPitch + idx % kT;
    row[0] = sum[v].x;
    row[1] = sum[v].y;
    row[2] = sum[v].z;
    row[3] = sum[v].w;
  }
  named_sync(1, kN);
  const long long base = static_cast<long long>(pr.image) * args.c * args.c;
  for (int e = tid; e < kTileFloats; e += kN) {
    const int r = e / kT;
    const int cc = e % kT;
    const int i = pr.i0 + r;
    const int j = pr.j0 + cc;
    if (i >= args.c || j >= args.c) continue;
    const float v = pr.diag && r > cc ? stage[cc * kPitch + r]
                                      : stage[r * kPitch + cc];
    args.raw[base + static_cast<long long>(i) * args.c + j] = v;
    args.g[base + static_cast<long long>(i) * args.c + j] =
        fminf(v, args.clamp) / args.norm;
  }
  if (pr.diag) return;
  for (int e = tid; e < kTileFloats; e += kN) {
    const int cc = e / kT;
    const int r = e % kT;
    const int i = pr.i0 + r;
    const int j = pr.j0 + cc;
    if (i >= args.c || j >= args.c) continue;
    const float v = stage[r * kPitch + cc];
    args.raw[base + static_cast<long long>(j) * args.c + i] = v;
    args.g[base + static_cast<long long>(j) * args.c + i] =
        fminf(v, args.clamp) / args.norm;
  }
}

template <bool kStaged, int kN, bool kOneLevel>
__device__ void sum_partials(const GramArgs& args, const Pair& pr,
                             int* flag, float* stage) {
  constexpr int kV = kVecsOf<kN>;
  constexpr int kFloats = kTileFloats;
  const int tid = threadIdx.x;
  const int pair = static_cast<int>(blockIdx.z * gridDim.x + blockIdx.x);
  const int split = static_cast<int>(blockIdx.y);
  float* tiles = args.ws + static_cast<long long>(pair) *
                               (args.splits + args.groups) * kFloats;
  const int image = pr.image;
  const bool diag = pr.diag;
  const int i0 = pr.i0;
  const int j0 = pr.j0;
  int* counters = args.counters + pair * (args.groups + 1);
  const int grp = split / args.group;
  const int first = grp * args.group;
  const int in_group = min(args.group, args.splits - first);
  auto ticket = [&](int* counter, int expected) {
    if constexpr (kStaged) {
      return last_to_arrive_acq_rel<kN>(counter, expected, flag);
    } else {
      return last_to_arrive(counter, expected, flag);
    }
  };
  if (!ticket(&counters[grp], in_group)) return;
  float4 sum[kV];
  sum_tiles<kN>(tiles + static_cast<long long>(first) * kFloats, in_group,
                sum);
  if constexpr (kOneLevel) {
    if (args.groups == 1) {
      write_pair_staged<kN>(args, pr, sum, stage);
      return;
    }
  }
  float4* gtile = reinterpret_cast<float4*>(
      tiles + static_cast<long long>(args.splits + grp) * kFloats);
#pragma unroll
  for (int v = 0; v < kV; ++v) gtile[tid + v * kN] = sum[v];
  if (!ticket(&counters[args.groups], args.groups)) return;
  sum_tiles<kN>(tiles + static_cast<long long>(args.splits) * kFloats,
                args.groups, sum);
  if constexpr (kStaged) {
    write_pair_staged<kN>(args, pr, sum, stage);
    return;
  }
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const float vals[4] = {sum[v].x, sum[v].y, sum[v].z, sum[v].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = 4 * (tid + v * kN) + e;
      const int r = idx / kT;
      const int cc = idx % kT;
      const int i = i0 + r;
      const int j = j0 + cc;
      if ((diag && r > cc) || i >= args.c || j >= args.c) continue;
      const float gv = fminf(vals[e], args.clamp) / args.norm;
      const long long base = static_cast<long long>(image) * args.c * args.c;
      const long long ij = base + static_cast<long long>(i) * args.c + j;
      const long long ji = base + static_cast<long long>(j) * args.c + i;
      args.raw[ij] = vals[e];
      args.raw[ji] = vals[e];
      args.g[ij] = gv;
      args.g[ji] = gv;
    }
  }
}

// kMode 1: 3xTF32 (gram_tc_kernel, 32-row slabs); 2: TF32
// (gram_tf32_kernel, 64-row slabs).
template <int kMode>
int launch_tc(const float* f, const GramArgs& args, int batch,
              const dim3& grid, int smem_bytes, cudaStream_t stream) {
  const auto kernel = kMode == 1 ? gram_tc_kernel : gram_tf32_kernel;
  CUtensorMap map{};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(args.c),
                              static_cast<cuuint64_t>(args.p),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(args.c) * 4,
                                 static_cast<cuuint64_t>(args.p) * args.c *
                                     4};
  const cuuint32_t box[3] = {kRowFloats, kMode == 1 ? kKP : kKP1, 1};
  const int rc = make_map(&map, f, 3, dims, strides, box);
  if (rc != 0) return rc;
  // The opt-in to more than 48 KB of dynamic shared memory is made once
  // per mode (a mode's plan always asks for the same size; the static
  // `flag` leaves the block less than the SM's 227 KB of dynamic).
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(map, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (one kernel launch for all `batch` images of the
// contiguous (batch, p, c) block `f`) in `mode` 0 (IEEE fp32), 1
// (3xTF32) or 2 (TF32); returns 0, a cudaError_t, or
// tf32x3::kTensorMapError + a driver code. `raw` and `g` are (batch, c,
// c); pairs are 64 x 64; `ws` holds batch * pairs * (splits + groups)
// * 64 * 64 floats; `counters` holds batch * pairs * (groups + 1)
// zeroed ints and is left zeroed; each run adds one to `*launches`. The
// split ranges are `rows_per_split` rows long (a multiple of the mode's
// slab: 32 rows, 64 in TF32 and IEEE) and cover all p rows
// of an image; groups = ceil(splits / group); c % 4 == 0 (TMA row
// stride, the IEEE mode's 16-byte copies). The plan comes from
// ops/gram.py's gram_plan; a plan this file has no kernel for, or whose
// shared memory does not hold its parts, is refused.
extern "C" int gram_forward(const float* f, float* ws, int* counters,
                            float* raw, float* g, int batch, long long p,
                            int c, int splits, long long rows_per_split,
                            int group, int stages, int smem_bytes,
                            float clamp, float norm,
                            unsigned long long* launches, int mode,
                            int device, void* stream) {
  // The calling thread may have no current context yet; the
  // tensor-map encoder needs one.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles = (c + kT - 1) / kT;
  const int groups = (splits + group - 1) / group;
  GramArgs args{ws,     counters, raw,    g,      p,     rows_per_split,
                c,      tiles,    splits, group,  groups, stages,
                clamp,  norm,     launches};
  const dim3 grid(static_cast<unsigned>(tiles * (tiles + 1) / 2),
                  static_cast<unsigned>(splits),
                  static_cast<unsigned>(batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_ieee(f, args, grid, smem_bytes, s);
    case 1:
      return launch_tc<1>(f, args, batch, grid, smem_bytes, s);
    case 2:
      return launch_tc<2>(f, args, batch, grid, smem_bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
