// Raw Gram matrices F_s^T F_s of a (S, P, C) float32 batch, plus the
// clamped and normalized G_s = min(raw_s, clamp) / n, in one launch for
// all S images, in one of three modes (the precision tiers of
// ops/precision.py): on Hopper's tensor cores in 3xTF32 or in TF32 (see
// tf32x3.cuh; gram_tc_kernel), or in IEEE fp32 on the CUDA cores
// (gram_ieee_kernel). All three share the grid, the split over P and
// the fixed-order sum of the partial tiles described below.
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
//     memory; then three wgmma m64n64k8 per k8 slice (3xTF32). In the
//     TF32 mode both operands are only rounded to tf32 (no lo tile) and
//     one wgmma runs per k8 slice;
//   - in the IEEE mode a 128-thread block stages 32-row slabs of F_i and
//     F_j in shared memory (two buffers, the next slab's loads in flight
//     in registers during this one's products) and each thread keeps 4
//     x 8 of the 64 x 64 tile in registers, one fp32 FMA per product;
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
// at 495 TFLOP/s; IEEE: by the 67 TFLOP/s of fp32 FMA from C = 64).
#define TF32X3_HOST
#include "tf32x3.cuh"

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
constexpr int kVecs = kTileFloats / 4 / kConsumers;  // float4s per thread

// Sum `count` tiles at `src` (kTileFloats apart) in index order; thread
// t holds float4s t, t + 128, ... of the tile.
__device__ __forceinline__ void sum_tiles(const float* src, int count,
                                          float4 (&sum)[kVecs]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int v = 0; v < kVecs; ++v) sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int t = 0; t < count; ++t) {
    const float4* tile =
        reinterpret_cast<const float4*>(src + static_cast<long long>(t) *
                                                  kTileFloats);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const float4 x = __ldcg(tile + tid + v * kConsumers);
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

// After the block's 128 consumer threads wrote its partial tile: the
// two-level fixed-order sum, and the last block of the pair writes raw
// and G (both triangles).
__device__ void sum_partials(const GramArgs& args, const Pair& pr,
                             int* flag);

// X3: 3xTF32; otherwise TF32 (no lo tiles).
template <bool X3>
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
  uint64_t* full =
      reinterpret_cast<uint64_t*>(bt_hi + (X3 ? 2 : 1) * kT * kRowFloats);
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
        operand<X3>(fj[slab_off(k + e, tn)], h[e], l[e]);
      }
      const int off = swz(tn, k);
      *reinterpret_cast<uint4*>(bt_hi + off) = make_uint4(h[0], h[1], h[2],
                                                          h[3]);
      if constexpr (X3) {
        *reinterpret_cast<uint4*>(bt_lo + off) = make_uint4(l[0], l[1], l[2],
                                                            l[3]);
      }
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
        operand<X3>(fi[off[e]], hi[kk][e], lo[kk][e]);
      }
    }
    fence_async_smem();
    named_sync(1, kConsumers);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_mode<kT, X3>(part, hi[kk], lo[kk], dhi + 2 * kk, dlo + 2 * kk,
                       kk == 0);
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

// The IEEE fp32 mode on the CUDA cores: the same grid, split and sum as
// gram_tc_kernel, 128 threads a block, each thread 4 rows x 8 columns
// (columns 4t..4t+3 and 32+4t..32+4t+3, so a warp's B reads are
// conflict-free) of the 64 x 64 tile, one fp32 FMA per product in
// pixel order.
constexpr int kIeeeRows = 32;  // pixel rows per slab

__global__ void __launch_bounds__(kConsumers)
gram_ieee_kernel(const float* __restrict__ f, const GramArgs args) {
  __shared__ __align__(16) float a_s[2][kIeeeRows][kT];
  __shared__ __align__(16) float b_s[2][kIeeeRows][kT];
  __shared__ int flag;
  count_launch(args.launches);
  const Pair pr = pair_of_block(args);
  const int tid = threadIdx.x;
  const float* img =
      f + static_cast<long long>(pr.image) * args.p * args.c;
  // Load role: rows lr + 8u (u = 0..3), channels lc..lc+3 of both tiles.
  const int lr = tid >> 4;
  const int lc = (tid & 15) * 4;
  // Compute role.
  const int ti = (tid >> 3) * 4;
  const int tj = (tid & 7) * 4;
  const int steps =
      static_cast<int>((pr.p_end - pr.p_begin + kIeeeRows - 1) / kIeeeRows);
  float4 ra[4];
  float4 rb[4];
  auto load = [&](int s) {
    const long long p0 = pr.p_begin + static_cast<long long>(s) * kIeeeRows;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long r = p0 + lr + 8 * u;
      const bool row = r < pr.p_end;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      ra[u] = row && pr.i0 + lc < args.c
                  ? *reinterpret_cast<const float4*>(img + r * args.c +
                                                     pr.i0 + lc)
                  : zero;
      rb[u] = row && pr.j0 + lc < args.c
                  ? *reinterpret_cast<const float4*>(img + r * args.c +
                                                     pr.j0 + lc)
                  : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      *reinterpret_cast<float4*>(&a_s[buf][lr + 8 * u][lc]) = ra[u];
      *reinterpret_cast<float4*>(&b_s[buf][lr + 8 * u][lc]) = rb[u];
    }
  };
  float acc[4][8];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[x][y] = 0.f;
  }
  if (steps > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) load(s + 1);
#pragma unroll 8
    for (int k = 0; k < kIeeeRows; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[cur][k][ti]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[cur][k][tj]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[cur][k][32 + tj]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
      }
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }
  float* mine = partial_tile(args);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    float* row = mine + (ti + x) * kT;
    *reinterpret_cast<float4*>(row + tj) =
        make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    *reinterpret_cast<float4*>(row + 32 + tj) =
        make_float4(acc[x][4], acc[x][5], acc[x][6], acc[x][7]);
  }
  sum_partials(args, pr, &flag);
}

__device__ void sum_partials(const GramArgs& args, const Pair& pr,
                             int* flag) {
  const int tid = threadIdx.x;
  const int pair = static_cast<int>(blockIdx.z * gridDim.x + blockIdx.x);
  const int split = static_cast<int>(blockIdx.y);
  float* tiles = args.ws + static_cast<long long>(pair) *
                               (args.splits + args.groups) * kTileFloats;
  const int image = pr.image;
  const bool diag = pr.diag;
  const int i0 = pr.i0;
  const int j0 = pr.j0;
  int* counters = args.counters + pair * (args.groups + 1);
  const int grp = split / args.group;
  const int first = grp * args.group;
  const int in_group = min(args.group, args.splits - first);
  if (!last_to_arrive(&counters[grp], in_group, flag)) return;
  float4 sum[kVecs];
  sum_tiles(tiles + static_cast<long long>(first) * kTileFloats, in_group,
            sum);
  float4* gtile = reinterpret_cast<float4*>(
      tiles + static_cast<long long>(args.splits + grp) * kTileFloats);
#pragma unroll
  for (int v = 0; v < kVecs; ++v) gtile[tid + v * kConsumers] = sum[v];
  if (!last_to_arrive(&counters[args.groups], args.groups, flag)) return;
  sum_tiles(tiles + static_cast<long long>(args.splits) * kTileFloats,
            args.groups, sum);
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const float vals[4] = {sum[v].x, sum[v].y, sum[v].z, sum[v].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = 4 * (tid + v * kConsumers) + e;
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

template <bool X3>
int launch_tc(const float* f, const GramArgs& args, int batch,
              const dim3& grid, int smem_bytes, cudaStream_t stream) {
  CUtensorMap map{};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(args.c),
                              static_cast<cuuint64_t>(args.p),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(args.c) * 4,
                                 static_cast<cuuint64_t>(args.p) * args.c *
                                     4};
  const cuuint32_t box[3] = {kRowFloats, kKP, 1};
  const int rc = make_map(&map, f, 3, dims, strides, box);
  if (rc != 0) return rc;
  // The opt-in to more than 48 KB of dynamic shared memory is made once
  // per mode (a mode's plan always asks for the same size; the static
  // `flag` leaves the block less than the SM's 227 KB of dynamic).
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      gram_tc_kernel<X3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  gram_tc_kernel<X3><<<grid, kThreads, smem_bytes, stream>>>(map, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (one kernel launch for all `batch` images of the
// contiguous (batch, p, c) block `f`) in `mode` 0 (IEEE fp32), 1
// (3xTF32) or 2 (TF32); returns 0, a cudaError_t, or
// tf32x3::kTensorMapError + a driver code. `raw` and `g` are (batch, c,
// c); `ws` holds batch * pairs * (splits + groups) * 64 * 64 floats;
// `counters` holds batch * pairs * (groups + 1) zeroed ints and is left
// zeroed; each run adds one to `*launches`. The split ranges are
// `rows_per_split` rows long (a multiple of 32) and cover all p rows of
// an image; groups = ceil(splits / group); c % 4 == 0 (TMA row stride).
// The plan comes from ops/gram.py's gram_plan (smem_bytes is 0 for the
// IEEE mode, whose shared memory is static).
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
      gram_ieee_kernel<<<grid, kConsumers, 0, s>>>(f, args);
      return static_cast<int>(cudaGetLastError());
    case 1:
      return launch_tc<true>(f, args, batch, grid, smem_bytes, s);
    case 2:
      return launch_tc<false>(f, args, batch, grid, smem_bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
