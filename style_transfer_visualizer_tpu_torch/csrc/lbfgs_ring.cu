// The L-BFGS compact direction's two passes over the bf16 curvature
// ring (engine/optimizers._compact_direction), on Hopper:
//
//   lbfgs_ring_products_kernel: with S and Y the ring's (m, n) bf16
//     pairs and g the fp32 gradient rounded to bf16 (to nearest even,
//     as grad.to(bfloat16)), the four products in slot order, fp32:
//       sy = S Y^T (m x m), yy = Y Y^T (m x m), p = S g, q = Y g (m).
//   lbfgs_ring_combine_kernel: with cs, cy the fp32 coefficient
//     m-vectors rounded to bf16 and gamma = h_diag read on the device,
//       d = -((gamma g + sum_a cs_a S_a) - gamma sum_a cy_a Y_a).
//
// They replace no Pallas kernel: the JAX package writes these products
// as dot_general of the bf16 ring with preferred_element_type f32
// (style_transfer_visualizer_tpu/engine/optimizers.py,
// _compact_direction) and leaves them to XLA. Each product of two bf16
// values is exact in fp32, so bf16 tensor-core products with fp32 sums
// are that definition's literal form; no fp32 copy of the ring is made.
// The m x m stage between the two passes (masks, two triangular solves)
// and, on a mesh, the one sum of the four partials over the ranks stay
// in PyTorch.
//
// Bound on the H100 SXM: both passes read the whole ring, 2 m n bf16;
// the products do 4 m (m + 1) n flops on it, 101 flops a ring byte at
// m = 100, under the 295 a byte at which the bf16 tensor cores, not the
// memory, would bound it. So each pass is bound by bytes: at 512x512 (n
// = 786,432, m = 100) 314.6 MB of ring, 0.094 ms at 3.35 TB/s.
//
// Products design: C = [S; Y] [Y; g]^T, 2m x (m + 1), one block tile of
// 224 x 104 (seven warps, each 2 m16 row tiles by 13 n8 column tiles of
// mma.sync m16n8k16 bf16) covers m <= 103 whole. Then the block loads
// S, Y and g of its column range once and reads [Y; g]'s rows from the
// Y rows of its own [S; Y] slab: each ring byte crosses HBM once and
// shared memory once. (A work item of one 64-row tile and all 104
// columns would read [Y; g] four times, three of them from L2.) A
// larger m takes a grid of such tiles, each loading its own rows.
//   - The ring's columns are split over the blocks (about one block an
//     SM, whole stages of 64 columns each), streamed through a ring of
//     4 shared-memory stages by cp.async (16-byte copies; a column past
//     n is zero-filled), rows of 128 bytes with the 16-byte chunks
//     XOR-swizzled by the row so that ldmatrix reads are conflict-free.
//     Where n % 8 != 0 (row starts off 16 bytes) or a pointer is not
//     16-byte aligned, the same stages are filled by plain 2-byte loads.
//   - g arrives as fp32 in a slot of its own and is rounded to bf16 into
//     its row of [Y; g] one stage ahead, so that a stage costs one
//     barrier and every fragment is one ldmatrix: the loop waits for
//     stages k and k + 1, rounds k + 1's g and computes k while two more
//     stages load. The rows of [S; Y] and [Y; g] past the last are never
//     loaded; they feed only outputs that are never written.
//   - fp32-faithful sums: the tensor core's own fp32 accumulation
//     truncates, and the m x m solves amplify a bias (a ring's condition
//     number reaches 3e6), so each 16-column step's product goes to a
//     fresh register tile that is added to the running sum in rounded
//     fp32, as conv3x3.cu does.
//   - The partial tiles of the column splits are summed in a fixed order
//     without float atomics, as in gram.cu: each block writes its tile
//     to the workspace in fragment order; the splits form groups, the
//     last block of a group to arrive (self-resetting arrival counters)
//     sums the group's partials in split order, and the last group sums
//     the group tiles in group order and writes the four outputs. So a
//     style's result depends only on (m, n) and the card's SM count, not
//     on the run, a graph replay or the batch.
//
// Combine design: each thread takes 8 consecutive columns (16-byte loads
// of each ring row), accumulates cs_a S_a and cy_a Y_a in fp32 in slot
// order a = 0..m-1, and writes d once: the ring's bytes plus 2 x 4 n.
//
// Both launch on the caller's stream, allocate nothing and read nothing
// back to the host, so a CUDA graph captures them. Each run adds one to
// its launch counter (count_launch).
#include <cuda_bf16.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::count_launch;
using tf32x3::smem_u32;

constexpr int kWarps = 7;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpM = 2;                       // m16 tiles a warp
constexpr int kTileM = kWarps * kWarpM * 16;    // 224 rows of [S; Y]
constexpr int kTN = 13;                         // n8 tiles
constexpr int kTileN = kTN * 8;                 // 104 rows of [Y; g]
constexpr int kStageK = 64;                     // ring columns a stage
constexpr int kRowBytes = kStageK * 2;          // one bf16 row: 128 bytes
constexpr int kChunks = kRowBytes / 16;         // 16-byte chunks a row
constexpr int kStages = 4;
constexpr int kSlabA = kTileM * kRowBytes;
constexpr int kSlabB = kTileN * kRowBytes;
constexpr int kSlabG = kStageK * 4;
// A block tile's partial in fragment order: (warp, mt, nt, lane, 4).
constexpr int kFragFloats = kWarps * kWarpM * kTN * 32 * 4;
constexpr int kProductsSmem =
    kStages * (kSlabA + kSlabB + kSlabG) + 16;  // + the arrival flag

struct ProductsArgs {
  const __nv_bfloat16* s;  // (m, n)
  const __nv_bfloat16* y;  // (m, n)
  const float* g;          // (n,)
  float* out;              // sy (m, m), yy (m, m), p (m), q (m)
  float* ws;               // (tiles, splits + groups, kFragFloats)
  int* counters;           // (tiles, groups + 1), 0 between calls
  long long n;
  int m, tiles_b, splits, stages_per_split, group, groups;
  unsigned long long* launches;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(row)));
}

// d = a b + c, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// Byte offset of the 16-byte chunk q (8 columns) of row r in a slab of
// kRowBytes rows: chunk q lands at q ^ (r % 8).
__device__ __forceinline__ int chunk_at(int r, int q) {
  return r * kRowBytes + ((q ^ (r & 7)) << 4);
}

// Eight ring values from column `col` of `row` into 16 bytes of shared
// memory, zero past n: one cp.async where the row is 16-byte aligned,
// else eight 2-byte loads.
template <bool kAligned>
__device__ __forceinline__ void load8(unsigned char* dst,
                                      const __nv_bfloat16* row,
                                      long long col, long long n) {
  if constexpr (kAligned) {
    // n % 8 == 0: the chunk is whole or wholly past n.
    cp_async16(dst, col < n ? row + col : row, col < n ? 16 : 0);
  } else {
    const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long c = col + 2 * e;
      const uint32_t lo = c < n ? __ldg(r + c) : 0u;
      const uint32_t hi = c + 1 < n ? __ldg(r + c + 1) : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Four fp32 values of g from column `col`, zero past n.
template <bool kAligned>
__device__ __forceinline__ void load4f(unsigned char* dst, const float* g,
                                       long long col, long long n) {
  if constexpr (kAligned) {
    cp_async16(dst, col < n ? g + col : g, col < n ? 16 : 0);
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = col + e < n ? __ldg(g + col + e) : 0.f;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

using Acc = float[kWarpM][kTN][4];

// Index in a tile's fragment-order partial of this thread's (mt, nt).
__device__ __forceinline__ int frag_index(int warp, int lane, int mt,
                                          int nt) {
  return (((warp * kWarpM + mt) * kTN + nt) * 32 + lane) * 4;
}

// acc = the sum of `count` fragment-order tiles at `src`, in index order
// (one m16 tile's fragments at a time: 13 loads a thread in flight).
__device__ __forceinline__ void sum_tiles(const float* src, int count,
                                          Acc& acc, int warp, int lane) {
#pragma unroll
  for (int mt = 0; mt < kWarpM; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int t = 0; t < count; ++t) {
      const float* tile = src + static_cast<long long>(t) * kFragFloats;
#pragma unroll
      for (int nt = 0; nt < kTN; ++nt) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            tile + frag_index(warp, lane, mt, nt)));
        acc[mt][nt][0] += x.x;
        acc[mt][nt][1] += x.y;
        acc[mt][nt][2] += x.z;
        acc[mt][nt][3] += x.w;
      }
    }
  }
}

__device__ __forceinline__ void store_tile(float* dst, const Acc& acc,
                                           int warp, int lane) {
#pragma unroll
  for (int mt = 0; mt < kWarpM; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTN; ++nt)
      *reinterpret_cast<float4*>(dst + frag_index(warp, lane, mt, nt)) =
          make_float4(acc[mt][nt][0], acc[mt][nt][1], acc[mt][nt][2],
                      acc[mt][nt][3]);
}

// One ticket from `counter`: true in the block that arrives
// `expected`-th (and last); that block sets the counter back to 0.
__device__ __forceinline__ bool last_to_arrive(int* counter, int expected,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// The block tile's sums into sy, yy, p and q: element (r, c) of
// [S; Y] [Y; g]^T, r < 2m and c <= m, lands in one of the four.
__device__ __forceinline__ void write_outputs(const ProductsArgs& args,
                                              const Acc& acc, int a0, int b0,
                                              int warp, int lane) {
  const int m = args.m;
  const long long mm = static_cast<long long>(m) * m;
  float* sy = args.out;
  float* yy = sy + mm;
  float* p = yy + mm;
  float* q = p + m;
#pragma unroll
  for (int mt = 0; mt < kWarpM; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = a0 + (warp * kWarpM + mt) * 16 + (lane >> 2) +
                      (e >> 1) * 8;
        const int c = b0 + nt * 8 + (lane & 3) * 2 + (e & 1);
        if (r >= 2 * m || c > m) continue;
        float* dst;
        if (r < m) {
          dst = c < m ? sy + static_cast<long long>(r) * m + c : p + r;
        } else {
          dst = c < m ? yy + static_cast<long long>(r - m) * m + c
                      : q + (r - m);
        }
        *dst = acc[mt][nt][e];
      }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
    lbfgs_ring_products_kernel(const ProductsArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* slab_a = smem;
  unsigned char* slab_b = slab_a + kStages * kSlabA;
  unsigned char* slab_g = slab_b + kStages * kSlabB;
  int* flag = reinterpret_cast<int*>(slab_g + kStages * kSlabG);
  count_launch(args.launches);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m = args.m;
  const long long n = args.n;
  const int split = blockIdx.x;
  const int tile = blockIdx.y;
  const int a0 = (tile / args.tiles_b) * kTileM;
  const int b0 = (tile % args.tiles_b) * kTileN;
  // One tile covers every row: [Y; g]'s Y rows are the slab's rows m..
  const bool alias = gridDim.y == 1;
  const int rows_a = min(kTileM, 2 * m - a0);
  const int rows_b = alias ? 0 : max(0, min(kTileN, m - b0));
  const bool has_g = b0 <= m && m < b0 + kTileN;
  // Smem row of [Y; g] row c (the g row m included, rounded to bf16
  // there; the rows past it are not loaded and feed only columns that
  // are never written).
  const int b_shift = alias ? m : -b0;

  const long long stages_total = (n + kStageK - 1) / kStageK;
  const long long first = static_cast<long long>(split) *
                          args.stages_per_split;
  const int count = static_cast<int>(
      min(static_cast<long long>(args.stages_per_split),
          stages_total - first));

  auto load_stage = [&](int slot, int k) {
    const long long col0 = (first + k) * kStageK;
    unsigned char* a = slab_a + slot * kSlabA;
#pragma unroll 1
    for (int i = tid; i < rows_a * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int q = i % kChunks;
      const int vr = a0 + r;
      const __nv_bfloat16* row =
          vr < m ? args.s + static_cast<long long>(vr) * n
                 : args.y + static_cast<long long>(vr - m) * n;
      load8<kAligned>(a + chunk_at(r, q), row, col0 + q * 8, n);
    }
    unsigned char* b = slab_b + slot * kSlabB;
#pragma unroll 1
    for (int i = tid; i < rows_b * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int q = i % kChunks;
      load8<kAligned>(b + chunk_at(r, q),
                      args.y + static_cast<long long>(b0 + r) * n,
                      col0 + q * 8, n);
    }
    if (has_g && tid < kStageK / 4) {
      load4f<kAligned>(slab_g + slot * kSlabG + tid * 16, args.g,
                       col0 + tid * 4, n);
    }
  };
  // The stage's g, arrived as fp32, into its bf16 row of [Y; g].
  auto round_g = [&](int slot) {
    if (!has_g || tid >= kStageK / 8) return;
    const float4* src =
        reinterpret_cast<const float4*>(slab_g + slot * kSlabG) + 2 * tid;
    const float4 lo = src[0];
    const float4 hi = src[1];
    unsigned char* b = alias ? slab_a + slot * kSlabA : slab_b + slot * kSlabB;
    *reinterpret_cast<uint4*>(b + chunk_at(m + b_shift, tid)) =
        make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                   pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
  };

  // This lane's ldmatrix rows: of its warp's first m16 tile (the chunk
  // swizzle is that of the row's low 3 bits, the same in every tile), and
  // of the first n8 tile of [Y; g].
  const int a_row = warp * kWarpM * 16 + (lane & 15);
  const int b_row = b0 + b_shift + (lane & 7);

  Acc acc;
#pragma unroll
  for (int mt = 0; mt < kWarpM; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // Stage k's g row is rounded one iteration ahead, once its copy has
  // landed, so that a stage needs one barrier: the loop waits for
  // stages k and k + 1 and computes k while kStages - 2 more load.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  round_g(0);
  for (int k = 0; k < count; ++k) {
    cp_async_wait<kStages - 3>();
    __syncthreads();
    const int next = k + kStages - 1;
    if (next < count) load_stage(next % kStages, next);
    cp_async_commit();
    if (k + 1 < count) round_g((k + 1) % kStages);

    const int slot = k % kStages;
    const unsigned char* a = slab_a + slot * kSlabA + a_row * kRowBytes;
    const unsigned char* b =
        (alias ? slab_a + slot * kSlabA : slab_b + slot * kSlabB) +
        b_row * kRowBytes;
    // Two 16-column steps unrolled at a time: the whole stage at once
    // leaves the compiler short of registers.
#pragma unroll 2
    for (int kk = 0; kk < kStageK / 16; ++kk) {
      // A fragments of this warp's m16 tiles for this 16-column step.
      uint32_t af[kWarpM][4];
#pragma unroll
      for (int mt = 0; mt < kWarpM; ++mt) {
        ldmatrix_x4(af[mt], a + mt * 16 * kRowBytes +
                                (((kk * 2 + (lane >> 4)) ^ (lane & 7)) << 4));
      }
#pragma unroll
      for (int nt = 0; nt < kTN; ++nt) {
        uint32_t bf[2];
        ldmatrix_x2(bf, b + nt * 8 * kRowBytes +
                            (((kk * 2 + ((lane >> 3) & 1)) ^ (b_row & 7))
                             << 4));
#pragma unroll
        for (int mt = 0; mt < kWarpM; ++mt) {
          // Each 16-column step's products in a fresh tile, added to
          // the running sum in rounded fp32.
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, af[mt], bf[0], bf[1], d);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[e];
        }
      }
    }
  }
  cp_async_wait<0>();

  if (args.splits == 1) {
    write_outputs(args, acc, a0, b0, warp, lane);
    return;
  }
  // ---- the fixed-order sum of the splits' partial tiles
  float* ws = args.ws + static_cast<long long>(tile) *
                            (args.splits + args.groups) * kFragFloats;
  store_tile(ws + static_cast<long long>(split) * kFragFloats, acc, warp,
             lane);
  const int gi = split / args.group;
  const int lo = gi * args.group;
  const int members = min(args.group, args.splits - lo);
  int* counters = args.counters + tile * (args.groups + 1);
  if (!last_to_arrive(counters + gi, members, flag)) return;
  sum_tiles(ws + static_cast<long long>(lo) * kFragFloats, members, acc,
            warp, lane);
  if (args.groups > 1) {
    store_tile(ws + static_cast<long long>(args.splits + gi) * kFragFloats,
               acc, warp, lane);
    if (!last_to_arrive(counters + args.groups, args.groups, flag)) return;
    sum_tiles(ws + static_cast<long long>(args.splits) * kFragFloats,
              args.groups, acc, warp, lane);
  }
  write_outputs(args, acc, a0, b0, warp, lane);
}

constexpr int kCombineThreads = 256;

struct CombineArgs {
  const __nv_bfloat16* s;  // (m, n)
  const __nv_bfloat16* y;  // (m, n)
  const float* g;          // (n,)
  const float* coeff_s;    // (m,)
  const float* coeff_y;    // (m,)
  const float* gamma;      // h_diag, one float
  float* d;                // (n,)
  long long n;
  int m;
  unsigned long long* launches;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[0..1] += c * the two bf16 values packed in `w` (low half first).
__device__ __forceinline__ void fma_pair(uint32_t w, float c, float* acc) {
  acc[0] = fmaf(c, __uint_as_float(w << 16), acc[0]);
  acc[1] = fmaf(c, __uint_as_float(w & 0xFFFF0000u), acc[1]);
}

// -((gamma g + s) - gamma y), rounded step by step as the plain version.
__device__ __forceinline__ float direction_of(float gamma, float g, float s,
                                              float y) {
  return -__fsub_rn(__fadd_rn(__fmul_rn(gamma, g), s), __fmul_rn(gamma, y));
}

// kVec 8: eight columns a thread, 16-byte loads (n % 8 == 0, aligned
// pointers); kVec 1: one column a thread, 2-byte loads.
template <int kVec>
__global__ void __launch_bounds__(kCombineThreads)
    lbfgs_ring_combine_kernel(const CombineArgs args) {
  __shared__ float cs[kCombineThreads];
  __shared__ float cy[kCombineThreads];
  count_launch(args.launches);
  const long long n = args.n;
  const long long j0 =
      (static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x) *
      kVec;
  const bool in = j0 < n;
  float acc_s[kVec];
  float acc_y[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc_s[e] = acc_y[e] = 0.f;

  for (int base = 0; base < args.m; base += kCombineThreads) {
    const int rows = min(kCombineThreads, args.m - base);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < rows) {
      cs[threadIdx.x] = bf16_round(args.coeff_s[base + threadIdx.x]);
      cy[threadIdx.x] = bf16_round(args.coeff_y[base + threadIdx.x]);
    }
    __syncthreads();
    if (!in) continue;
    const __nv_bfloat16* srow = args.s + static_cast<long long>(base) * n + j0;
    const __nv_bfloat16* yrow = args.y + static_cast<long long>(base) * n + j0;
#pragma unroll 4
    for (int a = 0; a < rows; ++a, srow += n, yrow += n) {
      if constexpr (kVec == 8) {
        const uint4 sv = __ldcs(reinterpret_cast<const uint4*>(srow));
        const uint4 yv = __ldcs(reinterpret_cast<const uint4*>(yrow));
        fma_pair(sv.x, cs[a], acc_s);
        fma_pair(sv.y, cs[a], acc_s + 2);
        fma_pair(sv.z, cs[a], acc_s + 4);
        fma_pair(sv.w, cs[a], acc_s + 6);
        fma_pair(yv.x, cy[a], acc_y);
        fma_pair(yv.y, cy[a], acc_y + 2);
        fma_pair(yv.z, cy[a], acc_y + 4);
        fma_pair(yv.w, cy[a], acc_y + 6);
      } else {
        acc_s[0] = fmaf(cs[a], __bfloat162float(*srow), acc_s[0]);
        acc_y[0] = fmaf(cy[a], __bfloat162float(*yrow), acc_y[0]);
      }
    }
  }
  if (!in) return;
  const float gamma = __ldg(args.gamma);
  if constexpr (kVec == 8) {
    const float4* g = reinterpret_cast<const float4*>(args.g + j0);
    float4* d = reinterpret_cast<float4*>(args.d + j0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 gv = __ldcs(g + h);
      const int e = 4 * h;
      d[h] = make_float4(
          direction_of(gamma, gv.x, acc_s[e], acc_y[e]),
          direction_of(gamma, gv.y, acc_s[e + 1], acc_y[e + 1]),
          direction_of(gamma, gv.z, acc_s[e + 2], acc_y[e + 2]),
          direction_of(gamma, gv.w, acc_s[e + 3], acc_y[e + 3]));
    }
  } else {
    args.d[j0] = direction_of(gamma, args.g[j0], acc_s[0], acc_y[0]);
  }
}

template <bool kAligned>
int launch_products(const ProductsArgs& args, int tiles,
                    cudaStream_t stream) {
  const auto kernel = lbfgs_ring_products_kernel<kAligned>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kProductsSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(static_cast<unsigned>(args.splits),
                  static_cast<unsigned>(tiles));
  kernel<<<grid, kThreads, kProductsSmem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The four products of one style's ring on `stream`: `out` holds 2 m m
// + 2 m floats (sy, yy, p, q in that order). The plan comes from
// ops/lbfgs_ring.py's products_plan: a grid of `splits` column ranges of
// `stages_per_split` 64-column stages by tiles_a x tiles_b block tiles
// (224 rows of [S; Y] by 104 of [Y; g]); the splits' partials are
// summed in groups of `group`. With splits > 1 `ws` holds tiles_a *
// tiles_b * (splits + groups) * 23296 floats and `counters` tiles_a *
// tiles_b * (groups + 1) zeroed ints, left zeroed. `aligned`: n % 8 ==
// 0 and s, y and g 16-byte aligned. Returns 0 or a cudaError_t.
extern "C" int lbfgs_ring_products(const void* s, const void* y,
                                   const float* g, float* out, float* ws,
                                   int* counters, long long n, int m,
                                   int tiles_a, int tiles_b, int splits,
                                   int stages_per_split, int group,
                                   int aligned,
                                   unsigned long long* launches, int device,
                                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (m < 1 || n < 1 || splits < 1 || group < 1 || tiles_a < 1 ||
      tiles_b < 1 || 2 * m > tiles_a * kTileM || m + 1 > tiles_b * kTileN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ProductsArgs args{static_cast<const __nv_bfloat16*>(s),
                          static_cast<const __nv_bfloat16*>(y),
                          g,
                          out,
                          ws,
                          counters,
                          n,
                          m,
                          tiles_b,
                          splits,
                          stages_per_split,
                          group,
                          (splits + group - 1) / group,
                          launches};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return aligned ? launch_products<true>(args, tiles_a * tiles_b, st)
                 : launch_products<false>(args, tiles_a * tiles_b, st);
}

// d = -((gamma g + cs S) - gamma cy Y) on `stream`, cs and cy rounded
// to bf16, gamma read from the device. `aligned`: n % 8 == 0 and s, y,
// g and d 16-byte aligned. Returns 0 or a cudaError_t.
extern "C" int lbfgs_ring_combine(const void* s, const void* y,
                                  const float* g, const float* coeff_s,
                                  const float* coeff_y, const float* gamma,
                                  float* d, long long n, int m, int aligned,
                                  unsigned long long* launches, int device,
                                  void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const CombineArgs args{static_cast<const __nv_bfloat16*>(s),
                         static_cast<const __nv_bfloat16*>(y),
                         g,
                         coeff_s,
                         coeff_y,
                         gamma,
                         d,
                         n,
                         m,
                         launches};
  const int vec = aligned ? 8 : 1;
  const long long per_block = static_cast<long long>(kCombineThreads) * vec;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned) {
    lbfgs_ring_combine_kernel<8><<<grid, kCombineThreads, 0, st>>>(args);
  } else {
    lbfgs_ring_combine_kernel<1><<<grid, kCombineThreads, 0, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
