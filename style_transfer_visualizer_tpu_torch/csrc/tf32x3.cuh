// Shared building blocks of the port's tensor-core kernels (conv3x3.cu,
// conv3x3_tf32.cu, gram.cu) for Hopper (sm_90a), in their two
// tensor-core modes: 3xTF32 and TF32. (The IEEE fp32 mode runs on the
// CUDA cores: conv3x3_ieee.cu, and gram.cu's gram_ieee_kernel.)
//
// 3xTF32: an fp32 operand a is split into a_hi = tf32(a) and
// a_lo = tf32(a - a_hi), both rounded to nearest with ties away (as
// cvt.rna), so a_lo holds the bits a_hi drops. A product is
// a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, each term on the tensor cores
// (wgmma, tf32 inputs, fp32 accumulators); the dropped a_lo*b_lo is
// below fp32's last bit. The result keeps about 21 bits of mantissa.
// TF32: the one product tf32(a)*tf32(b) (tf32 rounded to nearest, ties
// away, as the split's hi), exact in fp32, accumulated in fp32: about
// 11 bits of each operand, the `default` precision tier.
//
// Here: the split, the mbarrier and TMA wrappers, the wgmma wrappers
// (m64nNk8, A from registers or from shared memory, B K-major in shared
// memory with the 128-byte swizzle) and the host's tensor-map set-up.
// wgmma takes tf32 operands K-major only: the transpose bits exist for
// 16-bit types. A tf32 operand in shared memory is read as its top 19
// bits (truncated), so a kernel rounds it there first.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

// Rows of 32 fp32 values (128 bytes) are the unit of every TMA box and
// of the 128-byte swizzle: the 16-byte chunk q of row r of a
// 1024-byte-aligned tile lands at chunk q ^ (r % 8).
constexpr int kRowFloats = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset in floats of element (row, col) of a 128-byte-swizzled tile
// whose rows hold 32 floats.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kRowFloats + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

// tf32(x), rounded to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives, in two integer operations on the bits (half
// of TF32's last place added to the magnitude, the 13 dropped bits
// cleared) instead of a conversion, which issues at a quarter of the
// integer rate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// One more run of this kernel in `*launches`: thread 0 of block (0, 0,
// 0) adds one, so the device counts every launch, each replay of a
// CUDA graph that holds it included.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0) {
    atomicAdd(launches, 1ULL);
  }
}

// ---- mbarriers
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// never ends (a bug) traps after some seconds instead of hanging the
// card: the launch then fails with an error the wrapper raises.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` (1..15) over `count` threads, warps of one role only.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Registers per thread of the calling warpgroup, moved between roles
// of a warp-specialized block (all four warps execute it).
template <int R>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// ---- TMA loads into shared memory, completion on `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma
// Descriptor of a K-major operand tile in shared memory: rows of 128
// bytes (32 tf32 along K), 128-byte swizzle, 8-row groups 1024 bytes
// apart. The k8 slice kk of the 32 starts 32*kk bytes further: add 2*kk
// to the descriptor. The swizzle is a function of the address (chunk
// bits 4-6 XOR row bits 7-9, as TMA writes it), so a tile may start at
// any 128-byte row of a 1024-byte-aligned buffer, as the conv's taps
// do; the matrix-base-offset field stays 0 (a phase there is applied on
// top of the address's and reads the wrong chunks: measured on the
// H100).
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= uint64_t{1} << 16;           // leading offset (unused when swizzled)
  d |= uint64_t{1024 >> 4} << 32;   // stride offset: 8 rows of 128 bytes
  d |= uint64_t{1} << 62;           // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across
// the asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep a K step's A fragments (4 k8 slices) in their registers until
// the wait that retires the wgmma group reading them: the compiler takes
// the asynchronous read as done when the instruction issues.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kk][e])::"memory");
  }
}

// D(64 x N, fp32) += A(64 x 8, tf32, registers) * B(N x 8, tf32,
// K-major in shared memory). A's fragment: thread t of the warpgroup
// holds rows 16*(t/32) + (t%32)/4 (+8) and columns t%4 (+4), in the
// order (r, c), (r+8, c), (r, c+4), (r+8, c+4). D's: n8 block j holds
// (r, 8j + 2(t%4) + {0,1}) then (r+8, same).
__device__ __forceinline__ void mma_n8(float (&d)[4],
                                       const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void mma_n64(float (&d)[32],
                                       const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void mma_n128(float (&d)[64],
                                       const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// scale_d = 0 overwrites D instead of adding to it.
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4],
                                    uint64_t desc_b, int scale_d) {
  if constexpr (N == 8) {
    mma_n8(d, a, desc_b, scale_d);
  } else if constexpr (N == 64) {
    mma_n64(d, a, desc_b, scale_d);
  } else {
    static_assert(N == 128, "wgmma widths built: 8, 64, 128");
    mma_n128(d, a, desc_b, scale_d);
  }
}

// D(64 x N, fp32) += A(64 x 8, tf32) * B(N x 8, tf32), both K-major
// in shared memory (descriptors); D's fragment as in mma_n8.
__device__ __forceinline__ void mma_ss_n8(float (&d)[4], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t desc_a,
                                       uint64_t desc_b, int scale_d) {
  if constexpr (N == 8) {
    mma_ss_n8(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 64) {
    mma_ss_n64(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 128, "wgmma widths built: 8, 64, 128");
    mma_ss_n128(d, desc_a, desc_b, scale_d);
  }
}

// One 3xTF32 k8 step: D += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, small
// terms first; `fresh` starts D at the first product instead.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2],
                                     const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     uint64_t b_hi, uint64_t b_lo,
                                     bool fresh) {
  mma<N>(d, a_lo, b_hi, fresh ? 0 : 1);
  mma<N>(d, a_hi, b_lo, 1);
  mma<N>(d, a_hi, b_hi, 1);
}

// The tensor cores' fp32 sum does not round to nearest: each product
// added to a large accumulator loses up to an ulp of it. So a K step's
// twelve products go to a fresh tile, and the step's tile is added to
// the running sum in registers, rounded to nearest.
template <int R>
__device__ __forceinline__ void promote(float (&acc)[R],
                                        const float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += part[i];
}

#if defined(TF32X3_HOST)
// ---- host: tensor maps (the driver's encoder, reached through the
// runtime so the library needs no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Error code returned by the C entry points when a tensor map cannot
// be made (not a cudaError_t).
constexpr int kTensorMapError = 10000;

// A row-major fp32 tensor of `rank` dims (`dims` innermost first, byte
// `strides` of dims 1..rank-1), read in boxes `box` with the 128-byte
// swizzle and zero fill outside the tensor. Returns 0 or
// kTensorMapError + the driver's code.
inline int make_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kTensorMapError;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}
#endif  // TF32X3_HOST

}  // namespace tf32x3
