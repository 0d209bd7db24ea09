// micro_ops: the cost of the primitives a resampling kernel's inner loop is
// made of, as this card executes them. One __global__ function per
// primitive; each loads its block once, applies the primitive `reps` times
// with every application depending on the one before, and stores the
// result block. Every block of the grid (for a product, concat, the
// counted loop, the (8,128) mul, where and the (8,128) gather, every
// chain, two to eight of them a CUDA block) does the same work on the same
// inputs and stores the same values to the same output (a benign race;
// concat and the four warp-a-chain kernels store once a CUDA block), so
// time / (grid * reps)
// is the cost of one application with the launch and the loads amortised.
//
// Replaces micro_ops.py `bench` (the Pallas call) and the 14 kernel bodies
// of its `main`: mul on an (8,128) and a (64,128) tile; gather along axis
// 1 on both tiles; gather along axis 0; where; 8-fold concat; the f32
// products (64,128)@(128,128) and (8,128)@(128,128) (`k_mxu`, `k_mxu8`);
// dynamic roll; a counted loop; a predicated read-modify-write; a dynamic
// row slice; and the bicubic chunk-body composite (3 channels, 4
// horizontal + 4 vertical taps). The TPU bodies work on (8,128) vector
// registers and VMEM blocks; none of that layout carries over. Here a tile
// element lives in a register of the thread that owns it (element e =
// thread + j * 256; the (64,128) gather, the composite, concat and the
// warp-a-chain kernels assign theirs as their notes say), and whatever
// crosses threads goes through shared memory: a gather along axis 1 or 0
// is a shared-memory gather, the roll and the row slice read shared memory
// at an offset taken from the index block at run time, and the predicated
// update is a read-modify-write of shared memory under a run-time
// predicate.
//
// Bound of the 12 that are not products: none moves device memory worth
// naming (a few KB to 0.4 MB per block, resident in L1/L2 after the first
// block); each is bound by f32 instruction issue (mul, where, concat, loop:
// 33.5 T instructions a second, a lone add or multiply one, where's compare
// and predicated multiply two) or by shared memory (gathers, roll, slice,
// update, composite: 128 B a clock an SM, 33.5 TB/s, a store and each read
// of every value that crosses threads), whichever is larger
// (micro_ops_cuda.MicroOp).
//
// The products run on the tensor cores, as the TPU bodies run on the MXU:
// `wgmma` with TF32 operands, the only route to Hopper's tensor-core rate.
// One TF32 pass keeps 11 bits of each operand and misses the f32 gate
// (1e-5 of max|plain| a step) 8-10x over, so every product is three passes:
// v = hi + lo with hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi), and
// x @ b ~ x_lo @ b_hi + x_hi @ b_lo + x_hi @ b_hi, accumulated in f32 in
// that order (the two small terms first, then the large one), each term a
// pass over K = 128 in 16 k-steps of 8. The split operands are stored as
// rounded TF32 bit patterns, since wgmma would otherwise truncate the low
// 13 bits of an f32. b is split once a block, at load; x after every
// step. Bound: 3 * 2*M*N*K operations a step at 495 TFLOP/s (TF32, dense).
//
// (64,128)@(128,128): wgmma m64n128k8 with A (= x) in registers and B (=
// b) in shared memory. B must be K-major for TF32, so b is stored
// transposed (b^T, K contiguous) in 8x16-byte core matrices without
// swizzle, hi and lo 64 KB each. Inside each group of 8 k the stored rows
// are permuted (stored position p holds b row 2p for p < 4, 2(p-4)+1 for
// p >= 4): the accumulator fragment of step r (columns 2t, 2t+1 of each
// 8-column chunk) is then exactly the A fragment of step r+1 (k positions
// t, t+4), so a chain runs in registers with no shared-memory round trip
// for x and no barrier, 48 wgmma a step. A chain alone leaves the tensor
// cores idle while it splits its accumulators and while its last wgmma
// drains, so a block holds two chains (two of the grid's blocks), one a
// warpgroup, over the one b: neither waits for the other, and one's
// wgmma fill the other's split.
// (8,128)@(128,128): transposed, y^T = b^T x^T: two warpgroups, each an
// m64 half of b^T as the A operand, held in registers for the whole launch
// (hi and lo, 128 registers a thread), and x^T as the B operand, which is
// x's own row-major layout, split and written to one of two shared-memory
// buffers after every step (a fence to the async proxy and one block
// barrier a step; a step writes the buffer no wgmma is reading). The
// tensor cores keep no operand from one wgmma to the next, so every wgmma
// moves its slice of b^T in again: 128 KB a step, 2.5x the time of one
// chain's 3-pass operations at shared memory's 128 bytes a clock an SM.
// So a block runs four chains (four of the grid's blocks) in one B
// operand of 64 rows, x_hi of each chain then x_lo of each: b_hi meets
// all 64 rows in one wgmma m64n64k8 (hi.hi and hi.lo of every chain in
// its 8-column chunks) and b_lo meets the 32 x_hi rows in one m64n32k8,
// 32 wgmma a warpgroup a step for four chains, and y = (hi.lo + lo.hi) +
// hi.hi for each: b^T moves once for four chains. Between steps the
// tensor cores wait for the split, the stores and the barrier; nothing
// else feeds them.
// b_hi + b_lo take 128 KB of shared memory (64 rows) or 128 registers a
// thread (8 rows): one block an SM. 2048 chains are 1024 blocks (7.8 waves
// over 132 SMs) or 512 (3.9 waves); the loads of b (64 KB from L2 a block)
// are not overlapped with another block's steps. A grid that is not a
// multiple of a block's chains computes the last block's spare chains too
// (same inputs, same values) and stores only the grid's.
//
// Loop-invariant shared-memory reads (axis-0 gather, roll, slice, update)
// go through volatile pointers, so that each application really reads;
// the dependent chain is kept alive by the store of its final value.
// Arithmetic that a plain version repeats in another order of rounding
// uses round-to-nearest intrinsics (no FMA contraction).
//
// Gather indices are masked to the tile (& 127, & 7), so an index out of
// range cannot read outside shared memory. where's indices address nothing:
// each is compared with the application's count, whatever its value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpgroup = 128;
constexpr int kLanes = 128;            // tile width
constexpr int kTile8 = 8 * kLanes;     // elements of an (8,128) tile
constexpr int kTile64 = 64 * kLanes;   // elements of a (64,128) tile

enum Op {
  kMul8 = 0, kMul64, kGatherLane8, kGatherLane64, kGatherSub8, kWhere,
  kConcat, kMatmul64, kMatmul8, kDynRoll, kLoop, kWhenRmw, kDynSlice,
  kChunk, kNumOps
};

// x = x * 1.0001, `reps` times; ROWS * 128 elements, ROWS / 2 a thread
// (the (64,128) tile; the (8,128) one is mul8_kernel).
template <int ROWS>
__global__ void mul_kernel(const float* __restrict__ a,
                           float* __restrict__ out, int reps) {
  constexpr int kPer = ROWS * kLanes / kThreads;
  float x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] = a[threadIdx.x + j * kThreads];
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) x[j] = __fmul_rn(x[j], 1.0001f);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = x[j];
}

// Keeps the compiler from hoisting what is decoded from `v` out of a loop:
// a packed index word is unpacked again in every application, not held
// unpacked in registers across the loop.
__device__ __forceinline__ void hold_u32(uint32_t& v) {
  asm volatile("" : "+r"(v));
}

// Hands `v` to an empty `asm volatile` and back: the compiler must compute
// it (nothing else may use it), cannot know what comes back (each call's 0
// is a 0 of its own), and moves no memory access across it (no read of a
// wgmma accumulator above the wait for the wgmma that writes it).
__device__ __forceinline__ void hold(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// Byte k of `w`, zero-extended (one PRMT).
__device__ __forceinline__ uint32_t byte_of(uint32_t w, int k) {
  return __byte_perm(w, 0u, 0x4440u + static_cast<uint32_t>(k));
}

// x[r, c] = x[r, idx[r, c]] + 0.5, `reps` times, over a (64,128) tile.
// A gather never leaves its row, so each warp owns whole rows: warp w rows
// 8w .. 8w+7, lane l their columns l, l+32, l+64, l+96. Only a warp's own
// lanes meet over a row, and a __syncwarp orders them. The tile lives in
// two shared-memory buffers: an application reads one and writes the
// other, so one __syncwarp a loop is the only barrier, as in
// gather_lane8_kernel. 64 KB a block: three blocks an SM. A
// loop's 32 reads of a thread are issued before its 32 stores: with each
// store right after its read, the same kernel ran slower than the
// block-synchronised one it replaces.
//
// What bounds it is shared memory's wavefronts. A warp-load of 32 lanes
// gathers 32 run-time indices of one 128-word row; lanes whose words share
// a bank take one wavefront each. For the seeded idx64 that is 710
// wavefronts a block-loop against the 256 of a conflict-free read, plus the
// 256 of the (conflict-free) store: 966 against the bound's 256
// (micro_ops_cuda.smem_wavefronts). Nothing is scheduled from idx: its
// indices stay unknown until run time, every loop.
constexpr int kRowsPerWarp64 = 64 / (kThreads / 32);
constexpr int kPerGather64 = kRowsPerWarp64 * kLanes / 32;
constexpr int kGather64Smem = 2 * kTile64 * 4;

__global__ void __launch_bounds__(kThreads, 3)
    gather_lane64_kernel(const float* __restrict__ a,
                         const int* __restrict__ idx,
                         float* __restrict__ out, int reps) {
  extern __shared__ __align__(16) float xs2[];   // [buffer][kTile64]
  const int lane = threadIdx.x & 31;
  const int base = (threadIdx.x >> 5) * kRowsPerWarp64 * kLanes + lane;
  int src[kPerGather64];   // element i: row i / 4, column lane + 32 (i % 4)
#pragma unroll
  for (int i = 0; i < kPerGather64; ++i) {
    const int e = base + (i >> 2) * kLanes + (i & 3) * 32;
    xs2[e] = a[e];
    src[i] = (e & ~(kLanes - 1)) + (idx[e] & (kLanes - 1));
  }
  __syncwarp();
  for (int r = 0; r < reps; ++r) {
    const float* from = xs2 + (r & 1) * kTile64;
    float* to = xs2 + ((r & 1) ^ 1) * kTile64;
    float v[kPerGather64];
#pragma unroll
    for (int i = 0; i < kPerGather64; ++i)
      v[i] = __fadd_rn(from[src[i]], 0.5f);
#pragma unroll
    for (int i = 0; i < kPerGather64; ++i)
      to[base + (i >> 2) * kLanes + (i & 3) * 32] = v[i];
    __syncwarp();
  }
  const float* last = xs2 + (reps & 1) * kTile64;
#pragma unroll
  for (int i = 0; i < kPerGather64; ++i) {
    const int e = base + (i >> 2) * kLanes + (i & 3) * 32;
    out[e] = last[e];
  }
}

// acc[r, c] += x[idx[r, c], c], `reps` times, over an (8,128) tile.
__global__ void gather_sub_kernel(const float* __restrict__ a,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, int reps) {
  constexpr int kPer = kTile8 / kThreads;
  __shared__ float xs[kTile8];
  int src[kPer];
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    xs[e] = a[e];
    src[j] = (idx[e] & 7) * kLanes + (e % kLanes);
    acc[j] = 0.0f;
  }
  __syncthreads();
  const volatile float* xv = xs;
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = __fadd_rn(acc[j], xv[src[j]]);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = acc[j];
}

// acc(64,128) += concat of 8 copies of x(8,128) along axis 0, `reps` times.
// Accumulator element e adds x[e mod 1024], so a thread that holds the x of
// its own elements needs no other thread and no shared memory: thread t of
// a warpgroup (4 warps) owns elements e = t + 128 j (j < 64), whose sources
// are x[t + 128 (j mod 8)], 8 values loaded once a block. An application is
// one FADD an accumulator element, in the plain order (acc + x).
//
// What bounds it then is f32 issue: 8192 FADD a chain-application. A block
// is two warpgroups, and each runs kConcatTurns of the grid's chains (grid
// blocks) in turn, so 2048 chains are 256 blocks of 8 warps: one wave of at
// most two blocks an SM (16 chains on the busiest SM against a mean of
// 15.5), x loaded 256 times, and one store of the (64,128) result a block,
// by the block's first chain (the function's output is that one block):
// 8 MB of stores where a store a chain wrote 64 MB to the same addresses.
// The other chains' final values go through `hold`, so no chain is dead
// code.
//
// Elements j and j + 8 of a thread add the same x from the same 0, and
// every turn repeats the last: the compiler could merge such chains or
// hoist a turn. Each accumulator's 0 therefore comes out of its own `hold`
// at the start of each turn, a value the compiler cannot know. The loops stay rolled (`#pragma unroll 1`), so the kernel holds
// exactly one FADD for each of a thread's 64 accumulator elements: a
// merged or dropped chain shows in `cuobjdump -sass` (chip_smoke.py).
constexpr int kConcatThreads = 2 * kWarpgroup;
constexpr int kConcatPer = kTile64 / kWarpgroup;     // 64 elements a thread
constexpr int kConcatSources = kTile8 / kWarpgroup;  // 8 x values a thread
constexpr int kConcatTurns = 4;
constexpr int kConcatChains = 2 * kConcatTurns;      // chains a block

__global__ void __launch_bounds__(kConcatThreads, 2)
    concat_kernel(const float* __restrict__ a, float* __restrict__ out,
                  int reps, int grid) {
  const int wg = threadIdx.x / kWarpgroup;
  const int t = threadIdx.x % kWarpgroup;
  float x[kConcatSources];
#pragma unroll
  for (int i = 0; i < kConcatSources; ++i) x[i] = a[t + kWarpgroup * i];
  float acc[kConcatPer];
  const int first = static_cast<int>(blockIdx.x) * kConcatChains + wg;
#pragma unroll 1
  for (int turn = 0; turn < kConcatTurns; ++turn) {
    if (first + 2 * turn >= grid) return;   // no barrier follows
#pragma unroll
    for (int j = 0; j < kConcatPer; ++j) {
      acc[j] = 0.0f;
      hold(acc[j]);
    }
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int j = 0; j < kConcatPer; ++j)
        acc[j] = __fadd_rn(acc[j], x[j % kConcatSources]);
    }
    if (wg == 0 && turn == 0) {
#pragma unroll
      for (int j = 0; j < kConcatPer; ++j) out[t + kWarpgroup * j] = acc[j];
    } else {
#pragma unroll
      for (int j = 0; j < kConcatPer; ++j) hold(acc[j]);
    }
  }
}

// ---- the products on the tensor cores (see the note at the top) ----------

constexpr int kKSteps = kLanes / 8;                    // k-steps of 8 a pass
constexpr uint32_t kCoreBytes = 128;                   // leading byte offset
constexpr uint32_t kGroupBytes = kLanes * 8 * 4;       // stride byte offset
constexpr int kProduct64Smem = 2 * kLanes * kLanes * 4;  // b^T hi + lo
constexpr int kChains64 = 2;    // chains (warpgroups) a 64-row block
constexpr int kChains8 = 4;     // chains an 8-row block
constexpr int kOperand8 = 2 * kChains8 * kTile8;   // x_hi rows, x_lo rows
constexpr int kProduct8Smem = 2 * kOperand8 * 4;   // two B operands

// f32 -> TF32 rounded to nearest, ties away from zero (low 13 bits 0).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v -> (hi, lo): hi its TF32 rounding, lo the TF32 rounding of v - hi.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// Element (row, k) of a K-major operand with K = 128 in shared memory,
// without swizzle: 8 rows x 4 k (16 bytes a row) make a 128-byte core
// matrix; core matrices follow along K every kCoreBytes, 8-row groups every
// kGroupBytes.
__device__ __forceinline__ int kmajor_offset(int row, int k) {
  return (row >> 3) * (kLanes * 8) + (k >> 2) * 32 + (row & 7) * 4 + (k & 3);
}

// The descriptor of such an operand at `p` (layout type 0: no swizzle); a
// k-step of 8 adds 256 bytes, 16 to the descriptor.
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(kCoreBytes >> 4) << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32);
}

// Stored position, inside its group of 8, of b's row q (64-row product).
__device__ __forceinline__ int stored_k(int q) {
  return (q >> 1) + 4 * (q & 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy stores to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d(64x128) = (accumulate ? d : 0) + A(64x8, TF32 registers) @ B(8x128,
// TF32, K-major in shared memory at desc_b).
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// d(64x32) = (accumulate ? d : 0) + A(64x8, TF32 registers) @ B(8x32,
// TF32, K-major in shared memory at desc_b).
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// d(64x64) = (accumulate ? d : 0) + A(64x8, TF32 registers) @ B(8x64,
// TF32, K-major in shared memory at desc_b).
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// x(64,128) = x @ b(128,128), `reps` times, one chain a warpgroup, chain
// kChains64 * block + warpgroup of the grid's `grid`. Thread (warp w, lane
// 4g + t) of a warpgroup holds its x's accumulator fragment: d[4j + h] is
// x[16w + g + 8 * (h >> 1)][8j + 2t + (h & 1)], which read in the order
// d[4j], d[4j+2], d[4j+1], d[4j+3] is the A fragment of k-step j against
// the permuted b^T (stored_k).
__global__ void __launch_bounds__(kChains64 * kWarpgroup, 1)
    tc_matmul64_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       int reps, int grid) {
  extern __shared__ __align__(128) float smem[];
  float* bh = smem;                      // b^T, TF32 hi
  float* bl = smem + kLanes * kLanes;    // b^T, TF32 lo
  for (int e = threadIdx.x; e < kLanes * kLanes; e += blockDim.x) {
    const int k = e / kLanes, n = e % kLanes;
    uint32_t hi, lo;
    split_tf32(b[e], hi, lo);
    const int off = kmajor_offset(n, (k & ~7) | stored_k(k & 7));
    bh[off] = __uint_as_float(hi);
    bl[off] = __uint_as_float(lo);
  }
  fence_async_shared();
  __syncthreads();
  // no barrier follows: a spare chain's warpgroup may leave
  if (static_cast<int>(blockIdx.x) * kChains64 +
          static_cast<int>(threadIdx.x / kWarpgroup) >= grid)
    return;

  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float d[64];
#pragma unroll
  for (int j = 0; j < kKSteps; ++j) {
    const float2 top =
        *reinterpret_cast<const float2*>(a + r0 * kLanes + 8 * j + c0);
    const float2 bot =
        *reinterpret_cast<const float2*>(a + (r0 + 8) * kLanes + 8 * j + c0);
    d[4 * j] = top.x;
    d[4 * j + 1] = top.y;
    d[4 * j + 2] = bot.x;
    d[4 * j + 3] = bot.y;
  }
  const uint64_t desc_h = smem_desc(bh), desc_l = smem_desc(bl);
  for (int r = 0; r < reps; ++r) {
    uint32_t xh[64], xl[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) split_tf32(d[i], xh[i], xl[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKSteps; ++j)   // x_lo @ b_hi
      wgmma_m64n128k8(d, xl[4 * j], xl[4 * j + 2], xl[4 * j + 1],
                      xl[4 * j + 3], desc_h + 16 * j, j > 0);
#pragma unroll
    for (int j = 0; j < kKSteps; ++j)   // + x_hi @ b_lo
      wgmma_m64n128k8(d, xh[4 * j], xh[4 * j + 2], xh[4 * j + 1],
                      xh[4 * j + 3], desc_l + 16 * j, 1);
#pragma unroll
    for (int j = 0; j < kKSteps; ++j)   // + x_hi @ b_hi
      wgmma_m64n128k8(d, xh[4 * j], xh[4 * j + 2], xh[4 * j + 1],
                      xh[4 * j + 3], desc_h + 16 * j, 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) hold(d[i]);
  }
#pragma unroll
  for (int j = 0; j < kKSteps; ++j) {
    *reinterpret_cast<float2*>(out + r0 * kLanes + 8 * j + c0) =
        make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (r0 + 8) * kLanes + 8 * j + c0) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// x(8,128) = x @ b(128,128), `reps` times, in kChains8 chains a block
// (chains kChains8 * block + c of the grid's `grid`), as y^T = b^T x^T:
// warpgroup h computes rows 64h .. 64h+63 of y^T (columns of y) for every
// chain. Thread (warp w, lane 4g + t) of it holds the A fragments of b^T's
// rows m = 64h + 16w + g and m + 8 for all 16 k-steps (k = 8j + t and
// 8j + t + 4), and gets y[2t][m], y[2t+1][m], y[2t][m+8], y[2t+1][m+8] of
// each chain from each step. The B operand lives in shared memory as
// K-major (row n, k) core matrices, two buffers of 64 rows: row 8c + i is
// row i of chain c's x_hi, row 8 * (kChains8 + c) + i that of its x_lo.
__global__ void __launch_bounds__(2 * kWarpgroup, 1)
    tc_matmul8_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ out,
                      int reps, int grid) {
  extern __shared__ __align__(128) float xs[];   // [buffer][kOperand8]
  if (reps == 0) {
    for (int e = threadIdx.x; e < kTile8; e += blockDim.x) out[e] = a[e];
    return;
  }
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int m = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                (lane >> 2);
  uint32_t bh[4 * kKSteps], bl[4 * kKSteps];
#pragma unroll
  for (int j = 0; j < kKSteps; ++j) {
    const float* row = b + (8 * j + t) * kLanes;
    split_tf32(row[m], bh[4 * j], bl[4 * j]);
    split_tf32(row[m + 8], bh[4 * j + 1], bl[4 * j + 1]);
    split_tf32(row[4 * kLanes + m], bh[4 * j + 2], bl[4 * j + 2]);
    split_tf32(row[4 * kLanes + m + 8], bh[4 * j + 3], bl[4 * j + 3]);
  }
  for (int e = threadIdx.x; e < kTile8; e += blockDim.x) {
    uint32_t hi, lo;
    split_tf32(a[e], hi, lo);
    const int n = e / kLanes, k = e % kLanes;
#pragma unroll
    for (int c = 0; c < kChains8; ++c) {
      xs[kmajor_offset(8 * c + n, k)] = __uint_as_float(hi);
      xs[kmajor_offset(8 * (kChains8 + c) + n, k)] = __uint_as_float(lo);
    }
  }
  fence_async_shared();
  __syncthreads();

  // chunk c of hh: b_hi^T @ x_hi^T of chain c; chunk kChains8 + c: b_hi^T
  // @ x_lo^T of chain c; chunk c of lh: b_lo^T @ x_hi^T of chain c
  float hh[8 * kChains8] = {};
  float lh[4 * kChains8] = {};
  float d[4 * kChains8];
  for (int r = 0; r < reps; ++r) {
    const uint64_t desc = smem_desc(xs + (r & 1) * kOperand8);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKSteps; ++j)   // all 64 rows
      wgmma_m64n64k8(hh, bh[4 * j], bh[4 * j + 1], bh[4 * j + 2],
                     bh[4 * j + 3], desc + 16 * j, j > 0);
#pragma unroll
    for (int j = 0; j < kKSteps; ++j)   // the 32 x_hi rows
      wgmma_m64n32k8(lh, bl[4 * j], bl[4 * j + 1], bl[4 * j + 2],
                     bl[4 * j + 3], desc + 16 * j, j > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 4 * kChains8; ++i) {
      hold(hh[i]);
      hold(hh[4 * kChains8 + i]);
      hold(lh[i]);
      d[i] = __fadd_rn(__fadd_rn(hh[4 * kChains8 + i], lh[i]), hh[i]);
    }
    if (r + 1 < reps) {
      float* next = xs + ((r & 1) ^ 1) * kOperand8;
#pragma unroll
      for (int i = 0; i < 4 * kChains8; ++i) {
        const int n = 8 * (i >> 2) + 2 * t + (i & 1);
        const int k = m + 8 * ((i >> 1) & 1);
        uint32_t hi, lo;
        split_tf32(d[i], hi, lo);
        next[kmajor_offset(n, k)] = __uint_as_float(hi);
        next[kmajor_offset(8 * kChains8 + n, k)] = __uint_as_float(lo);
      }
      fence_async_shared();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * kChains8; ++i)
    if (static_cast<int>(blockIdx.x) * kChains8 + (i >> 2) < grid)
      out[(2 * t + (i & 1)) * kLanes + m + 8 * ((i >> 1) & 1)] = d[i];
}

// acc[r, c] += x[r, (c - s) mod 128] with s = idx[0, 0] read at run time,
// `reps` times: a rotated shared-memory read.
__global__ void dyn_roll_kernel(const float* __restrict__ a,
                                const int* __restrict__ idx,
                                float* __restrict__ out, int reps) {
  constexpr int kPer = kTile8 / kThreads;
  __shared__ float xs[kTile8];
  const int shift = idx[0];
  int src[kPer];
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    xs[e] = a[e];
    src[j] = (e / kLanes) * kLanes + ((e % kLanes - shift) & (kLanes - 1));
    acc[j] = 0.0f;
  }
  __syncthreads();
  const volatile float* xv = xs;
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = __fadd_rn(acc[j], xv[src[j]]);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = acc[j];
}

// ---- a warp a chain: the counted loop, the (8,128) mul, where, gather ----
//
// One warp is a chain (one of the grid's blocks): lane l owns elements
// l + 32 j (j < 32) of the (8,128) tile, so each warp-load and warp-store is
// 32 consecutive elements. The loop over `reps` stays rolled (`#pragma
// unroll 1`): an application is 32 instructions a lane for the add or the
// multiply (where: 32 compares and 32 predicated multiplies), and the
// loop's counter, compare and branch, 3 instructions, are paid once a
// chain-application (with a chain in 8 warps they were paid 8 times). What
// bounds the first three is f32 issue: 1024 instructions a
// chain-application (where 2048) at 33.5 T a second (the gather: shared
// memory, its note says how). 2048 chains are 256 blocks of 8 warps,
// one wave of at most two blocks an SM (16 chains on the busiest SM against
// a mean of 15.5); a ragged last block's spare warps leave before their
// loop (no block barrier follows). One store of the (8,128) result a block, by
// its first warp; the other warps' final values go through `hold`, so no
// chain is dead code. Each kernel holds one FADD or FMUL for each of a
// thread's 32 elements: a merged or dropped chain shows in `cuobjdump
// -sass` (chip_smoke.py).
constexpr int kChainThreads = 256;
constexpr int kChains = kChainThreads / 32;   // chains (warps) a block
constexpr int kChainPer = kTile8 / 32;        // 32 elements a lane

__device__ __forceinline__ int chain_of(int warp) {
  return static_cast<int>(blockIdx.x) * kChains + warp;
}

// A lane's 32 elements of an (8,128) tile, one coalesced warp-load each.
template <typename T>
__device__ __forceinline__ void load_chain(T (&v)[kChainPer],
                                           const T* __restrict__ src,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < kChainPer; ++j) v[j] = src[lane + 32 * j];
}

// The block's one store, by warp 0; any other warp's values go through
// `hold`.
__device__ __forceinline__ void store_chain(float (&v)[kChainPer],
                                            float* __restrict__ out,
                                            int warp, int lane) {
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kChainPer; ++j) out[lane + 32 * j] = v[j];
  } else {
#pragma unroll
    for (int j = 0; j < kChainPer; ++j) hold(v[j]);
  }
}

// acc = x; acc += 1.0, `reps` times: the cost of one counted-loop
// iteration around a trivial body. The primitive is the iteration, so the
// loop stays rolled: one real iteration an application. 1024 FADD and 3
// loop instructions a chain-application.
__global__ void __launch_bounds__(kChainThreads, 2)
    loop_kernel(const float* __restrict__ a, float* __restrict__ out,
                int reps, int grid) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (chain_of(warp) >= grid) return;
  float acc[kChainPer];
  load_chain(acc, a, lane);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kChainPer; ++j) acc[j] = __fadd_rn(acc[j], 1.0f);
  }
  store_chain(acc, out, warp, lane);
}

// x = x * 1.0001, `reps` times, over an (8,128) tile (micro_ops.py k_mul
// at (8,128)): 1024 FMUL and 3 loop instructions a chain-application,
// each multiply rounded once (`__fmul_rn`), as torch's f32 multiply is.
__global__ void __launch_bounds__(kChainThreads, 2)
    mul8_kernel(const float* __restrict__ a, float* __restrict__ out,
                int reps, int grid) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (chain_of(warp) >= grid) return;
  float x[kChainPer];
  load_chain(x, a, lane);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kChainPer; ++j) x[j] = __fmul_rn(x[j], 1.0001f);
  }
  store_chain(x, out, warp, lane);
}

// x = (i == r) ? x : x * 1.0001 as one compare and one multiply under its
// predicate (ISETP, then @P FMUL; no select, FSEL), the compare made at
// every application against the index as it is: nothing assumes the
// indices lie in [0, 8). Written in C++ (the ternary or an `if`), nvcc
// 12.8 predicates the multiply as well, but turns each compare with the
// loop's count into a count-down of its own, i - r, kept a register an
// element: 32 more integer adds a lane an application, 96 instructions
// where 64 do. In PTX the compare stays a compare with r.
__device__ __forceinline__ void mul_unless(float& x, int i, int r) {
  asm("{\n"
      ".reg .pred p;\n"
      "setp.ne.s32 p, %1, %2;\n"
      "@p mul.rn.f32 %0, %0, %3;\n"
      "}\n"
      : "+f"(x)
      : "r"(i), "r"(r), "f"(1.0001f));
}

// x = where(idx == r, x, x * 1.0001) for r = 0 .. reps-1 over an (8,128)
// tile (micro_ops.py k_where): a lane holds its 32 values and their 32
// int32 indices in registers; 1024 ISETP, 1024 predicated FMUL and 3 loop
// instructions a chain-application (r lives in a uniform register), against
// a bound that counts the compare and the multiply of every element
// (2048).
__global__ void __launch_bounds__(kChainThreads, 2)
    where_kernel(const float* __restrict__ a, const int* __restrict__ idx,
                 float* __restrict__ out, int reps, int grid) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (chain_of(warp) >= grid) return;
  float x[kChainPer];
  int i[kChainPer];
  load_chain(x, a, lane);
  load_chain(i, idx, lane);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kChainPer; ++j) mul_unless(x[j], i[j], r);
  }
  store_chain(x, out, warp, lane);
}

// x[r, c] = x[r, idx[r, c]] + 0.5, `reps` times, over an (8,128) tile
// (micro_ops.py k_gather_lane8), a warp a chain: lane l owns columns l,
// l+32, l+64, l+96 of each of the 8 rows (load_chain's elements), so a row
// gather meets only the warp's own lanes, and the tile lives in two
// shared-memory buffers of the warp's own: an application reads one and
// writes the other, and one __syncwarp a loop is the only barrier (no
// block barrier). A lane holds its 32 values and their 32
// gather sources (in its own row, masked to it) in registers; a loop's 32
// reads are issued before its 32 stores, as in gather_lane64_kernel.
// Nothing is scheduled from idx: its indices stay unknown until run time.
// 2048 chains are 256 blocks of 8 warps, 8 KB a warp, 64 KB a block; a
// ragged last block's spare warps leave before their first __syncwarp.
// One store of the result a block, by warp 0 (store_chain). The loop stays
// rolled: 32 FADD a lane, one for each element (chip_smoke.py counts them
// in `cuobjdump -sass`, and no BAR).
//
// What bounds it is shared memory's wavefronts, as for the (64,128)
// gather: a warp-load gathers 32 run-time indices of one 128-word row, 90
// wavefronts a chain-loop for the seeded idx8 against the 32 of a
// conflict-free read, plus the 32 of the store: 122 against the bound's 64
// (micro_ops_cuda.block_loop_wavefronts), a ceiling of 52.5% of the bound.
constexpr int kGather8Smem = kChains * 2 * kTile8 * 4;

__global__ void __launch_bounds__(kChainThreads, 2)
    gather_lane8_kernel(const float* __restrict__ a,
                        const int* __restrict__ idx,
                        float* __restrict__ out, int reps, int grid) {
  extern __shared__ __align__(16) float g8[];   // [warp][buffer][kTile8]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (chain_of(warp) >= grid) return;   // before any __syncwarp
  float* xs = g8 + warp * 2 * kTile8;
  float v[kChainPer];
  int src[kChainPer];   // element j: row j / 4, column lane + 32 (j % 4)
  load_chain(v, a, lane);
  load_chain(src, idx, lane);
#pragma unroll
  for (int j = 0; j < kChainPer; ++j) {
    const int e = lane + 32 * j;
    xs[e] = v[j];
    src[j] = (e & ~(kLanes - 1)) + (src[j] & (kLanes - 1));
  }
  __syncwarp();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    const float* from = xs + (r & 1) * kTile8;
    float* to = xs + ((r & 1) ^ 1) * kTile8;
#pragma unroll
    for (int j = 0; j < kChainPer; ++j) v[j] = __fadd_rn(from[src[j]], 0.5f);
#pragma unroll
    for (int j = 0; j < kChainPer; ++j) to[lane + 32 * j] = v[j];
    __syncwarp();
  }
  store_chain(v, out, warp, lane);
}

// o = a; then `reps` times: if (block >= first_block) o += 1.0, as a
// read-modify-write of shared memory under a predicate known only at run
// time (first_block is an argument; the callers pass 0).
__global__ void when_rmw_kernel(const float* __restrict__ a,
                                float* __restrict__ out, int reps,
                                int first_block) {
  constexpr int kPer = kTile8 / kThreads;
  __shared__ float os[kTile8];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    os[e] = a[e];
  }
  volatile float* ov = os;
  for (int r = 0; r < reps; ++r) {
    if (static_cast<int>(blockIdx.x) >= first_block) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = threadIdx.x + j * kThreads;
        ov[e] = __fadd_rn(ov[e], 1.0f);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    out[e] = ov[e];
  }
}

// acc(8,128) += x(64,128)[((i + r) % 8) * 8 : +8, :] for r = 0 .. reps-1,
// i = idx[0, 0] read at run time: a shared-memory read at a row offset
// that changes every application.
__global__ void dyn_slice_kernel(const float* __restrict__ a,
                                 const int* __restrict__ idx,
                                 float* __restrict__ out, int reps) {
  constexpr int kPer = kTile8 / kThreads;
  __shared__ float xs[kTile64];
  for (int e = threadIdx.x; e < kTile64; e += kThreads) xs[e] = a[e];
  const int first = idx[0];
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;
  __syncthreads();
  const volatile float* xv = xs;
  for (int r = 0; r < reps; ++r) {
    const int base = ((first + r) & 7) * kTile8;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      acc[j] = __fadd_rn(acc[j], xv[base + threadIdx.x + j * kThreads]);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = acc[j];
}

// The bicubic chunk body, `reps` times over 3 channels: the channel's
// (8,128) window replicated to 64 rows and gathered along axis 1 through 4
// index tables with 4 weight tables (the horizontal taps) into ih(64,128)
// in shared memory; then for each of the 8 groups of 8 rows, 4 gathers
// along axis 0 within the group, of which row 0 is kept, times 4 weights
// (the vertical taps); the 8 result rows are added to acc(8,128).
// win (3,8,128); relb, wfb (4,64,128); ry, wv (4,8,8,128).
//
// The tap tables are the same in every loop and channel, and on the TPU
// they sit in VMEM for the whole body. Here they are read from device
// memory once a block and held in registers for the whole launch: thread
// t owns ih elements e = t + 512 j (j < 16), with their four 7-bit relb
// indices one a byte of one word and their four wfb weights; and acc
// elements t and t + 512, with the four 3-bit ry rows that the kept row
// reads (one a byte of one word) and their four wv weights: 90 registers
// of tables a thread at 512 threads a block (256 threads would need 180;
// 1024 would leave 19 of the 64 a thread may then have for the rest). The
// whole ih is computed every channel-loop, the work the composite prices.
// ih has two buffers, so one barrier a channel-loop orders its store
// before the vertical reads: the next channel-loop writes the other
// buffer. Window 12 KB + ih 2 x 32 KB: one block an SM.
//
// What bounds it then is shared memory's wavefronts: the horizontal
// gathers read 32 run-time indices of one 128-word window row a warp-load,
// 2,831 wavefronts a channel-loop for the seeded relb where a
// conflict-free read would take 1,024; the vertical gathers (128) and the
// ih store (256) are conflict-free. 3,215 against the bound's 1,152
// (micro_ops_cuda.smem_wavefronts). Rounding as the plain version:
// products rounded on their own, taps summed k = 0..3.
constexpr int kChunkThreads = 512;
constexpr int kChunkPerIh = kTile64 / kChunkThreads;
constexpr int kChunkPer = kTile8 / kChunkThreads;
constexpr int kChunkSmem = (3 * kTile8 + 2 * kTile64) * 4;

__global__ void __launch_bounds__(kChunkThreads, 1)
    chunk_kernel(const float* __restrict__ win, const int* __restrict__ relb,
                 const float* __restrict__ wfb, const int* __restrict__ ry,
                 const float* __restrict__ wv, float* __restrict__ out,
                 int reps) {
  extern __shared__ __align__(16) float chunk_smem[];
  float* ws = chunk_smem;                // the window, (3, 8, 128)
  float* ihs = chunk_smem + 3 * kTile8;  // ih, [buffer][kTile64]
  const int t = threadIdx.x;
  for (int e = t; e < 3 * kTile8; e += kChunkThreads) ws[e] = win[e];
  uint32_t hidx[kChunkPerIh];       // byte k: relb[k][e] & 127
  float hw[kChunkPerIh][4];         // wfb[k][e]
#pragma unroll
  for (int j = 0; j < kChunkPerIh; ++j) {
    const int e = t + j * kChunkThreads;
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      packed |= static_cast<uint32_t>(relb[k * kTile64 + e] & (kLanes - 1))
                << (8 * k);
      hw[j][k] = wfb[k * kTile64 + e];
    }
    hidx[j] = packed;
  }
  uint32_t vidx[kChunkPer];         // byte m: ry[m][group][0][col] & 7
  float vw[kChunkPer][4];           // wv[m][group][0][col]
  float acc[kChunkPer];
#pragma unroll
  for (int j = 0; j < kChunkPer; ++j) {
    const int e = t + j * kChunkThreads;
    uint32_t packed = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int off = (m * 8 + e / kLanes) * kTile8 + e % kLanes;
      packed |= static_cast<uint32_t>(ry[off] & 7) << (8 * m);
      vw[j][m] = wv[off];
    }
    vidx[j] = packed;
    acc[j] = 0.0f;
  }
  __syncthreads();
  int buf = 0;
  for (int r = 0; r < reps; ++r) {
    for (int ch = 0; ch < 3; ++ch) {
      const float* blk = ws + ch * kTile8;
      float* ih = ihs + buf * kTile64;
#pragma unroll
      for (int j = 0; j < kChunkPerIh; ++j) {
        const int e = t + j * kChunkThreads;
        const float* row = blk + ((e / kLanes) & 7) * kLanes;
        hold_u32(hidx[j]);
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float term = __fmul_rn(row[byte_of(hidx[j], k)], hw[j][k]);
          sum = (k == 0) ? term : __fadd_rn(sum, term);
        }
        ih[e] = sum;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kChunkPer; ++j) {
        const int e = t + j * kChunkThreads;
        const float* col = ih + (e / kLanes) * 8 * kLanes + e % kLanes;
        hold_u32(vidx[j]);
        float add = 0.0f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float term =
              __fmul_rn(col[byte_of(vidx[j], m) * kLanes], vw[j][m]);
          add = (m == 0) ? term : __fadd_rn(add, term);
        }
        acc[j] = __fadd_rn(acc[j], add);
      }
      buf ^= 1;
    }
  }
#pragma unroll
  for (int j = 0; j < kChunkPer; ++j) out[t + j * kChunkThreads] = acc[j];
}

cudaError_t launch_matmul64(const float* a, const float* b, float* out,
                            int reps, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tc_matmul64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kProduct64Smem);
  if (err != cudaSuccess) return err;
  tc_matmul64_kernel<<<(grid + kChains64 - 1) / kChains64,
                       kChains64 * kWarpgroup, kProduct64Smem, stream>>>(
      a, b, out, reps, grid);
  return cudaGetLastError();
}

cudaError_t launch_gather_lane8(const float* a, const int* idx, float* out,
                                int reps, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_lane8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGather8Smem);
  if (err != cudaSuccess) return err;
  gather_lane8_kernel<<<(grid + kChains - 1) / kChains, kChainThreads,
                        kGather8Smem, stream>>>(a, idx, out, reps, grid);
  return cudaGetLastError();
}

cudaError_t launch_gather_lane64(const float* a, const int* idx, float* out,
                                 int reps, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_lane64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGather64Smem);
  if (err != cudaSuccess) return err;
  gather_lane64_kernel<<<grid, kThreads, kGather64Smem, stream>>>(a, idx, out,
                                                                   reps);
  return cudaGetLastError();
}

cudaError_t launch_chunk(const float* win, const int* relb, const float* wfb,
                         const int* ry, const float* wv, float* out, int reps,
                         int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmem);
  if (err != cudaSuccess) return err;
  chunk_kernel<<<grid, kChunkThreads, kChunkSmem, stream>>>(
      win, relb, wfb, ry, wv, out, reps);
  return cudaGetLastError();
}

cudaError_t launch_matmul8(const float* a, const float* b, float* out,
                           int reps, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tc_matmul8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kProduct8Smem);
  if (err != cudaSuccess) return err;
  tc_matmul8_kernel<<<(grid + kChains8 - 1) / kChains8, 2 * kWarpgroup,
                      kProduct8Smem, stream>>>(a, b, out, reps, grid);
  return cudaGetLastError();
}

}  // namespace

// One primitive, `grid` blocks of 256 threads (the composite: 512; the
// products, concat, the counted loop, the (8,128) mul, where and the
// (8,128) gather: `grid` chains, kChains64, kChains8, kConcatChains or kChains a block), `reps`
// applications each.
// op: 0 mul (8,128) | 1 mul (64,128) | 2 gather axis 1 (8,128) | 3 gather
// axis 1 (64,128) | 4 gather axis 0 (8,128) | 5 where | 6 concat | 7
// product (64,128)@(128,128) | 8 product (8,128)@(128,128) | 9 dynamic
// roll | 10 counted loop | 11 predicated read-modify-write | 12 dynamic
// row slice | 13 chunk-body composite. in0..in4 are the op's inputs in the
// order of its Python wrapper (f32 values, int32 indices; unused ones
// null); out is the f32 result block. `param` is the first block that
// updates for op 11 and unused otherwise. Returns a cudaError_t
// (0 = launched).
extern "C" int gs360x_micro_op(int op, const void* in0, const void* in1,
                               const void* in2, const void* in3,
                               const void* in4, void* out, int reps, int grid,
                               int param, void* stream) {
  if (op < 0 || op >= kNumOps || reps < 0 || grid <= 0 || in0 == nullptr ||
      out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f0 = static_cast<const float*>(in0);
  const float* f1 = static_cast<const float*>(in1);
  const int* i1 = static_cast<const int*>(in1);
  float* o = static_cast<float*>(out);
  const bool needs_in1 = op != kMul8 && op != kMul64 && op != kConcat &&
                         op != kLoop && op != kWhenRmw;
  if (needs_in1 && in1 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (op) {
    case kMul8:
      mul8_kernel<<<(grid + kChains - 1) / kChains, kChainThreads, 0, s>>>(
          f0, o, reps, grid);
      break;
    case kMul64:
      mul_kernel<64><<<grid, kThreads, 0, s>>>(f0, o, reps);
      break;
    case kGatherLane8:
      return static_cast<int>(launch_gather_lane8(f0, i1, o, reps, grid, s));
    case kGatherLane64:
      return static_cast<int>(launch_gather_lane64(f0, i1, o, reps, grid, s));
    case kGatherSub8:
      gather_sub_kernel<<<grid, kThreads, 0, s>>>(f0, i1, o, reps);
      break;
    case kWhere:
      where_kernel<<<(grid + kChains - 1) / kChains, kChainThreads, 0, s>>>(
          f0, i1, o, reps, grid);
      break;
    case kConcat:
      concat_kernel<<<(grid + kConcatChains - 1) / kConcatChains,
                      kConcatThreads, 0, s>>>(f0, o, reps, grid);
      break;
    case kMatmul64:
      return static_cast<int>(launch_matmul64(f0, f1, o, reps, grid, s));
    case kMatmul8:
      return static_cast<int>(launch_matmul8(f0, f1, o, reps, grid, s));
    case kDynRoll:
      dyn_roll_kernel<<<grid, kThreads, 0, s>>>(f0, i1, o, reps);
      break;
    case kLoop:
      loop_kernel<<<(grid + kChains - 1) / kChains, kChainThreads, 0, s>>>(
          f0, o, reps, grid);
      break;
    case kWhenRmw:
      when_rmw_kernel<<<grid, kThreads, 0, s>>>(f0, o, reps, param);
      break;
    case kDynSlice:
      dyn_slice_kernel<<<grid, kThreads, 0, s>>>(f0, i1, o, reps);
      break;
    default:  // kChunk
      if (in2 == nullptr || in3 == nullptr || in4 == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_chunk(
          f0, i1, static_cast<const float*>(in2),
          static_cast<const int*>(in3), static_cast<const float*>(in4), o,
          reps, grid, s));
  }
  return static_cast<int>(cudaGetLastError());
}
