// micro_ops: the cost of the primitives a resampling kernel's inner loop is
// made of, as this card executes them. One __global__ function per
// primitive; each loads its block once, applies the primitive `reps` times
// with every application depending on the one before, and stores the
// result block. Every block of the grid does the same work on the same
// inputs and stores the same values to the same output (a benign race), so
// time / (grid * reps) is the cost of one application with the launch and
// the loads amortised.
//
// Replaces micro_ops.py `bench` (the Pallas call) and the 14 kernel bodies
// of its `main`: mul on an (8,128) and a (64,128) tile; gather along axis
// 1 on both tiles; gather along axis 0; where; 8-fold concat; the f32
// products (64,128)@(128,128) and (8,128)@(128,128); dynamic roll; a
// counted loop; a predicated read-modify-write; a dynamic row slice; and
// the bicubic chunk-body composite (3 channels, 4 horizontal + 4 vertical
// taps). The TPU bodies work on (8,128) vector registers and VMEM blocks;
// none of that layout carries over. Here a tile element lives in a
// register of the thread that owns it (element e = thread + j * 256), and
// whatever crosses threads goes through shared memory: a gather along
// axis 1 or 0 is a shared-memory gather, the roll and the row slice read
// shared memory at an offset taken from the index block at run time, the
// predicated update is a read-modify-write of shared memory under a
// run-time predicate, and the products are f32 FMA loops over
// shared-memory tiles (no tensor cores, no library).
//
// Bound: none of these moves data worth naming (a few KB to 0.4 MB per
// block, all of it resident in L1/L2 after the first block); each is bound
// by what it prices: FP32 issue (mul, where, loop), shared-memory
// bandwidth and bank conflicts (gathers, roll, slice, update), FMA issue
// plus shared-memory reads (products), and L1/L2 reads of the index and
// weight tables plus shared-memory gathers (composite).
//
// Loop-invariant shared-memory reads (axis-0 gather, roll, slice, update)
// go through volatile pointers, so that each application really reads;
// the dependent chain is kept alive by the store of its final value.
// Arithmetic that a plain version repeats in another order of rounding
// uses round-to-nearest intrinsics (no FMA contraction), except the
// products, whose k-loop is an fmaf chain.
//
// Gather indices are masked to the tile (& 127, & 7), so an index out of
// range cannot read outside shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;            // tile width
constexpr int kTile8 = 8 * kLanes;     // elements of an (8,128) tile
constexpr int kTile64 = 64 * kLanes;   // elements of a (64,128) tile

enum Op {
  kMul8 = 0, kMul64, kGatherLane8, kGatherLane64, kGatherSub8, kWhere,
  kConcat, kMatmul64, kMatmul8, kDynRoll, kLoop, kWhenRmw, kDynSlice,
  kChunk, kNumOps
};

// x = x * 1.0001, `reps` times; ROWS * 128 elements, ROWS / 2 a thread.
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

// x[r, c] = x[r, idx[r, c]] + 0.5, `reps` times: the tile in shared
// memory, gathered within its row, written back between two barriers.
template <int ROWS>
__global__ void gather_lane_kernel(const float* __restrict__ a,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int reps) {
  constexpr int kPer = ROWS * kLanes / kThreads;
  __shared__ float xs[ROWS * kLanes];
  int src[kPer];
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    xs[e] = a[e];
    src[j] = (e / kLanes) * kLanes + (idx[e] & (kLanes - 1));
  }
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = __fadd_rn(xs[src[j]], 0.5f);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) xs[threadIdx.x + j * kThreads] = v[j];
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    out[e] = xs[e];
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

// x = (idx == r) ? x : x * 1.0001 for r = 0 .. reps-1, an (8,128) tile.
__global__ void where_kernel(const float* __restrict__ a,
                             const int* __restrict__ idx,
                             float* __restrict__ out, int reps) {
  constexpr int kPer = kTile8 / kThreads;
  float x[kPer];
  int i[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    x[j] = a[threadIdx.x + j * kThreads];
    i[j] = idx[threadIdx.x + j * kThreads];
  }
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      x[j] = (i[j] == r) ? x[j] : __fmul_rn(x[j], 1.0001f);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = x[j];
}

// acc(64,128) += concat of 8 copies of x(8,128) along axis 0, `reps` times:
// the 8-row tile in shared memory, replicated into the 64-row accumulator.
__global__ void concat_kernel(const float* __restrict__ a,
                              float* __restrict__ out, int reps) {
  constexpr int kPer = kTile64 / kThreads;
  __shared__ float xs[kTile8];
  float acc[kPer];
  for (int e = threadIdx.x; e < kTile8; e += kThreads) xs[e] = a[e];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;
  __syncthreads();
  const volatile float* xv = xs;
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      acc[j] = __fadd_rn(acc[j], xv[(threadIdx.x + j * kThreads) % kTile8]);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = acc[j];
}

// x(ROWS,128) = x @ b(128,128), `reps` times, in f32: b and two copies of
// x (read one, write the other) in dynamic shared memory; a thread owns
// one column of ROWS / 2 rows and runs the k-loop as an fmaf chain, four
// k a step, x read as one 16-byte broadcast.
template <int ROWS>
__global__ void matmul_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ out, int reps) {
  constexpr int kRpt = ROWS / 2;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                         // (128, 128)
  float* xs = smem + kLanes * kLanes;       // 2 x (ROWS, 128)
  for (int e = threadIdx.x; e < kLanes * kLanes; e += kThreads) bs[e] = b[e];
  for (int e = threadIdx.x; e < ROWS * kLanes; e += kThreads) xs[e] = a[e];
  __syncthreads();
  const int c = threadIdx.x % kLanes;
  const int r0 = (threadIdx.x / kLanes) * kRpt;
  int cur = 0;
  for (int r = 0; r < reps; ++r) {
    const float* x = xs + cur * ROWS * kLanes;
    float* y = xs + (cur ^ 1) * ROWS * kLanes;
    float acc[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) acc[i] = 0.0f;
    for (int k = 0; k < kLanes; k += 4) {
      const float b0 = bs[(k + 0) * kLanes + c];
      const float b1 = bs[(k + 1) * kLanes + c];
      const float b2 = bs[(k + 2) * kLanes + c];
      const float b3 = bs[(k + 3) * kLanes + c];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const float4 xv =
            *reinterpret_cast<const float4*>(x + (r0 + i) * kLanes + k);
        acc[i] = fmaf(xv.x, b0, acc[i]);
        acc[i] = fmaf(xv.y, b1, acc[i]);
        acc[i] = fmaf(xv.z, b2, acc[i]);
        acc[i] = fmaf(xv.w, b3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRpt; ++i) y[(r0 + i) * kLanes + c] = acc[i];
    __syncthreads();
    cur ^= 1;
  }
  const float* x = xs + cur * ROWS * kLanes;
  for (int e = threadIdx.x; e < ROWS * kLanes; e += kThreads) out[e] = x[e];
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

// acc = x; acc += 1.0, `reps` times: the cost of one counted-loop
// iteration around a trivial body.
__global__ void loop_kernel(const float* __restrict__ a,
                            float* __restrict__ out, int reps) {
  constexpr int kPer = kTile8 / kThreads;
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = a[threadIdx.x + j * kThreads];
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = __fadd_rn(acc[j], 1.0f);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = acc[j];
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
__global__ void chunk_kernel(const float* __restrict__ win,
                             const int* __restrict__ relb,
                             const float* __restrict__ wfb,
                             const int* __restrict__ ry,
                             const float* __restrict__ wv,
                             float* __restrict__ out, int reps) {
  constexpr int kPerIh = kTile64 / kThreads;
  constexpr int kPer = kTile8 / kThreads;
  __shared__ float ws[3 * kTile8];
  __shared__ float ih[kTile64];
  for (int e = threadIdx.x; e < 3 * kTile8; e += kThreads) ws[e] = win[e];
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    for (int ch = 0; ch < 3; ++ch) {
      const float* blk = ws + ch * kTile8;
#pragma unroll 4
      for (int j = 0; j < kPerIh; ++j) {
        const int e = threadIdx.x + j * kThreads;
        const float* row = blk + ((e / kLanes) & 7) * kLanes;
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float term = __fmul_rn(
              row[__ldg(relb + k * kTile64 + e) & (kLanes - 1)],
              __ldg(wfb + k * kTile64 + e));
          sum = (k == 0) ? term : __fadd_rn(sum, term);
        }
        ih[e] = sum;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = threadIdx.x + j * kThreads;
        const int group = e / kLanes;
        const int col = e % kLanes;
        float add = 0.0f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          // ry, wv [m][group][row 0][col]
          const int off = (m * 8 + group) * kTile8 + col;
          const float term = __fmul_rn(
              ih[(group * 8 + (__ldg(ry + off) & 7)) * kLanes + col],
              __ldg(wv + off));
          add = (m == 0) ? term : __fadd_rn(add, term);
        }
        acc[j] = __fadd_rn(acc[j], add);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = acc[j];
}

template <int ROWS>
cudaError_t launch_matmul(const float* a, const float* b, float* out,
                          int reps, int grid, cudaStream_t stream) {
  constexpr int kBytes =
      (kLanes * kLanes + 2 * ROWS * kLanes) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (err != cudaSuccess) return err;
  matmul_kernel<ROWS><<<grid, kThreads, kBytes, stream>>>(a, b, out, reps);
  return cudaGetLastError();
}

}  // namespace

// One primitive, `grid` blocks of 256 threads, `reps` applications each.
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
      mul_kernel<8><<<grid, kThreads, 0, s>>>(f0, o, reps);
      break;
    case kMul64:
      mul_kernel<64><<<grid, kThreads, 0, s>>>(f0, o, reps);
      break;
    case kGatherLane8:
      gather_lane_kernel<8><<<grid, kThreads, 0, s>>>(f0, i1, o, reps);
      break;
    case kGatherLane64:
      gather_lane_kernel<64><<<grid, kThreads, 0, s>>>(f0, i1, o, reps);
      break;
    case kGatherSub8:
      gather_sub_kernel<<<grid, kThreads, 0, s>>>(f0, i1, o, reps);
      break;
    case kWhere:
      where_kernel<<<grid, kThreads, 0, s>>>(f0, i1, o, reps);
      break;
    case kConcat:
      concat_kernel<<<grid, kThreads, 0, s>>>(f0, o, reps);
      break;
    case kMatmul64:
      return static_cast<int>(launch_matmul<64>(f0, f1, o, reps, grid, s));
    case kMatmul8:
      return static_cast<int>(launch_matmul<8>(f0, f1, o, reps, grid, s));
    case kDynRoll:
      dyn_roll_kernel<<<grid, kThreads, 0, s>>>(f0, i1, o, reps);
      break;
    case kLoop:
      loop_kernel<<<grid, kThreads, 0, s>>>(f0, o, reps);
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
      chunk_kernel<<<grid, kThreads, 0, s>>>(
          f0, i1, static_cast<const float*>(in2),
          static_cast<const int*>(in3), static_cast<const float*>(in4), o,
          reps);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
