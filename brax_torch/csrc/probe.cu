// Launch-overhead probe kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of tools/probe_pallas_overhead.py:
//   copy_k (:49), launched by trivial (:52) and by gridded (:62), and
//   chain_k (:75), launched by dotchain (:84) and dotchain5120 (:99).
// brax_torch/tools/probe_overhead.py times them.
//
// copy_plus_one_kernel: o = x + 1 over n floats (an [8, 128] tile).  Every
//   block of the grid writes the whole tile, as every step of gridded's grid
//   does.  A TPU runs those grid steps one after another; here the blocks
//   run at once, so a grid of N blocks measures the cost of N blocks, not of
//   N sequential steps.  Bound: bytes (the tile read once, written once).
//
// dot_chain_kernel: k dependent products h = bf16(h) @ bf16(W), f32 sums,
//   for h [n, 256] and W [256, 256]; the last product is written in f32.
//   Rows are independent through the chain, so each block takes a 64-row
//   tile (wgmma's M) and runs the whole chain on it.  W is converted to bf16
//   once per block into shared memory, transposed (K-major) in 128-byte
//   swizzled 64-wide K blocks; the tile of h lives in shared memory in bf16
//   in the same layout, double-buffered.  Two warpgroups each own 128 of
//   the 256 output columns: per product each issues 16
//   wgmma.mma_async.m64n128k16 from shared-memory descriptors (A = h, B =
//   W^T), waits, and converts its accumulators to bf16 straight from
//   registers into the other buffer, which the next product reads; one
//   block barrier per product.  Shared memory: 128 KB of W + 2 x 32 KB of h.
//   Bound: at 5120 rows and k = 24, operations (2 n 256^2 k flops at the
//   bf16 tensor-core rate, 0.0163 ms against 5.5 MB of x, W and y, 0.0016
//   ms); at 512 rows the two are close.  Measured on an H100 80GB HBM3 at
//   700 W (chip_smoke.py, graph-replayed): 0.045 ms at [5120, 256], k = 24,
//   where the cuBLAS chain takes 0.099.  A product takes ~1.6 us per tile,
//   of it ~1.1 us of tensor work: the epilogue and the barrier do not
//   overlap the next product (it needs every column of h), and 80 blocks
//   at 5120 rows fill 80 of the 132 SMs, so the chain's time is about the
//   same at 512 rows as at 5120.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WIDTH 256                           // the chain's width
#define TILE_ROWS 64                        // chain rows per block: wgmma's M
#define HALF_N 128                          // output columns per warpgroup
#define CHAIN_THREADS 256                   // two warpgroups
#define W_BYTES (WIDTH * WIDTH * 2)         // W^T in bf16
#define H_BYTES (TILE_ROWS * WIDTH * 2)     // one buffer of h in bf16
#define SMEM_BYTES (W_BYTES + 2 * H_BYTES + 1024)  // + slack to align to 1024
#define COPY_THREADS 256

__global__ void copy_plus_one_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  for (int i = threadIdx.x; i < n; i += COPY_THREADS) o[i] = x[i] + 1.0f;
}

// Byte offset of element (r, k) of a K-major bf16 operand of `rows` rows:
// K in blocks of 64 (128 bytes a row), each block rows x 128 B, the 16-byte
// chunks of row r permuted by r % 8 (the 128-byte swizzle wgmma reads).
__device__ __forceinline__ uint32_t swizzled(int r, int k, int rows) {
  return (uint32_t)((k >> 6) * rows * 128 + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) +
                    ((k & 7) << 1));
}

// wgmma matrix descriptor of a 128-byte swizzled K-major tile at shared
// address `addr` (1024-byte aligned atoms): 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
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
// generic-proxy shared-memory writes made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving uses of the accumulators across the wait
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) B (16 x 128), both
// bf16 from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint4 pack8(float4 a, float4 b) {
  __nv_bfloat162 p0 = __floats2bfloat162_rn(a.x, a.y), p1 = __floats2bfloat162_rn(a.z, a.w);
  __nv_bfloat162 p2 = __floats2bfloat162_rn(b.x, b.y), p3 = __floats2bfloat162_rn(b.z, b.w);
  uint4 u;
  u.x = *reinterpret_cast<uint32_t*>(&p0);
  u.y = *reinterpret_cast<uint32_t*>(&p1);
  u.z = *reinterpret_cast<uint32_t*>(&p2);
  u.w = *reinterpret_cast<uint32_t*>(&p3);
  return u;
}

__global__ void __launch_bounds__(CHAIN_THREADS, 1)
    dot_chain_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* wt = smem;                    // W^T: [256 n][256 k], K-major, swizzled
  unsigned char* hbuf[2] = {smem + W_BYTES, smem + W_BYTES + H_BYTES};  // [64 r][256 k]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE_ROWS;

  // W^T in bf16: a thread takes 8 consecutive k of one column n (8 loads,
  // each coalesced over the warp's 32 columns) and stores one 16-byte chunk
  for (int q = tid; q < WIDTH * (WIDTH / 8); q += CHAIN_THREADS) {
    const int nn = q % WIDTH, kc = q / WIDTH;
    const float* src = w + (size_t)(kc * 8) * WIDTH + nn;
    float4 a = make_float4(src[0], src[WIDTH], src[2 * WIDTH], src[3 * WIDTH]);
    float4 b = make_float4(src[4 * WIDTH], src[5 * WIDTH], src[6 * WIDTH], src[7 * WIDTH]);
    *reinterpret_cast<uint4*>(wt + swizzled(nn, kc * 8, WIDTH)) = pack8(a, b);
  }
  // the block's rows of x in bf16 (rows past n are zeros)
  for (int q = tid; q < TILE_ROWS * (WIDTH / 8); q += CHAIN_THREADS) {
    const int r = q / (WIDTH / 8), kc = q % (WIDTH / 8);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (row0 + r < n) {
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * WIDTH + kc * 8);
      a = src[0];
      b = src[1];
    }
    *reinterpret_cast<uint4*>(hbuf[0] + swizzled(r, kc * 8, TILE_ROWS)) = pack8(a, b);
  }
  fence_async_shared();
  __syncthreads();

  const int wg = tid / 128;               // the warpgroup: output columns [128 wg, 128 wg + 128)
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4;  // this thread's accumulator rows: r_lo and r_lo + 8
  const int c_lane = (lane % 4) * 2;
  const uint32_t wt_addr = (uint32_t)__cvta_generic_to_shared(wt) + wg * HALF_N * 128;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  for (int step = 0; step < k; ++step) {
    const uint32_t h_addr = (uint32_t)__cvta_generic_to_shared(hbuf[step & 1]);
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WIDTH / 16; ++kk) {
      const int kb = kk / 4, ks = kk % 4;  // 64-wide K block, 16-wide step inside it
      wgmma_m64n128k16(d, descriptor(h_addr + kb * TILE_ROWS * 128 + ks * 32),
                       descriptor(wt_addr + kb * WIDTH * 128 + ks * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(d);

    if (step + 1 < k) {
      // the next h, in bf16 from the accumulators into the other buffer
      unsigned char* next = hbuf[(step + 1) & 1];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = wg * HALF_N + j * 8 + c_lane;
        __nv_bfloat162 lo = __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(next + swizzled(r_lo, c, TILE_ROWS)) = lo;
        *reinterpret_cast<__nv_bfloat162*>(next + swizzled(r_lo + 8, c, TILE_ROWS)) = hi;
      }
      fence_async_shared();
      __syncthreads();
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = wg * HALF_N + j * 8 + c_lane;
        if (row0 + r_lo < n)
          *reinterpret_cast<float2*>(y + (size_t)(row0 + r_lo) * WIDTH + c) =
              make_float2(d[4 * j], d[4 * j + 1]);
        if (row0 + r_lo + 8 < n)
          *reinterpret_cast<float2*>(y + (size_t)(row0 + r_lo + 8) * WIDTH + c) =
              make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

extern "C" {

int brax_probe_width() { return WIDTH; }

// Lets dot_chain_kernel take SMEM_BYTES of shared memory on the current
// device.  Called once, when the library is loaded, so that a launch costs
// only the launch.
int brax_probe_init() {
  return (int)cudaFuncSetAttribute(dot_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
}

// o[0:n] = x[0:n] + 1, written by each of `blocks` blocks.
int brax_probe_copy_plus_one(const float* x, float* o, int n, int blocks, void* stream) {
  if (n <= 0 || blocks <= 0) return -1;
  copy_plus_one_kernel<<<blocks, COPY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return (int)cudaGetLastError();
}

// y [n, WIDTH] = k dependent products of x [n, WIDTH] with w [WIDTH, WIDTH];
// brax_probe_init must have run on the current device.
int brax_probe_dot_chain(const float* x, const float* w, float* y, int n, int k, void* stream) {
  if (n <= 0 || k <= 0) return -1;
  dim3 grid((n + TILE_ROWS - 1) / TILE_ROWS);
  dot_chain_kernel<<<grid, CHAIN_THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, w, y, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
