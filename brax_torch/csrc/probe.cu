// Launch-overhead probe kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of tools/probe_pallas_overhead.py:
//   copy_k (:49), launched by trivial (:52) and by gridded (:62), and
//   chain_k (:75), launched by dotchain (:84) and dotchain5120 (:99).
// They measure what one launch costs, not a computation anyone needs, so
// they stay simple; brax_torch/tools/probe_overhead.py times them.
//
// copy_plus_one_kernel: o = x + 1 over n floats (an [8, 128] tile).  Every
//   block of the grid writes the whole tile, as every step of gridded's grid
//   does.  A TPU runs those grid steps one after another; here the blocks
//   run at once, so a grid of N blocks measures the cost of N blocks, not of
//   N sequential steps.  Bound: bytes (the tile read once, written once).
//
// dot_chain_kernel: k dependent products h = bf16(h) @ bf16(W), f32 sums,
//   for h [n, 256] and W [256, 256].  Rows are independent through the
//   chain, so each block takes ROWS rows and runs the whole chain on them:
//   W is staged once into shared memory as bf16 (132 KB with padding), the
//   tile of h stays in shared memory as bf16 between the products, and the
//   products are WMMA m16n16k16 bf16 with f32 accumulation.  The last
//   product is written in f32.  Bound: at 512 rows bytes and operations are
//   close (x, W and y against 2 n 256^2 k flops at the bf16 tensor-core
//   rate); at 5120 rows and k = 24 operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define WIDTH 256          // the chain's width
#define ROWS 32            // chain rows per block
#define THREADS 256
#define WARPS (THREADS / 32)
#define LDB (WIDTH + 8)    // bf16 row stride in shared memory (a multiple of 8)
#define COL_TILES (WIDTH / 16)
#define FRAGS ((ROWS / 16) * COL_TILES / WARPS)  // 16x16 output tiles per warp
#define W_BYTES (WIDTH * LDB * 2)
#define H_BYTES (ROWS * LDB * 2)
#define S_BYTES (WARPS * 16 * 16 * 4)
#define SMEM_BYTES (W_BYTES + H_BYTES + S_BYTES)
#define COPY_THREADS 256

__global__ void copy_plus_one_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  for (int i = threadIdx.x; i < n; i += COPY_THREADS) o[i] = x[i] + 1.0f;
}

__device__ __forceinline__ void put4(bf16* dst, float4 v) {
  dst[0] = __float2bfloat16_rn(v.x);
  dst[1] = __float2bfloat16_rn(v.y);
  dst[2] = __float2bfloat16_rn(v.z);
  dst[3] = __float2bfloat16_rn(v.w);
}

__global__ void __launch_bounds__(THREADS) dot_chain_kernel(const float* __restrict__ x,
                                                            const float* __restrict__ w,
                                                            float* __restrict__ y, int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W = reinterpret_cast<bf16*>(smem);                      // [WIDTH][LDB]
  bf16* H = reinterpret_cast<bf16*>(smem + W_BYTES);            // [ROWS][LDB]
  float* S = reinterpret_cast<float*>(smem + W_BYTES + H_BYTES) + (threadIdx.x / 32) * 256;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * ROWS;

  // W and the block's rows of x, rounded to bf16, four floats per load
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int i = tid; i < WIDTH * WIDTH / 4; i += THREADS) {
    const int r = i / (WIDTH / 4), c = 4 * (i % (WIDTH / 4));
    put4(W + r * LDB + c, w4[i]);
  }
  for (int i = tid; i < ROWS * WIDTH / 4; i += THREADS) {
    const int r = i / (WIDTH / 4), c = 4 * (i % (WIDTH / 4));
    const float4 v = row0 + r < n
        ? reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * WIDTH)[c / 4]
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    put4(H + r * LDB + c, v);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAGS];
  for (int step = 0; step < k; ++step) {
#pragma unroll
    for (int j = 0; j < FRAGS; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < WIDTH; kk += 16) {
#pragma unroll
      for (int j = 0; j < FRAGS; ++j) {
        const int f = warp + j * WARPS, rt = f / COL_TILES, ct = f % COL_TILES;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, H + rt * 16 * LDB + kk, LDB);
        wmma::load_matrix_sync(b, W + kk * LDB + ct * 16, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // every warp has read this step's h
    const bool last = step == k - 1;
#pragma unroll
    for (int j = 0; j < FRAGS; ++j) {
      const int f = warp + j * WARPS, rt = f / COL_TILES, ct = f % COL_TILES;
      wmma::store_matrix_sync(S, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16, c = ct * 16 + e % 16;
        if (!last)
          H[r * LDB + c] = __float2bfloat16_rn(S[e]);
        else if (row0 + r < n)
          y[(size_t)(row0 + r) * WIDTH + c] = S[e];
      }
      __syncwarp();
    }
    __syncthreads();  // the next h is complete
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
  dim3 grid((n + ROWS - 1) / ROWS);
  dot_chain_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(x, w, y, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
