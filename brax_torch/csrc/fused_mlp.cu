// Fused MLP chain, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of brax_tpu/training/fused_mlp.py:
//   _fwd_kernel (launched by _get_op.call_fwd, fused_mlp.py:204) and
//   _bwd_kernel (launched by _get_op.call_bwd, fused_mlp.py:247).
//
// The chain: z_i = a_i @ W_i + b_i, a_{i+1} = act(z_i), a linear last layer.
// W_i is [d_i, d_{i+1}] row-major (flax's layout), d_i <= MAX_WIDTH.  In bf16
// mode the matmul inputs are rounded to bf16 (round to nearest even) and
// multiplied on the tensor cores (WMMA m16n16k16) with f32 accumulation, as
// the TPU kernel's bf16 MXU dots; in f32 mode every product is a plain FFMA.
//
// Forward (fwd_kernel): one block of 256 threads per tile of ROWS=32 rows.
// The tile's activations stay in shared memory (f32, [ROWS][LDH]) across all
// layers; W_i is streamed through shared memory in K-chunks, converted on the
// way.  Bound: at the ant recipe's shapes the value chain (87->256x5->1) is
// bound by operations, the policy chain (87->32x4->16) by bytes.
//
// Backward: three kernels per call, all launched by brax_fused_mlp_bwd.
//   bwd_rows_kernel  per row tile, recomputes the forward as _bwd_kernel does
//                    and writes each pre-activation z_i to a global scratch
//                    (five 256-wide z_i of a 32-row tile are 160 KB, too much
//                    to keep in shared memory beside the rest), then carries
//                    g back through the chain: g_i = dL/dz_i goes to a second
//                    global scratch, dx to its output.
//   dw_kernel        dW_i = a_i^T g_i and db_i = sum_rows g_i: one block per
//                    64x64 tile of dW_i and slice of the rows, each summing
//                    its slice in row order into its own part of a workspace
//                    (the slices give the policy chain's 6 tiles enough
//                    blocks to fill the card);
//   reduce_kernel    sums the slices' partials in slice order.
// The TPU body accumulates dW/db with += across its grid, which is safe only
// because a TPU grid runs in order.  Here no two blocks write the same
// element and every sum is taken in a fixed order, so the result is
// deterministic and needs no atomics.
//
// Every copy from global memory into shared memory keeps COPY_UNROLL loads
// in flight per thread (block_copy), and no loop over a tile divides per
// element: the first version of these kernels did both and ran 50-100x over
// its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define MAX_WIDTH 256
#define MAX_LAYERS 8
#define ROWS 32
#define THREADS 256
#define LDH 260   // f32 activation row stride (floats)
#define LDA 264   // bf16 A-operand row stride (elements)
#define LDW 264   // bf16 weight-chunk row stride
#define KC16 64   // weight rows per chunk, bf16
#define LDW32 260 // f32 weight-chunk row stride
#define KC32 32   // weight rows per chunk, f32
#define H_BYTES (ROWS * LDH * 4)
#define A16_BYTES (ROWS * LDA * 2)
#define WS_BYTES (KC16 * LDW * 2)
#define SMEM_BYTES (H_BYTES + A16_BYTES + WS_BYTES)
#define FRAGS_PER_WARP ((ROWS / 16) * (MAX_WIDTH / 16) / (THREADS / 32))
#define COPY_UNROLL 8

// dW pass
#define DT 64     // dW tile edge
#define RC 64     // rows per staged chunk
#define LDS16 72  // bf16 staging row stride
#define LDS32 68  // f32 staging row stride

enum { ACT_SWISH = 0, ACT_RELU = 1, ACT_TANH = 2 };

struct Chain {
  int n_layers;
  int dims[MAX_LAYERS + 1];
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
};

struct Grads {
  float* dw[MAX_LAYERS];
  float* db[MAX_LAYERS];
  int tile_start[MAX_LAYERS + 1];  // dW tiles of the layers before i
  int w_off[MAX_LAYERS];           // dW_i's offset in one slice of partials
  int b_off[MAX_LAYERS];           // db_i's
  int slice_size;                  // floats in one slice
  int rows_per_slice;
  float* part;                     // [slices][slice_size] partial sums
};

__device__ __forceinline__ int rup16(int x) { return (x + 15) & ~15; }

// store(r, c, load(r, c)) over a rows x cols grid, row-major over the block,
// with COPY_UNROLL loads (of T: float or float4) in flight per thread: the
// sources sit in L2 or HBM, and one load at a time per thread leaves the
// block waiting on latency.  (r, c) advance by additions: a division per
// element costs more than the copy itself.
template <typename T, typename Load, typename Store>
__device__ __forceinline__ void block_copy(int rows, int cols, Load load, Store store) {
  const int total = rows * cols;
  const int dr = THREADS / cols, dc = THREADS - dr * cols;  // THREADS as (rows, cols)
  auto step = [&](int& r, int& c) {
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  };
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  for (int base = threadIdx.x; base < total; base += COPY_UNROLL * THREADS) {
    T v[COPY_UNROLL];
    int lr = r, lc = c;
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      if (base + u * THREADS < total) v[u] = load(lr, lc);
      step(lr, lc);
    }
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      if (base + u * THREADS < total) store(r, c, v[u]);
      step(r, c);
    }
  }
}

// fn(r, c) over a rows x cols grid of shared memory: a warp per row, a lane
// per column.
template <typename F>
__device__ __forceinline__ void for_tile(int rows, int cols, F fn) {
  for (int r = threadIdx.x / 32; r < rows; r += THREADS / 32)
    for (int c = threadIdx.x % 32; c < cols; c += 32) fn(r, c);
}

__device__ __forceinline__ float act_fwd(int act, float z) {
  if (act == ACT_SWISH) return z * (1.0f / (1.0f + expf(-z)));
  if (act == ACT_RELU) return z > 0.0f ? z : 0.0f;
  return tanhf(z);
}

__device__ __forceinline__ float act_grad(int act, float z) {
  if (act == ACT_SWISH) {
    float s = 1.0f / (1.0f + expf(-z));
    return s * (1.0f + z * (1.0f - s));
  }
  if (act == ACT_RELU) return z > 0.0f ? 1.0f : 0.0f;
  float t = tanhf(z);
  return 1.0f - t * t;
}

// Rows [k0, k0 + kc) of B, columns [0, Np), zero outside [0, Kc) x [0, Nout),
// to put(kk, j, value).  B[k][j] = W[k*w_cols + j] (TRANS false) or
// W[j*w_cols + k] (TRANS true); neighbouring threads read neighbouring
// addresses either way.
template <bool TRANS, typename Put>
__device__ __forceinline__ void stage_weights(const float* __restrict__ W, int w_cols, int Kc,
                                              int Nout, int k0, int kc, int Np, Put put) {
  // float4 loads where a float4 never straddles the valid region's edge
  if (w_cols % 4 == 0 && (TRANS ? Kc : Nout) % 4 == 0 && (reinterpret_cast<size_t>(W) & 15) == 0) {
    const float4* W4 = reinterpret_cast<const float4*>(W);
    const int ld4 = w_cols / 4;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (TRANS)  // B[k..k+3][j] = W[j][k..k+3]
      block_copy<float4>(
          Np, kc / 4,
          [&](int j, int q) {
            return (k0 + 4 * q < Kc && j < Nout) ? W4[j * ld4 + k0 / 4 + q] : zero;
          },
          [&](int j, int q, float4 v) {
            put(4 * q, j, v.x); put(4 * q + 1, j, v.y); put(4 * q + 2, j, v.z); put(4 * q + 3, j, v.w);
          });
    else  // B[k][j..j+3] = W[k][j..j+3]
      block_copy<float4>(
          kc, Np / 4,
          [&](int kk, int q) { return (k0 + kk < Kc && 4 * q < Nout) ? W4[(k0 + kk) * ld4 + q] : zero; },
          [&](int kk, int q, float4 v) {
            put(kk, 4 * q, v.x); put(kk, 4 * q + 1, v.y); put(kk, 4 * q + 2, v.z); put(kk, 4 * q + 3, v.w);
          });
  } else if (TRANS) {  // W row j holds column j of B: walk (j, kk), kk fastest
    block_copy<float>(
        Np, kc,
        [&](int j, int kk) { return (k0 + kk < Kc && j < Nout) ? W[j * w_cols + k0 + kk] : 0.0f; },
        [&](int j, int kk, float v) { put(kk, j, v); });
  } else {
    block_copy<float>(
        kc, Np,
        [&](int kk, int j) { return (k0 + kk < Kc && j < Nout) ? W[(k0 + kk) * w_cols + j] : 0.0f; },
        put);
  }
}

// H[:, :rup16(Nout)] = H[:, :Kc] @ B, B[k][j] = W[k*w_cols + j] (TRANS false)
// or W[j*w_cols + k] (TRANS true).  H columns in [Kc, rup16(Kc)) must be 0.
// Output columns in [Nout, rup16(Nout)) come out 0.  Starts and ends with a
// block barrier, so H may be written before and read after.
template <bool BF16, bool TRANS>
__device__ void block_gemm(const float* __restrict__ W, int w_cols, int Kc, int Nout,
                           float* H, bf16* A16, unsigned char* ws_raw) {
  const int tid = threadIdx.x;
  const int Kp = rup16(Kc), Np = rup16(Nout);
  __syncthreads();
  if (BF16) {
    bf16* WS = reinterpret_cast<bf16*>(ws_raw);
    for_tile(ROWS, Kp, [&](int r, int c) { A16[r * LDA + c] = __float2bfloat16_rn(H[r * LDH + c]); });
    const int warp = tid / 32, nct = Np / 16, nfrag = (ROWS / 16) * nct;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAGS_PER_WARP];
#pragma unroll
    for (int j = 0; j < FRAGS_PER_WARP; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int k0 = 0; k0 < Kp; k0 += KC16) {
      const int kc = min(KC16, Kp - k0);
      __syncthreads();
      stage_weights<TRANS>(W, w_cols, Kc, Nout, k0, kc, Np,
                           [&](int kk, int j, float v) { WS[kk * LDW + j] = __float2bfloat16_rn(v); });
      __syncthreads();
#pragma unroll
      for (int j = 0; j < FRAGS_PER_WARP; ++j) {
        const int f = warp + j * (THREADS / 32);
        if (f < nfrag) {
          const int rt = f / nct, ct = f - rt * nct;
          for (int kk = 0; kk < kc; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(a, A16 + rt * 16 * LDA + k0 + kk, LDA);
            wmma::load_matrix_sync(b, WS + kk * LDW + ct * 16, LDW);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FRAGS_PER_WARP; ++j) {
      const int f = warp + j * (THREADS / 32);
      if (f < nfrag) {
        const int rt = f / nct, ct = f - rt * nct;
        wmma::store_matrix_sync(H + rt * 16 * LDH + ct * 16, acc[j], LDH, wmma::mem_row_major);
      }
    }
  } else {
    float* WS = reinterpret_cast<float*>(ws_raw);
    // thread: rows rg*8 .. rg*8+7, columns cg + 64q
    const int rg = tid / 64, cg = tid % 64;
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    for (int k0 = 0; k0 < Kp; k0 += KC32) {
      const int kc = min(KC32, Kp - k0);
      __syncthreads();
      stage_weights<TRANS>(W, w_cols, Kc, Nout, k0, kc, Np,
                           [&](int kk, int j, float v) { WS[kk * LDW32 + j] = v; });
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        float a[8], w[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = H[(rg * 8 + r) * LDH + k0 + kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = WS[kk * LDW32 + cg + 64 * q];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], w[q], acc[r][q]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (cg + 64 * q < Np) H[(rg * 8 + r) * LDH + cg + 64 * q] = acc[r][q];
  }
  __syncthreads();
}

// H[r][c] = src[(row0 + r) * cols + c] for valid rows and c < cols, else 0,
// over columns [0, rup16(cols)).
__device__ void load_tile(float* H, const float* __restrict__ src, int n, int row0, int cols) {
  block_copy<float>(
      ROWS, rup16(cols),
      [&](int r, int c) {
        return (row0 + r < n && c < cols) ? src[(size_t)(row0 + r) * cols + c] : 0.0f;
      },
      [&](int r, int c, float v) { H[r * LDH + c] = v; });
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Chain ch, const float* __restrict__ x,
                                                     float* __restrict__ y, int n, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* H = reinterpret_cast<float*>(smem);
  bf16* A16 = reinterpret_cast<bf16*>(smem + H_BYTES);
  unsigned char* WS = smem + H_BYTES + A16_BYTES;
  const int row0 = blockIdx.x * ROWS;
  load_tile(H, x, n, row0, ch.dims[0]);
  for (int i = 0; i < ch.n_layers; ++i) {
    const int K = ch.dims[i], N = ch.dims[i + 1], Np = rup16(N);
    const bool last = i == ch.n_layers - 1;
    block_gemm<BF16, false>(ch.w[i], N, K, N, H, A16, WS);
    const float* b = ch.b[i];
    for_tile(ROWS, Np, [&](int r, int c) {
      float v = 0.0f;
      if (c < N) {
        float z = H[r * LDH + c] + b[c];
        v = last ? z : act_fwd(act, z);
        if (last && row0 + r < n) y[(size_t)(row0 + r) * N + c] = z;
      }
      H[r * LDH + c] = v;
    });
  }
}

// z_i lives at zbuf + n * sum_{j<i} d_{j+1}, g_i at gbuf + the same offset,
// both [n][d_{i+1}] row-major.
__device__ __forceinline__ size_t layer_offset(const Chain& ch, int i, int n) {
  size_t off = 0;
  for (int j = 0; j < i; ++j) off += ch.dims[j + 1];
  return off * (size_t)n;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) bwd_rows_kernel(
    Chain ch, const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ dx,
    float* zbuf, float* gbuf, int n, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* H = reinterpret_cast<float*>(smem);
  bf16* A16 = reinterpret_cast<bf16*>(smem + H_BYTES);
  unsigned char* WS = smem + H_BYTES + A16_BYTES;
  const int row0 = blockIdx.x * ROWS;
  const int L = ch.n_layers;

  // forward recompute, keeping every hidden pre-activation
  load_tile(H, x, n, row0, ch.dims[0]);
  for (int i = 0; i < L - 1; ++i) {
    const int K = ch.dims[i], N = ch.dims[i + 1], Np = rup16(N);
    block_gemm<BF16, false>(ch.w[i], N, K, N, H, A16, WS);
    float* z_out = zbuf + layer_offset(ch, i, n);
    const float* b = ch.b[i];
    for_tile(ROWS, Np, [&](int r, int c) {
      float v = 0.0f;
      if (c < N) {
        float z = H[r * LDH + c] + b[c];
        if (row0 + r < n) z_out[(size_t)(row0 + r) * N + c] = z;
        v = act_fwd(act, z);
      }
      H[r * LDH + c] = v;
    });
  }

  // g back through the chain
  __syncthreads();
  load_tile(H, g, n, row0, ch.dims[L]);
  __syncthreads();
  for (int i = L - 1; i >= 0; --i) {
    const int K = ch.dims[i], N = ch.dims[i + 1], Kp = rup16(K);
    float* g_out = gbuf + layer_offset(ch, i, n);
    for_tile(ROWS, N, [&](int r, int c) {
      if (row0 + r < n) g_out[(size_t)(row0 + r) * N + c] = H[r * LDH + c];
    });
    block_gemm<BF16, true>(ch.w[i], N, N, K, H, A16, WS);
    if (i > 0) {
      const float* z_in = zbuf + layer_offset(ch, i - 1, n);
      for_tile(ROWS, Kp, [&](int r, int c) {
        float v = 0.0f;
        if (c < K && row0 + r < n) v = H[r * LDH + c] * act_grad(act, z_in[(size_t)(row0 + r) * K + c]);
        H[r * LDH + c] = v;
      });
    } else {
      for_tile(ROWS, K, [&](int r, int c) {
        if (row0 + r < n) dx[(size_t)(row0 + r) * K + c] = H[r * LDH + c];
      });
    }
    __syncthreads();
  }
}

// One 64x64 tile of dW_i (blockIdx.x) over one slice of the rows
// (blockIdx.y): its partial sums, and db_i's where the tile starts at k = 0,
// go to the slice's part of the workspace, summed in row order.
template <bool BF16>
__global__ void __launch_bounds__(THREADS) dw_kernel(Chain ch, Grads gr, const float* __restrict__ x,
                                                    const float* __restrict__ zbuf,
                                                    const float* __restrict__ gbuf, int n, int act) {
  __shared__ __align__(128) unsigned char sm[2 * RC * LDS16 * 2 + RC * LDS32 * 4];
  const int tid = threadIdx.x;
  int i = 0;
  while ((int)blockIdx.x >= gr.tile_start[i + 1]) ++i;
  const int K = ch.dims[i], N = ch.dims[i + 1];
  const int t = blockIdx.x - gr.tile_start[i];
  const int ntn = (N + DT - 1) / DT;
  const int k0 = (t / ntn) * DT, n0 = (t % ntn) * DT;
  const bool do_db = k0 == 0;
  const int row_begin = blockIdx.y * gr.rows_per_slice;
  const int row_end = min(n, row_begin + gr.rows_per_slice);
  const float* a_src = i == 0 ? x : zbuf + layer_offset(ch, i - 1, n);
  const bool a_act = i > 0;
  const float* g_src = gbuf + layer_offset(ch, i, n);
  float* part = gr.part + (size_t)blockIdx.y * gr.slice_size;
  float* Gs32 = reinterpret_cast<float*>(sm + 2 * RC * LDS16 * 2);
  float db_acc = 0.0f;
  // row r0 + r, column c of the tile, of a and of g
  auto load_a = [&](int r0, int r, int c) {
    return (r0 + r < row_end && k0 + c < K) ? a_src[(size_t)(r0 + r) * K + k0 + c] : 0.0f;
  };
  auto load_g = [&](int r0, int r, int c) {
    return (r0 + r < row_end && n0 + c < N) ? g_src[(size_t)(r0 + r) * N + n0 + c] : 0.0f;
  };
  // act(0) = 0 for every activation, so the zero padding stays zero
  auto act_a = [&](float v) { return a_act ? act_fwd(act, v) : v; };

  if (BF16) {
    bf16* As16 = reinterpret_cast<bf16*>(sm);
    bf16* Gs16 = As16 + RC * LDS16;
    const int warp = tid / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int r0 = row_begin; r0 < row_end; r0 += RC) {
      __syncthreads();
      block_copy<float>(RC, DT, [&](int r, int c) { return load_a(r0, r, c); },
                 [&](int r, int c, float v) { As16[r * LDS16 + c] = __float2bfloat16_rn(act_a(v)); });
      block_copy<float>(RC, DT, [&](int r, int c) { return load_g(r0, r, c); },
                 [&](int r, int c, float v) {
                   Gs16[r * LDS16 + c] = __float2bfloat16_rn(v);
                   Gs32[r * LDS32 + c] = v;
                 });
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = warp + 8 * j, mt = f / 4, nt = f % 4;
        for (int rr = 0; rr < RC; rr += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, As16 + rr * LDS16 + mt * 16, LDS16);
          wmma::load_matrix_sync(b, Gs16 + rr * LDS16 + nt * 16, LDS16);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      if (do_db && tid < DT)
        for (int r = 0; r < RC; ++r) db_acc += Gs32[r * LDS32 + tid];
    }
    __syncthreads();
    float* Cs = reinterpret_cast<float*>(sm);  // DT x LDS32 over the bf16 staging
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int f = warp + 8 * j, mt = f / 4, nt = f % 4;
      wmma::store_matrix_sync(Cs + mt * 16 * LDS32 + nt * 16, acc[j], LDS32, wmma::mem_row_major);
    }
    __syncthreads();
    for_tile(DT, DT, [&](int m, int c) {
      if (k0 + m < K && n0 + c < N)
        part[gr.w_off[i] + (size_t)(k0 + m) * N + n0 + c] = Cs[m * LDS32 + c];
    });
  } else {
    float* As32 = reinterpret_cast<float*>(sm);
    const int tx = tid % 16, ty = tid / 16;  // dW rows ty*4.., columns tx*4..
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
    for (int r0 = row_begin; r0 < row_end; r0 += RC) {
      __syncthreads();
      block_copy<float>(RC, DT, [&](int r, int c) { return load_a(r0, r, c); },
                 [&](int r, int c, float v) { As32[r * LDS32 + c] = act_a(v); });
      block_copy<float>(RC, DT, [&](int r, int c) { return load_g(r0, r, c); },
                 [&](int r, int c, float v) { Gs32[r * LDS32 + c] = v; });
      __syncthreads();
      for (int r = 0; r < RC; ++r) {
        float a[4], gv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) a[p] = As32[r * LDS32 + ty * 4 + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) gv[q] = Gs32[r * LDS32 + tx * 4 + q];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], gv[q], acc[p][q]);
      }
      if (do_db && tid < DT)
        for (int r = 0; r < RC; ++r) db_acc += Gs32[r * LDS32 + tid];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int m = k0 + ty * 4 + p, c = n0 + tx * 4 + q;
        if (m < K && c < N) part[gr.w_off[i] + (size_t)m * N + c] = acc[p][q];
      }
  }
  if (do_db && tid < DT && n0 + tid < N) part[gr.b_off[i] + n0 + tid] = db_acc;
}

// dW_i (blockIdx.y = i) or db_i (blockIdx.y = L + i): the sum of the
// slices' partials, slice by slice in order.
__global__ void __launch_bounds__(THREADS) reduce_kernel(Chain ch, Grads gr, int slices) {
  const int L = ch.n_layers;
  const bool is_b = (int)blockIdx.y >= L;
  const int i = is_b ? blockIdx.y - L : blockIdx.y;
  const int count = is_b ? ch.dims[i + 1] : ch.dims[i] * ch.dims[i + 1];
  const int off = is_b ? gr.b_off[i] : gr.w_off[i];
  float* out = is_b ? gr.db[i] : gr.dw[i];
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < count; e += gridDim.x * THREADS) {
    float sum = 0.0f;
    for (int sl = 0; sl < slices; ++sl) sum += gr.part[(size_t)sl * gr.slice_size + off + e];
    out[e] = sum;
  }
}

static int make_chain(Chain* ch, int n_layers, const int* dims, const void* const* w,
                      const void* const* b) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return -1;
  ch->n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1 || dims[i] > MAX_WIDTH) return -2;
    ch->dims[i] = dims[i];
  }
  for (int i = 0; i < n_layers; ++i) {
    ch->w[i] = static_cast<const float*>(w[i]);
    ch->b[i] = static_cast<const float*>(b[i]);
  }
  return 0;
}

template <typename K>
static int allow_smem(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

extern "C" {

int brax_fused_mlp_max_width() { return MAX_WIDTH; }
int brax_fused_mlp_max_layers() { return MAX_LAYERS; }
int brax_fused_mlp_rows() { return ROWS; }

// y [n, d_L] = chain(x [n, d_0]).  Returns 0 or a CUDA error code (negative:
// bad arguments).
int brax_fused_mlp_fwd(const float* x, float* y, int n, int n_layers, const int* dims,
                       const void* const* w, const void* const* b, int act, int bf16_mode,
                       void* stream) {
  Chain ch;
  int bad = make_chain(&ch, n_layers, dims, w, b);
  if (bad) return bad;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + ROWS - 1) / ROWS);
  int err;
  if (bf16_mode) {
    if ((err = allow_smem(fwd_kernel<true>))) return err;
    fwd_kernel<true><<<grid, THREADS, SMEM_BYTES, s>>>(ch, x, y, n, act);
  } else {
    if ((err = allow_smem(fwd_kernel<false>))) return err;
    fwd_kernel<false><<<grid, THREADS, SMEM_BYTES, s>>>(ch, x, y, n, act);
  }
  return (int)cudaGetLastError();
}

// dx [n, d_0], dw[i] [d_i, d_{i+1}], db[i] [d_{i+1}] from x, g [n, d_L].
// zbuf holds n * sum_{i<L-1} d_{i+1} floats, gbuf n * sum_{i<L} d_{i+1},
// part slices * (sum_i d_i d_{i+1} + sum_i d_{i+1}).  The rows are cut into
// `slices` slices for the dW pass.
int brax_fused_mlp_bwd(const float* x, const float* g, float* dx, void* const* dw,
                       void* const* db, float* zbuf, float* gbuf, float* part, int slices,
                       int n, int n_layers, const int* dims, const void* const* w,
                       const void* const* b, int act, int bf16_mode, void* stream) {
  Chain ch;
  int bad = make_chain(&ch, n_layers, dims, w, b);
  if (bad) return bad;
  if (slices < 1) return -3;
  Grads gr;
  gr.tile_start[0] = 0;
  int off = 0, max_count = 1;
  for (int i = 0; i < n_layers; ++i) {
    gr.dw[i] = static_cast<float*>(dw[i]);
    gr.db[i] = static_cast<float*>(db[i]);
    int tiles = ((dims[i] + DT - 1) / DT) * ((dims[i + 1] + DT - 1) / DT);
    gr.tile_start[i + 1] = gr.tile_start[i] + tiles;
    gr.w_off[i] = off;
    off += dims[i] * dims[i + 1];
    max_count = max(max_count, dims[i] * dims[i + 1]);
  }
  for (int i = 0; i < n_layers; ++i) {
    gr.b_off[i] = off;
    off += dims[i + 1];
  }
  gr.slice_size = off;
  const int chunks = (n + RC - 1) / RC;
  gr.rows_per_slice = ((chunks + slices - 1) / slices) * RC;
  gr.part = part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (n > 0) {
    dim3 grid((n + ROWS - 1) / ROWS);
    if (bf16_mode) {
      if ((err = allow_smem(bwd_rows_kernel<true>))) return err;
      bwd_rows_kernel<true><<<grid, THREADS, SMEM_BYTES, s>>>(ch, x, g, dx, zbuf, gbuf, n, act);
    } else {
      if ((err = allow_smem(bwd_rows_kernel<false>))) return err;
      bwd_rows_kernel<false><<<grid, THREADS, SMEM_BYTES, s>>>(ch, x, g, dx, zbuf, gbuf, n, act);
    }
    if ((err = (int)cudaGetLastError())) return err;
  }
  dim3 tiles(gr.tile_start[n_layers], slices);
  if (bf16_mode)
    dw_kernel<true><<<tiles, THREADS, 0, s>>>(ch, gr, x, zbuf, gbuf, n, act);
  else
    dw_kernel<false><<<tiles, THREADS, 0, s>>>(ch, gr, x, zbuf, gbuf, n, act);
  if ((err = (int)cudaGetLastError())) return err;
  dim3 sums(min((max_count + THREADS - 1) / THREADS, 64), 2 * n_layers);
  reduce_kernel<<<sums, THREADS, 0, s>>>(ch, gr, slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
