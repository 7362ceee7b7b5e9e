// Fused MLP chain, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of brax_tpu/training/fused_mlp.py:
//   _fwd_kernel (launched by _get_op.call_fwd, fused_mlp.py:204) and
//   _bwd_kernel (launched by _get_op.call_bwd, fused_mlp.py:247).
//
// The chain: z_i = a_i @ W_i + b_i, a_{i+1} = act(z_i), a linear last layer.
// W_i is [d_i, d_{i+1}] row-major (flax's layout), every d_{i+1} <= MAX_WIDTH
// and the input d_0 <= MAX_IN_WIDTH (SAC's critic takes obs and action
// together: humanoid's 240 + 17 = 257; the widest first layer of 256
// outputs that a stage holds resident beside its tiles).  In bf16
// mode the matmul inputs are rounded to bf16 (round to nearest even) and
// multiplied on the tensor cores (mma.sync m16n8k16) with f32 sums, as the
// TPU kernel's bf16 MXU dots; bias, activation and act' stay in f32.  In f32
// mode every product is a plain FFMA (the f32 kernels at the end of this
// file; they are on no main path).
//
// What bounds it.  At the PPO ant recipe's shapes the value chain
// (87->256x5->1) is bound by operations and the policy chain (87->32x4->16)
// by bytes; both are microseconds of work, so what a design has to beat is
// latency: staging the weights, and the chain of dependent layers, each a
// few dependent steps (products, activation, hand-over).  The pipeline
// kernels run 16 warps per SM (128 registers each) to hide it.
//
// bf16 forward (fwd_kernel), one launch.  A thread-block cluster is a
// pipeline over tiles of M rows (64, 32 or 16; fused_mlp.plan): CTA s of
// the cluster (a stage) holds layer s whole, converted to bf16 once and
// resident in shared memory for every tile the cluster takes, or, where
// the whole chain fits one CTA (the policy chain), all of it.  The grid is
// persistent: as many clusters as the card runs at once, up to one per
// tile.  A stage multiplies its bf16 input tile by its weights with
// mma.sync m16n8k16 (ldmatrix fragments; each of 16 warps one item of at
// most 32 rows x 32 columns), applies bias and activation in f32, and hands the
// bf16 activations to the next stage: st.async of 16-byte chunks into the
// next CTA's input tile, counted on that CTA's mbarrier (full), once that
// CTA has freed the tile (its arrival on this CTA's mbarrier, empty).  So
// each layer's activations move once, CTA to CTA, and no barrier spans the
// cluster between layers.  Stage 0 loads the next tile of x with cp.async
// while the tensor cores work on this one (two staging slots where shared
// memory allows, else one filled right after it is read).
//
// bf16 backward, two launches.
//   bwd_rows_kernel  the same clusters and resident layers, in two passes.
//                    The forward, but its last layer, writes every a_i in
//                    bf16 (a_0 = bf16(x)) and act'(z_i) in f32 to a global
//                    scratch.  Then the reverse pass, the pipeline run
//                    backwards: stage i forms g_i = dL/da_{i+1} * act'(z_i)
//                    (g_{L-1}: the incoming gradient), writes g_i in bf16
//                    and db's per-tile column sums of the f32 g_i, and hands
//                    dL/da_i = bf16(g_i) @ W_i^T (B by ldmatrix.trans from
//                    the same resident W_i) in f32 to stage i - 1, or writes
//                    it as dx (an input wider than 256 columns in a second
//                    round of warp items, columns 256 on).
//   dw_kernel        dW_i = a_i^T g_i: one block per 64x64 dW tile and slice
//                    of rows, bf16 chunks of 64 rows in a three-stage
//                    cp.async ring, mma.sync with ldmatrix.trans fragments.
//                    The last block of a tile to finish (an integer ticket)
//                    sums the slices' partials in slice order, and db's
//                    per-tile partials in tile order.
// No float atomics: every sum across blocks runs in a fixed order, so two
// calls give the same bits.
//
// Shared-memory layout: make_layout below; fused_mlp.py::layout mirrors it
// and the launchers check the bytes and stages they were given against
// their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MAX_WIDTH 256
#define MAX_IN_WIDTH 352  // d_0: kpad_0 + 8 bf16 columns of 256 rows fit at a 16-row backward tile
static_assert(MAX_IN_WIDTH <= 2 * MAX_WIDTH, "dx takes at most two rounds of warp items");
#define MAX_LAYERS 8
#define THREADS 256         // the dW pass and the f32 kernels
#define PT 512              // the pipeline kernels: 16 warps, an item each
#define PW (PT / 32)
#define SMEM_LIMIT 232448
#define MAX_CLUSTER 8
#define DW_TILE 64    // dW tile edge
#define DW_ROWS 64    // rows per staged chunk of the dW pass
#define DW_STAGES 3   // chunks in flight
#define DW_LD 72      // bf16 row stride of a staged chunk
#define DW_SMEM (DW_STAGES * 2 * DW_ROWS * DW_LD * 2)
#define SCRATCH_ALIGN 256
#define STAGE_UNROLL 4  // float4 pairs in flight per thread while staging weights

enum { ACT_SWISH = 0, ACT_RELU = 1, ACT_TANH = 2 };

struct Chain {
  int n_layers;
  int dims[MAX_LAYERS + 1];
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
};

// ---------------------------------------------------------------------------
// the launch layout (fused_mlp.py::plan mirrors it)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int rup(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// The cluster is a pipeline: stage s (CTA rank s) holds layers lo[s]..hi[s],
// whole, as bf16 W^T [npad][kpad + 8] followed by their f32 biases: the
// whole chain in one CTA where it fits beside the tiles, else a layer per
// CTA (every CTA has the same bytes).  bytes > SMEM_LIMIT: the chain does
// not fit at these rows.
struct Layout {
  int n_layers, stages, rows, xstages, backward;
  int kpad[MAX_LAYERS];      // d_i rounded up to 16
  int npad[MAX_LAYERS];      // d_{i+1} rounded up to 16
  int ldw[MAX_LAYERS];       // kpad + 8
  int w_off[MAX_LAYERS];     // W_i^T in its stage's shared memory (bytes)
  int bias_off[MAX_LAYERS];
  int lo[MAX_CLUSTER], hi[MAX_CLUSTER];
  int lda, ldr, ldg;         // row strides: bf16 tiles, f32 tile, bf16 g tile
  int r_off;                 // forward: the bf16 input tile [rows][lda]
  int x_off, x_slot;         // stage 0: x staging slots (f32 [rows][d_0])
  int rf_off, ds_off, gs_off, cs_off;  // backward reverse pass (share r_off..)
  int bar_off;               // four mbarriers
  int bytes;
};

#define UNFIT (1 << 30)

__host__ __device__ constexpr Layout make_layout(int L, const int* dims, int M, int xstages,
                                                 int backward) {
  Layout s{};
  s.n_layers = L;
  s.rows = M;
  s.xstages = xstages;
  s.backward = backward;
  int kmax = 0, nmax = 0;
  for (int i = 0; i < L; ++i) {
    s.kpad[i] = rup(dims[i], 16);
    s.npad[i] = rup(dims[i + 1], 16);
    s.ldw[i] = s.kpad[i] + 8;
    kmax = imax(kmax, s.kpad[i]);
    nmax = imax(nmax, s.npad[i]);
  }
  s.lda = kmax + 8;
  // the f32 tiles hold dL/da_{i+1} and act'(z_i), never the input's width
  s.ldr = imin(kmax, MAX_WIDTH) + 4;
  s.ldg = nmax + 8;
  s.x_slot = rup(M * dims[0] * 4, 16);
  const int fwd_tiles = M * s.lda * 2 + xstages * s.x_slot;
  const int bwd_tiles = 2 * M * s.ldr * 4 + M * s.ldg * 2 + 2 * MAX_WIDTH * 4;
  const int tiles = backward ? imax(fwd_tiles, bwd_tiles) : fwd_tiles;
  const int capacity = SMEM_LIMIT - tiles - 32;
  int total = 0;
  for (int i = 0; i < L; ++i) total += s.npad[i] * s.ldw[i] * 2 + s.npad[i] * 4;
  const bool one = total <= capacity;  // the whole chain in one CTA, else a layer per CTA
  int stage = 0, used = 0, top = 0;
  for (int i = 0; i < L; ++i) {
    const int need = s.npad[i] * s.ldw[i] * 2 + s.npad[i] * 4;
    if (i > 0 && !one) {
      ++stage;
      used = 0;
    }
    if (used == 0) s.lo[stage] = i;
    s.hi[stage] = i;
    s.w_off[i] = used;
    s.bias_off[i] = used + s.npad[i] * s.ldw[i] * 2;
    used += need;
    top = imax(top, used);
  }
  s.stages = stage + 1;
  int off = rup(top, 128);
  s.r_off = off;
  s.x_off = off + M * s.lda * 2;
  s.rf_off = off;
  s.ds_off = off + M * s.ldr * 4;
  s.gs_off = s.ds_off + M * s.ldr * 4;
  s.cs_off = s.gs_off + M * s.ldg * 2;
  off += tiles;
  s.bar_off = rup(off, 8);
  s.bytes = s.bar_off + 32;
  if (top > capacity) s.bytes = UNFIT;
  return s;
}

// The PPO ant and halfcheetah recipes' chains, SAC's critics and the
// widest chains the kernel takes, at the plans fused_mlp.plan picks for them (tests/test_torch_fused_launch.py
// reads these lines and holds plan() to the same bytes and stages).
#define LAYOUT_CHECK(chain, m, xs, bw, want, want_stages)                                     \
  static_assert(make_layout(sizeof(chain) / sizeof(int) - 1, chain, m, xs, bw).bytes == want &&  \
                    make_layout(sizeof(chain) / sizeof(int) - 1, chain, m, xs, bw).stages ==     \
                        want_stages,                                                            \
                #chain " layout")
constexpr int VALUE87[] = {87, 256, 256, 256, 256, 256, 1};
constexpr int VALUE27[] = {27, 256, 256, 256, 256, 256, 1};
constexpr int POLICY87[] = {87, 32, 32, 32, 32, 16};
constexpr int WIDE8[] = {256, 256, 256, 256, 256, 256, 256, 256, 256};
// halfcheetah's: an 18-wide input, padded to 32 columns; 6 actions, a 12-wide head
constexpr int VALUE18[] = {18, 256, 256, 256, 256, 256, 1};
constexpr int POLICY18[] = {18, 32, 32, 32, 32, 12};
LAYOUT_CHECK(VALUE87, 64, 2, 0, 214560, 6);
LAYOUT_CHECK(VALUE87, 32, 2, 1, 221728, 6);
LAYOUT_CHECK(VALUE27, 64, 2, 0, 183840, 6);
LAYOUT_CHECK(VALUE27, 32, 2, 1, 221728, 6);
LAYOUT_CHECK(POLICY87, 16, 2, 0, 30752, 1);
LAYOUT_CHECK(POLICY87, 16, 2, 1, 32416, 1);
LAYOUT_CHECK(WIDE8, 32, 2, 0, 218656, 8);
LAYOUT_CHECK(WIDE8, 32, 2, 1, 221728, 8);
LAYOUT_CHECK(VALUE18, 64, 2, 0, 179232, 6);
LAYOUT_CHECK(VALUE18, 32, 2, 1, 221728, 6);
LAYOUT_CHECK(POLICY18, 16, 2, 0, 15776, 1);
LAYOUT_CHECK(POLICY18, 16, 2, 1, 20128, 1);
// SAC's critics: humanoid's obs and action, 240 + 17 = 257 wide (padded to
// 272: a stage per layer, 16-row tiles), halfcheetah's 18 + 6 (the whole
// chain in one CTA), and the widest input, MAX_IN_WIDTH, at the 16-row
// tile and one x staging slot it fits at
constexpr int Q257[] = {257, 256, 256, 1};
constexpr int Q24[] = {24, 256, 256, 1};
constexpr int QWIDEST[] = {352, 256, 256, 1};
static_assert(QWIDEST[0] == MAX_IN_WIDTH, "QWIDEST is the widest input");
LAYOUT_CHECK(Q257, 16, 2, 0, 186272, 3);
LAYOUT_CHECK(Q257, 16, 2, 1, 188192, 3);
LAYOUT_CHECK(Q24, 16, 2, 0, 177824, 1);
LAYOUT_CHECK(Q24, 16, 2, 1, 210080, 1);
LAYOUT_CHECK(QWIDEST, 16, 1, 0, 219424, 3);
LAYOUT_CHECK(QWIDEST, 16, 1, 1, 229152, 3);

// ---------------------------------------------------------------------------
// primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// 16 bytes global -> shared in flight; zeros when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared::cluster address of *p in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// this CTA's arrival on its own barrier, expecting `bytes` from other CTAs
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// an arrival on a barrier of another CTA of the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint32_t cluster_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(cluster_bar)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.  A phase
// that never completes is a fault of the kernel: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// 16 bytes into another CTA's shared memory, counted on its barrier
__device__ __forceinline__ void st_async16(uint32_t cluster_dst, uint4 v, uint32_t cluster_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::
          "r"(cluster_dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(cluster_bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// fragments and arithmetic
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// swish's sigmoid with the hardware's exp2 and reciprocal (f32, within a
// few ulps of 1 / (1 + expf(-z)); 0 where exp(-z) overflows)
__device__ __forceinline__ float sigmoid_fast(float z) { return __fdividef(1.0f, 1.0f + __expf(-z)); }

template <int ACT>
__device__ __forceinline__ float act_f(float z) {
  if (ACT == ACT_SWISH) return z * sigmoid_fast(z);
  if (ACT == ACT_RELU) return z > 0.0f ? z : 0.0f;
  return tanhf(z);
}

template <int ACT>
__device__ __forceinline__ float act_g(float z) {
  if (ACT == ACT_SWISH) {
    const float s = sigmoid_fast(z);
    return s * (1.0f + z * (1.0f - s));
  }
  if (ACT == ACT_RELU) return z > 0.0f ? 1.0f : 0.0f;
  const float t = tanhf(z);
  return 1.0f - t * t;
}

__device__ __forceinline__ float act_fwd(int act, float z) {
  return act == ACT_SWISH ? act_f<ACT_SWISH>(z) : act == ACT_RELU ? act_f<ACT_RELU>(z) : act_f<ACT_TANH>(z);
}

__device__ __forceinline__ float act_grad(int act, float z) {
  return act == ACT_SWISH ? act_g<ACT_SWISH>(z) : act == ACT_RELU ? act_g<ACT_RELU>(z) : act_g<ACT_TANH>(z);
}

__device__ __forceinline__ uint32_t sel4(const uint32_t* v, int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// A warp's item of an output tile: rows rb.. (two 16-row tiles at 64 rows,
// one at 32 or 16), columns cb.. (up to four 8-column tiles; two at 16
// rows).  Every tile of at most 64 rows and 256 columns is at most one
// item per warp: 2 x 8 items at 64 and 32 rows, 1 x 16 at 16.  A wider
// tile (dx of an input wider than 256) takes a second round of items, its
// columns from `base` = 256 on.
struct Item {
  int rb, cb, mts, nts;
  bool active;
};

__device__ __forceinline__ Item warp_item(int rows, int cols, int base = 0) {
  const int w = threadIdx.x >> 5;
  Item it;
  if (rows == 16) {
    it.rb = 0;
    it.cb = base + w * 16;
    it.mts = 1;
    it.nts = min(2, (cols - it.cb) / 8);
  } else {
    it.rb = (w >> 3) * (rows / 2);
    it.cb = base + (w & 7) * 32;
    it.mts = rows / 32;
    it.nts = min(4, (cols - it.cb) / 8);
  }
  it.active = it.cb < cols;
  return it;
}

// acc[0..MT)[0..2 NP) = A [rows][k] (row-major, stride lda) @ B over k in
// [0, K), where B[k][n] = Wt[n][k] (TRANS false: the forward, n over the
// item's columns) or B[k][n] = Wt[k][n] (TRANS true: the transposed
// product, k over W's output columns, n over its inputs).  K is a multiple
// of 16.  A k-step's fragments load together before its 2 MT NP products.
template <bool TRANS, int MT, int NP>
__device__ __forceinline__ void item_mma_n(float (&acc)[2][4][4], const Item& it, const bf16* A,
                                           int lda, const bf16* Wt, int ldw, int K) {
  const int lane = threadIdx.x & 31, q = lane >> 3, l7 = lane & 7;
  const bf16* ap = A + (it.rb + l7 + (q & 1) * 8) * lda + (q >> 1) * 8;
  // rows n of Wt: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15);
  // transposed: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const bf16* bp = TRANS ? Wt + (l7 + (q & 1) * 8) * ldw + it.cb + (q >> 1) * 8
                         : Wt + (it.cb + l7 + (q >> 1) * 8) * ldw + (q & 1) * 8;
  const int b_step = TRANS ? 16 * ldw : 16, b_pair = TRANS ? 16 : 16 * ldw;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4], b[NP][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) ldsm_x4(a[mi], ap + 16 * mi * lda + k0);
#pragma unroll
    for (int jp = 0; jp < NP; ++jp) {
      if (TRANS)
        ldsm_x4_trans(b[jp], bp + (k0 / 16) * b_step + jp * b_pair);
      else
        ldsm_x4(b[jp], bp + (k0 / 16) * b_step + jp * b_pair);
    }
#pragma unroll
    for (int jp = 0; jp < NP; ++jp)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16(acc[mi][2 * jp], a[mi], b[jp][0], b[jp][1]);
        mma_bf16(acc[mi][2 * jp + 1], a[mi], b[jp][2], b[jp][3]);
      }
  }
}

template <bool TRANS>
__device__ __forceinline__ void item_mma(float (&acc)[2][4][4], const Item& it, const bf16* A,
                                         int lda, const bf16* Wt, int ldw, int K) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
  if (!it.active) return;
  switch (it.mts * 8 + it.nts / 2) {
    case 9: item_mma_n<TRANS, 1, 1>(acc, it, A, lda, Wt, ldw, K); break;
    case 10: item_mma_n<TRANS, 1, 2>(acc, it, A, lda, Wt, ldw, K); break;
    case 17: item_mma_n<TRANS, 2, 1>(acc, it, A, lda, Wt, ldw, K); break;
    default: item_mma_n<TRANS, 2, 2>(acc, it, A, lda, Wt, ldw, K); break;
  }
}

// The item's values f(row, col, acc) as bf16, 16 bytes per lane: the four
// lanes of a quad swap their pairs so that lane t holds row g + 8 (t & 1)
// of 8-column tile 2 jp + (t >> 1), eight columns: chunk[mi][jp], at
// chunk_row / chunk_col.
template <typename F>
__device__ __forceinline__ void item_pack_bf16(const float (&acc)[2][4][4], const Item& it, F f,
                                               uint4 (&chunk)[2][2]) {
  if (!it.active) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp)
      if (mi < it.mts && 2 * jp < it.nts) {
        const int r0 = it.rb + 16 * mi + g, c0 = it.cb + 16 * jp + 2 * t;
        uint32_t v[4];  // index nt * 2 + h: 8-column tile 2 jp + nt, row g + 8 h
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            v[nt * 2 + h] = pack_bf16(f(r0 + 8 * h, c0 + 8 * nt, acc[mi][2 * jp + nt][2 * h]),
                                      f(r0 + 8 * h, c0 + 8 * nt + 1, acc[mi][2 * jp + nt][2 * h + 1]));
        uint32_t got[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) got[r] = __shfl_xor_sync(0xffffffffu, sel4(v, t ^ r), r);
        // element s of this lane's chunk came from lane s = t ^ r
        chunk[mi][jp] = make_uint4(sel4(got, t), sel4(got, t ^ 1), sel4(got, t ^ 2), sel4(got, t ^ 3));
      }
}

__device__ __forceinline__ int chunk_row(const Item& it, int mi) {
  return it.rb + 16 * mi + ((threadIdx.x & 31) >> 2) + 8 * (threadIdx.x & 1);
}

__device__ __forceinline__ int chunk_col(const Item& it, int jp) {
  return it.cb + 16 * jp + 8 * ((threadIdx.x >> 1) & 1);
}

template <typename Put>
__device__ __forceinline__ void item_put_bf16(const uint4 (&chunk)[2][2], const Item& it, Put put) {
  if (!it.active) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp)
      if (mi < it.mts && 2 * jp < it.nts) put(chunk_row(it, mi), chunk_col(it, jp), chunk[mi][jp]);
}

// The item's f32 values in place as 16-byte chunks: lanes t and t^1 swap
// halves so that the even lane holds row g's columns 2t..2t+3 and the odd
// one row g+8's 2(t-1)..2t+1 (acc[mi][j] becomes that float4).
__device__ __forceinline__ void item_pack_f32(float (&acc)[2][4][4], const Item& it) {
  if (!it.active) return;
  const bool odd = threadIdx.x & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (mi < it.mts && j < it.nts) {
        float* v = acc[mi][j];
        const float g0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const float g1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        if (odd) {
          v[0] = g0;
          v[1] = g1;
        } else {
          v[2] = g0;
          v[3] = g1;
        }
      }
}

template <typename Put>
__device__ __forceinline__ void item_put_f32(const float (&acc)[2][4][4], const Item& it, Put put) {
  if (!it.active) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (mi < it.mts && j < it.nts)
        put(it.rb + 16 * mi + g + 8 * (t & 1), it.cb + 8 * j + 2 * (t & 2),
            make_float4(acc[mi][j][0], acc[mi][j][1], acc[mi][j][2], acc[mi][j][3]));
}

// ---------------------------------------------------------------------------
// the pipeline kernels' pieces
// ---------------------------------------------------------------------------

// Stage s's layers as bf16 W^T [npad][ldw] (zero outside the layer) and f32
// biases.  Once per block.
__device__ void stage_weights(const Chain& ch, const Layout& lay, int s, unsigned char* smem) {
  for (int i = lay.lo[s]; i <= lay.hi[s]; ++i) {
    const int K = ch.dims[i], N = ch.dims[i + 1], np = lay.npad[i], ldw = lay.ldw[i];
    bf16* Wt = reinterpret_cast<bf16*>(smem + lay.w_off[i]);
    float* bias = reinterpret_cast<float*>(smem + lay.bias_off[i]);
    const float* W = ch.w[i];
    // rows (k, k+1) by column, the column fastest: reads of W's rows are
    // coalesced, and each thread writes bf16 pairs.  Where W's rows are
    // float4-aligned, a thread takes four columns, STAGE_UNROLL of them in
    // flight.
    const int kq_total = lay.kpad[i] / 2;
    if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0) {
      const float4* W4 = reinterpret_cast<const float4*>(W);
      const int q4 = np / 4, total = kq_total * q4, n4 = N / 4;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int e0 = threadIdx.x; e0 < total; e0 += STAGE_UNROLL * PT) {
        float4 v0[STAGE_UNROLL], v1[STAGE_UNROLL];
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
          const int e = e0 + u * PT, kq = e / q4, nq = e - kq * q4;
          const int k = 2 * kq, col = 4 * nq;
          const bool ok = e < total && col < N;
          v0[u] = ok && k < K ? W4[(size_t)k * n4 + nq] : zero;
          v1[u] = ok && k + 1 < K ? W4[(size_t)(k + 1) * n4 + nq] : zero;
        }
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
          const int e = e0 + u * PT, kq = e / q4, nq = e - kq * q4;
          if (e < total) {
            uint32_t* dst = reinterpret_cast<uint32_t*>(Wt + 4 * nq * ldw + 2 * kq);
            dst[0] = pack_bf16(v0[u].x, v1[u].x);
            dst[ldw / 2] = pack_bf16(v0[u].y, v1[u].y);
            dst[ldw] = pack_bf16(v0[u].z, v1[u].z);
            dst[3 * ldw / 2] = pack_bf16(v0[u].w, v1[u].w);
          }
        }
      }
    } else {
      const int total = kq_total * np;
      for (int e = threadIdx.x; e < total; e += PT) {
        const int kq = e / np, col = e - kq * np, k = 2 * kq;
        float v0 = 0.0f, v1 = 0.0f;
        if (col < N) {
          if (k < K) v0 = W[(size_t)k * N + col];
          if (k + 1 < K) v1 = W[(size_t)(k + 1) * N + col];
        }
        *reinterpret_cast<uint32_t*>(Wt + col * ldw + k) = pack_bf16(v0, v1);
      }
    }
    for (int c = threadIdx.x; c < np; c += PT) bias[c] = c < N ? ch.b[i][c] : 0.0f;
  }
}

// rows [row0, row0 + rows) of x [n][d0] into a staging slot, in flight
__device__ void load_x(float* slot, const float* x, int row0, int rows, int d0) {
  const float* src = x + (size_t)row0 * d0;
  const int total = rows * d0;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = total / 4;
    for (int v = threadIdx.x; v < nv; v += PT) cp_async16(slot + 4 * v, src + 4 * v, true);
    done = 4 * nv;
  }
  for (int e = done + threadIdx.x; e < total; e += PT) cp_async4(slot + e, src + e);
}

// Waits for the tile's x, converts it to the bf16 tile A (zero past the
// valid rows and past d0), and starts loading the cluster's next tile.
__device__ void next_x(const Layout& lay, float* xs, bf16* A, const float* x, int n, int d0,
                       int it, int tile, int stride, int valid) {
  const int M = lay.rows, next = tile + stride, tiles = (n + M - 1) / M;
  const int slot_f = lay.x_slot / 4;
  float* cur = xs;
  if (lay.xstages == 2) {
    if (next < tiles) load_x(xs + ((it + 1) & 1) * slot_f, x, next * M, min(M, n - next * M), d0);
    cp_async_commit();
    cp_async_wait<1>();
    cur = xs + (it & 1) * slot_f;
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, kp0 = lay.kpad[0];
  for (int r = warp; r < M; r += PW)
    for (int c = 2 * lane; c < kp0; c += 64) {
      float v0 = 0.0f, v1 = 0.0f;
      if (r < valid) {
        if (c < d0) v0 = cur[r * d0 + c];
        if (c + 1 < d0) v1 = cur[r * d0 + c + 1];
      }
      *reinterpret_cast<uint32_t*>(A + r * lay.lda + c) = pack_bf16(v0, v1);
    }
  __syncthreads();
  if (lay.xstages == 1) {
    if (next < tiles) load_x(xs, x, next * M, min(M, n - next * M), d0);
    cp_async_commit();
  }
}

// mbarriers: [0] my input tile is full, [1] my successor's input tile is
// empty (forward); [2], [3] the same for the reverse pass (predecessor).
enum { BAR_FULL = 0, BAR_EMPTY = 1, BAR_FULL_BWD = 2, BAR_EMPTY_BWD = 3 };

__device__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 4; ++b) mbar_init(bars + b, 1);
    mbar_fence_init();
  }
}

struct Scratch {
  bf16* a[MAX_LAYERS];    // a_i [n][kpad_i], a_0 = bf16(x)
  float* d[MAX_LAYERS];   // act'(z_i) [n][npad_i], i < n_layers - 1
  bf16* g[MAX_LAYERS];    // g_i = dL/dz_i [n][npad_i]
  float* dbp;             // [row tiles][db_stride]: per-tile column sums of g_i
  int db_off[MAX_LAYERS];
  int db_stride;
  int* counters;          // the dW pass's tickets, one per dW tile
  int n_counters;
};

// The forward through this stage's layers, for every tile the cluster
// takes.  Stage 0 converts x; another stage waits for its predecessor's
// tile.  Between its own layers a stage keeps the bf16 tile in place; at
// its last layer it frees its input tile for the predecessor, packs the
// activations, waits until its successor's input tile is free and sends
// them there (st.async, 16 bytes per lane, counted on the successor's
// barrier).  The stage with layer n_layers - 1 writes y; with STORE (the
// backward's first pass) every a_{i+1} goes to the scratch instead and
// layer n_layers - 1 is not computed.
template <bool STORE, int ACT>
__device__ void forward_pass(const Chain& ch, const Layout& lay, const Scratch& sc, unsigned char* smem,
                             const float* x, float* y, int n) {
  const int S = lay.stages, M = lay.rows, s = cluster_rank(), L = ch.n_layers;
  const int last = STORE ? L - 2 : L - 1;  // the last layer computed
  const int lo = lay.lo[s], hi = min(lay.hi[s], last);
  const int d0 = ch.dims[0], dL = ch.dims[L];
  const int tiles = (n + M - 1) / M, stride = gridDim.x / S;
  bf16* A = reinterpret_cast<bf16*>(smem + lay.r_off);
  float* xs = reinterpret_cast<float*>(smem + lay.x_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  const bool works = lo <= hi;
  const bool sends = works && s + 1 < S && lay.lo[s + 1] <= last;
  const bool receives = works && s > 0;
  const uint32_t next_tile = sends ? cluster_addr(A, s + 1) : 0;
  const uint32_t next_full = sends ? cluster_addr(bars + BAR_FULL, s + 1) : 0;
  const uint32_t prev_empty = receives ? cluster_addr(bars + BAR_EMPTY, s - 1) : 0;
  const int lda = lay.lda;
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t4 = lane & 3;
  int tile = blockIdx.x / S;
  if (!works && !(STORE && s == 0)) return;  // stage 0 still writes a_0
  for (int it = 0; tile < tiles; tile += stride, ++it) {
    const int row0 = tile * M, valid = min(M, n - row0);
    if (s == 0) {
      next_x(lay, xs, A, x, n, d0, it, tile, stride, valid);
      if (STORE) {  // a_0 = bf16(x)
        const int kp0 = lay.kpad[0], vec = kp0 / 8;
        for (int e = threadIdx.x; e < valid * vec; e += PT) {
          const int r = e / vec, q = e - r * vec;
          *reinterpret_cast<uint4*>(sc.a[0] + (size_t)(row0 + r) * kp0 + 8 * q) =
              *reinterpret_cast<const uint4*>(A + r * lda + 8 * q);
        }
      }
    } else if (works) {
      if (threadIdx.x == 0) mbar_expect(bars + BAR_FULL, M * lay.kpad[lo] * 2);
      mbar_wait(bars + BAR_FULL, it & 1);
    }
    for (int i = lo; i <= hi; ++i) {
      const Item item = warp_item(M, lay.npad[i]);
      float acc[2][4][4];
      item_mma<false>(acc, item, A, lda, reinterpret_cast<const bf16*>(smem + lay.w_off[i]),
                      lay.ldw[i], lay.kpad[i]);
      const float* bias = reinterpret_cast<const float*>(smem + lay.bias_off[i]);
      const bool out_here = i < hi;
      __syncthreads();  // every warp has read the tile
      if (!out_here && receives && threadIdx.x == 0) mbar_arrive_remote(prev_empty);
      if (!STORE && i == L - 1) {
        if (item.active)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = item.rb + 16 * mi + g4 + 8 * h, c = item.cb + 8 * j + 2 * t4;
                if (mi < item.mts && j < item.nts && r < valid) {
                  float* yr = y + (size_t)(row0 + r) * dL;
                  if (c < dL) yr[c] = acc[mi][j][2 * h] + bias[c];
                  if (c + 1 < dL) yr[c + 1] = acc[mi][j][2 * h + 1] + bias[c + 1];
                }
              }
        continue;
      }
      if (STORE && item.active) {  // act'(z_i) in f32, for the reverse pass
        float* d_out = sc.d[i];
        const int np = lay.npad[i];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = item.rb + 16 * mi + g4 + 8 * h, c = item.cb + 8 * j + 2 * t4;
              if (mi < item.mts && j < item.nts && r < valid)
                *reinterpret_cast<float2*>(d_out + (size_t)(row0 + r) * np + c) =
                    make_float2(act_g<ACT>(acc[mi][j][2 * h] + bias[c]),
                                act_g<ACT>(acc[mi][j][2 * h + 1] + bias[c + 1]));
            }
      }
      uint4 chunk[2][2];
      item_pack_bf16(acc, item, [&](int, int c, float z) { return act_f<ACT>(z + bias[c]); }, chunk);
      if (!out_here && sends) mbar_wait(bars + BAR_EMPTY, (it & 1) ^ 1);
      bf16* a_next = STORE ? sc.a[i + 1] : nullptr;
      const int kn = lay.npad[i];
      item_put_bf16(chunk, item, [&](int r, int c, uint4 v) {
        if (out_here)
          *reinterpret_cast<uint4*>(A + r * lda + c) = v;
        else if (sends)
          st_async16(next_tile + (uint32_t)(r * lda + c) * 2, v, next_full);
        if (STORE && r < valid) *reinterpret_cast<uint4*>(a_next + (size_t)(row0 + r) * kn + c) = v;
      });
      if (out_here) __syncthreads();
    }
  }
}

template <int ACT>
__device__ void forward_kernel_body(const Chain& ch, const Layout& lay, unsigned char* smem,
                                    const float* x, float* y, int n) {
  const int s = cluster_rank(), S = lay.stages, M = lay.rows;
  init_barriers(reinterpret_cast<uint64_t*>(smem + lay.bar_off));
  const int tile = blockIdx.x / S;
  if (s == 0 && tile < (n + M - 1) / M)
    load_x(reinterpret_cast<float*>(smem + lay.x_off), x, tile * M, min(M, n - tile * M), ch.dims[0]);
  cp_async_commit();
  cluster_sync();  // barriers initialised, every CTA of the cluster running
  stage_weights(ch, lay, s, smem);
  __syncthreads();
  Scratch none{};
  forward_pass<false, ACT>(ch, lay, none, smem, x, y, n);
  cluster_sync();  // no CTA leaves while another may still write into it
}

__global__ void __launch_bounds__(PT, 1)
    fwd_kernel(Chain ch, Layout lay, const float* __restrict__ x, float* __restrict__ y, int n,
               int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (act == ACT_SWISH)
    forward_kernel_body<ACT_SWISH>(ch, lay, smem, x, y, n);
  else if (act == ACT_RELU)
    forward_kernel_body<ACT_RELU>(ch, lay, smem, x, y, n);
  else
    forward_kernel_body<ACT_TANH>(ch, lay, smem, x, y, n);
}

// The reverse pass of stage s over its layers hi..lo for every tile: g_i =
// dL/da_{i+1} * act'(z_i), act'(z_i) in f32 from the forward pass (the
// scratch; g_{L-1} is the incoming gradient), then dL/da_i =
// bf16(g_i) @ W_i^T.  dL/da_{i+1} comes from the successor (f32, st.async)
// or from this stage's previous layer; dL/da_{lo} goes to the predecessor
// (or is dx).  g_i goes to the scratch in bf16 with db's per-tile sums.
template <int ACT>
__device__ void reverse_pass(const Chain& ch, const Layout& lay, const Scratch& sc, unsigned char* smem,
                             const float* gin, float* dx, int n) {
  const int S = lay.stages, M = lay.rows, s = cluster_rank(), L = ch.n_layers;
  const int lo = lay.lo[s], hi = lay.hi[s];
  const int d0 = ch.dims[0], dL = ch.dims[L];
  const int tiles = (n + M - 1) / M, stride = gridDim.x / S;
  float* Rf = reinterpret_cast<float*>(smem + lay.rf_off);
  float* Ds = reinterpret_cast<float*>(smem + lay.ds_off);
  bf16* Gs = reinterpret_cast<bf16*>(smem + lay.gs_off);
  float* cs = reinterpret_cast<float*>(smem + lay.cs_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  const bool sends = s > 0, receives = s + 1 < S;
  const uint32_t prev_tile = sends ? cluster_addr(Rf, s - 1) : 0;
  const uint32_t prev_full = sends ? cluster_addr(bars + BAR_FULL_BWD, s - 1) : 0;
  const uint32_t next_empty = receives ? cluster_addr(bars + BAR_EMPTY_BWD, s + 1) : 0;
  const int ldr = lay.ldr, ldg = lay.ldg;
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t4 = lane & 3;
  const int first = blockIdx.x / S;
  // act'(z_i) tiles, one step ahead: the steps (tile, i) with i < L - 1, i from hi down
  const int top = min(hi, L - 2);
  auto load_d = [&](int tile, int i) {
    const int row0 = tile * M, valid = min(M, n - row0), vec = lay.npad[i] / 4;
    for (int e = threadIdx.x; e < M * vec; e += PT) {
      const int r = e / vec, q = e - r * vec;
      cp_async16(Ds + r * ldr + 4 * q, sc.d[i] + (size_t)(row0 + (r < valid ? r : 0)) * lay.npad[i] + 4 * q,
                 r < valid);
    }
    cp_async_commit();
  };
  if (top >= lo && first < tiles) load_d(first, top);
  for (int it = 0, tile = first; tile < tiles; tile += stride, ++it) {
    const int row0 = tile * M, valid = min(M, n - row0);
    for (int i = hi; i >= lo; --i) {
      const int np = lay.npad[i], kp = lay.kpad[i];
      const bf16* Wt = reinterpret_cast<const bf16*>(smem + lay.w_off[i]);
      float* dbp = sc.dbp + (size_t)tile * sc.db_stride + sc.db_off[i];
      if (i == L - 1) {  // g = the incoming gradient, staged in Rf (the last stage receives nothing)
        for (int r = threadIdx.x >> 5; r < M; r += PW)
          for (int c = lane; c < np; c += 32)
            Rf[r * ldr + c] = r < valid && c < dL ? gin[(size_t)(row0 + r) * dL + c] : 0.0f;
        __syncthreads();
        for (int r = threadIdx.x >> 5; r < M; r += PW)
          for (int c = 2 * lane; c < np; c += 64) {
            const uint32_t v = pack_bf16(Rf[r * ldr + c], Rf[r * ldr + c + 1]);
            *reinterpret_cast<uint32_t*>(Gs + r * ldg + c) = v;
            if (r < valid) *reinterpret_cast<uint32_t*>(sc.g[i] + (size_t)(row0 + r) * np + c) = v;
          }
        for (int c = threadIdx.x; c < np; c += PT) {
          float sum = 0.0f;
          for (int r = 0; r < valid; ++r) sum += Rf[r * ldr + c];
          dbp[c] = sum;
        }
      } else {
        if (i == hi) {  // dL/da_{i+1} from the successor
          if (threadIdx.x == 0) mbar_expect(bars + BAR_FULL_BWD, M * np * 4);
          mbar_wait(bars + BAR_FULL_BWD, it & 1);
        }
        cp_async_wait<0>();
        __syncthreads();  // act'(z_i) has landed in every thread's view
        const Item item = warp_item(M, np);
        float acc[2][4][4];
        // g = dL/da_{i+1} * act'(z_i), at the item's fragment positions; rows
        // past the tile's valid ones are 0
        if (item.active)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = item.rb + 16 * mi + g4 + 8 * h, c = item.cb + 8 * j + 2 * t4;
                float2 v = make_float2(0.0f, 0.0f);
                if (mi < item.mts && j < item.nts && r < valid) {
                  const float2 dl = *reinterpret_cast<const float2*>(Rf + r * ldr + c);
                  const float2 d = *reinterpret_cast<const float2*>(Ds + r * ldr + c);
                  v = make_float2(dl.x * d.x, dl.y * d.y);
                }
                acc[mi][j][2 * h] = v.x;
                acc[mi][j][2 * h + 1] = v.y;
              }
        // db's per-tile sums: over the item's rows by shuffles, then over row groups in order
        if (item.active)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < item.nts) {
              float c0s = acc[0][j][0] + acc[0][j][2], c1s = acc[0][j][1] + acc[0][j][3];
              if (item.mts > 1) {
                c0s += acc[1][j][0] + acc[1][j][2];
                c1s += acc[1][j][1] + acc[1][j][3];
              }
#pragma unroll
              for (int m = 4; m < 32; m <<= 1) {
                c0s += __shfl_xor_sync(0xffffffffu, c0s, m);
                c1s += __shfl_xor_sync(0xffffffffu, c1s, m);
              }
              if (g4 == 0) {
                float* row = cs + (item.rb ? 1 : 0) * MAX_WIDTH;  // this item's row group
                row[item.cb + 8 * j + 2 * t4] = c0s;
                row[item.cb + 8 * j + 2 * t4 + 1] = c1s;
              }
            }
        uint4 chunk[2][2];
        item_pack_bf16(acc, item, [](int, int, float v) { return v; }, chunk);
        bf16* g_out = sc.g[i];
        item_put_bf16(chunk, item, [&](int r, int c, uint4 v) {
          *reinterpret_cast<uint4*>(Gs + r * ldg + c) = v;
          if (r < valid) *reinterpret_cast<uint4*>(g_out + (size_t)(row0 + r) * np + c) = v;
        });
        __syncthreads();  // Gs and the column sums are whole; Rf and Ds are read
        for (int c = threadIdx.x; c < np; c += PT) {
          float sum = cs[c];
          if (M > 16) sum += cs[MAX_WIDTH + c];  // the second row group
          dbp[c] = sum;
        }
        // the next act' tile into Ds
        if (i - 1 >= lo)
          load_d(tile, i - 1);
        else if (top >= lo && tile + stride < tiles)
          load_d(tile + stride, top);
      }
      if (i == lo && receives && threadIdx.x == 0) mbar_arrive_remote(next_empty);  // Rf is free
      __syncthreads();  // Gs is whole
      // dL/da_i = bf16(g) @ W_i^T; dx (i = 0) in rounds of 256 columns
      if (i == 0) {
        auto dx_round = [&](int base) {
          const Item item = warp_item(M, kp, base);
          float acc[2][4][4];
          item_mma<true>(acc, item, Gs, ldg, Wt, lay.ldw[i], np);
          if (item.active)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int r = item.rb + 16 * mi + g4 + 8 * h, c = item.cb + 8 * j + 2 * t4;
                  if (mi < item.mts && j < item.nts && r < valid) {
                    float* dr = dx + (size_t)(row0 + r) * d0;
                    if (c < d0) dr[c] = acc[mi][j][2 * h];
                    if (c + 1 < d0) dr[c + 1] = acc[mi][j][2 * h + 1];
                  }
                }
        };
        dx_round(0);
        if (kp > MAX_WIDTH) dx_round(MAX_WIDTH);  // an input wider than 256 (kp <= MAX_IN_WIDTH)
      } else {
        const Item item = warp_item(M, kp);
        float acc[2][4][4];
        item_mma<true>(acc, item, Gs, ldg, Wt, lay.ldw[i], np);
        item_pack_f32(acc, item);
        if (i > lo) {
          item_put_f32(acc, item, [&](int r, int c, float4 v) { *reinterpret_cast<float4*>(Rf + r * ldr + c) = v; });
        } else {
          mbar_wait(bars + BAR_EMPTY_BWD, (it & 1) ^ 1);
          item_put_f32(acc, item, [&](int r, int c, float4 v) {
            st_async16(prev_tile + (uint32_t)(r * ldr + c) * 4,
                       make_uint4(__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z),
                                  __float_as_uint(v.w)),
                       prev_full);
          });
        }
      }
      __syncthreads();  // Rf (this stage's next layer) and Gs are free again
    }
  }
}

template <int ACT>
__device__ void backward_kernel_body(const Chain& ch, const Layout& lay, const Scratch& sc,
                                     unsigned char* smem, const float* x, const float* gin, float* dx,
                                     int n) {
  const int s = cluster_rank(), S = lay.stages, M = lay.rows;
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e < sc.n_counters; e += PT) sc.counters[e] = 0;
  init_barriers(reinterpret_cast<uint64_t*>(smem + lay.bar_off));
  const int tile = blockIdx.x / S;
  if (s == 0 && tile < (n + M - 1) / M)
    load_x(reinterpret_cast<float*>(smem + lay.x_off), x, tile * M, min(M, n - tile * M), ch.dims[0]);
  cp_async_commit();
  cluster_sync();  // barriers initialised, every CTA of the cluster running
  stage_weights(ch, lay, s, smem);
  __syncthreads();
  forward_pass<true, ACT>(ch, lay, sc, smem, x, nullptr, n);
  cp_async_wait<0>();
  cluster_sync();  // every a_i of the cluster's tiles is in the scratch; the tiles are free
  reverse_pass<ACT>(ch, lay, sc, smem, gin, dx, n);
  cluster_sync();
}

__global__ void __launch_bounds__(PT, 1)
    bwd_rows_kernel(Chain ch, Layout lay, Scratch sc, const float* __restrict__ x,
                    const float* __restrict__ gin, float* __restrict__ dx, int n, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (act == ACT_SWISH)
    backward_kernel_body<ACT_SWISH>(ch, lay, sc, smem, x, gin, dx, n);
  else if (act == ACT_RELU)
    backward_kernel_body<ACT_RELU>(ch, lay, sc, smem, x, gin, dx, n);
  else
    backward_kernel_body<ACT_TANH>(ch, lay, sc, smem, x, gin, dx, n);
}

struct DwPlan {
  int n_layers, tiles, slices, rows_per_slice, row_tiles, db_stride;
  int dims[MAX_LAYERS + 1];
  int kpad[MAX_LAYERS], npad[MAX_LAYERS];
  int tile_start[MAX_LAYERS + 1];
  int db_off[MAX_LAYERS];
  const bf16* a[MAX_LAYERS];
  const bf16* g[MAX_LAYERS];
  const float* dbp;
  float* part;  // [slices][tiles][DW_TILE * DW_TILE]
  int* counters;
  float* dw[MAX_LAYERS];
  float* db[MAX_LAYERS];
};

// One 64x64 tile of dW_i (blockIdx.x) over one slice of the rows
// (blockIdx.y), then, in the tile's last block, the sum over the slices.
__global__ void __launch_bounds__(THREADS) dw_kernel(DwPlan p, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int i = 0;
  while ((int)blockIdx.x >= p.tile_start[i + 1]) ++i;
  const int t = blockIdx.x - p.tile_start[i], ntn = (p.npad[i] + DW_TILE - 1) / DW_TILE;
  const int k0 = (t / ntn) * DW_TILE, n0 = (t % ntn) * DW_TILE;
  const int kp = p.kpad[i], np = p.npad[i];
  const int rb = blockIdx.y * p.rows_per_slice, re = min(n, rb + p.rows_per_slice);
  const int chunks = re > rb ? (re - rb + DW_ROWS - 1) / DW_ROWS : 0;
  bf16* stage = reinterpret_cast<bf16*>(smem);  // [DW_STAGES][a, g][DW_ROWS][DW_LD]
  const bf16* a_src = p.a[i];
  const bf16* g_src = p.g[i];
  auto load = [&](int chunk, int s) {
    bf16* as = stage + s * 2 * DW_ROWS * DW_LD;
    const int r0 = rb + chunk * DW_ROWS;
    for (int v = tid; v < 2 * DW_ROWS * 8; v += THREADS) {
      const int m = v / (DW_ROWS * 8), rr = (v / 8) % DW_ROWS, q = v % 8;
      const int row = r0 + rr;
      const int col = (m ? n0 : k0) + 8 * q, width = m ? np : kp;
      const bool ok = row < re && col < width;
      const bf16* src = (m ? g_src : a_src) + (ok ? (size_t)row * width + col : 0);
      cp_async16(as + (m * DW_ROWS + rr) * DW_LD + 8 * q, src, ok);
    }
  };
  float acc[4][4] = {};
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  const int mt = warp >> 1, nb = (warp & 1) * 32, q = lane >> 3, l7 = lane & 7;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int nx = chunk + DW_STAGES - 1;
    if (nx < chunks) load(nx, nx % DW_STAGES);
    cp_async_commit();
    cp_async_wait<DW_STAGES - 1>();
    __syncthreads();
    const bf16* as = stage + (chunk % DW_STAGES) * 2 * DW_ROWS * DW_LD;
    const bf16* gsm = as + DW_ROWS * DW_LD;
#pragma unroll
    for (int rr = 0; rr < DW_ROWS; rr += 16) {
      uint32_t a[4], b[4], b2[4];
      // A[m][kk] = a[rr + kk][m]: matrices (kk 0-7, m 0-7), (kk 0-7, m 8-15),
      // (kk 8-15, m 0-7), (kk 8-15, m 8-15) of the chunk, transposed
      ldsm_x4_trans(a, as + (rr + l7 + (q >> 1) * 8) * DW_LD + mt * 16 + (q & 1) * 8);
      // B[kk][n] = g[rr + kk][n]: (kk 0-7, n 0-7), (kk 8-15, n 0-7), then n 8-15
      ldsm_x4_trans(b, gsm + (rr + l7 + (q & 1) * 8) * DW_LD + nb + (q >> 1) * 8);
      ldsm_x4_trans(b2, gsm + (rr + l7 + (q & 1) * 8) * DW_LD + nb + 16 + (q >> 1) * 8);
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
      mma_bf16(acc[2], a, b2[0], b2[1]);
      mma_bf16(acc[3], a, b2[2], b2[3]);
    }
    __syncthreads();
  }
  float* part = p.part + ((size_t)blockIdx.y * p.tiles + blockIdx.x) * (DW_TILE * DW_TILE);
  const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g4 + 8 * h, c = nb + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(part + r * DW_TILE + c) = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  if (p.slices > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(p.counters + blockIdx.x, 1) == p.slices - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  } else {
    __syncthreads();
  }
  const int K = p.dims[i], N = p.dims[i + 1];
  for (int e = tid; e < DW_TILE * DW_TILE; e += THREADS) {
    const int m = e / DW_TILE, c = e % DW_TILE;
    if (k0 + m < K && n0 + c < N) {
      float s = 0.0f;
      for (int sl = 0; sl < p.slices; ++sl)
        s += __ldcg(p.part + ((size_t)sl * p.tiles + blockIdx.x) * (DW_TILE * DW_TILE) + e);
      p.dw[i][(size_t)(k0 + m) * N + n0 + c] = s;
    }
  }
  if (k0 == 0 && tid < DW_TILE && n0 + tid < N) {
    float s = 0.0f;
#pragma unroll 16
    for (int rt = 0; rt < p.row_tiles; ++rt)  // in order; the loads run ahead
      s += __ldcg(p.dbp + (size_t)rt * p.db_stride + p.db_off[i] + n0 + tid);
    p.db[i][n0 + tid] = s;
  }
}

// ---------------------------------------------------------------------------
// f32 mode: FFMA products, a 32-row tile per block, W streamed through
// shared memory (on no main path)
// ---------------------------------------------------------------------------

#define ROWS 32
#define LDH (MAX_IN_WIDTH + 4)    // f32 activation row stride (floats)
#define LDW32 (MAX_IN_WIDTH + 4)  // f32 weight-chunk row stride
#define KC32 32   // weight rows per chunk
#define H_BYTES (ROWS * LDH * 4)
#define F32_SMEM (H_BYTES + KC32 * LDW32 * 4)
#define COPY_UNROLL 8
#define RC 64     // dW pass: rows per staged chunk
#define LDS32 68  // dW pass: staging row stride

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

// store(r, c, load(r, c)) over a rows x cols grid with COPY_UNROLL loads in
// flight per thread; (r, c) advance by additions, never a division.
template <typename Load, typename Store>
__device__ __forceinline__ void block_copy(int rows, int cols, Load load, Store store) {
  const int total = rows * cols;
  const int dr = THREADS / cols, dc = THREADS - dr * cols;
  auto step = [&](int& r, int& c) {
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  };
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  for (int base = threadIdx.x; base < total; base += COPY_UNROLL * THREADS) {
    float v[COPY_UNROLL];
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

template <typename F>
__device__ __forceinline__ void for_tile(int rows, int cols, F fn) {
  for (int r = threadIdx.x / 32; r < rows; r += THREADS / 32)
    for (int c = threadIdx.x % 32; c < cols; c += 32) fn(r, c);
}

// H[:, :rup16(Nout)] = H[:, :Kc] @ B, B[k][j] = W[k*w_cols + j] (TRANS false)
// or W[j*w_cols + k] (TRANS true), for rup16(Nout) <= 64 QN.  Starts and
// ends with a block barrier.
template <bool TRANS, int QN>
__device__ void block_gemm_f32(const float* __restrict__ W, int w_cols, int Kc, int Nout, float* H,
                               float* WS) {
  const int tid = threadIdx.x, Kp = rup16(Kc), Np = rup16(Nout);
  const int rg = tid / 64, cg = tid % 64;  // rows rg*8 .. rg*8+7, columns cg + 64q
  float acc[8][QN];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < QN; ++q) acc[r][q] = 0.0f;
  for (int k0 = 0; k0 < Kp; k0 += KC32) {
    const int kc = min(KC32, Kp - k0);
    __syncthreads();
    if (TRANS)
      block_copy(Np, kc,
                 [&](int j, int kk) { return (k0 + kk < Kc && j < Nout) ? W[j * w_cols + k0 + kk] : 0.0f; },
                 [&](int j, int kk, float v) { WS[kk * LDW32 + j] = v; });
    else
      block_copy(kc, Np,
                 [&](int kk, int j) { return (k0 + kk < Kc && j < Nout) ? W[(k0 + kk) * w_cols + j] : 0.0f; },
                 [&](int kk, int j, float v) { WS[kk * LDW32 + j] = v; });
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float a[8], w[QN];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = H[(rg * 8 + r) * LDH + k0 + kk];
#pragma unroll
      for (int q = 0; q < QN; ++q)  // past 256 columns, only those in the chunk's row
        w[q] = q < 4 || cg + 64 * q < Np ? WS[kk * LDW32 + cg + 64 * q] : 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < QN; ++q) acc[r][q] = fmaf(a[r], w[q], acc[r][q]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < QN; ++q)
      if (cg + 64 * q < Np) H[(rg * 8 + r) * LDH + cg + 64 * q] = acc[r][q];
  __syncthreads();
}

__device__ void load_tile(float* H, const float* __restrict__ src, int n, int row0, int cols) {
  block_copy(ROWS, rup16(cols),
             [&](int r, int c) { return (row0 + r < n && c < cols) ? src[(size_t)(row0 + r) * cols + c] : 0.0f; },
             [&](int r, int c, float v) { H[r * LDH + c] = v; });
}

__global__ void __launch_bounds__(THREADS) fwd_f32_kernel(Chain ch, const float* __restrict__ x,
                                                         float* __restrict__ y, int n, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* H = reinterpret_cast<float*>(smem);
  float* WS = reinterpret_cast<float*>(smem + H_BYTES);
  const int row0 = blockIdx.x * ROWS;
  load_tile(H, x, n, row0, ch.dims[0]);
  for (int i = 0; i < ch.n_layers; ++i) {
    const int K = ch.dims[i], N = ch.dims[i + 1], Np = rup16(N);
    const bool last = i == ch.n_layers - 1;
    block_gemm_f32<false, 4>(ch.w[i], N, K, N, H, WS);
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

// z_i at zbuf + n * sum_{j<i} d_{j+1}, g_i at gbuf + the same, [n][d_{i+1}]
__device__ __forceinline__ size_t layer_offset(const Chain& ch, int i, int n) {
  size_t off = 0;
  for (int j = 0; j < i; ++j) off += ch.dims[j + 1];
  return off * (size_t)n;
}

__global__ void __launch_bounds__(THREADS) bwd_rows_f32_kernel(
    Chain ch, const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ dx,
    float* zbuf, float* gbuf, int n, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* H = reinterpret_cast<float*>(smem);
  float* WS = reinterpret_cast<float*>(smem + H_BYTES);
  const int row0 = blockIdx.x * ROWS;
  const int L = ch.n_layers;
  load_tile(H, x, n, row0, ch.dims[0]);
  for (int i = 0; i < L - 1; ++i) {
    const int K = ch.dims[i], N = ch.dims[i + 1], Np = rup16(N);
    block_gemm_f32<false, 4>(ch.w[i], N, K, N, H, WS);
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
  __syncthreads();
  load_tile(H, g, n, row0, ch.dims[L]);
  __syncthreads();
  for (int i = L - 1; i >= 0; --i) {
    const int K = ch.dims[i], N = ch.dims[i + 1], Kp = rup16(K);
    float* g_out = gbuf + layer_offset(ch, i, n);
    for_tile(ROWS, N, [&](int r, int c) {
      if (row0 + r < n) g_out[(size_t)(row0 + r) * N + c] = H[r * LDH + c];
    });
    if (Kp > MAX_WIDTH)  // dx of an input wider than 256
      block_gemm_f32<true, (MAX_IN_WIDTH + 63) / 64>(ch.w[i], N, N, K, H, WS);
    else
      block_gemm_f32<true, 4>(ch.w[i], N, N, K, H, WS);
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

// One 64x64 tile of dW_i (blockIdx.x) over one slice of the rows (blockIdx.y)
// into the slice's part of the workspace, db_i's where the tile starts at k = 0.
__global__ void __launch_bounds__(THREADS) dw_f32_kernel(Chain ch, Grads gr, const float* __restrict__ x,
                                                        const float* __restrict__ zbuf,
                                                        const float* __restrict__ gbuf, int n, int act) {
  __shared__ __align__(128) float sm[2 * RC * LDS32];
  const int tid = threadIdx.x;
  int i = 0;
  while ((int)blockIdx.x >= gr.tile_start[i + 1]) ++i;
  const int K = ch.dims[i], N = ch.dims[i + 1];
  const int t = blockIdx.x - gr.tile_start[i];
  const int ntn = (N + DW_TILE - 1) / DW_TILE;
  const int k0 = (t / ntn) * DW_TILE, n0 = (t % ntn) * DW_TILE;
  const bool do_db = k0 == 0;
  const int row_begin = blockIdx.y * gr.rows_per_slice;
  const int row_end = min(n, row_begin + gr.rows_per_slice);
  const float* a_src = i == 0 ? x : zbuf + layer_offset(ch, i - 1, n);
  const bool a_act = i > 0;
  const float* g_src = gbuf + layer_offset(ch, i, n);
  float* part = gr.part + (size_t)blockIdx.y * gr.slice_size;
  float* As32 = sm;
  float* Gs32 = sm + RC * LDS32;
  float db_acc = 0.0f;
  const int tx = tid % 16, ty = tid / 16;  // dW rows ty*4.., columns tx*4..
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
  for (int r0 = row_begin; r0 < row_end; r0 += RC) {
    __syncthreads();
    block_copy(RC, DW_TILE,
               [&](int r, int c) { return (r0 + r < row_end && k0 + c < K) ? a_src[(size_t)(r0 + r) * K + k0 + c] : 0.0f; },
               [&](int r, int c, float v) { As32[r * LDS32 + c] = a_act ? act_fwd(act, v) : v; });
    block_copy(RC, DW_TILE,
               [&](int r, int c) { return (r0 + r < row_end && n0 + c < N) ? g_src[(size_t)(r0 + r) * N + n0 + c] : 0.0f; },
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
    if (do_db && tid < DW_TILE)
      for (int r = 0; r < RC; ++r) db_acc += Gs32[r * LDS32 + tid];
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int m = k0 + ty * 4 + p, c = n0 + tx * 4 + q;
      if (m < K && c < N) part[gr.w_off[i] + (size_t)m * N + c] = acc[p][q];
    }
  if (do_db && tid < DW_TILE && n0 + tid < N) part[gr.b_off[i] + n0 + tid] = db_acc;
}

// dW_i (blockIdx.y = i) or db_i (blockIdx.y = L + i): the slices' partials
// summed slice by slice in order.
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static int make_chain(Chain* ch, int n_layers, const int* dims, const void* const* w,
                      const void* const* b) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return -1;
  ch->n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1 || dims[i] > (i ? MAX_WIDTH : MAX_IN_WIDTH)) return -2;
    ch->dims[i] = dims[i];
  }
  for (int i = 0; i < n_layers; ++i) {
    ch->w[i] = static_cast<const float*>(w[i]);
    ch->b[i] = static_cast<const float*>(b[i]);
  }
  return 0;
}

// The dynamic shared-memory ceiling of a kernel, raised once.
template <typename K>
static int allow_smem(K kernel, int bytes) {
  static int done = 0;
  if (done) return 0;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) done = 1;
  return err;
}

static int prepare(int kind) {
  switch (kind) {
    case 0: return allow_smem(fwd_kernel, SMEM_LIMIT);
    case 1: return allow_smem(bwd_rows_kernel, SMEM_LIMIT);
    case 2: return allow_smem(dw_kernel, DW_SMEM);
    case 3: return allow_smem(fwd_f32_kernel, F32_SMEM);
    default: return allow_smem(bwd_rows_f32_kernel, F32_SMEM);
  }
}

static void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks, int cluster,
                           int smem, cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(PT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The launch plan's own checks: the layout's stages and bytes must be those
// the caller reckoned (fused_mlp.py::plan), and fit.
static int make_plan_layout(Layout* lay, const Chain& ch, int cluster, int rows, int xstages,
                            int backward, int smem) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return -3;
  if (rows != 16 && rows != 32 && rows != 64) return -3;
  if (xstages != 1 && xstages != 2) return -3;
  *lay = make_layout(ch.n_layers, ch.dims, rows, xstages, backward);
  if (lay->bytes != smem || smem > SMEM_LIMIT || lay->stages != cluster) return -4;
  return 0;
}

extern "C" {

int brax_fused_mlp_max_width() { return MAX_WIDTH; }
int brax_fused_mlp_max_in_width() { return MAX_IN_WIDTH; }
int brax_fused_mlp_max_layers() { return MAX_LAYERS; }
int brax_fused_mlp_smem_limit() { return SMEM_LIMIT; }

// Clusters of `cluster` CTAs with `smem` bytes each that the card runs at
// once (kind 0 forward, 1 backward rows pass); negative: a CUDA error.
int brax_fused_mlp_max_clusters(int kind, int cluster, int smem) {
  int err = prepare(kind);
  if (err) return -err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, cluster, cluster, smem, 0);
  int count = 0;
  err = (int)(kind == 0 ? cudaOccupancyMaxActiveClusters(&count, fwd_kernel, &cfg)
                        : cudaOccupancyMaxActiveClusters(&count, bwd_rows_kernel, &cfg));
  return err ? -err : count;
}

// y [n, d_L] = chain(x [n, d_0]), bf16 products: `clusters` clusters of
// `cluster` CTAs (the pipeline's stages) over tiles of `rows` rows, with
// `stages` x staging slots.  Returns 0 or a CUDA error code
// (negative: bad arguments).
int brax_fused_mlp_fwd(const float* x, float* y, int n, int n_layers, const int* dims,
                       const void* const* w, const void* const* b, int act, int cluster, int rows,
                       int xstages, int clusters, int smem, void* stream) {
  Chain ch;
  int err = make_chain(&ch, n_layers, dims, w, b);
  if (err) return err;
  Layout lay;
  if ((err = make_plan_layout(&lay, ch, cluster, rows, xstages, 0, smem))) return err;
  if (n <= 0) return 0;
  if (clusters < 1) return -3;
  if ((err = prepare(0))) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, clusters * cluster, cluster, smem, static_cast<cudaStream_t>(stream));
  if ((err = (int)cudaLaunchKernelEx(&cfg, fwd_kernel, ch, lay, x, y, n, act))) return err;
  return (int)cudaGetLastError();
}

// Scratch of the bf16 backward, in this order, each part aligned to
// SCRATCH_ALIGN bytes: a_i (bf16 [n][kpad_i]) for every layer, act'(z_i)
// (f32 [n][npad_i]) for every layer but the last, g_i (bf16
// [n][npad_i]) for every layer, db's per-tile partials (f32 [row tiles][sum
// npad]), the dW partials (f32 [slices][dW tiles][64 * 64]) and the tickets
// (int [dW tiles]).  Returns its bytes.
static size_t carve(Scratch* sc, DwPlan* dp, unsigned char* base, const Layout& lay, int n,
                    int slices) {
  const int L = lay.n_layers;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + off;
    off += (bytes + SCRATCH_ALIGN - 1) / SCRATCH_ALIGN * SCRATCH_ALIGN;
    return p;
  };
  for (int i = 0; i < L; ++i) sc->a[i] = reinterpret_cast<bf16*>(take((size_t)n * lay.kpad[i] * 2));
  for (int i = 0; i < L; ++i)
    sc->d[i] = reinterpret_cast<float*>(take(i + 1 < L ? (size_t)n * lay.npad[i] * 4 : 0));
  for (int i = 0; i < L; ++i) sc->g[i] = reinterpret_cast<bf16*>(take((size_t)n * lay.npad[i] * 2));
  int db = 0, tiles = 0;
  dp->tile_start[0] = 0;
  for (int i = 0; i < L; ++i) {
    sc->db_off[i] = db;
    db += lay.npad[i];
    tiles += ((lay.kpad[i] + DW_TILE - 1) / DW_TILE) * ((lay.npad[i] + DW_TILE - 1) / DW_TILE);
    dp->tile_start[i + 1] = tiles;
  }
  sc->db_stride = db;
  const int row_tiles = (n + lay.rows - 1) / lay.rows;
  sc->dbp = reinterpret_cast<float*>(take((size_t)row_tiles * db * 4));
  dp->part = reinterpret_cast<float*>(take((size_t)slices * tiles * DW_TILE * DW_TILE * 4));
  sc->counters = reinterpret_cast<int*>(take((size_t)tiles * 4));
  sc->n_counters = tiles;
  dp->n_layers = L;
  dp->tiles = tiles;
  dp->slices = slices;
  dp->row_tiles = row_tiles;
  dp->db_stride = db;
  for (int i = 0; i < L; ++i) {
    dp->kpad[i] = lay.kpad[i];
    dp->npad[i] = lay.npad[i];
    dp->db_off[i] = sc->db_off[i];
    dp->a[i] = sc->a[i];
    dp->g[i] = sc->g[i];
  }
  dp->dbp = sc->dbp;
  dp->counters = sc->counters;
  return off;
}

// dx [n, d_0], dw[i] [d_i, d_{i+1}], db[i] [d_{i+1}] from x, g [n, d_L], bf16
// products.  The rows pass runs the plan of brax_fused_mlp_fwd with the
// backward's layout; the dW pass cuts the rows into `slices` slices of
// `rows_per_slice` rows.  `scratch` holds `scratch_bytes` (carve above).
int brax_fused_mlp_bwd(const float* x, const float* g, float* dx, void* const* dw, void* const* db,
                       void* scratch, size_t scratch_bytes, int n, int n_layers, const int* dims,
                       const void* const* w, const void* const* b, int act, int cluster, int rows,
                       int xstages, int clusters, int smem, int slices, int rows_per_slice,
                       void* stream) {
  Chain ch;
  int err = make_chain(&ch, n_layers, dims, w, b);
  if (err) return err;
  Layout lay;
  if ((err = make_plan_layout(&lay, ch, cluster, rows, xstages, 1, smem))) return err;
  if (slices < 1 || rows_per_slice < 1 || (size_t)slices * rows_per_slice < (size_t)n) return -3;
  if (n > 0 && clusters < 1) return -3;
  Scratch sc;
  DwPlan dp;
  if (carve(&sc, &dp, static_cast<unsigned char*>(scratch), lay, n, slices) != scratch_bytes) return -5;
  dp.rows_per_slice = rows_per_slice;
  for (int i = 0; i <= n_layers; ++i) dp.dims[i] = dims[i];
  for (int i = 0; i < n_layers; ++i) {
    dp.dw[i] = static_cast<float*>(dw[i]);
    dp.db[i] = static_cast<float*>(db[i]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if ((err = prepare(1))) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, clusters * cluster, cluster, smem, s);
    if ((err = (int)cudaLaunchKernelEx(&cfg, bwd_rows_kernel, ch, lay, sc, x, g, dx, n, act))) return err;
    if ((err = (int)cudaGetLastError())) return err;
  } else if (slices > 1) {
    return -3;  // the tickets are zeroed by the rows pass
  }
  if ((err = prepare(2))) return err;
  dw_kernel<<<dim3(dp.tiles, slices), THREADS, DW_SMEM, s>>>(dp, n);
  return (int)cudaGetLastError();
}

// f32 mode: y = chain(x), one block per 32 rows.
int brax_fused_mlp_fwd_f32(const float* x, float* y, int n, int n_layers, const int* dims,
                           const void* const* w, const void* const* b, int act, void* stream) {
  Chain ch;
  int err = make_chain(&ch, n_layers, dims, w, b);
  if (err) return err;
  if (n <= 0) return 0;
  if ((err = prepare(3))) return err;
  fwd_f32_kernel<<<(n + ROWS - 1) / ROWS, THREADS, F32_SMEM, static_cast<cudaStream_t>(stream)>>>(
      ch, x, y, n, act);
  return (int)cudaGetLastError();
}

// f32 mode backward.  zbuf holds n * sum_{i<L-1} d_{i+1} floats, gbuf
// n * sum_{i<L} d_{i+1}, part slices * (sum_i d_i d_{i+1} + sum_i d_{i+1}).
int brax_fused_mlp_bwd_f32(const float* x, const float* g, float* dx, void* const* dw,
                           void* const* db, float* zbuf, float* gbuf, float* part, int slices,
                           int n, int n_layers, const int* dims, const void* const* w,
                           const void* const* b, int act, void* stream) {
  Chain ch;
  int err = make_chain(&ch, n_layers, dims, w, b);
  if (err) return err;
  if (slices < 1) return -3;
  Grads gr;
  gr.tile_start[0] = 0;
  int off = 0, max_count = 1;
  for (int i = 0; i < n_layers; ++i) {
    gr.dw[i] = static_cast<float*>(dw[i]);
    gr.db[i] = static_cast<float*>(db[i]);
    int tiles = ((dims[i] + DW_TILE - 1) / DW_TILE) * ((dims[i + 1] + DW_TILE - 1) / DW_TILE);
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
  if (n > 0) {
    if ((err = prepare(4))) return err;
    bwd_rows_f32_kernel<<<(n + ROWS - 1) / ROWS, THREADS, F32_SMEM, s>>>(ch, x, g, dx, zbuf, gbuf, n, act);
    if ((err = (int)cudaGetLastError())) return err;
  }
  dw_f32_kernel<<<dim3(gr.tile_start[n_layers], slices), THREADS, 0, s>>>(ch, gr, x, zbuf, gbuf, n, act);
  if ((err = (int)cudaGetLastError())) return err;
  dim3 sums(min((max_count + THREADS - 1) / THREADS, 64), 2 * n_layers);
  reduce_kernel<<<sums, THREADS, 0, s>>>(ch, gr, slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
