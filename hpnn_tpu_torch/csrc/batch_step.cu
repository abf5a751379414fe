// Minibatch training steps of the batch path (`train_nn --batch`) and
// of the fleet path (`train_fleet`): S steps, each on one B-row block
// of a bank.
//
// Replaces, in hpnn_tpu/ops/pallas_train.py, the five kernels that
// share `_batch_step_math`:
//   train_step_fused_batch  (`_batch_step_kernel`): S = 1, X/T one block;
//   train_step_fused_banked: S = 1, block k of the (S*B, n) bank;
//   train_epoch_grid_banked: S steps, blocks in the order `order[S]`;
//   train_epoch_dbuf_banked: the same, and each step first starts the
//     copy of the next step's block into L2 (`prefetch`), the
//     counterpart of the Pallas start-next/wait-own DMA rotation;
//   train_fleet_epoch_dbuf_banked: N members' dbuf epochs in one launch,
//     member i on its own slice of the stacked weights, its own bank
//     and its own row of `orders (N, S)` and `losses (N, S)`.
//
// What one step computes (lr_eff = lr*(1/B), computed in double on the
// host, as the JAX Python-scalar product is):
//   forward, layer by layer: ANN act(z) = 2/(1+exp(-z)) - 1; the SNN
//     output layer exp(z-1)/(TINY + sum exp(z-1)), no max shift;
//   output delta (t-o)*dact(o) (ANN) or t'-o (SNN, t' = max(t, 0));
//   hidden deltas (delta_{l+1} . W_{l+1}) * dact(v_l), all from the
//     weights BEFORE the update;
//   update of every layer from outer = delta_l^T . v_{l-1}:
//     BP W += lr_eff*outer; BPM m = dw + lr_eff*outer, W += m, dw = alpha*m;
//   re-forward, then the loss 0.5*sum((t-o)^2)*inv_b (ANN) or
//     -sum(t'*log(o+TINY))*inv_b/n_out (SNN) into losses[s].
//
// Bound.  One step at 784-300-10, B = 256 is three passes of
// 2*B*238200 flops (forward, update, re-forward) plus the hidden deltas:
// about 367 MFLOP, 5.5 us at the H100's 67 TFLOP/s FP32 (non-tensor);
// its bytes (a 0.8 MB X block, the weights once) take under 1 us at
// 3.35 TB/s.  So it is bound by operations.
//
// Design.  The epoch body is written once for a *team* of thread
// blocks, which has a rank, a size and a sync: the team strides over a
// phase's tiles and rows, and `sync()` separates the phases (a forward
// layer, a hidden-delta layer, the update of all layers).
//   batch_train (#2-#5): the team is the whole grid, one persistent
//     cooperative launch of one block per SM, every block co-resident,
//     `grid.sync()`;
//   cluster_train (#6, and #2-#5 on request): the team is one
//     thread-block cluster of C CTAs (C = 1, 2, 4, 8 or 16; the wrapper
//     plans C), the barrier `barrier.cluster` with release/acquire
//     semantics (`__syncthreads()` when C = 1); member i of a fleet is
//     cluster i, blocks [i*C, (i+1)*C) of the grid.  Members never wait
//     on each other, so N is not bounded by co-residency: clusters that
//     do not fit at once run in waves.
// A block is 2 tile workers of 128 threads, each with its own named
// barrier (`bar.sync 1+w, 128`): worker w of rank r takes tiles
// r + size*w, then every 2*size-th.  A tile is a 32x32 output block of
// a SIMT GEMM, FP32 (or FP64) FMA, no tensor cores, no fast math, each
// thread a 4x2 register block.  Its k-tiles (32 deep) are pipelined
// through two shared-memory stages: the loads of k-tile k+1 are issued
// (`ld.global.cg`, into registers, from addresses laid out once a tile)
// before k-tile k is computed, stored into the other stage after it,
// and one barrier of the worker's threads a k-tile separates the two.
// The loads bypass L1 because another SM may have written the rows
// since this one last read them; cp.async's 4- and 8-byte forms go
// through L1, and its 16-byte form needs 16-byte aligned rows, which
// the 10-wide output layer of 784-300-10 and the 851- and 230-wide
// rows of XRD do not give.  Loads two k-tiles ahead (a second register
// set) were measured no faster (PERF.md): the k-tile is bound by
// the worker's own instructions, not by L2.  Each stage is stored
// k-major with a 16-byte pad a row, so the stores of a transposed tile
// and the fragment loads of the FMA loop are free of bank conflicts.
// The worker is 128 threads (4x2 blocks): of the other sizes measured
// (PERF.md), 64 threads (4x4 blocks) was a third slower on #4 and no
// faster on the fleet at its planned sizes, 256 (4x1) as fast on #4 and
// slower on the fleet.  Fused epilogues: act for the forward (v.W^T,
// "NT"), dact for the deltas (delta.W, "NN"), the SGD or BPM triad for
// the update (delta^T.v, "TN").  When n_out <= 32 one tile column holds
// an output row whole: the last forward layer's tiles stage their outputs in
// shared memory and one thread a row takes the SNN normalisation and
// the output delta (or the row's error) from there, so the step needs
// no separate pass over the output rows and no sync around it.  The
// weights, and the activations and deltas scratch (2*B*sum(out_l)
// values, allocated by the wrapper), stay in device memory, held in
// the 50 MB L2.
//
// Determinism: every output element is summed by one thread as the
// single chain fma(a_k, b_k, acc), k = 0..K-1 in order, from 0; each
// row's softmax sum and error by one thread in column order; the batch
// loss by one warp in a fixed tree.  No atomics, no split K.  So the
// same inputs give bitwise the same outputs whatever the team, the
// cluster size or the tile assignment, and the five entry points agree
// bitwise on the same blocks: member i of #6 equals #5 (and #4) run on
// bank i with orders[i].
//
// Built for float (the card's default type) and double.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define HPNN_MAX_LAYERS 16
#define HPNN_THREADS 256
#define HPNN_TILE 32  // output tile edge, k-tile depth
#define HPNN_WORKER 128  // threads of one tile worker
#define HPNN_WORKERS (HPNN_THREADS / HPNN_WORKER)  // tile workers a block
#define HPNN_CW 2      // columns of a thread's register block (of 4 rows)
#define HPNN_TX 16     // threads along a tile row (HPNN_TILE / HPNN_CW)
#define HPNN_LOADS 8   // values of each operand k-tile a thread loads
static_assert(HPNN_WORKER * 4 * HPNN_CW == HPNN_TILE * HPNN_TILE &&
                  HPNN_TX * HPNN_CW == HPNN_TILE &&
                  HPNN_WORKER * HPNN_LOADS == HPNN_TILE * HPNN_TILE,
              "a worker's register blocks and loads cover one tile");
#define HPNN_OUT_LD (HPNN_TILE + 1)  // row of the staged output tile
#define HPNN_MAX_CLUSTER 16
// blocks per SM of the cooperative grid: a block's workers already
// outnumber the tiles of 784-300-10's largest phase (260), and a grid
// sync costs more the more blocks it waits for
#define HPNN_BLOCKS_PER_SM 1

namespace {

template <typename T>
struct Params {
  int n_layers;
  int dims[HPNN_MAX_LAYERS + 1];  // dims[0] = n_in, dims[l+1] = rows of W_l
  size_t off[HPNN_MAX_LAYERS];    // offset of layer l's (B, dims[l+1]) block
  T* w[HPNN_MAX_LAYERS];
  T* dw[HPNN_MAX_LAYERS];
  const T* X;      // bank of (blocks*B, n_in)
  const T* Tg;     // bank of (blocks*B, n_out)
  const int* order;  // (S,) block ids in device memory, or null:
  int first;         // then step s reads block first + s
  int B, S;
  T lr, alpha, inv_b;
  T* acts;     // sum over layers of (B, dims[l+1])
  T* ds;       // the same shape as acts
  T* rowloss;  // (B,)
  T* losses;   // (S,)
  int snn, momentum, prefetch;
};

// Shared memory of one block, in values of T: per worker two stages of
// an A and a B k-tile (HPNN_TILE k-rows of ld<T>() values each, k-major)
// and a staged output tile.  ops/batch_step.py::shared_bytes mirrors it.
template <typename T>
__host__ __device__ constexpr int stage_ld() { return HPNN_TILE + 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int stage_values() { return HPNN_TILE * stage_ld<T>(); }
template <typename T>
__host__ __device__ constexpr int worker_values() {
  return 4 * stage_values<T>() + HPNN_TILE * HPNN_OUT_LD;
}
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)HPNN_WORKERS * worker_values<T>() * sizeof(T);
}

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }

// N (4 or 2) consecutive values of an N-value aligned shared-memory row
template <int N>
__device__ __forceinline__ void ldv(float (&v)[N], const float* p) {
  static_assert(N == 4 || N == 2, "a fragment is 4 or 2 values");
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}
template <int N>
__device__ __forceinline__ void ldv(double (&v)[N], const double* p) {
  static_assert(N == 4 || N == 2, "a fragment is 4 or 2 values");
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const double2 q = *reinterpret_cast<const double2*>(p + i);
    v[i] = q.x, v[i + 1] = q.y;
  }
}

// the SNN target read as 0/1: max(t, 0)
template <typename T>
__device__ __forceinline__ T clamp0(T t) { return t > T(0) ? t : T(0); }

template <typename T>
__device__ __forceinline__ T act(T z) {
  return T(2) / (T(1) + dev_exp(-z)) - T(1);
}

template <typename T>
__device__ __forceinline__ T dact(T y) {
  return T(-0.5) * (y * y - T(1));
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The cluster barrier: release and acquire at cluster scope, so each CTA
// sees the device memory the others wrote before it (as in
// csrc/convergence.cu).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Phases of a step, timed with clock64() by thread 0 of rank 0 in a
// build with -DHPNN_PHASE_CLOCKS (ops/batch_step.py::phase_clocks);
// without it the epoch's clock is NoClock and costs nothing.
enum Phase {
  P_FWD,   // forward tiles (and the output rows folded into them)
  P_ROWS,  // the output rows apart (n_out > 32)
  P_HID,   // hidden-delta tiles
  P_UPD,   // update tiles
  P_SYNC,  // the team's syncs, waiting for the slowest block included
  P_REST,  // step start (prefetch) and the loss warp
  N_PHASES
};

struct NoClock {
  __device__ void to(int) {}
};

#ifdef HPNN_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[N_PHASES];

// Cycles by phase of one thread: start() opens P_REST, to(k) closes
// the phase under way and opens k.
struct PhaseClock {
  bool on;
  int cur;
  long long last;
  unsigned long long acc[N_PHASES];
  __device__ void start(bool on_) {
    on = on_;
    cur = P_REST;
    last = clock64();
    for (int k = 0; k < N_PHASES; ++k) acc[k] = 0;
  }
  __device__ void to(int k) {
    if (on) {
      const long long t = clock64();
      acc[cur] += (unsigned long long)(t - last);
      last = t;
    }
    cur = k;
  }
  __device__ void flush() {
    to(cur);
    if (on)
      for (int k = 0; k < N_PHASES; ++k) g_phase_clocks[k] += acc[k];
  }
};

// A team whose syncs count as P_SYNC on `clk`.
template <typename Team>
struct TimedTeam {
  Team& team;
  PhaseClock& clk;
  __device__ int rank() const { return team.rank(); }
  __device__ int size() const { return team.size(); }
  __device__ void sync() {
    const int was = clk.cur;
    clk.to(P_SYNC);
    team.sync();
    clk.to(was);
  }
};
#endif

// The unit of work of an epoch: the whole cooperative grid (#2-#5) ...
struct GridTeam {
  cg::grid_group grid;
  __device__ int rank() const { return blockIdx.x; }
  __device__ int size() const { return gridDim.x; }
  __device__ void sync() { grid.sync(); }
};

// ... or one thread-block cluster, a fleet member (#6); C = 1 is one
// thread block, whose own __syncthreads orders its device memory.
struct ClusterTeam {
  int r, n;
  __device__ ClusterTeam() {
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  }
  __device__ int rank() const { return r; }
  __device__ int size() const { return n; }
  __device__ void sync() {
    if (n > 1)
      cluster_barrier();
    else
      __syncthreads();
  }
};

// One HPNN_WORKER-thread tile worker of a block: its id, its thread's
// index in it and its shared memory (stage s of operand o at stage(o, s);
// the staged output tile at out).
template <typename T>
struct Worker {
  T* sm;
  int id, w;
  __device__ explicit Worker(unsigned char* smem)
      : sm(reinterpret_cast<T*>(smem) +
           (size_t)(threadIdx.x / HPNN_WORKER) * worker_values<T>()),
        id(threadIdx.x / HPNN_WORKER), w(threadIdx.x % HPNN_WORKER) {}
  __device__ T* stage(int o, int s) const { return sm + (2 * o + s) * stage_values<T>(); }
  __device__ T* out() const { return sm + 4 * stage_values<T>(); }
  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + id), "r"(HPNN_WORKER) : "memory");
  }
  // the worker's first tile of a phase and its stride, for `team`
  template <typename Team>
  __device__ int first(const Team& team) const { return team.rank() + team.size() * id; }
  template <typename Team>
  __device__ int stride(const Team& team) const { return team.size() * HPNN_WORKERS; }
};

// A thread's share of the 32 x 32 k-tiles of one operand of a tile,
// P(x, k) = P[x*sx + k*sk] for x in [x0, x0+32) below xlim.  With k
// contiguous (sk == 1) a warp reads 4 rows of 8 consecutive k, value
// q = 4g + j at row xb + g*HPNN_WORKER/8 and k kb + 8j; else one k of 32
// consecutive x, value q at x xb and k kb + q*HPNN_WORKER/32.  The
// addresses are laid out once a tile: `base` is value 0's at k-tile 0.
template <typename T>
struct Operand {
  const T* base;
  size_t step;    // from one row group (or k group) to the next
  size_t kstep;   // from one k-tile to the next
  bool kfast;
  unsigned rows;  // bit g: row group g inside the matrix (x-fast: bit 0 for all)
  int xb, kb;     // the thread's first x and k inside the tile
};

template <typename T>
__device__ __forceinline__ Operand<T> operand(const T* P, size_t sx, size_t sk, int x0,
                                              int xlim, int w) {
  Operand<T> o;
  o.kfast = sk == 1;
  if (o.kfast) {
    o.xb = w >> 3, o.kb = w & 7;
    o.step = (size_t)(HPNN_WORKER / 8) * sx;
    o.kstep = HPNN_TILE;
    o.rows = 0;
#pragma unroll
    for (int g = 0; g < HPNN_LOADS / 4; ++g)
      if (x0 + o.xb + g * (HPNN_WORKER / 8) < xlim) o.rows |= 1u << g;
  } else {
    o.xb = w & 31, o.kb = w >> 5;
    o.step = (size_t)(HPNN_WORKER / 32) * sk;
    o.kstep = (size_t)HPNN_TILE * sk;
    o.rows = x0 + o.xb < xlim ? 1u : 0u;
  }
  o.base = P + (size_t)(x0 + o.xb) * sx + (size_t)o.kb * sk;
  return o;
}

// k-tile kt of the operand (K deep) into the thread's registers; 0
// outside the matrix.
template <typename T>
__device__ __forceinline__ void load_tile(T (&v)[HPNN_LOADS], const Operand<T>& o, int kt,
                                          int K) {
  const T* p = o.base + (size_t)kt * o.kstep;
  const int kleft = K - kt * HPNN_TILE - o.kb;  // value k offsets below it are inside
  if (o.kfast) {
#pragma unroll
    for (int g = 0; g < HPNN_LOADS / 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * g + j] = ((o.rows >> g) & 1u) && 8 * j < kleft
                           ? ldcg(p + g * o.step + 8 * j) : T(0);
  } else {
#pragma unroll
    for (int q = 0; q < HPNN_LOADS; ++q)
      v[q] = o.rows && q * (HPNN_WORKER / 32) < kleft ? ldcg(p + q * o.step) : T(0);
  }
}

// The registers of load_tile into a stage, k-major: S[k][x].
template <typename T>
__device__ __forceinline__ void store_tile(T* S, const T (&v)[HPNN_LOADS], const Operand<T>& o) {
  constexpr int LD = stage_ld<T>();
  if (o.kfast) {
#pragma unroll
    for (int g = 0; g < HPNN_LOADS / 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        S[(o.kb + 8 * j) * LD + o.xb + g * (HPNN_WORKER / 8)] = v[4 * g + j];
  } else {
#pragma unroll
    for (int q = 0; q < HPNN_LOADS; ++q)
      S[(o.kb + q * (HPNN_WORKER / 32)) * LD + o.xb] = v[q];
  }
}

// One 32x32 tile (tm, tn) of C(r, c) = sum_k A(r, k) * Bm(k, c) with
// A(r, k) = A[r*sar + k*sak] and Bm(k, c) = Bm[k*sbk + c*sbc], by the
// worker `wk`; calls epi(r, c, acc) for each element inside (M, N).
// Thread (ty, tx) of 8 x HPNN_TX owns rows 4ty..4ty+3 and columns
// HPNN_CW*tx..HPNN_CW*tx+HPNN_CW-1.
template <typename T, typename Epi>
__device__ void gemm_tile(int M, int N, int K, const T* A, size_t sar, size_t sak,
                          const T* Bm, size_t sbk, size_t sbc, int tm, int tn,
                          const Worker<T>& wk, Epi epi) {
  const int ty = wk.w / HPNN_TX, tx = wk.w % HPNN_TX;
  const int r0 = tm * HPNN_TILE, c0 = tn * HPNN_TILE;
  constexpr int LD = stage_ld<T>();
  const Operand<T> oa = operand(A, sar, sak, r0, M, wk.w);
  const Operand<T> ob = operand(Bm, sbc, sbk, c0, N, wk.w);
  T acc[4][HPNN_CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HPNN_CW; ++j) acc[i][j] = T(0);
  T va[HPNN_LOADS], vb[HPNN_LOADS];
  load_tile(va, oa, 0, K);
  load_tile(vb, ob, 0, K);
  store_tile(wk.stage(0, 0), va, oa);
  store_tile(wk.stage(1, 0), vb, ob);
  wk.sync();
  const int nk = cdiv(K, HPNN_TILE);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {  // k-tile kt+1 in flight while kt is computed
      load_tile(va, oa, kt + 1, K);
      load_tile(vb, ob, kt + 1, K);
    }
    const T* As = wk.stage(0, s) + 4 * ty;
    const T* Bs = wk.stage(1, s) + HPNN_CW * tx;
    const int kmax = min(HPNN_TILE, K - kt * HPNN_TILE);
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      T a[4], b[HPNN_CW];
      ldv<4>(a, As + kk * LD);
      ldv<HPNN_CW>(b, Bs + kk * LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < HPNN_CW; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_tile(wk.stage(0, s ^ 1), va, oa);
      store_tile(wk.stage(1, s ^ 1), vb, ob);
    }
    // the one barrier a k-tile: stage s^1 is full, and nobody still
    // reads stage s, which k-tile kt+2 overwrites
    wk.sync();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HPNN_CW; ++j) {
      const int r = r0 + 4 * ty + i, c = c0 + HPNN_CW * tx + j;
      if (r < M && c < N) epi(r, c, acc[i][j]);
    }
}

// One output row b held whole in shared memory (`os`, its n values as
// the forward wrote them): the SNN normalisation, then the output delta
// (loss == false) or the row's error into rowloss (loss == true).  `o`
// is where the row's outputs go in acts.  The same operations in the
// same order as output_rows.
template <typename T>
__device__ void finish_row(const Params<T>& p, const T* os, T* o, const T* t, int b,
                           bool loss) {
  const int n = p.dims[p.n_layers];
  const T tiny = T(1e-14);
  T dv = T(1);
  if (p.snn) {
    T s = T(0);
    for (int i = 0; i < n; ++i) s += os[i];
    dv = tiny + s;
  }
  if (loss) {
    T acc = T(0);
    for (int i = 0; i < n; ++i) {
      const T oi = p.snn ? os[i] / dv : os[i];
      o[i] = oi;
      if (p.snn) {
        acc += clamp0(t[i]) * dev_log(oi + tiny);
      } else {
        const T d = t[i] - oi;
        acc += d * d;
      }
    }
    p.rowloss[b] = acc;
  } else {
    T* d = p.ds + p.off[p.n_layers - 1] + (size_t)b * n;
    for (int i = 0; i < n; ++i) {
      const T oi = p.snn ? os[i] / dv : os[i];
      o[i] = oi;
      d[i] = p.snn ? clamp0(t[i]) - oi : (t[i] - oi) * dact(oi);
    }
  }
}

// What the last forward layer's tiles do once their outputs are in:
// nothing (the output rows take a pass of their own), or, when one tile
// column holds an output row, its delta or its error.
enum Finish { F_NONE, F_DELTAS, F_LOSS };

// acts_l <- forward of the (B, n_in) block x through every layer.
template <typename T, typename Team>
__device__ void forward(const Params<T>& p, const T* x, const T* tg, Team& team,
                        const Worker<T>& wk, Finish finish) {
  for (int l = 0; l < p.n_layers; ++l) {
    const int m = p.dims[l], n = p.dims[l + 1];
    const T* vin = l == 0 ? x : p.acts + p.off[l - 1];
    T* vout = p.acts + p.off[l];
    const bool soft = p.snn && l == p.n_layers - 1;
    const bool fold = finish != F_NONE && l == p.n_layers - 1;  // then n <= HPNN_TILE
    const int tn_count = cdiv(n, HPNN_TILE);
    const int tiles = cdiv(p.B, HPNN_TILE) * tn_count;
    for (int t = wk.first(team); t < tiles; t += wk.stride(team)) {
      const int tm = t / tn_count;
      T* os = wk.out();
      gemm_tile<T>(p.B, n, m, vin, m, 1, p.w[l], 1, m, tm, t % tn_count, wk,
                   [&](int r, int c, T z) {
                     const T v = soft ? dev_exp(z - T(1)) : act(z);
                     if (fold)
                       os[(r - tm * HPNN_TILE) * HPNN_OUT_LD + c] = v;
                     else
                       vout[(size_t)r * n + c] = v;
                   });
      if (fold) {
        wk.sync();  // the tile's outputs are staged
        const int b = tm * HPNN_TILE + wk.w;
        if (wk.w < HPNN_TILE && b < p.B)
          finish_row(p, os + wk.w * HPNN_OUT_LD, vout + (size_t)b * n,
                     tg + (size_t)b * n, b, finish == F_LOSS);
        // the next write of `os` follows this tile's k-tile barriers
      }
    }
    team.sync();
  }
}

// One thread per output row: the SNN normalisation, then the output
// delta (loss == false) or the row's error into rowloss (loss == true).
// For n_out > HPNN_TILE, where a row spans tiles.
template <typename T, typename Team>
__device__ void output_rows(const Params<T>& p, const T* tg, const Team& team,
                            bool loss) {
  const int L = p.n_layers, n = p.dims[L];
  const T tiny = T(1e-14);
  const int stride = team.size() * blockDim.x;
  for (int b = team.rank() * blockDim.x + threadIdx.x; b < p.B; b += stride) {
    T* o = p.acts + p.off[L - 1] + (size_t)b * n;
    const T* t = tg + (size_t)b * n;
    if (p.snn) {
      T s = T(0);
      for (int i = 0; i < n; ++i) s += ldcg(o + i);
      const T dv = tiny + s;
      for (int i = 0; i < n; ++i) o[i] = ldcg(o + i) / dv;
    }
    if (loss) {
      T acc = T(0);
      for (int i = 0; i < n; ++i) {
        const T oi = ldcg(o + i);
        if (p.snn) {
          acc += clamp0(t[i]) * dev_log(oi + tiny);
        } else {
          const T d = t[i] - oi;
          acc += d * d;
        }
      }
      p.rowloss[b] = acc;
    } else {
      T* d = p.ds + p.off[L - 1] + (size_t)b * n;
      for (int i = 0; i < n; ++i) {
        const T oi = ldcg(o + i);
        d[i] = p.snn ? clamp0(t[i]) - oi : (t[i] - oi) * dact(oi);
      }
    }
  }
}

// Hidden deltas, last hidden layer first, from the current weights.
template <typename T, typename Team>
__device__ void hidden_deltas(const Params<T>& p, Team& team, const Worker<T>& wk) {
  for (int l = p.n_layers - 2; l >= 0; --l) {
    const int n = p.dims[l + 1], k = p.dims[l + 2];
    const T* dn = p.ds + p.off[l + 1];
    const T* a = p.acts + p.off[l];
    T* d = p.ds + p.off[l];
    const int tn_count = cdiv(n, HPNN_TILE);
    const int tiles = cdiv(p.B, HPNN_TILE) * tn_count;
    for (int t = wk.first(team); t < tiles; t += wk.stride(team))
      gemm_tile<T>(p.B, n, k, dn, k, 1, p.w[l + 1], n, 1, t / tn_count,
                   t % tn_count, wk, [&](int r, int c, T z) {
                     const size_t q = (size_t)r * n + c;
                     d[q] = z * dact(ldcg(a + q));
                   });
    team.sync();
  }
}

// The update of every layer, its tiles laid end to end over the team.
template <typename T, typename Team>
__device__ void update(const Params<T>& p, const T* x, Team& team, const Worker<T>& wk) {
  int total = 0;
  for (int l = 0; l < p.n_layers; ++l)
    total += cdiv(p.dims[l + 1], HPNN_TILE) * cdiv(p.dims[l], HPNN_TILE);
  for (int t = wk.first(team); t < total; t += wk.stride(team)) {
    int l = 0, tt = t;
    while (true) {
      const int c = cdiv(p.dims[l + 1], HPNN_TILE) * cdiv(p.dims[l], HPNN_TILE);
      if (tt < c) break;
      tt -= c;
      ++l;
    }
    const int M = p.dims[l + 1], N = p.dims[l];
    const T* d = p.ds + p.off[l];
    const T* v = l == 0 ? x : p.acts + p.off[l - 1];
    T* W = p.w[l];
    T* DW = p.dw[l];
    const int tn_count = cdiv(N, HPNN_TILE);
    gemm_tile<T>(M, N, p.B, d, 1, M, v, N, 1, tt / tn_count, tt % tn_count, wk,
                 [&](int i, int j, T outer) {
                   const size_t q = (size_t)i * N + j;
                   if (p.momentum) {
                     const T m = ldcg(DW + q) + p.lr * outer;
                     W[q] = ldcg(W + q) + m;
                     DW[q] = p.alpha * m;
                   } else {
                     W[q] = ldcg(W + q) + p.lr * outer;
                   }
                 });
  }
  team.sync();
}

// Start the copy of block `blk` of both banks into L2, spread over the team.
template <typename T, typename Team>
__device__ void prefetch_block(const Params<T>& p, const Team& team, int blk) {
  const size_t tid = (size_t)team.rank() * blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)team.size() * blockDim.x;
  const size_t rows = (size_t)blk * p.B;
  const char* xb = reinterpret_cast<const char*>(p.X + rows * p.dims[0]);
  const char* tb = reinterpret_cast<const char*>(p.Tg + rows * p.dims[p.n_layers]);
  const size_t nx = (size_t)p.B * p.dims[0] * sizeof(T);
  const size_t nt = (size_t)p.B * p.dims[p.n_layers] * sizeof(T);
  for (size_t o = tid * 128; o < nx; o += nthreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(xb + o));
  for (size_t o = tid * 128; o < nt; o += nthreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(tb + o));
}

template <typename T>
__device__ __forceinline__ int block_of(const Params<T>& p, int s) {
  return p.order ? __ldg(p.order + s) : p.first + s;
}

// One epoch of S steps by `team`.
template <typename T, typename Team, typename Clock>
__device__ void epoch(const Params<T>& p, Team& team, const Worker<T>& wk, Clock& clk) {
  const int n_in = p.dims[0], n_out = p.dims[p.n_layers];
  const bool fold = n_out <= HPNN_TILE;
  for (int s = 0; s < p.S; ++s) {
    const size_t row0 = (size_t)block_of(p, s) * p.B;
    const T* x = p.X + row0 * n_in;
    const T* tg = p.Tg + row0 * n_out;
    if (p.prefetch && s + 1 < p.S) prefetch_block(p, team, block_of(p, s + 1));
    clk.to(P_FWD);
    forward(p, x, tg, team, wk, fold ? F_DELTAS : F_NONE);
    if (!fold) {
      clk.to(P_ROWS);
      output_rows(p, tg, team, false);
      team.sync();
    }
    clk.to(P_HID);
    hidden_deltas(p, team, wk);
    clk.to(P_UPD);
    update(p, x, team, wk);
    clk.to(P_FWD);
    forward(p, x, tg, team, wk, fold ? F_LOSS : F_NONE);
    if (!fold) {
      clk.to(P_ROWS);
      output_rows(p, tg, team, true);
      team.sync();
    }
    clk.to(P_REST);
    // rowloss is next written after this step's syncs, so the team's
    // first warp sums it while the team starts the next step
    if (team.rank() == 0 && threadIdx.x < 32) {
      T acc = T(0);
      for (int b = threadIdx.x; b < p.B; b += 32) acc += ldcg(p.rowloss + b);
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
      if (threadIdx.x == 0)
        p.losses[s] = p.snn ? -acc * p.inv_b / T(n_out) : T(0.5) * acc * p.inv_b;
    }
  }
}

// The epoch by `team`, its phases clocked in a -DHPNN_PHASE_CLOCKS build.
template <typename T, typename Team>
__device__ void run_epoch(const Params<T>& p, Team& team, const Worker<T>& wk) {
#ifdef HPNN_PHASE_CLOCKS
  PhaseClock clk;
  clk.start(team.rank() == 0 && threadIdx.x == 0);
  TimedTeam<Team> timed{team, clk};
  epoch(p, timed, wk, clk);
  clk.flush();
#else
  NoClock clk;
  epoch(p, team, wk, clk);
#endif
}

template <typename T>
__global__ void __launch_bounds__(HPNN_THREADS, 1) batch_train(Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  GridTeam team{cg::this_grid()};
  run_epoch(p, team, Worker<T>(smem));
}

// Member strides of a fleet launch, in elements of T.
struct Fleet {
  size_t x, t;     // one member's bank of X (bank_rows*n_in) and of T
  size_t scratch;  // 2*B*sum(dims[1:]) + B
};

// Cluster i trains member i: `p` holds member 0's pointers, moved here
// to member i's slices.  The stacked weights are (N, out, in), so member
// i's layer l starts i*out*in elements in; orders and losses are (N, S).
// One member (#2-#5 on a cluster team) is cluster 0 with p as given.
template <typename T>
__global__ void __launch_bounds__(HPNN_THREADS, 1) cluster_train(Params<T> p, Fleet f) {
  extern __shared__ __align__(16) unsigned char smem[];
  ClusterTeam team;
  const size_t i = blockIdx.x / team.size();
  for (int l = 0; l < p.n_layers; ++l) {
    const size_t n_w = (size_t)p.dims[l] * p.dims[l + 1];
    p.w[l] += i * n_w;
    if (p.momentum) p.dw[l] += i * n_w;
  }
  p.X += i * f.x;
  p.Tg += i * f.t;
  if (p.order) p.order += i * p.S;
  p.acts += i * f.scratch;
  p.ds += i * f.scratch;
  p.rowloss += i * f.scratch;
  p.losses += i * p.S;
  run_epoch(p, team, Worker<T>(smem));
}

// Both kernels' dynamic shared memory, and the cluster kernel's
// non-portable cluster size, opted in on the current device.  The two
// queries below set them; the wrapper asks one of them once per type and
// device before it launches there, so a launch sets no attribute.
template <typename T>
cudaError_t set_attributes() {
  const int smem = (int)smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(batch_train<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_train<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_train<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T>
int grid_blocks(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_attributes<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, batch_train<T>,
                                                        HPNN_THREADS, smem_bytes<T>());
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  *blocks = sms * (per_sm < HPNN_BLOCKS_PER_SM ? per_sm : HPNN_BLOCKS_PER_SM);
  return (int)cudaSuccess;
}

// The launch's Params (member 0's, for a fleet), the scratch laid out
// as acts | ds | rowloss.  Returns the number of values of one scratch
// (2*B*sum(dims[1:]) + B), or 0 for a shape the kernel does not take.
template <typename T>
size_t make_params(Params<T>* p, int snn, int momentum, int n_layers,
                   const int* dims, void* const* w, void* const* dw,
                   const void* X, const void* Tg, int B, const int* order,
                   int first, int S, double lr_eff, double alpha, double inv_b,
                   void* scratch, void* losses, int prefetch) {
  if (n_layers < 1 || n_layers > HPNN_MAX_LAYERS || B < 1 || S < 1) return 0;
  p->n_layers = n_layers;
  size_t total = 0;
  for (int l = 0; l <= n_layers; ++l) p->dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    p->off[l] = total;
    total += (size_t)B * dims[l + 1];
    p->w[l] = static_cast<T*>(w[l]);
    p->dw[l] = momentum ? static_cast<T*>(dw[l]) : nullptr;
  }
  p->X = static_cast<const T*>(X);
  p->Tg = static_cast<const T*>(Tg);
  p->order = order;
  p->first = first;
  p->B = B;
  p->S = S;
  p->lr = (T)lr_eff;
  p->alpha = (T)alpha;
  p->inv_b = (T)inv_b;
  p->acts = static_cast<T*>(scratch);
  p->ds = p->acts + total;
  p->rowloss = p->ds + total;
  p->losses = static_cast<T*>(losses);
  p->snn = snn;
  p->momentum = momentum;
  p->prefetch = prefetch;
  return 2 * total + B;
}

// The launch of `members` clusters of `cluster` CTAs (1, 2, 4, 8 or 16)
// of cluster_train<T>; `attr` holds the cluster size.
template <typename T>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int members,
                           int cluster, cudaStream_t stream) {
  if (members < 1 || cluster < 1 || cluster > HPNN_MAX_CLUSTER || (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  *cfg = {};
  cfg->gridDim = dim3((unsigned)members * cluster, 1, 1);
  cfg->blockDim = dim3(HPNN_THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem_bytes<T>();
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Clusters of `cluster` CTAs the card holds at once (0: none fits).
template <typename T>
int max_clusters(int cluster, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = set_attributes<T>();
  if (err == cudaSuccess) err = cluster_config<T>(&cfg, &attr, 1, cluster, 0);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(n, cluster_train<T>, &cfg);
  return (int)err;
}

// `members` clusters of `cluster` CTAs, cluster i on member i.  The
// wrapper has checked with max_clusters that the card places one.
template <typename T>
int launch_clusters(const Params<T>& p, const Fleet& f, int members, int cluster,
                    cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T>(&cfg, &attr, members, cluster, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, cluster_train<T>, p, f);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int blocks, int cluster, int snn, int momentum, int n_layers, const int* dims,
           void* const* w, void* const* dw, const void* X, const void* Tg,
           int B, const int* order, int first, int S, double lr_eff,
           double alpha, double inv_b, void* scratch, void* losses,
           int prefetch, cudaStream_t stream) {
  Params<T> p;
  if (!make_params(&p, snn, momentum, n_layers, dims, w, dw, X, Tg, B, order,
                   first, S, lr_eff, alpha, inv_b, scratch, losses, prefetch))
    return (int)cudaErrorInvalidValue;
  if (cluster) return launch_clusters(p, Fleet{0, 0, 0}, 1, cluster, stream);
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)batch_train<T>, dim3(blocks),
                                                dim3(HPNN_THREADS), args, smem_bytes<T>(),
                                                stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fleet(int members, int cluster, int snn, int momentum, int n_layers,
                 const int* dims, void* const* w, void* const* dw,
                 const void* X, const void* Tg, long long bank_rows, int B,
                 const int* orders, int S, double lr_eff, double alpha,
                 double inv_b, void* scratch, void* losses, cudaStream_t stream) {
  if (members < 1 || bank_rows < B || orders == nullptr)
    return (int)cudaErrorInvalidValue;
  Params<T> p;
  Fleet f;
  f.scratch = make_params(&p, snn, momentum, n_layers, dims, w, dw, X, Tg, B,
                          orders, 0, S, lr_eff, alpha, inv_b, scratch, losses, 1);
  if (!f.scratch) return (int)cudaErrorInvalidValue;
  f.x = (size_t)bank_rows * dims[0];
  f.t = (size_t)bank_rows * dims[n_layers];
  return launch_clusters(p, f, members, cluster, stream);
}

}  // namespace

// Plain C entry for ctypes.  `cluster` 0: one cooperative launch of
// `blocks` blocks (from hpnn_batch_grid_blocks), the grid the team;
// `cluster` C in {1, 2, 4, 8, 16}: one cluster of C CTAs the team,
// `blocks` unused.  `dims`, `w` and `dw` are HOST arrays (of n_layers+1
// ints and n_layers device pointers); every other pointer is a device
// pointer.  `order` may be null: step s then reads block first + s.
// `scratch` holds 2*B*sum(dims[1:]) + B values.  dtype: 0 = float,
// 1 = double.  Ask hpnn_batch_grid_blocks or hpnn_fleet_max_clusters on
// the device first: they opt the kernels in to their shared memory.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int hpnn_batch_train(int dtype, int blocks, int cluster, int snn, int momentum,
                                int n_layers, const int* dims, void* const* w,
                                void* const* dw, const void* X, const void* Tg,
                                int B, const void* order, int first, int S,
                                double lr_eff, double alpha, double inv_b,
                                void* scratch, void* losses, int prefetch,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  if (dtype == 0)
    return launch<float>(blocks, cluster, snn, momentum, n_layers, dims, w, dw, X, Tg,
                         B, ord, first, S, lr_eff, alpha, inv_b, scratch, losses,
                         prefetch, st);
  if (dtype == 1)
    return launch<double>(blocks, cluster, snn, momentum, n_layers, dims, w, dw, X, Tg,
                          B, ord, first, S, lr_eff, alpha, inv_b, scratch, losses,
                          prefetch, st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry of the fleet epoch (#6): `members` clusters of `cluster`
// CTAs (1, 2, 4, 8 or 16), cluster i on member i, every step prefetching
// its member's next block.  `dims`, `w` and `dw` are as for
// hpnn_batch_train, with w[l] (and dw[l]) the stacked (members,
// dims[l+1], dims[l]) layer l, member stride dims[l]*dims[l+1].  X and
// Tg are the stacked banks, (members, bank_rows, dims[0]) and (members,
// bank_rows, dims[n_layers]), member stride bank_rows rows.  `orders`
// and `losses` are (members, S), member stride S; `scratch` holds
// members * (2*B*sum(dims[1:]) + B) values, member stride one scratch.
// Ask hpnn_fleet_max_clusters on the device first, as for
// hpnn_batch_train.  Returns the cudaError_t of the launch.
extern "C" int hpnn_fleet_train(int dtype, int members, int cluster, int snn, int momentum,
                                int n_layers, const int* dims, void* const* w,
                                void* const* dw, const void* X, const void* Tg,
                                long long bank_rows, int B, const void* orders,
                                int S, double lr_eff, double alpha, double inv_b,
                                void* scratch, void* losses, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(orders);
  if (dtype == 0)
    return launch_fleet<float>(members, cluster, snn, momentum, n_layers, dims, w, dw, X,
                               Tg, bank_rows, B, ord, S, lr_eff, alpha, inv_b,
                               scratch, losses, st);
  if (dtype == 1)
    return launch_fleet<double>(members, cluster, snn, momentum, n_layers, dims, w, dw,
                                X, Tg, bank_rows, B, ord, S, lr_eff, alpha, inv_b,
                                scratch, losses, st);
  return (int)cudaErrorInvalidValue;
}

// The cooperative grid of one launch on the current device: every
// block co-resident.  Sets the kernels' attributes (set_attributes).
// Returns the cudaError_t of the query.
extern "C" int hpnn_batch_grid_blocks(int dtype, int* blocks) {
  *blocks = 0;
  if (dtype == 0) return grid_blocks<float>(blocks);
  if (dtype == 1) return grid_blocks<double>(blocks);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cluster` CTAs (1, 2, 4, 8 or 16) of the fleet
// kernel the current device holds at once, into *n.  Sets the kernels'
// attributes (set_attributes).  Returns the cudaError_t of the query.
extern "C" int hpnn_fleet_max_clusters(int dtype, int cluster, int* n) {
  *n = 0;
  if (dtype == 0) return max_clusters<float>(cluster, n);
  if (dtype == 1) return max_clusters<double>(cluster, n);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of one block, in bytes (0 for another dtype).
extern "C" long long hpnn_batch_smem_bytes(int dtype) {
  if (dtype == 0) return (long long)smem_bytes<float>();
  if (dtype == 1) return (long long)smem_bytes<double>();
  return 0;
}

#ifdef HPNN_PHASE_CLOCKS
// The SM cycles rank 0's thread 0 spent in each phase (enum Phase), summed
// over the launches since the last reset; then zero them if `reset`.
extern "C" int hpnn_batch_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess || !reset) return (int)err;
  static const unsigned long long zero[N_PHASES] = {};
  return (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
}
#endif

extern "C" const char* hpnn_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
