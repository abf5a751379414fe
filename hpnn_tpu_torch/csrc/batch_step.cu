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
// blocks, which has a rank, a size, a sync and the nets it trains: the
// team strides over a phase's tiles and rows, and `sync()` separates the
// phases (a forward layer, a hidden-delta layer, the update of all
// layers).
//   batch_train (#2-#5): the team is the whole grid on one net, one
//     persistent cooperative launch of one block per SM, every block
//     co-resident, `grid.sync()`;
//   cluster_train (#6), its team a template argument:
//     FleetGridTeam: the same grid on every member of the fleet.  A
//       phase's tiles are all members' laid end to end (member i's tile
//       t is the (i*tiles + t)-th), so the workers stride over (member,
//       tile) pairs and one worker takes tiles of several members; every
//       member's step advances at each `grid.sync()`.  The rest of a step
//       is split by member: the output rows apart (one thread a row of
//       every member), member i's prefetch by the blocks of rank i mod N,
//       its loss by the first warp of block i mod size.  For 8 members
//       of 784-300-10 that is 264 workers on 640 forward and 2080 update
//       tiles, where one 8-CTA cluster a member left 68 of 132 SMs idle;
//     ClusterTeam (and #2-#5 on request): one thread-block cluster of C
//       CTAs a member (C = 1, 2, 4, 8 or 16), the barrier
//       `barrier.cluster` with release/acquire semantics
//       (`__syncthreads()` when C = 1); member i is cluster i, blocks
//       [i*C, (i+1)*C) of the grid.  Members never wait on each other, so
//       N is not bounded by co-residency: clusters that do not fit at
//       once run in waves.  Where a phase is one tile a member (the
//       HPNN-sized fleet) its barriers cost less than the grid's.
//   The wrapper plans the team of each launch (ops/batch_step.py::
//   fleet_cluster) from an estimate of a step on each.
// A block is 2 tile workers of 128 threads, each with its own named
// barrier (`bar.sync 1+w, 128`): worker w of rank r takes tiles
// r + size*w, then every 2*size-th.  A tile is a 32x32 output block; in
// the float and double builds that of a SIMT GEMM, FP32 (or FP64) FMA,
// no tensor cores, no fast math, each thread a 4x2 register block (the
// bf16 build's tile is below).  Its k-tiles (32 deep) are pipelined
// through two shared-memory stages: the loads of k-tile k+1 are issued
// (`ld.global.cg`, into registers, from addresses laid out once a tile)
// before k-tile k is computed, stored into the other stage after it,
// and one barrier of the worker's threads a k-tile separates the two.
// The loads bypass L1 because another SM may have written the rows
// since this one last read them; cp.async's 4- and 8-byte forms go
// through L1, and its 16-byte form needs 16-byte aligned rows, which
// the 10-wide output layer of 784-300-10 and the 851- and 230-wide
// rows of XRD do not give.  In the SIMT tile, loads two k-tiles ahead
// (a second register set) were measured no faster (PERF.md): its
// k-tile is bound by the worker's own instructions, not by L2.  Each stage is stored
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
// single chain fma(a_k, b_k, acc), k = 0..K-1 in order, from 0 (bf16: by
// one warp's chain of mma over k16 steps in order, from 0); each
// row's softmax sum and error by one thread in column order; the batch
// loss by one warp in a fixed tree.  No atomics, no split K.  So the
// same inputs give bitwise the same outputs whatever the team, the
// cluster size, the tile assignment or the members that share a launch's
// workers, and the five entry points agree
// bitwise on the same blocks: member i of #6 equals #5 (and #4) run on
// bank i with orders[i].
//
// Built for float (the card's default type) and double, and for bf16
// (dtype 2, the fleet's `dtype="bf16"`): weights, dw, the banks,
// activations and deltas are __nv_bfloat16 in device memory; the
// epilogues run in float, and each value is rounded to bf16 (round to
// nearest even) where it is stored, as the JAX program holds each of
// those arrays in bf16.  The row losses and the losses are float.  The
// float and double builds take the SIMT tile above: acc_t of their type
// is the type itself and every conversion is the identity.
//
// The bf16 build's tiles run on the tensor cores (gemm_tile_mma), as the
// TPU kernel's three dots on bf16 operands run on the MXU
// (`preferred_element_type=f32`: exact bf16 products, float32 sums):
// `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`.  The worker keeps its
// 32x32 output tile; each of its 4 warps owns a 16x16 quadrant, two
// m16n8 fragments, 8 float accumulators a thread.  A k-tile is staged
// raw, in bf16, in the layout device memory holds it (32 rows of 32
// contiguous values: rows x for an operand contiguous in k, rows k
// otherwise), each row padded to 40 values (80 bytes) so that the 8
// row addresses of an ldmatrix phase fall in 8 different 16-byte bank
// groups; `ldmatrix` (`.trans` for a k-row stage) loads the fragments,
// 2 k16 steps a k-tile, 4 ldmatrix and 4 mma a warp.  The loads stay
// `ld.global.cg`, two k-tiles in flight, raw (the body before converted
// each value to float as it loaded it, so every load waited for its
// data: PERF.md): 16-byte loads where the rows and the matrix edge are
// 16-byte aligned (the 784-wide X bank and W0), 2-byte loads, a warp on
// 32 consecutive values of a row, elsewhere (the 300- and 10-wide rows,
// the 851/230-wide XRD rows); no cp.async or TMA, whose 16-byte L2-only
// copies need 16-byte aligned rows.  Each output element is summed by
// one warp's mma chain in a fixed k order, with exact zeros outside the
// matrix, so the bf16 build keeps the bitwise rules below.  (mma.sync
// rather than wgmma: wgmma takes 64 rows at least, which would part the
// bf16 build's tile walk, its folded output rows and its staged output
// tile from the float/double builds that share the body.)
//
// The layers.  A net of any depth: the wrapper packs one 32-byte record a
// layer (`Layer`: W's and dw's addresses, the rows below the layer, the
// widths) into a table it keeps in device memory and on the host, once
// for a set of weights (ops/batch_step.py::_layer_table).  A net of at
// most HPNN_PARAM_LAYERS layers takes its per-layer values, filled from
// the host copy, by value in the kernel parameters (`ParamLayers`), read
// through the constant cache as they were before the table existed; a deeper one reads them from
// the table in device memory through the read-only path
// (`TableLayers`).  Both apply a fleet member's offset where W is read
// (`Slices::member`).  A
// body reading every net from the table was 10% slower an epoch at
// 784-300-10 on an H100 (PERF.md), hence the two; which one a launch takes
// is a template argument of the kernels, and every sum is the same.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

#define HPNN_PARAM_LAYERS 16  // layers whose values ride in the kernel parameters
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

typedef __nv_bfloat16 bf16;

// The type a value of storage type T is computed in: T itself, or float
// for bf16.
template <typename T>
struct Acc {
  typedef T type;
};
template <>
struct Acc<bf16> {
  typedef float type;
};
template <typename T>
using acc_t = typename Acc<T>::type;

// A computed value as stored in T (rounded to nearest even for bf16), and
// a stored value as computed.  The bf16 conversions are the intrinsics:
// the build may define __CUDA_NO_BFLOAT16_CONVERSIONS__.
template <typename T>
__device__ __forceinline__ T to_t(acc_t<T> v) { return v; }
template <>
__device__ __forceinline__ bf16 to_t<bf16>(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ double ld(const double* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

// One layer of the launch's table (ops/batch_step.py::LAYER).
struct Layer {
  unsigned long long w, dw;  // W_l and its dw (member 0's of a fleet), or 0
  long long cum;             // rows of the layers below l: acts offset / B
  int m, n;                  // columns and rows of W_l
};
static_assert(sizeof(Layer) == 32, "ops/batch_step.py::LAYER packs 32 bytes");

// The per-layer values of a net of at most HPNN_PARAM_LAYERS layers, by
// value in the kernel parameters; member i's W_l starts i*m*n values past
// member 0's.
template <typename T>
struct ParamLayers {
  int dims[HPNN_PARAM_LAYERS + 1];  // dims[0] = n_in, dims[l+1] = rows of W_l
  size_t off_[HPNN_PARAM_LAYERS];   // offset of layer l's (B, dims[l+1]) block
  T* w_[HPNN_PARAM_LAYERS];         // member 0's
  T* dw_[HPNN_PARAM_LAYERS];

  __device__ int m(int l) const { return dims[l]; }
  __device__ int n(int l) const { return dims[l + 1]; }
  __device__ size_t off(int l, int) const { return off_[l]; }
  __device__ T* w(int l, size_t i) const { return w_[l] + i * ((size_t)dims[l] * dims[l + 1]); }
  __device__ T* dw(int l, size_t i) const { return dw_[l] + i * ((size_t)dims[l] * dims[l + 1]); }
};

// The per-layer values of a net of any depth: the table in device
// memory, read through the read-only path; member i's W_l starts
// i*m*n values past member 0's.
template <typename T>
struct TableLayers {
  const Layer* lay;  // n_layers records

  __device__ int m(int l) const { return __ldg(&lay[l].m); }
  __device__ int n(int l) const { return __ldg(&lay[l].n); }
  __device__ size_t off(int l, int B) const { return (size_t)B * __ldg(&lay[l].cum); }
  __device__ T* w(int l, size_t i) const {
    return reinterpret_cast<T*>(__ldg(&lay[l].w)) + i * ((size_t)m(l) * n(l));
  }
  __device__ T* dw(int l, size_t i) const {
    return reinterpret_cast<T*>(__ldg(&lay[l].dw)) + i * ((size_t)m(l) * n(l));
  }
};

// One net's share of a launch's device memory: member i's of a fleet.
template <typename T>
struct Slices {
  const T* X;         // bank of (blocks*B, n_in)
  const T* Tg;        // bank of (blocks*B, n_out)
  const int* order;   // (S,) block ids in device memory, or null
  T* acts;            // sum over layers of (B, dims[l+1])
  T* ds;              // the same shape as acts
  acc_t<T>* rowloss;  // (B,)
  acc_t<T>* losses;   // (S,)
  size_t member;      // its index in the stacked (N, out, in) weights
};

// Member strides of a fleet launch, in elements of T, and its members.
struct Fleet {
  size_t x, t;     // one member's bank of X (bank_rows*n_in) and of T
  size_t scratch;  // 2*B*n_act + B*sizeof(acc_t<T>)/sizeof(T)
  int n;           // members
};

template <typename T, class Ly>
struct Params {
  typedef acc_t<T> A;
  int n_layers;
  Ly ly;        // the per-layer values
  Slices<T> s;  // member 0's, or the one net's
  Fleet f;      // {0, 0, 0, 1} for one net
  int first;    // with a null order, step k reads block first + k
  int B, S;
  A lr, alpha, inv_b;
  int snn, momentum, prefetch;

  __device__ int m(int l) const { return ly.m(l); }  // columns of W_l
  __device__ int n(int l) const { return ly.n(l); }  // rows of W_l
  __device__ size_t off(int l) const { return ly.off(l, B); }
  __device__ T* w(int l, const Slices<T>& q) const { return ly.w(l, q.member); }
  __device__ T* dw(int l, const Slices<T>& q) const { return ly.dw(l, q.member); }
  // member i's slices: its orders and losses are row i of (N, S)
  __device__ Slices<T> at(size_t i) const {
    Slices<T> q = s;
    q.X += i * f.x;
    q.Tg += i * f.t;
    if (q.order) q.order += i * S;
    q.acts += i * f.scratch;
    q.ds += i * f.scratch;
    q.rowloss = reinterpret_cast<A*>(reinterpret_cast<T*>(q.rowloss) + i * f.scratch);
    q.losses += i * S;
    q.member = i;
    return q;
  }
  // the block of the bank that q's step k reads, and its rows of X and T
  __device__ int block(const Slices<T>& q, int k) const {
    return q.order ? __ldg(q.order + k) : first + k;
  }
  __device__ const T* x(const Slices<T>& q, int k) const {
    return q.X + (size_t)block(q, k) * B * m(0);
  }
  __device__ const T* tg(const Slices<T>& q, int k) const {
    return q.Tg + (size_t)block(q, k) * B * n(n_layers - 1);
  }
};

// Shared memory of one block: per worker two stages of an A and a B
// k-tile (HPNN_TILE rows of stage_ld<T>() values of T each: as computed
// for float and double, raw for bf16's tensor cores) and a staged output
// tile of acc_t<T>.  ops/batch_step.py::shared_bytes mirrors it.
template <typename S>
__host__ __device__ constexpr int stage_ld() { return HPNN_TILE + 16 / (int)sizeof(S); }
template <typename S>
__host__ __device__ constexpr int stage_values() { return HPNN_TILE * stage_ld<S>(); }
template <typename T>
__host__ __device__ constexpr size_t worker_bytes() {
  return 4 * stage_values<T>() * sizeof(T) +
         HPNN_TILE * HPNN_OUT_LD * sizeof(acc_t<T>);
}
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)HPNN_WORKERS * worker_bytes<T>();
}

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
// exp(x) of the SNN output (x = z - 1), models/snn.py's out_exp: a
// subnormal double result is exp(x / 2) squared, rounded once by the
// multiply, since exp itself can return 0 there where the CPU does not
__device__ __forceinline__ float out_exp(float x) { return expf(x); }
__device__ __forceinline__ double out_exp(double x) {
  if (x < -708.0) {
    const double h = exp(0.5 * x);
    return h * h;
  }
  return exp(x);
}
__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

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

// Parts of a tile's k-tiles, clocked by the same thread in the same
// build: issuing the loads of a later k-tile; storing a k-tile into its
// stage (waiting for its loads included); the fragment loads
// (ldmatrix; none apart in the SIMT tile, whose shared-memory loads
// interleave with its FMA); the products (mma, or the SIMT loop); the
// worker's barrier.
enum KPart { K_LOADS, K_STORES, K_FRAGS, K_PRODUCTS, K_BARRIER, N_KPARTS };

#ifdef HPNN_PHASE_CLOCKS
// cycles by KPart, then the number of k-tiles they cover
__device__ unsigned long long g_ktile_clocks[N_KPARTS + 1];

// Cycles of one thread by KPart over one tile: to(k) closes the part
// under way as k, next() counts a k-tile, flush() adds the tile's cycles
// and k-tiles to g_ktile_clocks.
struct KClock {
  bool on;
  long long last;
  unsigned long long acc[N_KPARTS + 1];
  __device__ explicit KClock(bool on_) : on(on_) {
    for (int k = 0; k <= N_KPARTS; ++k) acc[k] = 0;
  }
  __device__ void start() {
    if (on) last = clock64();
  }
  __device__ void to(int k) {
    if (on) {
      const long long t = clock64();
      acc[k] += (unsigned long long)(t - last);
      last = t;
    }
  }
  __device__ void next() { ++acc[N_KPARTS]; }
  __device__ void flush() {
    if (on)
      for (int k = 0; k <= N_KPARTS; ++k) atomicAdd(&g_ktile_clocks[k], acc[k]);
  }
};
#else
struct KClock {
  __device__ explicit KClock(bool) {}
  __device__ void start() {}
  __device__ void to(int) {}
  __device__ void next() {}
  __device__ void flush() {}
};
#endif

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
  static constexpr bool fleet = Team::fleet;
  Team& team;
  PhaseClock& clk;
  __device__ int rank() const { return team.rank(); }
  __device__ int size() const { return team.size(); }
  __device__ int members() const { return team.members(); }
  __device__ void sync() {
    const int was = clk.cur;
    clk.to(P_SYNC);
    team.sync();
    clk.to(was);
  }
};
#endif

// The unit of work of an epoch: the whole cooperative grid on one net
// (#2-#5) ...
struct GridTeam {
  static constexpr bool fleet = false;
  cg::grid_group grid;
  __device__ int rank() const { return blockIdx.x; }
  __device__ int size() const { return gridDim.x; }
  __device__ int members() const { return 1; }
  __device__ void sync() { grid.sync(); }
};

// ... or one thread-block cluster on one net, a fleet member (#6); C = 1
// is one thread block, whose own __syncthreads orders its device memory
// ...
struct ClusterTeam {
  static constexpr bool fleet = false;
  int r, n;
  __device__ ClusterTeam() {
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  }
  __device__ int rank() const { return r; }
  __device__ int size() const { return n; }
  __device__ int members() const { return 1; }
  __device__ void sync() {
    if (n > 1)
      cluster_barrier();
    else
      __syncthreads();
  }
};

// ... or the whole cooperative grid on every member of a fleet (#6): a
// phase's tiles are the members' laid end to end, member i's tile t the
// (i*tiles + t)-th, so one worker takes tiles of several members, and
// every member's step advances at each grid.sync().
struct FleetGridTeam {
  static constexpr bool fleet = true;
  cg::grid_group grid;
  int n;  // members
  __device__ int rank() const { return blockIdx.x; }
  __device__ int size() const { return gridDim.x; }
  __device__ int members() const { return n; }
  __device__ void sync() { grid.sync(); }
};

// One HPNN_WORKER-thread tile worker of a block: its id, its thread's
// index in it and its shared memory (stage s of operand o at stage(o, s);
// the staged output tile at out).
template <typename T>
struct Worker {
  typedef acc_t<T> A;
  unsigned char* sm;
  int id, w;
#ifdef HPNN_PHASE_CLOCKS
  bool timed = false;  // this thread clocks its tiles' k-tiles (KClock)
#endif
  __device__ explicit Worker(unsigned char* smem)
      : sm(smem + (size_t)(threadIdx.x / HPNN_WORKER) * worker_bytes<T>()),
        id(threadIdx.x / HPNN_WORKER), w(threadIdx.x % HPNN_WORKER) {}
  __device__ T* stage(int o, int s) const {
    return reinterpret_cast<T*>(sm) + (2 * o + s) * stage_values<T>();
  }
  __device__ A* out() const {
    return reinterpret_cast<A*>(sm + 4 * stage_values<T>() * sizeof(T));
  }
  __device__ bool clocked() const {
#ifdef HPNN_PHASE_CLOCKS
    return timed;
#else
    return false;
#endif
  }
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

// k-tile kt of the operand (K deep) into the thread's registers, as
// computed; 0 outside the matrix.
template <typename T>
__device__ __forceinline__ void load_tile(acc_t<T> (&v)[HPNN_LOADS], const Operand<T>& o,
                                          int kt, int K) {
  typedef acc_t<T> A;
  const T* p = o.base + (size_t)kt * o.kstep;
  const int kleft = K - kt * HPNN_TILE - o.kb;  // value k offsets below it are inside
  if (o.kfast) {
#pragma unroll
    for (int g = 0; g < HPNN_LOADS / 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * g + j] = ((o.rows >> g) & 1u) && 8 * j < kleft
                           ? ldcg(p + g * o.step + 8 * j) : A(0);
  } else {
#pragma unroll
    for (int q = 0; q < HPNN_LOADS; ++q)
      v[q] = o.rows && q * (HPNN_WORKER / 32) < kleft ? ldcg(p + q * o.step) : A(0);
  }
}

// The registers of load_tile into a stage, k-major: S[k][x].
template <typename T>
__device__ __forceinline__ void store_tile(acc_t<T>* S, const acc_t<T> (&v)[HPNN_LOADS],
                                           const Operand<T>& o) {
  constexpr int LD = stage_ld<acc_t<T>>();
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
// worker `wk`, on the SIMT FMA (float, double); calls epi(r, c, acc) for
// each element inside (M, N).  Thread (ty, tx) of 8 x HPNN_TX owns rows
// 4ty..4ty+3 and columns HPNN_CW*tx..HPNN_CW*tx+HPNN_CW-1.
template <typename T, typename Epi>
__device__ void gemm_tile_simt(int M, int N, int K, const T* A, size_t sar, size_t sak,
                               const T* Bm, size_t sbk, size_t sbc, int tm, int tn,
                               const Worker<T>& wk, Epi epi) {
  typedef acc_t<T> V;
  const int ty = wk.w / HPNN_TX, tx = wk.w % HPNN_TX;
  const int r0 = tm * HPNN_TILE, c0 = tn * HPNN_TILE;
  constexpr int LD = stage_ld<V>();
  KClock kc(wk.clocked());
  kc.start();
  const Operand<T> oa = operand(A, sar, sak, r0, M, wk.w);
  const Operand<T> ob = operand(Bm, sbc, sbk, c0, N, wk.w);
  V acc[4][HPNN_CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HPNN_CW; ++j) acc[i][j] = V(0);
  V va[HPNN_LOADS], vb[HPNN_LOADS];
  load_tile(va, oa, 0, K);
  load_tile(vb, ob, 0, K);
  kc.to(K_LOADS);
  store_tile(wk.stage(0, 0), va, oa);
  store_tile(wk.stage(1, 0), vb, ob);
  kc.to(K_STORES);
  wk.sync();
  kc.to(K_BARRIER);
  const int nk = cdiv(K, HPNN_TILE);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {  // k-tile kt+1 in flight while kt is computed
      load_tile(va, oa, kt + 1, K);
      load_tile(vb, ob, kt + 1, K);
    }
    kc.to(K_LOADS);
    const V* As = wk.stage(0, s) + 4 * ty;
    const V* Bs = wk.stage(1, s) + HPNN_CW * tx;
    const int kmax = min(HPNN_TILE, K - kt * HPNN_TILE);
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      V a[4], b[HPNN_CW];
      ldv<4>(a, As + kk * LD);
      ldv<HPNN_CW>(b, Bs + kk * LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < HPNN_CW; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    kc.to(K_PRODUCTS);
    if (more) {
      store_tile(wk.stage(0, s ^ 1), va, oa);
      store_tile(wk.stage(1, s ^ 1), vb, ob);
    }
    kc.to(K_STORES);
    // the one barrier a k-tile: stage s^1 is full, and nobody still
    // reads stage s, which k-tile kt+2 overwrites
    wk.sync();
    kc.to(K_BARRIER);
    kc.next();
  }
  kc.flush();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HPNN_CW; ++j) {
      const int r = r0 + 4 * ty + i, c = c0 + HPNN_CW * tx + j;
      if (r < M && c < N) epi(r, c, acc[i][j]);
    }
}

// ---- the bf16 tile on the tensor cores

// A thread's share of the 32 x 32 k-tiles of one bf16 operand, staged as
// device memory holds them: stage row i, column j is P(x0 + i, k0 + j)
// for an operand contiguous in k (P[x*sx + k]) and P(x0 + j, k0 + i)
// otherwise (P[x + k*sk]).  Vector: the thread loads row `row`, the 8
// columns from `col`, in one 16-byte load; else column `col` of rows
// row + 4j, j < 8, by 2-byte loads, a warp 64 consecutive bytes of a row
// (loads of 4 or 8 bytes where the rows allow them were measured slower:
// PERF.md).  The addresses are laid out once a tile: `base` is the
// thread's first value at k-tile 0.
struct Tile16 {
  const bf16* base;
  size_t rstep;   // from the thread's row j to row j+1 (2-byte loads)
  size_t kstep;   // from one k-tile to the next
  int row, col;   // the thread's first stage row and column
  int xleft;      // rows (k-contiguous) or columns (else) inside the matrix
  bool kfast, vec;
};

__device__ __forceinline__ Tile16 tile16(const bf16* P, size_t sx, size_t sk, int x0,
                                         int xlim, int K, int w) {
  Tile16 o;
  o.kfast = sk == 1;
  const size_t rs = o.kfast ? sx : sk;  // from one stage row to the next
  // 16-byte loads need 16-byte aligned rows and a matrix edge on 8 values
  o.vec = rs % 8 == 0 && (o.kfast ? K : xlim) % 8 == 0 &&
          reinterpret_cast<uintptr_t>(P) % 16 == 0;
  if (o.vec) {
    o.row = w >> 2, o.col = 8 * (w & 3);
  } else {
    o.row = w >> 5, o.col = w & 31;
  }
  o.rstep = 4 * rs;
  o.kstep = o.kfast ? HPNN_TILE : HPNN_TILE * sk;
  o.xleft = xlim - x0;
  o.base = o.kfast ? P + (size_t)(x0 + o.row) * sx + o.col
                   : P + (size_t)x0 + o.col + (size_t)o.row * sk;
  return o;
}

// A k-tile in flight: 16 bytes (vector) or 8 values of 2 bytes.
struct Ld16 {
  unsigned u[8];
};

// k-tile kt of the operand (K deep) into the thread's registers, raw;
// 0 outside the matrix.
__device__ __forceinline__ void load16(Ld16& v, const Tile16& o, int kt, int K) {
  const int kleft = K - kt * HPNN_TILE;
  const int rows = o.kfast ? o.xleft : kleft, cols = o.kfast ? kleft : o.xleft;
  const bf16* p = o.base + (size_t)kt * o.kstep;
  if (o.vec) {
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (o.row < rows && o.col < cols) q = __ldcg(reinterpret_cast<const uint4*>(p));
    v.u[0] = q.x, v.u[1] = q.y, v.u[2] = q.z, v.u[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v.u[j] = o.row + 4 * j < rows && o.col < cols
                   ? __ldcg(reinterpret_cast<const unsigned short*>(p + j * o.rstep)) : 0u;
  }
}

// The registers of load16 into a stage.
__device__ __forceinline__ void store16(bf16* S, const Ld16& v, const Tile16& o) {
  constexpr int LD = stage_ld<bf16>();
  if (o.vec) {
    *reinterpret_cast<uint4*>(S + o.row * LD + o.col) = make_uint4(v.u[0], v.u[1], v.u[2], v.u[3]);
  } else {
    unsigned short* h = reinterpret_cast<unsigned short*>(S);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[(o.row + 4 * j) * LD + o.col] = (unsigned short)v.u[j];
  }
}

// The stage offset of the row that `lane` gives `ldmatrix.x4` for a
// 16 x 16 (x, k) block at x offset xw: the four 8 x 8 matrices in the
// order of an A fragment, (x, k) blocks (0, 0), (8, 0), (0, 8), (8, 8),
// or of two B fragments, (0, 0), (0, 8), (8, 0), (8, 8).  A stage of x
// rows is read as stored, one of k rows transposed (.trans).
__device__ __forceinline__ int frag_off(bool kfast, bool a_order, int xw, int lane) {
  constexpr int LD = stage_ld<bf16>();
  const int m = lane >> 3;
  const int xo = 8 * (a_order ? m & 1 : m >> 1), ko = 8 * (a_order ? m >> 1 : m & 1);
  return kfast ? (xw + xo + (lane & 7)) * LD + ko : (ko + (lane & 7)) * LD + xw + xo;
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p, bool trans) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a . b on the tensor cores: exact bf16 products, float32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tile of gemm_tile_simt for bf16, on the tensor cores.  Warp q owns
// the quadrant of rows 16(q/2).. and columns 16(q%2)..; its lane l holds
// the m16n8 accumulators of rows l/4 and l/4 + 8, columns 2(l%4) and
// 2(l%4) + 1 of each of its two 8-column fragments.  K-tile kt+1 and
// kt+2 are in flight while kt is multiplied: `hold` carries kt+1 (stored
// after the products), `next` takes kt+2's loads.
template <typename T, typename Epi>
__device__ void gemm_tile_mma(int M, int N, int K, const T* A, size_t sar, size_t sak,
                              const T* Bm, size_t sbk, size_t sbc, int tm, int tn,
                              const Worker<T>& wk, Epi epi) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core tile takes bf16");
  const int lane = wk.w & 31, warp = wk.w >> 5;
  const int r0 = tm * HPNN_TILE, c0 = tn * HPNN_TILE;
  const int wr = 16 * (warp >> 1), wc = 16 * (warp & 1);
  KClock kc(wk.clocked());
  kc.start();
  const Tile16 oa = tile16(A, sar, sak, r0, M, K, wk.w);
  const Tile16 ob = tile16(Bm, sbc, sbk, c0, N, K, wk.w);
  constexpr int LD = stage_ld<bf16>();
  const int fa = frag_off(oa.kfast, true, wr, lane), fb = frag_off(ob.kfast, false, wc, lane);
  const int ia = oa.kfast ? 16 : 16 * LD, ib = ob.kfast ? 16 : 16 * LD;  // one k16 step
  // a quadrant wholly outside C stages its share of the k-tiles and
  // multiplies nothing
  const bool live = r0 + wr < M && c0 + wc < N;
  float acc[2][4] = {};
  const int nk = cdiv(K, HPNN_TILE);
  Ld16 ha, hb, na, nb;
  load16(ha, oa, 0, K);
  load16(hb, ob, 0, K);
  kc.to(K_LOADS);
  store16(wk.stage(0, 0), ha, oa);
  store16(wk.stage(1, 0), hb, ob);
  kc.to(K_STORES);
  if (nk > 1) {
    load16(ha, oa, 1, K);
    load16(hb, ob, 1, K);
  }
  kc.to(K_LOADS);
  wk.sync();
  kc.to(K_BARRIER);
  auto ktile = [&](int kt, Ld16& hold_a, Ld16& hold_b, Ld16& next_a, Ld16& next_b) {
    const int s = kt & 1;
    if (kt + 2 < nk) {
      load16(next_a, oa, kt + 2, K);
      load16(next_b, ob, kt + 2, K);
    }
    kc.to(K_LOADS);
    if (live) {
      const bf16* As = wk.stage(0, s) + fa;
      const bf16* Bs = wk.stage(1, s) + fb;
      // the second k16 step only where the k-tile reaches it
      const int steps = K - kt * HPNN_TILE > 16 ? 2 : 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h < steps) {
          unsigned a[4], b[4];
          ldsm4(a, As + h * ia, !oa.kfast);
          ldsm4(b, Bs + h * ib, !ob.kfast);
          kc.to(K_FRAGS);
          mma16816(acc[0], a, b[0], b[1]);
          mma16816(acc[1], a, b[2], b[3]);
          kc.to(K_PRODUCTS);
        }
      }
    }
    if (kt + 1 < nk) {
      store16(wk.stage(0, s ^ 1), hold_a, oa);
      store16(wk.stage(1, s ^ 1), hold_b, ob);
    }
    kc.to(K_STORES);
    // stage s^1 is full, and nobody still reads stage s, which k-tile
    // kt+2 overwrites
    wk.sync();
    kc.to(K_BARRIER);
    kc.next();
  };
  for (int kt = 0; kt < nk; kt += 2) {
    ktile(kt, ha, hb, na, nb);
    if (kt + 1 < nk) ktile(kt + 1, na, nb, ha, hb);
  }
  kc.flush();
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + wr + g + 8 * (e >> 1), c = c0 + wc + 8 * f + 2 * q + (e & 1);
      if (r < M && c < N) epi(r, c, acc[f][e]);
    }
}

// One 32x32 tile of C = A . Bm by the worker (gemm_tile_simt's contract):
// on the tensor cores for bf16, on the SIMT FMA for float and double.
template <typename T, typename Epi>
__device__ __forceinline__ void gemm_tile(int M, int N, int K, const T* A, size_t sar,
                                          size_t sak, const T* Bm, size_t sbk, size_t sbc,
                                          int tm, int tn, const Worker<T>& wk, Epi epi) {
  if constexpr (std::is_same<T, bf16>::value)
    gemm_tile_mma(M, N, K, A, sar, sak, Bm, sbk, sbc, tm, tn, wk, epi);
  else
    gemm_tile_simt(M, N, K, A, sar, sak, Bm, sbk, sbc, tm, tn, wk, epi);
}

// One output row b of member q held whole in shared memory (`os`, its n
// values as the forward wrote them): the SNN normalisation, then the
// output delta (loss == false) or the row's error into rowloss (loss ==
// true).  `o` is where the row's outputs go in acts.  The same operations
// in the same order as output_rows.
template <typename T, class Ly>
__device__ void finish_row(const Params<T, Ly>& p, const Slices<T>& q, const acc_t<T>* os, T* o,
                           const T* t, int b, bool loss) {
  typedef acc_t<T> A;
  const int n = p.n(p.n_layers - 1);
  const A tiny = A(1e-14);
  A dv = A(1);
  if (p.snn) {
    A s = A(0);
    for (int i = 0; i < n; ++i) s += os[i];
    dv = tiny + s;
  }
  if (loss) {
    A acc = A(0);
    for (int i = 0; i < n; ++i) {
      const A oi = p.snn ? os[i] / dv : os[i];
      o[i] = to_t<T>(oi);
      if (p.snn) {
        acc += clamp0(ld(t + i)) * dev_log(oi + tiny);
      } else {
        const A d = ld(t + i) - oi;
        acc += d * d;
      }
    }
    q.rowloss[b] = acc;
  } else {
    T* d = q.ds + p.off(p.n_layers - 1) + (size_t)b * n;
    for (int i = 0; i < n; ++i) {
      const A oi = p.snn ? os[i] / dv : os[i];
      o[i] = to_t<T>(oi);
      d[i] = to_t<T>(p.snn ? clamp0(ld(t + i)) - oi : (ld(t + i) - oi) * dact(oi));
    }
  }
}

// What the last forward layer's tiles do once their outputs are in:
// nothing (the output rows take a pass of their own), or, when one tile
// column holds an output row, its delta or its error.
enum Finish { F_NONE, F_DELTAS, F_LOSS };

// Step k of an epoch: its block's rows of X and T for a one-net team,
// found once a step (a fleet team finds each member's at each tile).
template <typename T>
struct Step {
  int k;
  const T* x;
  const T* tg;
};

template <bool fleet, typename T, class Ly>
__device__ __forceinline__ const T* x_of(const Params<T, Ly>& p, const Step<T>& st,
                                         const Slices<T>& q) {
  if constexpr (fleet)
    return p.x(q, st.k);
  else
    return st.x;
}

template <bool fleet, typename T, class Ly>
__device__ __forceinline__ const T* tg_of(const Params<T, Ly>& p, const Step<T>& st,
                                          const Slices<T>& q) {
  if constexpr (fleet)
    return p.tg(q, st.k);
  else
    return st.tg;
}

// The worker's tiles of a phase of `tiles` tiles a member: fn(q, t) for
// each, t a tile of the member whose slices are q (`one`, for a one-net
// team).
template <typename T, class Ly, typename Team, typename Fn>
__device__ __forceinline__ void walk(const Params<T, Ly>& p, const Slices<T>& one,
                                     const Team& team, const Worker<T>& wk, int tiles, Fn fn) {
  const int total = team.members() * tiles;
  for (int t = wk.first(team); t < total; t += wk.stride(team)) {
    if constexpr (Team::fleet) {
      const int i = t / tiles;
      fn(p.at(i), t - i * tiles);
    } else {
      fn(one, t);
    }
  }
}

// acts_l <- forward of step st's (B, n_in) block through every layer.
template <typename T, class Ly, typename Team>
__device__ void forward(const Params<T, Ly>& p, const Slices<T>& one, const Step<T>& st,
                        Team& team, const Worker<T>& wk, Finish finish) {
  for (int l = 0; l < p.n_layers; ++l) {
    const int m = p.m(l), n = p.n(l);
    const bool soft = p.snn && l == p.n_layers - 1;
    const bool fold = finish != F_NONE && l == p.n_layers - 1;  // then n <= HPNN_TILE
    const int tn_count = cdiv(n, HPNN_TILE);
    const int tiles = cdiv(p.B, HPNN_TILE) * tn_count;
    walk(p, one, team, wk, tiles, [&](const Slices<T>& q, int t) {
      typedef acc_t<T> A;
      const T* vin = l == 0 ? x_of<Team::fleet>(p, st, q) : q.acts + p.off(l - 1);
      T* vout = q.acts + p.off(l);
      const int tm = t / tn_count;
      A* os = wk.out();
      gemm_tile<T>(p.B, n, m, vin, m, 1, p.w(l, q), 1, m, tm, t % tn_count, wk,
                   [&](int r, int c, A z) {
                     const A v = soft ? out_exp(z - A(1)) : act(z);
                     if (fold)
                       os[(r - tm * HPNN_TILE) * HPNN_OUT_LD + c] = v;
                     else
                       vout[(size_t)r * n + c] = to_t<T>(v);
                   });
      if (fold) {
        wk.sync();  // the tile's outputs are staged
        const int b = tm * HPNN_TILE + wk.w;
        if (wk.w < HPNN_TILE && b < p.B)
          finish_row(p, q, os + wk.w * HPNN_OUT_LD, vout + (size_t)b * n,
                     tg_of<Team::fleet>(p, st, q) + (size_t)b * n, b, finish == F_LOSS);
        // the next write of `os` follows this tile's k-tile barriers
      }
    });
    team.sync();
  }
}

// One thread per output row of every member: the SNN normalisation, then
// the output delta (loss == false) or the row's error into rowloss (loss
// == true).  For n_out > HPNN_TILE, where a row spans tiles.
template <typename T, class Ly, typename Team>
__device__ void output_rows(const Params<T, Ly>& p, const Slices<T>& one, const Step<T>& st,
                            const Team& team, bool loss) {
  typedef acc_t<T> A;
  const int L = p.n_layers, n = p.n(L - 1);
  const A tiny = A(1e-14);
  const int stride = team.size() * blockDim.x;
  const int total = team.members() * p.B;
  for (int r = team.rank() * blockDim.x + threadIdx.x; r < total; r += stride) {
    Slices<T> q = one;
    int b = r;
    if constexpr (Team::fleet) {
      const int i = r / p.B;
      q = p.at(i);
      b = r - i * p.B;
    }
    T* o = q.acts + p.off(L - 1) + (size_t)b * n;
    const T* t = tg_of<Team::fleet>(p, st, q) + (size_t)b * n;
    if (p.snn) {
      A s = A(0);
      for (int i = 0; i < n; ++i) s += ldcg(o + i);
      const A dv = tiny + s;
      for (int i = 0; i < n; ++i) o[i] = to_t<T>(ldcg(o + i) / dv);
    }
    if (loss) {
      A acc = A(0);
      for (int i = 0; i < n; ++i) {
        const A oi = ldcg(o + i);
        if (p.snn) {
          acc += clamp0(ld(t + i)) * dev_log(oi + tiny);
        } else {
          const A d = ld(t + i) - oi;
          acc += d * d;
        }
      }
      q.rowloss[b] = acc;
    } else {
      T* d = q.ds + p.off(L - 1) + (size_t)b * n;
      for (int i = 0; i < n; ++i) {
        const A oi = ldcg(o + i);
        d[i] = to_t<T>(p.snn ? clamp0(ld(t + i)) - oi : (ld(t + i) - oi) * dact(oi));
      }
    }
  }
}

// Hidden deltas, last hidden layer first, from the current weights.
template <typename T, class Ly, typename Team>
__device__ void hidden_deltas(const Params<T, Ly>& p, const Slices<T>& one, Team& team,
                              const Worker<T>& wk) {
  for (int l = p.n_layers - 2; l >= 0; --l) {
    const int n = p.n(l), k = p.n(l + 1);
    const int tn_count = cdiv(n, HPNN_TILE);
    const int tiles = cdiv(p.B, HPNN_TILE) * tn_count;
    walk(p, one, team, wk, tiles, [&](const Slices<T>& q, int t) {
      const T* dn = q.ds + p.off(l + 1);
      const T* a = q.acts + p.off(l);
      T* d = q.ds + p.off(l);
      gemm_tile<T>(p.B, n, k, dn, k, 1, p.w(l + 1, q), n, 1, t / tn_count, t % tn_count, wk,
                   [&](int r, int c, acc_t<T> z) {
                     const size_t e = (size_t)r * n + c;
                     d[e] = to_t<T>(z * dact(ldcg(a + e)));
                   });
    });
    team.sync();
  }
}

// The update of every layer, its tiles laid end to end over the team.
template <typename T, class Ly, typename Team>
__device__ void update(const Params<T, Ly>& p, const Slices<T>& one, const Step<T>& st,
                       Team& team, const Worker<T>& wk) {
  int total = 0;
  for (int l = 0; l < p.n_layers; ++l)
    total += cdiv(p.n(l), HPNN_TILE) * cdiv(p.m(l), HPNN_TILE);
  walk(p, one, team, wk, total, [&](const Slices<T>& q, int t) {
    int l = 0, tt = t;
    while (true) {
      const int c = cdiv(p.n(l), HPNN_TILE) * cdiv(p.m(l), HPNN_TILE);
      if (tt < c) break;
      tt -= c;
      ++l;
    }
    const int M = p.n(l), N = p.m(l);
    const T* d = q.ds + p.off(l);
    const T* v = l == 0 ? x_of<Team::fleet>(p, st, q) : q.acts + p.off(l - 1);
    T* W = p.w(l, q);
    T* DW = p.dw(l, q);
    const int tn_count = cdiv(N, HPNN_TILE);
    gemm_tile<T>(M, N, p.B, d, 1, M, v, N, 1, tt / tn_count, tt % tn_count, wk,
                 [&](int i, int j, acc_t<T> outer) {
                   const size_t e = (size_t)i * N + j;
                   if (p.momentum) {
                     const acc_t<T> m = ldcg(DW + e) + p.lr * outer;
                     W[e] = to_t<T>(ldcg(W + e) + m);
                     DW[e] = to_t<T>(p.alpha * m);
                   } else {
                     W[e] = to_t<T>(ldcg(W + e) + p.lr * outer);
                   }
                 });
  });
  team.sync();
}

// Start the copy of block `blk` of q's banks into L2, spread over the
// `size` blocks ranked `rank` of those that share it.
template <typename T, class Ly>
__device__ void prefetch_block(const Params<T, Ly>& p, const Slices<T>& q, int rank, int size,
                               int blk) {
  const size_t tid = (size_t)rank * blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)size * blockDim.x;
  const size_t rows = (size_t)blk * p.B;
  const char* xb = reinterpret_cast<const char*>(q.X + rows * p.m(0));
  const char* tb = reinterpret_cast<const char*>(q.Tg + rows * p.n(p.n_layers - 1));
  const size_t nx = (size_t)p.B * p.m(0) * sizeof(T);
  const size_t nt = (size_t)p.B * p.n(p.n_layers - 1) * sizeof(T);
  for (size_t o = tid * 128; o < nx; o += nthreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(xb + o));
  for (size_t o = tid * 128; o < nt; o += nthreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(tb + o));
}

// Start the copies of step k's blocks: the team's net's over the whole
// team, or member i's over the grid's blocks of rank i mod N (each block
// a share of the members, when they outnumber the blocks).
template <typename T, class Ly, typename Team>
__device__ void prefetch_step(const Params<T, Ly>& p, const Slices<T>& one, const Team& team,
                              int k) {
  if constexpr (Team::fleet) {
    const int N = team.members(), G = team.size(), r = team.rank();
    if (N <= G) {
      const Slices<T> q = p.at(r % N);
      prefetch_block(p, q, r / N, (G - 1 - r % N) / N + 1, p.block(q, k));
    } else {
      for (int i = r; i < N; i += G) {
        const Slices<T> q = p.at(i);
        prefetch_block(p, q, 0, 1, p.block(q, k));
      }
    }
  } else {
    prefetch_block(p, one, team.rank(), team.size(), p.block(one, k));
  }
}

// q's loss of step k from its row losses, by one warp in a fixed tree.
template <typename T, class Ly>
__device__ void step_loss(const Params<T, Ly>& p, const Slices<T>& q, int k) {
  typedef acc_t<T> A;
  A acc = A(0);
  for (int b = threadIdx.x; b < p.B; b += 32) acc += ldcg(q.rowloss + b);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (threadIdx.x == 0) {
    const int n_out = p.n(p.n_layers - 1);
    q.losses[k] = p.snn ? -acc * p.inv_b / A(n_out) : A(0.5) * acc * p.inv_b;
  }
}

// One epoch of S steps by `team`, on the net whose slices are `one` (a
// one-net team) or on every member (a fleet team).
template <typename T, class Ly, typename Team, typename Clock>
__device__ void epoch(const Params<T, Ly>& p, const Slices<T>& one, Team& team,
                      const Worker<T>& wk, Clock& clk) {
  const bool fold = p.n(p.n_layers - 1) <= HPNN_TILE;
  for (int s = 0; s < p.S; ++s) {
    const Step<T> st{s, p.x(one, s), p.tg(one, s)};
    if (p.prefetch && s + 1 < p.S) prefetch_step(p, one, team, s + 1);
    clk.to(P_FWD);
    forward(p, one, st, team, wk, fold ? F_DELTAS : F_NONE);
    if (!fold) {
      clk.to(P_ROWS);
      output_rows(p, one, st, team, false);
      team.sync();
    }
    clk.to(P_HID);
    hidden_deltas(p, one, team, wk);
    clk.to(P_UPD);
    update(p, one, st, team, wk);
    clk.to(P_FWD);
    forward(p, one, st, team, wk, fold ? F_LOSS : F_NONE);
    if (!fold) {
      clk.to(P_ROWS);
      output_rows(p, one, st, team, true);
      team.sync();
    }
    clk.to(P_REST);
    // rowloss is next written after this step's syncs, so a warp sums
    // each net's while the team starts the next step: the team's first
    // (one net), or the first of block i mod size (member i)
    if (threadIdx.x < 32) {
      if constexpr (Team::fleet) {
        for (int i = team.rank(); i < team.members(); i += team.size())
          step_loss(p, p.at(i), s);
      } else if (team.rank() == 0) {
        step_loss(p, one, s);
      }
    }
  }
}

// The epoch by `team`, its phases clocked in a -DHPNN_PHASE_CLOCKS build
// by thread 0 of the launch's block 0 (the first cluster's rank 0).
template <typename T, class Ly, typename Team>
__device__ void run_epoch(const Params<T, Ly>& p, const Slices<T>& one, Team& team,
                          const Worker<T>& wk) {
#ifdef HPNN_PHASE_CLOCKS
  PhaseClock clk;
  const bool on = blockIdx.x == 0 && threadIdx.x == 0;
  clk.start(on);
  Worker<T> clocked = wk;
  clocked.timed = on;
  TimedTeam<Team> timed{team, clk};
  epoch(p, one, timed, clocked, clk);
  clk.flush();
#else
  NoClock clk;
  epoch(p, one, team, wk, clk);
#endif
}

template <typename T, class Ly>
__global__ void __launch_bounds__(HPNN_THREADS, 1) batch_train(Params<T, Ly> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  GridTeam team{cg::this_grid()};
  run_epoch(p, p.s, team, Worker<T>(smem));
}

// The fleet kernel (#6), `p` holding member 0's slices and the strides
// to member i's.  Team ClusterTeam: cluster i trains member i (one member
// is #2-#5 on a cluster team, cluster 0 on p's slices).  Team
// FleetGridTeam: the cooperative grid trains every member.
template <typename T, class Ly, typename Team>
__global__ void __launch_bounds__(HPNN_THREADS, 1) cluster_train(Params<T, Ly> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (Team::fleet) {
    Team team{cg::this_grid(), p.f.n};
    run_epoch(p, p.s, team, Worker<T>(smem));
  } else {
    Team team;
    run_epoch(p, p.at(blockIdx.x / team.size()), team, Worker<T>(smem));
  }
}

// Every kernel's dynamic shared memory, and the cluster kernels'
// non-portable cluster size, opted in on the current device.  The two
// queries below set them; the wrapper asks one of them once per type and
// device before it launches there, so a launch sets no attribute.
template <typename T, class Ly>
cudaError_t set_attributes_of() {
  const int smem = (int)smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(batch_train<T, Ly>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_train<T, Ly, ClusterTeam>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_train<T, Ly, ClusterTeam>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_train<T, Ly, FleetGridTeam>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

template <typename T>
cudaError_t set_attributes() {
  cudaError_t err = set_attributes_of<T, ParamLayers<T>>();
  return err == cudaSuccess ? set_attributes_of<T, TableLayers<T>>() : err;
}

// Blocks an SM holds of a cooperative kernel, the fewer of its two
// flavours' (parameter and table layers).
template <typename T, typename KP, typename KT>
cudaError_t per_sm_of(KP flavour_param, KT flavour_table, int* per_sm) {
  int table = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, flavour_param, HPNN_THREADS, smem_bytes<T>());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&table, flavour_table, HPNN_THREADS,
                                                        smem_bytes<T>());
  if (err == cudaSuccess && table < *per_sm) *per_sm = table;
  return err;
}

// The cooperative grid of both cooperative kernels: one block an SM at
// most (HPNN_BLOCKS_PER_SM), every block co-resident.
template <typename T>
int grid_blocks(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0, per_sm_fleet = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_attributes<T>();
  if (err == cudaSuccess)
    err = per_sm_of<T>(batch_train<T, ParamLayers<T>>, batch_train<T, TableLayers<T>>,
                       &per_sm);
  if (err == cudaSuccess)
    err = per_sm_of<T>(cluster_train<T, ParamLayers<T>, FleetGridTeam>,
                       cluster_train<T, TableLayers<T>, FleetGridTeam>, &per_sm_fleet);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm_fleet < per_sm) per_sm = per_sm_fleet;
  *blocks = sms * (per_sm < HPNN_BLOCKS_PER_SM ? per_sm : HPNN_BLOCKS_PER_SM);
  return (int)cudaSuccess;
}

// The launch's Params (member 0's, for a fleet) from the host copy of
// the layer table `rec`, the scratch laid out as acts | ds | rowloss,
// rowloss in acc_t<T>; one net's strides ({0, 0, 0, 1}).  Returns the
// number of values of T of one scratch (2*B*n_act + B*sizeof(acc_t<T>) /
// sizeof(T)), or 0 for a shape the kernel does not take.
template <typename T, class Ly>
size_t make_params(Params<T, Ly>* p, int snn, int momentum, int n_layers, const Layer* rec,
                   const void* X, const void* Tg, int B, const int* order, int first, int S,
                   double lr_eff, double alpha, double inv_b, void* scratch, void* losses,
                   int prefetch) {
  if (n_layers < 1 || B < 1 || S < 1) return 0;
  p->n_layers = n_layers;
  const size_t total = (size_t)B * (rec[n_layers - 1].cum + rec[n_layers - 1].n);
  typedef acc_t<T> A;
  p->s.X = static_cast<const T*>(X);
  p->s.Tg = static_cast<const T*>(Tg);
  p->s.order = order;
  p->s.acts = static_cast<T*>(scratch);
  p->s.ds = p->s.acts + total;
  p->s.rowloss = reinterpret_cast<A*>(p->s.ds + total);
  p->s.losses = static_cast<A*>(losses);
  p->s.member = 0;
  p->f = Fleet{0, 0, 0, 1};
  p->first = first;
  p->B = B;
  p->S = S;
  p->lr = (A)lr_eff;
  p->alpha = (A)alpha;
  p->inv_b = (A)inv_b;
  p->snn = snn;
  p->momentum = momentum;
  p->prefetch = prefetch;
  return 2 * total + (size_t)B * (sizeof(A) / sizeof(T));
}

// The per-layer values: by value for a net of at most HPNN_PARAM_LAYERS
// layers, else the table's address.
template <typename T>
void set_layers(ParamLayers<T>* ly, const Layer* rec, const void*, int n_layers, int B,
                int momentum) {
  ly->dims[0] = rec[0].m;
  for (int l = 0; l < n_layers; ++l) {
    ly->dims[l + 1] = rec[l].n;
    ly->off_[l] = (size_t)B * rec[l].cum;
    ly->w_[l] = reinterpret_cast<T*>(rec[l].w);
    ly->dw_[l] = momentum ? reinterpret_cast<T*>(rec[l].dw) : nullptr;
  }
}

template <typename T>
void set_layers(TableLayers<T>* ly, const Layer*, const void* table, int, int, int) {
  ly->lay = static_cast<const Layer*>(table);
}

// The launch of `members` clusters of `cluster` CTAs (1, 2, 4, 8 or 16)
// of cluster_train<T, Ly, ClusterTeam>; `attr` holds the cluster size.
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

// Clusters of `cluster` CTAs the card holds at once (0: none fits), the
// fewer of the two flavours'.
template <typename T>
int max_clusters(int cluster, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n_table = 0;
  cudaError_t err = set_attributes<T>();
  if (err == cudaSuccess) err = cluster_config<T>(&cfg, &attr, 1, cluster, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(n, cluster_train<T, ParamLayers<T>, ClusterTeam>, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n_table, cluster_train<T, TableLayers<T>, ClusterTeam>,
                                         &cfg);
  if (err == cudaSuccess && n_table < *n) *n = n_table;
  return (int)err;
}

// `members` clusters of `cluster` CTAs, cluster i on member i.  The
// wrapper has checked with max_clusters that the card places one.
template <typename T, class Ly>
int launch_clusters(const Params<T, Ly>& p, int members, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T>(&cfg, &attr, members, cluster, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, cluster_train<T, Ly, ClusterTeam>, p);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// One cooperative launch of `kernel` on `blocks` blocks (from
// grid_blocks): refused, never hung, when they cannot all be resident.
template <typename T, class Ly>
int launch_grid(void (*kernel)(Params<T, Ly>), Params<T, Ly> p, int blocks,
                cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                                dim3(HPNN_THREADS), args, smem_bytes<T>(),
                                                stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T, class Ly>
int launch_as(int blocks, int cluster, int snn, int momentum, int n_layers, const void* table,
              const Layer* rec, const void* X, const void* Tg, int B, const int* order,
              int first, int S, double lr_eff, double alpha, double inv_b, void* scratch,
              void* losses, int prefetch, cudaStream_t stream) {
  Params<T, Ly> p;
  if (!make_params(&p, snn, momentum, n_layers, rec, X, Tg, B, order, first, S, lr_eff,
                   alpha, inv_b, scratch, losses, prefetch))
    return (int)cudaErrorInvalidValue;
  set_layers(&p.ly, rec, table, n_layers, B, momentum);
  if (cluster) return launch_clusters(p, 1, cluster, stream);
  return launch_grid<T, Ly>(batch_train<T, Ly>, p, blocks, stream);
}

template <typename T>
int launch(int blocks, int cluster, int snn, int momentum, int n_layers, const void* table,
           const void* host_table, const void* X, const void* Tg, int B, const int* order,
           int first, int S, double lr_eff, double alpha, double inv_b, void* scratch,
           void* losses, int prefetch, cudaStream_t stream) {
  if ((table == nullptr && n_layers > HPNN_PARAM_LAYERS) || host_table == nullptr)
    return (int)cudaErrorInvalidValue;
  const Layer* rec = static_cast<const Layer*>(host_table);
  return n_layers > HPNN_PARAM_LAYERS
             ? launch_as<T, TableLayers<T>>(blocks, cluster, snn, momentum, n_layers, table,
                                            rec, X, Tg, B, order, first, S, lr_eff, alpha,
                                            inv_b, scratch, losses, prefetch, stream)
             : launch_as<T, ParamLayers<T>>(blocks, cluster, snn, momentum, n_layers, table,
                                            rec, X, Tg, B, order, first, S, lr_eff, alpha,
                                            inv_b, scratch, losses, prefetch, stream);
}

template <typename T, class Ly>
int launch_fleet_as(int blocks, int members, int cluster, int snn, int momentum, int n_layers,
                    const void* table, const Layer* rec, const void* X, const void* Tg,
                    long long bank_rows, int B, const int* orders, int S, double lr_eff,
                    double alpha, double inv_b, void* scratch, void* losses,
                    cudaStream_t stream) {
  Params<T, Ly> p;
  const size_t scratch_values = make_params(&p, snn, momentum, n_layers, rec, X, Tg, B, orders,
                                            0, S, lr_eff, alpha, inv_b, scratch, losses, 1);
  if (!scratch_values) return (int)cudaErrorInvalidValue;
  set_layers(&p.ly, rec, table, n_layers, B, momentum);
  p.f = Fleet{(size_t)bank_rows * rec[0].m, (size_t)bank_rows * rec[n_layers - 1].n,
              scratch_values, members};
  if (cluster) return launch_clusters(p, members, cluster, stream);
  return launch_grid<T, Ly>(cluster_train<T, Ly, FleetGridTeam>, p, blocks, stream);
}

template <typename T>
int launch_fleet(int blocks, int members, int cluster, int snn, int momentum, int n_layers,
                 const void* table, const void* host_table, const void* X, const void* Tg,
                 long long bank_rows, int B, const int* orders, int S, double lr_eff,
                 double alpha, double inv_b, void* scratch, void* losses,
                 cudaStream_t stream) {
  if (members < 1 || bank_rows < B || orders == nullptr || host_table == nullptr ||
      (table == nullptr && n_layers > HPNN_PARAM_LAYERS) || n_layers < 1)
    return (int)cudaErrorInvalidValue;
  const Layer* rec = static_cast<const Layer*>(host_table);
  return n_layers > HPNN_PARAM_LAYERS
             ? launch_fleet_as<T, TableLayers<T>>(blocks, members, cluster, snn, momentum,
                                                  n_layers, table, rec, X, Tg, bank_rows, B,
                                                  orders, S, lr_eff, alpha, inv_b, scratch,
                                                  losses, stream)
             : launch_fleet_as<T, ParamLayers<T>>(blocks, members, cluster, snn, momentum,
                                                  n_layers, table, rec, X, Tg, bank_rows, B,
                                                  orders, S, lr_eff, alpha, inv_b, scratch,
                                                  losses, stream);
}

}  // namespace

// Plain C entry for ctypes.  `cluster` 0: one cooperative launch of
// `blocks` blocks (from hpnn_batch_grid_blocks), the grid the team;
// `cluster` C in {1, 2, 4, 8, 16}: one cluster of C CTAs the team,
// `blocks` unused.  `table` and `host_table` hold the same n_layers
// `Layer` records (ops/batch_step.py::_layer_table), in device and in
// host memory (`table` may be null for a net of at most
// HPNN_PARAM_LAYERS layers, which reads only the host copy's values);
// every other pointer is a device pointer.  `order` may be
// null: step s then reads block first + s.  `scratch` holds 2*B*n_act +
// B values (of T; B floats, or 2*B bf16 values, for bf16), n_act the
// sum of every layer's rows.  dtype: 0 = float, 1 = double, 2 = bf16
// storage (then `losses` is float).  Ask hpnn_batch_grid_blocks or
// hpnn_fleet_max_clusters on the device first: they opt the kernels in
// to their shared memory.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int hpnn_batch_train(int dtype, int blocks, int cluster, int snn, int momentum,
                                int n_layers, const void* table, const void* host_table,
                                const void* X, const void* Tg, int B, const void* order,
                                int first, int S, double lr_eff, double alpha, double inv_b,
                                void* scratch, void* losses, int prefetch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  if (dtype == 0)
    return launch<float>(blocks, cluster, snn, momentum, n_layers, table, host_table, X, Tg,
                         B, ord, first, S, lr_eff, alpha, inv_b, scratch, losses, prefetch,
                         st);
  if (dtype == 1)
    return launch<double>(blocks, cluster, snn, momentum, n_layers, table, host_table, X, Tg,
                          B, ord, first, S, lr_eff, alpha, inv_b, scratch, losses, prefetch,
                          st);
  if (dtype == 2)
    return launch<bf16>(blocks, cluster, snn, momentum, n_layers, table, host_table, X, Tg,
                        B, ord, first, S, lr_eff, alpha, inv_b, scratch, losses, prefetch,
                        st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry of the fleet epoch (#6), every step prefetching each
// member's next block.  `cluster` 0: one cooperative launch of `blocks`
// blocks (from hpnn_batch_grid_blocks), the grid walking every member's
// tiles; `cluster` C in {1, 2, 4, 8, 16}: `members` clusters of C CTAs,
// cluster i on member i, `blocks` unused.  `table` and `host_table` are
// as for hpnn_batch_train, each record's w (and dw) the stacked (members,
// n, m) layer l, member stride m*n.  X and Tg are the stacked banks,
// (members, bank_rows, n_in) and (members, bank_rows, n_out), member
// stride bank_rows rows.  `orders` and `losses` are (members, S), member
// stride S; `scratch` holds members * (2*B*n_act + B) values, member
// stride one scratch.  Ask hpnn_batch_grid_blocks or
// hpnn_fleet_max_clusters on the device first, as for hpnn_batch_train.
// Returns the cudaError_t of the launch.
extern "C" int hpnn_fleet_train(int dtype, int blocks, int members, int cluster, int snn,
                                int momentum, int n_layers, const void* table,
                                const void* host_table, const void* X, const void* Tg,
                                long long bank_rows, int B, const void* orders, int S,
                                double lr_eff, double alpha, double inv_b, void* scratch,
                                void* losses, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(orders);
  if (dtype == 0)
    return launch_fleet<float>(blocks, members, cluster, snn, momentum, n_layers, table,
                               host_table, X, Tg, bank_rows, B, ord, S, lr_eff, alpha, inv_b,
                               scratch, losses, st);
  if (dtype == 1)
    return launch_fleet<double>(blocks, members, cluster, snn, momentum, n_layers, table,
                                host_table, X, Tg, bank_rows, B, ord, S, lr_eff, alpha, inv_b,
                                scratch, losses, st);
  if (dtype == 2)
    return launch_fleet<bf16>(blocks, members, cluster, snn, momentum, n_layers, table,
                              host_table, X, Tg, bank_rows, B, ord, S, lr_eff, alpha, inv_b,
                              scratch, losses, st);
  return (int)cudaErrorInvalidValue;
}

// The cooperative grid of one launch on the current device (of #2-#5,
// and of #6 on the grid): every block co-resident.  Sets the kernels'
// attributes (set_attributes).  Returns the cudaError_t of the query
// (cudaErrorNotSupported on a card without cooperative launches).
extern "C" int hpnn_batch_grid_blocks(int dtype, int* blocks) {
  *blocks = 0;
  if (dtype == 0) return grid_blocks<float>(blocks);
  if (dtype == 1) return grid_blocks<double>(blocks);
  if (dtype == 2) return grid_blocks<bf16>(blocks);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cluster` CTAs (1, 2, 4, 8 or 16) of the fleet
// kernel the current device holds at once, into *n.  Sets the kernels'
// attributes (set_attributes).  Returns the cudaError_t of the query.
extern "C" int hpnn_fleet_max_clusters(int dtype, int cluster, int* n) {
  *n = 0;
  if (dtype == 0) return max_clusters<float>(cluster, n);
  if (dtype == 1) return max_clusters<double>(cluster, n);
  if (dtype == 2) return max_clusters<bf16>(cluster, n);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of one block, in bytes (0 for another dtype).
extern "C" long long hpnn_batch_smem_bytes(int dtype) {
  if (dtype == 0) return (long long)smem_bytes<float>();
  if (dtype == 1) return (long long)smem_bytes<double>();
  if (dtype == 2) return (long long)smem_bytes<bf16>();
  return 0;
}

#ifdef HPNN_PHASE_CLOCKS
// The SM cycles rank 0's thread 0 spent in each phase (enum Phase), then
// in each part of its tiles' k-tiles (enum KPart), then the number of
// those k-tiles: N_PHASES + N_KPARTS + 1 values summed over the launches
// since the last reset; then zero them if `reset`.
extern "C" int hpnn_batch_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + N_PHASES, g_ktile_clocks, sizeof(g_ktile_clocks));
  if (err != cudaSuccess || !reset) return (int)err;
  static const unsigned long long zero[N_PHASES + N_KPARTS + 1] = {};
  err = cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(g_phase_clocks));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_ktile_clocks, zero, sizeof(g_ktile_clocks));
  return (int)err;
}
#endif

extern "C" const char* hpnn_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
