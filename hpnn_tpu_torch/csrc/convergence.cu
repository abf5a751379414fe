// Per-sample convergence loop of libhpnn's BP/BPM training, one CUDA
// launch per chunk of samples: one thread-block cluster whose CTAs own
// row blocks of every layer.
//
// Replaces: hpnn_tpu/ops/pallas_train.py, `_kernel` launched by
// `train_sample_fused` and scanned over a chunk by `train_epoch_fused`
// (the fused-round body of hpnn_tpu/train/driver.py).
//
// What it computes, for each sample s of the chunk in order (the
// weights carry from sample to sample; the momentum `dw` is zeroed at
// every sample start, the reference's ann_raz_momentum quirk):
//
//   forward; ep0 = err; p_trg = last index with t == 1.0 (else 0)
//   it = 0
//   do {
//     it++
//     ep = err
//     deltas from the current weights; BP or BPM update in place
//     forward; epr = err; dep = ep - epr
//     ok = first_argmax(out) == p_trg  (the first NaN wins if any)
//     if it == 1: first_ok = ok
//   } while (it <= max_iter && (dep > delta || !(ok && it > min_iter)))
//   final_ok = ok && it > min_iter
//
// ANN: every layer act(z) = 2/(1+exp(-z)) - 1, err = 0.5*sum((t-o)^2),
// output delta (t-o)*dact(o).  SNN: output o = exp(z-1)/(TINY + sum
// exp(z-1)) with no max shift, err = -sum(t*log(o+TINY))/n_out, output
// delta t-o.  Hidden deltas (W^T . delta) * dact(v), dact(y) =
// -0.5*(y*y-1).  BP: W += lr*(d (x) v).  BPM: m = dw + lr*(d (x) v);
// W += m; dw = alpha*m.
//
// Bound: operations.  Per iteration about 5 flops a weight (7 with
// momentum) plus 2 per weight of the layers above the first (W^T.d);
// the bytes a chunk must move (weights in and out once, the samples)
// are far less.  At 784-300-10 in float that is 0.0143 ms for 4 samples
// x 200 iterations at 67 TFLOP/s (chip_smoke.py's work_of/bound_ms).
//
// Why the single-block design sat at ~40 us an iteration.  One block of
// 1024 threads on one SM of 132 ran the whole loop, the weights in
// device memory held by the L2.  An iteration reads W three times and
// writes it once, ~3.8 MB at 784-300-10 float, all through one SM's
// share of L2 bandwidth (~95 GB/s), with the other SMs idle.
//
// The cluster design.  One launch is one cluster of C CTAs (16, the
// non-portable size; any C of 1-16 gives the same result), 640 threads
// each.  CTA r owns
// the contiguous rows [r*n/C, (r+1)*n/C) of every layer of n rows
// (owner(i) = ceil((i+1)*C/n) - 1).  Its rows of W (and of dw) live in
// its own shared memory for the whole chunk where they fit, copied in at
// chunk start and written back at chunk end; else the owner streams them
// from device memory with the same arithmetic.  Every CTA keeps a full
// copy of the input, the target, every layer's activations and deltas,
// so every CTA computes the loss, the argmax and the exit test on
// bitwise equal vectors in the same order: all CTAs leave the do-while
// on the same iteration by construction.
//
//   forward, layer l: the owned rows (a warp per row, lanes striding the
//     columns, fma, warp_sum), each row first updated in the same pass by
//     the warp that reads it (W read once an iteration; for l >= 1 only
//     after the first barrier, see below); a cluster barrier; then each
//     CTA pulls the other CTAs' rows of the new vector through
//     distributed shared memory (DSMEM).  SNN: every CTA then forms the
//     denominator from its full copy; the output layer keeps exp(z - 1)
//     as published and every reader divides (Cta::output).
//   loss: warp 0 takes the loss and the first argmax (a warp reduction
//     that keeps the serial scan's answer) while the other warps take
//     every output delta; one __syncthreads.
//   hidden deltas: the owned units, column j of W_{l+1} summed over
//     i = 0..n-1 in order, the rows of W_{l+1} that other CTAs own read
//     through DSMEM into a staging tile.  The top hidden layer's tile
//     (10 x 19 at 784-300-10) is staged in the same pass as the forward's
//     last gather, when every W is final.  Below the top hidden layer, a
//     barrier and a gather of the deltas.
//
// A row another CTA may read (of the activations, the deltas, W) is
// never rewritten before every CTA has passed a cluster barrier after
// reading it.  The activations are double-buffered by parity: a forward
// writes the other buffer, so a CTA can still read the previous vector
// of another while that one computes the next, and the update of W_l
// (l >= 1) can wait until after the first forward barrier, which every
// CTA passes only once it has finished reading other CTAs' rows of W_l
// for its deltas.  Cluster barriers per iteration: one per layer plus
// one per hidden layer below the top one (L + max(0, L - 2)): 2 at
// 784-300-10; __syncthreads: one per layer after its gather, one for
// the loss, one after the hidden deltas (4 at 784-300-10, 5 for SNN,
// whose denominator takes one).  Where the
// second activation buffer does not fit, the update runs before the
// forward behind one more cluster barrier.  A barrier at each sample
// start and one before exit (no CTA leaves while another reads it).
//
// What holds it back (PERF.md, from the phase clocks): the two cluster
// barriers, each a GPU-wide release fence on sm_90a, and the two gathers'
// DSMEM round trips behind a __syncthreads, then the update and forward
// pass (shared-memory bandwidth of one SM) and warp 0's loss chain.
// Pushing rows into the other CTAs (st.async with an mbarrier) instead
// of pulling them after a barrier would drop the fence.
//
// Shared memory of a CTA, in the order laid out: two scalar slots and
// two ints (the loss, the softmax denominator, ok, the target's index);
// the input, the target; 2 or 3 copies of the activations and deltas
// (acts by parity, deltas); the staging tile (up to the wrapper's
// STAGE values, none if it does not fit); the owned weight rows
// (ceil(n_l/C) x m_l per layer); the owned dw rows.  At 784-300-10, C = 16, that is 61 KB of
// weights in float BP, 122 KB with dw (float BPM) and 122 KB in double
// BP; double BPM keeps dw in device memory, read and written only by its
// owner.  The plan is the wrapper's (ops/convergence.py::plan); this
// file only lays it out.  The owned rows' home (shared or device memory)
// is a template argument of the kernel, so the compiler addresses them
// as shared memory, not through generic pointers.
//
// The vectors.  A net too wide for one CTA's copy of the input, the
// target, the activations and the deltas (n_in + n_out + 2 x the layer
// widths past 232448 bytes) keeps them in device memory: a scratch of
// the wrapper's of C private copies laid out by rank, each the same
// layout as the shared one with both activation buffers.  Nothing else
// changes: every CTA still holds a full copy and computes the loss, the
// argmax and the exit test on it in the same order, and a gather reads
// the owner's rows from the owner's copy (through the L2, `ld.global.cg`)
// after the same cluster barrier, whose release and acquire order device
// memory at cluster scope as they order shared memory, so the rule of
// the next paragraph holds as it is.  Shared memory then holds the
// scalars, the staging tile and, where they fit, the owned rows of W and
// dw.  Where the vectors live is a third template argument of the kernel
// (VRES); every sum is the same, so a net that fits gives the same bits
// either way.
//
// The layers.  A net of any depth: the wrapper packs one 40-byte record
// a layer (`Layer`: W's address, its dw's offset in the dw scratch, the
// widths, the layer's offsets) into a table it keeps in device memory
// and on the host, once for a set of weights and a cluster size
// (ops/convergence.py::_layer_table).  A net of at most
// HPNN_PARAM_LAYERS layers takes its per-layer values, filled from the
// host copy, by value in the kernel parameters (`ParamLayers`), read
// through the constant cache as they were before the table existed; a
// deeper one reads them from the table in device memory through the
// read-only path (`TableLayers`).  A kernel reading every net from the
// table was 8-9% slower an iteration at 784-300-10 on an H100 (PERF.md),
// hence the two; which one a launch takes is a template argument of the
// kernel, and every sum is the same.
//
// Numerics: plain FP32 (or FP64) arithmetic with FMA, expf/logf in
// float and exp/log in double, no fast math and no tensor cores — the
// counterpart of the Pallas kernel's precision=HIGHEST pin.  Every sum
// keeps the single-block kernel's order and expression form, whatever
// C is, so the result is bitwise that kernel's and the same across
// plans.  Built for float (the production type) and double.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

#define HPNN_PARAM_LAYERS 16  // layers whose values ride in the kernel parameters
// 20 warps: one per owned row at 784-300-10 over 16 CTAs; measured
// faster than 16 or 32 warps at 8 and 16 CTAs (PERF.md)
#define HPNN_THREADS 640
#define HPNN_MAX_CLUSTER 16
#define HPNN_MAX_SMEM 232448

namespace {

// One layer of the launch's table (ops/convergence.py::LAYER).
struct Layer {
  unsigned long long w;      // W_l, (n, m) row-major, in device memory
  long long dwo;             // offset of layer l's dw in the dw scratch
  unsigned long long inv_n;  // ceil(2^40 / n)
  int m, n;                  // columns and rows of W_l
  int off;                   // offset of layer l in the acts/deltas arrays
  int wblk;                  // offset of layer l's owned rows in a weight block
};
static_assert(sizeof(Layer) == 40, "ops/convergence.py::LAYER packs 40 bytes");

// The per-layer values of a net of at most HPNN_PARAM_LAYERS layers, by
// value in the kernel parameters.
template <typename T>
struct ParamLayers {
  int dims[HPNN_PARAM_LAYERS + 1];  // dims[0] = n_in, dims[l+1] = rows of layer l
  int off_[HPNN_PARAM_LAYERS];      // offset of layer l in the acts/deltas arrays
  int wblk_[HPNN_PARAM_LAYERS];     // offset of layer l's owned rows in a weight block
  T* w_[HPNN_PARAM_LAYERS];
  T* dw_[HPNN_PARAM_LAYERS];
  unsigned long long inv_n_[HPNN_PARAM_LAYERS];  // ceil(2^40 / rows of layer l)

  __device__ int m(int l) const { return dims[l]; }
  __device__ int n(int l) const { return dims[l + 1]; }
  __device__ int off(int l) const { return off_[l]; }
  __device__ int wblk(int l) const { return wblk_[l]; }
  __device__ T* w(int l) const { return w_[l]; }
  __device__ T* dw(int l) const { return dw_[l]; }
  __device__ unsigned long long inv_n(int l) const { return inv_n_[l]; }
};

// The per-layer values of a net of any depth: the table in device
// memory, read through the read-only path.
template <typename T>
struct TableLayers {
  const Layer* lay;  // n_layers records
  T* dws;            // the dw scratch, or null

  __device__ int m(int l) const { return __ldg(&lay[l].m); }
  __device__ int n(int l) const { return __ldg(&lay[l].n); }
  __device__ int off(int l) const { return __ldg(&lay[l].off); }
  __device__ int wblk(int l) const { return __ldg(&lay[l].wblk); }
  __device__ T* w(int l) const { return reinterpret_cast<T*>(__ldg(&lay[l].w)); }
  __device__ T* dw(int l) const { return dws + __ldg(&lay[l].dwo); }
  __device__ unsigned long long inv_n(int l) const { return __ldg(&lay[l].inv_n); }
};

template <typename T, class Ly>
struct Net {
  int n_layers;
  Ly ly;                          // the per-layer values
  unsigned long long inv_c;       // ceil(2^40 / C)
  int n_act;                      // sum of the layer widths
  int stage;                      // values in the staging tile (0: none)
  int wtot;                       // values in one weight block
  bool dbuf, w_res, dw_res;
  T* vecs;                        // the vectors' C copies in device memory, or null
  long long vcopy;                // values in one copy
};

// x / d for 0 <= x with x * d < 2^40, given inv = ceil(2^40 / d): the
// error of inv is below x / 2^40 < 1 / d, so the floor is exact.  Every
// thread divides by layer widths and C in every phase, and a 32-bit
// division is some twenty instructions.
__host__ __device__ __forceinline__ unsigned long long inv40(int d) {
  return ((1ull << 40) + (unsigned long long)d - 1) / (unsigned long long)d;
}

__device__ __forceinline__ int div40(int x, unsigned long long inv) {
  return (int)(((unsigned long long)x * inv) >> 40);
}

// r * n / C (r <= C <= 16 keeps r*n*C below 2^40 for any n < 2^31)
__device__ __forceinline__ int row_start(int r, int n, unsigned long long inv_c) {
  return div40(r * n, inv_c);
}

// the q with row_start(q) <= i < row_start(q + 1): ceil((i+1)*C/n) - 1,
// which is ((i+1)*C - 1) / n; exact while (i+1)*C*n <= n*n*C <= 2^40, so
// for layers of at most 2^18 rows (ops/convergence.py::MAX_ROWS; the plan
// refuses wider ones)
__device__ __forceinline__ int owner(int i, int C, unsigned long long inv_n) {
  return div40((i + 1) * C - 1, inv_n);
}

// Phases of an iteration, timed with clock64() by thread 0 of rank 0
// in a build with -DHPNN_PHASE_CLOCKS (ops/convergence.py::phase_clocks);
// without it HPNN_PHASE is nothing.
enum Phase {
  P_DHID,    // hidden deltas: the staged W tiles, their gathers
  P_UPD,     // the update of the owned rows, apart (one activation buffer)
  P_FWD,     // a layer's owned rows of the forward (with their update)
  P_CSYNC,   // the forward's cluster barrier
  P_GATHER,  // pulling the other CTAs' rows of a vector
  P_SOFT,    // the softmax denominator
  P_ERR,     // loss, argmax and exit test, beside the output deltas
  P_REST,    // sample start and end
  P_FWD_OUT,     // P_FWD of the output layer
  P_CSYNC_OUT,   // P_CSYNC of the output layer
  P_GATHER_OUT,  // P_GATHER of the output layer
  P_RING_WAIT,   // the grid build: waiting on a ring slot's fill
  N_PHASES
};
#ifdef HPNN_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[N_PHASES];
__device__ int g_clock_cta;  // the grid build's CTA whose thread 0 marks
#define HPNN_PHASE(c, k) (c).mark(k)
#else
#define HPNN_PHASE(c, k) ((void)0)
#endif

// The cluster barrier: release and acquire at cluster scope, so each CTA
// sees the shared (and device) memory the others wrote before it.  On
// sm_90a the release is a GPU-wide fence (MEMBAR.ALL.GPU) and the
// acquire an L1 invalidation, as in cooperative_groups' cluster.sync().
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T act(T z) {
  return T(2) / (T(1) + dev_exp(-z)) - T(1);
}

template <typename T>
__device__ __forceinline__ T dact(T y) {
  return T(-0.5) * (y * y - T(1));
}

// What one CTA sees: the net, its rank, the cluster and its buffers.
// WRES / DWRES: the owned rows of W / dw live in shared memory, so the
// compiler addresses them as shared (not through generic pointers).
// VRES: the input, the target, the activations and the deltas (xs, ts,
// acts, ds) live in shared memory, else in this CTA's copy in device
// memory.
template <typename T_, bool WRES, bool DWRES, bool VRES, class Ly>
struct Cta {
  using T = T_;
  const Net<T, Ly>& net;
  cg::cluster_group cluster;
  int rank, C;
  T* xs;
  T* ts;
  T* acts;   // the buffer of parity 0; parity 1 follows when net.dbuf
  T* ds;
  T* stage;
  T* wsm;    // owned weight rows, when resident
  T* dwsm;   // owned dw rows, when resident
  T* s_err;
  T* s_scalar;
  int* s_ok;
  int* s_ptrg;
  unsigned long long* clk;  // N_PHASES sums and the last mark (phase-clock build)

  __device__ int r0(int l) const { return row_start(rank, net.ly.n(l), net.inv_c); }
  __device__ int r1(int l) const { return row_start(rank + 1, net.ly.n(l), net.inv_c); }
  __device__ T* wown(int l) const {
    return WRES ? wsm + net.ly.wblk(l) : net.ly.w(l) + (size_t)r0(l) * net.ly.m(l);
  }
  __device__ T* mown(int l) const {
    return DWRES ? dwsm + net.ly.wblk(l) : net.ly.dw(l) + (size_t)r0(l) * net.ly.m(l);
  }
  __device__ T* buf(int parity) const { return acts + (net.dbuf ? parity : 0) * net.n_act; }
  __device__ T* out_deltas() const { return ds + net.ly.off(net.n_layers - 1); }

  // Output i of the activations `a`.  SNN: the layer holds exp(z - 1) as
  // the owners published it, divided here by the forward's denominator.
  __device__ T output(const T* a, int i, bool snn) const {
    const T o = a[net.ly.off(net.n_layers - 1) + i];
    return snn ? o / *s_scalar : o;
  }

  __device__ void mark(int k) const {
    if (threadIdx.x == 0 && rank == 0) {
      const unsigned long long t = clock64();
      clk[k] += t - clk[N_PHASES];
      clk[N_PHASES] = t;
    }
  }

  // W_l[i][j], whoever owns row i.
  __device__ T weight(int l, int i, int j) const {
    const int n = net.ly.n(l), m = net.ly.m(l);
    if (!WRES) return __ldcg(net.ly.w(l) + (size_t)i * m + j);
    const int q = owner(i, C, net.ly.inv_n(l));
    T* p = wsm + net.ly.wblk(l) + (size_t)(i - row_start(q, n, net.inv_c)) * m + j;
    return q == rank ? *p : *cluster.map_shared_rank(p, q);
  }

  // v[i] of CTA q's copy of the vectors: through distributed shared
  // memory, or from q's copy in device memory through the L2 (the L1 of
  // this SM may hold a line of it from before the last barrier)
  __device__ T peer(T* v, int q) const {
    if (VRES) return *cluster.map_shared_rank(v, q);
    return __ldcg(v + (long long)(q - rank) * net.vcopy);
  }

  // v[i] for every i outside the owned rows of layer l, from its owner.
  __device__ void gather(T* v, int l) const {
    const int n = net.ly.n(l), a = r0(l), b = r1(l);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if (i < a || i >= b) v[i] = peer(v + i, owner(i, C, net.ly.inv_n(l)));
  }

  // Whether the deltas of the top hidden layer take their W_{L-1} tile
  // in one piece, staged at the end of the forward (prefetch_tile).
  __device__ bool tile_prefetched() const {
    const int L = net.n_layers;
    if (L < 2 || net.stage == 0) return false;
    const int nc = r1(L - 2) - r0(L - 2);
    return nc <= (int)blockDim.x && nc <= net.stage && nc * net.ly.n(L - 1) <= net.stage;
  }

  // stage[i * nc + t] = W_{L-1}[i][c0 + t], the tile of tile_prefetched.
  __device__ void prefetch_tile() const {
    const int L = net.n_layers, n = net.ly.n(L - 1);
    const int c0 = r0(L - 2), nc = r1(L - 2) - c0;
    for (int k = threadIdx.x; k < n * nc; k += blockDim.x)
      stage[k] = weight(L - 1, k / nc, c0 + k % nc);
  }
};

// BP or BPM update of the owned rows of layer l, from the activations
// `a` and the deltas: the single-buffer plan's update (the forward fuses
// it where the activations are double-buffered).
template <class K, typename T = typename K::T>
__device__ void update_layer(const K& c, int l, bool momentum, T lr, T alpha, const T* a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int m = c.net.ly.m(l);
  const int r0 = c.r0(l), r1 = c.r1(l);
  const T* __restrict__ vin = (l == 0) ? c.xs : a + c.net.ly.off(l - 1);
  const T* d = c.ds + c.net.ly.off(l);
  T* W = c.wown(l);
  T* M = momentum ? c.mown(l) : nullptr;
  for (int row = r0 + warp; row < r1; row += nwarps) {
    const T di = d[row];
    T* __restrict__ wr = W + (size_t)(row - r0) * m;
    if (momentum) {
      T* __restrict__ mr = M + (size_t)(row - r0) * m;
#pragma unroll 4
      for (int j = lane; j < m; j += 32) {
        const T mm = mr[j] + lr * (di * vin[j]);
        wr[j] = wr[j] + mm;
        mr[j] = alpha * mm;
      }
    } else {
#pragma unroll 4
      for (int j = lane; j < m; j += 32) wr[j] = wr[j] + lr * (di * vin[j]);
    }
  }
}

// Activations of every layer into `an`.  `ao` (the previous parity)
// non-null: each owned row of W_l is first updated from `ao` by the warp
// that then reads it for the forward, in the same pass (for l >= 1 after
// the first cluster barrier; layer 0's W is never read by another CTA).
template <class K, typename T = typename K::T>
__device__ void forward(const K& c, bool snn, T* an, const T* ao, bool momentum, T lr,
                        T alpha) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T tiny = T(1e-14);
  const int L = c.net.n_layers;
  for (int l = 0; l < L; ++l) {
    const int n = c.net.ly.n(l), m = c.net.ly.m(l);
    const T* __restrict__ vin = (l == 0) ? c.xs : an + c.net.ly.off(l - 1);
    const T* __restrict__ vold = (l == 0 || ao == nullptr) ? vin : ao + c.net.ly.off(l - 1);
    const T* d = c.ds + c.net.ly.off(l);
    T* vout = an + c.net.ly.off(l);
    const bool soft = snn && l == L - 1;
    const int r0 = c.r0(l), r1 = c.r1(l);
    T* W = c.wown(l);
    T* M = momentum ? c.mown(l) : nullptr;
    for (int row = r0 + warp; row < r1; row += nwarps) {
      T* __restrict__ wr = W + (size_t)(row - r0) * m;
      T acc = T(0);
      if (ao == nullptr) {
#pragma unroll 4
        for (int j = lane; j < m; j += 32) acc = fma(wr[j], vin[j], acc);
      } else if (!momentum) {
        const T di = d[row];
#pragma unroll 4
        for (int j = lane; j < m; j += 32) {
          const T w = wr[j] + lr * (di * vold[j]);
          wr[j] = w;
          acc = fma(w, vin[j], acc);
        }
      } else {
        const T di = d[row];
        T* __restrict__ mr = M + (size_t)(row - r0) * m;
#pragma unroll 4
        for (int j = lane; j < m; j += 32) {
          const T mm = mr[j] + lr * (di * vold[j]);
          const T w = wr[j] + mm;
          wr[j] = w;
          mr[j] = alpha * mm;
          acc = fma(w, vin[j], acc);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) vout[row] = soft ? out_exp(acc - T(1)) : act(acc);
    }
    HPNN_PHASE(c, l == L - 1 ? P_FWD_OUT : P_FWD);
    cluster_barrier();
    HPNN_PHASE(c, l == L - 1 ? P_CSYNC_OUT : P_CSYNC);
    c.gather(vout, l);
    // every W is final until the next update: stage the next deltas' tile
    // in the same pass as the last gather
    if (l == L - 1 && c.tile_prefetched()) c.prefetch_tile();
    __syncthreads();
    HPNN_PHASE(c, l == L - 1 ? P_GATHER_OUT : P_GATHER);
    if (soft) {
      // the denominator only: the owned exponentials stay as published,
      // since another CTA may still be gathering them (Cta::output divides)
      if (warp == 0) {
        T e = T(0);
        for (int i = lane; i < n; i += 32) e += vout[i];
        e = warp_sum(e);
        if (lane == 0) *c.s_scalar = tiny + e;
      }
      __syncthreads();
      HPNN_PHASE(c, P_SOFT);
    }
  }
}

// The loss of the output layer and whether its first argmax is p_trg,
// computed by warp 0 while the other warps compute every output delta;
// one __syncthreads, then every thread of every CTA holds the same values.
template <class K, typename T = typename K::T>
__device__ T loss_and_output_deltas(const K& c, bool snn, const T* a, int p_trg, int* ok) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = c.net.n_layers, n = c.net.ly.n(L - 1);
  const T tiny = T(1e-14);
  if (warp == 0) {
    T acc = T(0);
    // each step one fused multiply-add, spelled out: the compiler
    // contracted `acc += x * y` so in the cluster build, and would not
    // in every instantiation
    for (int i = lane; i < n; i += 32) {
      const T o = c.output(a, i, snn);
      if (snn) {
        acc = fma(c.ts[i], dev_log(o + tiny), acc);
      } else {
        const T d = c.ts[i] - o;
        acc = fma(d, d, acc);
      }
    }
    acc = warp_sum(acc);
    // first index of the max; the first NaN wins if any (jnp.argmax):
    // each lane scans its indices in order, then the lanes merge, the
    // lower index winning ties
    int bi = -1;
    T bv = T(0);
    bool bnan = false;
    for (int i = lane; i < n && !bnan; i += 32) {
      const T v = c.output(a, i, snn);
      if (isnan(v) || bi < 0 || v > bv) {
        bi = i;
        bv = v;
        bnan = isnan(v);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int oi = __shfl_down_sync(0xffffffffu, bi, o);
      const T ov = __shfl_down_sync(0xffffffffu, bv, o);
      const bool onan = __shfl_down_sync(0xffffffffu, (int)bnan, o) != 0;
      bool take;
      if (oi < 0 || lane + o > 31) take = false;
      else if (bi < 0) take = true;
      else if (bnan != onan) take = onan;
      else if (bnan) take = oi < bi;
      else take = ov > bv || (ov == bv && oi < bi);
      if (take) {
        bi = oi;
        bv = ov;
        bnan = onan;
      }
    }
    if (lane == 0) {
      *c.s_err = snn ? -acc / T(n) : T(0.5) * acc;
      *c.s_ok = (bi == p_trg) ? 1 : 0;
    }
  } else {
    T* d = c.out_deltas();
    for (int i = threadIdx.x - 32; i < n; i += blockDim.x - 32) {
      const T o = c.output(a, i, snn);
      d[i] = snn ? c.ts[i] - o : (c.ts[i] - o) * dact(o);
    }
  }
  __syncthreads();
  *ok = *c.s_ok;
  return *c.s_err;  // rewritten only after the __syncthreads of the next phases
}

// The hidden deltas of the owned units of each hidden layer, from the
// current weights, the activations `a` and the output deltas.
template <class K, typename T = typename K::T>
__device__ void hidden_deltas(const K& c, const T* a) {
  const int L = c.net.n_layers;
  for (int l = L - 2; l >= 0; --l) {
    const int n = c.net.ly.n(l + 1), m = c.net.ly.n(l);
    const T* dn = c.ds + c.net.ly.off(l + 1);
    const T* al = a + c.net.ly.off(l);
    T* d = c.ds + c.net.ly.off(l);
    const int c0 = c.r0(l), nc = c.r1(l) - c0;
    if (l == L - 2 && c.tile_prefetched()) {
      if ((int)threadIdx.x < nc) {
        T acc = T(0);
        for (int i = 0; i < n; ++i) acc = fma(dn[i], c.stage[i * nc + threadIdx.x], acc);
        d[c0 + threadIdx.x] = acc * dact(al[c0 + threadIdx.x]);
      }
    } else if (c.net.stage == 0) {
      for (int j = c0 + threadIdx.x; j < c0 + nc; j += blockDim.x) {
        T acc = T(0);
        for (int i = 0; i < n; ++i) acc = fma(dn[i], c.weight(l + 1, i, j), acc);
        d[j] = acc * dact(al[j]);
      }
    } else {
      // columns in groups of ng, rows in tiles of ti: the tile of
      // W_{l+1} is loaded by every thread, each column summed in order
      for (int g0 = 0; g0 < nc; g0 += min((int)blockDim.x, c.net.stage)) {
        const int ng = min(min((int)blockDim.x, c.net.stage), nc - g0);
        const int ti = c.net.stage / ng;
        T acc = T(0);
        for (int i0 = 0; i0 < n; i0 += ti) {
          const int ni = min(ti, n - i0);
          for (int k = threadIdx.x; k < ni * ng; k += blockDim.x)
            c.stage[k] = c.weight(l + 1, i0 + k / ng, c0 + g0 + k % ng);
          __syncthreads();
          if ((int)threadIdx.x < ng)
            for (int ii = 0; ii < ni; ++ii)
              acc = fma(dn[i0 + ii], c.stage[ii * ng + threadIdx.x], acc);
          __syncthreads();
        }
        if ((int)threadIdx.x < ng) {
          const int j = c0 + g0 + threadIdx.x;
          d[j] = acc * dact(al[j]);
        }
      }
    }
    if (l > 0) {  // the layer below needs every delta of this one
      cluster_barrier();
      c.gather(d, l);
    }
    __syncthreads();
  }
  HPNN_PHASE(c, P_DHID);
}

template <typename T, bool WRES, bool DWRES, bool VRES, class Ly>
__global__ void __launch_bounds__(HPNN_THREADS, 1)
convergence_cluster(Net<T, Ly> net, bool snn, bool momentum, const T* X, const T* Tg,
                    int S, T alpha, T delta, int min_iter, int max_iter, T lr,
                    T* ep0_out, int* niter_out, T* dep_out, int* first_out,
                    int* final_out, T* out_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int L = net.n_layers;
  const int n_in = net.ly.m(0), n_out = net.ly.n(L - 1);
  T* scal = reinterpret_cast<T*>(smem_raw);
  int* ints = reinterpret_cast<int*>(scal + 2);
  T* xs = VRES ? reinterpret_cast<T*>(ints + 2)
               : net.vecs + (long long)cluster.block_rank() * net.vcopy;
  T* ts = xs + n_in;
  T* acts = ts + n_out;
  T* ds = acts + (net.dbuf ? 2 : 1) * net.n_act;
  T* stage = VRES ? ds + net.n_act : reinterpret_cast<T*>(ints + 2);
  T* wsm = stage + net.stage;
  T* dwsm = wsm + (WRES ? net.wtot : 0);
#ifdef HPNN_PHASE_CLOCKS
  __shared__ unsigned long long s_clk[N_PHASES + 1];
  if (threadIdx.x == 0) {
    for (int k = 0; k < N_PHASES; ++k) s_clk[k] = 0;
    s_clk[N_PHASES] = clock64();
  }
#else
  unsigned long long* s_clk = nullptr;
#endif
  const Cta<T, WRES, DWRES, VRES, Ly> c{net, cluster, (int)cluster.block_rank(),
                                  (int)cluster.num_blocks(), xs, ts, acts, ds, stage, wsm,
                                  dwsm, scal, scal + 1, ints, ints + 1, s_clk};

  if (WRES) {
    for (int l = 0; l < L; ++l) {
      const size_t nm = (size_t)(c.r1(l) - c.r0(l)) * net.ly.m(l);
      const T* src = net.ly.w(l) + (size_t)c.r0(l) * net.ly.m(l);
      for (size_t k = threadIdx.x; k < nm; k += blockDim.x) wsm[net.ly.wblk(l) + k] = src[k];
    }
  }
  int parity = 0;
  for (int s = 0; s < S; ++s) {
    for (int i = threadIdx.x; i < n_in; i += blockDim.x)
      xs[i] = X[(size_t)s * n_in + i];
    for (int i = threadIdx.x; i < n_out; i += blockDim.x)
      ts[i] = Tg[(size_t)s * n_out + i];
    if (momentum) {
      for (int l = 0; l < L; ++l) {
        T* M = c.mown(l);
        const size_t nm = (size_t)(c.r1(l) - c.r0(l)) * net.ly.m(l);
        for (size_t k = threadIdx.x; k < nm; k += blockDim.x) M[k] = T(0);
      }
    }
    // every CTA has started (s = 0) and no CTA still reads the last
    // sample's vectors of another
    cluster_barrier();
    HPNN_PHASE(c, P_REST);
    if (threadIdx.x == 0) {
      int p = 0;
      for (int i = 0; i < n_out; ++i)
        if (ts[i] == T(1)) p = i;
      *c.s_ptrg = p;
    }
    forward(c, snn, c.buf(parity), (const T*)nullptr, momentum, lr, alpha);
    const int p_trg = *c.s_ptrg;

    // the do-while, its test moved to the top: pass 0 takes ep0, pass k
    // tests iteration k, then runs iteration k + 1
    int it = 0, ok = 0, first_ok = 0;
    T ep0 = T(0), ep = T(0), dep = T(0);
    while (true) {
      const T* a = c.buf(parity);
      int ok_now;
      const T e = loss_and_output_deltas(c, snn, a, p_trg, &ok_now);
      HPNN_PHASE(c, P_ERR);
      if (it == 0) {
        ep0 = e;
        ep = e;
      } else {
        dep = ep - e;
        ep = e;  // the next iteration's Ep: same acts, same reduction
        ok = ok_now;
        if (it == 1) first_ok = ok;
        const bool ok_eff = ok && it > min_iter;
        if (!(it <= max_iter && (dep > delta || !ok_eff))) break;
      }
      ++it;
      hidden_deltas(c, a);
      if (net.dbuf) {
        parity ^= 1;
        forward(c, snn, c.buf(parity), a, momentum, lr, alpha);
      } else {
        cluster_barrier();  // no CTA still reads rows of W this CTA updates
        HPNN_PHASE(c, P_CSYNC);
        for (int l = 0; l < L; ++l) update_layer(c, l, momentum, lr, alpha, a);
        __syncthreads();
        HPNN_PHASE(c, P_UPD);
        forward(c, snn, c.buf(parity), (const T*)nullptr, momentum, lr, alpha);
      }
    }
    if (c.rank == 0) {
      if (threadIdx.x == 0) {
        ep0_out[s] = ep0;
        niter_out[s] = it;
        dep_out[s] = dep;
        first_out[s] = first_ok;
        final_out[s] = (ok && it > min_iter) ? 1 : 0;
      }
      for (int i = threadIdx.x; i < n_out; i += blockDim.x)
        out_out[(size_t)s * n_out + i] = c.output(c.buf(parity), i, snn);
    }
    __syncthreads();  // xs/ts are rewritten by the next sample
    HPNN_PHASE(c, P_REST);
  }
  if (WRES) {
    for (int l = 0; l < L; ++l) {
      const size_t nm = (size_t)(c.r1(l) - c.r0(l)) * net.ly.m(l);
      T* dst = net.ly.w(l) + (size_t)c.r0(l) * net.ly.m(l);
      for (size_t k = threadIdx.x; k < nm; k += blockDim.x) dst[k] = wsm[net.ly.wblk(l) + k];
    }
  }
  cluster_barrier();  // no CTA leaves while another may read its vectors
#ifdef HPNN_PHASE_CLOCKS
  if (threadIdx.x == 0 && c.rank == 0)
    for (int k = 0; k < N_PHASES; ++k) g_phase_clocks[k] += s_clk[k];
#endif
}

// ------------------------------------------------------------- the grid build
//
// One CTA an SM of a cooperative grid of G CTAs (every CTA the card holds
// at once) for a net whose owned rows of W overflow a cluster's shared
// memory.  CTA r owns the rows [r*n/G, (r+1)*n/G) of every layer, as in
// the cluster build; the vectors live in device memory as ONE published
// copy (each value written by its owner only), read by whoever needs
// them after the grid barrier that follows their writing; W and dw stay
// in their homes in device memory.
//
// Bound: bytes.  W streams from device memory every iteration, read and
// written once: 190 MB an iteration at 784-[30000]-10 float32 (and at
// 784-[15000]-10 float64), 56.9 us at 3.35 TB/s.  One cluster pulled it
// through 16 SMs at ~0.47 TB/s; the grid pulls it through every SM.
//
// W through a ring.  Each warp with rows has a ring of HPNN_GRID_DEPTH
// slots in shared memory and keeps its next rows in flight: its lane 0
// copies a row (or a segment of a long row: a multiple of 32 columns, so
// lane k still takes the columns k, k+32, ... in order) with a 1-D bulk
// copy (cp.async.bulk, completing on the slot's mbarrier), widened to the
// 16-byte boundaries the copy needs, while the warp runs the update and
// the forward of the rows before it from shared memory, and writes the
// updated row back with coalesced stores.  BPM copies the dw segment
// beside W; the input vector of the layer (and its old copy) is staged in
// shared memory once a layer where it fits, else copied beside W, segment
// by segment.  A CTA's only row of a layer (a wide output layer's few
// rows over 132 CTAs) goes another way, lone_row: the warps that share
// no scheduler with warp 0 fill it into a ring (cp.async, updated in
// place and written back) while warp 0 sums it.
//
// The rules of the cluster build hold as they are: the activations are
// double-buffered by parity, a row another CTA may read (of the
// activations, the hidden deltas, W) is rewritten only after every CTA
// has passed a grid barrier after reading it, and every CTA takes the
// loss, the argmax and the exit test from the same published values in
// the same order.  The output deltas, which every CTA computes, stay
// private to each CTA.  No CTA asks who owns a row: a reader reads the
// published vector itself, so owner()'s 40-bit division (exact for C <=
// 16) is never used; row_start's is exact for G <= 1024 at 2^18 rows.
//
// Every sum keeps the cluster build's order and expression form, so the
// grid gives the same bits for any G, and the cluster build's.

#define HPNN_GRID_THREADS 512        // 16 warps
#define HPNN_GRID_WARPS (HPNN_GRID_THREADS / 32)
#define HPNN_GRID_DEPTH 3            // slots of a warp's ring
#define HPNN_GRID_SMEM 229376        // dynamic shared memory of a grid CTA (224 KB)
#define HPNN_GRID_OUT_SMEM 16384     // output deltas up to this many bytes stay in shared memory
#define HPNN_GRID_LONG 6             // slots of a lone row's ring (lone_row)
#define HPNN_GRID_HEAD (32 + 8 * HPNN_GRID_WARPS * HPNN_GRID_DEPTH)  // scalars and mbarriers

// Values from one parity's published activations to the other's: the
// widths' sum rounded up to 4, so both buffers start 16-byte aligned (a
// lone row's fill reads them 16 bytes at a time where they are).
__host__ __device__ __forceinline__ long long grid_abuf(long long n_act) {
  return (n_act + 3) / 4 * 4;
}

// The grid barrier: thread 0 of each CTA adds to a word in device memory
// with release semantics at gpu scope and spins with acquire loads until
// bit 31 flips (CTA 0 adds 2^31 - (G - 1), the others 1, so a barrier
// adds 2^31 and the word's low bits start each barrier at 0: start_grid
// zeroes it before each launch); __syncthreads on both sides.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old, now;
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(add) : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(bar) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// Orders this thread's generic accesses (of device and shared memory)
// before later async-proxy copies (cp.async.bulk) that touch the same
// bytes: every writer of what a copy will read or overwrite runs it
// before the barrier that precedes the copy, and the copying lane again.
__device__ __forceinline__ void proxy_fence() { asm volatile("fence.proxy.async;" ::: "memory"); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(1u) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes from device memory at `src` into shared memory at `dst` (both
// 16-byte aligned, bytes a multiple of 16), completing on mbarrier `b`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// The 16-byte-aligned window around v[0, len): its first byte, its bytes
// and where v[0] sits in it, in values.  A tensor's allocation is
// 16-byte aligned at both ends (the caching allocator's blocks are), so
// the window never leaves it.
struct Window {
  const unsigned char* at;
  unsigned bytes;
  int lead;
};

template <typename T>
__device__ __forceinline__ Window window(const T* v, int len) {
  const unsigned long long p = reinterpret_cast<unsigned long long>(v);
  const unsigned long long a = p & ~15ull;
  const unsigned long long b = (p + (unsigned long long)len * sizeof(T) + 15) & ~15ull;
  return {reinterpret_cast<const unsigned char*>(a), (unsigned)(b - a),
          (int)((p - a) / sizeof(T))};
}

// One segment of a row in shared memory, its lanes striding the columns
// as the cluster build's rows do: the forward's sum (seg_forward), with
// the BP (seg_bp) or BPM (seg_bpm) update first, the updated values
// stored to W's (and dw's) home.
template <typename T>
__device__ __forceinline__ void seg_forward(const T* __restrict__ w, const T* __restrict__ vi,
                                            int len, T& acc) {
  // a lane loads its next 32 / sizeof(T) columns of both before it sums
  // them, so one round of shared-memory latency covers them all (a lone
  // row's warp waited a round a column)
  constexpr int B = 32 / sizeof(T);
  int j = threadIdx.x & 31;
  for (; j + 32 * (B - 1) < len; j += 32 * B) {
    T a[B], b[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      a[u] = w[j + 32 * u];
      b[u] = vi[j + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < B; ++u) acc = fma(a[u], b[u], acc);
  }
  for (; j < len; j += 32) acc = fma(w[j], vi[j], acc);
}

template <typename T>
__device__ __forceinline__ void seg_bp(const T* __restrict__ w, const T* __restrict__ vo,
                                       const T* __restrict__ vi, T* __restrict__ wg, int len,
                                       T di, T lr, T& acc) {
#pragma unroll 4
  for (int j = threadIdx.x & 31; j < len; j += 32) {
    const T wv = w[j] + lr * (di * vo[j]);
    wg[j] = wv;
    acc = fma(wv, vi[j], acc);
  }
}

template <typename T>
__device__ __forceinline__ void seg_bpm(const T* __restrict__ w, const T* __restrict__ mw,
                                        const T* __restrict__ vo, const T* __restrict__ vi,
                                        T* __restrict__ wg, T* __restrict__ mg, int len, T di,
                                        T lr, T alpha, T& acc) {
#pragma unroll 4
  for (int j = threadIdx.x & 31; j < len; j += 32) {
    const T mm = mw[j] + lr * (di * vo[j]);
    const T wv = w[j] + mm;
    wg[j] = wv;
    mg[j] = alpha * mm;
    acc = fma(wv, vi[j], acc);
  }
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// A warp's place in its ring: the slot of its next copy and that slot's
// phase parity; advanced once per copy, carried across layers and samples.
struct Ring {
  int slot;
  unsigned parity;
  __device__ void next() {
    if (++slot == HPNN_GRID_DEPTH) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// What one CTA of the grid sees.  The loss (loss_and_output_deltas) reads
// it through the same members and accessors as a cluster CTA.
template <typename T_, class Ly>
struct GridCta {
  using T = T_;
  const Net<T, Ly>& net;
  int rank, C;
  const T* xs;              // the sample's input, in device memory
  const T* ts;              // the sample's target, in device memory
  T* acts;                  // the published activations: parity 0, then parity 1
  long long abuf;           // values from one parity's activations to the other's
  T* ds;                    // the published deltas of the hidden layers
  T* dout;                  // this CTA's output deltas (shared or device memory)
  unsigned* bar;            // the grid barrier's word
  unsigned char* work;      // the staged vectors and the rings, or the deltas' tile
  int work_bytes;
  unsigned long long* mbar; // HPNN_GRID_DEPTH mbarriers a warp
  T* s_err;
  T* s_scalar;
  int* s_ok;
  int* s_ptrg;
  unsigned long long* clk;

  __device__ int r0(int l) const { return row_start(rank, net.ly.n(l), net.inv_c); }
  __device__ int r1(int l) const { return row_start(rank + 1, net.ly.n(l), net.inv_c); }
  __device__ T* buf(int parity) const { return acts + parity * abuf; }
  __device__ T* out_deltas() const { return dout; }

  // output i of the published activations `a` (SNN: divided by the
  // forward's denominator), from the L2
  __device__ T output(const T* a, int i, bool snn) const {
    const T o = __ldcg(a + net.ly.off(net.n_layers - 1) + i);
    return snn ? o / *s_scalar : o;
  }

  __device__ void mark(int k) const {
#ifdef HPNN_PHASE_CLOCKS
    if (threadIdx.x == 0 && rank == g_clock_cta) {
      const unsigned long long t = clock64();
      clk[k] += t - clk[N_PHASES];
      clk[N_PHASES] = t;
    }
#endif
  }
};

// The layer's rows one warp runs from its ring: the copies (issue) and the
// update and forward of a segment (run).  Every value is a pure function
// of the layer and the CTA, so the lanes of a warp agree.
template <class K, typename T = typename K::T>
struct RowStream {
  const K& c;
  int l, m, r0, rows, warp, A, nseg, seg, slot, part;
  bool upd, momentum, staged;
  const T* vin;   // the layer's input vector, in device memory
  const T* vold;  // its previous parity (the update's), in device memory
  const T* svin;  // the staged copies in shared memory (staged)
  const T* svold;
  unsigned char* ring;
  unsigned long long* bars;  // the mbarriers of this stream's slots

  __device__ int items() const { return warp < A ? (rows - warp + A - 1) / A * nseg : 0; }
  __device__ int row_of(int i) const { return r0 + warp + (i / nseg) * A; }
  __device__ unsigned char* slot_at(int k) const {
    return ring + (size_t)(warp * HPNN_GRID_DEPTH + k) * slot;
  }

  // where part p of item i starts in device memory: W's row segment,
  // dw's (momentum), then the vectors' segments where they are not staged
  __device__ const T* part_src(int i, int p) const {
    const int row = row_of(i), j0 = (i % nseg) * seg;
    if (p == 0) return c.net.ly.w(l) + (size_t)row * m + j0;
    if (upd && momentum && --p == 0) return c.net.ly.dw(l) + (size_t)row * m + j0;
    if (upd && vold != vin && --p == 0) return vold + j0;
    return vin + j0;
  }
  __device__ int parts() const {
    return 1 + (upd && momentum) + (staged ? 0 : 1 + (upd && vold != vin));
  }

  // lane 0: copy item i (a row's segment) into slot k
  __device__ void issue(int i, int k) const {
    const int len = min(seg, m - (i % nseg) * seg);
    unsigned long long* b = &bars[k];
    unsigned char* dst = slot_at(k);
    unsigned bytes = 0;
    for (int p = 0; p < parts(); ++p) bytes += window(part_src(i, p), len).bytes;
    mbar_expect(b, bytes);
    for (int p = 0; p < parts(); ++p) {
      const Window win = window(part_src(i, p), len);
      bulk_copy(dst + p * part, win.at, win.bytes, b);
    }
  }

  // part p of item i in slot k
  __device__ const T* in_slot(int i, int k, int p) const {
    const int len = min(seg, m - (i % nseg) * seg);
    return reinterpret_cast<const T*>(slot_at(k) + p * part) + window(part_src(i, p), len).lead;
  }

  // the warp: update and forward of item i from slot k; `acc` carries a
  // row's lane sums across its segments
  __device__ void run(int i, int k, T lr, T alpha, T& acc) const {
    const int row = row_of(i), j0 = (i % nseg) * seg, len = min(seg, m - j0);
    const T* w = in_slot(i, k, 0);
    const int pv = 1 + (upd && momentum);  // the first vector's part
    const bool two = upd && vold != vin;
    const T* vi = staged ? svin + j0 : in_slot(i, k, pv + two);
    const T* vo = staged ? svold + j0 : two ? in_slot(i, k, pv) : vi;
    if (!upd) {
      seg_forward(w, vi, len, acc);
      return;
    }
    const int L = c.net.n_layers;
    const T di = l == L - 1 ? c.dout[row] : __ldcg(c.ds + c.net.ly.off(l) + row);
    T* wg = c.net.ly.w(l) + (size_t)row * m + j0;
    if (momentum)
      seg_bpm(w, in_slot(i, k, 1), vo, vi, wg, c.net.ly.dw(l) + (size_t)row * m + j0, len, di,
              lr, alpha, acc);
    else
      seg_bp(w, vo, vi, wg, len, di, lr, acc);
  }
};

// V values of T, stored to device memory as one 16-byte store when V *
// sizeof(T) is 16 (p then aligned to it).
template <int V, typename T>
struct Pack {
  T v[V];
};

template <int V, typename T>
__device__ __forceinline__ void stv(T* p, const Pack<V, T>& r) {
  if constexpr (V * sizeof(T) == 16) {
    using U = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    *reinterpret_cast<U*>(p) = *reinterpret_cast<const U*>(&r);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = r.v[e];
  }
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// wait until at most n (0..3) of this thread's latest copy groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// The fill of one segment of a lone row by lone_row's fillers: W's
// segment, updated by BP (MODE 1) or BPM (MODE 2) and written back, or
// as it is (MODE 0), into the slot's `sw`; the input vector's into `sx`
// where it is not staged.  The 16-byte groups are first copied into the
// slot with cp.async (copy: many groups in flight, no registers), then
// updated there in place (update); the values past the last whole group,
// or all of them where the arrays are not 16-byte aligned, go through
// registers (scalar).  One instantiation a mode, each with the cluster
// build's expressions (a product that two branches shared was not
// contracted into the add as there, and the sums parted).
template <typename T>
struct Fill {
  static constexpr int V = 16 / sizeof(T);
  T* W;            // the segment of W's row, of dw's (BPM), in device memory
  T* M;
  const T* vold;   // of the old and the new input vector, in device memory
  const T* vin;
  const T* svold;  // the old input vector staged in shared memory, or null
  T* sw;           // the slot's parts: W, dw (BPM), the old vector and the
  T* sm;           // input vector (each null where not copied)
  T* so;
  T* sx;
  T di, lr, alpha;
  int t, nt;       // this thread among the nt that fill

  __device__ int first() const { return t * V; }
  __device__ int step() const { return nt * V; }

  __device__ void copy(int body) const {
    for (int j = first(); j < body; j += step()) {
      cp16(sw + j, W + j);
      if (sm) cp16(sm + j, M + j);
      if (so) cp16(so + j, vold + j);
      if (sx) cp16(sx + j, vin + j);
    }
    cp_commit();
  }

  template <int MODE>
  __device__ void update(int body) const {
    if constexpr (MODE > 0) {
      for (int j = first(); j < body; j += step()) {
        Pack<V, T> w = *reinterpret_cast<const Pack<V, T>*>(sw + j);
        const T* op = svold ? svold + j : so ? so + j : sx + j;
        Pack<V, T> o = *reinterpret_cast<const Pack<V, T>*>(op);
        if constexpr (MODE == 2) {
          Pack<V, T> mm = *reinterpret_cast<const Pack<V, T>*>(sm + j);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const T m1 = mm.v[e] + lr * (di * o.v[e]);
            w.v[e] = w.v[e] + m1;
            mm.v[e] = alpha * m1;
          }
          stv<V>(M + j, mm);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) w.v[e] = w.v[e] + lr * (di * o.v[e]);
        }
        stv<V>(W + j, w);
        *reinterpret_cast<Pack<V, T>*>(sw + j) = w;
      }
    }
  }

  template <int MODE>
  __device__ void scalar(int from, int len) const {
    for (int j = from + t; j < len; j += nt) {
      if (sx) sx[j] = __ldcg(vin + j);
      T w = __ldcg(W + j);
      if constexpr (MODE > 0) {
        const T o = svold ? svold[j] : __ldcg(vold + j);
        if constexpr (MODE == 2) {
          const T m1 = __ldcg(M + j) + lr * (di * o);
          w = w + m1;
          M[j] = alpha * m1;
        } else {
          w = w + lr * (di * o);
        }
        W[j] = w;
      }
      sw[j] = w;
    }
  }
};

// A lone row (the CTA's only row of the layer, as in a wide net's output
// layer): the warps that share no scheduler with warp 0 (warp % 4 != 0)
// fill its segments into a ring of HPNN_GRID_LONG slots in shared memory
// (Fill, the copies of up to 3 segments ahead in flight), named barriers
// 1.. marking a slot full and the next HPNN_GRID_LONG empty again, while
// warp 0 sums the filled ones in the cluster build's order, its
// scheduler to itself.  One warp alone was bound by its own stores, and
// a warp 0 that shared its scheduler with fillers by its issue slots
// (PERF.md).
template <int MODE, class K, typename T = typename K::T>
__device__ void lone_row(const K& c, int l, int row, const T* vin, const T* vold,
                         const T* svin, const T* svold, bool staged, T lr, T alpha,
                         unsigned char* ring, int ring_bytes, T& out) {
  constexpr int V = 16 / sizeof(T), AHEAD = 3;
  const int warp = threadIdx.x >> 5, L = c.net.n_layers, m = c.net.ly.m(l);
  const int nwarps = blockDim.x >> 5;
  const bool filler = (warp & 3) != 0;
  const int nt = 32 * (nwarps - (nwarps + 3) / 4);   // the fillers' threads
  const int t = 32 * (warp - 1 - warp / 4) + (threadIdx.x & 31);
  const int nb = nt + 32;                             // a named barrier's threads
  T* W = c.net.ly.w(l) + (size_t)row * m;
  T* M = MODE == 2 ? c.net.ly.dw(l) + (size_t)row * m : nullptr;
  const bool old = MODE > 0 && !staged && vold != vin;  // the old vector copied apart
  const int parts = 1 + (MODE == 2) + old + !staged;
  const int seg = ring_bytes / (HPNN_GRID_LONG * parts) / (int)sizeof(T) / 32 * 32;
  const int nseg = (m + seg - 1) / seg;
  const T di = MODE == 0 ? T(0) : l == L - 1 ? c.dout[row] : __ldcg(c.ds + c.net.ly.off(l) + row);
  // the copies where every array they read is 16-byte aligned (a
  // segment starts a multiple of 32 values on)
  const bool vec = ((reinterpret_cast<unsigned long long>(W) |
                     reinterpret_cast<unsigned long long>(M) |
                     (staged ? 0ull : reinterpret_cast<unsigned long long>(vold) |
                                      reinterpret_cast<unsigned long long>(vin))) &
                    15) == 0;
  auto fill = [&](int s) {
    T* sw = reinterpret_cast<T*>(ring) + (size_t)(s % HPNN_GRID_LONG) * parts * seg;
    T* p = sw + seg;
    T* sm = MODE == 2 ? p : nullptr;
    p += MODE == 2 ? seg : 0;
    T* so = old ? p : nullptr;
    p += old ? seg : 0;
    const int j0 = s * seg;
    return Fill<T>{W + j0, M ? M + j0 : nullptr, vold + j0, vin + j0,
                   staged ? svold + j0 : nullptr, sw, sm, so, staged ? nullptr : p, di, lr,
                   alpha, t, nt};
  };
  auto len_of = [&](int s) { return min(seg, m - s * seg); };
  auto body_of = [&](int s) { return vec ? len_of(s) / V * V : 0; };
  T acc = T(0);
  if (filler)
    for (int s = 0; s < min(AHEAD, nseg); ++s) fill(s).copy(body_of(s));
  for (int s = 0; s < nseg; ++s) {
    const int k = s % HPNN_GRID_LONG;
    if (filler) {
      const int u = s + AHEAD;
      if (u < nseg) {
        if (u >= HPNN_GRID_LONG) named_sync(1 + HPNN_GRID_LONG + u % HPNN_GRID_LONG, nb);
        fill(u).copy(body_of(u));
      }
      cp_wait(min(AHEAD, nseg - 1 - s));
      const Fill<T> f = fill(s);
      f.template update<MODE>(body_of(s));
      f.template scalar<MODE>(body_of(s), len_of(s));
      named_arrive(1 + k, nb);
    } else if (warp == 0) {
      HPNN_PHASE(c, l == L - 1 ? P_FWD_OUT : P_FWD);
      named_sync(1 + k, nb);
      HPNN_PHASE(c, P_RING_WAIT);
      const Fill<T> f = fill(s);
      seg_forward(f.sw, staged ? svin + s * seg : f.sx, len_of(s), acc);
      if (s + HPNN_GRID_LONG < nseg) named_arrive(1 + HPNN_GRID_LONG + k, nb);
    }
  }
  if (warp == 0) out = warp_sum(acc);
}

// Activations of every layer into the published `an`; `ao` (the previous
// parity) non-null: each owned row of W_l is first updated from `ao` in
// the same pass (for l >= 1 after the first grid barrier, as in the
// cluster build).  `ring` is this warp's place in its ring.
template <class K, typename T = typename K::T>
__device__ void grid_forward(const K& c, bool snn, T* an, const T* ao, bool momentum, T lr,
                             T alpha, Ring& ring) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T tiny = T(1e-14);
  const int L = c.net.n_layers;
  const bool upd = ao != nullptr;
  for (int l = 0; l < L; ++l) {
    const int n = c.net.ly.n(l), m = c.net.ly.m(l);
    const int r0 = c.r0(l), rows = c.r1(l) - r0;
    const T* vin = l == 0 ? c.xs : an + c.net.ly.off(l - 1);
    const T* vold = (l == 0 || !upd) ? vin : ao + c.net.ly.off(l - 1);
    T* vout = an + c.net.ly.off(l);
    const bool soft = snn && l == L - 1;
    const int fwd = l == L - 1 ? P_FWD_OUT : P_FWD;
    if (rows > 0) {
      // the input vector (and its old copy) staged once where it fits
      // half the work area, else copied beside W segment by segment
      const int nvec = (upd && vold != vin) ? 2 : 1;
      const bool staged = (long long)nvec * m * (long long)sizeof(T) <= c.work_bytes / 2;
      T* sv = reinterpret_cast<T*>(c.work);
      T* svold = sv + (nvec == 2 ? m : 0);
      if (staged) {
        for (int k = threadIdx.x; k < m; k += blockDim.x) {
          sv[k] = __ldcg(vin + k);
          if (nvec == 2) svold[k] = __ldcg(vold + k);
        }
      }
      proxy_fence();
      __syncthreads();
      HPNN_PHASE(c, l == L - 1 ? P_GATHER_OUT : P_GATHER);
      const int used = staged ? (nvec * m * (int)sizeof(T) + 15) / 16 * 16 : 0;
      if (rows == 1 && nwarps > 1) {
        T acc = T(0);
        unsigned char* ring0 = c.work + used;
        const int nbytes = c.work_bytes - used;
        if (!upd)
          lone_row<0>(c, l, r0, vin, vold, sv, svold, staged, lr, alpha, ring0, nbytes, acc);
        else if (!momentum)
          lone_row<1>(c, l, r0, vin, vold, sv, svold, staged, lr, alpha, ring0, nbytes, acc);
        else
          lone_row<2>(c, l, r0, vin, vold, sv, svold, staged, lr, alpha, ring0, nbytes, acc);
        if (threadIdx.x == 0) vout[r0] = soft ? out_exp(acc - T(1)) : act(acc);
      } else {
        const int A = min(nwarps, rows);
        const int parts = 1 + (upd && momentum) + (staged ? 0 : nvec);
        const int slot = (c.work_bytes - used) / (A * HPNN_GRID_DEPTH) / 16 * 16;
        const int part = slot / parts / 16 * 16;
        const int segmax = (part - 32) / (int)sizeof(T) / 32 * 32;
        const int nseg = (m + segmax - 1) / segmax;
        const int seg = nseg == 1 ? m : ((m + nseg - 1) / nseg + 31) / 32 * 32;
        const RowStream<K> rs{c, l, m, r0, rows, warp, A, nseg, seg, slot, part, upd,
                              momentum, staged, vin, vold, sv, svold, c.work + used,
                              c.mbar + warp * HPNN_GRID_DEPTH};
        const int total = rs.items();
        if (total > 0 && lane == 0) {
          // the last writers of the rows and vectors (and of this work
          // area) fenced and passed a barrier since
          proxy_fence();
          Ring r = ring;
          for (int i = 0; i < min(total, HPNN_GRID_DEPTH); ++i, r.next()) rs.issue(i, r.slot);
        }
        T acc = T(0);
        for (int i = 0; i < total; ++i) {
          const int k = ring.slot;
          HPNN_PHASE(c, fwd);
          mbar_wait(&rs.bars[k], ring.parity);
          HPNN_PHASE(c, P_RING_WAIT);
          rs.run(i, k, lr, alpha, acc);
          if ((i + 1) % nseg == 0) {
            acc = warp_sum(acc);
            if (lane == 0) vout[rs.row_of(i)] = soft ? out_exp(acc - T(1)) : act(acc);
            acc = T(0);
          }
          __syncwarp();
          if (lane == 0 && i + HPNN_GRID_DEPTH < total) {
            // the warp's reads of the slot before the copy that refills it
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            rs.issue(i + HPNN_GRID_DEPTH, k);
          }
          ring.next();
        }
      }
      proxy_fence();  // the rows written back, the activations: read by copies later
    }
    HPNN_PHASE(c, fwd);
    grid_barrier(c.bar);
    HPNN_PHASE(c, l == L - 1 ? P_CSYNC_OUT : P_CSYNC);
    if (soft) {
      // the denominator from the published exponentials, which stay as
      // they are (GridCta::output divides)
      if (warp == 0) {
        T e = T(0);
        for (int i = lane; i < n; i += 32) e += __ldcg(vout + i);
        e = warp_sum(e);
        if (lane == 0) *c.s_scalar = tiny + e;
      }
      __syncthreads();
      HPNN_PHASE(c, P_SOFT);
    }
  }
}

// The hidden deltas of the owned units of each hidden layer, from the
// current weights, the published activations `a` and the output deltas:
// column j of W_{l+1} summed over i = 0..n-1 in order by one thread, the
// deltas below (and W's columns, in groups of up to a block) staged tile
// by tile in the work area.  A grid barrier after each layer but the
// lowest: the layer below reads every delta of this one.
template <class K, typename T = typename K::T>
__device__ void grid_hidden_deltas(const K& c, const T* a) {
  const int L = c.net.n_layers;
  T* tile = reinterpret_cast<T*>(c.work);
  const int cap = c.work_bytes / (int)sizeof(T);
  for (int l = L - 2; l >= 0; --l) {
    const int n = c.net.ly.n(l + 1), m = c.net.ly.n(l);
    const T* W = c.net.ly.w(l + 1);
    const bool top = l == L - 2;
    const T* dn = top ? c.dout : c.ds + c.net.ly.off(l + 1);
    const T* al = a + c.net.ly.off(l);
    T* d = c.ds + c.net.ly.off(l);
    const int c0 = c.r0(l), nc = c.r1(l) - c0;
    for (int g0 = 0; g0 < nc; g0 += blockDim.x) {
      const int ng = min((int)blockDim.x, nc - g0);
      const int ti = min(n, cap / (ng + 1));  // rows a tile: ti deltas, ti x ng weights
      T acc = T(0);
      for (int i0 = 0; i0 < n; i0 += ti) {
        const int ni = min(ti, n - i0);
        for (int k = threadIdx.x; k < ni; k += blockDim.x)
          tile[k] = top ? dn[i0 + k] : __ldcg(dn + i0 + k);
        for (int k = threadIdx.x; k < ni * ng; k += blockDim.x)
          tile[ti + k] = __ldcg(W + (size_t)(i0 + k / ng) * m + c0 + g0 + k % ng);
        __syncthreads();
        if ((int)threadIdx.x < ng)
          for (int ii = 0; ii < ni; ++ii)
            acc = fma(tile[ii], tile[ti + ii * ng + threadIdx.x], acc);
        __syncthreads();
      }
      if ((int)threadIdx.x < ng) {
        const int j = c0 + g0 + threadIdx.x;
        d[j] = acc * dact(__ldcg(al + j));
      }
    }
    if (l > 0) grid_barrier(c.bar);
  }
  proxy_fence();  // the tile's area: the forward's copies write it next
  __syncthreads();
  HPNN_PHASE(c, P_DHID);
}

template <typename T, class Ly>
__global__ void __launch_bounds__(HPNN_GRID_THREADS, 1)
convergence_grid(Net<T, Ly> net, unsigned* bar, T* ds, T* dout_dev, bool snn, bool momentum,
                 const T* X, const T* Tg, int S, T alpha, T delta, int min_iter, int max_iter,
                 T lr, T* ep0_out, int* niter_out, T* dep_out, int* first_out, int* final_out,
                 T* out_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = net.n_layers;
  const int n_in = net.ly.m(0), n_out = net.ly.n(L - 1);
  T* scal = reinterpret_cast<T*>(smem_raw);
  int* ints = reinterpret_cast<int*>(smem_raw + 16);
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem_raw + 32);
  unsigned char* p = smem_raw + HPNN_GRID_HEAD;
  const bool out_sm = (long long)n_out * sizeof(T) <= HPNN_GRID_OUT_SMEM;
  T* dout = out_sm ? reinterpret_cast<T*>(p) : dout_dev + (size_t)blockIdx.x * n_out;
  if (out_sm) p += ((long long)n_out * sizeof(T) + 15) / 16 * 16;
  const int work_bytes = HPNN_GRID_SMEM - (int)(p - smem_raw);
#ifdef HPNN_PHASE_CLOCKS
  __shared__ unsigned long long s_clk[N_PHASES + 1];
  if (threadIdx.x == 0) {
    for (int k = 0; k < N_PHASES; ++k) s_clk[k] = 0;
    s_clk[N_PHASES] = clock64();
  }
#else
  unsigned long long* s_clk = nullptr;
#endif
  if (threadIdx.x < HPNN_GRID_WARPS * HPNN_GRID_DEPTH) mbar_init(&mbar[threadIdx.x]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  int parity = 0;
  Ring ring{0, 0u};
  for (int s = 0; s < S; ++s) {
    const GridCta<T, Ly> c{net, (int)blockIdx.x, (int)gridDim.x, X + (size_t)s * n_in,
                           Tg + (size_t)s * n_out, net.vecs, grid_abuf(net.n_act), ds, dout, bar,
                           p, work_bytes, mbar, scal, scal + 1, ints, ints + 1, s_clk};
    if (momentum) {
      for (int l = 0; l < L; ++l) {
        T* M = net.ly.dw(l) + (size_t)c.r0(l) * net.ly.m(l);
        const size_t nm = (size_t)(c.r1(l) - c.r0(l)) * net.ly.m(l);
        for (size_t k = threadIdx.x; k < nm; k += blockDim.x) M[k] = T(0);
      }
      proxy_fence();
    }
    // every CTA has started (s = 0) and no CTA still reads the last
    // sample's vectors
    grid_barrier(bar);
    HPNN_PHASE(c, P_REST);
    if (threadIdx.x == 0) {
      int pt = 0;
      for (int i = 0; i < n_out; ++i)
        if (c.ts[i] == T(1)) pt = i;
      *c.s_ptrg = pt;
    }
    grid_forward(c, snn, c.buf(parity), (const T*)nullptr, momentum, lr, alpha, ring);
    const int p_trg = *c.s_ptrg;

    // the do-while, its test moved to the top, as in convergence_cluster
    int it = 0, ok = 0, first_ok = 0;
    T ep0 = T(0), ep = T(0), dep = T(0);
    while (true) {
      const T* a = c.buf(parity);
      int ok_now;
      const T e = loss_and_output_deltas(c, snn, a, p_trg, &ok_now);
      HPNN_PHASE(c, P_ERR);
      if (it == 0) {
        ep0 = e;
        ep = e;
      } else {
        dep = ep - e;
        ep = e;
        ok = ok_now;
        if (it == 1) first_ok = ok;
        const bool ok_eff = ok && it > min_iter;
        if (!(it <= max_iter && (dep > delta || !ok_eff))) break;
      }
      ++it;
      grid_hidden_deltas(c, a);
      parity ^= 1;
      grid_forward(c, snn, c.buf(parity), a, momentum, lr, alpha, ring);
    }
    if (c.rank == 0) {
      if (threadIdx.x == 0) {
        ep0_out[s] = ep0;
        niter_out[s] = it;
        dep_out[s] = dep;
        first_out[s] = first_ok;
        final_out[s] = (ok && it > min_iter) ? 1 : 0;
      }
      for (int i = threadIdx.x; i < n_out; i += blockDim.x)
        out_out[(size_t)s * n_out + i] = c.output(c.buf(parity), i, snn);
    }
    __syncthreads();
    HPNN_PHASE(c, P_REST);
  }
#ifdef HPNN_PHASE_CLOCKS
  if (threadIdx.x == 0 && (int)blockIdx.x == g_clock_cta)
    for (int k = 0; k < N_PHASES; ++k) g_phase_clocks[k] += s_clk[k];
#endif
}

// The arguments of one launch beside the net.
template <typename T>
struct Args {
  bool snn, momentum;
  const T* X;
  const T* Tg;
  int S;
  T alpha, delta;
  int min_iter, max_iter;
  T lr;
  T* ep0;
  int* n_iter;
  T* dep;
  int* first_ok;
  int* final_ok;
  T* out;
};

// The kernel for the homes of the owned rows (W, dw) and of the vectors.
template <typename T, bool VRES, class Ly>
auto kernel_for(const Net<T, Ly>& net) {
  return net.w_res ? (net.dw_res ? convergence_cluster<T, true, true, VRES, Ly>
                                 : convergence_cluster<T, true, false, VRES, Ly>)
                   : (net.dw_res ? convergence_cluster<T, false, true, VRES, Ly>
                                 : convergence_cluster<T, false, false, VRES, Ly>);
}

// One cluster launch of the kernel on `net`: the owned rows' home
// (shared or device memory), the vectors' and the layers' flavour pick
// the kernel.
template <typename T, class Ly>
int start(const Net<T, Ly>& net, const Args<T>& a, int n_in, int n_out, int cluster,
          cudaStream_t stream) {
  // the layout of convergence_cluster; ops/convergence.py::plan mirrors it
  const bool vres = net.vecs == nullptr;
  const size_t vec =
      vres ? (size_t)n_in + n_out + (net.dbuf ? 3 : 2) * (size_t)net.n_act : 0;
  const size_t smem =
      2 * sizeof(T) + 2 * sizeof(int) +
      sizeof(T) * (vec + net.stage + (net.w_res ? net.wtot : 0) +
                   (net.dw_res ? net.wtot : 0));
  if (smem > HPNN_MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = vres ? kernel_for<T, true>(net) : kernel_for<T, false>(net);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(HPNN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&n_clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n_clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kern, net, a.snn, a.momentum, a.X, a.Tg, a.S, a.alpha,
                           a.delta, a.min_iter, a.max_iter, a.lr, a.ep0, a.n_iter, a.dep,
                           a.first_ok, a.final_ok, a.out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The net's scalars, from the host copy of the layer table `rec`.
template <typename T, class Ly>
void fill(Net<T, Ly>* net, const Layer* rec, int n_layers, int momentum, int cluster,
          int dbuf, int stage, int w_res, int dw_res, void* vectors) {
  int wtot = 0;
  for (int l = 0; l < n_layers; ++l) wtot += ((rec[l].n + cluster - 1) / cluster) * rec[l].m;
  net->n_layers = n_layers;
  net->inv_c = inv40(cluster);
  net->n_act = rec[n_layers - 1].off + rec[n_layers - 1].n;
  net->stage = stage;
  net->wtot = wtot;
  net->dbuf = dbuf != 0;
  net->w_res = w_res != 0;
  net->dw_res = momentum != 0 && dw_res != 0;
  net->vecs = static_cast<T*>(vectors);
  net->vcopy = (long long)rec[0].m + rec[n_layers - 1].n + 3LL * net->n_act;
}

// The per-layer values of a net of at most HPNN_PARAM_LAYERS layers, from
// the host copy of the layer table `rec`; `dws` the dw scratch or null.
template <typename T>
void set_params(ParamLayers<T>* ly, const Layer* rec, int n_layers, T* dws) {
  ly->dims[0] = rec[0].m;
  for (int l = 0; l < n_layers; ++l) {
    ly->dims[l + 1] = rec[l].n;
    ly->off_[l] = rec[l].off;
    ly->wblk_[l] = rec[l].wblk;
    ly->inv_n_[l] = rec[l].inv_n;
    ly->w_[l] = reinterpret_cast<T*>(rec[l].w);
    ly->dw_[l] = dws ? dws + rec[l].dwo : nullptr;
  }
}

template <typename T>
int launch(int momentum, int n_layers, const void* table, const void* host_table, void* dw,
           void* vectors, const Args<T>& a, int cluster, int dbuf, int stage, int w_res,
           int dw_res, cudaStream_t stream) {
  if (n_layers < 1 || (table == nullptr && n_layers > HPNN_PARAM_LAYERS) ||
      host_table == nullptr || cluster < 1 ||
      cluster > HPNN_MAX_CLUSTER || stage < 0 || (momentum && !dw_res && dw == nullptr) ||
      (vectors != nullptr && !dbuf))
    return (int)cudaErrorInvalidValue;
  const Layer* rec = static_cast<const Layer*>(host_table);
  const int n_in = rec[0].m, n_out = rec[n_layers - 1].n;
  T* dws = momentum && !dw_res ? static_cast<T*>(dw) : nullptr;
  if (n_layers > HPNN_PARAM_LAYERS) {
    Net<T, TableLayers<T>> net;
    fill(&net, rec, n_layers, momentum, cluster, dbuf, stage, w_res, dw_res, vectors);
    net.ly.lay = static_cast<const Layer*>(table);
    net.ly.dws = dws;
    return start(net, a, n_in, n_out, cluster, stream);
  }
  Net<T, ParamLayers<T>> net;
  fill(&net, rec, n_layers, momentum, cluster, dbuf, stage, w_res, dw_res, vectors);
  set_params(&net.ly, rec, n_layers, dws);
  return start(net, a, n_in, n_out, cluster, stream);
}


// One cooperative launch of the grid build on `net` (its vectors the
// published activations), G = `ctas` CTAs; the barrier word zeroed first
// on the stream.  A grid the card cannot hold at once is refused by the
// launch (cudaErrorCooperativeLaunchTooLarge), never run in part.
template <typename T, class Ly>
int start_grid(const Net<T, Ly>& net, unsigned* bar, T* ds, T* dout, const Args<T>& a,
               int ctas, cudaStream_t stream) {
  auto kern = convergence_grid<T, Ly>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, HPNN_GRID_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(bar, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(HPNN_GRID_THREADS, 1, 1);
  cfg.dynamicSmemBytes = HPNN_GRID_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, net, bar, ds, dout, a.snn, a.momentum, a.X, a.Tg, a.S,
                           a.alpha, a.delta, a.min_iter, a.max_iter, a.lr, a.ep0, a.n_iter,
                           a.dep, a.first_ok, a.final_ok, a.out);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The grid build's launch: `scratch` is laid out as the barrier word (16
// bytes), the published activations (2 x grid_abuf(n_act)), the hidden
// deltas (n_act), then, where the output deltas overflow HPNN_GRID_OUT_SMEM
// bytes, each CTA's output deltas (ctas x n_out); `dw` every layer's dw
// (momentum).
template <typename T>
int launch_grid(int momentum, int n_layers, const void* table, const void* host_table,
                void* dw, void* scratch, const Args<T>& a, int ctas, cudaStream_t stream) {
  if (n_layers < 1 || (table == nullptr && n_layers > HPNN_PARAM_LAYERS) ||
      host_table == nullptr || scratch == nullptr || ctas < 1 || (momentum && dw == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layer* rec = static_cast<const Layer*>(host_table);
  T* dws = momentum ? static_cast<T*>(dw) : nullptr;
  unsigned* bar = static_cast<unsigned*>(scratch);
  T* acts = reinterpret_cast<T*>(static_cast<unsigned char*>(scratch) + 16);
  const long long n_act = (long long)rec[n_layers - 1].off + rec[n_layers - 1].n;
  T* ds = acts + 2 * grid_abuf(n_act);
  T* dout = ds + n_act;
  if (n_layers > HPNN_PARAM_LAYERS) {
    Net<T, TableLayers<T>> net;
    fill(&net, rec, n_layers, momentum, ctas, 1, 0, 0, 0, acts);
    net.ly.lay = static_cast<const Layer*>(table);
    net.ly.dws = dws;
    return start_grid(net, bar, ds, dout, a, ctas, stream);
  }
  Net<T, ParamLayers<T>> net;
  fill(&net, rec, n_layers, momentum, ctas, 1, 0, 0, 0, acts);
  set_params(&net.ly, rec, n_layers, dws);
  return start_grid(net, bar, ds, dout, a, ctas, stream);
}

// CTAs of the grid build the current device holds at once: its SMs times
// the blocks an SM holds of either layers' flavour (one, by the launch
// bounds and the shared memory).  Sets the kernels' shared-memory size.
template <typename T>
int grid_ctas(int* ctas) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0, per_sm_table = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(convergence_grid<T, ParamLayers<T>>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, HPNN_GRID_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(convergence_grid<T, TableLayers<T>>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, HPNN_GRID_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, convergence_grid<T, ParamLayers<T>>, HPNN_GRID_THREADS, HPNN_GRID_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_table, convergence_grid<T, TableLayers<T>>, HPNN_GRID_THREADS, HPNN_GRID_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  *ctas = sms * (per_sm_table < per_sm ? per_sm_table : per_sm);
  return (int)cudaSuccess;
}

}  // namespace

// Plain C entry for ctypes.  `table` and `host_table` hold the same
// n_layers `Layer` records (ops/convergence.py::_layer_table), in device
// and in host memory (`table` may be null for a net of at most
// HPNN_PARAM_LAYERS layers, which reads only the host copy's values, by
// value in the kernel parameters); `dw` is the dw scratch (every layer's, at the
// records' offsets), null unless momentum keeps dw in device memory;
// `vectors` is the vectors' scratch (C copies of n_in + n_out + 3 x the
// layer widths values, by rank; the activations double-buffered), null
// to keep them in shared memory.  Every other pointer is a device pointer.  dtype: 0 = float, 1 =
// double.  The plan: the cluster size (1-16), whether the activations
// are double-buffered, the staging tile's values, whether the owned
// rows of W and of dw live in shared memory.  Returns the cudaError_t
// of the launch (0 = launched); a cluster the card cannot place is
// cudaErrorLaunchOutOfResources.
extern "C" int hpnn_convergence_train_epoch(
    int dtype, int snn, int momentum, int n_layers, const void* table,
    const void* host_table, void* dw, void* vectors, const void* X, const void* Tg, int S,
    double alpha, double delta, int min_iter, int max_iter, double lr,
    void* ep0, void* n_iter, void* dep, void* first_ok, void* final_ok,
    void* out, int cluster, int dbuf, int stage, int w_res, int dw_res,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Args<float> a{snn != 0, momentum != 0, static_cast<const float*>(X),
                        static_cast<const float*>(Tg), S, (float)alpha, (float)delta,
                        min_iter, max_iter, (float)lr, static_cast<float*>(ep0),
                        static_cast<int*>(n_iter), static_cast<float*>(dep),
                        static_cast<int*>(first_ok), static_cast<int*>(final_ok),
                        static_cast<float*>(out)};
    return launch<float>(momentum, n_layers, table, host_table, dw, vectors, a, cluster, dbuf,
                         stage, w_res, dw_res, st);
  }
  if (dtype == 1) {
    const Args<double> a{snn != 0, momentum != 0, static_cast<const double*>(X),
                         static_cast<const double*>(Tg), S, alpha, delta, min_iter,
                         max_iter, lr, static_cast<double*>(ep0), static_cast<int*>(n_iter),
                         static_cast<double*>(dep), static_cast<int*>(first_ok),
                         static_cast<int*>(final_ok), static_cast<double*>(out)};
    return launch<double>(momentum, n_layers, table, host_table, dw, vectors, a, cluster, dbuf,
                          stage, w_res, dw_res, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The grid build (convergence_grid): one cooperative launch of `ctas` CTAs
// (at most hpnn_convergence_grid_ctas's); `scratch` as launch_grid lays it
// out, `dw` every layer's dw at the records' offsets (momentum, else
// null); the other arguments as hpnn_convergence_train_epoch's.  Returns
// the cudaError_t of the launch; a grid the card cannot hold at once is
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int hpnn_convergence_train_epoch_grid(
    int dtype, int snn, int momentum, int n_layers, const void* table,
    const void* host_table, void* dw, void* scratch, const void* X, const void* Tg, int S,
    double alpha, double delta, int min_iter, int max_iter, double lr,
    void* ep0, void* n_iter, void* dep, void* first_ok, void* final_ok,
    void* out, int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Args<float> a{snn != 0, momentum != 0, static_cast<const float*>(X),
                        static_cast<const float*>(Tg), S, (float)alpha, (float)delta,
                        min_iter, max_iter, (float)lr, static_cast<float*>(ep0),
                        static_cast<int*>(n_iter), static_cast<float*>(dep),
                        static_cast<int*>(first_ok), static_cast<int*>(final_ok),
                        static_cast<float*>(out)};
    return launch_grid<float>(momentum, n_layers, table, host_table, dw, scratch, a, ctas, st);
  }
  if (dtype == 1) {
    const Args<double> a{snn != 0, momentum != 0, static_cast<const double*>(X),
                         static_cast<const double*>(Tg), S, alpha, delta, min_iter,
                         max_iter, lr, static_cast<double*>(ep0), static_cast<int*>(n_iter),
                         static_cast<double*>(dep), static_cast<int*>(first_ok),
                         static_cast<int*>(final_ok), static_cast<double*>(out)};
    return launch_grid<double>(momentum, n_layers, table, host_table, dw, scratch, a, ctas, st);
  }
  return (int)cudaErrorInvalidValue;
}

// CTAs of the grid build the current device holds at once, into *ctas
// (dtype 0 = float, 1 = double).  Returns the cudaError_t of the query.
extern "C" int hpnn_convergence_grid_ctas(int dtype, int* ctas) {
  *ctas = 0;
  if (dtype == 0) return grid_ctas<float>(ctas);
  if (dtype == 1) return grid_ctas<double>(ctas);
  return (int)cudaErrorInvalidValue;
}

#ifdef HPNN_PHASE_CLOCKS
// The SM cycles rank 0's thread 0 spent in each phase (enum Phase), summed
// over the launches since the last reset; then zero them if `reset`.
extern "C" int hpnn_convergence_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess || !reset) return (int)err;
  static const unsigned long long zero[N_PHASES] = {};
  return (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
}

// The CTA of the grid build whose thread 0 marks the phases (0 at load).
extern "C" int hpnn_convergence_clock_cta(int cta) {
  return (int)cudaMemcpyToSymbol(g_clock_cta, &cta, sizeof(cta));
}
#endif

extern "C" const char* hpnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
