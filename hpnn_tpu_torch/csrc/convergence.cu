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
  N_PHASES
};
#ifdef HPNN_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[N_PHASES];
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
    HPNN_PHASE(c, P_FWD);
    cluster_barrier();
    HPNN_PHASE(c, P_CSYNC);
    c.gather(vout, l);
    // every W is final until the next update: stage the next deltas' tile
    // in the same pass as the last gather
    if (l == L - 1 && c.tile_prefetched()) c.prefetch_tile();
    __syncthreads();
    HPNN_PHASE(c, P_GATHER);
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
    for (int i = lane; i < n; i += 32) {
      const T o = c.output(a, i, snn);
      if (snn) {
        acc += c.ts[i] * dev_log(o + tiny);
      } else {
        const T d = c.ts[i] - o;
        acc += d * d;
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
    T* d = c.ds + c.net.ly.off(L - 1);
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
  net.ly.dims[0] = n_in;
  for (int l = 0; l < n_layers; ++l) {
    net.ly.dims[l + 1] = rec[l].n;
    net.ly.off_[l] = rec[l].off;
    net.ly.wblk_[l] = rec[l].wblk;
    net.ly.inv_n_[l] = rec[l].inv_n;
    net.ly.w_[l] = reinterpret_cast<T*>(rec[l].w);
    net.ly.dw_[l] = dws ? dws + rec[l].dwo : nullptr;
  }
  return start(net, a, n_in, n_out, cluster, stream);
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

#ifdef HPNN_PHASE_CLOCKS
// The SM cycles rank 0's thread 0 spent in each phase (enum Phase), summed
// over the launches since the last reset; then zero them if `reset`.
extern "C" int hpnn_convergence_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess || !reset) return (int)err;
  static const unsigned long long zero[N_PHASES] = {};
  return (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
}
#endif

extern "C" const char* hpnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
