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
// Design: the simple one that is right.  The epoch body is written once
// for a *team* of thread blocks, which has a rank, a size and a sync:
// the team strides over a phase's tiles and rows, and `sync()`
// separates the phases (a forward layer, the output rows, a
// hidden-delta layer, the update of all layers, the loss rows).
//   batch_train (#2-#5): the team is the whole grid, one persistent
//     cooperative launch, every block co-resident, `grid.sync()`;
//   fleet_train (#6): the team is one thread block, `__syncthreads()`,
//     and a plain launch of N blocks, block i on member i (the Pallas
//     `grid=(N,)`).  Members never wait on each other, so N is not
//     bounded by co-residency; one member runs on one SM, so a member's
//     step is slower than #4's, and the fleet's gain is N steps at once.
//     Its bound is N times one epoch's, by operations likewise.
// Each matrix phase is a tiled SIMT GEMM over 32x32 output tiles with
// 32-deep shared-memory k-tiles, FP32 (or FP64) FMA, no tensor cores,
// no fast math, with a fused
// epilogue: act for the forward (v.W^T, "NT"), dact for the deltas
// (delta.W, "NN"), the SGD or BPM triad for the update (delta^T.v,
// "TN").  The weights, and the activations and deltas scratch
// (2*B*sum(out_l) values, allocated by the wrapper), stay in device
// memory, held in the 50 MB L2; loads that may see another block's
// writes bypass L1 (`__ldcg`).
//
// Determinism: every output element is summed by one thread in a fixed
// k order; each row's softmax sum and error by one thread in column
// order; the batch loss by one warp in a fixed tree.  No atomics.  So
// the same inputs give bitwise the same outputs whatever the team, and
// the five entry points agree bitwise on the same blocks: member i of
// #6 equals #5 (and #4) run on bank i with orders[i].
//
// Built for float (the card's default type) and double.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define HPNN_MAX_LAYERS 16
#define HPNN_THREADS 256
#define HPNN_TILE 32
// blocks per SM: the largest phase at 784-300-10 has 250 tiles, and a
// grid sync costs more the more blocks it waits for
#define HPNN_BLOCKS_PER_SM 2

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

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }

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

// The unit of work of an epoch: the whole cooperative grid (#2-#5) ...
struct GridTeam {
  cg::grid_group grid;
  __device__ int rank() const { return blockIdx.x; }
  __device__ int size() const { return gridDim.x; }
  __device__ void sync() { grid.sync(); }
};

// ... or one thread block, a fleet member (#6).
struct BlockTeam {
  __device__ int rank() const { return 0; }
  __device__ int size() const { return 1; }
  __device__ void sync() { __syncthreads(); }
};

// One 32x32 tile (tm, tn) of C(r, c) = sum_k A(r, k) * Bm(k, c) with
// A(r, k) = A[r*sar + k*sak] and Bm(k, c) = Bm[k*sbk + c*sbc]; calls
// epi(r, c, acc) for each element inside (M, N).  Thread (ty, tx) of
// 8x32 owns rows ty, ty+8, ty+16, ty+24 of column tx.
template <typename T, typename Epi>
__device__ void gemm_tile(int M, int N, int K, const T* A, size_t sar,
                          size_t sak, const T* Bm, size_t sbk, size_t sbc,
                          int tm, int tn, T (*As)[HPNN_TILE + 1],
                          T (*Bs)[HPNN_TILE + 1], Epi epi) {
  const int tx = threadIdx.x % HPNN_TILE, ty = threadIdx.x / HPNN_TILE;
  const int r0 = tm * HPNN_TILE, c0 = tn * HPNN_TILE;
  // neighbouring threads load neighbouring addresses
  const bool a_kfast = sak == 1, b_cfast = sbc == 1;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int k0 = 0; k0 < K; k0 += HPNN_TILE) {
    for (int e = threadIdx.x; e < HPNN_TILE * HPNN_TILE; e += HPNN_THREADS) {
      const int i = e / HPNN_TILE, j = e % HPNN_TILE;
      const int ar = a_kfast ? i : j, ak = a_kfast ? j : i;
      const int r = r0 + ar, k = k0 + ak;
      As[ak][ar] = (r < M && k < K) ? ldcg(A + (size_t)r * sar + (size_t)k * sak) : T(0);
      const int bk = b_cfast ? i : j, bc = b_cfast ? j : i;
      const int kb = k0 + bk, c = c0 + bc;
      Bs[bk][bc] = (kb < K && c < N) ? ldcg(Bm + (size_t)kb * sbk + (size_t)c * sbc) : T(0);
    }
    __syncthreads();
    const int kmax = min(HPNN_TILE, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const T b = Bs[kk][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fma(As[kk][ty + 8 * q], b, acc[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + ty + 8 * q, c = c0 + tx;
    if (r < M && c < N) epi(r, c, acc[q]);
  }
}

// acts_l <- forward of the (B, n_in) block x through every layer.
template <typename T, typename Team>
__device__ void forward(const Params<T>& p, const T* x, Team& team,
                        T (*As)[HPNN_TILE + 1], T (*Bs)[HPNN_TILE + 1]) {
  for (int l = 0; l < p.n_layers; ++l) {
    const int m = p.dims[l], n = p.dims[l + 1];
    const T* vin = l == 0 ? x : p.acts + p.off[l - 1];
    T* vout = p.acts + p.off[l];
    const bool soft = p.snn && l == p.n_layers - 1;
    const int tn_count = cdiv(n, HPNN_TILE);
    const int tiles = cdiv(p.B, HPNN_TILE) * tn_count;
    for (int t = team.rank(); t < tiles; t += team.size())
      gemm_tile<T>(p.B, n, m, vin, m, 1, p.w[l], 1, m, t / tn_count,
                   t % tn_count, As, Bs, [&](int r, int c, T z) {
                     vout[(size_t)r * n + c] = soft ? dev_exp(z - T(1)) : act(z);
                   });
    team.sync();
  }
}

// One thread per output row: the SNN normalisation, then the output
// delta (loss == false) or the row's error into rowloss (loss == true).
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
__device__ void hidden_deltas(const Params<T>& p, Team& team,
                              T (*As)[HPNN_TILE + 1], T (*Bs)[HPNN_TILE + 1]) {
  for (int l = p.n_layers - 2; l >= 0; --l) {
    const int n = p.dims[l + 1], k = p.dims[l + 2];
    const T* dn = p.ds + p.off[l + 1];
    const T* a = p.acts + p.off[l];
    T* d = p.ds + p.off[l];
    const int tn_count = cdiv(n, HPNN_TILE);
    const int tiles = cdiv(p.B, HPNN_TILE) * tn_count;
    for (int t = team.rank(); t < tiles; t += team.size())
      gemm_tile<T>(p.B, n, k, dn, k, 1, p.w[l + 1], n, 1, t / tn_count,
                   t % tn_count, As, Bs, [&](int r, int c, T z) {
                     const size_t q = (size_t)r * n + c;
                     d[q] = z * dact(ldcg(a + q));
                   });
    team.sync();
  }
}

// The update of every layer, its tiles laid end to end over the team.
template <typename T, typename Team>
__device__ void update(const Params<T>& p, const T* x, Team& team,
                       T (*As)[HPNN_TILE + 1], T (*Bs)[HPNN_TILE + 1]) {
  int total = 0;
  for (int l = 0; l < p.n_layers; ++l)
    total += cdiv(p.dims[l + 1], HPNN_TILE) * cdiv(p.dims[l], HPNN_TILE);
  for (int t = team.rank(); t < total; t += team.size()) {
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
    gemm_tile<T>(M, N, p.B, d, 1, M, v, N, 1, tt / tn_count, tt % tn_count,
                 As, Bs, [&](int i, int j, T outer) {
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
template <typename T, typename Team>
__device__ void epoch(const Params<T>& p, Team& team, T (*As)[HPNN_TILE + 1],
                      T (*Bs)[HPNN_TILE + 1]) {
  const int n_in = p.dims[0], n_out = p.dims[p.n_layers];
  for (int s = 0; s < p.S; ++s) {
    const size_t row0 = (size_t)block_of(p, s) * p.B;
    const T* x = p.X + row0 * n_in;
    const T* tg = p.Tg + row0 * n_out;
    if (p.prefetch && s + 1 < p.S) prefetch_block(p, team, block_of(p, s + 1));
    forward(p, x, team, As, Bs);
    output_rows(p, tg, team, false);
    team.sync();
    hidden_deltas(p, team, As, Bs);
    update(p, x, team, As, Bs);
    forward(p, x, team, As, Bs);
    output_rows(p, tg, team, true);
    team.sync();
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

template <typename T>
__global__ void __launch_bounds__(HPNN_THREADS) batch_train(Params<T> p) {
  __shared__ T As[HPNN_TILE][HPNN_TILE + 1];
  __shared__ T Bs[HPNN_TILE][HPNN_TILE + 1];
  GridTeam team{cg::this_grid()};
  epoch(p, team, As, Bs);
}

// Member strides of a fleet launch, in elements of T.
struct Fleet {
  size_t x, t;     // one member's bank of X (bank_rows*n_in) and of T
  size_t scratch;  // 2*B*sum(dims[1:]) + B
};

// Block i trains member i: `p` holds member 0's pointers, moved here to
// member i's slices.  The stacked weights are (N, out, in), so member
// i's layer l starts i*out*in elements in; orders and losses are (N, S).
template <typename T>
__global__ void __launch_bounds__(HPNN_THREADS) fleet_train(Params<T> p, Fleet f) {
  __shared__ T As[HPNN_TILE][HPNN_TILE + 1];
  __shared__ T Bs[HPNN_TILE][HPNN_TILE + 1];
  const size_t i = blockIdx.x;
  for (int l = 0; l < p.n_layers; ++l) {
    const size_t n_w = (size_t)p.dims[l] * p.dims[l + 1];
    p.w[l] += i * n_w;
    if (p.momentum) p.dw[l] += i * n_w;
  }
  p.X += i * f.x;
  p.Tg += i * f.t;
  p.order += i * p.S;
  p.acts += i * f.scratch;
  p.ds += i * f.scratch;
  p.rowloss += i * f.scratch;
  p.losses += i * p.S;
  BlockTeam team;
  epoch(p, team, As, Bs);
}

template <typename T>
int grid_blocks(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, batch_train<T>,
                                                        HPNN_THREADS, 0);
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

template <typename T>
int launch(int blocks, int snn, int momentum, int n_layers, const int* dims,
           void* const* w, void* const* dw, const void* X, const void* Tg,
           int B, const int* order, int first, int S, double lr_eff,
           double alpha, double inv_b, void* scratch, void* losses,
           int prefetch, cudaStream_t stream) {
  Params<T> p;
  if (!make_params(&p, snn, momentum, n_layers, dims, w, dw, X, Tg, B, order,
                   first, S, lr_eff, alpha, inv_b, scratch, losses, prefetch))
    return (int)cudaErrorInvalidValue;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)batch_train<T>, dim3(blocks), dim3(HPNN_THREADS), args, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fleet(int members, int snn, int momentum, int n_layers,
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
  fleet_train<T><<<members, HPNN_THREADS, 0, stream>>>(p, f);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  `blocks` is the grid, from
// hpnn_batch_grid_blocks.  `dims`, `w` and `dw` are HOST arrays (of
// n_layers+1 ints and n_layers device pointers); every other pointer is
// a device pointer.  `order` may be null: step s then reads block
// first + s.  `scratch` holds 2*B*sum(dims[1:]) + B values.  dtype:
// 0 = float, 1 = double.  Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int hpnn_batch_train(int dtype, int blocks, int snn, int momentum,
                                int n_layers, const int* dims, void* const* w,
                                void* const* dw, const void* X, const void* Tg,
                                int B, const void* order, int first, int S,
                                double lr_eff, double alpha, double inv_b,
                                void* scratch, void* losses, int prefetch,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  if (dtype == 0)
    return launch<float>(blocks, snn, momentum, n_layers, dims, w, dw, X, Tg, B,
                         ord, first, S, lr_eff, alpha, inv_b, scratch, losses,
                         prefetch, st);
  if (dtype == 1)
    return launch<double>(blocks, snn, momentum, n_layers, dims, w, dw, X, Tg, B,
                          ord, first, S, lr_eff, alpha, inv_b, scratch, losses,
                          prefetch, st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry of the fleet epoch (#6): `members` blocks, block i on
// member i, every step prefetching its member's next block.  `dims`,
// `w` and `dw` are as for hpnn_batch_train, with w[l] (and dw[l]) the
// stacked (members, dims[l+1], dims[l]) layer l, member stride
// dims[l]*dims[l+1].  X and Tg are the stacked banks, (members,
// bank_rows, dims[0]) and (members, bank_rows, dims[n_layers]), member
// stride bank_rows rows.  `orders` and `losses` are (members, S), member
// stride S; `scratch` holds members * (2*B*sum(dims[1:]) + B) values,
// member stride one scratch.  Returns the cudaError_t of the launch.
extern "C" int hpnn_fleet_train(int dtype, int members, int snn, int momentum,
                                int n_layers, const int* dims, void* const* w,
                                void* const* dw, const void* X, const void* Tg,
                                long long bank_rows, int B, const void* orders,
                                int S, double lr_eff, double alpha, double inv_b,
                                void* scratch, void* losses, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(orders);
  if (dtype == 0)
    return launch_fleet<float>(members, snn, momentum, n_layers, dims, w, dw, X,
                               Tg, bank_rows, B, ord, S, lr_eff, alpha, inv_b,
                               scratch, losses, st);
  if (dtype == 1)
    return launch_fleet<double>(members, snn, momentum, n_layers, dims, w, dw, X,
                                Tg, bank_rows, B, ord, S, lr_eff, alpha, inv_b,
                                scratch, losses, st);
  return (int)cudaErrorInvalidValue;
}

// The cooperative grid of one launch on the current device: every
// block co-resident.  Returns the cudaError_t of the query.
extern "C" int hpnn_batch_grid_blocks(int dtype, int* blocks) {
  *blocks = 0;
  if (dtype == 0) return grid_blocks<float>(blocks);
  if (dtype == 1) return grid_blocks<double>(blocks);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hpnn_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
