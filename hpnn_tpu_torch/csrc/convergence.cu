// Per-sample convergence loop of libhpnn's BP/BPM training, one CUDA
// launch per chunk of samples.
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
// Bound.  Per iteration the loop reads W for the re-forward and for
// W^T . delta, and reads and writes W in the update: about 4*|W| bytes,
// plus 2*|dw| with momentum.  At 784-300-10 in float (|W| = 0.95 MB)
// that is about 3.8 MB per iteration, or about 1.1 us at the H100's
// 3.35 TB/s; the flops (about 5 per weight) are far below the card's
// rate.  The weights (1.9 MB with dw) do not fit in one block's 227 KB
// of shared memory, so they stay in device memory, where the 50 MB L2
// keeps them resident across iterations.
//
// Design: the simple one that is right.  One thread block of 1024
// threads runs the chunk's whole loop; activations, deltas, the input
// and the target live in shared memory (2 * sum of layer widths values
// plus n_in + n_out).  Forward W.v: a warp per row, lanes striding the
// columns (coalesced), shuffle reduce.  Hidden deltas W^T.delta: a
// thread per column looping over the rows (coalesced across threads).
// Update: a warp per row, lanes striding the columns.  Error and the
// softmax denominator: warp reductions.  __syncthreads() between phases.
// A single block sits far from the bound above: it draws on one SM's
// share of L2 bandwidth, so expect tens of microseconds per iteration.
// A cluster/distributed-shared-memory design that spreads the rows over
// many SMs is later performance work.
//
// Numerics: plain FP32 (or FP64) arithmetic with FMA, expf/logf in
// float and exp/log in double, no fast math and no tensor cores — the
// counterpart of the Pallas kernel's precision=HIGHEST pin.  Built for
// float (the production type) and double (checked to tight bars).

#include <cuda_runtime.h>
#include <math.h>

#define HPNN_MAX_LAYERS 16
#define HPNN_THREADS 1024

namespace {

template <typename T>
struct Net {
  int n_layers;
  int dims[HPNN_MAX_LAYERS + 1];  // dims[0] = n_in, dims[l+1] = rows of layer l
  int off[HPNN_MAX_LAYERS];       // offset of layer l in the acts/deltas arrays
  T* w[HPNN_MAX_LAYERS];
  T* dw[HPNN_MAX_LAYERS];
};

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
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

// acts[off[l]..] <- activations of layer l from the current weights.
template <typename T>
__device__ void forward(const Net<T>& net, bool snn, const T* xs, T* acts,
                        T* s_scalar) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T tiny = T(1e-14);
  for (int l = 0; l < net.n_layers; ++l) {
    const int n = net.dims[l + 1], m = net.dims[l];
    const T* W = net.w[l];
    const T* vin = (l == 0) ? xs : acts + net.off[l - 1];
    T* vout = acts + net.off[l];
    const bool soft = snn && l == net.n_layers - 1;
    for (int row = warp; row < n; row += nwarps) {
      const T* wr = W + (size_t)row * m;
      T acc = T(0);
      for (int j = lane; j < m; j += 32) acc = fma(wr[j], vin[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) vout[row] = soft ? dev_exp(acc - T(1)) : act(acc);
    }
    __syncthreads();
    if (soft) {
      if (warp == 0) {
        T e = T(0);
        for (int i = lane; i < n; i += 32) e += vout[i];
        e = warp_sum(e);
        if (lane == 0) *s_scalar = tiny + e;
      }
      __syncthreads();
      const T dv = *s_scalar;
      for (int i = threadIdx.x; i < n; i += blockDim.x) vout[i] = vout[i] / dv;
      __syncthreads();
    }
  }
}

// Error of the output layer, and (argmax_ok != nullptr) whether its
// first argmax is p_trg.  Every thread returns the same values.
template <typename T>
__device__ T error_and_check(const Net<T>& net, bool snn, const T* ts,
                             const T* out, int p_trg, T* s_err, int* s_ok,
                             int* ok) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = net.dims[net.n_layers];
  const T tiny = T(1e-14);
  if (warp == 0) {
    T acc = T(0);
    for (int i = lane; i < n; i += 32) {
      if (snn) {
        acc += ts[i] * dev_log(out[i] + tiny);
      } else {
        const T d = ts[i] - out[i];
        acc += d * d;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      *s_err = snn ? -acc / T(n) : T(0.5) * acc;
      if (ok != nullptr) {
        // first index of the max; the first NaN wins if any (jnp.argmax)
        int best = 0, first_nan = -1;
        for (int i = 0; i < n; ++i) {
          const T v = out[i];
          if (isnan(v)) {
            first_nan = i;
            break;
          }
          if (v > out[best]) best = i;
        }
        *s_ok = ((first_nan >= 0 ? first_nan : best) == p_trg) ? 1 : 0;
      }
    }
  }
  __syncthreads();
  if (ok != nullptr) *ok = *s_ok;
  return *s_err;
}

// Deltas from the current weights and activations, then the in-place
// BP or BPM update of every layer.
template <typename T>
__device__ void backward_update(const Net<T>& net, bool snn, bool momentum,
                                T lr, T alpha, const T* xs, const T* ts,
                                const T* acts, T* ds) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int L = net.n_layers;
  {
    const int n = net.dims[L];
    const T* o = acts + net.off[L - 1];
    T* d = ds + net.off[L - 1];
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      d[i] = snn ? ts[i] - o[i] : (ts[i] - o[i]) * dact(o[i]);
  }
  __syncthreads();
  for (int l = L - 2; l >= 0; --l) {
    const int n = net.dims[l + 2], m = net.dims[l + 1];
    const T* W = net.w[l + 1];
    const T* dn = ds + net.off[l + 1];
    const T* a = acts + net.off[l];
    T* d = ds + net.off[l];
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      T acc = T(0);
      for (int i = 0; i < n; ++i) acc = fma(dn[i], W[(size_t)i * m + j], acc);
      d[j] = acc * dact(a[j]);
    }
    __syncthreads();
  }
  for (int l = 0; l < L; ++l) {
    const int n = net.dims[l + 1], m = net.dims[l];
    T* W = net.w[l];
    T* M = net.dw[l];
    const T* vin = (l == 0) ? xs : acts + net.off[l - 1];
    const T* d = ds + net.off[l];
    for (int row = warp; row < n; row += nwarps) {
      const T di = d[row];
      T* wr = W + (size_t)row * m;
      if (momentum) {
        T* mr = M + (size_t)row * m;
        for (int j = lane; j < m; j += 32) {
          const T mm = mr[j] + lr * (di * vin[j]);
          wr[j] = wr[j] + mm;
          mr[j] = alpha * mm;
        }
      } else {
        for (int j = lane; j < m; j += 32) wr[j] = wr[j] + lr * (di * vin[j]);
      }
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(HPNN_THREADS)
convergence_epoch(Net<T> net, bool snn, bool momentum, const T* X, const T* Tg,
                  int S, T alpha, T delta, int min_iter, int max_iter, T lr,
                  T* ep0_out, int* niter_out, T* dep_out, int* first_out,
                  int* final_out, T* out_out) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ T s_err, s_scalar;
  __shared__ int s_ok, s_ptrg;

  const int L = net.n_layers;
  const int n_in = net.dims[0], n_out = net.dims[L];
  const int n_act = net.off[L - 1] + n_out;
  T* xs = smem;
  T* ts = xs + n_in;
  T* acts = ts + n_out;
  T* ds = acts + n_act;
  const T* out = acts + net.off[L - 1];

  for (int s = 0; s < S; ++s) {
    for (int i = threadIdx.x; i < n_in; i += blockDim.x)
      xs[i] = X[(size_t)s * n_in + i];
    for (int i = threadIdx.x; i < n_out; i += blockDim.x)
      ts[i] = Tg[(size_t)s * n_out + i];
    if (momentum) {
      for (int l = 0; l < L; ++l) {
        const size_t nm = (size_t)net.dims[l + 1] * net.dims[l];
        for (size_t k = threadIdx.x; k < nm; k += blockDim.x) net.dw[l][k] = T(0);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int p = 0;
      for (int i = 0; i < n_out; ++i)
        if (ts[i] == T(1)) p = i;
      s_ptrg = p;
    }
    forward(net, snn, xs, acts, &s_scalar);
    const T ep0 = error_and_check<T>(net, snn, ts, out, 0, &s_err, &s_ok, nullptr);
    const int p_trg = s_ptrg;

    int it = 0, ok = 0, first_ok = 0;
    T ep = ep0, dep;
    while (true) {
      ++it;
      backward_update(net, snn, momentum, lr, alpha, xs, ts, acts, ds);
      forward(net, snn, xs, acts, &s_scalar);
      const T epr = error_and_check<T>(net, snn, ts, out, p_trg, &s_err, &s_ok, &ok);
      dep = ep - epr;
      ep = epr;  // the next iteration's Ep: same acts, same reduction
      if (it == 1) first_ok = ok;
      const bool ok_eff = ok && it > min_iter;
      if (!(it <= max_iter && (dep > delta || !ok_eff))) break;
    }
    if (threadIdx.x == 0) {
      ep0_out[s] = ep0;
      niter_out[s] = it;
      dep_out[s] = dep;
      first_out[s] = first_ok;
      final_out[s] = (ok && it > min_iter) ? 1 : 0;
    }
    for (int i = threadIdx.x; i < n_out; i += blockDim.x)
      out_out[(size_t)s * n_out + i] = out[i];
    __syncthreads();  // xs/ts are rewritten by the next sample
  }
}

template <typename T>
int launch(int snn, int momentum, int n_layers, const int* dims,
           void* const* w, void* const* dw, const void* X, const void* Tg,
           int S, double alpha, double delta, int min_iter, int max_iter,
           double lr, void* ep0, void* n_iter, void* dep, void* first_ok,
           void* final_ok, void* out, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > HPNN_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  Net<T> net;
  net.n_layers = n_layers;
  int total = 0;
  for (int l = 0; l <= n_layers; ++l) net.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    net.off[l] = total;
    total += dims[l + 1];
    net.w[l] = static_cast<T*>(w[l]);
    net.dw[l] = momentum ? static_cast<T*>(dw[l]) : nullptr;
  }
  const size_t smem = sizeof(T) * ((size_t)dims[0] + dims[n_layers] + 2 * (size_t)total);
  cudaError_t err = cudaFuncSetAttribute(
      convergence_epoch<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  convergence_epoch<T><<<1, HPNN_THREADS, smem, stream>>>(
      net, snn != 0, momentum != 0, static_cast<const T*>(X),
      static_cast<const T*>(Tg), S, (T)alpha, (T)delta, min_iter, max_iter,
      (T)lr, static_cast<T*>(ep0), static_cast<int*>(n_iter),
      static_cast<T*>(dep), static_cast<int*>(first_ok),
      static_cast<int*>(final_ok), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  `dims`, `w` and `dw` are HOST arrays (of
// n_layers+1 ints and n_layers device pointers); every other pointer is
// a device pointer.  dtype: 0 = float, 1 = double.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int hpnn_convergence_train_epoch(
    int dtype, int snn, int momentum, int n_layers, const int* dims,
    void* const* w, void* const* dw, const void* X, const void* Tg, int S,
    double alpha, double delta, int min_iter, int max_iter, double lr,
    void* ep0, void* n_iter, void* dep, void* first_ok, void* final_ok,
    void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(snn, momentum, n_layers, dims, w, dw, X, Tg, S, alpha,
                         delta, min_iter, max_iter, lr, ep0, n_iter, dep,
                         first_ok, final_ok, out, st);
  if (dtype == 1)
    return launch<double>(snn, momentum, n_layers, dims, w, dw, X, Tg, S, alpha,
                          delta, min_iter, max_iter, lr, ep0, n_iter, dep,
                          first_ok, final_ok, out, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hpnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
