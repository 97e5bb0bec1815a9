// The adaptive solver's step and Newton-Krylov body for Hopper (sm_90a),
// with a plain C interface: everything shud_tpu_torch/solver/bdf.py does
// between two of its reductions.
//
// JAX runs this body inside lax.while_loop (shud_tpu/solver/bdf.py:237-389
// step_body, :168-203 _newton, :112-165 _gmres), where XLA fuses the vector
// and scalar work between the dot products into a few kernels; the Pallas
// package has no kernel for it.  Run as single torch ops it is ~114 device
// kernels a NFE.  Four kernels here take the work between reductions:
//
//   bdf_begin      S1  the step size, the WRMS weights, the predictor and
//                      the BDF coefficients (step_begin up to its first
//                      Newton iteration)
//   krylov_axpy    S2  -(y - bh f - c0), v - bh J v, -h_ij v_i + w
//   krylov_column  S3  v0 = b / beta, v_{j+1} = w / |w| (the breakdown
//                      test), and after the last column the Givens
//                      rotations, the back-substitution, x = sum ys_j v_j,
//                      where(beta > 0), y + dy and the terms of both norms
//   bdf_finish     S4  the Newton tail (dnorm, it + 1, another iteration?)
//                      and the step end (error test, controller, counters,
//                      the selects of y, y_prev and y_prev2, `active`)
//
// The reductions themselves (the dot products and the two WRMS sums) stay
// torch.dot and torch.sum in solver/kernels.py: no hand kernel reproduces
// cuBLAS's or PyTorch's summation order, and with those kept a trajectory
// stays bitwise the torch pieces' (solver_kernel=False).  The scalars a
// kernel needs are recomputed by each thread from the reductions' results,
// so no kernel needs a grid barrier; block 0 writes what later kernels or
// the host read (the step's h, bh, t_new; beta and ys).
//
// Each kernel redoes the torch expression op by op, in the same order and
// with the same roundings (built with --fmad=false, IEEE division and
// square root):
//   * a state over a 0-d step size on the card is the product with its
//     reciprocal (kernels.over), and 1.0 / t on a tensor is
//     t.reciprocal() * 1.0;
//   * sum / n divides by a host integer: the product with its reciprocal,
//     which PyTorch computes on the host in the state's type (inv_n here);
//   * x ** 2 is x * x;
//   * the controller's power is pow(double, double), rounded once to the
//     state's type;
//   * Python floats are cast to the state's type before they meet it
//     (torch.where(c, x, 1.0), comparisons, products with constants);
//   * torch.clamp and torch.minimum pass NaNs through;
//   * the counters are int64.
//
// What bounds them: memory.  Each is one pass over a few state vectors
// (S1 reads 3-4 and writes 3; S2 reads 2-3, writes 1; S3 reads up to m + 3,
// writes up to 3; S4 reads 4, writes 3) with a handful of operations an
// entry.  S1 and S4 take one entry a thread, 256 threads to a block.
//
// S2 and S3 (the Newton update: 10 and 4 launches a Newton iteration at
// m = 3) are laid out for Hopper's loads:
//   * each thread takes VEC consecutive entries of every vector, 4 in f32
//     and 2 in f64, read and written as one 16-byte access each (a tail of
//     n mod VEC entries entry by entry in the same kernel); the wrapper
//     picks VEC = 1, the same kernels, for a pointer that is not 16-byte
//     aligned or an n below VEC (kernels.vec_width); 128 threads to a
//     block, so the mega path's 98,432 entries spread over 193 blocks;
//   * S2's mode and S3's Krylov dimension m are template parameters: one
//     instantiation per mode and per m = 1..kMaxM, every loop of the last
//     column's chain (the Givens rotations of all m columns and the
//     back-substitution) unrolled, so g, R, cs, sn, hc and ys live in
//     registers (ptxas: no stack frame, no spill);
//   * the last column issues all of a thread's loads first (the
//     iteration's dot products, then its entries of the m basis vectors,
//     y, and with the norms ewt and y_pred), and every thread then runs
//     the chain itself from the dot products: it is warp-uniform, so SIMT
//     issues it once a warp, with no shared memory and no block barrier,
//     and the vectors' latency overlaps it.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the caller allocates every buffer.  Each kernel adds
// one to *count (a device counter of solver/kernels.py) where it runs, so a
// launch replayed from a CUDA graph is counted as well.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 8;  // Krylov dimension (3 by default, 5 in fixed.py)
// the dot products of one Newton iteration: b.b, then for column j: w.w,
// v_0.w ... v_j.w, w.w after Gram-Schmidt
constexpr int kMaxDots = 1 + kMaxM * (kMaxM + 5) / 2;

// the scalars a solver's scratch holds (solver/kernels.py Scratch.scal)
constexpr int kH = 0, kBH = 1, kTNew = 2, kDNorm = 3, kBeta = 4, kYs = 5;

enum AxpyMode { kResidual = 0, kMatvec = 1, kGramSchmidt = 2 };
enum FinishMode { kNewton = 0, kStep = 1 };

__device__ __forceinline__ float fmin_(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double fmin_(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float fmax_(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double fmax_(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ bool isnan_(T x) {
  return x != x;
}
// torch.clamp(x, max=hi), (x, min=lo), (x, lo, hi) and torch.minimum, as
// PyTorch's CUDA kernels compute them: a NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return isnan_(x) ? x : fmin_(x, hi);
}
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return isnan_(x) ? x : fmax_(x, lo);
}
template <typename T>
__device__ __forceinline__ T clamp_(T x, T lo, T hi) {
  return isnan_(x) ? x : fmin_(fmax_(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T minimum_(T a, T b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmin_(a, b));
}
// 1.0 / t on a tensor: t.reciprocal() * 1.0
template <typename T>
__device__ __forceinline__ T recip(T x) {
  return T(1) / x;
}

__device__ __forceinline__ long long index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// ---------------------------------------------------------------------------
// S1 bdf_begin (bdf.step_begin before its first Newton iteration)
// ---------------------------------------------------------------------------

template <typename T>
struct BeginArgs {
  const T *y, *y_prev, *y_prev2, *fy0;  // fy0 null with the history predictor
  const T *t, *h, *h_prev, *h_prev2, *tout;
  const int64_t* order;
  T *ewt, *y_pred, *c0, *scal;
  int64_t* it;
  unsigned long long* count;
  double rtol, atol, h_max, h_min;
  long long n;
  int max_order, history;
};

template <typename T>
__global__ void bdf_begin_kernel(BeginArgs<T> a) {
  const long long i = index();
  if (i == 0) atomicAdd(a.count, 1ULL);
  const T t = *a.t, tau = *a.h_prev, tau2 = *a.h_prev2;
  const int64_t order = *a.order;
  const bool use2 = order >= 2, use3 = order >= 3;
  T h = minimum_(clamp_max(*a.h, T(a.h_max)), *a.tout - t);
  h = clamp_min(h, T(a.h_min));
  // variable-step BDF coefficients
  const T r = h / tau;
  const T r1 = r + T(1);
  const T den = T(2) * r + T(1);
  const T a1 = (r1 * r1) / den;
  const T a2 = -(r * r) / den;
  const T b2 = r1 / den;
  T bh = (use2 ? b2 : T(1)) * h;
  // variable-step BDF3 (Lagrange-derivative form) and the Hermite cubic
  T g1 = T(0), g2 = T(0), g3 = T(0), rg0 = T(0);
  T w01 = T(0), w12 = T(0), w02 = T(0), e0 = T(0), e1 = T(0);
  if (a.max_order >= 3) {
    const T s1 = h + tau, s2 = (h + tau) + tau2;
    const T g0 = (recip(h) + recip(s1)) + recip(s2);
    g1 = -(s1 * s2) / ((h * tau) * (tau + tau2));
    g2 = (h * s2) / ((s1 * tau) * tau2);
    g3 = -(h * s1) / ((s2 * (tau + tau2)) * tau2);
    rg0 = recip(g0);
    if (use3) bh = rg0;
    w01 = recip(tau2);
    w12 = recip(tau);
    w02 = recip(tau + tau2);
    e0 = (h + tau) + tau2;
    e1 = h + tau;
  }
  if (i == 0) {
    a.scal[kH] = h;
    a.scal[kBH] = bh;
    a.scal[kTNew] = t + h;
    *a.it = 0;
  }
  if (i >= a.n) return;
  const T y = a.y[i], yp = a.y_prev[i], yp2 = a.y_prev2[i];
  a.ewt[i] = recip(T(a.rtol) * abs_(y) + T(a.atol));
  T pred;
  if (a.history) {
    // the quadratic Lagrange predictor through y_prev2, y_prev, y
    const T e0h = (h + tau) + tau2, e1h = h + tau;
    const T d01 = (yp - yp2) * recip(tau2);
    const T d12 = (y - yp) * recip(tau);
    const T d2 = (d12 - d01) * recip(tau + tau2);
    pred = use2 ? (yp2 + d01 * e0h) + (d2 * e0h) * e1h : y;
  } else {
    // forward Euler, the quadratic Hermite through (y_prev, y, fy0)
    const T f = a.fy0[i];
    const T ac = ((yp - y) + f * tau) * recip(tau * tau);
    pred = use2 ? (y + f * h) + (ac * h) * h : h * f + y;
  }
  T c0 = use2 ? a1 * y + a2 * yp : y;
  if (a.max_order >= 3 && use3) {
    const T f = a.fy0[i];
    const T d01 = (yp - yp2) * w01;
    const T d12 = (y - yp) * w12;
    const T d2_012 = (d12 - d01) * w02;
    const T d2_122 = (f - d12) * w12;
    const T d3 = (d2_122 - d2_012) * w02;
    pred = ((yp2 + d01 * e0) + (d2_012 * e0) * e1) + ((d3 * e0) * e1) * h;
    c0 = (-((g1 * y + g2 * yp) + g3 * yp2)) * rg0;
  }
  a.y_pred[i] = pred;
  a.c0[i] = c0;
}

// ---------------------------------------------------------------------------
// S2 and S3: VEC entries a thread
// ---------------------------------------------------------------------------

constexpr int kVecThreads = 128;

// the wide form's entries a thread: one 16-byte access
template <typename T>
constexpr int kWide = 16 / static_cast<int>(sizeof(T));

// a thread's VEC consecutive entries, moved as one access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// entries [i0, i0 + VEC) of p: one access where all lie below n, else
// entry by entry (the tail; what lies beyond n reads as 0 and is not
// stored)
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, long long i0, long long n,
                                     T (&r)[VEC]) {
  if (i0 + VEC <= n) {
    const Pack<T, VEC> q = *reinterpret_cast<const Pack<T, VEC>*>(p + i0);
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = q.v[e];
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = i0 + e < n ? p[i0 + e] : T(0);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, long long i0, long long n,
                                      const T (&r)[VEC]) {
  if (i0 + VEC <= n) {
    Pack<T, VEC> q;
#pragma unroll
    for (int e = 0; e < VEC; ++e) q.v[e] = r[e];
    *reinterpret_cast<Pack<T, VEC>*>(p + i0) = q;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (i0 + e < n) p[i0 + e] = r[e];
    }
  }
}

// ---------------------------------------------------------------------------
// S2 krylov_axpy (the vector updates of newton_iter and _gmres)
// ---------------------------------------------------------------------------

template <typename T>
struct AxpyArgs {
  const T *x, *y, *z, *k;
  T* out;  // may be y (the Gram-Schmidt update of w in place)
  unsigned long long* count;
  long long n;
};

template <typename T, int MODE, int VEC>
__global__ void __launch_bounds__(kVecThreads)
    krylov_axpy_kernel(AxpyArgs<T> a) {
  const long long t = index();
  if (t == 0) atomicAdd(a.count, 1ULL);
  const long long i0 = t * VEC;
  if (i0 >= a.n) return;
  T x[VEC], y[VEC], z[VEC], out[VEC];
  load(a.x, i0, a.n, x);
  load(a.y, i0, a.n, y);
  if (MODE == kResidual) load(a.z, i0, a.n, z);
  const T k = *a.k;
  // each entry read before it is written: out may be y
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (MODE == kResidual) {
      out[e] = -((x[e] - k * y[e]) - z[e]);  // -(y - bh f(y) - c0)
    } else if (MODE == kMatvec) {
      out[e] = x[e] - k * y[e];              // v - bh J v
    } else {
      out[e] = (-k) * x[e] + y[e];           // -h_ij v_i + w
    }
  }
  store(a.out, i0, a.n, out);
}

// ---------------------------------------------------------------------------
// S3 krylov_column (_gmres's scalar chains and the vector op each guards)
// ---------------------------------------------------------------------------

// FIRST and COLUMN: v_out = w / safe
template <typename T>
struct ScaleArgs {
  const T *w, *wn, *w0;  // w0 null: FIRST (wn is b.b)
  T* v_out;
  unsigned long long* count;
  double tol;
  long long n;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kVecThreads)
    krylov_column_scale_kernel(ScaleArgs<T> a) {
  const long long t = index();
  if (t == 0) atomicAdd(a.count, 1ULL);
  const long long i0 = t * VEC;
  if (i0 >= a.n) return;
  // the dot products and w in one round trip
  const T dn = *a.wn;
  const T d0 = a.w0 == nullptr ? T(0) : *a.w0;
  T w[VEC];
  load(a.w, i0, a.n, w);
  T norm;
  if (a.w0 == nullptr) {
    norm = sqrt_(dn);  // beta
  } else {
    // |w| after Gram-Schmidt, 0 when it is below tol x |A v_j| (a
    // breakdown)
    const T w0 = sqrt_(d0);
    const T wn = sqrt_(dn);
    norm = wn > T(a.tol) * w0 ? wn : T(0);
  }
  const T safe = norm > T(0) ? norm : T(1);
#pragma unroll
  for (int e = 0; e < VEC; ++e) w[e] = w[e] / safe;
  store(a.v_out, i0, a.n, w);
}

// LAST: the least-squares solve of all m columns, y + dy and the norms'
// terms
template <typename T>
struct LastArgs {
  const T* dots[kMaxDots];
  const T* vs[kMaxM];
  const T *y, *ewt, *y_pred;
  T *y_out, *sq_dy, *sq_err, *scal;  // sq_dy, sq_err null: no norms
  unsigned long long* count;
  double tol;
  long long n;
};

// the dot products of one Newton iteration at Krylov dimension M
template <int M>
constexpr int kDots = 1 + M * (M + 5) / 2;

// the Givens rotations of every column and the back-substitution R ys = g
// from the dot products d, unrolled for M columns: every index is a
// constant, so every array is registers
template <typename T, int M>
__device__ __forceinline__ void least_squares(const T (&d)[kDots<M>],
                                              double tol, T& beta,
                                              T (&ys)[M]) {
  T g[M + 1], R[M][M], cs[M], sn[M];
  beta = sqrt_(d[0]);
  g[0] = beta;
#pragma unroll
  for (int k = 1; k <= M; ++k) g[k] = T(0);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int off = 1 + j * (j + 5) / 2;
    // |w| after Gram-Schmidt in column j, 0 below tol x |A v_j|
    const T w0 = sqrt_(d[off]);
    const T wraw = sqrt_(d[off + j + 2]);
    const T wn = wraw > T(tol) * w0 ? wraw : T(0);
    T hc[M];
#pragma unroll
    for (int i = 0; i <= j; ++i) hc[i] = d[off + 1 + i];
#pragma unroll
    for (int i = 0; i < j; ++i) {  // the previous rotations
      const T tmp = cs[i] * hc[i] + sn[i] * hc[i + 1];
      hc[i + 1] = (-sn[i]) * hc[i] + cs[i] * hc[i + 1];
      hc[i] = tmp;
    }
    const T denom = sqrt_(hc[j] * hc[j] + wn * wn);
    const T dsafe = denom > T(0) ? denom : T(1);
    const T c = denom > T(0) ? hc[j] / dsafe : T(1);
    const T s = denom > T(0) ? wn / dsafe : T(0);
    cs[j] = c;
    sn[j] = s;
    hc[j] = c * hc[j] + s * wn;
    g[j + 1] = (-s) * g[j];
    g[j] = c * g[j];
#pragma unroll
    for (int i = 0; i <= j; ++i) R[j][i] = hc[i];
  }
#pragma unroll
  for (int j = M - 1; j >= 0; --j) {
    T acc = g[j];
#pragma unroll
    for (int k = j + 1; k < M; ++k) acc = acc - R[k][j] * ys[k];
    const T rjj = R[j][j];
    ys[j] = abs_(rjj) > T(0) ? acc / rjj : T(0);
  }
}

template <typename T, int M, int VEC>
__global__ void __launch_bounds__(kVecThreads)
    krylov_column_last_kernel(LastArgs<T> a) {
  const long long t = index();
  if (t == 0) atomicAdd(a.count, 1ULL);
  const long long i0 = t * VEC;
  if (i0 >= a.n) return;  // not thread 0: n >= 1 (column_last)
  const bool norms = a.sq_dy != nullptr;
  // every load first, the chain's dot products ahead of the vectors: one
  // round trip for all, its latency overlapping the chain below (a load
  // left beside its use in the chain would wait a round trip each, the
  // square root's and division's slow-path calls keeping the scheduler
  // from hoisting it)
  T d[kDots<M>];
#pragma unroll
  for (int k = 0; k < kDots<M>; ++k) d[k] = *a.dots[k];
  T v[M][VEC], y[VEC], e[VEC], p[VEC];
#pragma unroll
  for (int j = 0; j < M; ++j) load(a.vs[j], i0, a.n, v[j]);
  load(a.y, i0, a.n, y);
  if (norms) {
    load(a.ewt, i0, a.n, e);
    load(a.y_pred, i0, a.n, p);
  }
  T beta, ys[M];
  least_squares<T, M>(d, a.tol, beta, ys);
  if (t == 0) {
    a.scal[kBeta] = beta;
#pragma unroll
    for (int k = 0; k < M; ++k) a.scal[kYs + k] = ys[k];
  }
  T dy[VEC], yn[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    T x = v[0][q] * ys[0];
#pragma unroll
    for (int j = 1; j < M; ++j) x = ys[j] * v[j][q] + x;
    dy[q] = beta > T(0) ? x : T(0);
    yn[q] = y[q] + dy[q];
  }
  store(a.y_out, i0, a.n, yn);
  if (norms) {
    T sq_dy[VEC], sq_err[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const T pd = dy[q] * e[q];
      sq_dy[q] = pd * pd;
      const T qe = (yn[q] - p[q]) * e[q];
      sq_err[q] = qe * qe;
    }
    store(a.sq_dy, i0, a.n, sq_dy);
    store(a.sq_err, i0, a.n, sq_err);
  }
}

// ---------------------------------------------------------------------------
// S4 bdf_finish (the Newton tail; step_end without the quadrature)
// ---------------------------------------------------------------------------

template <typename T>
struct FinishArgs {
  const T* total;  // the sum of the norm's terms
  T* scal;
  int64_t* it;
  bool *more, *accept;
  T *y, *y_prev, *y_prev2;
  const T* y_new;
  T *t, *h, *h_prev, *h_prev2;
  int64_t *order, *nfe, *nsteps, *nfails, *nnifails, *nni;
  const T* tout;
  const int64_t* nsteps0;
  bool* active;  // null: not written
  unsigned long long* count;
  double inv_n, newton_tol, hmin_bar, h_min, safety, eta_min, eta_max,
      err_floor, tout_eps;
  long long n, max_steps;
  int mode, max_order, krylov_m, history;
};

template <typename T>
__global__ void bdf_finish_kernel(FinishArgs<T> a) {
  const long long i = index();
  if (i == 0) atomicAdd(a.count, 1ULL);
  if (a.mode == kNewton) {
    if (i != 0) return;
    const T dnorm = sqrt_(*a.total * T(a.inv_n));
    a.scal[kDNorm] = dnorm;
    *a.it += 1;
    *a.more = dnorm > T(a.newton_tol);
    return;
  }
  const T h = a.scal[kH];
  const bool conv = a.scal[kDNorm] <= T(a.newton_tol);
  const T err = sqrt_(*a.total * T(a.inv_n)) * T(0.5);
  const bool at_hmin = h <= T(a.hmin_bar);
  const bool accept = (conv && err <= T(1)) || (at_hmin && conv);
  if (i == 0) {
    const int64_t order = *a.order, it = *a.it;
    const T order_p1 = T(order + 1);
    const T inv = recip(clamp_min(err, T(a.err_floor)));
    const T eta =
        T(a.safety) * T(pow(double(inv), double(recip(order_p1))));
    const T h_acc = h * clamp_(eta, T(a.eta_min), T(a.eta_max));
    const T h_rej = conv ? h * clamp_(eta, T(0.1), T(0.5)) : h * T(0.25);
    const T h_next = accept ? h_acc : clamp_min(h_rej, T(a.h_min));
    const int64_t up = order + 1 < a.max_order ? order + 1 : a.max_order;
    const int64_t new_order = accept ? up : (conv ? order : 1);
    const int64_t nfe_n = it * (1 + a.krylov_m) + (a.history ? 0 : 1);
    const T t_old = *a.t, hp = *a.h_prev, hp2 = *a.h_prev2;
    const T t_next = accept ? a.scal[kTNew] : t_old;
    const int64_t nsteps = *a.nsteps + 1;
    *a.t = t_next;
    *a.h = h_next;
    *a.h_prev = accept ? h : hp;
    *a.h_prev2 = accept ? hp : hp2;
    *a.order = new_order;
    *a.nfe += nfe_n;
    *a.nsteps = nsteps;
    *a.nfails += (conv && !accept) ? 1 : 0;
    *a.nnifails += conv ? 0 : 1;
    *a.nni += it;
    *a.accept = accept;
    if (a.active != nullptr) {
      *a.active = t_next < *a.tout - T(a.tout_eps) &&
                  nsteps - *a.nsteps0 < a.max_steps;
    }
  }
  if (i >= a.n) return;
  const T y = a.y[i], yp = a.y_prev[i], yp2 = a.y_prev2[i];
  a.y[i] = accept ? a.y_new[i] : y;
  a.y_prev[i] = accept ? y : yp;
  a.y_prev2[i] = accept ? yp : yp2;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads > 0
                                   ? (n + kThreads - 1) / kThreads
                                   : 1);
}

template <typename T>
int begin(void* const* p, const double* d, const long long* iv,
          cudaStream_t stream) {
  BeginArgs<T> a;
  a.y = static_cast<const T*>(p[0]);
  a.y_prev = static_cast<const T*>(p[1]);
  a.y_prev2 = static_cast<const T*>(p[2]);
  a.fy0 = static_cast<const T*>(p[3]);
  a.t = static_cast<const T*>(p[4]);
  a.h = static_cast<const T*>(p[5]);
  a.h_prev = static_cast<const T*>(p[6]);
  a.h_prev2 = static_cast<const T*>(p[7]);
  a.tout = static_cast<const T*>(p[8]);
  a.order = static_cast<const int64_t*>(p[9]);
  a.ewt = static_cast<T*>(p[10]);
  a.y_pred = static_cast<T*>(p[11]);
  a.c0 = static_cast<T*>(p[12]);
  a.scal = static_cast<T*>(p[13]);
  a.it = static_cast<int64_t*>(p[14]);
  a.count = static_cast<unsigned long long*>(p[15]);
  a.rtol = d[0];
  a.atol = d[1];
  a.h_max = d[2];
  a.h_min = d[3];
  a.n = iv[0];
  a.max_order = static_cast<int>(iv[1]);
  a.history = static_cast<int>(iv[2]);
  bdf_begin_kernel<T><<<blocks_for(a.n), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the grid of S2 and S3: one thread per VEC entries
unsigned vec_blocks(long long n, int vec) {
  const long long threads = (n + vec - 1) / vec;
  const long long blocks = (threads + kVecThreads - 1) / kVecThreads;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

// null or 16-byte aligned: what the wide form's accesses need
bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int MODE>
void launch_axpy(const AxpyArgs<T>& a, int vec, cudaStream_t s) {
  if (vec == 1) {
    krylov_axpy_kernel<T, MODE, 1>
        <<<vec_blocks(a.n, 1), kVecThreads, 0, s>>>(a);
  } else {
    krylov_axpy_kernel<T, MODE, kWide<T>>
        <<<vec_blocks(a.n, kWide<T>), kVecThreads, 0, s>>>(a);
  }
}

template <typename T>
int axpy(int mode, int vec, void* x, void* y, void* z, void* k, void* out,
         void* count, long long n, cudaStream_t s) {
  if ((vec != 1 && vec != kWide<T>) ||
      (vec != 1 && !(aligned(x) && aligned(y) && aligned(z) &&
                     aligned(out)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AxpyArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.y = static_cast<const T*>(y);
  a.z = static_cast<const T*>(z);
  a.k = static_cast<const T*>(k);
  a.out = static_cast<T*>(out);
  a.count = static_cast<unsigned long long*>(count);
  a.n = n;
  switch (mode) {
    case kResidual:
      launch_axpy<T, kResidual>(a, vec, s);
      break;
    case kMatvec:
      launch_axpy<T, kMatvec>(a, vec, s);
      break;
    case kGramSchmidt:
      launch_axpy<T, kGramSchmidt>(a, vec, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int column_scale(int vec, void* w, void* v_out, void* wn, void* w0,
                 double tol, void* count, long long n, cudaStream_t s) {
  if ((vec != 1 && vec != kWide<T>) ||
      (vec != 1 && !(aligned(w) && aligned(v_out)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScaleArgs<T> a;
  a.w = static_cast<const T*>(w);
  a.v_out = static_cast<T*>(v_out);
  a.wn = static_cast<const T*>(wn);
  a.w0 = static_cast<const T*>(w0);
  a.count = static_cast<unsigned long long*>(count);
  a.tol = tol;
  a.n = n;
  if (vec == 1) {
    krylov_column_scale_kernel<T, 1>
        <<<vec_blocks(n, 1), kVecThreads, 0, s>>>(a);
  } else {
    krylov_column_scale_kernel<T, kWide<T>>
        <<<vec_blocks(n, kWide<T>), kVecThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M>
void launch_last(const LastArgs<T>& a, int vec, cudaStream_t s) {
  if (vec == 1) {
    krylov_column_last_kernel<T, M, 1>
        <<<vec_blocks(a.n, 1), kVecThreads, 0, s>>>(a);
  } else {
    krylov_column_last_kernel<T, M, kWide<T>>
        <<<vec_blocks(a.n, kWide<T>), kVecThreads, 0, s>>>(a);
  }
}

template <typename T>
int column_last(int m, int vec, void* const* dots, void* const* p,
                double tol, long long n, cudaStream_t s) {
  if (m < 1 || m > kMaxM || n < 1 || (vec != 1 && vec != kWide<T>)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LastArgs<T> a;
  const int nd = 1 + m * (m + 5) / 2;
  for (int k = 0; k < kMaxDots; ++k) {
    a.dots[k] = k < nd ? static_cast<const T*>(dots[k]) : nullptr;
  }
  bool ok = true;
  for (int k = 0; k < kMaxM; ++k) {
    a.vs[k] = k < m ? static_cast<const T*>(p[k]) : nullptr;
    ok = ok && aligned(a.vs[k]);
  }
  for (int k = kMaxM; k < kMaxM + 6; ++k) ok = ok && aligned(p[k]);
  if (vec != 1 && !ok) return static_cast<int>(cudaErrorInvalidValue);
  a.y = static_cast<const T*>(p[kMaxM]);
  a.ewt = static_cast<const T*>(p[kMaxM + 1]);
  a.y_pred = static_cast<const T*>(p[kMaxM + 2]);
  a.y_out = static_cast<T*>(p[kMaxM + 3]);
  a.sq_dy = static_cast<T*>(p[kMaxM + 4]);
  a.sq_err = static_cast<T*>(p[kMaxM + 5]);
  a.scal = static_cast<T*>(p[kMaxM + 6]);
  a.count = static_cast<unsigned long long*>(p[kMaxM + 7]);
  a.tol = tol;
  a.n = n;
  switch (m) {
    case 1: launch_last<T, 1>(a, vec, s); break;
    case 2: launch_last<T, 2>(a, vec, s); break;
    case 3: launch_last<T, 3>(a, vec, s); break;
    case 4: launch_last<T, 4>(a, vec, s); break;
    case 5: launch_last<T, 5>(a, vec, s); break;
    case 6: launch_last<T, 6>(a, vec, s); break;
    case 7: launch_last<T, 7>(a, vec, s); break;
    default: launch_last<T, 8>(a, vec, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finish(int mode, void* const* p, const double* d, const long long* iv,
           cudaStream_t stream) {
  FinishArgs<T> a;
  a.total = static_cast<const T*>(p[0]);
  a.scal = static_cast<T*>(p[1]);
  a.it = static_cast<int64_t*>(p[2]);
  a.more = static_cast<bool*>(p[3]);
  a.accept = static_cast<bool*>(p[4]);
  a.y = static_cast<T*>(p[5]);
  a.y_prev = static_cast<T*>(p[6]);
  a.y_prev2 = static_cast<T*>(p[7]);
  a.y_new = static_cast<const T*>(p[8]);
  a.t = static_cast<T*>(p[9]);
  a.h = static_cast<T*>(p[10]);
  a.h_prev = static_cast<T*>(p[11]);
  a.h_prev2 = static_cast<T*>(p[12]);
  a.order = static_cast<int64_t*>(p[13]);
  a.nfe = static_cast<int64_t*>(p[14]);
  a.nsteps = static_cast<int64_t*>(p[15]);
  a.nfails = static_cast<int64_t*>(p[16]);
  a.nnifails = static_cast<int64_t*>(p[17]);
  a.nni = static_cast<int64_t*>(p[18]);
  a.tout = static_cast<const T*>(p[19]);
  a.nsteps0 = static_cast<const int64_t*>(p[20]);
  a.active = static_cast<bool*>(p[21]);
  a.count = static_cast<unsigned long long*>(p[22]);
  a.inv_n = d[0];
  a.newton_tol = d[1];
  a.hmin_bar = d[2];
  a.h_min = d[3];
  a.safety = d[4];
  a.eta_min = d[5];
  a.eta_max = d[6];
  a.err_floor = d[7];
  a.tout_eps = d[8];
  a.n = iv[0];
  a.max_steps = iv[1];
  a.max_order = static_cast<int>(iv[2]);
  a.krylov_m = static_cast<int>(iv[3]);
  a.history = static_cast<int>(iv[4]);
  a.mode = mode;
  const unsigned grid = mode == kNewton ? 1u : blocks_for(a.n);
  bdf_finish_kernel<T><<<grid, mode == kNewton ? 1 : kThreads, 0, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// *f64*: 1 for float64 states, 0 for float32.  The pointer and parameter
// layouts are solver/kernels.py's.

int shud_bdf_begin(int f64, void* const* ptrs, const double* params,
                   const long long* iparams, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? begin<double>(ptrs, params, iparams, s)
             : begin<float>(ptrs, params, iparams, s);
}

// *vec*: the entries a thread, 1 or 16 / sizeof(T) (every pointer then
// 16-byte aligned, else cudaErrorInvalidValue).  z is null but for the
// residual.
int shud_krylov_axpy(int f64, int mode, int vec, void* x, void* y, void* z,
                     void* k, void* out, void* count, long long n,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? axpy<double>(mode, vec, x, y, z, k, out, count, n, s)
             : axpy<float>(mode, vec, x, y, z, k, out, count, n, s);
}

// FIRST (w0 null: v_out = w / sqrt(wn)) and COLUMN (v_out = w / |w|, wn
// and w0 the dot products of w after and before Gram-Schmidt)
int shud_krylov_column_scale(int f64, int vec, void* w, void* v_out,
                             void* wn, void* w0, double tol, void* count,
                             long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? column_scale<double>(vec, w, v_out, wn, w0, tol, count, n, s)
             : column_scale<float>(vec, w, v_out, wn, w0, tol, count, n, s);
}

// LAST: *dots* the 1 + m (m + 5) / 2 dot products of the iteration;
// *ptrs* vs[0..kMaxM), y, ewt, y_pred, y_out, sq_dy, sq_err (both null:
// no norms), scal, count
int shud_krylov_column_last(int f64, int m, int vec, void* const* dots,
                            void* const* ptrs, double tol, long long n,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? column_last<double>(m, vec, dots, ptrs, tol, n, s)
             : column_last<float>(m, vec, dots, ptrs, tol, n, s);
}

int shud_bdf_finish(int f64, int mode, void* const* ptrs,
                    const double* params, const long long* iparams,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? finish<double>(mode, ptrs, params, iparams, s)
             : finish<float>(mode, ptrs, params, iparams, s);
}

}  // extern "C"
