// The 2D Cartesian Euler operators (x-z slice, rigid walls on all four
// sides): the DFR right-hand side or an RK stage, its Jacobian action, the
// first-order finite-volume right-hand side and its Jacobian action.
//
// Replaces no TPU kernel: the JAX package computes these functions in XLA
// (wxfactory_tpu/models/euler_cartesian.py:115-186, make_rhs_euler_cartesian;
// models/euler_cartesian_fv.py:64-92, make_rhs_euler_cartesian_fv; and
// jax.jvp of each for its integrators' and multigrid levels' Jacobian
// action). They were added because the port's card path runs hand-written
// kernels only. The plain torch versions of the same functions are
// wxfactory_tpu_torch/ops/euler_cartesian_operator.py::euler_cartesian_plain,
// euler_cartesian_tangent_plain, euler_cartesian_fv_plain and
// euler_cartesian_fv_tangent_plain; the wrappers there launch these kernels.
//
// What they compute (state (4, nel_z, nel_x, s^2) = rho, rho*u, rho*w,
// rho*theta, node kz*s + kx; FV (4, ncell_z, ncell_x)):
//   DFR: extrapolate the state to the four faces of every element (linear,
//   the 1D factors of the JAX package's EE), the pointwise fluxes (pressure
//   P0 exp(gamma log(Rd/P0 rho*theta))) and their divergence with -2/dx and
//   -2/dz folded into the 1D derivative (DD), the AUSM flux at interior
//   interfaces (the normal momentum row carries the pressure term only, as
//   euler_cartesian.py:62-102 has it) and the pressure-only wall flux on
//   the boundary, the boundary correction (CC), gravity -rho g on rho*w.
//   A stage returns a*x + b*q + cdt*RHS(q) (x read only when given).
//   FV: the selected flux (ausm with the advected normal momentum, rusanov,
//   upwind; euler_cartesian_fv.py:29-61) between cell states, pressure-only
//   walls, -(dF_x)/dx - (dF_z)/dz, gravity. The multigrid's coarse levels
//   take only its Jacobian action; the RHS serves the FV model's own calls.
//   Tangent: the same element (cell) body instantiated over a dual number
//   (value, tangent), so one launch reads q and v and writes J(q).v. At the
//   ties the dual follows jax.jvp: maximum(0, m) and minimum(0, m) at m = 0
//   carry half the tangent, rusanov's maximum of two equal speeds half of
//   each, |v| at v = 0 the tangent itself (select(v >= 0, dv, -dv)), and
//   upwind's where(vsum > 0) the selected side's.
//
// Design: one thread a node (a cell for FV); a DFR block owns
// EB = 128 / s^2 elements. An RHS call or a stage is one launch with no
// trace buffer and no glue: each element extrapolates its own faces from
// its state in shared memory and its x and z neighbours' faces from their
// state in device memory, with the same explicit fma sequence (line_trace),
// so the two elements of an interface form the AUSM flux from bit-identical
// inputs at one call site and the flux divergence loses no rho or
// rho*theta across an interface; the walls carry no mass or rho*theta flux.
// The FV cell computes its four faces' fluxes, each from its own and its
// neighbour's state, likewise.
//
// What bounds them (NVIDIA H100 SXM, 3.35 TB/s; float64, 256 x 64 elements,
// s = 4, 262,144 nodes): an RHS call must read q (8.4 MB) and write the
// output (8.4 MB): 5.0 us; a stage with x also reads x (7.5 us); the
// tangent reads q and v and writes J.v (7.5 us). Their operations (~0.1
// GFLOP) take ~3 us at the 34 TFLOP/s f64 vector peak: bytes bound them.
// The DFR kernel re-reads the neighbours' face lines from device memory (s
// loads a trace row, L2-resident) and recomputes each interface's flux on
// both sides. A first kernel, right and simple; kernels/check.py::
// euler_cartesian_work counts the functions' bytes and operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // a DFR block's threads (EB elements of s^2 nodes)
constexpr int kFvThreads = 256;
constexpr double kGravity = 9.80616;
constexpr double kP0 = 100000.0;
constexpr double kRd = 287.05;
constexpr double kCpd = 1005.46;
constexpr double kCvd = kCpd - kRd;
constexpr double kGamma = kCpd / kCvd;
constexpr double kRdP0 = kRd / kP0;

// ---------------------------------------------------------------------------
// Scalars and the dual number

template <typename T>
struct Dual {
  T v, d;
  Dual() = default;
  __device__ __forceinline__ Dual(T v_, T d_) : v(v_), d(d_) {}
  __device__ __forceinline__ explicit Dual(T v_) : v(v_), d(T(0)) {}
};

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float texp(float v) { return expf(v); }
__device__ __forceinline__ double texp(double v) { return exp(v); }
__device__ __forceinline__ float tlog(float v) { return logf(v); }
__device__ __forceinline__ double tlog(double v) { return log(v); }
__device__ __forceinline__ float tsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double tsqrt(double v) { return sqrt(v); }

template <typename T>
__device__ __forceinline__ Dual<T> fmadd(Dual<T> a, T c, Dual<T> acc) {
  return Dual<T>(fmadd(a.v, c, acc.v), fmadd(a.d, c, acc.d));
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return Dual<T>(a.v + b.v, a.d + b.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return Dual<T>(a.v - b.v, a.d - b.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return Dual<T>(-a.v, -a.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) { return Dual<T>(a.v * b.v, a.d * b.v + a.v * b.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return Dual<T>(q, (a.d - q * b.d) / b.v);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T c) { return Dual<T>(a.v + c, a.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T c, Dual<T> a) { return Dual<T>(c + a.v, a.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T c) { return Dual<T>(a.v - c, a.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T c, Dual<T> a) { return Dual<T>(c - a.v, -a.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T c) { return Dual<T>(a.v * c, a.d * c); }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T c, Dual<T> a) { return Dual<T>(c * a.v, c * a.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T c) { return Dual<T>(a.v / c, a.d / c); }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(T c, Dual<T> a) {
  const T q = c / a.v;
  return Dual<T>(q, -(q * a.d) / a.v);
}
template <typename T>
__device__ __forceinline__ Dual<T> texp(Dual<T> a) {
  const T e = texp(a.v);
  return Dual<T>(e, a.d * e);
}
template <typename T>
__device__ __forceinline__ Dual<T> tlog(Dual<T> a) { return Dual<T>(tlog(a.v), a.d / a.v); }
template <typename T>
__device__ __forceinline__ Dual<T> tsqrt(Dual<T> a) {
  const T r = tsqrt(a.v);
  return Dual<T>(r, a.d * (T(0.5) / r));
}

// The ties, by jax.jvp's rules: maximum(0, m) / minimum(0, m) carry half the
// tangent at m = 0; maximum(a, b) half of each at a = b; |v| the tangent
// itself at v = 0.
template <typename T>
__device__ __forceinline__ T max0(T m) { return m > T(0) ? m : T(0); }
template <typename T>
__device__ __forceinline__ T min0(T m) { return m < T(0) ? m : T(0); }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a >= T(0) ? a : -a; }
template <typename T>
__device__ __forceinline__ Dual<T> max0(Dual<T> m) {
  if (m.v > T(0)) return m;
  return Dual<T>(T(0), m.v == T(0) ? T(0.5) * m.d : T(0));
}
template <typename T>
__device__ __forceinline__ Dual<T> min0(Dual<T> m) {
  if (m.v < T(0)) return m;
  return Dual<T>(T(0), m.v == T(0) ? T(0.5) * m.d : T(0));
}
template <typename T>
__device__ __forceinline__ Dual<T> tmax(Dual<T> a, Dual<T> b) {
  if (a.v > b.v) return a;
  if (a.v < b.v) return b;
  return Dual<T>(a.v, T(0.5) * (a.d + b.d));
}
template <typename T>
__device__ __forceinline__ Dual<T> tabs(Dual<T> a) { return a.v >= T(0) ? a : -a; }

// The base type, loads, the stored part and the value of a number: a plain
// scalar, or a dual whose value comes from q and tangent from v and whose
// tangent is stored.
template <typename N>
struct Num {
  using T = N;
  __device__ __forceinline__ static N ld(const T* q, const T*, long long i) { return q[i]; }
  __device__ __forceinline__ static T out(N x) { return x; }
  __device__ __forceinline__ static T value(N x) { return x; }
};
template <typename T_>
struct Num<Dual<T_>> {
  using T = T_;
  __device__ __forceinline__ static Dual<T> ld(const T* q, const T* v, long long i) { return Dual<T>(q[i], v[i]); }
  __device__ __forceinline__ static T out(Dual<T> x) { return x.d; }
  __device__ __forceinline__ static T value(Dual<T> x) { return x.v; }
};

// ---------------------------------------------------------------------------
// The physics (wxfactory_tpu/models/euler_cartesian.py and _fv.py)

template <typename N>
__device__ __forceinline__ N pressure(N rho_theta) {
  using T = typename Num<N>::T;
  return T(kP0) * texp(T(kGamma) * tlog(T(kRdP0) * rho_theta));
}

// The DFR model's AUSM flux between face states L and R; dir 0 = x, 1 = z.
template <typename N>
__device__ __forceinline__ void ausm_flux(const N (&L)[4], const N (&R)[4], int dir, N (&f)[4]) {
  using T = typename Num<N>::T;
  const N inv_l = T(1) / L[0];
  const N inv_r = T(1) / R[0];
  const N p_l = pressure(L[3]);
  const N p_r = pressure(R[3]);
  const N a_l = tsqrt(T(kGamma) * p_l * inv_l);
  const N a_r = tsqrt(T(kGamma) * p_r * inv_r);
  const N vn_l = L[1 + dir] * inv_l;
  const N vn_r = R[1 + dir] * inv_r;
  const N m_l = vn_l / a_l + T(1);
  const N m_r = vn_r / a_r - T(1);
  const N m = T(0.25) * (m_l * m_l - m_r * m_r);
  const N m_max = max0(m) * a_l;
  const N m_min = min0(m) * a_r;
  const N p_half = T(0.5) * (m_l * p_l - m_r * p_r);
  f[0] = L[0] * m_max + R[0] * m_min;
  f[3] = L[3] * m_max + R[3] * m_min;
  f[1 + dir] = p_half;
  f[2 - dir] = L[2 - dir] * m_max + R[2 - dir] * m_min;
}

// The rigid wall: the face's pressure in the normal momentum row only.
template <typename N>
__device__ __forceinline__ void wall_flux(const N (&Q)[4], int dir, N (&f)[4]) {
  using T = typename Num<N>::T;
  const N zero(T(0));
  f[0] = zero;
  f[3] = zero;
  f[1 + dir] = pressure(Q[3]);
  f[2 - dir] = zero;
}

constexpr int kAusm = 0, kRusanov = 1, kUpwind = 2;

// The FV model's fluxes between cell states L and R with their pressures;
// n = 1 (x, rho*u) or 2 (z, rho*w).
template <typename N, int FLUX>
__device__ __forceinline__ void fv_flux(const N (&L)[4], const N (&R)[4], N pl, N pr, int n, N (&f)[4]) {
  using T = typename Num<N>::T;
  if (FLUX == kAusm) {
    const N al = tsqrt(T(kGamma) * pl / L[0]);
    const N ar = tsqrt(T(kGamma) * pr / R[0]);
    const N ml = L[n] / (L[0] * al);
    const N mr = R[n] / (R[0] * ar);
    const N mp = ml + T(1);
    const N mm = mr - T(1);
    const N m = T(0.25) * (mp * mp - mm * mm);
    const N mx = max0(m);
    const N mn = min0(m);
#pragma unroll
    for (int v = 0; v < 4; ++v) f[v] = L[v] * mx * al + R[v] * mn * ar;
    f[n] = f[n] + T(0.5) * ((T(1) + ml) * pl + (T(1) - mr) * pr);
  } else if (FLUX == kRusanov) {
    const N al = tsqrt(T(kGamma) * pl / L[0]);
    const N ar = tsqrt(T(kGamma) * pr / R[0]);
    const N vl = L[n] / L[0];
    const N vr = R[n] / R[0];
    const N eig = tmax(tabs(vl) + al, tabs(vr) + ar);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      N fl = L[v] * vl;
      N fr = R[v] * vr;
      if (v == n) {
        fl = fl + pl;
        fr = fr + pr;
      }
      f[v] = T(0.5) * (fl + fr - eig * (R[v] - L[v]));
    }
  } else {
    const N vsum = L[n] + R[n];
    const bool left = Num<N>::value(vsum) > T(0);
    const N vl = L[n] / L[0];
    const N vr = R[n] / R[0];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      N fl = L[v] * vl;
      N fr = R[v] * vr;
      if (v == n) {
        fl = fl + pl;
        fr = fr + pr;
      }
      f[v] = left ? fl : fr;
    }
  }
}

// ---------------------------------------------------------------------------
// The DFR element body

// ops1d: en (s) | ep (s) | Dx (s, s) | Dz (s, s) | cxn (s) | cxp (s) | czn (s) | czp (s)
template <int S>
struct Plan {
  static constexpr int S2 = S * S;
  static constexpr int EN = 0, EP = S, DX = 2 * S, DZ = 2 * S + S2, CXN = 2 * S + 2 * S2, CXP = CXN + S,
                       CZN = CXP + S, CZP = CZN + S, N_OPS = CZP + S;
  static constexpr int EB = kThreads / S2 > 0 ? kThreads / S2 : 1;  // elements a block
  static constexpr int PER_ELEM = 12 * S2 + 16 * S;                  // state, fluxes, face fluxes (numbers)
  template <typename N>
  static constexpr size_t smem() {
    using T = typename Num<N>::T;
    return (N_OPS * sizeof(T) + 15) / 16 * 16 + (size_t)EB * PER_ELEM * sizeof(N);
  }
};

// The trace at one face point of the line vals[0..S): one fixed fma
// sequence, whichever element computes it.
template <typename N, int S>
__device__ __forceinline__ N line_trace(const N (&vals)[S], const typename Num<N>::T* coef) {
  using T = typename Num<N>::T;
  N acc(T(0));
#pragma unroll
  for (int i = 0; i < S; ++i) acc = fmadd(vals[i], coef[i], acc);
  return acc;
}

// One element a group of s^2 threads: q (and, for a dual, v) in, the RHS,
// the stage or J.v out. Faces: 0 west, 1 east, 2 bottom, 3 top; face point k
// is kz on an x face and kx on a z face.
template <typename N, int S>
__device__ __forceinline__ void element_body(const typename Num<N>::T* __restrict__ q,
                                             const typename Num<N>::T* __restrict__ dv,
                                             const typename Num<N>::T* __restrict__ ops,
                                             const typename Num<N>::T* __restrict__ x,
                                             typename Num<N>::T* __restrict__ out, int nx, int nz,
                                             typename Num<N>::T a, typename Num<N>::T b,
                                             typename Num<N>::T cdt, int stage) {
  using T = typename Num<N>::T;
  using P = Plan<S>;
  constexpr int S2 = P::S2;
  extern __shared__ unsigned char smem_raw[];
  T* sOps = reinterpret_cast<T*>(smem_raw);
  N* sElem = reinterpret_cast<N*>(smem_raw + (P::N_OPS * sizeof(T) + 15) / 16 * 16);

  const int tid = threadIdx.x;
  const int le = tid / S2;
  const int j = tid - le * S2;
  const long long nel = (long long)nx * nz;
  const long long e = (long long)blockIdx.x * P::EB + le;
  const bool valid = e < nel;
  const long long nq = nel * S2;  // a variable's row

  for (int i = tid; i < P::N_OPS; i += blockDim.x) sOps[i] = ops[i];
  N* sQ = sElem + le * P::PER_ELEM;  // (4, S2)
  N* sF = sQ + 4 * S2;               // (8, S2): F_x rows, then F_z rows
  N* sFl = sF + 8 * S2;              // (4 faces, 4, S)
  if (valid) {
#pragma unroll
    for (int v = 0; v < 4; ++v) sQ[v * S2 + j] = Num<N>::ld(q, dv, v * nq + e * S2 + j);
  }
  __syncthreads();

  const int ex = valid ? (int)(e % nx) : 0;
  const int ez = valid ? (int)(e / nx) : 0;
  if (valid) {
    // Pointwise fluxes at node j.
    const N rho = sQ[j], ru = sQ[S2 + j], rw = sQ[2 * S2 + j], rt = sQ[3 * S2 + j];
    const N inv = T(1) / rho;
    const N u = ru * inv;
    const N w = rw * inv;
    const N p = pressure(rt);
    sF[0 * S2 + j] = ru;
    sF[1 * S2 + j] = ru * u + p;
    sF[2 * S2 + j] = ru * w;
    sF[3 * S2 + j] = rt * u;
    sF[4 * S2 + j] = rw;
    sF[5 * S2 + j] = rw * u;
    sF[6 * S2 + j] = rw * w + p;
    sF[7 * S2 + j] = rt * w;

    // Interface and wall fluxes at the element's 4s face points.
    for (int fp = j; fp < 4 * S; fp += S2) {
      const int face = fp / S;
      const int k = fp - face * S;
      const int dir = face >> 1;
      const bool pos = face & 1;
      const int base = dir == 0 ? k * S : k;
      const int stride = dir == 0 ? 1 : S;
      const int nbx = dir == 0 ? ex + (pos ? 1 : -1) : ex;
      const int nbz = dir == 1 ? ez + (pos ? 1 : -1) : ez;
      const bool interior = nbx >= 0 && nbx < nx && nbz >= 0 && nbz < nz;
      N own[4], nb[4], vals[S], flux[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
#pragma unroll
        for (int i = 0; i < S; ++i) vals[i] = sQ[v * S2 + base + i * stride];
        own[v] = line_trace<N, S>(vals, sOps + (pos ? P::EP : P::EN));
      }
      if (interior) {
        const long long enb = (long long)nbz * nx + nbx;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
#pragma unroll
          for (int i = 0; i < S; ++i) vals[i] = Num<N>::ld(q, dv, v * nq + enb * S2 + base + i * stride);
          nb[v] = line_trace<N, S>(vals, sOps + (pos ? P::EN : P::EP));
        }
        N L[4], R[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          L[v] = pos ? own[v] : nb[v];
          R[v] = pos ? nb[v] : own[v];
        }
        ausm_flux(L, R, dir, flux);
      } else {
        wall_flux(own, dir, flux);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) sFl[(face * 4 + v) * S + k] = flux[v];
    }
  }
  __syncthreads();
  if (!valid) return;

  // Divergence, boundary correction, gravity; the stage combination.
  const int kz = j / S;
  const int kx = j - kz * S;
  const T* Dx = sOps + P::DX + kx * S;
  const T* Dz = sOps + P::DZ + kz * S;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    N acc(T(0));
#pragma unroll
    for (int i = 0; i < S; ++i) acc = fmadd(sF[v * S2 + kz * S + i], Dx[i], acc);
#pragma unroll
    for (int i = 0; i < S; ++i) acc = fmadd(sF[(4 + v) * S2 + i * S + kx], Dz[i], acc);
    acc = fmadd(sFl[(0 * 4 + v) * S + kz], sOps[P::CXN + kx], acc);
    acc = fmadd(sFl[(1 * 4 + v) * S + kz], sOps[P::CXP + kx], acc);
    acc = fmadd(sFl[(2 * 4 + v) * S + kx], sOps[P::CZN + kz], acc);
    acc = fmadd(sFl[(3 * 4 + v) * S + kx], sOps[P::CZP + kz], acc);
    if (v == 2) acc = acc + (-sQ[j]) * T(kGravity);
    T val = Num<N>::out(acc);
    const long long o = v * nq + e * S2 + j;
    if (stage) {
      val = b * q[o] + cdt * val;
      if (x != nullptr) val = a * x[o] + val;
    }
    out[o] = val;
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads) euler_cartesian_operator_kernel(
    const T* __restrict__ q, const T* __restrict__ ops, const T* __restrict__ x, T* __restrict__ out, int nx, int nz,
    T a, T b, T cdt, int stage) {
  element_body<T, S>(q, nullptr, ops, x, out, nx, nz, a, b, cdt, stage);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads) euler_cartesian_tangent_kernel(
    const T* __restrict__ q, const T* __restrict__ v, const T* __restrict__ ops, T* __restrict__ out, int nx, int nz) {
  element_body<Dual<T>, S>(q, v, ops, nullptr, out, nx, nz, T(0), T(1), T(0), 0);
}

// ---------------------------------------------------------------------------
// The FV cell body: one thread a cell; faces 0 west, 1 east, 2 bottom, 3 top.

template <typename N, int FLUX>
__device__ __forceinline__ void cell_body(const typename Num<N>::T* __restrict__ q,
                                          const typename Num<N>::T* __restrict__ dv,
                                          typename Num<N>::T* __restrict__ out, int nx, int nz,
                                          typename Num<N>::T dx, typename Num<N>::T dz) {
  using T = typename Num<N>::T;
  const long long ncell = (long long)nx * nz;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const int cx = (int)(c % nx);
  const int cz = (int)(c / nx);
  N own[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) own[v] = Num<N>::ld(q, dv, v * ncell + c);
  N faces[4][4];
  for (int face = 0; face < 4; ++face) {
    const int dir = face >> 1;
    const bool pos = face & 1;
    const int nbx = dir == 0 ? cx + (pos ? 1 : -1) : cx;
    const int nbz = dir == 1 ? cz + (pos ? 1 : -1) : cz;
    N f[4];
    if (nbx >= 0 && nbx < nx && nbz >= 0 && nbz < nz) {
      const long long cn = (long long)nbz * nx + nbx;
      N nb[4], L[4], R[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) nb[v] = Num<N>::ld(q, dv, v * ncell + cn);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        L[v] = pos ? own[v] : nb[v];
        R[v] = pos ? nb[v] : own[v];
      }
      fv_flux<N, FLUX>(L, R, pressure(L[3]), pressure(R[3]), 1 + dir, f);
    } else {
      wall_flux(own, dir, f);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) faces[face][v] = f[v];
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    N r = (-(faces[1][v] - faces[0][v])) / dx - (faces[3][v] - faces[2][v]) / dz;
    if (v == 2) r = r + (-own[0]) * T(kGravity);
    out[v * ncell + c] = Num<N>::out(r);
  }
}

template <typename T, int FLUX>
__global__ void __launch_bounds__(kFvThreads) euler_cartesian_fv_kernel(const T* __restrict__ q,
                                                                       T* __restrict__ out, int nx, int nz, T dx,
                                                                       T dz) {
  cell_body<T, FLUX>(q, nullptr, out, nx, nz, dx, dz);
}

template <typename T, int FLUX>
__global__ void __launch_bounds__(kFvThreads) euler_cartesian_fv_tangent_kernel(
    const T* __restrict__ q, const T* __restrict__ v, T* __restrict__ out, int nx, int nz, T dx, T dz) {
  cell_body<Dual<T>, FLUX>(q, v, out, nx, nz, dx, dz);
}

// ---------------------------------------------------------------------------
// Launches

template <typename T, int S>
cudaError_t launch_dfr(int nx, int nz, const void* q, const void* v, const void* ops, const void* x, void* out,
                       double a, double b, double cdt, int stage, cudaStream_t stream) {
  using P = Plan<S>;
  const unsigned blocks = (unsigned)(((long long)nx * nz + P::EB - 1) / P::EB);
  if (v == nullptr) {
    euler_cartesian_operator_kernel<T, S><<<blocks, P::EB * P::S2, P::template smem<T>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(ops), static_cast<const T*>(x), static_cast<T*>(out), nx, nz,
        T(a), T(b), T(cdt), stage);
  } else {
    euler_cartesian_tangent_kernel<T, S><<<blocks, P::EB * P::S2, P::template smem<Dual<T>>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(ops), static_cast<T*>(out), nx, nz);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dfr(int s, int nx, int nz, const void* q, const void* v, const void* ops, const void* x,
                         void* out, double a, double b, double cdt, int stage, cudaStream_t stream) {
  switch (s) {
    case 2: return launch_dfr<T, 2>(nx, nz, q, v, ops, x, out, a, b, cdt, stage, stream);
    case 3: return launch_dfr<T, 3>(nx, nz, q, v, ops, x, out, a, b, cdt, stage, stream);
    case 4: return launch_dfr<T, 4>(nx, nz, q, v, ops, x, out, a, b, cdt, stage, stream);
    case 5: return launch_dfr<T, 5>(nx, nz, q, v, ops, x, out, a, b, cdt, stage, stream);
    case 6: return launch_dfr<T, 6>(nx, nz, q, v, ops, x, out, a, b, cdt, stage, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int FLUX>
cudaError_t launch_fv(int nx, int nz, const void* q, const void* v, void* out, double dx, double dz,
                      cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((long long)nx * nz + kFvThreads - 1) / kFvThreads);
  if (v == nullptr) {
    euler_cartesian_fv_kernel<T, FLUX><<<blocks, kFvThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<T*>(out), nx, nz, T(dx), T(dz));
  } else {
    euler_cartesian_fv_tangent_kernel<T, FLUX><<<blocks, kFvThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(v), static_cast<T*>(out), nx, nz, T(dx), T(dz));
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fv(int flux, int nx, int nz, const void* q, const void* v, void* out, double dx, double dz,
                        cudaStream_t stream) {
  switch (flux) {
    case kAusm: return launch_fv<T, kAusm>(nx, nz, q, v, out, dx, dz, stream);
    case kRusanov: return launch_fv<T, kRusanov>(nx, nz, q, v, out, dx, dz, stream);
    case kUpwind: return launch_fv<T, kUpwind>(nx, nz, q, v, out, dx, dz, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Kernel>
cudaError_t kernel_resources(Kernel kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  info[4] = threads;
  return err;
}

template <typename T, int S>
cudaError_t dfr_resources(int kernel, int* info) {
  using P = Plan<S>;
  if (kernel == 0)
    return kernel_resources(euler_cartesian_operator_kernel<T, S>, P::EB * P::S2, P::template smem<T>(), info);
  return kernel_resources(euler_cartesian_tangent_kernel<T, S>, P::EB * P::S2, P::template smem<Dual<T>>(), info);
}

template <typename T, int FLUX>
cudaError_t fv_resources(int kernel, int* info) {
  if (kernel == 2) return kernel_resources(euler_cartesian_fv_kernel<T, FLUX>, kFvThreads, 0, info);
  return kernel_resources(euler_cartesian_fv_tangent_kernel<T, FLUX>, kFvThreads, 0, info);
}

template <typename T>
cudaError_t dispatch_resources(int s, int kernel, int* info) {
  if (kernel == 0 || kernel == 1) {
    switch (s) {
      case 2: return dfr_resources<T, 2>(kernel, info);
      case 3: return dfr_resources<T, 3>(kernel, info);
      case 4: return dfr_resources<T, 4>(kernel, info);
      case 5: return dfr_resources<T, 5>(kernel, info);
      case 6: return dfr_resources<T, 6>(kernel, info);
      default: return cudaErrorInvalidValue;
    }
  }
  if (kernel != 2 && kernel != 3) return cudaErrorInvalidValue;
  switch (s) {
    case kAusm: return fv_resources<T, kAusm>(kernel, info);
    case kRusanov: return fv_resources<T, kRusanov>(kernel, info);
    case kUpwind: return fv_resources<T, kUpwind>(kernel, info);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* euler_cartesian_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The DFR RHS (stage == 0) or the stage a*x + b*q + cdt*RHS(q) (x == NULL:
// no x term) of q (4, nz, nx, s^2), s = 2..6. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int euler_cartesian_launch(int is_f64, int s, int nx, int nz, const void* q, const void* ops,
                                      const void* x, void* out, double a, double b, double cdt, int stage,
                                      void* stream) {
  if (nx < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? dispatch_dfr<double>(s, nx, nz, q, nullptr, ops, x, out, a, b, cdt, stage, st)
                      : dispatch_dfr<float>(s, nx, nz, q, nullptr, ops, x, out, a, b, cdt, stage, st));
}

// J(q).v of the DFR RHS, one launch.
extern "C" int euler_cartesian_tangent_launch(int is_f64, int s, int nx, int nz, const void* q, const void* v,
                                              const void* ops, void* out, void* stream) {
  if (nx < 1 || nz < 1 || v == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? dispatch_dfr<double>(s, nx, nz, q, v, ops, nullptr, out, 0.0, 1.0, 0.0, 0, st)
                      : dispatch_dfr<float>(s, nx, nz, q, v, ops, nullptr, out, 0.0, 1.0, 0.0, 0, st));
}

// The FV RHS of q (4, nz, nx) with flux 0 ausm, 1 rusanov, 2 upwind.
extern "C" int euler_cartesian_fv_launch(int is_f64, int flux, int nx, int nz, const void* q, void* out, double dx,
                                         double dz, void* stream) {
  if (nx < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? dispatch_fv<double>(flux, nx, nz, q, nullptr, out, dx, dz, st)
                      : dispatch_fv<float>(flux, nx, nz, q, nullptr, out, dx, dz, st));
}

// J(q).v of the FV RHS, one launch.
extern "C" int euler_cartesian_fv_tangent_launch(int is_f64, int flux, int nx, int nz, const void* q, const void* v,
                                                 void* out, double dx, double dz, void* stream) {
  if (nx < 1 || nz < 1 || v == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? dispatch_fv<double>(flux, nx, nz, q, v, out, dx, dz, st)
                      : dispatch_fv<float>(flux, nx, nz, q, v, out, dx, dz, st));
}

// What the runtime reports of a kernel (kernel 0: the DFR operator, 1: its
// tangent, at s; 2: the FV operator, 3: its tangent, with flux s): info =
// [registers, local (spill) bytes a thread, dynamic shared memory bytes a
// block, resident blocks an SM, threads a block].
extern "C" int euler_cartesian_resources(int is_f64, int s, int kernel, int* info) {
  return (int)(is_f64 ? dispatch_resources<double>(s, kernel, info) : dispatch_resources<float>(s, kernel, info));
}
