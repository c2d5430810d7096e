// 3D Euler DFR spatial operator on the cubed sphere, one launch per call.
//
// Replaces the TPU kernel wxfactory_tpu/ops/pallas_euler3d.py:2131 (km3_fused,
// body _km3_body) in its absolute form: the RHS, optionally plus the
// well-balanced offset bal, optionally fused with the RK stage combination
// a*x + b*q + cdt*(RHS(q) + bal), optionally emitting the output's panel-edge
// traces for the next stage's halo. It computes what the JAX package's
// models/euler_cubesphere.py:90-291 (_euler3d_rhs_core) computes. The plain
// torch version of the same function is wxfactory_tpu_torch/ops/
// euler3d_operator.py::euler3d_operator_plain; the wrapper euler3d_operator
// there launches this kernel.
//
// Layouts (C order, T = float or double; nh = nel_h, nk = nel_v):
//   q, x, bal, out  (5, 6*nk*nh*nh, s^3)   element (panel, ez, ey, ex),
//                                          node (kz*s + ky)*s + kx
//   halo, traces    (5, 4, 6, nk, nh, s^2) sides (S, N, W, E), face point
//                                          kz*s + k_along
//   ops1d           en (s) | ep (s) | cn (s) | cp (s) | D (s, s) | HF (s, s):
//                   1D extrapolation to x=-1/+1, boundary-correction columns,
//                   derivative D[j][i], highest-mode filter HF[j][i]
//   fields          (28, nk*nh*nh, s^3) one panel's metric (the same on all
//                   six): sqrt(g), 1/sqrt(g), 1/(dz/deta), h00 h01 h02 h11 h12
//                   h22, Gamma^a_{bc} (a*6 + [11 12 13 22 23 33]), wpres_int
//   tch             (9, 6*nk*nh*nh, s^3) Gamma^a_{0b} (a*3 + b), or NULL when
//                   the planet does not rotate
//   itf_x           (4, nk, nh, nh+1, s^2) [sqrt(g), h^{1k}] at x interfaces
//   itf_y           (4, nk, nh+1, nh, s^2) [sqrt(g), h^{2k}] at y interfaces
//   itf_z           (4, nk+1, nh, nh, s^2) [sqrt(g), h^{3k}] at z interfaces
//
// Design: one thread per solution point, EB = 256 / s^3 elements per block
// (s=6: one element of 216 threads); a block's elements share (ez, ey, ex)
// ranges with the five blocks next to it (the panel is the fastest block
// index), so the one-panel metric is read from device memory about once and
// from L2 by the other five panels. The 3D operators are never formed: the
// 1D operators act along one axis at a time, so shared memory holds the
// element's state, logs, fluxes and face data (24 s^3 + 42 s^2 numbers an
// element) and O(s^2) operator entries. Each element computes the Rusanov
// flux at its own six faces from (own trace, neighbour trace) with qL/qR in
// a fixed order (west/south/down side left); the neighbour's trace is
// re-extrapolated (log space for rho and rho*theta) from its state in device
// memory with the same fma sequence the neighbour uses for its own trace,
// and both go through one call site of the flux, so both sides of an
// interior interface get bit-identical fluxes (mass is conserved to
// round-off). Panel-edge west/south faces take qL from the halo, east/north
// take qR; the ground and the lid mirror the element's own trace with w odd.
//
// What bounds it (H100 SXM, float64, nel_h = nel_v = 20, s = 3, 48,000
// elements, 1,296,000 points): each call must read q (51.8 MB), the one-panel
// metric (28 fields, 48.4 MB; 9 more full-size fields on a rotating planet),
// the interface metric (~7 MB), x in stage mode (51.8 MB) and write out
// (51.8 MB): ~155-210 MB, 46-63 us at 3.35 TB/s. Its arithmetic is ~500
// operations a point (counting a log, exp, sqrt or divide as one), ~0.65
// GFLOP, ~19 us at the 34 TFLOP/s f64 vector peak: memory-bound in
// principle. The design spends operations to save bytes (neighbour traces
// re-extrapolated from the state, about 12 extra logs a point, instead of
// a pass that writes traces to device memory and a second launch), and
// keeps all intermediates in shared memory. Its known costs are the
// neighbour-state reads (30 s^3 loads an element, mostly L1/L2 hits), f64
// log/exp throughput, and low occupancy (53-92 KB of shared memory a block
// in f64).
//
// Tangent mode (euler3d_tangent_kernel, C entry euler3d_tangent_launch):
// the Jacobian action J(q).v of the RHS above, replacing km3_fused's
// tangent mode (pallas_euler3d.py:2131 with tangent=, body _km3_body
// :762-777), the matvec of the exponential integrators' Krylov loop. It
// takes the ABSOLUTE state q and the direction v with both halos; the JAX
// mode takes the perturbation dq and the base q0 (q = q0 + dq), which is
// the same function of (q, v): the base-state split is there for float32
// on the TPU, and buys nothing for the float64 operator on this card. It
// emits J.v alone (no stage, bal or traces). Every nonlinear site is
// linearised exactly: d exp(E.log q) = tr * (E.(v/q)) for rho and
// rho*theta at the own and the re-extrapolated neighbour traces alike,
// dp = gamma p v_rt / q_rt, the quotient rule for the normal speed and for
// the own-side face pressure that divides the w-pressure flux, the product
// rule for the quadratic Christoffel terms (Coriolis, time Christoffels
// and the filtered gravity are linear). Two non-differentiable sites take
// the convention of jax.jvp and of torch.func.jvp of the plain version:
// d|vn| = +dvn where vn >= 0 (zero included: a state at rest has vn = 0
// at every z face), -dvn below; d max(aL, aR) = the larger side's
// derivative, the mean of both at a tie. The tie is exact at the ground
// and the lid, where both sides are the element's own trace with w odd:
// there the two sides' derivatives are equal (|vn| and its derivative are
// even in w), so any choice gives the same flux. The conservation
// discipline of the RHS mode carries over: each element computes all six
// faces, re-extrapolates the neighbour's primal and direction traces from
// device memory in the fma order the neighbour uses, and passes qL/qR in
// the fixed order through one call site, so the mass-flux derivative is
// bit-identical from both sides and J.v has zero mass integral to
// round-off. It holds 29 s^3 + 54 s^2 numbers an element in shared memory
// (65-115 KB a block in f64) and reads q, v, the metric and both halos:
// at 20x20x3, s=3, f64 ~212 MB, 63 us at 3.35 TB/s, bytes-bound like the
// RHS mode.
//
// Perturbation mode (template flag PERT of both kernels; C entries with
// q0 != NULL): km3_fused's pert= mode (pallas_euler3d.py:2131 with pert=,
// body _km3_body with base= :919-945, :1061-1136, :1215-1240, :1290-1320,
// :1427-1540), the float32 companion of the mixed-precision Krylov loop.
// q then carries the PERTURBATION dq around the base state q0, halo the
// delta halo; q0 and its halo halo0 come with it (rhs0, the float64 base
// RHS cast, in RHS mode). Every linear stage acts on deltas; every
// nonlinear site is expanded exactly around the base: the log-space traces
// as t0 * expm1(E.log1p(dq/q0)) (own and re-extrapolated neighbour traces
// alike, in the same fma order), the pressure as p0 * expm1(gamma
// log1p(drt/rt0)), the Rusanov flux by the product rule with base normal
// speeds and the dissipation on delta jumps plus deig on the base jumps,
// the face log pressures and w-pressure split with the base face
// pressures, the quadratic forcing by the product rule. RHS mode writes
// rhs0 + delta (no stage, bal or traces); tangent mode writes J(q0 + dq).v
// with the absolute traces t0 + dt, pressures p0 + dp and log-pressure
// gradient dlp0 + ddlp as the linearisation coefficients. It keeps the
// real log1p/expm1 (the JAX package writes them as compensated formulas
// because Mosaic lacks them). Shared memory grows by q0, its logs and its
// log p: 32 s^3 + 54 s^2 numbers an element in RHS mode, 37 s^3 + 60 s^2
// in tangent mode.

#include <cuda_runtime.h>

namespace {

constexpr double kGravity = 9.80616;
constexpr double kP0 = 100000.0;
constexpr double kRd = 287.05;
constexpr double kCpd = 1005.46;
constexpr double kGamma = kCpd / (kCpd - kRd);
constexpr int kThreads = 256;

// Indices into `fields`.
constexpr int F_SQRTG = 0, F_INVSG = 1, F_INVDZ = 2, F_H = 3, F_CHS = 9, F_WPRES = 27;

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float sqrt_rn(float v) { return __fsqrt_rn(v); }
__device__ __forceinline__ double sqrt_rn(double v) { return __dsqrt_rn(v); }
__device__ __forceinline__ float tlog(float v) { return logf(v); }
__device__ __forceinline__ double tlog(double v) { return log(v); }
__device__ __forceinline__ float texp(float v) { return expf(v); }
__device__ __forceinline__ double texp(double v) { return exp(v); }
__device__ __forceinline__ float tlog1p(float v) { return log1pf(v); }
__device__ __forceinline__ double tlog1p(double v) { return log1p(v); }
__device__ __forceinline__ float texpm1(float v) { return expm1f(v); }
__device__ __forceinline__ double texpm1(double v) { return expm1(v); }

template <typename T>
__device__ __forceinline__ T pressure(T rho_theta) {
  return T(kP0) * texp(T(kGamma) * tlog(T(kRd / kP0) * rho_theta));
}

// Rusanov flux at one interface point with the rho*w advection/pressure split
// (reference pde/fluxes.py rusanov_3d_*_new; term order of the JAX package's
// _euler3d_rhs_core). f: rho, rho*u1, rho*u2, rho*theta fluxes.
template <typename T>
__device__ __forceinline__ void rusanov(const T* L, const T* R, T vL, T vR, T sg, T h0, T h1, T h2,
                                        T hd, T* f, T& wadv, T& wpres, T& pL, T& pR) {
  const T gam = T(kGamma);
  pL = pressure(L[4]);
  pR = pressure(R[4]);
  const T eig = fmax(fabs(vL) + sqrt_rn(hd * gam * pL / L[0]), fabs(vR) + sqrt_rn(hd * gam * pR / R[0]));
  const T sl = sg * vL, sr = sg * vR, es = eig * sg;
  f[0] = T(0.5) * (sl * L[0] + sr * R[0] - es * (R[0] - L[0]));
  f[1] = T(0.5) * ((sl * L[1] + sg * h0 * pL) + (sr * R[1] + sg * h0 * pR) - es * (R[1] - L[1]));
  f[2] = T(0.5) * ((sl * L[2] + sg * h1 * pL) + (sr * R[2] + sg * h1 * pR) - es * (R[2] - L[2]));
  f[3] = T(0.5) * (sl * L[4] + sr * R[4] - es * (R[4] - L[4]));
  wadv = T(0.5) * (sl * L[3] + sr * R[3] - es * (R[3] - L[3]));
  wpres = T(0.5) * (sg * h2 * pL + sg * h2 * pR);
}

// The line of s nodes through face point k of a face normal to direction d:
// node(i) = base + i * stride (x: k = kz*s+ky; y: k = kz*s+kx; z: k = ky*s+kx).
template <int S>
__device__ __forceinline__ void face_line(int d, int k, int& base, int& stride) {
  if (d == 0) {
    base = k * S;
    stride = 1;
  } else if (d == 1) {
    base = (k / S) * S * S + k % S;
    stride = S;
  } else {
    base = k;
    stride = S * S;
  }
}

// Trace of an element at one face point from its nodal values in shared
// memory: log-space rows (rho, rho*theta) from `lg`, momenta from `st`.
// Explicit fma in a fixed order, the same as nb_trace.
template <typename T, int S>
__device__ __forceinline__ void own_trace(const T* st, const T* lg, int base, int stride,
                                          const T* coef, T* tr) {
  constexpr int S3 = S * S * S;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const T* src = v == 0 ? lg : (v == 4 ? lg + S3 : st + v * S3);
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) acc = fmadd(src[base + i * stride], coef[i], acc);
    tr[v] = (v == 0 || v == 4) ? texp(acc) : acc;
  }
}

// The same trace of another element, from its state in device memory.
template <typename T, int S>
__device__ __forceinline__ void nb_trace(const T* q, long long nq, long long elem, int base,
                                         int stride, const T* coef, T* tr) {
  constexpr int S3 = S * S * S;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const T* src = q + v * nq + elem * S3 + base;
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const T val = (v == 0 || v == 4) ? tlog(src[i * stride]) : src[i * stride];
      acc = fmadd(val, coef[i], acc);
    }
    tr[v] = (v == 0 || v == 4) ? texp(acc) : acc;
  }
}

// The perturbation's trace at one face point from its nodal values in
// shared memory: the momenta linear (from `st`), rho and rho*theta as
// t0 * expm1(E.log1p(dq/q0)) from the log1p rows `lg` and the base trace
// t0. The same fma order as nb_delta_trace.
template <typename T, int S>
__device__ __forceinline__ void own_delta_trace(const T* st, const T* lg, int base, int stride,
                                                const T* coef, const T* t0, T* tr) {
  constexpr int S3 = S * S * S;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const T* src = v == 0 ? lg : (v == 4 ? lg + S3 : st + v * S3);
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) acc = fmadd(src[base + i * stride], coef[i], acc);
    tr[v] = (v == 0 || v == 4) ? t0[v] * texpm1(acc) : acc;
  }
}

// The same perturbation trace of another element, from dq and q0 in device memory.
template <typename T, int S>
__device__ __forceinline__ void nb_delta_trace(const T* dq, const T* q0, long long nq, long long elem,
                                               int base, int stride, const T* coef, const T* t0, T* tr) {
  constexpr int S3 = S * S * S;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const long long o = v * nq + elem * S3 + base;
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const T val = (v == 0 || v == 4) ? tlog1p(dq[o + i * stride] / q0[o + i * stride]) : dq[o + i * stride];
      acc = fmadd(val, coef[i], acc);
    }
    tr[v] = (v == 0 || v == 4) ? t0[v] * texpm1(acc) : acc;
  }
}

// Delta of `rusanov` around the base interface states (L0, R0) for the
// perturbations (dL, dR): the pressures as p0 * expm1(gamma log1p(d/rt0)),
// the fluxes by the product rule with the base normal speeds v0 and the
// absolute states, the dissipation on the delta jumps plus deig on the base
// jumps (the JAX package's models/euler_cubesphere.py:494-532 and
// pallas_euler3d.py:1061-1095). va are the absolute normal speeds. Returns
// the deltas of the four fluxes and of the w advection, the base and delta
// w pressure fluxes, and the base face pressures with their deltas.
template <typename T>
__device__ __forceinline__ void rusanov_delta(const T* L0, const T* R0, const T* dL, const T* dR, T v0L, T v0R,
                                              T vaL, T vaR, T sg, T h0, T h1, T h2, T hd, T* df, T& dwadv,
                                              T& wpres0, T& dwpres, T& pL0, T& pR0, T& dpL, T& dpR) {
  const T gam = T(kGamma);
  pL0 = pressure(L0[4]);
  pR0 = pressure(R0[4]);
  dpL = pL0 * texpm1(gam * tlog1p(dL[4] / L0[4]));
  dpR = pR0 * texpm1(gam * tlog1p(dR[4] / R0[4]));
  const T eig = fmax(fabs(vaL) + sqrt_rn(hd * gam * (pL0 + dpL) / (L0[0] + dL[0])),
                     fabs(vaR) + sqrt_rn(hd * gam * (pR0 + dpR) / (R0[0] + dR[0])));
  const T eig0 = fmax(fabs(v0L) + sqrt_rn(hd * gam * pL0 / L0[0]), fabs(v0R) + sqrt_rn(hd * gam * pR0 / R0[0]));
  const T deig = eig - eig0;
  const T dvL = vaL - v0L, dvR = vaR - v0R;
  T fl[5], fr[5], diss[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    fl[v] = sg * (v0L * dL[v] + dvL * (L0[v] + dL[v]));
    fr[v] = sg * (v0R * dR[v] + dvR * (R0[v] + dR[v]));
    diss[v] = sg * (eig * (dR[v] - dL[v]) + deig * (R0[v] - L0[v]));
  }
  df[0] = T(0.5) * (fl[0] + fr[0] - diss[0]);
  df[1] = T(0.5) * ((fl[1] + sg * h0 * dpL) + (fr[1] + sg * h0 * dpR) - diss[1]);
  df[2] = T(0.5) * ((fl[2] + sg * h1 * dpL) + (fr[2] + sg * h1 * dpR) - diss[2]);
  df[3] = T(0.5) * (fl[4] + fr[4] - diss[4]);
  dwadv = T(0.5) * (fl[3] + fr[3] - diss[3]);
  wpres0 = T(0.5) * sg * h2 * (pL0 + pR0);
  dwpres = T(0.5) * sg * h2 * (dpL + dpR);
}

// The neighbour side of face `face` of element (p, kz, ey, ex): whether it
// is a boundary (panel edge or ground/lid), the halo side and the position
// along the edge, and the neighbour element.
__device__ __forceinline__ void face_neighbour(int face, int nh, int nk, int kz, int ey, int ex, long long elem,
                                               bool& boundary, int& hside, int& along, long long& nb_elem) {
  switch (face) {
    case 0: boundary = ex == 0;      hside = 2; along = ey; nb_elem = elem - 1; break;
    case 1: boundary = ex == nh - 1; hside = 3; along = ey; nb_elem = elem + 1; break;
    case 2: boundary = ey == 0;      hside = 0; along = ex; nb_elem = elem - nh; break;
    case 3: boundary = ey == nh - 1; hside = 1; along = ex; nb_elem = elem + nh; break;
    case 4: boundary = kz == 0;      hside = 0; along = 0; nb_elem = elem - nh * nh; break;
    default: boundary = kz == nk - 1; hside = 0; along = 0; nb_elem = elem + nh * nh; break;
  }
}

// The interface metric [sqrt(g), h^{d0}, h^{d1}, h^{d2}] at face point k of
// face `face` of element (kz, ey, ex).
template <typename T, int S>
__device__ __forceinline__ void face_metric(const T* itf_x, const T* itf_y, const T* itf_z, int d, bool pos, int k,
                                            int nh, int nk, int kz, int ey, int ex, T& sg, T& h0, T& h1, T& h2) {
  constexpr int S2 = S * S;
  const T* itf;
  long long istride, iidx;
  if (d == 0) {
    itf = itf_x;
    istride = (long long)nk * nh * (nh + 1) * S2;
    iidx = ((long long)(kz * nh + ey) * (nh + 1) + ex + pos) * S2 + k;
  } else if (d == 1) {
    itf = itf_y;
    istride = (long long)nk * (nh + 1) * nh * S2;
    iidx = ((long long)(kz * (nh + 1) + ey + pos) * nh + ex) * S2 + k;
  } else {
    itf = itf_z;
    istride = (long long)(nk + 1) * nh * nh * S2;
    iidx = ((long long)((kz + pos) * nh + ey) * nh + ex) * S2 + k;
  }
  sg = itf[iidx];
  h0 = itf[istride + iidx];
  h1 = itf[2 * istride + iidx];
  h2 = itf[3 * istride + iidx];
}

// Shared memory (in T): ops1d, then per element [q (5 s^3) | log rho, log
// rho*theta (2 s^3) | log p (s^3) | sqrt(g)*rho (s^3) | fluxes (3 directions
// x 5 components x s^3: rho, rho*u1, rho*u2, rho*theta, w advection) | face
// data (7 x 6 s^2: the four fluxes, w advection, w pressure / p, log p)].
// In perturbation mode q, the logs, log p, sqrt(g)*rho, the fluxes and the
// face data are the perturbation's (log1p(dq/q0) rows, log1p(dp/p0)), and
// the element adds q0 (5 s^3) and log q0 (2 s^3) after the logs, log p0
// (s^3) after log p, and two face rows (log p0 and the base w pressure / p0:
// 9 x 6 s^2). Every region starts on a 16-byte boundary.
template <typename T, int S, bool PERT = false>
struct Shape {
  static constexpr int S2 = S * S;
  static constexpr int S3 = S * S * S;
  static constexpr int NF = 6 * S2;
  static constexpr int A = 16 / sizeof(T);
  static constexpr int pad(int n) { return (n + A - 1) / A * A; }
  // ops1d segments at 16-byte boundaries: the kernel selects between the
  // en and ep pointers at run time, and nvcc then loads pairs of
  // coefficients as one 16-byte vector from either pointer.
  static constexpr int PS = pad(S), PS2 = pad(S2);
  static constexpr int N_OPS = 4 * PS + 2 * PS2;
  static constexpr int OFF_LOG = pad(5 * S3);
  static constexpr int OFF_Q0 = OFF_LOG + pad(2 * S3);
  static constexpr int OFF_LOG0 = OFF_Q0 + (PERT ? pad(5 * S3) : 0);
  static constexpr int OFF_LP = OFF_LOG0 + (PERT ? pad(2 * S3) : 0);
  static constexpr int OFF_LP0 = OFF_LP + pad(S3);
  static constexpr int OFF_SG = OFF_LP0 + (PERT ? pad(S3) : 0);
  static constexpr int OFF_F = OFF_SG + pad(S3);
  static constexpr int OFF_FACE = OFF_F + pad(15 * S3);
  static constexpr int PER_ELEM = OFF_FACE + pad((PERT ? 9 : 7) * NF);
  static constexpr int EB = kThreads / S3 > 0 ? kThreads / S3 : 1;
};

template <typename T, int S, bool PERT>
__global__ void __launch_bounds__(kThreads) euler3d_operator_kernel(
    const T* __restrict__ q, const T* __restrict__ halo, const T* __restrict__ ops,
    const T* __restrict__ fields, const T* __restrict__ tch, const T* __restrict__ itf_x,
    const T* __restrict__ itf_y, const T* __restrict__ itf_z, const T* __restrict__ x,
    const T* __restrict__ bal, const T* __restrict__ q0, const T* __restrict__ halo0,
    const T* __restrict__ rhs0, T* __restrict__ out, T* __restrict__ traces, int nh, int nk, T a,
    T b, T cdt, int stage) {
  using Sh = Shape<T, S, PERT>;
  constexpr int S2 = Sh::S2, S3 = Sh::S3, NF = Sh::NF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* sEn = smem;
  const T* sEp = smem + Sh::PS;
  const T* sCn = smem + 2 * Sh::PS;
  const T* sCp = smem + 3 * Sh::PS;
  const T* sD = smem + 4 * Sh::PS;
  const T* sHF = sD + Sh::PS2;
  const T gam = T(kGamma);

  const int tid = threadIdx.x;
  const int e_loc = tid / S3;
  const int j = tid - e_loc * S3;
  const int per_panel = nk * nh * nh;
  const int p = blockIdx.x % 6;
  const int pe = (blockIdx.x / 6) * Sh::EB + e_loc;
  const bool valid = pe < per_panel;
  const long long elem = (long long)p * per_panel + pe;
  const long long nq = 6LL * per_panel * S3;        // stride between variables
  const long long fstride = (long long)per_panel * S3;  // stride between metric fields

  T* sQ = smem + Sh::N_OPS + e_loc * Sh::PER_ELEM;
  T* sLog = sQ + Sh::OFF_LOG;
  T* sQ0 = sQ + Sh::OFF_Q0;
  T* sLog0 = sQ + Sh::OFF_LOG0;
  T* sLp = sQ + Sh::OFF_LP;
  T* sLp0 = sQ + Sh::OFF_LP0;
  T* sSg = sQ + Sh::OFF_SG;
  T* sF = sQ + Sh::OFF_F;
  T* sFace = sQ + Sh::OFF_FACE;

  for (int i = tid; i < 4 * S + 2 * S2; i += blockDim.x) {
    const int dst = i < 4 * S ? (i / S) * Sh::PS + i % S
                              : 4 * Sh::PS + ((i - 4 * S) / S2) * Sh::PS2 + (i - 4 * S) % S2;
    smem[dst] = ops[i];
  }

  int kz = 0, ey = 0, ex = 0;
  // qv: the state (the perturbation in PERT mode), q0v: the base; pres the
  // absolute pressure, p0v and dpv its base and perturbation (PERT).
  T qv[5], q0v[5], pres = T(0), p0v = T(0), dpv = T(0), sqrtg = T(0), hm[6];
  const T* fld = fields + (long long)(valid ? pe : 0) * S3 + j;
  if (valid) {
    kz = pe / (nh * nh);
    const int r = pe - kz * nh * nh;
    ey = r / nh;
    ex = r - ey * nh;
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      qv[v] = q[v * nq + elem * S3 + j];
      sQ[v * S3 + j] = qv[v];
      if constexpr (PERT) {
        q0v[v] = q0[v * nq + elem * S3 + j];
        sQ0[v * S3 + j] = q0v[v];
      }
    }
    sqrtg = fld[F_SQRTG * fstride];
#pragma unroll
    for (int i = 0; i < 6; ++i) hm[i] = fld[(F_H + i) * fstride];
    // h^{dk} for direction d: rows (00 01 02), (01 11 12), (02 12 22)
    const T hrow[3][3] = {{hm[0], hm[1], hm[2]}, {hm[1], hm[3], hm[4]}, {hm[2], hm[4], hm[5]}};
    if constexpr (!PERT) {
      // --- Pointwise: logs, pressure, sqrt(g)-weighted fluxes.
      const T rho = qv[0];
      const T u[3] = {qv[1] / rho, qv[2] / rho, qv[3] / rho};
      sLog[j] = tlog(rho);
      sLog[S3 + j] = tlog(qv[4]);
      pres = pressure(qv[4]);
      sLp[j] = tlog(pres);
      sSg[j] = sqrtg * rho;
      const T sgp = sqrtg * pres;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T su = sqrtg * u[d];
        T* fd = sF + d * 5 * S3 + j;
        fd[0] = su * qv[0];
        fd[S3] = su * qv[1] + sgp * hrow[d][0];
        fd[2 * S3] = su * qv[2] + sgp * hrow[d][1];
        fd[3 * S3] = su * qv[4];
        fd[4 * S3] = su * qv[3];
      }
    } else {
      // --- Pointwise deltas: du = (d(rho u) - u0 d(rho)) / rho, dp around
      // p0, the flux deltas sqrt(g) (u0 dq + du q) (+ sqrt(g) dp h).
      const T rho0 = q0v[0], rho = rho0 + qv[0];
      T qa[5];
#pragma unroll
      for (int v = 0; v < 5; ++v) qa[v] = q0v[v] + qv[v];
      const T u0[3] = {q0v[1] / rho0, q0v[2] / rho0, q0v[3] / rho0};
      const T du[3] = {(qv[1] - u0[0] * qv[0]) / rho, (qv[2] - u0[1] * qv[0]) / rho,
                       (qv[3] - u0[2] * qv[0]) / rho};
      const T dlt = tlog1p(qv[4] / q0v[4]);
      sLog[j] = tlog1p(qv[0] / rho0);
      sLog[S3 + j] = dlt;
      sLog0[j] = tlog(rho0);
      sLog0[S3 + j] = tlog(q0v[4]);
      p0v = pressure(q0v[4]);
      dpv = p0v * texpm1(gam * dlt);
      pres = p0v + dpv;
      sLp[j] = tlog1p(dpv / p0v);
      sLp0[j] = tlog(p0v);
      sSg[j] = sqrtg * qv[0];
      const T sgdp = sqrtg * dpv;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T* fd = sF + d * 5 * S3 + j;
        fd[0] = sqrtg * (u0[d] * qv[0] + du[d] * qa[0]);
        fd[S3] = sqrtg * (u0[d] * qv[1] + du[d] * qa[1]) + sgdp * hrow[d][0];
        fd[2 * S3] = sqrtg * (u0[d] * qv[2] + du[d] * qa[2]) + sgdp * hrow[d][1];
        fd[3 * S3] = sqrtg * (u0[d] * qv[4] + du[d] * qa[4]);
        fd[4 * S3] = sqrtg * (u0[d] * qv[3] + du[d] * qa[3]);
      }
    }
  }
  __syncthreads();

  // --- Interface fluxes at this element's six faces (W, E, S, N, D, U).
  if (valid) {
#pragma unroll 1
    for (int fi = j; fi < NF; fi += S3) {
      const int face = fi / S2;
      const int k = fi - face * S2;
      const int d = face >> 1;
      const bool pos = face & 1;
      int base, stride;
      face_line<S>(d, k, base, stride);
      bool boundary;
      int hside, along;
      long long nb_elem;
      face_neighbour(face, nh, nk, kz, ey, ex, elem, boundary, hside, along, nb_elem);
      const long long h = ((((long long)(hside)*6 + p) * nk + kz) * nh + along) * S2 + k;
      const long long hv = 4LL * 6 * nk * nh * S2;  // stride between halo variables
      const T* coef = pos ? sEp : sEn;
      const T* ncoef = pos ? sEn : sEp;  // the neighbour's facing face: its positive face when ours is negative
      T sg, h0, h1, h2;
      face_metric<T, S>(itf_x, itf_y, itf_z, d, pos, k, nh, nk, kz, ey, ex, sg, h0, h1, h2);
      const T hd = d == 0 ? h0 : (d == 1 ? h1 : h2);
      T* fc = sFace + fi;
      if constexpr (!PERT) {
        T own[5], nb[5];
        own_trace<T, S>(sQ, sLog, base, stride, coef, own);
        if (!boundary) {
          nb_trace<T, S>(q, nq, nb_elem, base, stride, ncoef, nb);
        } else if (d < 2) {
#pragma unroll
          for (int v = 0; v < 5; ++v) nb[v] = halo[v * hv + h];
        } else {
#pragma unroll
          for (int v = 0; v < 5; ++v) nb[v] = own[v];  // ground / rigid lid: mirror
        }
        T L[5], R[5];
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          L[v] = pos ? own[v] : nb[v];
          R[v] = pos ? nb[v] : own[v];
        }
        T vL = L[1 + d] / L[0];
        T vR = R[1 + d] / R[0];
        if (boundary && d == 2) {  // w is odd across the ground and the lid
          if (pos) vR = -vR; else vL = -vL;
        }
        T f[4], wadv, wpres, pL, pR;
        rusanov(L, R, vL, vR, sg, h0, h1, h2, hd, f, wadv, wpres, pL, pR);
        const T p_own = pos ? pL : pR;
        fc[0] = f[0];
        fc[NF] = f[1];
        fc[2 * NF] = f[2];
        fc[3 * NF] = f[3];
        fc[4 * NF] = wadv;
        fc[5 * NF] = wpres / p_own;
        fc[6 * NF] = tlog(p_own);
      } else {
        T own0[5], own[5], nb0[5], nb[5];
        own_trace<T, S>(sQ0, sLog0, base, stride, coef, own0);
        own_delta_trace<T, S>(sQ, sLog, base, stride, coef, own0, own);
        if (!boundary) {
          nb_trace<T, S>(q0, nq, nb_elem, base, stride, ncoef, nb0);
          nb_delta_trace<T, S>(q, q0, nq, nb_elem, base, stride, ncoef, nb0, nb);
        } else if (d < 2) {
#pragma unroll
          for (int v = 0; v < 5; ++v) {
            nb0[v] = halo0[v * hv + h];
            nb[v] = halo[v * hv + h];
          }
        } else {
#pragma unroll
          for (int v = 0; v < 5; ++v) {  // ground / rigid lid: mirror
            nb0[v] = own0[v];
            nb[v] = own[v];
          }
        }
        T L0[5], R0[5], dL[5], dR[5];
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          L0[v] = pos ? own0[v] : nb0[v];
          R0[v] = pos ? nb0[v] : own0[v];
          dL[v] = pos ? own[v] : nb[v];
          dR[v] = pos ? nb[v] : own[v];
        }
        T v0L = L0[1 + d] / L0[0], v0R = R0[1 + d] / R0[0];
        T vaL = (L0[1 + d] + dL[1 + d]) / (L0[0] + dL[0]), vaR = (R0[1 + d] + dR[1 + d]) / (R0[0] + dR[0]);
        if (boundary && d == 2) {  // w is odd across the ground and the lid
          if (pos) {
            v0R = -v0R;
            vaR = -vaR;
          } else {
            v0L = -v0L;
            vaL = -vaL;
          }
        }
        T df[4], dwadv, wpres0, dwpres, pL0, pR0, dpL, dpR;
        rusanov_delta(L0, R0, dL, dR, v0L, v0R, vaL, vaR, sg, h0, h1, h2, hd, df, dwadv, wpres0, dwpres, pL0,
                      pR0, dpL, dpR);
        const T p0_own = pos ? pL0 : pR0;
        const T dp_own = pos ? dpL : dpR;
        const T pa = p0_own + dp_own;
        const T wp0 = wpres0 / p0_own;
        fc[0] = df[0];
        fc[NF] = df[1];
        fc[2 * NF] = df[2];
        fc[3 * NF] = df[3];
        fc[4 * NF] = dwadv;
        fc[5 * NF] = dwpres / pa - wp0 * (dp_own / pa);  // d[wpres / p]
        fc[6 * NF] = tlog1p(dp_own / p0_own);           // d[log p]
        fc[7 * NF] = tlog(p0_own);
        fc[8 * NF] = wp0;
      }
    }
  }
  __syncthreads();

  // --- Divergence + corrections, w pressure split, forcing, stage.
  if (valid) {
    const int jx = j % S, jy = (j / S) % S, jz = j / S2;
    const int lx = (jz * S + jy) * S, ly = jz * S2 + jx, lz = jy * S + jx;  // line bases
    const int kxf = jz * S + jy, kyf = jz * S + jx, kzf = jy * S + jx;    // face points
    const T* Dx = sD + jx * S;
    const T* Dy = sD + jy * S;
    const T* Dz = sD + jz * S;

    T div[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const T* fx = sF + c * S3;
      const T* fy = sF + (5 + c) * S3;
      const T* fz = sF + (10 + c) * S3;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dx[i], fx[lx + i], acc);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dy[i], fy[ly + i * S], acc);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dz[i], fz[lz + i * S2], acc);
      div[c] = acc;
    }
    const T cnx = sCn[jx], cpx = sCp[jx], cny = sCn[jy], cpy = sCp[jy], cnz = sCn[jz], cpz = sCp[jz];
    // Boundary correction of face row c at this node.
    auto corr_of = [&](int c) {
      const T* fc = sFace + c * NF;
      return cnx * fc[kxf] + cpx * fc[S2 + kxf] + cny * fc[2 * S2 + kyf] + cpy * fc[3 * S2 + kyf] +
             cnz * fc[4 * S2 + kzf] + cpz * fc[5 * S2 + kzf];
    };
    T corr[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) corr[c] = corr_of(c);
    // Log-pressure gradients along x, y, z (the perturbation's in PERT mode)
    // with the face log p corrections, from log p nodes `lp` and face row `row`.
    auto dlog_p = [&](const T* lp, int row, T& dlx, T& dly, T& dlz) {
      const T* flp = sFace + row * NF;
      dlx = T(0), dly = T(0), dlz = T(0);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        dlx = fmadd(Dx[i], lp[lx + i], dlx);
        dly = fmadd(Dy[i], lp[ly + i * S], dly);
        dlz = fmadd(Dz[i], lp[lz + i * S2], dlz);
      }
      dlx += cnx * flp[kxf] + cpx * flp[S2 + kxf];
      dly += cny * flp[2 * S2 + kyf] + cpy * flp[3 * S2 + kyf];
      dlz += cnz * flp[4 * S2 + kzf] + cpz * flp[5 * S2 + kzf];
    };
    T dlx, dly, dlz, grav = T(0);
    dlog_p(sLp, 6, dlx, dly, dlz);
#pragma unroll
    for (int i = 0; i < S; ++i) grav = fmadd(sHF[jz * S + i], sSg[lz + i * S2], grav);

    const T invsg = fld[F_INVSG * fstride];
    const T invdz = fld[F_INVDZ * fstride];
    const T wpres_int = fld[F_WPRES * fstride];
    const T sh02 = sqrtg * hm[2], sh12 = sqrtg * hm[4], sh22 = sqrtg * hm[5];
    T w_df, force[3];
    if constexpr (!PERT) {
      w_df = div[4] + corr[4] + (wpres_int + corr[5]) * pres + pres * (sh02 * dlx + sh12 * dly + sh22 * dlz);
      const T rho = qv[0];
      const T u[3] = {qv[1] / rho, qv[2] / rho, qv[3] / rho};
      // Christoffel/Coriolis forcing: rows a = 0, 1, 2 of
      // 2 rho Gamma^a_{0b} u^b + Gamma^a_{bc} (rho u^b u^c + h^{bc} p).
      const T pair[6] = {rho * u[0] * u[0] + hm[0] * pres, rho * u[0] * u[1] + hm[1] * pres,
                         rho * u[0] * u[2] + hm[2] * pres, rho * u[1] * u[1] + hm[3] * pres,
                         rho * u[1] * u[2] + hm[4] * pres, rho * u[2] * u[2] + hm[5] * pres};
#pragma unroll
      for (int a_ = 0; a_ < 3; ++a_) {
        const T* ch = fld + (F_CHS + 6 * a_) * fstride;
        T fr = ch[0] * pair[0];
        if (tch != nullptr) {
          const T* tc = tch + (long long)(3 * a_) * nq + elem * S3 + j;
          fr = T(2) * rho * (tc[0] * u[0] + tc[nq] * u[1] + tc[2 * nq] * u[2]) + fr;
        }
        force[a_] = fr + T(2) * ch[fstride] * pair[1] + T(2) * ch[2 * fstride] * pair[2] +
                    ch[3 * fstride] * pair[3] + T(2) * ch[4 * fstride] * pair[4] + ch[5 * fstride] * pair[5];
      }
    } else {
      // The w pressure split: d[(W + c) p] = (W + c0) dp + dc p and
      // d[p sgh dlp] = p0 ddlp + dp (dlp0 + ddlp), c0 and dlp0 the base's.
      const T wcorr0 = corr_of(8);
      T dl0x, dl0y, dl0z;
      dlog_p(sLp0, 7, dl0x, dl0y, dl0z);
      w_df = div[4] + corr[4] + (wpres_int + wcorr0) * dpv + corr[5] * pres +
             sh02 * (p0v * dlx + dpv * (dl0x + dlx)) + sh12 * (p0v * dly + dpv * (dl0y + dly)) +
             sh22 * (p0v * dlz + dpv * (dl0z + dlz));
      // Forcing deltas: d[q_b q_c / rho] by the product rule with absolute
      // second factors, h^{bc} dp, the Coriolis term linear in d(rho u).
      const T rho0 = q0v[0], rho = rho0 + qv[0];
      auto dprod = [&](int i, int k) {
        return (qv[i] * q0v[k] + (q0v[i] + qv[i]) * qv[k]) / rho - (q0v[i] * q0v[k] / rho0) * (qv[0] / rho);
      };
      const T pair[6] = {dprod(1, 1) + hm[0] * dpv, dprod(1, 2) + hm[1] * dpv, dprod(1, 3) + hm[2] * dpv,
                         dprod(2, 2) + hm[3] * dpv, dprod(2, 3) + hm[4] * dpv, dprod(3, 3) + hm[5] * dpv};
#pragma unroll
      for (int a_ = 0; a_ < 3; ++a_) {
        const T* ch = fld + (F_CHS + 6 * a_) * fstride;
        T fr = ch[0] * pair[0];
        if (tch != nullptr) {
          const T* tc = tch + (long long)(3 * a_) * nq + elem * S3 + j;
          fr = T(2) * (tc[0] * qv[1] + tc[nq] * qv[2] + tc[2 * nq] * qv[3]) + fr;
        }
        force[a_] = fr + T(2) * ch[fstride] * pair[1] + T(2) * ch[2 * fstride] * pair[2] +
                    ch[3 * fstride] * pair[3] + T(2) * ch[4 * fstride] * pair[4] + ch[5 * fstride] * pair[5];
      }
    }
    const T gravity = invdz * T(kGravity) * invsg * grav;

    T r[5];
    r[0] = -invsg * (div[0] + corr[0]);
    r[1] = -invsg * (div[1] + corr[1]) - force[0];
    r[2] = -invsg * (div[2] + corr[2]) - force[1];
    r[3] = -invsg * w_df - (force[2] + gravity);
    r[4] = -invsg * (div[3] + corr[3]);
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const long long o = v * nq + elem * S3 + j;
      T val = r[v];
      if constexpr (PERT) {
        val = rhs0[o] + val;
      } else {
        if (bal != nullptr) val += bal[o];
        if (stage) {
          val = b * qv[v] + cdt * val;
          if (x != nullptr) val = a * x[o] + val;
        }
      }
      out[o] = val;
      sQ[v * S3 + j] = val;  // only this thread reads this slot from here on
    }
  }

  // --- Panel-edge traces of the output state (x and y faces on an edge).
  if (!PERT && traces != nullptr) {
    __syncthreads();
    if (valid) {
      for (int fi = j; fi < 4 * S2; fi += S3) {
        const int face = fi / S2;
        const int k = fi - face * S2;
        bool on_edge;
        int tside, along;
        switch (face) {
          case 0: on_edge = ex == 0;      tside = 2; along = ey; break;
          case 1: on_edge = ex == nh - 1; tside = 3; along = ey; break;
          case 2: on_edge = ey == 0;      tside = 0; along = ex; break;
          default: on_edge = ey == nh - 1; tside = 1; along = ex; break;
        }
        if (!on_edge) continue;
        int base, stride;
        face_line<S>(face >> 1, k, base, stride);
        const T* coef = (face & 1) ? sEp : sEn;
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          T acc = T(0);
#pragma unroll
          for (int i = 0; i < S; ++i) {
            const T val = sQ[v * S3 + base + i * stride];
            acc = fmadd((v == 0 || v == 4) ? tlog(val) : val, coef[i], acc);
          }
          traces[((((long long)(v * 4 + tside) * 6 + p) * nk + kz) * nh + along) * S2 + k] =
              (v == 0 || v == 4) ? texp(acc) : acc;
        }
      }
    }
  }
}

// Dynamic shared memory of one block, after raising the kernel's limit
// above the default 48 KB once.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool& configured) {
  if (configured || smem <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int S, bool PERT>
cudaError_t launch(int nh, int nk, const void* q, const void* halo, const void* ops,
                   const void* fields, const void* tch, const void* itf_x, const void* itf_y,
                   const void* itf_z, const void* x, const void* bal, const void* q0, const void* halo0,
                   const void* rhs0, void* out, void* traces, double a, double b, double cdt, int stage,
                   cudaStream_t stream) {
  using Sh = Shape<T, S, PERT>;
  const size_t smem = sizeof(T) * (Sh::N_OPS + (size_t)Sh::EB * Sh::PER_ELEM);
  static bool configured = false;
  cudaError_t err = configure(euler3d_operator_kernel<T, S, PERT>, smem, configured);
  if (err != cudaSuccess) return err;
  const int per_panel = nk * nh * nh;
  const int blocks = 6 * ((per_panel + Sh::EB - 1) / Sh::EB);
  euler3d_operator_kernel<T, S, PERT><<<blocks, Sh::EB * Sh::S3, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(halo), static_cast<const T*>(ops),
      static_cast<const T*>(fields), static_cast<const T*>(tch), static_cast<const T*>(itf_x),
      static_cast<const T*>(itf_y), static_cast<const T*>(itf_z), static_cast<const T*>(x),
      static_cast<const T*>(bal), static_cast<const T*>(q0), static_cast<const T*>(halo0),
      static_cast<const T*>(rhs0), static_cast<T*>(out), static_cast<T*>(traces), nh, nk, T(a), T(b), T(cdt),
      stage);
  return cudaGetLastError();
}

template <typename T, bool PERT>
cudaError_t dispatch(int s, int nh, int nk, const void* q, const void* halo, const void* ops,
                     const void* fields, const void* tch, const void* itf_x, const void* itf_y,
                     const void* itf_z, const void* x, const void* bal, const void* q0, const void* halo0,
                     const void* rhs0, void* out, void* traces, double a, double b, double cdt, int stage,
                     cudaStream_t stream) {
#define E3_CASE(S)                                                                                 \
  case S:                                                                                          \
    return launch<T, S, PERT>(nh, nk, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0,  \
                              halo0, rhs0, out, traces, a, b, cdt, stage, stream);
  switch (s) {
    E3_CASE(2) E3_CASE(3) E3_CASE(4) E3_CASE(5) E3_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef E3_CASE
}

// ---------------------------------------------------------------------------
// Tangent mode

// The direction's trace at one face point from its log-tangent nodal
// values in shared memory (v_rho/rho, v_1, v_2, v_3, v_rt/rt): the momenta
// extrapolated linearly, rho and rho*theta as tr * (E.(v/q)), tr the
// primal trace. The same fma order as nb_tangent_trace.
template <typename T, int S>
__device__ __forceinline__ void own_tangent_trace(const T* sv, int base, int stride, const T* coef,
                                                  const T* tr, T* ttr) {
  constexpr int S3 = S * S * S;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const T* src = sv + v * S3;
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) acc = fmadd(src[base + i * stride], coef[i], acc);
    ttr[v] = (v == 0 || v == 4) ? tr[v] * acc : acc;
  }
}

// The same direction trace of another element, from q and v in device memory.
template <typename T, int S>
__device__ __forceinline__ void nb_tangent_trace(const T* q, const T* vd, long long nq, long long elem,
                                                 int base, int stride, const T* coef, const T* tr,
                                                 T* ttr) {
  constexpr int S3 = S * S * S;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const long long o = v * nq + elem * S3 + base;
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const T val = (v == 0 || v == 4) ? vd[o + i * stride] / q[o + i * stride] : vd[o + i * stride];
      acc = fmadd(val, coef[i], acc);
    }
    ttr[v] = (v == 0 || v == 4) ? tr[v] * acc : acc;
  }
}

// The same direction trace in perturbation mode: the log-tangent v/(q0 + dq)
// of the neighbour from v, dq and q0 in device memory, in the fma order of
// the element's own (phase 1 computes v/(q0 + dq) the same way).
template <typename T, int S>
__device__ __forceinline__ void nb_tangent_trace_pert(const T* q0, const T* dq, const T* vd, long long nq,
                                                      long long elem, int base, int stride, const T* coef,
                                                      const T* tr, T* ttr) {
  constexpr int S3 = S * S * S;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const long long o = v * nq + elem * S3 + base;
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const long long n = o + i * stride;
      const T val = (v == 0 || v == 4) ? vd[n] / (q0[n] + dq[n]) : vd[n];
      acc = fmadd(val, coef[i], acc);
    }
    ttr[v] = (v == 0 || v == 4) ? tr[v] * acc : acc;
  }
}

// Directional derivative of `rusanov` at (L, R) with face pressures (pL,
// pR) in the direction (tL, tR), vL/vR the normal speeds and tvL/tvR
// theirs. Returns the derivatives of the four fluxes, of the w advection
// and w pressure fluxes, and of the face pressures.
template <typename T>
__device__ __forceinline__ void rusanov_tangent(const T* L, const T* R, const T* tL, const T* tR, T vL,
                                                T vR, T tvL, T tvR, T pL, T pR, T sg, T h0, T h1, T h2, T hd,
                                                T* tf, T& twadv, T& twpres, T& tpL, T& tpR) {
  const T gam = T(kGamma);
  tpL = gam * pL * tL[4] / L[4];
  tpR = gam * pR * tR[4] / R[4];
  const T cL = sqrt_rn(hd * gam * pL / L[0]);
  const T cR = sqrt_rn(hd * gam * pR / R[0]);
  const T aL = fabs(vL) + cL, aR = fabs(vR) + cR;
  const T taL = (vL >= T(0) ? tvL : -tvL) + T(0.5) * cL * (tpL / pL - tL[0] / L[0]);
  const T taR = (vR >= T(0) ? tvR : -tvR) + T(0.5) * cR * (tpR / pR - tR[0] / R[0]);
  const T eig = fmax(aL, aR);
  const T teig = aL > aR ? taL : (aL < aR ? taR : T(0.5) * (taL + taR));
  const T sl = sg * vL, sr = sg * vR, es = eig * sg;
  const T tsl = sg * tvL, tsr = sg * tvR, tes = teig * sg;
  T adv[5];
#pragma unroll
  for (int v = 0; v < 5; ++v)
    adv[v] = T(0.5) * ((tsl * L[v] + sl * tL[v]) + (tsr * R[v] + sr * tR[v]) -
                       (tes * (R[v] - L[v]) + es * (tR[v] - tL[v])));
  const T tps = T(0.5) * (tpL + tpR);
  tf[0] = adv[0];
  tf[1] = adv[1] + sg * h0 * tps;
  tf[2] = adv[2] + sg * h1 * tps;
  tf[3] = adv[4];
  twadv = adv[3];
  twpres = sg * h2 * tps;
}

// Shared memory of the tangent mode (in T): ops1d, then per element [q
// (5 s^3) | log-tangent v (5 s^3) | log rho, log rho*theta (2 s^3) | log p
// (s^3) | sqrt(g)*v_rho (s^3) | direction fluxes (15 s^3) | face data
// (9 x 6 s^2: the derivatives of the four fluxes, of the w advection, of
// w pressure / p and of log p; then w pressure / p and log p)]. In
// perturbation mode q, the logs and log p are the perturbation's (the
// log-tangent is taken at q0 + dq), the element adds q0 (5 s^3) and log q0
// (2 s^3) after the logs and log p0 (s^3) after log p, and the face rows end
// with log p0 and the perturbation's d[log p] (10 x 6 s^2; the w pressure
// / p row holds the absolute value). Every region starts on a 16-byte
// boundary.
template <typename T, int S, bool PERT = false>
struct TangentShape {
  using Sh = Shape<T, S>;
  static constexpr int S2 = Sh::S2, S3 = Sh::S3, NF = Sh::NF;
  static constexpr int PS = Sh::PS, PS2 = Sh::PS2, N_OPS = Sh::N_OPS, EB = Sh::EB;
  static constexpr int OFF_V = Sh::pad(5 * S3);
  static constexpr int OFF_LOG = OFF_V + Sh::pad(5 * S3);
  static constexpr int OFF_Q0 = OFF_LOG + Sh::pad(2 * S3);
  static constexpr int OFF_LOG0 = OFF_Q0 + (PERT ? Sh::pad(5 * S3) : 0);
  static constexpr int OFF_LP = OFF_LOG0 + (PERT ? Sh::pad(2 * S3) : 0);
  static constexpr int OFF_LP0 = OFF_LP + Sh::pad(S3);
  static constexpr int OFF_SG = OFF_LP0 + (PERT ? Sh::pad(S3) : 0);
  static constexpr int OFF_F = OFF_SG + Sh::pad(S3);
  static constexpr int OFF_FACE = OFF_F + Sh::pad(15 * S3);
  static constexpr int PER_ELEM = OFF_FACE + Sh::pad((PERT ? 10 : 9) * NF);
};

template <typename T, int S, bool PERT>
__global__ void __launch_bounds__(kThreads) euler3d_tangent_kernel(
    const T* __restrict__ q, const T* __restrict__ vd, const T* __restrict__ halo,
    const T* __restrict__ thalo, const T* __restrict__ ops, const T* __restrict__ fields,
    const T* __restrict__ tch, const T* __restrict__ itf_x, const T* __restrict__ itf_y,
    const T* __restrict__ itf_z, const T* __restrict__ q0, const T* __restrict__ halo0, T* __restrict__ out,
    int nh, int nk) {
  using Sh = TangentShape<T, S, PERT>;
  constexpr int S2 = Sh::S2, S3 = Sh::S3, NF = Sh::NF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* sEn = smem;
  const T* sEp = smem + Sh::PS;
  const T* sCn = smem + 2 * Sh::PS;
  const T* sCp = smem + 3 * Sh::PS;
  const T* sD = smem + 4 * Sh::PS;
  const T* sHF = sD + Sh::PS2;

  const int tid = threadIdx.x;
  const int e_loc = tid / S3;
  const int j = tid - e_loc * S3;
  const int per_panel = nk * nh * nh;
  const int p = blockIdx.x % 6;
  const int pe = (blockIdx.x / 6) * Sh::EB + e_loc;
  const bool valid = pe < per_panel;
  const long long elem = (long long)p * per_panel + pe;
  const long long nq = 6LL * per_panel * S3;
  const long long fstride = (long long)per_panel * S3;
  const T gam = T(kGamma);

  T* sQ = smem + Sh::N_OPS + e_loc * Sh::PER_ELEM;
  T* sV = sQ + Sh::OFF_V;
  T* sLog = sQ + Sh::OFF_LOG;
  T* sQ0 = sQ + Sh::OFF_Q0;
  T* sLog0 = sQ + Sh::OFF_LOG0;
  T* sLp = sQ + Sh::OFF_LP;
  T* sLp0 = sQ + Sh::OFF_LP0;
  T* sSg = sQ + Sh::OFF_SG;
  T* sF = sQ + Sh::OFF_F;
  T* sFace = sQ + Sh::OFF_FACE;

  for (int i = tid; i < 4 * S + 2 * S2; i += blockDim.x) {
    const int dst = i < 4 * S ? (i / S) * Sh::PS + i % S
                              : 4 * Sh::PS + ((i - 4 * S) / S2) * Sh::PS2 + (i - 4 * S) % S2;
    smem[dst] = ops[i];
  }

  int kz = 0, ey = 0, ex = 0;
  // qa: the absolute state (q0 + dq in PERT mode), u its velocity, pres its
  // pressure (p0v + dpv in PERT mode).
  T qa[5], tv[5], u[3], pres = T(0), p0v = T(0), dpv = T(0), tpres = T(0), sqrtg = T(0), hm[6];
  const T* fld = fields + (long long)(valid ? pe : 0) * S3 + j;
  if (valid) {
    kz = pe / (nh * nh);
    const int r = pe - kz * nh * nh;
    ey = r / nh;
    ex = r - ey * nh;
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const T qv = q[v * nq + elem * S3 + j];
      tv[v] = vd[v * nq + elem * S3 + j];
      sQ[v * S3 + j] = qv;
      if constexpr (PERT) {
        const T q0v = q0[v * nq + elem * S3 + j];
        sQ0[v * S3 + j] = q0v;
        qa[v] = q0v + qv;
      } else {
        qa[v] = qv;
      }
    }
    sV[j] = tv[0] / qa[0];
    sV[S3 + j] = tv[1];
    sV[2 * S3 + j] = tv[2];
    sV[3 * S3 + j] = tv[3];
    sV[4 * S3 + j] = tv[4] / qa[4];
    sqrtg = fld[F_SQRTG * fstride];
#pragma unroll
    for (int i = 0; i < 6; ++i) hm[i] = fld[(F_H + i) * fstride];
    // --- Pointwise: logs, pressure and its derivative, the direction's
    // sqrt(g)-weighted fluxes.
    const T rho = qa[0];
    if constexpr (!PERT) {
      u[0] = qa[1] / rho;
      u[1] = qa[2] / rho;
      u[2] = qa[3] / rho;
      sLog[j] = tlog(rho);
      sLog[S3 + j] = tlog(qa[4]);
      pres = pressure(qa[4]);
      sLp[j] = tlog(pres);
    } else {
      // u = u0 + (d(rho u) - u0 d(rho)) / rho, p = p0 + p0 expm1(gamma log1p(drt/rt0)).
      const T rho0 = sQ0[j], dr = sQ[j];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T u0 = sQ0[(1 + d) * S3 + j] / rho0;
        u[d] = u0 + (sQ[(1 + d) * S3 + j] - u0 * dr) / rho;
      }
      const T dlt = tlog1p(sQ[4 * S3 + j] / sQ0[4 * S3 + j]);
      sLog[j] = tlog1p(dr / rho0);
      sLog[S3 + j] = dlt;
      sLog0[j] = tlog(rho0);
      sLog0[S3 + j] = tlog(sQ0[4 * S3 + j]);
      p0v = pressure(sQ0[4 * S3 + j]);
      dpv = p0v * texpm1(gam * dlt);
      pres = p0v + dpv;
      sLp[j] = tlog1p(dpv / p0v);
      sLp0[j] = tlog(p0v);
    }
    const T tu[3] = {(tv[1] - u[0] * tv[0]) / rho, (tv[2] - u[1] * tv[0]) / rho, (tv[3] - u[2] * tv[0]) / rho};
    tpres = gam * pres * tv[4] / qa[4];
    sSg[j] = sqrtg * tv[0];
    const T tsgp = sqrtg * tpres;
    const T hrow[3][3] = {{hm[0], hm[1], hm[2]}, {hm[1], hm[3], hm[4]}, {hm[2], hm[4], hm[5]}};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T su = sqrtg * u[d], tsu = sqrtg * tu[d];
      T* fd = sF + d * 5 * S3 + j;
      fd[0] = tsu * qa[0] + su * tv[0];
      fd[S3] = (tsu * qa[1] + su * tv[1]) + tsgp * hrow[d][0];
      fd[2 * S3] = (tsu * qa[2] + su * tv[2]) + tsgp * hrow[d][1];
      fd[3 * S3] = tsu * qa[4] + su * tv[4];
      fd[4 * S3] = tsu * qa[3] + su * tv[3];
    }
  }
  __syncthreads();

  // --- Interface flux derivatives at this element's six faces (W, E, S, N, D, U).
  if (valid) {
#pragma unroll 1
    for (int fi = j; fi < NF; fi += S3) {
      const int face = fi / S2;
      const int k = fi - face * S2;
      const int d = face >> 1;
      const bool pos = face & 1;
      int base, stride;
      face_line<S>(d, k, base, stride);
      const T* coef = pos ? sEp : sEn;
      const T* nc = pos ? sEn : sEp;
      bool boundary;
      int hside, along;
      long long nb_elem;
      face_neighbour(face, nh, nk, kz, ey, ex, elem, boundary, hside, along, nb_elem);
      const long long h = ((((long long)(hside)*6 + p) * nk + kz) * nh + along) * S2 + k;
      const long long hv = 4LL * 6 * nk * nh * S2;  // stride between halo variables
      // own/nb: the absolute traces; own0/nb0 the base's and od/nd the
      // perturbation's (PERT); town/tnb the direction's.
      T own[5], town[5], nb[5], tnb[5], own0[5], nb0[5], od[5], nd[5];
      if constexpr (!PERT) {
        own_trace<T, S>(sQ, sLog, base, stride, coef, own);
      } else {
        own_trace<T, S>(sQ0, sLog0, base, stride, coef, own0);
        own_delta_trace<T, S>(sQ, sLog, base, stride, coef, own0, od);
#pragma unroll
        for (int v = 0; v < 5; ++v) own[v] = own0[v] + od[v];
      }
      own_tangent_trace<T, S>(sV, base, stride, coef, own, town);
      if (!boundary) {
        if constexpr (!PERT) {
          nb_trace<T, S>(q, nq, nb_elem, base, stride, nc, nb);
          nb_tangent_trace<T, S>(q, vd, nq, nb_elem, base, stride, nc, nb, tnb);
        } else {
          nb_trace<T, S>(q0, nq, nb_elem, base, stride, nc, nb0);
          nb_delta_trace<T, S>(q, q0, nq, nb_elem, base, stride, nc, nb0, nd);
#pragma unroll
          for (int v = 0; v < 5; ++v) nb[v] = nb0[v] + nd[v];
          nb_tangent_trace_pert<T, S>(q0, q, vd, nq, nb_elem, base, stride, nc, nb, tnb);
        }
      } else if (d < 2) {
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          if constexpr (PERT) {
            nb0[v] = halo0[v * hv + h];
            nd[v] = halo[v * hv + h];
            nb[v] = nb0[v] + nd[v];
          } else {
            nb[v] = halo[v * hv + h];
          }
          tnb[v] = thalo[v * hv + h];
        }
      } else {
#pragma unroll
        for (int v = 0; v < 5; ++v) {  // ground / rigid lid: mirror
          nb[v] = own[v];
          tnb[v] = town[v];
          if constexpr (PERT) {
            nb0[v] = own0[v];
            nd[v] = od[v];
          }
        }
      }
      T L[5], R[5], tL[5], tR[5];
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        L[v] = pos ? own[v] : nb[v];
        R[v] = pos ? nb[v] : own[v];
        tL[v] = pos ? town[v] : tnb[v];
        tR[v] = pos ? tnb[v] : town[v];
      }
      T vL = L[1 + d] / L[0];
      T vR = R[1 + d] / R[0];
      T tvL = (tL[1 + d] - vL * tL[0]) / L[0];
      T tvR = (tR[1 + d] - vR * tR[0]) / R[0];
      if (boundary && d == 2) {  // w is odd across the ground and the lid
        if (pos) {
          vR = -vR;
          tvR = -tvR;
        } else {
          vL = -vL;
          tvL = -tvL;
        }
      }

      T sg, h0, h1, h2;
      face_metric<T, S>(itf_x, itf_y, itf_z, d, pos, k, nh, nk, kz, ey, ex, sg, h0, h1, h2);
      const T hd = d == 0 ? h0 : (d == 1 ? h1 : h2);
      // Face pressures: absolute, or base + perturbation (PERT), with the
      // own side's values for the w-pressure split and the face log p.
      T pL, pR, wp, lp_own, dlp_own = T(0);
      if constexpr (!PERT) {
        pL = pressure(L[4]);
        pR = pressure(R[4]);
        const T p_own = pos ? pL : pR;
        wp = T(0.5) * (sg * h2 * pL + sg * h2 * pR) / p_own;
        lp_own = tlog(p_own);
      } else {
        const T L0_4 = pos ? own0[4] : nb0[4], R0_4 = pos ? nb0[4] : own0[4];
        const T dL_4 = pos ? od[4] : nd[4], dR_4 = pos ? nd[4] : od[4];
        const T pL0 = pressure(L0_4), pR0 = pressure(R0_4);
        const T dpL = pL0 * texpm1(gam * tlog1p(dL_4 / L0_4));
        const T dpR = pR0 * texpm1(gam * tlog1p(dR_4 / R0_4));
        pL = pL0 + dpL;
        pR = pR0 + dpR;
        const T p0_own = pos ? pL0 : pR0, dp_own = pos ? dpL : dpR;
        const T wpres0 = T(0.5) * sg * h2 * (pL0 + pR0), dwpres = T(0.5) * sg * h2 * (dpL + dpR);
        const T wp0 = wpres0 / p0_own, pa = p0_own + dp_own;
        wp = wp0 + (dwpres / pa - wp0 * (dp_own / pa));  // base + d[wpres / p]
        lp_own = tlog(p0_own);
        dlp_own = tlog1p(dp_own / p0_own);
      }
      T tf[4], twadv, twpres, tpL, tpR;
      rusanov_tangent(L, R, tL, tR, vL, vR, tvL, tvR, pL, pR, sg, h0, h1, h2, hd, tf, twadv, twpres, tpL, tpR);
      const T p_own = pos ? pL : pR;
      const T tp_own = pos ? tpL : tpR;
      T* fc = sFace + fi;
      fc[0] = tf[0];
      fc[NF] = tf[1];
      fc[2 * NF] = tf[2];
      fc[3 * NF] = tf[3];
      fc[4 * NF] = twadv;
      fc[5 * NF] = (twpres - wp * tp_own) / p_own;
      fc[6 * NF] = tp_own / p_own;
      fc[7 * NF] = wp;
      fc[8 * NF] = lp_own;
      if constexpr (PERT) fc[9 * NF] = dlp_own;
    }
  }
  __syncthreads();

  // --- Divergence + corrections, w pressure split, forcing: their derivatives.
  if (valid) {
    const int jx = j % S, jy = (j / S) % S, jz = j / S2;
    const int lx = (jz * S + jy) * S, ly = jz * S2 + jx, lz = jy * S + jx;
    const int kxf = jz * S + jy, kyf = jz * S + jx, kzf = jy * S + jx;
    const T* Dx = sD + jx * S;
    const T* Dy = sD + jy * S;
    const T* Dz = sD + jz * S;

    T div[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const T* fx = sF + c * S3;
      const T* fy = sF + (5 + c) * S3;
      const T* fz = sF + (10 + c) * S3;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dx[i], fx[lx + i], acc);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dy[i], fy[ly + i * S], acc);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dz[i], fz[lz + i * S2], acc);
      div[c] = acc;
    }
    const T cnx = sCn[jx], cpx = sCp[jx], cny = sCn[jy], cpy = sCp[jy], cnz = sCn[jz], cpz = sCp[jz];
    T corr[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const T* fc = sFace + c * NF;
      corr[c] = cnx * fc[kxf] + cpx * fc[S2 + kxf] + cny * fc[2 * S2 + kyf] + cpy * fc[3 * S2 + kyf] +
                cnz * fc[4 * S2 + kzf] + cpz * fc[5 * S2 + kzf];
    }
    // log p gradients (primal, from log p nodes `lp` and face row `row`)
    // and their derivatives: d log p = gamma v_rt / rt.
    auto dlog_p = [&](const T* lp, int row, T& dlx, T& dly, T& dlz) {
      const T* flp = sFace + row * NF;
      dlx = T(0), dly = T(0), dlz = T(0);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        dlx = fmadd(Dx[i], lp[lx + i], dlx);
        dly = fmadd(Dy[i], lp[ly + i * S], dly);
        dlz = fmadd(Dz[i], lp[lz + i * S2], dlz);
      }
      dlx += cnx * flp[kxf] + cpx * flp[S2 + kxf];
      dly += cny * flp[2 * S2 + kyf] + cpy * flp[3 * S2 + kyf];
      dlz += cnz * flp[4 * S2 + kzf] + cpz * flp[5 * S2 + kzf];
    };
    const T* tflp = sFace + 6 * NF;
    const T* sLt = sV + 4 * S3;
    T dlx, dly, dlz, tdlx = T(0), tdly = T(0), tdlz = T(0), grav = T(0);
    if constexpr (!PERT) {
      dlog_p(sLp, 8, dlx, dly, dlz);
    } else {  // the absolute gradient: the base's plus the perturbation's
      T d0x, d0y, d0z, ddx, ddy, ddz;
      dlog_p(sLp0, 8, d0x, d0y, d0z);
      dlog_p(sLp, 9, ddx, ddy, ddz);
      dlx = d0x + ddx;
      dly = d0y + ddy;
      dlz = d0z + ddz;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      tdlx = fmadd(Dx[i], sLt[lx + i], tdlx);
      tdly = fmadd(Dy[i], sLt[ly + i * S], tdly);
      tdlz = fmadd(Dz[i], sLt[lz + i * S2], tdlz);
      grav = fmadd(sHF[jz * S + i], sSg[lz + i * S2], grav);
    }
    tdlx = gam * tdlx + (cnx * tflp[kxf] + cpx * tflp[S2 + kxf]);
    tdly = gam * tdly + (cny * tflp[2 * S2 + kyf] + cpy * tflp[3 * S2 + kyf]);
    tdlz = gam * tdlz + (cnz * tflp[4 * S2 + kzf] + cpz * tflp[5 * S2 + kzf]);

    const T invsg = fld[F_INVSG * fstride];
    const T invdz = fld[F_INVDZ * fstride];
    const T wpres_int = fld[F_WPRES * fstride];
    const T rho = qa[0];
    const T tu[3] = {(tv[1] - u[0] * tv[0]) / rho, (tv[2] - u[1] * tv[0]) / rho, (tv[3] - u[2] * tv[0]) / rho};
    const T sh02 = sqrtg * hm[2], sh12 = sqrtg * hm[4], sh22 = sqrtg * hm[5];
    const T tw_df = div[4] + corr[4] + corr[5] * pres + (wpres_int + corr[7]) * tpres +
                    tpres * (sh02 * dlx + sh12 * dly + sh22 * dlz) +
                    pres * (sh02 * tdlx + sh12 * tdly + sh22 * tdlz);

    // Christoffel/Coriolis forcing, product rule: d(rho u_b u_c) and h^{bc} dp.
    const int B[6] = {0, 0, 0, 1, 1, 2}, C[6] = {0, 1, 2, 1, 2, 2};
    T tpair[6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      tpair[i] = (tv[0] * u[B[i]] * u[C[i]] + rho * tu[B[i]] * u[C[i]] + rho * u[B[i]] * tu[C[i]]) +
                 hm[i] * tpres;
    T force[3];
#pragma unroll
    for (int a_ = 0; a_ < 3; ++a_) {
      const T* ch = fld + (F_CHS + 6 * a_) * fstride;
      T fr = ch[0] * tpair[0];
      if (tch != nullptr) {
        const T* tc = tch + (long long)(3 * a_) * nq + elem * S3 + j;
        const T cu = tc[0] * u[0] + tc[nq] * u[1] + tc[2 * nq] * u[2];
        const T ctu = tc[0] * tu[0] + tc[nq] * tu[1] + tc[2 * nq] * tu[2];
        fr = T(2) * (tv[0] * cu + rho * ctu) + fr;
      }
      force[a_] = fr + T(2) * ch[fstride] * tpair[1] + T(2) * ch[2 * fstride] * tpair[2] +
                  ch[3 * fstride] * tpair[3] + T(2) * ch[4 * fstride] * tpair[4] + ch[5 * fstride] * tpair[5];
    }
    const T gravity = invdz * T(kGravity) * invsg * grav;

    const long long o = elem * S3 + j;
    out[o] = -invsg * (div[0] + corr[0]);
    out[nq + o] = -invsg * (div[1] + corr[1]) - force[0];
    out[2 * nq + o] = -invsg * (div[2] + corr[2]) - force[1];
    out[3 * nq + o] = -invsg * tw_df - (force[2] + gravity);
    out[4 * nq + o] = -invsg * (div[3] + corr[3]);
  }
}

template <typename T, int S, bool PERT>
cudaError_t launch_tangent(int nh, int nk, const void* q, const void* v, const void* halo, const void* thalo,
                           const void* ops, const void* fields, const void* tch, const void* itf_x,
                           const void* itf_y, const void* itf_z, const void* q0, const void* halo0, void* out,
                           cudaStream_t stream) {
  using Sh = TangentShape<T, S, PERT>;
  const size_t smem = sizeof(T) * (Sh::N_OPS + (size_t)Sh::EB * Sh::PER_ELEM);
  static bool configured = false;
  cudaError_t err = configure(euler3d_tangent_kernel<T, S, PERT>, smem, configured);
  if (err != cudaSuccess) return err;
  const int per_panel = nk * nh * nh;
  const int blocks = 6 * ((per_panel + Sh::EB - 1) / Sh::EB);
  euler3d_tangent_kernel<T, S, PERT><<<blocks, Sh::EB * Sh::S3, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(halo),
      static_cast<const T*>(thalo), static_cast<const T*>(ops), static_cast<const T*>(fields),
      static_cast<const T*>(tch), static_cast<const T*>(itf_x), static_cast<const T*>(itf_y),
      static_cast<const T*>(itf_z), static_cast<const T*>(q0), static_cast<const T*>(halo0),
      static_cast<T*>(out), nh, nk);
  return cudaGetLastError();
}

template <typename T, bool PERT>
cudaError_t dispatch_tangent(int s, int nh, int nk, const void* q, const void* v, const void* halo,
                             const void* thalo, const void* ops, const void* fields, const void* tch,
                             const void* itf_x, const void* itf_y, const void* itf_z, const void* q0,
                             const void* halo0, void* out, cudaStream_t stream) {
#define E3T_CASE(S)                                                                                         \
  case S:                                                                                                   \
    return launch_tangent<T, S, PERT>(nh, nk, q, v, halo, thalo, ops, fields, tch, itf_x, itf_y, itf_z, q0, \
                                      halo0, out, stream);
  switch (s) {
    E3T_CASE(2) E3T_CASE(3) E3T_CASE(4) E3T_CASE(5) E3T_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef E3T_CASE
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). tch == NULL: no time
// Christoffels; x == NULL: no x term; bal == NULL: no offset; traces == NULL:
// no trace emission; stage == 0: out = RHS(q) (+ bal). q0 != NULL:
// perturbation mode (q the perturbation, halo its delta halo, halo0 and
// rhs0 the base's; RHS mode only: x, bal and traces must be NULL).
extern "C" int euler3d_operator_launch(int is_f64, int s, int nh, int nk, const void* q,
                                       const void* halo, const void* ops, const void* fields,
                                       const void* tch, const void* itf_x, const void* itf_y,
                                       const void* itf_z, const void* x, const void* bal, const void* q0,
                                       const void* halo0, const void* rhs0, void* out, void* traces,
                                       double a, double b, double cdt, int stage, void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  const bool pert = q0 != nullptr;
  if (pert && (halo0 == nullptr || rhs0 == nullptr || x != nullptr || bal != nullptr || traces != nullptr ||
               stage != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_f64)
    err = pert ? dispatch<double, true>(s, nh, nk, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0,
                                        halo0, rhs0, out, traces, a, b, cdt, stage, st)
               : dispatch<double, false>(s, nh, nk, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0,
                                         halo0, rhs0, out, traces, a, b, cdt, stage, st);
  else
    err = pert ? dispatch<float, true>(s, nh, nk, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0,
                                       halo0, rhs0, out, traces, a, b, cdt, stage, st)
               : dispatch<float, false>(s, nh, nk, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0,
                                        halo0, rhs0, out, traces, a, b, cdt, stage, st);
  return (int)err;
}

extern "C" const char* euler3d_operator_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// J(q).v, the tangent mode. Returns the cudaError_t of the launch (0 on
// success); tch == NULL: no time Christoffels; q0 != NULL: perturbation
// mode, J(q0 + q).v (halo q's delta halo, halo0 q0's). The error string
// comes from euler3d_operator_error_string.
extern "C" int euler3d_tangent_launch(int is_f64, int s, int nh, int nk, const void* q, const void* v,
                                      const void* halo, const void* thalo, const void* ops,
                                      const void* fields, const void* tch, const void* itf_x,
                                      const void* itf_y, const void* itf_z, const void* q0, const void* halo0,
                                      void* out, void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  const bool pert = q0 != nullptr;
  if (pert && halo0 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_f64)
    err = pert ? dispatch_tangent<double, true>(s, nh, nk, q, v, halo, thalo, ops, fields, tch, itf_x, itf_y,
                                                itf_z, q0, halo0, out, st)
               : dispatch_tangent<double, false>(s, nh, nk, q, v, halo, thalo, ops, fields, tch, itf_x, itf_y,
                                                 itf_z, q0, halo0, out, st);
  else
    err = pert ? dispatch_tangent<float, true>(s, nh, nk, q, v, halo, thalo, ops, fields, tch, itf_x, itf_y,
                                               itf_z, q0, halo0, out, st)
               : dispatch_tangent<float, false>(s, nh, nk, q, v, halo, thalo, ops, fields, tch, itf_x, itf_y,
                                                itf_z, q0, halo0, out, st);
  return (int)err;
}
