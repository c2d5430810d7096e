// 3D Euler DFR spatial operator on the cubed sphere: an interface pass and
// a volume pass a call (below).
//
// Replaces the TPU kernel wxfactory_tpu/ops/pallas_euler3d.py:2131 (km3_fused,
// body _km3_body) in its absolute form: the RHS, optionally plus the
// well-balanced offset bal, optionally fused with the RK stage combination
// a*x + b*q + cdt*(RHS(q) + bal), optionally emitting the output's panel-edge
// traces for the next stage's halo. It computes what the JAX package's
// models/euler_cubesphere.py:90-291 (_euler3d_rhs_core) computes. The plain
// torch version of the same function is wxfactory_tpu_torch/ops/
// euler3d_operator.py::euler3d_operator_plain; the wrapper euler3d_operator
// there launches these kernels.
//
// Tile mode (C entry euler3d_tile_launch): the same kernels with a panel
// count of 1 instead of 6 replace pallas_euler3d.py::km3_tile, the per-rank
// kernel of the tile-parallel step (parallel/shard_map_euler3d_fused.py): one nt x nt
// tile of columns of one panel, all four horizontal edges from the halo, the
// tile's slices of the metric and of its own panel's time Christoffels, the
// absolute and perturbation modes, stage combination and all four sides'
// traces (km3_tile emits W/E only). A tile edge inside a panel behaves as a
// panel edge: its halo is the neighbour tile's emitted trace, which the
// emission computes in the fma order of the re-extrapolation (nb_trace) the
// whole-sphere launch does at that interface. Plain version: ops/
// euler3d_operator.py::euler3d_tile_operator_plain; wrapper:
// euler3d_tile_operator.
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
// Design: two kernels a call, on the caller's stream. The interface pass
// (euler3d_interface_kernel) takes one thread per interface point of the
// grid, so each interface is computed once: both sides' traces (log space
// for rho and rho*theta) re-extrapolated from the elements' states in
// device memory in one fma sequence (nb_trace), or the halo at a panel (tile)
// edge, or the mirror with w odd at the ground and the lid; the Rusanov flux
// with (L, R) in the fixed west/south/lower order through one call site;
// its rows (the four fluxes and the w advection, and each side's w
// pressure / p and log p; ItfRows) into device memory (ItfLayout). The
// volume pass (euler3d_volume_kernel) takes one thread per solution point,
// EB = 256 / s^3 elements per block, the panel the fastest block index (the
// one-panel metric is read from device memory about once and from L2 by the
// other five panels): the pointwise fluxes, the divergence (the 1D
// operators along one axis at a time; the 3D operators are never formed),
// the boundary corrections from the rows of the element's six faces, the w
// pressure split, gravity and forcing, the stage combination, the output
// and its panel-edge traces. Both elements of an interface read the one set
// of rows, so both sides get bit-identical fluxes (mass is conserved to
// round-off). The rows live between the two launches in memory from a pool
// of the library's own (rows_alloc): the C entries take no scratch buffer.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700.00 W power limit; float64,
// nel_h = nel_v = 20, s = 3, 48,000 elements, 1,296,000 points): each call
// must read q (51.8 MB), the one-panel metric (28 fields, 48.4 MB; 9 more
// full-size fields on a rotating planet), the interface metric (~7 MB), x
// in stage mode (51.8 MB) and write out (51.8 MB): ~155-210 MB, 46-63 us at
// 3.35 TB/s; its ~0.65 GFLOP take ~19 us at the 34 TFLOP/s f64 vector
// peak. The one-kernel operator this replaced (each element its six faces,
// the neighbour's trace re-extrapolated at every face, so each interface
// twice) took 0.323 ms for the RHS: its face loop 52-61 % of that, its
// neighbour re-extrapolation 24-28 %, at 2 blocks (486 threads) an SM in
// f64 and 1 in f64 PERT, set by its registers (tools/operator_ablation.py).
// Here (tools/operator_ablation.py, in turns with that kernel) the f64 RHS
// takes 0.292-0.293 ms against its 0.321-0.323, the f32 PERT stage + x +
// traces 0.293 against 0.407: the volume pass about what the replaced
// kernel took without its face loop (0.142 ms), the interface pass the
// rest (~0.150), latency-bound on its 30 scattered loads an interface point
// (0.209 with the halo read in their place), beside 98 MB of interface rows
// written and read (f64; ~0.06 ms of bandwidth). Staging strips of
// elements in shared memory for the interface pass (each node's logs once)
// and one patch kernel that marched up a column computing each interface
// once per block were both measured slower.

// Tangent prep and apply (euler3d_tangent_prep_kernel and
// euler3d_tangent_apply_kernel, C entries euler3d_tangent_prep_launch and
// euler3d_tangent_apply_launch): the Jacobian action J(q).v of the RHS
// above, replacing km3_fused's tangent mode (pallas_euler3d.py:2131 with
// tangent=, pallas_call :2398, body _km3_body :762-781, primal sites
// :945-969, :1138-1190, :1317-1380), the matvec of the exponential and
// Rosenbrock integrators' Krylov loops, split in two kernels because q is
// fixed for a whole Krylov solve and v changes every iteration. The prep
// runs once per linearisation point and writes every primal quantity the
// action needs that costs a transcendental, a square root, a division or
// a neighbour read into a coefficient buffer (ops/euler3d_operator.py::
// tangent_layout): per node 1/rho, 1/(rho theta), u, theta, p and the w
// pressure split's primal factor w_pres (wpres_int + the correction of the
// face w pressure / p + sqrt(g) h^{k2} d_k log p), element-major (each
// element's 8 s^3 a contiguous run, staged by the apply with cp.async);
// per interface point, once for both sides, in the interface metric's
// families and order: the L/R primal traces with their 1/rho and
// 1/(rho theta), sound speeds, gamma p/(rho theta), the pressure ratios,
// the Rusanov eigenvalue and the selector weight of d max(aL, aR). The
// apply reads v, its halo and the buffer and is linear in v: no
// transcendental, square root or division. It takes the absolute state;
// in PERT mode the prep forms every primal quantity as the perturbation
// form does (t0 + dt, p0 + dp, dlp0 + ddlp, the real log1p/expm1), and the
// apply is the same. Two non-differentiable sites take the convention of
// jax.jvp and of torch.func.jvp of the plain version: d|vn| = +dvn where
// vn >= 0 (zero included: a state at rest has vn = 0 at every z face),
// -dvn below; d max(aL, aR) = the larger side's derivative, the mean of
// both at a tie (exact at the ground and the lid, where both sides are the
// element's own trace with w odd and their derivatives are equal). The
// conservation discipline carries over: each element computes all six
// faces of the apply from the one stored set of interface coefficients,
// its own direction trace from shared memory and the neighbour's
// re-extrapolated from v and the neighbour's 1/rho, 1/(rho theta) (from
// shared memory when the neighbour is in the block: the same products) in
// the fma order the neighbour uses, with (L, R) in the fixed order through
// one call site, so the mass-flux derivative is bit-identical from both
// sides and J.v has zero mass integral to round-off. Face work runs face
// by face over the block's elements, so a warp takes one direction and
// side. Tensor cores do not apply: the contractions are s x s with s <= 6,
// far below wgmma's 64-row tiles.
//
// What bounds them (NVIDIA H100 80GB HBM3, 700 W power limit; dcmip31 at
// nel_h = nel_v = 20, s = 3; tools/tangent_ablation.py, 20 calls between
// CUDA events). The one-call kernel these replace took 0.774-0.782 ms in
// f64 and 0.391-0.394 ms in f32 PERT: its face loop (the neighbour's
// re-extrapolated logs and exps, the divisions) 66-68 % of that, its
// transcendentals 12-21 %, at one block (243 threads) an SM in f64 (166
// registers). The prep does that primal work once a step: 0.329-0.333 ms
// f64, 0.246-0.248 f32 PERT (its bytes bound 0.118 / 0.067 ms). The apply
// must read ~481 MB in f64 (the buffer is ~31 words a node against the
// state's 5): a floor of 0.144 ms (0.072 f32). It takes 0.471-0.482 ms f64
// and 0.243 f32 PERT at 128 registers and 2 blocks an SM in f64 (80 and 3
// in f32, 0.261 at 64 and 4; ApplyBlocks). The face loop is ~0.31 ms of it
// in f64, latency-bound rather than bytes-bound: its interface coefficient
// reads (22 rows a face point, each interface read from both sides) cost
// ~0.16 ms and the out-of-block neighbours' reads ~0.07. More blocks an SM
// spill (3 blocks in f64: 0.51 ms), loading the 22 coefficients up front
// spills (0.62 ms), and staging them into shared memory with word-granular
// cp.async costs more than the loads it replaces (0.71 ms). Reading each
// interface's coefficients once (as the operator's interface pass
// computes each interface once) is what would move it toward its floor.
//
// Terrain (DCMIP 20, 21, 22; C entries euler3d_operator_terrain_launch,
// euler3d_tangent_prep_terrain_launch, euler3d_tangent_apply_terrain_launch
// of the terrain library, this source built with -DE3_TERRAIN_LIBRARY):
// with bottom topography the metric differs from panel to panel, so these
// read every panel's interior fields (28, 6*nk*nh*nh, s^3) and interface
// metric (4, 6, ... per family) at the element's own panel. Each kernel of
// this file takes a compile-time flag TERRAIN (its last template argument;
// TERRAIN = false: one panel's metric, no sponge). The Rayleigh sponge
// of DCMIP 21/22 (the JAX package's extra_forcing, testcases/dcmip.py:
// 321-324 there) rides in a parameter of the volume pass and the apply that
// only their terrain instantiations read: sponge (4, 6*nk*nh*nh, s^3) = [mask | mask *
// u_ref of u1, u2, u3], NULL for none; the momentum forcing gains mask
// q[1+i] - q[0] (mask u_ref_i) (absolute mode; the perturbation mode takes
// no sponge), the apply its tangent mask v[1+i] - v[0] (mask u_ref_i), which
// needs no prep. A tile reads one panel, so the tile launch takes its own
// panel's slice of a per-panel metric in the one-panel layout.
//
// Perturbation mode (template flag PERT of the operator and prep kernels; C entries with
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
// rhs0 + delta, optionally fused with the RK stage combination of
// perturbations b*dq + cdt*(rhs0 + delta) (+ a*dx), which is the absolute
// stage because every TVD-RK3 and Euler stage has a + b = 1, and
// optionally emitting the output perturbation's delta panel-edge traces
// t0 * expm1(E.log1p(dout/q0)) around the base traces t0 (traces0, built
// in float64 and cast, as ops/euler3d_operator.py::edge_traces_delta has
// them), all four sides (km3_fused's stage and delta slabs,
// pallas_euler3d.py:1568-1645, emit W/E only; no bal); the tangent prep
// forms the linearisation at q0 + dq (above). It keeps the real
// log1p/expm1 (the JAX package writes them as compensated formulas because
// Mosaic lacks them). The volume pass's shared memory grows by q0 and log
// p0 (6 s^3 numbers an element), an interface point by two rows a side
// (log p0 and w pressure0 / p0); the delta traces read q0 from there.

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
// face `face` of element (kz, ey, ex). TERRAIN: every panel's metric, panel
// p of npanel (each family (4, npanel, ...)); else one panel's.
template <typename T, int S, bool TERRAIN>
__device__ __forceinline__ void face_metric(const T* itf_x, const T* itf_y, const T* itf_z, int d, bool pos, int k,
                                            int nh, int nk, int kz, int ey, int ex, T& sg, T& h0, T& h1, T& h2,
                                            int p, int npanel) {
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
  if constexpr (TERRAIN) {  // the panel's block of each row
    iidx += p * istride;
    istride *= npanel;
  }
  sg = itf[iidx];
  h0 = itf[istride + iidx];
  h1 = itf[2 * istride + iidx];
  h2 = itf[3 * istride + iidx];
}

// The 1D operators' layout in shared memory (in T), shared by the kernels
// of this file, and the elements a block of the tangent kernels takes (EB =
// 256 / s^3, one thread a node). Every region starts on a 16-byte boundary.
template <typename T, int S>
struct Shape {
  static constexpr int S2 = S * S;
  static constexpr int S3 = S * S * S;
  static constexpr int NF = 6 * S2;
  static constexpr int A = 16 / sizeof(T);
  static constexpr int pad(int n) { return (n + A - 1) / A * A; }
  // ops1d segments at 16-byte boundaries: the kernels select between the
  // en and ep pointers at run time, and nvcc then loads pairs of
  // coefficients as one 16-byte vector from either pointer.
  static constexpr int PS = pad(S), PS2 = pad(S2);
  static constexpr int N_OPS = 4 * PS + 2 * PS2;
  static constexpr int EB = kThreads / S3 > 0 ? kThreads / S3 : 1;
};

// ops1d into shared memory, each segment on a 16-byte boundary.
template <typename T, int S>
__device__ __forceinline__ void load_ops(const T* ops, T* smem) {
  using Sh = Shape<T, S>;
  for (int i = threadIdx.x; i < 4 * S + 2 * Sh::S2; i += blockDim.x) {
    const int dst = i < 4 * S ? (i / S) * Sh::PS + i % S
                              : 4 * Sh::PS + ((i - 4 * S) / Sh::S2) * Sh::PS2 + (i - 4 * S) % Sh::S2;
    smem[dst] = ops[i];
  }
}

// The interface rows of one interface point, kept in device memory between
// the two kernels of a call: the four fluxes and the w advection (or their
// deltas), which both sides read, then each side's own (L: the
// west/south/lower element, R: the other): w pressure / p and log p, in
// PERT mode d[w pressure / p], d log p, log p0 and w pressure0 / p0.
template <bool PERT>
struct ItfRows {
  static constexpr int SIDE = PERT ? 4 : 2;
  static constexpr int N = 5 + 2 * SIDE;
};

// Where the rows live: three families in the interface metric's order with
// the panel in front, x (npanel, nk, nh, nh+1, s^2), y (npanel, nk, nh+1, nh,
// s^2) and z (npanel, nk+1, nh, nh, s^2), each family row-major (row r of
// point i of family d at base(d) + r * count(d) + i).
struct ItfLayout {
  long long nx, nz;  // points of the x (and y) family and of the z family
  __host__ __device__ ItfLayout(int npanel, int nh, int nk, int s) {
    nx = (long long)npanel * nk * nh * (nh + 1) * s * s;
    nz = (long long)npanel * (nk + 1) * nh * nh * s * s;
  }
  __host__ __device__ long long points() const { return 2 * nx + nz; }
  __device__ __forceinline__ long long count(int d) const { return d == 2 ? nz : nx; }
  __device__ __forceinline__ long long base(int d, int rows) const { return d * rows * nx; }
};

// Where one side of an interface point takes its trace from: the element's
// state in device memory (re-extrapolated in nb_trace's fma order, the
// order every trace of this file is formed in), the halo (a panel or tile
// edge), or the other side (the ground and the lid, w odd).
enum TraceSource { kDevice, kHalo, kMirror };

// The trace of one side at face point k of a face normal to d, through the
// extrapolation coefficients coef: tr, and in PERT mode the base trace tr0
// and the perturbation's tr. elem: the side's element (kDevice), h: its
// halo entry (kHalo).
template <typename T, int S, bool PERT>
__device__ __forceinline__ void side_trace(TraceSource src, const T* q, const T* q0, const T* halo, const T* halo0,
                                           long long nq, long long elem, long long h, long long hv, int d, int k,
                                           const T* coef, T* tr0, T* tr) {
  int base, stride;
  face_line<S>(d, k, base, stride);
  if (src == kDevice) {
    if constexpr (PERT) {
      nb_trace<T, S>(q0, nq, elem, base, stride, coef, tr0);
      nb_delta_trace<T, S>(q, q0, nq, elem, base, stride, coef, tr0, tr);
    } else {
      nb_trace<T, S>(q, nq, elem, base, stride, coef, tr);
    }
  } else {
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      tr[v] = halo[v * hv + h];
      if constexpr (PERT) tr0[v] = halo0[v * hv + h];
    }
  }
}

constexpr int kItfThreads = 128;

// Resident blocks an SM the two kernels are compiled for: registers a thread
// at most 64 K / (threads a block x this).
template <typename T, bool PERT>
struct ItfBlocks {
  static constexpr int value = sizeof(T) == 8 ? (PERT ? 4 : 6) : (PERT ? 4 : 6);
};
template <typename T, bool PERT>
struct VolBlocks {
  static constexpr int value = sizeof(T) == 8 ? (PERT ? 2 : 2) : (PERT ? 4 : 4);
};

// The interface pass: one thread per interface point of the whole grid (of
// the sphere or the tile), each computed once. Both sides' traces from the
// elements' states in device memory, from the halo or mirrored; the
// Rusanov flux with (L, R) in the fixed west/south/lower order through one
// call site of rusanov / rusanov_delta; its rows into `rows`, each side's
// own rows only for a side that is an element of this grid.
template <typename T, int S, bool PERT, bool TERRAIN>
__global__ void __launch_bounds__(kItfThreads, ItfBlocks<T, PERT>::value) euler3d_interface_kernel(
    const T* __restrict__ q, const T* __restrict__ halo, const T* __restrict__ ops, const T* __restrict__ itf_x,
    const T* __restrict__ itf_y, const T* __restrict__ itf_z, const T* __restrict__ q0,
    const T* __restrict__ halo0, T* __restrict__ rows, int nh, int nk, int npanel) {
  using Ops = Shape<T, S>;
  constexpr int S2 = S * S, NR = ItfRows<PERT>::N, SR = ItfRows<PERT>::SIDE;
  __shared__ __align__(16) T sOps[2 * Ops::PS];  // en | ep, each on a 16-byte boundary
  if (threadIdx.x < 2 * S) sOps[(threadIdx.x / S) * Ops::PS + threadIdx.x % S] = ops[threadIdx.x];
  __syncthreads();
  const ItfLayout lay(npanel, nh, nk, S);
  long long i = blockIdx.x * (long long)kItfThreads + threadIdx.x;
  int d = 0;
  if (i >= lay.nx) {
    i -= lay.nx;
    d = 1;
    if (i >= lay.nx) {
      i -= lay.nx;
      d = 2;
      if (i >= lay.nz) return;
    }
  }
  const int per_panel = nk * nh * nh;
  const long long nq = (long long)npanel * per_panel * S * S2;  // stride between variables
  const long long hv = 4LL * npanel * nk * nh * S2;             // stride between halo variables
  const int k = (int)(i % S2);
  unsigned t = (unsigned)(i / S2);  // the interface in its family (32-bit: its divisions are cheaper)
  const unsigned uh = nh, uk = nk;
  int p, kz, gy, gx;  // the panel, the level (z: the interface gz), and the interface's row and column
  TraceSource sl = kDevice, sr = kDevice;
  long long el = 0, er = 0, hl = 0, hr = 0;
  if (d == 0) {  // between elements gx-1 (L) and gx (R) of row gy
    gx = (int)(t % (uh + 1));
    t /= uh + 1;
    gy = (int)(t % uh);
    t /= uh;
    kz = (int)(t % uk);
    p = (int)(t / uk);
    if (gx == 0) sl = kHalo;
    if (gx == nh) sr = kHalo;
    hl = ((((long long)2 * npanel + p) * nk + kz) * nh + gy) * S2 + k;  // W side
    hr = ((((long long)3 * npanel + p) * nk + kz) * nh + gy) * S2 + k;  // E side
    el = (long long)p * per_panel + (kz * nh + gy) * nh + gx - 1;
    er = el + 1;
  } else if (d == 1) {  // between elements gy-1 (L) and gy (R) of column gx
    gx = (int)(t % uh);
    t /= uh;
    gy = (int)(t % (uh + 1));
    t /= uh + 1;
    kz = (int)(t % uk);
    p = (int)(t / uk);
    if (gy == 0) sl = kHalo;
    if (gy == nh) sr = kHalo;
    hl = ((((long long)0 * npanel + p) * nk + kz) * nh + gx) * S2 + k;  // S side
    hr = ((((long long)1 * npanel + p) * nk + kz) * nh + gx) * S2 + k;  // N side
    el = (long long)p * per_panel + (kz * nh + gy - 1) * nh + gx;
    er = el + nh;
  } else {  // between levels kz-1 (L) and kz (R) of column (gy, gx)
    gx = (int)(t % uh);
    t /= uh;
    gy = (int)(t % uh);
    t /= uh;
    kz = (int)(t % (uk + 1));
    p = (int)(t / (uk + 1));
    if (kz == 0) sl = kMirror;
    if (kz == nk) sr = kMirror;
    el = (long long)p * per_panel + ((kz - 1) * nh + gy) * nh + gx;
    er = el + nh * nh;
  }
  T L0[5], R0[5], L[5], R[5];  // base traces (PERT) and the traces (PERT: their perturbations)
  if (sl != kMirror) side_trace<T, S, PERT>(sl, q, q0, halo, halo0, nq, el, hl, hv, d, k, sOps + Ops::PS, L0, L);
  if (sr != kMirror) side_trace<T, S, PERT>(sr, q, q0, halo, halo0, nq, er, hr, hv, d, k, sOps, R0, R);
#pragma unroll
  for (int v = 0; v < 5; ++v) {  // ground / rigid lid: mirror
    if (sl == kMirror) {
      L[v] = R[v];
      if constexpr (PERT) L0[v] = R0[v];
    }
    if (sr == kMirror) {
      R[v] = L[v];
      if constexpr (PERT) R0[v] = L0[v];
    }
  }
  T sg, h0, h1, h2;
  face_metric<T, S, TERRAIN>(itf_x, itf_y, itf_z, d, false, k, nh, nk, kz, gy, gx, sg, h0, h1, h2, p, npanel);
  const T hd = d == 0 ? h0 : (d == 1 ? h1 : h2);
  T* row = rows + lay.base(d, NR) + i;
  const long long rs = lay.count(d);  // stride between rows
  T* side_l = row + 5 * rs;
  T* side_r = row + (5 + SR) * rs;
  if constexpr (!PERT) {
    T vL = L[1 + d] / L[0];
    T vR = R[1 + d] / R[0];
    if (sl == kMirror) vL = -vL;  // w is odd across the ground and the lid
    if (sr == kMirror) vR = -vR;
    T f[4], wadv, wpres, pL, pR;
    rusanov(L, R, vL, vR, sg, h0, h1, h2, hd, f, wadv, wpres, pL, pR);
    row[0] = f[0];
    row[rs] = f[1];
    row[2 * rs] = f[2];
    row[3 * rs] = f[3];
    row[4 * rs] = wadv;
    if (sl == kDevice) {
      side_l[0] = wpres / pL;
      side_l[rs] = tlog(pL);
    }
    if (sr == kDevice) {
      side_r[0] = wpres / pR;
      side_r[rs] = tlog(pR);
    }
  } else {
    T v0L = L0[1 + d] / L0[0], v0R = R0[1 + d] / R0[0];
    T vaL = (L0[1 + d] + L[1 + d]) / (L0[0] + L[0]), vaR = (R0[1 + d] + R[1 + d]) / (R0[0] + R[0]);
    if (sl == kMirror) {  // w is odd across the ground and the lid
      v0L = -v0L;
      vaL = -vaL;
    }
    if (sr == kMirror) {
      v0R = -v0R;
      vaR = -vaR;
    }
    T df[4], dwadv, wpres0, dwpres, pL0, pR0, dpL, dpR;
    rusanov_delta(L0, R0, L, R, v0L, v0R, vaL, vaR, sg, h0, h1, h2, hd, df, dwadv, wpres0, dwpres, pL0, pR0, dpL,
                  dpR);
    row[0] = df[0];
    row[rs] = df[1];
    row[2 * rs] = df[2];
    row[3 * rs] = df[3];
    row[4 * rs] = dwadv;
    // A side's d[wpres / p], d[log p], log p0 and wpres0 / p0.
    auto side_rows = [&](T* out, T p0_own, T dp_own) {
      const T pa = p0_own + dp_own;
      const T wp0 = wpres0 / p0_own;
      out[0] = dwpres / pa - wp0 * (dp_own / pa);
      out[rs] = tlog1p(dp_own / p0_own);
      out[2 * rs] = tlog(p0_own);
      out[3 * rs] = wp0;
    };
    if (sl == kDevice) side_rows(side_l, pL0, dpL);
    if (sr == kDevice) side_rows(side_r, pR0, dpR);
  }
}

// Shared memory of the volume kernel (in T): ops1d, then per element [q (5
// s^3; the output once the divergence is formed) | log p (s^3) | sqrt(g)*rho
// (s^3) | fluxes (3 directions x 5 components x s^3: rho, rho*u1, rho*u2,
// rho*theta, w advection)], in perturbation mode (q, log p, sqrt(g)*rho and
// the fluxes then the perturbation's) also [q0 (5 s^3) | log p0 (s^3)].
// Every region starts on a 16-byte boundary.
template <typename T, int S, bool PERT>
struct VolShape {
  using Sh = Shape<T, S>;
  static constexpr int S2 = Sh::S2, S3 = Sh::S3, EB = Sh::EB;
  static constexpr int OFF_LP = Sh::pad(5 * S3);
  static constexpr int OFF_SG = OFF_LP + Sh::pad(S3);
  static constexpr int OFF_F = OFF_SG + Sh::pad(S3);
  static constexpr int OFF_Q0 = OFF_F + Sh::pad(15 * S3);
  static constexpr int OFF_LP0 = OFF_Q0 + (PERT ? Sh::pad(5 * S3) : 0);
  static constexpr int PER_ELEM = OFF_LP0 + (PERT ? Sh::pad(S3) : 0);
  static constexpr int SIZE = Sh::N_OPS + EB * PER_ELEM;
};

// The volume pass: one thread per solution point, EB = 256 / s^3 elements
// per block (the panel the fastest block index, so the one-panel metric is
// read from device memory about once and from L2 by the other five
// panels): the pointwise fluxes, the divergence, the boundary corrections
// from the interface rows of the element's six faces, the w pressure split,
// gravity and forcing, the stage combination, the output and its panel-edge
// traces.
// TERRAIN: every panel's metric (fields (28, npanel*nk*nh*nh, s^3)) and,
// in the absolute form, the Rayleigh sponge when `sponge` is not NULL (the
// kernels without terrain never read it).
template <typename T, int S, bool PERT, bool TERRAIN>
__global__ void __launch_bounds__(kThreads, VolBlocks<T, PERT>::value) euler3d_volume_kernel(
    const T* __restrict__ q, const T* __restrict__ ops, const T* __restrict__ fields, const T* __restrict__ tch,
    const T* __restrict__ x, const T* __restrict__ bal, const T* __restrict__ q0, const T* __restrict__ rhs0,
    const T* __restrict__ traces0, const T* __restrict__ rows, T* __restrict__ out, T* __restrict__ traces, int nh,
    int nk, int npanel, T a, T b, T cdt, int stage, const T* __restrict__ sponge) {
  using Sh = VolShape<T, S, PERT>;
  using Ops = Shape<T, S>;
  constexpr int S2 = Sh::S2, S3 = Sh::S3, NR = ItfRows<PERT>::N, SR = ItfRows<PERT>::SIDE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* sEn = smem;
  const T* sEp = smem + Ops::PS;
  const T* sCn = smem + 2 * Ops::PS;
  const T* sCp = smem + 3 * Ops::PS;
  const T* sD = smem + 4 * Ops::PS;
  const T* sHF = sD + Ops::PS2;
  const T gam = T(kGamma);

  const int tid = threadIdx.x;
  const int e_loc = tid / S3;
  const int j = tid - e_loc * S3;
  const int per_panel = nk * nh * nh;
  const int p = blockIdx.x % npanel;
  const int pe = (blockIdx.x / npanel) * Sh::EB + e_loc;
  const bool valid = pe < per_panel;
  const long long elem = (long long)p * per_panel + pe;
  const long long nq = (long long)npanel * per_panel * S3;  // stride between variables
  // stride between metric fields
  const long long fstride = TERRAIN ? nq : (long long)per_panel * S3;

  T* sQ = smem + Ops::N_OPS + e_loc * Sh::PER_ELEM;
  T* sLp = sQ + Sh::OFF_LP;
  T* sSg = sQ + Sh::OFF_SG;
  T* sF = sQ + Sh::OFF_F;
  T* sQ0 = sQ + Sh::OFF_Q0;
  T* sLp0 = sQ + Sh::OFF_LP0;
  load_ops<T, S>(ops, smem);

  int kz = 0, ey = 0, ex = 0;
  // pres: the absolute pressure, p0v and dpv its base and perturbation
  // (PERT); the state and the metric are read again after the barrier
  // (from shared memory and L1) instead of held across it in registers.
  T pres = T(0), p0v = T(0), dpv = T(0);
  const T* fld = fields + (long long)(valid ? (TERRAIN ? elem : pe) : 0) * S3 + j;
  if (valid) {
    kz = pe / (nh * nh);
    const int r = pe - kz * nh * nh;
    ey = r / nh;
    ex = r - ey * nh;
    // qv: the state (the perturbation in PERT mode), q0v: the base.
    T qv[5], q0v[5], hm[6];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      qv[v] = q[v * nq + elem * S3 + j];
      sQ[v * S3 + j] = qv[v];
      if constexpr (PERT) {
        q0v[v] = q0[v * nq + elem * S3 + j];
        sQ0[v * S3 + j] = q0v[v];
      }
    }
    const T sqrtg = fld[F_SQRTG * fstride];
#pragma unroll
    for (int i = 0; i < 6; ++i) hm[i] = fld[(F_H + i) * fstride];
    // h^{dk} for direction d: rows (00 01 02), (01 11 12), (02 12 22)
    const T hrow[3][3] = {{hm[0], hm[1], hm[2]}, {hm[1], hm[3], hm[4]}, {hm[2], hm[4], hm[5]}};
    if constexpr (!PERT) {
      // --- Pointwise: pressure, log p, sqrt(g)-weighted fluxes.
      const T rho = qv[0];
      const T u[3] = {qv[1] / rho, qv[2] / rho, qv[3] / rho};
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

  // --- Divergence + corrections, w pressure split, forcing, stage.
  if (valid) {
    const int jx = j % S, jy = (j / S) % S, jz = j / S2;
    const int lx = (jz * S + jy) * S, ly = jz * S2 + jx, lz = jy * S + jx;  // line bases
    const int kxf = jz * S + jy, kyf = jz * S + jx, kzf = jy * S + jx;    // face points
    const T* Dx = sD + jx * S;
    const T* Dy = sD + jy * S;
    const T* Dz = sD + jz * S;
    T qv[5], q0v[5], hm[6];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      qv[v] = sQ[v * S3 + j];
      if constexpr (PERT) q0v[v] = sQ0[v * S3 + j];
    }
    const T sqrtg = fld[F_SQRTG * fstride];
#pragma unroll
    for (int i = 0; i < 6; ++i) hm[i] = fld[(F_H + i) * fstride];

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
    // This node's six interface points (W, E, S, N, D, U) in the interface
    // rows, and its side of each: R at W, S, D; L at E, N, U.
    const ItfLayout lay(npanel, nh, nk, S);
    const T* rx = rows;
    const T* ry = rows + lay.base(1, NR);
    const T* rz = rows + lay.base(2, NR);
    const long long nx = lay.nx, nz = lay.nz;
    // The points' indices in their families (32-bit: a family holds fewer
    // than 2^31 points at any grid that fits the card).
    const int iw = (((p * nk + kz) * nh + ey) * (nh + 1) + ex) * S2 + kxf, ie = iw + S2;
    const int is = (((p * nk + kz) * (nh + 1) + ey) * nh + ex) * S2 + kyf, in = is + nh * S2;
    const int id = (((p * (nk + 1) + kz) * nh + ey) * nh + ex) * S2 + kzf, iu = id + nh * nh * S2;
    const T cnx = sCn[jx], cpx = sCp[jx], cny = sCn[jy], cpy = sCp[jy], cnz = sCn[jz], cpz = sCp[jz];
    // The boundary correction of shared row c, and of the sides' row 5 + c.
    auto corr_of = [&](int c) {
      return cnx * rx[c * nx + iw] + cpx * rx[c * nx + ie] + cny * ry[c * nx + is] + cpy * ry[c * nx + in] +
             cnz * rz[c * nz + id] + cpz * rz[c * nz + iu];
    };
    auto side_corr = [&](int c) {
      const int l = 5 + c, r = 5 + SR + c;
      return cnx * rx[r * nx + iw] + cpx * rx[l * nx + ie] + cny * ry[r * nx + is] + cpy * ry[l * nx + in] +
             cnz * rz[r * nz + id] + cpz * rz[l * nz + iu];
    };
    T corr[6];
#pragma unroll
    for (int c = 0; c < 5; ++c) corr[c] = corr_of(c);
    corr[5] = side_corr(0);
    // Log-pressure gradients along x, y, z (the perturbation's in PERT mode)
    // with the face log p corrections, from log p nodes `lp` and the sides'
    // row 5 + c.
    auto dlog_p = [&](const T* lp, int c, T& dlx, T& dly, T& dlz) {
      const int l = 5 + c, r = 5 + SR + c;
      dlx = T(0), dly = T(0), dlz = T(0);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        dlx = fmadd(Dx[i], lp[lx + i], dlx);
        dly = fmadd(Dy[i], lp[ly + i * S], dly);
        dlz = fmadd(Dz[i], lp[lz + i * S2], dlz);
      }
      dlx += cnx * rx[r * nx + iw] + cpx * rx[l * nx + ie];
      dly += cny * ry[r * nx + is] + cpy * ry[l * nx + in];
      dlz += cnz * rz[r * nz + id] + cpz * rz[l * nz + iu];
    };
    T dlx, dly, dlz, grav = T(0);
    dlog_p(sLp, 1, dlx, dly, dlz);
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
      const T wcorr0 = side_corr(3);
      T dl0x, dl0y, dl0z;
      dlog_p(sLp0, 2, dl0x, dl0y, dl0z);
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
    T force_w = force[2] + gravity;
    if constexpr (TERRAIN && !PERT) {
      if (sponge != nullptr) {  // Rayleigh sponge: mask q[1+i] - q[0] (mask u_ref_i)
        const T* sp = sponge + elem * S3 + j;
        force[0] = force[0] + (sp[0] * qv[1] - qv[0] * sp[nq]);
        force[1] = force[1] + (sp[0] * qv[2] - qv[0] * sp[2 * nq]);
        force_w = force_w + (sp[0] * qv[3] - qv[0] * sp[3 * nq]);
      }
    }

    T r[5];
    r[0] = -invsg * (div[0] + corr[0]);
    r[1] = -invsg * (div[1] + corr[1]) - force[0];
    r[2] = -invsg * (div[2] + corr[2]) - force[1];
    r[3] = -invsg * w_df - force_w;
    r[4] = -invsg * (div[3] + corr[3]);
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const long long o = v * nq + elem * S3 + j;
      T val = r[v];
      if constexpr (PERT) {
        val = rhs0[o] + val;
      } else {
        if (bal != nullptr) val += bal[o];
      }
      // The stage combination; in PERT mode on the perturbations (every
      // TVD-RK3 and Euler stage has a + b = 1, so it is the absolute one).
      if (stage) {
        val = b * qv[v] + cdt * val;
        if (x != nullptr) val = a * x[o] + val;
      }
      out[o] = val;
      sQ[v * S3 + j] = val;  // only this thread reads this slot from here on
    }
  }

  // --- Panel-edge traces of the output state (x and y faces on an edge);
  // in PERT mode the output perturbation's delta traces around the base
  // traces traces0: t0 * expm1(E.log1p(dout/q0)) for rho and rho*theta
  // (q0 still in shared memory), the momenta linear; in the fma order of
  // nb_trace / nb_delta_trace, which re-extrapolate them.
  if (traces != nullptr) {
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
          const bool lg = v == 0 || v == 4;
          const long long t = ((((long long)(v * 4 + tside) * npanel + p) * nk + kz) * nh + along) * S2 + k;
          T acc = T(0);
#pragma unroll
          for (int i = 0; i < S; ++i) {
            const int n = v * S3 + base + i * stride;
            T val = sQ[n];
            if (lg) {
              if constexpr (PERT) val = tlog1p(val / sQ0[n]);
              else val = tlog(val);
            }
            acc = fmadd(val, coef[i], acc);
          }
          if (lg) {
            if constexpr (PERT) acc = traces0[t] * texpm1(acc);
            else acc = texp(acc);
          }
          traces[t] = acc;
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

// The interface rows of a call live between its two launches: stream-ordered
// allocations from a memory pool of this library's own (one a device),
// which keeps freed memory for the next call instead of returning it to the
// system (the C entries' signatures carry no scratch buffer).
cudaError_t rows_alloc(void** ptr, size_t bytes, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static cudaMemPool_t pools[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (pools[dev] == nullptr) {
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = dev;
    cudaMemPool_t pool;
    err = cudaMemPoolCreate(&pool, &props);
    if (err != cudaSuccess) return err;
    unsigned long long keep = ~0ULL;
    err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) return err;
    pools[dev] = pool;
  }
  return cudaMallocFromPoolAsync(ptr, bytes, pools[dev], stream);
}

template <typename T, int S, bool PERT, bool TERRAIN>
cudaError_t launch(int nh, int nk, int npanel, const void* q, const void* halo, const void* ops,
                   const void* fields, const void* tch, const void* itf_x, const void* itf_y,
                   const void* itf_z, const void* x, const void* bal, const void* q0, const void* halo0,
                   const void* rhs0, const void* traces0, void* out, void* traces, double a, double b,
                   double cdt, int stage, const void* sponge, cudaStream_t stream) {
  using Sh = VolShape<T, S, PERT>;
  const size_t smem = sizeof(T) * (size_t)Sh::SIZE;
  static bool configured = false;
  cudaError_t err = configure(euler3d_volume_kernel<T, S, PERT, TERRAIN>, smem, configured);
  if (err != cudaSuccess) return err;
  const ItfLayout lay(npanel, nh, nk, S);
  void* rows = nullptr;
  err = rows_alloc(&rows, sizeof(T) * ItfRows<PERT>::N * (size_t)lay.points(), stream);
  if (err != cudaSuccess) return err;
  const unsigned itf_blocks = (unsigned)((lay.points() + kItfThreads - 1) / kItfThreads);
  euler3d_interface_kernel<T, S, PERT, TERRAIN><<<itf_blocks, kItfThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(halo), static_cast<const T*>(ops),
      static_cast<const T*>(itf_x), static_cast<const T*>(itf_y), static_cast<const T*>(itf_z),
      static_cast<const T*>(q0), static_cast<const T*>(halo0), static_cast<T*>(rows), nh, nk, npanel);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    const int blocks = npanel * ((nk * nh * nh + Sh::EB - 1) / Sh::EB);
    euler3d_volume_kernel<T, S, PERT, TERRAIN><<<blocks, Sh::EB * Sh::S3, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(ops), static_cast<const T*>(fields),
        static_cast<const T*>(tch), static_cast<const T*>(x), static_cast<const T*>(bal), static_cast<const T*>(q0),
        static_cast<const T*>(rhs0), static_cast<const T*>(traces0), static_cast<const T*>(rows),
        static_cast<T*>(out), static_cast<T*>(traces), nh, nk, npanel, T(a), T(b), T(cdt), stage,
        static_cast<const T*>(sponge));
    err = cudaGetLastError();
  }
  const cudaError_t freed = cudaFreeAsync(rows, stream);
  return err != cudaSuccess ? err : freed;
}

template <typename T, bool PERT, bool TERRAIN>
cudaError_t dispatch(int s, int nh, int nk, int npanel, const void* q, const void* halo, const void* ops,
                     const void* fields, const void* tch, const void* itf_x, const void* itf_y,
                     const void* itf_z, const void* x, const void* bal, const void* q0, const void* halo0,
                     const void* rhs0, const void* traces0, void* out, void* traces, double a, double b,
                     double cdt, int stage, const void* sponge, cudaStream_t stream) {
#define E3_CASE(S)                                                                                         \
  case S:                                                                                                  \
    return launch<T, S, PERT, TERRAIN>(nh, nk, npanel, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0, \
                                       halo0, rhs0, traces0, out, traces, a, b, cdt, stage, sponge, stream);
  switch (s) {
    E3_CASE(2) E3_CASE(3) E3_CASE(4) E3_CASE(5) E3_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef E3_CASE
}

template <bool TERRAIN>
int operator_launch(int npanel, int is_f64, int s, int nh, int nk, const void* q, const void* halo,
                    const void* ops, const void* fields, const void* tch, const void* itf_x, const void* itf_y,
                    const void* itf_z, const void* x, const void* bal, const void* q0, const void* halo0,
                    const void* rhs0, const void* traces0, void* out, void* traces, double a, double b, double cdt,
                    int stage, const void* sponge, void* stream) {
  const bool pert = q0 != nullptr;
  if (pert && (halo0 == nullptr || rhs0 == nullptr || bal != nullptr || (traces != nullptr && traces0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (pert && sponge != nullptr) return (int)cudaErrorInvalidValue;  // the perturbation form has no sponge
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_f64)
    err = pert ? dispatch<double, true, TERRAIN>(s, nh, nk, npanel, q, halo, ops, fields, tch, itf_x, itf_y, itf_z,
                                                 x, bal, q0, halo0, rhs0, traces0, out, traces, a, b, cdt, stage,
                                                 sponge, st)
               : dispatch<double, false, TERRAIN>(s, nh, nk, npanel, q, halo, ops, fields, tch, itf_x, itf_y, itf_z,
                                                  x, bal, q0, halo0, rhs0, traces0, out, traces, a, b, cdt, stage,
                                                  sponge, st);
  else
    err = pert ? dispatch<float, true, TERRAIN>(s, nh, nk, npanel, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x,
                                                bal, q0, halo0, rhs0, traces0, out, traces, a, b, cdt, stage, sponge,
                                                st)
               : dispatch<float, false, TERRAIN>(s, nh, nk, npanel, q, halo, ops, fields, tch, itf_x, itf_y, itf_z,
                                                 x, bal, q0, halo0, rhs0, traces0, out, traces, a, b, cdt, stage,
                                                 sponge, st);
  return (int)err;
}

// ---------------------------------------------------------------------------
// Tangent prep and apply

// Rows of the tangent coefficient buffer (ops/euler3d_operator.py,
// TANGENT_NODE_ROWS and TANGENT_FACE_ROWS).
constexpr int KN = 8;
constexpr int KF = 22;
constexpr int CN_IRHO = 0, CN_IRT = 1, CN_U = 2, CN_THETA = 5, CN_P = 6, CN_WPRES = 7;
constexpr int CF_L = 0, CF_R = 5, CF_IRHO = 10, CF_IRT = 12, CF_C = 14, CF_GP = 16, CF_RATIO = 18, CF_EIG = 20,
              CF_WL = 21;

// Offsets in the coefficient buffer (tangent_layout): node rows (6, nk, nh,
// nh, KN, s^3), then the x, y and z interface families (KF, 6, nk, nh,
// nh+1, s^2), (KF, 6, nk, nh+1, nh, s^2), (KF, 6, nk+1, nh, nh, s^2).
struct TangentLayout {
  long long fam_x, fam_z;  // entries per row (the y family has fam_x)
  long long base_x, base_y, base_z;
  __host__ __device__ TangentLayout(int nh, int nk, int s) {
    const long long s2 = (long long)s * s;
    fam_x = 6LL * nk * nh * (nh + 1) * s2;
    fam_z = 6LL * (nk + 1) * nh * nh * s2;
    base_x = 6LL * nk * nh * nh * KN * s2 * s;
    base_y = base_x + KF * fam_x;
    base_z = base_y + KF * fam_x;
  }
  // Row stride of family d, and the entry of face point k of face (d, pos)
  // of element (p, kz, ey, ex) in its row 0.
  __device__ __forceinline__ long long rows(int d) const { return d == 2 ? fam_z : fam_x; }
  __device__ __forceinline__ long long face(int d, bool pos, int k, int s2, int nh, int nk, int p, int kz, int ey,
                                            int ex) const {
    if (d == 0) return base_x + ((((long long)p * nk + kz) * nh + ey) * (nh + 1) + ex + pos) * s2 + k;
    if (d == 1) return base_y + ((((long long)p * nk + kz) * (nh + 1) + ey + pos) * nh + ex) * s2 + k;
    return base_z + ((((long long)p * (nk + 1) + kz + pos) * nh + ey) * nh + ex) * s2 + k;
  }
};

// The element (panel-local index pe) as (kz, ey, ex).
__device__ __forceinline__ void element_position(int pe, int nh, int& kz, int& ey, int& ex) {
  kz = pe / (nh * nh);
  const int r = pe - kz * nh * nh;
  ey = r / nh;
  ex = r - ey * nh;
}

// Shared memory of the prep (in T): ops1d, then per element [q (5 s^3) |
// log rho, log rho*theta (2 s^3) | log p (s^3) | face rows (2 x 6 s^2: the
// own side's w pressure / p and log p)]. In perturbation mode q, the logs
// and log p are the perturbation's, the element adds q0 (5 s^3) and log q0
// (2 s^3) after the logs and log p0 (s^3) after log p, and the face rows
// are w pressure / p (absolute), log p0 and the perturbation's d log p.
template <typename T, int S, bool PERT>
struct PrepShape {
  using Sh = Shape<T, S>;
  static constexpr int S2 = Sh::S2, S3 = Sh::S3, NF = Sh::NF, EB = Sh::EB, N_OPS = Sh::N_OPS;
  static constexpr int OFF_LOG = Sh::pad(5 * S3);
  static constexpr int OFF_Q0 = OFF_LOG + Sh::pad(2 * S3);
  static constexpr int OFF_LOG0 = OFF_Q0 + (PERT ? Sh::pad(5 * S3) : 0);
  static constexpr int OFF_LP = OFF_LOG0 + (PERT ? Sh::pad(2 * S3) : 0);
  static constexpr int OFF_LP0 = OFF_LP + Sh::pad(S3);
  static constexpr int OFF_FACE = OFF_LP0 + (PERT ? Sh::pad(S3) : 0);
  static constexpr int PER_ELEM = OFF_FACE + Sh::pad((PERT ? 3 : 2) * NF);
  static constexpr int SIZE = N_OPS + EB * PER_ELEM;
};


// The linearisation at q (q0 + dq in PERT mode, q then dq and halo its delta
// halo): every primal quantity of J(q).v that costs a transcendental, a
// square root, a division or a neighbour read, into the coefficient buffer.
// One thread per node, EB elements per block as the operator kernel. Each
// element computes the primal trace at all six faces (the neighbour's
// re-extrapolated from device memory in its own fma order, as the operator
// kernel does), its own side's face w pressure / p and log p for w_pres, and
// writes the interface coefficients of the faces it owns: its W, S, D faces
// and the E, N, U faces on a panel edge, the ground or the lid, so each
// interface point is written once. Face work runs face by face over the
// block's elements (item = (face, element, face point)), so a warp takes
// one direction and side.
template <typename T, int S, bool PERT, bool TERRAIN>
__global__ void __launch_bounds__(kThreads) euler3d_tangent_prep_kernel(
    const T* __restrict__ q, const T* __restrict__ halo, const T* __restrict__ ops, const T* __restrict__ fields,
    const T* __restrict__ itf_x, const T* __restrict__ itf_y, const T* __restrict__ itf_z,
    const T* __restrict__ q0, const T* __restrict__ halo0, T* __restrict__ coef, int nh, int nk) {
  using Sh = PrepShape<T, S, PERT>;
  using Ops = Shape<T, S>;
  constexpr int S2 = Sh::S2, S3 = Sh::S3, NF = Sh::NF, EB = Sh::EB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* sEn = smem;
  const T* sEp = smem + Ops::PS;
  const T* sCn = smem + 2 * Ops::PS;
  const T* sCp = smem + 3 * Ops::PS;
  const T* sD = smem + 4 * Ops::PS;
  const T gam = T(kGamma);

  const int tid = threadIdx.x;
  const int e_loc = tid / S3;
  const int j = tid - e_loc * S3;
  const int per_panel = nk * nh * nh;
  const int p = blockIdx.x % 6;
  const int pe0 = (blockIdx.x / 6) * EB;
  const int pe = pe0 + e_loc;
  const bool valid = pe < per_panel;
  const long long elem = (long long)p * per_panel + pe;
  const long long nq = 6LL * per_panel * S3;
  const long long fstride = TERRAIN ? nq : (long long)per_panel * S3;
  const TangentLayout lay(nh, nk, S);

  T* sQ = smem + Sh::N_OPS + e_loc * Sh::PER_ELEM;
  T* sLog = sQ + Sh::OFF_LOG;
  T* sQ0 = sQ + Sh::OFF_Q0;
  T* sLog0 = sQ + Sh::OFF_LOG0;
  T* sLp = sQ + Sh::OFF_LP;
  T* sLp0 = sQ + Sh::OFF_LP0;
  load_ops<T, S>(ops, smem);

  // --- Pointwise: the node rows but w_pres, the logs and log p.
  T* cn = coef + elem * (KN * S3) + j;
  if (valid) {
    T qv[5], q0v[5], qa[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      qv[v] = q[v * nq + elem * S3 + j];
      sQ[v * S3 + j] = qv[v];
      if constexpr (PERT) {
        q0v[v] = q0[v * nq + elem * S3 + j];
        sQ0[v * S3 + j] = q0v[v];
        qa[v] = q0v[v] + qv[v];
      } else {
        qa[v] = qv[v];
      }
    }
    const T rho = qa[0];
    T u[3], pres;
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
      const T rho0 = q0v[0], dr = qv[0];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T u0 = q0v[1 + d] / rho0;
        u[d] = u0 + (qv[1 + d] - u0 * dr) / rho;
      }
      const T dlt = tlog1p(qv[4] / q0v[4]);
      sLog[j] = tlog1p(dr / rho0);
      sLog[S3 + j] = dlt;
      sLog0[j] = tlog(rho0);
      sLog0[S3 + j] = tlog(q0v[4]);
      const T p0v = pressure(q0v[4]);
      const T dpv = p0v * texpm1(gam * dlt);
      pres = p0v + dpv;
      sLp[j] = tlog1p(dpv / p0v);
      sLp0[j] = tlog(p0v);
    }
    cn[CN_IRHO * S3] = T(1) / rho;
    cn[CN_IRT * S3] = T(1) / qa[4];
#pragma unroll
    for (int d = 0; d < 3; ++d) cn[(CN_U + d) * S3] = u[d];
    cn[CN_THETA * S3] = qa[4] / rho;
    cn[CN_P * S3] = pres;
  }
  __syncthreads();

  // --- Interface points: primal traces, speeds, pressures, sound speeds,
  // the Rusanov eigenvalue and its selector; the own side's face rows.
  const int n_items = 6 * EB * S2;
  for (int it = tid; it < n_items; it += blockDim.x) {
    const int face = it / (EB * S2);
    const int r = it - face * (EB * S2);
    const int e = r / S2;
    const int k = r - e * S2;
    const int pe_f = pe0 + e;
    if (pe_f >= per_panel) continue;
    const long long elem_f = (long long)p * per_panel + pe_f;
    int kz, ey, ex;
    element_position(pe_f, nh, kz, ey, ex);
    const int d = face >> 1;
    const bool pos = face & 1;
    int base, stride;
    face_line<S>(d, k, base, stride);
    const T* cf = pos ? sEp : sEn;
    const T* nc = pos ? sEn : sEp;  // the neighbour's facing face: its positive face when ours is negative
    bool boundary;
    int hside, along;
    long long nb_elem;
    face_neighbour(face, nh, nk, kz, ey, ex, elem_f, boundary, hside, along, nb_elem);
    const long long h = ((((long long)(hside)*6 + p) * nk + kz) * nh + along) * S2 + k;
    const long long hv = 4LL * 6 * nk * nh * S2;  // stride between halo variables
    T* eQ = smem + Sh::N_OPS + e * Sh::PER_ELEM;
    T* fc = eQ + Sh::OFF_FACE + face * S2 + k;
    T sg, h0, h1, h2;
    face_metric<T, S, TERRAIN>(itf_x, itf_y, itf_z, d, pos, k, nh, nk, kz, ey, ex, sg, h0, h1, h2, p, 6);
    const T hd = d == 0 ? h0 : (d == 1 ? h1 : h2);
    T own[5], nb[5], L[5], R[5], pL, pR;
    if constexpr (!PERT) {
      own_trace<T, S>(eQ, eQ + Sh::OFF_LOG, base, stride, cf, own);
      if (!boundary) {
        nb_trace<T, S>(q, nq, nb_elem, base, stride, nc, nb);
      } else if (d < 2) {
#pragma unroll
        for (int v = 0; v < 5; ++v) nb[v] = halo[v * hv + h];
      } else {
#pragma unroll
        for (int v = 0; v < 5; ++v) nb[v] = own[v];  // ground / rigid lid: mirror
      }
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        L[v] = pos ? own[v] : nb[v];
        R[v] = pos ? nb[v] : own[v];
      }
      pL = pressure(L[4]);
      pR = pressure(R[4]);
      const T p_own = pos ? pL : pR;
      fc[0] = T(0.5) * (sg * h2 * pL + sg * h2 * pR) / p_own;
      fc[NF] = tlog(p_own);
    } else {
      T own0[5], nb0[5], od[5], nd[5];
      own_trace<T, S>(eQ + Sh::OFF_Q0, eQ + Sh::OFF_LOG0, base, stride, cf, own0);
      own_delta_trace<T, S>(eQ, eQ + Sh::OFF_LOG, base, stride, cf, own0, od);
      if (!boundary) {
        nb_trace<T, S>(q0, nq, nb_elem, base, stride, nc, nb0);
        nb_delta_trace<T, S>(q, q0, nq, nb_elem, base, stride, nc, nb0, nd);
      } else if (d < 2) {
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          nb0[v] = halo0[v * hv + h];
          nd[v] = halo[v * hv + h];
        }
      } else {
#pragma unroll
        for (int v = 0; v < 5; ++v) {  // ground / rigid lid: mirror
          nb0[v] = own0[v];
          nd[v] = od[v];
        }
      }
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        own[v] = own0[v] + od[v];
        nb[v] = nb0[v] + nd[v];
        L[v] = pos ? own[v] : nb[v];
        R[v] = pos ? nb[v] : own[v];
      }
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
      fc[0] = wp0 + (dwpres / pa - wp0 * (dp_own / pa));  // base + d[wpres / p]
      fc[NF] = tlog(p0_own);
      fc[2 * NF] = tlog1p(dp_own / p0_own);
    }
    if (!pos || boundary) {  // this element owns the interface point
      T vL = L[1 + d] / L[0];
      T vR = R[1 + d] / R[0];
      if (boundary && d == 2) {  // w is odd across the ground and the lid
        if (pos) vR = -vR; else vL = -vL;
      }
      const T cL = sqrt_rn(hd * gam * pL / L[0]);
      const T cR = sqrt_rn(hd * gam * pR / R[0]);
      const T aL = fabs(vL) + cL, aR = fabs(vR) + cR;
      T* out = coef + lay.face(d, pos, k, S2, nh, nk, p, kz, ey, ex);
      const long long rs = lay.rows(d);
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        out[(CF_L + v) * rs] = L[v];
        out[(CF_R + v) * rs] = R[v];
      }
      out[CF_IRHO * rs] = T(1) / L[0];
      out[(CF_IRHO + 1) * rs] = T(1) / R[0];
      out[CF_IRT * rs] = T(1) / L[4];
      out[(CF_IRT + 1) * rs] = T(1) / R[4];
      out[CF_C * rs] = cL;
      out[(CF_C + 1) * rs] = cR;
      out[CF_GP * rs] = gam * pL / L[4];
      out[(CF_GP + 1) * rs] = gam * pR / R[4];
      out[CF_RATIO * rs] = pR / pL;
      out[(CF_RATIO + 1) * rs] = pL / pR;
      out[CF_EIG * rs] = fmax(aL, aR);
      // d max(aL, aR): the larger side's derivative, the mean of both at a tie.
      out[CF_WL * rs] = aL > aR ? T(1) : (aL < aR ? T(0) : T(0.5));
    }
  }
  __syncthreads();

  // --- w_pres = wpres_int + corr(w pressure / p) + sqrt(g) h^{k2} d_k log p.
  if (valid) {
    const int jx = j % S, jy = (j / S) % S, jz = j / S2;
    const int lx = (jz * S + jy) * S, ly = jz * S2 + jx, lz = jy * S + jx;
    const int kxf = jz * S + jy, kyf = jz * S + jx, kzf = jy * S + jx;
    const T* Dx = sD + jx * S;
    const T* Dy = sD + jy * S;
    const T* Dz = sD + jz * S;
    const T cnx = sCn[jx], cpx = sCp[jx], cny = sCn[jy], cpy = sCp[jy], cnz = sCn[jz], cpz = sCp[jz];
    const T* sFace = sQ + Sh::OFF_FACE;
    auto corr_of = [&](int c) {
      const T* f = sFace + c * NF;
      return cnx * f[kxf] + cpx * f[S2 + kxf] + cny * f[2 * S2 + kyf] + cpy * f[3 * S2 + kyf] +
             cnz * f[4 * S2 + kzf] + cpz * f[5 * S2 + kzf];
    };
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
    T dlx, dly, dlz;
    if constexpr (!PERT) {
      dlog_p(sLp, 1, dlx, dly, dlz);
    } else {  // the absolute gradient: the base's plus the perturbation's
      T d0x, d0y, d0z, ddx, ddy, ddz;
      dlog_p(sLp0, 1, d0x, d0y, d0z);
      dlog_p(sLp, 2, ddx, ddy, ddz);
      dlx = d0x + ddx;
      dly = d0y + ddy;
      dlz = d0z + ddz;
    }
    const T* fld = fields + (long long)(TERRAIN ? elem : pe) * S3 + j;
    const T sqrtg = fld[F_SQRTG * fstride];
    const T sh02 = sqrtg * fld[(F_H + 2) * fstride], sh12 = sqrtg * fld[(F_H + 4) * fstride],
            sh22 = sqrtg * fld[(F_H + 5) * fstride];
    cn[CN_WPRES * S3] = fld[F_WPRES * fstride] + corr_of(0) + (sh02 * dlx + sh12 * dly + sh22 * dlz);
  }
}

// Shared memory of the apply (in T): ops1d, then per element the
// log-tangent rows (v_rho/rho, v_1, v_2, v_3, v_rt/rt) and sqrt(g) v_rho
// (6 s^3; once the faces and gradients have read them, one direction's
// fluxes, 5 s^3), then per element the face rows (7 x 6 s^2: the
// derivatives of the four fluxes, of the w advection, of w pressure / p and
// of log p). Before the pointwise phase the face region holds the block's
// node coefficients (KN s^3 an element, packed), staged with cp.async.
template <typename T, int S>
struct ApplyShape {
  using Sh = Shape<T, S>;
  static constexpr int S2 = Sh::S2, S3 = Sh::S3, NF = Sh::NF, EB = Sh::EB;
  static constexpr int PER_LT = Sh::pad(6 * S3);
  static constexpr int PER_FACE = Sh::pad(7 * NF > KN * S3 ? 7 * NF : KN * S3);
  static constexpr int OFF_LT = Sh::N_OPS;
  static constexpr int OFF_FACE = OFF_LT + EB * PER_LT;
  static constexpr int SIZE = OFF_FACE + EB * PER_FACE;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// J(q).v from the coefficient buffer: linear in v, no transcendental,
// square root or division. One thread per node, EB elements per block.
// Each element computes the flux derivative at its six faces from the one
// stored set of interface coefficients, its own direction trace (from the
// log-tangent rows in shared memory) and the neighbour's, re-extrapolated
// from v and the neighbour's 1/rho, 1/(rho theta) in device memory in the
// fma order of the neighbour's own, with (L, R) in the fixed order through
// one call site: the mass-flux derivative is bit-identical from both sides.
// Resident blocks an SM the apply is compiled for: registers a thread at
// most 64 K / (256 x this).
template <typename T>
struct ApplyBlocks {
  static constexpr int value = sizeof(T) == 8 ? 2 : 3;
};

// TERRAIN: every panel's metric, and the sponge's tangent mask v[1+i] -
// v[0] (mask u_ref_i) when `sponge` is not NULL (the kernels without
// terrain never read it).
template <typename T, int S, bool TERRAIN>
__global__ void __launch_bounds__(kThreads, ApplyBlocks<T>::value) euler3d_tangent_apply_kernel(
    const T* __restrict__ vd, const T* __restrict__ thalo, const T* __restrict__ ops,
    const T* __restrict__ fields, const T* __restrict__ tch, const T* __restrict__ itf_x,
    const T* __restrict__ itf_y, const T* __restrict__ itf_z, const T* __restrict__ coef, T* __restrict__ out,
    int nh, int nk, const T* __restrict__ sponge) {
  using Sh = ApplyShape<T, S>;
  using Ops = Shape<T, S>;
  constexpr int S2 = Sh::S2, S3 = Sh::S3, NF = Sh::NF, EB = Sh::EB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* sEn = smem;
  const T* sEp = smem + Ops::PS;
  const T* sCn = smem + 2 * Ops::PS;
  const T* sCp = smem + 3 * Ops::PS;
  const T* sD = smem + 4 * Ops::PS;
  const T* sHF = sD + Ops::PS2;
  const T gam = T(kGamma);

  const int tid = threadIdx.x;
  const int e_loc = tid / S3;
  const int j = tid - e_loc * S3;
  const int per_panel = nk * nh * nh;
  const int p = blockIdx.x % 6;
  const int pe0 = (blockIdx.x / 6) * EB;
  const int pe = pe0 + e_loc;
  const bool valid = pe < per_panel;
  const long long elem = (long long)p * per_panel + pe;
  const long long nq = 6LL * per_panel * S3;
  const long long fstride = TERRAIN ? nq : (long long)per_panel * S3;
  const TangentLayout lay(nh, nk, S);

  // --- Stage the block's node coefficients (one contiguous run) while v,
  // ops1d and the metric load.
  const int n_block = per_panel - pe0 < EB ? per_panel - pe0 : EB;  // elements in this block
  {
    constexpr int W = 16 / sizeof(T);
    const T* src = coef + ((long long)p * per_panel + pe0) * (KN * S3);
    T* dst = smem + Sh::OFF_FACE;
    for (int c = tid; c < n_block * (KN * S3 / W); c += blockDim.x) cp_async16(dst + c * W, src + c * W);
    cp_async_commit();
  }
  load_ops<T, S>(ops, smem);
  T* sLT = smem + Sh::OFF_LT + e_loc * Sh::PER_LT;
  T tv[5] = {T(0), T(0), T(0), T(0), T(0)}, sqrtg = T(0);
  const T* fld = fields + (long long)(valid ? (TERRAIN ? elem : pe) : 0) * S3 + j;
  if (valid) {
#pragma unroll
    for (int v = 0; v < 5; ++v) tv[v] = vd[v * nq + elem * S3 + j];
    sqrtg = fld[F_SQRTG * fstride];
  }
  cp_async_wait_all();
  __syncthreads();

  // --- Pointwise: node coefficients into registers, the log-tangent rows.
  T irho = T(0), irt = T(0), u[3] = {T(0), T(0), T(0)}, theta = T(0), pres = T(0), wpres = T(0);
  if (valid) {
    const T* sn = smem + Sh::OFF_FACE + e_loc * (KN * S3) + j;
    irho = sn[CN_IRHO * S3];
    irt = sn[CN_IRT * S3];
#pragma unroll
    for (int d = 0; d < 3; ++d) u[d] = sn[(CN_U + d) * S3];
    theta = sn[CN_THETA * S3];
    pres = sn[CN_P * S3];
    wpres = sn[CN_WPRES * S3];
    sLT[j] = tv[0] * irho;
    sLT[S3 + j] = tv[1];
    sLT[2 * S3 + j] = tv[2];
    sLT[3 * S3 + j] = tv[3];
    sLT[4 * S3 + j] = tv[4] * irt;
    sLT[5 * S3 + j] = sqrtg * tv[0];
  }
  __syncthreads();

  // --- Interface flux derivatives at the six faces (W, E, S, N, D, U) of
  // every element, face by face over the block's elements.
  const int n_items = 6 * EB * S2;
  for (int it = tid; it < n_items; it += blockDim.x) {
    const int face = it / (EB * S2);
    const int r = it - face * (EB * S2);
    const int e = r / S2;
    const int k = r - e * S2;
    const int pe_f = pe0 + e;
    if (pe_f >= per_panel) continue;
    const long long elem_f = (long long)p * per_panel + pe_f;
    int kz, ey, ex;
    element_position(pe_f, nh, kz, ey, ex);
    const int d = face >> 1;
    const bool pos = face & 1;
    int base, stride;
    face_line<S>(d, k, base, stride);
    const T* cf = pos ? sEp : sEn;
    const T* nc = pos ? sEn : sEp;
    bool boundary;
    int hside, along;
    long long nb_elem;
    face_neighbour(face, nh, nk, kz, ey, ex, elem_f, boundary, hside, along, nb_elem);

    // The interface's coefficients (row r of family d at ci[r * rs]).
    const T* ci = coef + lay.face(d, pos, k, S2, nh, nk, p, kz, ey, ex);
    const long long rs = lay.rows(d);
    const int own_side = pos ? CF_L : CF_R, nb_side = pos ? CF_R : CF_L;

    // Direction traces: the own side's from the log-tangent rows, the
    // neighbour's re-extrapolated in the same fma order, from the halo, or
    // the mirror; log-space rows times the primal trace.
    const T* lt = smem + Sh::OFF_LT + e * Sh::PER_LT;
    const T* cnb = coef + nb_elem * (KN * S3) + base;
    // A neighbour in this block has its log-tangent rows in shared memory,
    // the same products v * (1/rho) the re-extrapolation forms.
    const long long nb_loc = nb_elem - ((long long)p * per_panel + pe0);
    const bool nb_local = !boundary && nb_loc >= 0 && nb_loc < n_block;
    const T* nlt = smem + Sh::OFF_LT + (nb_local ? nb_loc : 0) * Sh::PER_LT;
    const long long h = ((((long long)(hside)*6 + p) * nk + kz) * nh + along) * S2 + k;
    const long long hv = 4LL * 6 * nk * nh * S2;
    T tL[5], tR[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const bool lg = v == 0 || v == 4;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(lt[v * S3 + base + i * stride], cf[i], acc);
      const T town = lg ? ci[(own_side + v) * rs] * acc : acc;
      T tnb;
      if (nb_local) {  // the neighbour's log-tangent rows, from shared memory
        T nacc = T(0);
#pragma unroll
        for (int i = 0; i < S; ++i) nacc = fmadd(nlt[v * S3 + base + i * stride], nc[i], nacc);
        tnb = lg ? ci[(nb_side + v) * rs] * nacc : nacc;
      } else if (!boundary) {  // from v and its node coefficients in device memory, in the same fma order
        const T* src = vd + v * nq + nb_elem * S3 + base;
        T nacc = T(0);
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const T x = src[i * stride];
          const T val = v == 0 ? x * cnb[CN_IRHO * S3 + i * stride] : (v == 4 ? x * cnb[CN_IRT * S3 + i * stride] : x);
          nacc = fmadd(val, nc[i], nacc);
        }
        tnb = lg ? ci[(nb_side + v) * rs] * nacc : nacc;
      } else if (d < 2) {
        tnb = thalo[v * hv + h];
      } else {
        tnb = town;  // ground / rigid lid: mirror
      }
      tL[v] = pos ? town : tnb;
      tR[v] = pos ? tnb : town;
    }

    // The Rusanov flux derivative with the rho*w advection/pressure split.
    const T iL0 = ci[CF_IRHO * rs], iR0 = ci[(CF_IRHO + 1) * rs];
    const T iL4 = ci[CF_IRT * rs], iR4 = ci[(CF_IRT + 1) * rs];
    T vL = ci[(CF_L + 1 + d) * rs] * iL0, vR = ci[(CF_R + 1 + d) * rs] * iR0;
    T tvL = (tL[1 + d] - vL * tL[0]) * iL0, tvR = (tR[1 + d] - vR * tR[0]) * iR0;
    if (boundary && d == 2) {  // w is odd across the ground and the lid
      if (pos) {
        vR = -vR;
        tvR = -tvR;
      } else {
        vL = -vL;
        tvL = -tvL;
      }
    }
    // d|vn| = +dvn at vn >= 0 (zero included), d max(aL, aR) by the weights.
    const T lL = gam * iL4 * tL[4], lR = gam * iR4 * tR[4];  // d log p of each side
    const T taL = (vL >= T(0) ? tvL : -tvL) + T(0.5) * ci[CF_C * rs] * (lL - iL0 * tL[0]);
    const T taR = (vR >= T(0) ? tvR : -tvR) + T(0.5) * ci[(CF_C + 1) * rs] * (lR - iR0 * tR[0]);
    const T wL = ci[CF_WL * rs];
    const T teig = wL * taL + (T(1) - wL) * taR;
    T sg, h0, h1, h2;
    face_metric<T, S, TERRAIN>(itf_x, itf_y, itf_z, d, pos, k, nh, nk, kz, ey, ex, sg, h0, h1, h2, p, 6);
    const T sl = sg * vL, sr = sg * vR, es = ci[CF_EIG * rs] * sg;
    const T tsl = sg * tvL, tsr = sg * tvR, tes = teig * sg;
    const T tps = T(0.5) * (ci[CF_GP * rs] * tL[4] + ci[(CF_GP + 1) * rs] * tR[4]);
    T* fc = smem + Sh::OFF_FACE + e * Sh::PER_FACE + face * S2 + k;
    // Face rows: rho, rho*u1, rho*u2, rho*theta, w advection (v = 0, 1, 2, 4, 3).
    constexpr int ROW[5] = {0, 1, 2, 4, 3};
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const T L = ci[(CF_L + v) * rs], R = ci[(CF_R + v) * rs];
      T adv = T(0.5) * ((tsl * L + sl * tL[v]) + (tsr * R + sr * tR[v]) - (tes * (R - L) + es * (tR[v] - tL[v])));
      if (v == 1) adv += sg * h0 * tps;
      if (v == 2) adv += sg * h1 * tps;
      fc[ROW[v] * NF] = adv;
    }
    // The own side's d[w pressure / p] = 0.5 sg h2 (p_other / p_own)(d log
    // p_other - d log p_own), and its d log p.
    fc[5 * NF] = pos ? T(0.5) * sg * h2 * ci[CF_RATIO * rs] * (lR - lL)
                     : T(0.5) * sg * h2 * ci[(CF_RATIO + 1) * rs] * (lL - lR);
    fc[6 * NF] = pos ? lL : lR;
  }
  __syncthreads();

  // --- The log-tangent rows' part of the w pressure split and gravity,
  // before the direction fluxes take over the log-tangent region.
  const int jx = j % S, jy = (j / S) % S, jz = j / S2;
  const int lx = (jz * S + jy) * S, ly = jz * S2 + jx, lz = jy * S + jx;  // line bases
  const int kxf = jz * S + jy, kyf = jz * S + jx, kzf = jy * S + jx;    // face points
  const T* Dx = sD + jx * S;
  const T* Dy = sD + jy * S;
  const T* Dz = sD + jz * S;
  const T cnx = sCn[jx], cpx = sCp[jx], cny = sCn[jy], cpy = sCp[jy], cnz = sCn[jz], cpz = sCp[jz];
  const T* sFace = smem + Sh::OFF_FACE + e_loc * Sh::PER_FACE;
  T pgrad = T(0), grav = T(0);  // sqrt(g) h^{k2} d_k (d log p), the filtered sqrt(g) v_rho
  if (valid) {
    const T* lt4 = sLT + 4 * S3;
    const T* sG = sLT + 5 * S3;
    T tdlx = T(0), tdly = T(0), tdlz = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      tdlx = fmadd(Dx[i], lt4[lx + i], tdlx);
      tdly = fmadd(Dy[i], lt4[ly + i * S], tdly);
      tdlz = fmadd(Dz[i], lt4[lz + i * S2], tdlz);
      grav = fmadd(sHF[jz * S + i], sG[lz + i * S2], grav);
    }
    const T* flp = sFace + 6 * NF;
    tdlx = gam * tdlx + (cnx * flp[kxf] + cpx * flp[S2 + kxf]);
    tdly = gam * tdly + (cny * flp[2 * S2 + kyf] + cpy * flp[3 * S2 + kyf]);
    tdlz = gam * tdlz + (cnz * flp[4 * S2 + kzf] + cpz * flp[5 * S2 + kzf]);
    pgrad = sqrtg * fld[(F_H + 2) * fstride] * tdlx + sqrtg * fld[(F_H + 4) * fstride] * tdly +
            sqrtg * fld[(F_H + 5) * fstride] * tdlz;
  }

  // --- Divergence of the pointwise flux derivatives sqrt(g) (w_d q_c/rho +
  // u_d v_c) (+ the pressure's), w_d = v_{1+d} - u_d v_rho, one direction
  // at a time in the log-tangent region.
  const T tpres = gam * pres * irt * tv[4];
  const T tsgp = sqrtg * tpres;
  T w[3], div[5] = {T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int d = 0; d < 3; ++d) w[d] = tv[1 + d] - u[d] * tv[0];
  // h^{d0}, h^{d1}: rows (00 01), (01 11), (02 12) of the field h.
  constexpr int HD0[3] = {0, 1, 2}, HD1[3] = {1, 3, 4};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    __syncthreads();
    if (valid) {
      const T phi[5] = {T(1), u[0], u[1], u[2], theta};
      T fl[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) fl[c] = sqrtg * (w[d] * phi[c] + u[d] * tv[c]);
      sLT[j] = fl[0];
      sLT[S3 + j] = fl[1] + tsgp * fld[(F_H + HD0[d]) * fstride];
      sLT[2 * S3 + j] = fl[2] + tsgp * fld[(F_H + HD1[d]) * fstride];
      sLT[3 * S3 + j] = fl[4];
      sLT[4 * S3 + j] = fl[3];
    }
    __syncthreads();
    if (valid) {
      const T* Dd = d == 0 ? Dx : (d == 1 ? Dy : Dz);
      const int line = d == 0 ? lx : (d == 1 ? ly : lz);
      const int step = d == 0 ? 1 : (d == 1 ? S : S2);
#pragma unroll
      for (int c = 0; c < 5; ++c) {
#pragma unroll
        for (int i = 0; i < S; ++i) div[c] = fmadd(Dd[i], sLT[c * S3 + line + i * step], div[c]);
      }
    }
  }
  if (!valid) return;

  // Boundary corrections of the face rows at this node.
  T corr[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const T* f = sFace + c * NF;
    corr[c] = cnx * f[kxf] + cpx * f[S2 + kxf] + cny * f[2 * S2 + kyf] + cpy * f[3 * S2 + kyf] +
              cnz * f[4 * S2 + kzf] + cpz * f[5 * S2 + kzf];
  }
  const T invsg = fld[F_INVSG * fstride];
  const T invdz = fld[F_INVDZ * fstride];
  const T tw_df = div[4] + corr[4] + corr[5] * pres + wpres * tpres + pres * pgrad;

  // Christoffel/Coriolis forcing: d(rho u_b u_c) = v_rho u_b u_c + w_b u_c +
  // u_b w_c and h^{bc} dp; the Coriolis term is linear in the momenta.
  const int B[6] = {0, 0, 0, 1, 1, 2}, C[6] = {0, 1, 2, 1, 2, 2};
  T tpair[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    tpair[i] = (tv[0] * u[B[i]] * u[C[i]] + w[B[i]] * u[C[i]] + u[B[i]] * w[C[i]]) + fld[(F_H + i) * fstride] * tpres;
  T force[3];
#pragma unroll
  for (int a_ = 0; a_ < 3; ++a_) {
    const T* ch = fld + (F_CHS + 6 * a_) * fstride;
    T fr = ch[0] * tpair[0];
    if (tch != nullptr) {
      const T* tc = tch + (long long)(3 * a_) * nq + elem * S3 + j;
      fr = T(2) * (tc[0] * tv[1] + tc[nq] * tv[2] + tc[2 * nq] * tv[3]) + fr;
    }
    force[a_] = fr + T(2) * ch[fstride] * tpair[1] + T(2) * ch[2 * fstride] * tpair[2] + ch[3 * fstride] * tpair[3] +
                T(2) * ch[4 * fstride] * tpair[4] + ch[5 * fstride] * tpair[5];
  }
  const T gravity = invdz * T(kGravity) * invsg * grav;
  T force_w = force[2] + gravity;
  if constexpr (TERRAIN) {
    if (sponge != nullptr) {  // the Rayleigh sponge's tangent: mask v[1+i] - v[0] (mask u_ref_i)
      const T* sp = sponge + elem * S3 + j;
      force[0] = force[0] + (sp[0] * tv[1] - tv[0] * sp[nq]);
      force[1] = force[1] + (sp[0] * tv[2] - tv[0] * sp[2 * nq]);
      force_w = force_w + (sp[0] * tv[3] - tv[0] * sp[3 * nq]);
    }
  }

  const long long o = elem * S3 + j;
  out[o] = -invsg * (div[0] + corr[0]);
  out[nq + o] = -invsg * (div[1] + corr[1]) - force[0];
  out[2 * nq + o] = -invsg * (div[2] + corr[2]) - force[1];
  out[3 * nq + o] = -invsg * tw_df - force_w;
  out[4 * nq + o] = -invsg * (div[3] + corr[3]);
}

template <typename T, int S, bool PERT, bool TERRAIN>
cudaError_t launch_prep(int nh, int nk, const void* q, const void* halo, const void* ops, const void* fields,
                        const void* itf_x, const void* itf_y, const void* itf_z, const void* q0, const void* halo0,
                        void* coef, cudaStream_t stream) {
  using Sh = PrepShape<T, S, PERT>;
  const size_t smem = sizeof(T) * (size_t)Sh::SIZE;
  static bool configured = false;
  cudaError_t err = configure(euler3d_tangent_prep_kernel<T, S, PERT, TERRAIN>, smem, configured);
  if (err != cudaSuccess) return err;
  const int blocks = 6 * ((nk * nh * nh + Sh::EB - 1) / Sh::EB);
  euler3d_tangent_prep_kernel<T, S, PERT, TERRAIN><<<blocks, Sh::EB * Sh::S3, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(halo), static_cast<const T*>(ops),
      static_cast<const T*>(fields), static_cast<const T*>(itf_x), static_cast<const T*>(itf_y),
      static_cast<const T*>(itf_z), static_cast<const T*>(q0), static_cast<const T*>(halo0), static_cast<T*>(coef),
      nh, nk);
  return cudaGetLastError();
}

template <typename T, int S, bool TERRAIN>
cudaError_t launch_apply(int nh, int nk, const void* v, const void* thalo, const void* ops, const void* fields,
                         const void* tch, const void* itf_x, const void* itf_y, const void* itf_z, const void* coef,
                         void* out, const void* sponge, cudaStream_t stream) {
  using Sh = ApplyShape<T, S>;
  const size_t smem = sizeof(T) * (size_t)Sh::SIZE;
  static bool configured = false;
  cudaError_t err = configure(euler3d_tangent_apply_kernel<T, S, TERRAIN>, smem, configured);
  if (err != cudaSuccess) return err;
  const int blocks = 6 * ((nk * nh * nh + Sh::EB - 1) / Sh::EB);
  euler3d_tangent_apply_kernel<T, S, TERRAIN><<<blocks, Sh::EB * Sh::S3, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(thalo), static_cast<const T*>(ops),
      static_cast<const T*>(fields), static_cast<const T*>(tch), static_cast<const T*>(itf_x),
      static_cast<const T*>(itf_y), static_cast<const T*>(itf_z), static_cast<const T*>(coef), static_cast<T*>(out),
      nh, nk, static_cast<const T*>(sponge));
  return cudaGetLastError();
}

// Registers, local (spill) bytes, dynamic shared memory and resident blocks
// an SM of one kernel instantiation, as the runtime reports them.
template <typename Kernel>
cudaError_t kernel_resources(Kernel kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  bool configured = false;
  err = configure(kernel, smem, configured);
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
cudaError_t tangent_resources(int kernel, int* info) {
  if (kernel == 2)
    return kernel_resources(euler3d_tangent_apply_kernel<T, S, false>, ApplyShape<T, S>::EB * ApplyShape<T, S>::S3,
                            sizeof(T) * (size_t)ApplyShape<T, S>::SIZE, info);
  using P1 = PrepShape<T, S, true>;
  using P0 = PrepShape<T, S, false>;
  if (kernel == 1)
    return kernel_resources(euler3d_tangent_prep_kernel<T, S, true, false>, P1::EB * P1::S3, sizeof(T) * (size_t)P1::SIZE,
                            info);
  return kernel_resources(euler3d_tangent_prep_kernel<T, S, false, false>, P0::EB * P0::S3, sizeof(T) * (size_t)P0::SIZE,
                          info);
}

template <typename T, int S, bool PERT>
cudaError_t operator_resources(int kernel, int* info) {
  if (kernel == 0)
    return kernel_resources(euler3d_interface_kernel<T, S, PERT, false>, kItfThreads, 0, info);
  using Sh = VolShape<T, S, PERT>;
  return kernel_resources(euler3d_volume_kernel<T, S, PERT, false>, Sh::EB * Sh::S3, sizeof(T) * (size_t)Sh::SIZE, info);
}

// The terrain kernels' resources: 0 the interface pass, 1 the volume pass,
// 2 and 3 theirs in perturbation mode, 4 the prep, 5 the perturbation
// prep, 6 the apply.
template <typename T, int S>
cudaError_t terrain_resources(int kernel, int* info) {
  using V0 = VolShape<T, S, false>;
  using V1 = VolShape<T, S, true>;
  using P0 = PrepShape<T, S, false>;
  using P1 = PrepShape<T, S, true>;
  using A = ApplyShape<T, S>;
  switch (kernel) {
    case 0: return kernel_resources(euler3d_interface_kernel<T, S, false, true>, kItfThreads, 0, info);
    case 1:
      return kernel_resources(euler3d_volume_kernel<T, S, false, true>, V0::EB * V0::S3,
                              sizeof(T) * (size_t)V0::SIZE, info);
    case 2: return kernel_resources(euler3d_interface_kernel<T, S, true, true>, kItfThreads, 0, info);
    case 3:
      return kernel_resources(euler3d_volume_kernel<T, S, true, true>, V1::EB * V1::S3,
                              sizeof(T) * (size_t)V1::SIZE, info);
    case 4:
      return kernel_resources(euler3d_tangent_prep_kernel<T, S, false, true>, P0::EB * P0::S3,
                              sizeof(T) * (size_t)P0::SIZE, info);
    case 5:
      return kernel_resources(euler3d_tangent_prep_kernel<T, S, true, true>, P1::EB * P1::S3,
                              sizeof(T) * (size_t)P1::SIZE, info);
    case 6:
      return kernel_resources(euler3d_tangent_apply_kernel<T, S, true>, A::EB * A::S3, sizeof(T) * (size_t)A::SIZE,
                              info);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool PERT>
cudaError_t dispatch_operator_resources(int s, int kernel, int* info) {
  switch (s) {
    case 2: return operator_resources<T, 2, PERT>(kernel, info);
    case 3: return operator_resources<T, 3, PERT>(kernel, info);
    case 4: return operator_resources<T, 4, PERT>(kernel, info);
    case 5: return operator_resources<T, 5, PERT>(kernel, info);
    case 6: return operator_resources<T, 6, PERT>(kernel, info);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool PERT, bool TERRAIN>
cudaError_t dispatch_prep(int s, int nh, int nk, const void* q, const void* halo, const void* ops, const void* fields,
                          const void* itf_x, const void* itf_y, const void* itf_z, const void* q0, const void* halo0,
                          void* coef, cudaStream_t stream) {
#define E3P_CASE(S)                                                                                             \
  case S:                                                                                                       \
    return launch_prep<T, S, PERT, TERRAIN>(nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, q0, halo0, coef, \
                                            stream);
  switch (s) {
    E3P_CASE(2) E3P_CASE(3) E3P_CASE(4) E3P_CASE(5) E3P_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef E3P_CASE
}

template <typename T, bool TERRAIN>
cudaError_t dispatch_apply(int s, int nh, int nk, const void* v, const void* thalo, const void* ops,
                           const void* fields, const void* tch, const void* itf_x, const void* itf_y,
                           const void* itf_z, const void* coef, void* out, const void* sponge, cudaStream_t stream) {
#define E3A_CASE(S)                                                                                             \
  case S:                                                                                                       \
    return launch_apply<T, S, TERRAIN>(nh, nk, v, thalo, ops, fields, tch, itf_x, itf_y, itf_z, coef, out, sponge, \
                                       stream);
  switch (s) {
    E3A_CASE(2) E3A_CASE(3) E3A_CASE(4) E3A_CASE(5) E3A_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef E3A_CASE
}

template <bool TERRAIN>
int prep_launch(int is_f64, int s, int nh, int nk, const void* q, const void* halo, const void* ops,
                const void* fields, const void* itf_x, const void* itf_y, const void* itf_z, const void* q0,
                const void* halo0, void* coef, void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  const bool pert = q0 != nullptr;
  if (pert && halo0 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_f64)
    err = pert ? dispatch_prep<double, true, TERRAIN>(s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, q0, halo0,
                                                      coef, st)
               : dispatch_prep<double, false, TERRAIN>(s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, q0,
                                                       halo0, coef, st);
  else
    err = pert ? dispatch_prep<float, true, TERRAIN>(s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, q0, halo0,
                                                     coef, st)
               : dispatch_prep<float, false, TERRAIN>(s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, q0,
                                                      halo0, coef, st);
  return (int)err;
}

template <typename T>
cudaError_t dispatch_resources(int s, int kernel, int* info) {
  switch (s) {
    case 2: return tangent_resources<T, 2>(kernel, info);
    case 3: return tangent_resources<T, 3>(kernel, info);
    case 4: return tangent_resources<T, 4>(kernel, info);
    case 5: return tangent_resources<T, 5>(kernel, info);
    case 6: return tangent_resources<T, 6>(kernel, info);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_terrain_resources(int s, int kernel, int* info) {
  switch (s) {
    case 2: return terrain_resources<T, 2>(kernel, info);
    case 3: return terrain_resources<T, 3>(kernel, info);
    case 4: return terrain_resources<T, 4>(kernel, info);
    case 5: return terrain_resources<T, 5>(kernel, info);
    case 6: return terrain_resources<T, 6>(kernel, info);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* euler3d_operator_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The library without terrain (built from this source as it is) and the
// terrain library (built with -DE3_TERRAIN_LIBRARY, ops/euler3d_operator.py
// loads it as "euler3d_terrain"): each compiles only the kernels its entries
// launch, so the two build in parallel and neither unit holds the other's
// kernels.
#ifndef E3_TERRAIN_LIBRARY

// Returns the cudaError_t of the launch (0 on success). tch == NULL: no time
// Christoffels; x == NULL: no x term; bal == NULL: no offset; traces == NULL:
// no trace emission; stage == 0: out = RHS(q) (+ bal). q0 != NULL:
// perturbation mode (q the perturbation, halo its delta halo, halo0 and
// rhs0 the base's; x and out perturbations, traces the output's delta
// traces around the base traces traces0; bal must be NULL).
extern "C" int euler3d_operator_launch(int is_f64, int s, int nh, int nk, const void* q,
                                       const void* halo, const void* ops, const void* fields,
                                       const void* tch, const void* itf_x, const void* itf_y,
                                       const void* itf_z, const void* x, const void* bal, const void* q0,
                                       const void* halo0, const void* rhs0, const void* traces0, void* out,
                                       void* traces, double a, double b, double cdt, int stage, void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  return operator_launch<false>(6, is_f64, s, nh, nk, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0,
                                halo0, rhs0, traces0, out, traces, a, b, cdt, stage, nullptr, stream);
}

// The same operator over ONE tile of nt x nt columns of nk elements (the port
// of pallas_euler3d.py::km3_tile): the layouts above with one panel, so q, x,
// out (5, nk*nt*nt, s^3), halo and traces (5, 4, 1, nk, nt, s^2) on all four
// tile edges, fields (28, nk*nt*nt, s^3) the tile's slice of the one-panel
// metric (with topography: of its own panel's, ops/euler3d_operator.py::
// tile_constants), tch (9, nk*nt*nt, s^3) the tile's slice of its own
// panel's time Christoffels (or NULL), itf_x (4, nk, nt, nt+1, s^2), itf_y
// (4, nk, nt+1, nt, s^2), itf_z (4, nk+1, nt, nt, s^2); the perturbation
// base likewise.
extern "C" int euler3d_tile_launch(int is_f64, int s, int nt, int nk, const void* q, const void* halo,
                                   const void* ops, const void* fields, const void* tch, const void* itf_x,
                                   const void* itf_y, const void* itf_z, const void* x, const void* bal,
                                   const void* q0, const void* halo0, const void* rhs0, const void* traces0,
                                   void* out, void* traces, double a, double b, double cdt, int stage,
                                   void* stream) {
  if (nt < 1 || nk < 1) return (int)cudaErrorInvalidValue;
  return operator_launch<false>(1, is_f64, s, nt, nk, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0,
                                halo0, rhs0, traces0, out, traces, a, b, cdt, stage, nullptr, stream);
}

// The linearisation at q (tangent prep): the coefficient buffer ``coef``
// (layout: ops/euler3d_operator.py::tangent_layout). q0 != NULL:
// perturbation mode, the linearisation at q0 + q (halo q's delta halo,
// halo0 q0's). Returns the cudaError_t of the launch (0 on success).
extern "C" int euler3d_tangent_prep_launch(int is_f64, int s, int nh, int nk, const void* q, const void* halo,
                                           const void* ops, const void* fields, const void* itf_x,
                                           const void* itf_y, const void* itf_z, const void* q0, const void* halo0,
                                           void* coef, void* stream) {
  return prep_launch<false>(is_f64, s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, q0, halo0, coef, stream);
}

// What the runtime reports of the operator's kernels (kernel 0: the
// interface pass, 1: the volume pass; pert: their perturbation mode): info =
// [registers, local (spill) bytes a thread, dynamic shared memory bytes a
// block, resident blocks an SM, threads a block].
extern "C" int euler3d_operator_resources(int is_f64, int s, int pert, int kernel, int* info) {
  if (is_f64)
    return (int)(pert ? dispatch_operator_resources<double, true>(s, kernel, info)
                      : dispatch_operator_resources<double, false>(s, kernel, info));
  return (int)(pert ? dispatch_operator_resources<float, true>(s, kernel, info)
                    : dispatch_operator_resources<float, false>(s, kernel, info));
}

// J.v from the coefficient buffer ``coef`` of a prep, the direction v and
// its halo thalo (tangent apply); tch == NULL: no time Christoffels.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int euler3d_tangent_apply_launch(int is_f64, int s, int nh, int nk, const void* v, const void* thalo,
                                            const void* ops, const void* fields, const void* tch,
                                            const void* itf_x, const void* itf_y, const void* itf_z,
                                            const void* coef, void* out, void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_f64 ? dispatch_apply<double, false>(s, nh, nk, v, thalo, ops, fields, tch, itf_x, itf_y, itf_z, coef, out,
                                             nullptr, st)
             : dispatch_apply<float, false>(s, nh, nk, v, thalo, ops, fields, tch, itf_x, itf_y, itf_z, coef, out,
                                            nullptr, st);
  return (int)err;
}

// What the runtime reports of a tangent kernel (kernel 0: prep, 1: the
// perturbation prep, 2: apply): info = [registers, local (spill) bytes a
// thread, dynamic shared memory bytes a block, resident blocks an SM,
// threads a block].
extern "C" int euler3d_tangent_resources(int is_f64, int s, int kernel, int* info) {
  return (int)(is_f64 ? dispatch_resources<double>(s, kernel, info) : dispatch_resources<float>(s, kernel, info));
}

#else  // E3_TERRAIN_LIBRARY

// The operator (euler3d_operator_launch's arguments and layouts) on a
// geometry with topography (DCMIP 20, 21, 22): fields (28,
// 6*nk*nh*nh, s^3) and itf_x (4, 6, nk, nh, nh+1, s^2), itf_y (4, 6, nk,
// nh+1, nh, s^2), itf_z (4, 6, nk+1, nh, nh, s^2) every panel's metric;
// sponge (4, 6*nk*nh*nh, s^3): the Rayleigh sponge's mask and mask * u_ref
// of u1, u2, u3 (NULL: none; the perturbation mode takes none).
extern "C" int euler3d_operator_terrain_launch(int is_f64, int s, int nh, int nk, const void* q, const void* halo,
                                               const void* ops, const void* fields, const void* tch,
                                               const void* itf_x, const void* itf_y, const void* itf_z,
                                               const void* x, const void* bal, const void* q0, const void* halo0,
                                               const void* rhs0, const void* traces0, void* out, void* traces,
                                               double a, double b, double cdt, int stage, const void* sponge,
                                               void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  return operator_launch<true>(6, is_f64, s, nh, nk, q, halo, ops, fields, tch, itf_x, itf_y, itf_z, x, bal, q0,
                               halo0, rhs0, traces0, out, traces, a, b, cdt, stage, sponge, stream);
}

// The same on every panel's metric (a geometry with topography; the
// layouts of euler3d_operator_terrain_launch).
extern "C" int euler3d_tangent_prep_terrain_launch(int is_f64, int s, int nh, int nk, const void* q,
                                                   const void* halo, const void* ops, const void* fields,
                                                   const void* itf_x, const void* itf_y, const void* itf_z,
                                                   const void* q0, const void* halo0, void* coef, void* stream) {
  return prep_launch<true>(is_f64, s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, q0, halo0, coef, stream);
}

// The same on every panel's metric (a geometry with topography), with the
// Rayleigh sponge's tangent (sponge as in euler3d_operator_terrain_launch;
// NULL: none).
extern "C" int euler3d_tangent_apply_terrain_launch(int is_f64, int s, int nh, int nk, const void* v,
                                                    const void* thalo, const void* ops, const void* fields,
                                                    const void* tch, const void* itf_x, const void* itf_y,
                                                    const void* itf_z, const void* coef, void* out,
                                                    const void* sponge, void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_f64 ? dispatch_apply<double, true>(s, nh, nk, v, thalo, ops, fields, tch, itf_x, itf_y, itf_z, coef, out,
                                            sponge, st)
             : dispatch_apply<float, true>(s, nh, nk, v, thalo, ops, fields, tch, itf_x, itf_y, itf_z, coef, out,
                                           sponge, st);
  return (int)err;
}

// What the runtime reports of a terrain kernel (kernel 0: the interface
// pass, 1: the volume pass, 2 and 3: theirs in perturbation mode, 4: the
// prep, 5: the perturbation prep, 6: the apply): info = [registers, local
// (spill) bytes a thread, dynamic shared memory bytes a block, resident
// blocks an SM, threads a block].
extern "C" int euler3d_terrain_resources(int is_f64, int s, int kernel, int* info) {
  return (int)(is_f64 ? dispatch_terrain_resources<double>(s, kernel, info)
                      : dispatch_terrain_resources<float>(s, kernel, info));
}

#endif  // E3_TERRAIN_LIBRARY
