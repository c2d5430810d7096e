// Device code shared by the shallow-water kernels (csrc/sw_operator.cu and
// csrc/sw_run.cu): the element-block body of the DFR operator in its absolute
// and perturbation forms, the AUSM flux's tangent split into its primal
// coefficients and their linear action (the tangent kernels'), the
// panel-edge traces of a state and the halo exchange of traces. Every kernel
// that computes one of these functions calls the same device function, with
// each sum and each fused multiply-add written out in a fixed order, so the
// per-stage kernels and the whole-run kernel give
// the same bits for the same inputs. A panel-edge face takes its neighbour's
// values from one of three sources (HaloFrom): a halo plane, the neighbour
// panels' traces (halo_point), or the neighbour panels' state itself
// (state_halo_point: edge_trace then the halo's rotation, the composition of
// the edge-trace and halo kernels at one point, so all three give the same
// bits).
//
// Bottom topography (the absolute state mode and the tangent kernels, TOPO):
// the faces extrapolate h + hsurf (face_trace_sum: each node's sum, then the
// same fma order as face_trace, wherever the nodes live), the panel-edge face
// the neighbour's h + hsurf through the same src/flip tables as its q (h is a
// scalar: no rotation); both sides of an interface then subtract that
// interface's hsurf_itf in the same order before the flux, so they see the
// same face h; the forcing rows add g(H^11 dz1 + H^12 dz2) h and g(H^21 dz1 +
// H^22 dz2) h from planes made once at setup. With all-zero planes every
// value is the TOPO = false value bit for bit (x + 0 = x, fma(0, h, f) = f).
// The perturbation form with topography (PERT and TOPO, state mode): the
// topography rides the base (the base traces itf0 and halo0 are those of h0
// + hsurf with each interface's hsurf already taken away, made once in
// float64 at setup), the delta traces and halo are those of dh alone, and
// the forcing rows add the delta g(H^a1 dz1 + H^a2 dz2) dh in the same sum
// (the JAX package's rhs_delta_core with topography,
// models/shallow_water.py:346-421 there); it reads the forcing planes only.
//
// Sum factorisation. The operator's extrapolation, derivative and
// correction matrices are Kronecker products with the identity
// (ops/dfr.py), so every face point depends on the s nodes of one row or
// column, every node's divergence on s x-terms and s y-terms, and its
// correction on its 4 faces. The body computes exactly those terms from the
// 1D factors (load_factors: a few hundred bytes of shared memory), in the
// order in which the dense products of the TPU kernel meet their non-zero
// terms; an fma with an exact zero leaves a sum as it was, so for a finite
// state it gives the dense products' bits with s times fewer operations and,
// for a neighbour's trace, s values a variable read instead of s^2.
//
// Layouts (C order, T = float or double; P = npanel, 6 for the whole
// cubed sphere, 1 for one tile of it, whose four edges all come from the halo):
//   q, x, out  (3, P*nel*nel, s^2)   element (panel, ey, ex), node ky*s + kx
//   halo       (3, 4, P, nel, s)     neighbour traces, sides (S, N, W, E)
//   traces     (3, 4, P, nel, s)     a state's own panel-edge (tile-edge) traces
//   ops        EE (s^2, 4s) | DD (2s^2, s^2) | CC (4s, s^2), faces (W, E, S, N)
//   fields     (13, nel*nel, s^2)    one panel's metric (identical on all six;
//                                    a tile's slice of it for a tile)
//   gridrot    (P*nel*nel, s^2)      panel-dependent factor of the time Christoffels
//   itf_x      (3, nel, nel+1, s)    sqrt(g), H^11, H^21 at x1 interfaces
//   itf_y      (3, nel+1, nel, s)    sqrt(g), H^22, H^12 at x2 interfaces
// Topography (TOPO): hsurf (P*nel*nel, s^2) at the nodes, hsurf_x (P, nel,
// nel+1, s) and hsurf_y (P, nel+1, nel, s) at the interfaces, force (2,
// P*nel*nel, s^2) the two forcing coefficients g(H^1b dz_b), g(H^2b dz_b).
// Perturbation form (the 14 base planes of pallas_sw_gen.build_base_planes in
// the model layout): q0 (3, ...) and u0 = hu0/h0 (2, ...) at the nodes, itf0
// (3, P*nel*nel, 4s) the base state's face traces, halo0 (3, 4, P, nel, s) its
// halo, rhs0 (3, ...) its float64 RHS cast to T.
// Halo tables (P = 6 only): src (24) the neighbour's (side*6 + panel) row
// feeding each (side*6 + panel) row, flip (24) 1 where that edge runs
// opposite, conv (4, 24, nel*s) the 2x2 contravariant rotation c11, c12, c21,
// c22 (ops/sw_operator.py::panel_edge_plan mirrors their use in numpy).

#pragma once

#include <cuda_runtime.h>

namespace swk {

constexpr double kGravity = 9.80616;
constexpr int kThreads = 256;

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float sqrt_rn(float v) { return __fsqrt_rn(v); }
__device__ __forceinline__ double sqrt_rn(double v) { return __dsqrt_rn(v); }

// Face point k of face f (0 west, 1 east, 2 south, 3 north) of one variable
// of an element (s^2 nodes, node ky*s + kx): the s nodes of its row (west,
// east: row k) or column (south, north: column k) times the face's 1D
// extrapolation weights w, ascending node index, explicit fma. The dense
// EE column meets the same non-zero terms in the same order, and an fma with
// an exact zero leaves a sum unchanged, so for a finite state this is the
// dense product's value. Every trace of a state (an element's own face, its
// neighbour's re-extrapolation, the emitted traces, trace_point) comes from
// this one function, so both sides of an interface see the same bits, and
// the result does not depend on where v lives (shared or global memory).
template <typename T, int S>
__device__ __forceinline__ T face_trace(const T* v, const T* w, int f, int k) {
  const int base = f < 2 ? k * S : k;
  const int stride = f < 2 ? 1 : S;
  T acc = T(0);
#pragma unroll
  for (int m = 0; m < S; ++m) acc = fmadd(v[base + m * stride], w[m], acc);
  return acc;
}

// face_trace of h + hsurf: each node's sum, then face_trace's fma order.
template <typename T, int S>
__device__ __forceinline__ T face_trace_sum(const T* v, const T* hs, const T* w, int f, int k) {
  const int base = f < 2 ? k * S : k;
  const int stride = f < 2 ? 1 : S;
  T acc = T(0);
#pragma unroll
  for (int m = 0; m < S; ++m) acc = fmadd(v[base + m * stride] + hs[base + m * stride], w[m], acc);
  return acc;
}

// AUSM Mach-splitting flux at one interface point (reference rhs_sw.py:170-207,
// term order of pallas_sw._ausm_slots). is_x: the normal momentum is hu1.
template <typename T>
__device__ __forceinline__ void ausm(const T* L, const T* R, T msg, T mhd, T mho, bool is_x, T* F) {
  const T g = T(kGravity);
  const T half_g = T(0.5 * kGravity);
  const T hL = L[0], hR = R[0];
  const T aL = sqrt_rn(g * hL * mhd);
  const T aR = sqrt_rn(g * hR * mhd);
  const T qnL = is_x ? L[1] : L[2];
  const T qnR = is_x ? R[1] : R[2];
  const T tmpL = hL * aL;
  const T tmpR = hR * aR;
  const T mL = tmpL != T(0) ? qnL / tmpL : T(0);
  const T mR = tmpR != T(0) ? qnR / tmpR : T(0);
  const T big_m = T(0.25) * ((mL + T(1)) * (mL + T(1)) - (mR - T(1)) * (mR - T(1)));
  const T adv_l = (big_m > T(0) ? big_m : T(0)) * aL;
  const T adv_r = (big_m < T(0) ? big_m : T(0)) * aR;
#pragma unroll
  for (int v = 0; v < 3; ++v) F[v] = msg * (adv_l * L[v] + adv_r * R[v]);
  const T pres_l = (T(1) + mL) * (msg * half_g) * (hL * hL);
  const T pres_r = (T(1) - mR) * (msg * half_g) * (hR * hR);
  const T pres_diag = T(0.5) * (mhd * pres_l + mhd * pres_r);
  const T pres_off = T(0.5) * (mho * pres_l + mho * pres_r);
  F[1] += is_x ? pres_diag : pres_off;
  F[2] += is_x ? pres_off : pres_diag;
}

// Term-level delta of `ausm` around the base states (L0, R0) for the
// perturbations (dL, dR), term for term as pallas_sw._ausm_delta_slots: the
// sound-speed delta g*mhd*dh/(a + a0), Mach-number deltas as differences of
// the full and the base Mach numbers, the split Mach terms as max(0, M) -
// max(0, M0) and min(0, M) - min(0, M0), and the pressure term's exact
// expansion; the divide guards of the absolute form are kept.
template <typename T>
__device__ __forceinline__ void ausm_delta(const T* L0, const T* R0, const T* dL, const T* dR, T msg,
                                           T mhd, T mho, bool is_x, T* F) {
  const T g = T(kGravity);
  const T hL0 = L0[0], hR0 = R0[0];
  const T dhL = dL[0], dhR = dR[0];
  const T hL = hL0 + dhL, hR = hR0 + dhR;
  const T aL0 = sqrt_rn(g * hL0 * mhd);
  const T aR0 = sqrt_rn(g * hR0 * mhd);
  const T aL = sqrt_rn(g * hL * mhd);
  const T aR = sqrt_rn(g * hR * mhd);
  const T daL = aL + aL0 > T(0) ? g * mhd * dhL / (aL + aL0) : T(0);
  const T daR = aR + aR0 > T(0) ? g * mhd * dhR / (aR + aR0) : T(0);
  const T qn0L = is_x ? L0[1] : L0[2];
  const T qn0R = is_x ? R0[1] : R0[2];
  const T dqnL = is_x ? dL[1] : dL[2];
  const T dqnR = is_x ? dR[1] : dR[2];
  const T tmpL0 = hL0 * aL0, tmpL = hL * aL;
  const T tmpR0 = hR0 * aR0, tmpR = hR * aR;
  const T mL0 = tmpL0 != T(0) ? qn0L / tmpL0 : T(0);
  const T mR0 = tmpR0 != T(0) ? qn0R / tmpR0 : T(0);
  const T mL = tmpL != T(0) ? (qn0L + dqnL) / tmpL : T(0);
  const T mR = tmpR != T(0) ? (qn0R + dqnR) / tmpR : T(0);
  const T dmL = mL - mL0, dmR = mR - mR0;
  const T M0 = T(0.25) * ((mL0 + T(1)) * (mL0 + T(1)) - (mR0 - T(1)) * (mR0 - T(1)));
  const T dM = T(0.25) * ((mL + mL0 + T(2)) * dmL - (mR + mR0 - T(2)) * dmR);
  const T M = M0 + dM;
  const T P0 = M0 > T(0) ? M0 : T(0);
  const T dP = (M > T(0) ? M : T(0)) - P0;
  const T N0 = M0 < T(0) ? M0 : T(0);
  const T dN = (M < T(0) ? M : T(0)) - N0;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const T l = L0[v] + dL[v], r = R0[v] + dR[v];
    F[v] = msg * (dP * aL * l + P0 * (daL * l + aL0 * dL[v]) + dN * aR * r + N0 * (daR * r + aR0 * dR[v]));
  }
  const T dterm = dmL * hL * hL + (T(1) + mL0) * (hL + hL0) * dhL - dmR * hR * hR + (T(1) - mR0) * (hR + hR0) * dhR;
  const T dpres = T(0.25 * kGravity) * msg * dterm;
  F[1] += (is_x ? mhd : mho) * dpres;
  F[2] += (is_x ? mho : mhd) * dpres;
}

// The AUSM flux's tangent split in two (the tangent prep and apply kernels
// of csrc/sw_operator.cu). ausm_tangent_coefficients computes, once per
// linearisation point, every primal quantity of the flux's directional
// derivative that costs a square root, a division or a trace of q, as `ausm`
// computes them: c = [L (3) | R (3) | aL, aR | 1/(hL aL), 1/(hR aR) (0 where
// h a == 0, the divide guard) | mL, mR | M], the rows of ops/sw_operator.py::
// SW_TANGENT_FACE_ROWS. ausm_tangent_apply is the derivative at those
// coefficients in the direction (dL, dR), linear in it (no square root, no
// division): the flux's tangent as jax.jvp takes it of the XLA RHS
// (models/shallow_water.py:130-160 of the JAX package): d sqrt(x) = dx * 0.5
// / sqrt(x), with 1/a = h * (1/(h a)); the guarded divisions' derivative 0
// where h a == 0 (the branch jnp.where picks); the split Mach terms' d max(0,
// M) and d min(0, M) all of dM on their side of 0, none on the other, and
// half of it at the tie M = 0 (where jax.jvp of jnp.maximum/jnp.minimum
// splits it, and where every interface of a state at rest sits); the
// pressure terms by the product rule.
constexpr int kTangentFaceRows = 13;

template <typename T>
__device__ __forceinline__ void ausm_tangent_coefficients(const T* L, const T* R, T mhd, bool is_x, T* c) {
  const T g = T(kGravity);
  const T hL = L[0], hR = R[0];
  const T aL = sqrt_rn(g * hL * mhd);
  const T aR = sqrt_rn(g * hR * mhd);
  const T qnL = is_x ? L[1] : L[2];
  const T qnR = is_x ? R[1] : R[2];
  const T tmpL = hL * aL;
  const T tmpR = hR * aR;
  const T mL = tmpL != T(0) ? qnL / tmpL : T(0);
  const T mR = tmpR != T(0) ? qnR / tmpR : T(0);
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    c[v] = L[v];
    c[3 + v] = R[v];
  }
  c[6] = aL;
  c[7] = aR;
  c[8] = tmpL != T(0) ? T(1) / tmpL : T(0);
  c[9] = tmpR != T(0) ? T(1) / tmpR : T(0);
  c[10] = mL;
  c[11] = mR;
  c[12] = T(0.25) * ((mL + T(1)) * (mL + T(1)) - (mR - T(1)) * (mR - T(1)));
}

template <typename T>
__device__ __forceinline__ void ausm_tangent_apply(const T* c, const T* dL, const T* dR, T msg, T mhd, T mho,
                                                   bool is_x, T* dF) {
  const T g = T(kGravity);
  const T half_g = T(0.5 * kGravity);
  const T hL = c[0], hR = c[3];
  const T aL = c[6], aR = c[7], ihaL = c[8], ihaR = c[9], mL = c[10], mR = c[11], big_m = c[12];
  const T dhL = dL[0], dhR = dR[0];
  const T daL = (g * dhL * mhd) * (T(0.5) * (hL * ihaL));
  const T daR = (g * dhR * mhd) * (T(0.5) * (hR * ihaR));
  const T dqnL = is_x ? dL[1] : dL[2];
  const T dqnR = is_x ? dR[1] : dR[2];
  const T dmL = (dqnL - mL * (dhL * aL + hL * daL)) * ihaL;
  const T dmR = (dqnR - mR * (dhR * aR + hR * daR)) * ihaR;
  const T dM = T(0.5) * ((mL + T(1)) * dmL - (mR - T(1)) * dmR);
  const T P = big_m > T(0) ? big_m : T(0);
  const T N = big_m < T(0) ? big_m : T(0);
  const T dP = big_m > T(0) ? dM : (big_m == T(0) ? T(0.5) * dM : T(0));
  const T dN = big_m < T(0) ? dM : (big_m == T(0) ? T(0.5) * dM : T(0));
  const T adv_l = P * aL, adv_r = N * aR;
  const T dadv_l = dP * aL + P * daL;
  const T dadv_r = dN * aR + N * daR;
#pragma unroll
  for (int v = 0; v < 3; ++v)
    dF[v] = msg * ((dadv_l * c[v] + adv_l * dL[v]) + (dadv_r * c[3 + v] + adv_r * dR[v]));
  const T k = msg * half_g;
  const T dpres_l = k * (dmL * (hL * hL) + (T(1) + mL) * (T(2) * hL * dhL));
  const T dpres_r = k * ((T(1) - mR) * (T(2) * hR * dhR) - dmR * (hR * hR));
  const T dpres_diag = T(0.5) * (mhd * dpres_l + mhd * dpres_r);
  const T dpres_off = T(0.5) * (mho * dpres_l + mho * dpres_r);
  dF[1] += is_x ? dpres_diag : dpres_off;
  dF[2] += is_x ? dpres_off : dpres_diag;
}

// The 1D factors of the operator's Kronecker-structured matrices, read from
// the dense blocks of `ops` (EE (s^2, 4s) | DD (2s^2, s^2) | CC (4s, s^2), the
// layout the plain version reads) at one position of each factor entry:
//   ext  (4, s)  face f's extrapolation weight of the m-th node of a row
//                (W, E) or column (S, N): EE[row*4s + f*s], row m or m*s
//   dx   (s, s)  d/dx at kx from node kx' of its row: DD[kx'*s^2 + kx]
//   dy   (s, s)  d/dy at ky from node ky' of its column:
//                DD[(s^2 + ky'*s)*s^2 + ky*s]
//   corr (4, s)  face f's correction weight at node coordinate c (kx for
//                W, E; ky for S, N): CC[f*s*s^2 + c] (W, E), CC[f*s*s^2 + c*s]
// EE, DD and CC are Kronecker products with the identity (ops/dfr.py), so
// these entries are the 1D factors (tests/test_torch_sw_element_plan.py
// holds the premise and ops/sw_operator.py::element_plan mirrors the
// indexing). Shared memory (in T): the factors, padded to 4 words, then per
// element [q (3 s^2) | fx, fy (6 s^2) | face fluxes (3 * 4s)].
template <int S>
struct Shape {
  static constexpr int S2 = S * S;
  static constexpr int NF = 4 * S;
  static constexpr int N_FAC = (8 * S + 2 * S2 + 3) / 4 * 4;
  static constexpr int PER_ELEM = 9 * S2 + 3 * NF;
  static constexpr int EB = kThreads / S2 > 0 ? kThreads / S2 : 1;  // most elements a block
  static size_t smem_bytes(size_t item, int eb) { return item * (N_FAC + (size_t)eb * PER_ELEM); }
};

// Every thread of the block calls it; the factors are visible after the
// caller's (or element_block's first) barrier.
template <typename T, int S>
__device__ __forceinline__ void load_factors(const T* ops, T* fac) {
  constexpr int S2 = S * S, NF = 4 * S;
  const T* ee = ops;
  const T* dd = ee + S2 * NF;
  const T* cc = dd + 2 * S2 * S2;
  for (int i = threadIdx.x; i < 8 * S + 2 * S2; i += blockDim.x) {
    T val;
    if (i < NF) {
      const int f = i / S, m = i - f * S;
      val = ee[(f < 2 ? m : m * S) * NF + f * S];
    } else if (i < NF + S2) {
      const int kx = (i - NF) / S, m = i - NF - kx * S;
      val = dd[m * S2 + kx];
    } else if (i < NF + 2 * S2) {
      const int ky = (i - NF - S2) / S, m = i - NF - S2 - ky * S;
      val = dd[(S2 + m * S) * S2 + ky * S];
    } else {
      const int f = (i - NF - 2 * S2) / S, c = i - NF - 2 * S2 - f * S;
      val = cc[f * S * S2 + (f < 2 ? c : c * S)];
    }
    fac[i] = val;
  }
}

// Where a panel-edge face finds its neighbour's (h, hu1, hu2): a halo plane
// (`halo`; the only source of a tile launch), the panel-edge traces of the
// stage input (`halo` holds them; the whole-run kernel), or the stage input
// `q` itself (whole sphere only).
enum class HaloFrom { kPlane, kTraces, kState };

template <typename T>
struct OpArgs {
  const T* q;     // stage input state (the perturbation in the perturbation form)
  const T* halo;  // its halo plane, its panel-edge traces (kTraces), or nullptr (kState)
  const T* ops;
  const T* fields;
  const T* gridrot;
  const T* itf_x;
  const T* itf_y;
  const T* x;     // stage a-term state, nullptr: no a*x term
  T* out;
  T* traces;      // nullptr: no trace emission
  // perturbation base (PERT only)
  const T* q0;
  const T* u0;
  const T* itf0;
  const T* halo0;
  const T* rhs0;
  // halo tables (kTraces and kState only)
  const int* hsrc;
  const int* hflip;
  const T* hconv;
  // bottom topography (TOPO only)
  const T* hsurf;
  const T* hsurf_x;
  const T* hsurf_y;
  const T* topo_force;
  int nel;
  int npanel;  // 6: the whole cubed sphere; 1: one tile (kTraces and kState need 6)
  T a, b, cdt;
  int stage;  // 0: out = RHS(q)
};

// Edge point i (0 <= i < npts) of (side, panel) row `row` = side*6 + panel
// receives the neighbour row src[row] at its point j: i itself, or npts-1-i
// across an edge that runs opposite.
__device__ __forceinline__ void halo_source(const int* src, const int* flip, int npts, int row, int i, int* r,
                                            int* j) {
  *r = src[row];
  *j = flip[row] ? npts - 1 - i : i;
}

// The halo values (h, hu1, hu2) of row `row` at point i from the neighbour's
// values a0, a1, a2 there: the momenta rotated into the local contravariant
// basis with conv (4, 24, npts), entry ci = row*npts + i, component stride
// cstride = 24*npts (the arithmetic of pallas_sw.kh_exchange / _halo_math and
// of the plain halo_from_traces).
template <typename T>
__device__ __forceinline__ void rotate_halo(const T* conv, long long cstride, long long ci, T a0, T a1, T a2,
                                            T* out) {
  out[0] = a0;
  out[1] = fmadd(conv[ci], a1, conv[cstride + ci] * a2);
  out[2] = fmadd(conv[2 * cstride + ci], a1, conv[3 * cstride + ci] * a2);
}

// The halo values that row `row` receives at edge point i from the outgoing
// traces (3, 24, npts).
template <typename T>
__device__ __forceinline__ void halo_point(const T* traces, const int* src, const int* flip, const T* conv,
                                           int npts, int row, int i, T* out) {
  const long long vstride = 24LL * npts;
  int r, j;
  halo_source(src, flip, npts, row, i, &r, &j);
  const long long at = (long long)r * npts + j;
  rotate_halo(conv, vstride, (long long)row * npts + i, traces[at], traces[vstride + at], traces[2 * vstride + at],
              out);
}

// Variable v of the trace of state q at point j = along*s + k of (side, panel)
// row `row`: its edge element's face point (face_trace; ext: the factors'
// extrapolation weights). TOPO: h's trace is that of h + hsurf.
template <typename T, int S, bool TOPO = false>
__device__ __forceinline__ T edge_trace(const T* q, const T* ext, int nel, int row, int j, int v,
                                        const T* hsurf = nullptr) {
  constexpr int S2 = S * S;
  const int side = row / 6, p = row - side * 6;
  const int along = j / S, k = j - along * S;
  int ey, ex, f;
  switch (side) {
    case 0: ey = 0;       ex = along;   f = 2; break;  // south
    case 1: ey = nel - 1; ex = along;   f = 3; break;  // north
    case 2: ey = along;   ex = 0;       f = 0; break;  // west
    default: ey = along;  ex = nel - 1; f = 1; break;  // east
  }
  const long long nq = 6LL * nel * nel * S2;
  const long long elem = ((long long)p * nel + ey) * nel + ex;
  if constexpr (TOPO) {
    if (v == 0) return face_trace_sum<T, S>(q + elem * S2, hsurf + elem * S2, ext + f * S, f, k);
  }
  return face_trace<T, S>(q + v * nq + elem * S2, ext + f * S, f, k);
}

// Trace value t = ((v*4 + side)*6 + p)*nel*s + along*s + k of state q.
template <typename T, int S>
__device__ __forceinline__ T trace_point(const T* q, const T* ext, int nel, long long t) {
  const int npts = nel * S;
  return edge_trace<T, S>(q, ext, nel, (int)((t / npts) % 24), (int)(t % npts), (int)(t / (24LL * npts)));
}

// The halo values that row `row` receives at edge point i, straight from the
// neighbour panel's state q: halo_point of the traces trace_point would
// write, without writing them. TOPO: the neighbour's h + hsurf.
template <typename T, int S, bool TOPO = false>
__device__ __forceinline__ void state_halo_point(const T* q, const T* ext, const int* src, const int* flip,
                                                 const T* conv, int nel, int row, int i, T* out,
                                                 const T* hsurf = nullptr) {
  const int npts = nel * S;
  int r, j;
  halo_source(src, flip, npts, row, i, &r, &j);
  rotate_halo(conv, 24LL * npts, (long long)row * npts + i, edge_trace<T, S, TOPO>(q, ext, nel, r, j, 0, hsurf),
              edge_trace<T, S>(q, ext, nel, r, j, 1), edge_trace<T, S>(q, ext, nel, r, j, 2), out);
}

// One block of `eb` consecutive elements of the operator (eb <= Shape::EB;
// thread e*s^2 + j is node j of the block's element e), called by every
// thread of the block (it synchronises the block). `smem` holds the 1D
// factors already (load_factors, visible after the caller's or this
// function's first barrier); the per-element regions follow them.
//
// Each element computes the AUSM flux at its own four faces from (own trace,
// neighbour trace or halo) with qL/qR in a fixed order: the neighbour's trace
// is re-extrapolated from the s nodes of its row or column in global memory
// by face_trace, the function that neighbour uses for its own trace, so both
// sides of an interior interface get bit-identical fluxes (mass is conserved
// to round-off). West and south panel-edge interfaces take qL from the halo,
// east and north take qR from it. In the perturbation form (PERT) the state,
// halo, output and traces carry deltas: base traces come from itf0 (the
// neighbour's entry for the neighbour's face, so again the same bits on both
// sides) and halo0, and every flux is the term-level delta around them; the
// output is rhs0 + delta (or the stage combination of delta states). With
// HaloFrom::kTraces, `halo` holds the traces and each panel-edge face computes
// its halo value with `halo_point`; with HaloFrom::kState, with
// `state_halo_point` from the neighbour panel's rows of `q` (the delta in the
// perturbation form; the base halo stays the plane halo0).
//
// The divergence at node (ky, kx) sums the s x-terms of its row, then the s
// y-terms of its column; the correction its four faces' fluxes, W, E, S, N:
// the order in which the dense DD and CC products met their non-zero terms.
// TOPO (state mode only): the topography of the header comment; with PERT
// only its forcing delta, the rest riding the base planes.
template <typename T, int S, bool PERT, HaloFrom HALO, bool TOPO = false>
__device__ __forceinline__ void element_block(const OpArgs<T>& A, int blk, int eb, T* smem) {
  static_assert(!TOPO || HALO == HaloFrom::kState, "topography runs in the state mode");
  // h + hsurf at the faces: the absolute form with topography only (a
  // perturbation's traces are those of dh).
  constexpr bool TOPO_TRACES = TOPO && !PERT;
  using Sh = Shape<S>;
  constexpr int S2 = Sh::S2, NF = Sh::NF;
  const T* sExt = smem;
  const T* sDx = sExt + NF;
  const T* sDy = sDx + S2;
  const T* sCorr = sDy + S2;

  const int nel = A.nel;
  const int tid = threadIdx.x;
  const int e_loc = tid / S2;
  const int j = tid - e_loc * S2;
  const int ky = j / S, kx = j - ky * S;
  const int npanel = A.npanel;
  const int per_panel = nel * nel;
  const int nelem = npanel * per_panel;
  const int elem = blk * eb + e_loc;
  const bool valid = e_loc < eb && elem < nelem;
  const long long nq = (long long)nelem * S2;           // stride between variables
  const long long fstride = (long long)per_panel * S2;  // stride between metric fields
  const long long pt = (long long)elem * S2 + j;

  T* sQ = smem + Sh::N_FAC + e_loc * Sh::PER_ELEM;
  T* sF = sQ + 3 * S2;
  T* sFl = sF + 6 * S2;

  int p = 0, pe = 0, ey = 0, ex = 0;
  if (valid) {
    p = elem / per_panel;
    pe = elem - p * per_panel;
    ey = pe / nel;
    ex = pe - ey * nel;
#pragma unroll
    for (int v = 0; v < 3; ++v) sQ[v * S2 + j] = A.q[v * nq + pt];
  }
  __syncthreads();

  // --- Pointwise fluxes, forcing, and the fluxes at this element's faces.
  T force1 = T(0), force2 = T(0), invsg = T(0);
  if (valid) {
    const T* fld = A.fields + (long long)pe * S2 + j;
    const T sqrtg = fld[0], h11 = fld[fstride], h12 = fld[2 * fstride], h22 = fld[3 * fstride];
    const T g101 = fld[4 * fstride], g102 = fld[5 * fstride];
    const T g201 = fld[6 * fstride], g202 = fld[7 * fstride];
    const T c111 = fld[8 * fstride], c112 = fld[9 * fstride];
    const T c212 = fld[10 * fstride], c222 = fld[11 * fstride];
    invsg = fld[12 * fstride];
    const T half_g = T(0.5 * kGravity);
    const T rot2 = T(2) * A.gridrot[pt];
    if constexpr (PERT) {
      // Term-level delta of the pointwise stage (pallas_sw._element_stage_pert).
      const T h0 = A.q0[pt], hu10 = A.q0[nq + pt], hu20 = A.q0[2 * nq + pt];
      const T u10 = A.u0[pt], u20 = A.u0[nq + pt];
      const T dh = sQ[j], dhu1 = sQ[S2 + j], dhu2 = sQ[2 * S2 + j];
      const T h = h0 + dh;
      const T du1 = (dhu1 - u10 * dh) / h;
      const T du2 = (dhu2 - u20 * dh) / h;
      const T u1 = u10 + du1, u2 = u20 + du2;
      const T hph0 = h + h0;
      const T d11 = dhu1 * u1 + hu10 * du1;
      const T d12 = dhu1 * u2 + hu10 * du2;
      const T d21 = dhu2 * u1 + hu20 * du1;
      const T d22 = dhu2 * u2 + hu20 * du2;
      sF[0 * S2 + j] = sqrtg * dhu1;
      sF[1 * S2 + j] = sqrtg * (d11 + half_g * h11 * hph0 * dh);
      sF[2 * S2 + j] = sqrtg * (d21 + half_g * h12 * hph0 * dh);
      sF[3 * S2 + j] = sqrtg * dhu2;
      sF[4 * S2 + j] = sqrtg * (d12 + half_g * h12 * hph0 * dh);
      sF[5 * S2 + j] = sqrtg * (d22 + half_g * h22 * hph0 * dh);
      force1 = rot2 * (g101 * dhu1 + g102 * dhu2) + c111 * d11 + T(2) * c112 * d12;
      force2 = rot2 * (g201 * dhu1 + g202 * dhu2) + T(2) * c212 * d12 + c222 * d22;
      if constexpr (TOPO) {
        force1 = fmadd(A.topo_force[pt], dh, force1);
        force2 = fmadd(A.topo_force[nq + pt], dh, force2);
      }
    } else {
      const T h = sQ[j], hu1 = sQ[S2 + j], hu2 = sQ[2 * S2 + j];
      const T u1 = hu1 / h, u2 = hu2 / h, hsq = h * h;
      sF[0 * S2 + j] = sqrtg * hu1;
      sF[1 * S2 + j] = sqrtg * (hu1 * u1 + half_g * h11 * hsq);
      sF[2 * S2 + j] = sqrtg * (hu2 * u1 + half_g * h12 * hsq);
      sF[3 * S2 + j] = sqrtg * hu2;
      sF[4 * S2 + j] = sqrtg * (hu1 * u2 + half_g * h12 * hsq);
      sF[5 * S2 + j] = sqrtg * (hu2 * u2 + half_g * h22 * hsq);
      force1 = rot2 * (g101 * hu1 + g102 * hu2) + c111 * hu1 * u1 + T(2) * c112 * hu1 * u2;
      force2 = rot2 * (g201 * hu1 + g202 * hu2) + T(2) * c212 * hu1 * u2 + c222 * hu2 * u2;
      if constexpr (TOPO) {
        force1 = fmadd(A.topo_force[pt], h, force1);
        force2 = fmadd(A.topo_force[nq + pt], h, force2);
      }
    }

    const int npts = nel * S;
    for (int fi = j; fi < NF; fi += S2) {
      const int side = fi / S;  // faces: 0 west, 1 east, 2 south, 3 north
      const int k = fi - side * S;
      bool at_edge;
      int nb_elem, hside, along;
      switch (side) {
        case 0: at_edge = ex == 0;       nb_elem = elem - 1;   hside = 2; along = ey; break;
        case 1: at_edge = ex == nel - 1; nb_elem = elem + 1;   hside = 3; along = ey; break;
        case 2: at_edge = ey == 0;       nb_elem = elem - nel; hside = 0; along = ex; break;
        default: at_edge = ey == nel - 1; nb_elem = elem + nel; hside = 1; along = ex; break;
      }
      const int nb_side = side ^ 1;  // the neighbour's face on this interface
      const long long hidx = ((long long)(hside * npanel + p) * nel + along) * S + k;  // within one variable
      const long long hvar = 4LL * npanel * npts;
      T own[3], nb[3];
      if (at_edge) {
        if constexpr (HALO == HaloFrom::kTraces) {
          halo_point(A.halo, A.hsrc, A.hflip, A.hconv, npts, hside * 6 + p, along * S + k, nb);
        } else if constexpr (HALO == HaloFrom::kState) {
          state_halo_point<T, S, TOPO_TRACES>(A.q, sExt, A.hsrc, A.hflip, A.hconv, nel, hside * 6 + p,
                                              along * S + k, nb, A.hsurf);
        } else {
#pragma unroll
          for (int v = 0; v < 3; ++v) nb[v] = A.halo[v * hvar + hidx];
        }
      } else {
#pragma unroll
        for (int v = 0; v < 3; ++v)
          nb[v] = face_trace<T, S>(A.q + v * nq + (long long)nb_elem * S2, sExt + nb_side * S, nb_side, k);
        if constexpr (TOPO_TRACES)
          nb[0] = face_trace_sum<T, S>(A.q + (long long)nb_elem * S2, A.hsurf + (long long)nb_elem * S2,
                                       sExt + nb_side * S, nb_side, k);
      }
#pragma unroll
      for (int v = 0; v < 3; ++v) own[v] = face_trace<T, S>(sQ + v * S2, sExt + side * S, side, k);
      if constexpr (TOPO_TRACES)
        own[0] = face_trace_sum<T, S>(sQ, A.hsurf + (long long)elem * S2, sExt + side * S, side, k);
      // West/south faces: the neighbour (or halo) is on the left.
      const bool own_right = side == 0 || side == 2;
      T L[3], R[3], F[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        L[v] = own_right ? nb[v] : own[v];
        R[v] = own_right ? own[v] : nb[v];
      }
      const bool is_x = side < 2;
      const T* itf = is_x ? A.itf_x : A.itf_y;
      const int istride = nel * (nel + 1) * S;
      const int iidx = is_x ? ((ey * (nel + 1) + ex + (side == 1)) * S + k)
                            : (((ey + (side == 3)) * nel + ex) * S + k);
      if constexpr (TOPO_TRACES) {
        const T hs = (is_x ? A.hsurf_x : A.hsurf_y)[(long long)p * istride + iidx];
        L[0] = L[0] - hs;
        R[0] = R[0] - hs;
      }
      if constexpr (PERT) {
        const long long tvar = (long long)nelem * NF;
        T own0[3], nb0[3], L0[3], R0[3];
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          own0[v] = A.itf0[v * tvar + (long long)elem * NF + fi];
          nb0[v] = at_edge ? A.halo0[v * hvar + hidx] : A.itf0[v * tvar + (long long)nb_elem * NF + nb_side * S + k];
          L0[v] = own_right ? nb0[v] : own0[v];
          R0[v] = own_right ? own0[v] : nb0[v];
        }
        ausm_delta(L0, R0, L, R, itf[iidx], itf[istride + iidx], itf[2 * istride + iidx], is_x, F);
      } else {
        ausm(L, R, itf[iidx], itf[istride + iidx], itf[2 * istride + iidx], is_x, F);
      }
#pragma unroll
      for (int v = 0; v < 3; ++v) sFl[v * NF + fi] = F[v];
    }
  }
  __syncthreads();

  // --- Interior divergence + boundary correction, stage combination.
  if (valid) {
    T r[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      T div = T(0);
#pragma unroll
      for (int m = 0; m < S; ++m) div = fmadd(sF[v * S2 + ky * S + m], sDx[kx * S + m], div);
#pragma unroll
      for (int m = 0; m < S; ++m) div = fmadd(sF[(3 + v) * S2 + m * S + kx], sDy[ky * S + m], div);
      T corr = T(0);
      corr = fmadd(sFl[v * NF + ky], sCorr[kx], corr);                 // west
      corr = fmadd(sFl[v * NF + S + ky], sCorr[S + kx], corr);         // east
      corr = fmadd(sFl[v * NF + 2 * S + kx], sCorr[2 * S + ky], corr);  // south
      corr = fmadd(sFl[v * NF + 3 * S + kx], sCorr[3 * S + ky], corr);  // north
      const T force = v == 0 ? T(0) : (v == 1 ? force1 : force2);
      r[v] = (-invsg * div - force) - invsg * corr;
      if constexpr (PERT) r[v] = r[v] + A.rhs0[v * nq + pt];
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const long long o = v * nq + pt;
      T val = r[v];
      if (A.stage) {
        val = A.b * sQ[v * S2 + j] + A.cdt * r[v];
        if (A.x != nullptr) val = A.a * A.x[o] + val;
      }
      A.out[o] = val;
      sQ[v * S2 + j] = val;  // only this thread reads this slot from here on
    }
  }

  // --- Panel-edge traces of the output state.
  if (A.traces != nullptr) {
    __syncthreads();
    if (valid) {
      const int npts = nel * S;
      for (int fi = j; fi < NF; fi += S2) {
        const int side = fi / S;
        const int k = fi - side * S;
        bool on_edge;
        int tside, along;
        switch (side) {
          case 0: on_edge = ex == 0;       tside = 2; along = ey; break;
          case 1: on_edge = ex == nel - 1; tside = 3; along = ey; break;
          case 2: on_edge = ey == 0;       tside = 0; along = ex; break;
          default: on_edge = ey == nel - 1; tside = 1; along = ex; break;
        }
        if (on_edge) {
#pragma unroll
          for (int v = 0; v < 3; ++v)
            A.traces[v * 4LL * npanel * npts + ((long long)(tside * npanel + p) * nel + along) * S + k] =
                face_trace<T, S>(sQ + v * S2, sExt + side * S, side, k);
        }
      }
    }
  }
}

// Host side: info = [registers, local (spill) bytes a thread, dynamic shared
// memory bytes a block, resident blocks an SM, threads a block] of one kernel
// instantiation launched with `threads` threads and `smem` bytes, as the
// runtime reports them.
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

}  // namespace swk
