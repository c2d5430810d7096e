// Shallow-water DFR spatial operator on the cubed sphere, one launch per call.
//
// Replaces the TPU kernel wxfactory_tpu/ops/pallas_sw_gen.py::km_gen (body
// _panel_body, with pallas_sw._element_stage and _ausm_slots): absolute form,
// optional RK stage combination a*x + b*q + cdt*RHS(q), optional emission of
// the output's panel-edge traces for the next stage's halo. The plain torch
// version of the same function is wxfactory_tpu_torch/ops/sw_operator.py::
// sw_operator_plain; the wrapper sw_operator there launches this kernel.
//
// Layouts (C order, T = float or double):
//   q, x, out  (3, 6*nel*nel, s^2)   element (panel, ey, ex), node ky*s + kx
//   halo       (3, 4, 6, nel, s)     neighbour traces, sides (S, N, W, E)
//   traces     (3, 4, 6, nel, s)     this state's own panel-edge traces
//   ops        EE (s^2, 4s) | DD (2s^2, s^2) | CC (4s, s^2), faces (W, E, S, N)
//   fields     (13, nel*nel, s^2)    one panel's metric (identical on all six)
//   gridrot    (6*nel*nel, s^2)      panel-dependent factor of the time Christoffels
//   itf_x      (3, nel, nel+1, s)    sqrt(g), H^11, H^21 at x1 interfaces
//   itf_y      (3, nel+1, nel, s)    sqrt(g), H^22, H^12 at x2 interfaces
//
// Design: one thread per solution point, EB = 256 / s^2 elements per block;
// EE/DD/CC and each element's state, pointwise fluxes and face fluxes in
// shared memory. Each element computes the AUSM flux at its own four faces
// from (own trace, neighbour trace or halo) with qL/qR in a fixed order:
// the neighbour's trace is re-extrapolated from its state in global memory
// with the same fma sequence that neighbour uses for its own trace, so both
// sides of an interior interface get bit-identical fluxes (mass is conserved
// to round-off). West/south panel-edge interfaces take qL from the halo,
// east/north take qR from it.
//
// What bounds it (H100 SXM, s=3, float64, per element and call): about
// 0.7-0.9 KB of device-memory traffic (state 216 B in and 216 B out, x 216 B
// in stage mode, gridrot 72 B; the single-panel metric, 13 fields, and the
// neighbours' states mostly hit L2) against about 3.8 kFLOP (dense 18x9
// divergence and 12x9 correction products, 24 face extrapolations, pointwise
// fluxes, 12 AUSM fluxes): ~4-5 FLOP/B, under the card's f64 balance of
// ~10 FLOP/B (34 TFLOP/s vector f64 over 3.35 TB/s), so the kernel is
// memory-bound in principle; at nel=64 both bounds are under 10 us, so in
// practice block-level latency (two or three barriers per block, low
// occupancy at large s) dominates. The dense EE/DD/CC products do s times
// the FLOPs of their Kronecker factors; using the 1D factors, and fusing the
// halo exchange into the kernel, are later work.

#include <cuda_runtime.h>

namespace {

constexpr double kGravity = 9.80616;
constexpr int kThreads = 256;

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float sqrt_rn(float v) { return __fsqrt_rn(v); }
__device__ __forceinline__ double sqrt_rn(double v) { return __dsqrt_rn(v); }

// Column `col` of an (n, ncol) row-major matrix applied to a length-n vector.
// Explicit fma in a fixed order: the result does not depend on where the
// vector lives (shared or global memory) or on the compiler's contraction.
template <typename T, int N>
__device__ __forceinline__ T dot_col(const T* v, const T* m, int ncol, int col) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) acc = fmadd(v[i], m[i * ncol + col], acc);
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

// Shared memory (in T): EE, DD, CC, then per element [q (3 s^2) | fx, fy
// (6 s^2) | face fluxes (3 * 4s)].
template <int S>
struct Shape {
  static constexpr int S2 = S * S;
  static constexpr int NF = 4 * S;
  static constexpr int N_OPS = S2 * NF + 2 * S2 * S2 + NF * S2;
  static constexpr int PER_ELEM = 9 * S2 + 3 * NF;
  static constexpr int EB = kThreads / S2 > 0 ? kThreads / S2 : 1;
};

template <typename T, int S>
__global__ void __launch_bounds__(kThreads) sw_operator_kernel(
    const T* __restrict__ q, const T* __restrict__ halo, const T* __restrict__ ops,
    const T* __restrict__ fields, const T* __restrict__ gridrot,
    const T* __restrict__ itf_x, const T* __restrict__ itf_y,
    const T* __restrict__ x, T* __restrict__ out, T* __restrict__ traces,
    int nel, T a, T b, T cdt, int stage) {
  using Sh = Shape<S>;
  constexpr int S2 = Sh::S2, NF = Sh::NF;
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* sEE = smem;
  const T* sDD = sEE + S2 * NF;
  const T* sCC = sDD + 2 * S2 * S2;

  const int tid = threadIdx.x;
  const int e_loc = tid / S2;
  const int j = tid - e_loc * S2;
  const int per_panel = nel * nel;
  const int nelem = 6 * per_panel;
  const int elem = blockIdx.x * Sh::EB + e_loc;
  const bool valid = elem < nelem;
  const long long nq = (long long)nelem * S2;  // stride between variables
  const long long fstride = (long long)per_panel * S2;  // stride between metric fields

  T* sQ = smem + Sh::N_OPS + e_loc * Sh::PER_ELEM;
  T* sF = sQ + 3 * S2;
  T* sFl = sF + 6 * S2;

  for (int i = tid; i < Sh::N_OPS; i += blockDim.x) smem[i] = ops[i];
  int p = 0, pe = 0, ey = 0, ex = 0;
  if (valid) {
    p = elem / per_panel;
    pe = elem - p * per_panel;
    ey = pe / nel;
    ex = pe - ey * nel;
#pragma unroll
    for (int v = 0; v < 3; ++v) sQ[v * S2 + j] = q[v * nq + (long long)elem * S2 + j];
  }
  __syncthreads();

  // --- Pointwise fluxes, forcing, and the fluxes at this element's faces.
  T force1 = T(0), force2 = T(0), invsg = T(0);
  if (valid) {
    const T* fld = fields + (long long)pe * S2 + j;
    const T sqrtg = fld[0], h11 = fld[fstride], h12 = fld[2 * fstride], h22 = fld[3 * fstride];
    const T g101 = fld[4 * fstride], g102 = fld[5 * fstride];
    const T g201 = fld[6 * fstride], g202 = fld[7 * fstride];
    const T c111 = fld[8 * fstride], c112 = fld[9 * fstride];
    const T c212 = fld[10 * fstride], c222 = fld[11 * fstride];
    invsg = fld[12 * fstride];
    const T half_g = T(0.5 * kGravity);
    const T h = sQ[j], hu1 = sQ[S2 + j], hu2 = sQ[2 * S2 + j];
    const T u1 = hu1 / h, u2 = hu2 / h, hsq = h * h;
    sF[0 * S2 + j] = sqrtg * hu1;
    sF[1 * S2 + j] = sqrtg * (hu1 * u1 + half_g * h11 * hsq);
    sF[2 * S2 + j] = sqrtg * (hu2 * u1 + half_g * h12 * hsq);
    sF[3 * S2 + j] = sqrtg * hu2;
    sF[4 * S2 + j] = sqrtg * (hu1 * u2 + half_g * h12 * hsq);
    sF[5 * S2 + j] = sqrtg * (hu2 * u2 + half_g * h22 * hsq);
    const T rot2 = T(2) * gridrot[(long long)elem * S2 + j];
    force1 = rot2 * (g101 * hu1 + g102 * hu2) + c111 * hu1 * u1 + T(2) * c112 * hu1 * u2;
    force2 = rot2 * (g201 * hu1 + g202 * hu2) + T(2) * c212 * hu1 * u2 + c222 * hu2 * u2;

    for (int fi = j; fi < NF; fi += S2) {
      const int side = fi / S;  // EE column blocks: 0 west, 1 east, 2 south, 3 north
      const int k = fi - side * S;
      bool at_edge;
      int nb_elem, nb_col, hside, along;
      switch (side) {
        case 0: at_edge = ex == 0;       nb_elem = elem - 1;   nb_col = S + k;     hside = 2; along = ey; break;
        case 1: at_edge = ex == nel - 1; nb_elem = elem + 1;   nb_col = k;         hside = 3; along = ey; break;
        case 2: at_edge = ey == 0;       nb_elem = elem - nel; nb_col = 3 * S + k; hside = 0; along = ex; break;
        default: at_edge = ey == nel - 1; nb_elem = elem + nel; nb_col = 2 * S + k; hside = 1; along = ex; break;
      }
      T own[3], nb[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        own[v] = dot_col<T, S2>(sQ + v * S2, sEE, NF, fi);
        nb[v] = at_edge ? halo[(((v * 4 + hside) * 6 + p) * nel + along) * S + k]
                        : dot_col<T, S2>(q + v * nq + (long long)nb_elem * S2, sEE, NF, nb_col);
      }
      // West/south faces: the neighbour (or halo) is on the left.
      const bool own_right = side == 0 || side == 2;
      T L[3], R[3], F[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        L[v] = own_right ? nb[v] : own[v];
        R[v] = own_right ? own[v] : nb[v];
      }
      const bool is_x = side < 2;
      const T* itf = is_x ? itf_x : itf_y;
      const int istride = nel * (nel + 1) * S;
      const int iidx = is_x ? ((ey * (nel + 1) + ex + (side == 1)) * S + k)
                            : (((ey + (side == 3)) * nel + ex) * S + k);
      ausm(L, R, itf[iidx], itf[istride + iidx], itf[2 * istride + iidx], is_x, F);
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
      for (int i = 0; i < S2; ++i) div = fmadd(sF[v * S2 + i], sDD[i * S2 + j], div);
      for (int i = 0; i < S2; ++i) div = fmadd(sF[(3 + v) * S2 + i], sDD[(S2 + i) * S2 + j], div);
      T corr = T(0);
      for (int fi = 0; fi < NF; ++fi) corr = fmadd(sFl[v * NF + fi], sCC[fi * S2 + j], corr);
      const T force = v == 0 ? T(0) : (v == 1 ? force1 : force2);
      r[v] = (-invsg * div - force) - invsg * corr;
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const long long o = v * nq + (long long)elem * S2 + j;
      T val = r[v];
      if (stage) {
        val = b * sQ[v * S2 + j] + cdt * r[v];
        if (x != nullptr) val = a * x[o] + val;
      }
      out[o] = val;
      sQ[v * S2 + j] = val;  // only this thread reads this slot from here on
    }
  }

  // --- Panel-edge traces of the output state.
  if (traces != nullptr) {
    __syncthreads();
    if (valid) {
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
            traces[(((v * 4 + tside) * 6 + p) * nel + along) * S + k] = dot_col<T, S2>(sQ + v * S2, sEE, NF, fi);
        }
      }
    }
  }
}

template <typename T, int S>
cudaError_t launch(int nel, const void* q, const void* halo, const void* ops, const void* fields,
                   const void* gridrot, const void* itf_x, const void* itf_y, const void* x,
                   void* out, void* traces, double a, double b, double cdt, int stage,
                   cudaStream_t stream) {
  using Sh = Shape<S>;
  const size_t smem = sizeof(T) * (Sh::N_OPS + (size_t)Sh::EB * Sh::PER_ELEM);
  static bool configured = false;
  if (!configured && smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sw_operator_kernel<T, S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int nelem = 6 * nel * nel;
  const int blocks = (nelem + Sh::EB - 1) / Sh::EB;
  sw_operator_kernel<T, S><<<blocks, Sh::EB * Sh::S2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(halo), static_cast<const T*>(ops),
      static_cast<const T*>(fields), static_cast<const T*>(gridrot),
      static_cast<const T*>(itf_x), static_cast<const T*>(itf_y), static_cast<const T*>(x),
      static_cast<T*>(out), static_cast<T*>(traces), nel, T(a), T(b), T(cdt), stage);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int s, int nel, const void* q, const void* halo, const void* ops,
                     const void* fields, const void* gridrot, const void* itf_x,
                     const void* itf_y, const void* x, void* out, void* traces, double a,
                     double b, double cdt, int stage, cudaStream_t stream) {
#define SW_CASE(S)                                                                         \
  case S:                                                                                  \
    return launch<T, S>(nel, q, halo, ops, fields, gridrot, itf_x, itf_y, x, out, traces, \
                        a, b, cdt, stage, stream);
  switch (s) {
    SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x == NULL: no x term;
// traces == NULL: no trace emission; stage == 0: out = RHS(q).
extern "C" int sw_operator_launch(int is_f64, int s, int nel, const void* q, const void* halo,
                                  const void* ops, const void* fields, const void* gridrot,
                                  const void* itf_x, const void* itf_y, const void* x, void* out,
                                  void* traces, double a, double b, double cdt, int stage,
                                  void* stream) {
  if (nel < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_f64 ? dispatch<double>(s, nel, q, halo, ops, fields, gridrot, itf_x, itf_y, x, out,
                                traces, a, b, cdt, stage, st)
             : dispatch<float>(s, nel, q, halo, ops, fields, gridrot, itf_x, itf_y, x, out,
                               traces, a, b, cdt, stage, st);
  return (int)err;
}

extern "C" const char* sw_operator_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
