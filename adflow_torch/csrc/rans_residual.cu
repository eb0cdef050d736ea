// Fused RANS-SA residual of one halo-filled block: all six channels.
//
// Replaces the TPU kernel adflow_tpu/ops/pallas_rans.py::_kernel (K1). It
// computes the same discretization as the plain PyTorch version
// adflow_torch/ops/cuda_rans.py::rans_residual_reference:
//   derived state (p, T, Sutherland mu, SA eddy mu_t)
//   JST pressure sensor + directionally scaled spectral radii + central flux
//     with 2nd/4th-difference dissipation and wall porosity
//   Green-Gauss cell gradients of (u, v, w, T, nuTilde)
//   normal-corrected face gradients -> stress tensor and heat flux
//   SA source (production, destruction, ft2, cb2) + first-order upwind
//     advection + diffusion + non-conservative correction + row scale
//
// Layout: channels last, as the JAX package and the port keep their arrays
// (padded state w (ni+4, nj+4, nk+4, 6); siE (ni+3, nj+2, nk+2, 3), ...).
//
// Design (first version, simple and deterministic):
//   pass 1: one thread per cell of the one-ring extended grid
//           (ni+2)(nj+2)(nk+2) writes 27 derived fields to a scratch buffer
//           (structure of arrays, so neighbouring threads store neighbouring
//           words): u, v, w, p, T, mu_eff, k_eff, nu_eff, sensor, the three
//           scaled radii and the 15 gradient components.
//   pass 2: one thread per interior cell computes its six faces' inviscid,
//           JST, viscous and SA fluxes and its SA source, then writes the six
//           channels. Each face is computed by both of its cells with the
//           same code, so there are no atomics and sums run in a fixed order.
// The bound on this card is device-memory bytes (about 130 MB in and out
// per evaluation at 256x64x64 against ~1.6 GFLOP); this version moves more
// than that (the scratch round trip, neighbour re-reads served by L2/L1).
// Fusing the passes and tiling in shared memory are later work.
//
// Every constant is a float literal and only float math functions are used,
// so nothing runs in double. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr float GAMMA = 1.4f;
constexpr float GM1 = 0.4f;
constexpr float PR_LAMINAR = 0.72f;
constexpr float PR_TURB = 0.9f;
constexpr float CB1 = 0.1355f;
constexpr float CB2 = 0.622f;
constexpr float SIGMA = 2.0f / 3.0f;
constexpr float KARMAN = 0.41f;
constexpr float CW1 = CB1 / (KARMAN * KARMAN) + (1.0f + CB2) / SIGMA;
constexpr float CW2 = 0.3f;
constexpr float CW3_6 = 64.0f;          // CW3 = 2
constexpr float CV1_3 = 7.1f * 7.1f * 7.1f;
constexpr float CT3 = 1.2f;
constexpr float CT4 = 0.5f;

// scratch field slots (each a plane of ne floats)
enum {
  S_U = 0, S_V, S_W, S_P, S_T, S_MU, S_K, S_NUE, S_SENS,
  S_SRI, S_SRJ, S_SRK, S_G0, N_SCRATCH = S_G0 + 15
};

struct Grid {
  int ni, nj, nk;
  __device__ long long pad(int I, int J, int K) const {       // padded cell
    return ((long long)I * (nj + 4) + J) * (nk + 4) + K;
  }
  __device__ long long ext(int I, int J, int K) const {       // ext cell
    return ((long long)I * (nj + 2) + J) * (nk + 2) + K;
  }
  __device__ long long n_ext() const {
    return (long long)(ni + 2) * (nj + 2) * (nk + 2);
  }
  // face between ext cells E - e_a and E, addressed by E, in the axis-a
  // extended face array (siE (ni+3,nj+2,nk+2), sjE (ni+2,nj+3,nk+2), ...)
  __device__ long long face(int a, int I, int J, int K) const {
    if (a == 0) return ((long long)I * (nj + 2) + J) * (nk + 2) + K;
    if (a == 1) return ((long long)I * (nj + 3) + J) * (nk + 2) + K;
    return ((long long)I * (nj + 2) + J) * (nk + 3) + K;
  }
  // interior face porosity for the same face (porI (ni+1,nj,nk), ...)
  __device__ long long por(int a, int I, int J, int K) const {
    const int i = I - 1, j = J - 1, k = K - 1;
    if (a == 0) return ((long long)i * nj + j) * nk + k;
    if (a == 1) return ((long long)i * (nj + 1) + j) * nk + k;
    return ((long long)i * nj + j) * (nk + 1) + k;
  }
};

struct Cell {
  float rho, mx, my, mz, rhoE, u, v, w, p, T, nut;
};

__device__ __forceinline__ Cell load_cell(const float* __restrict__ W,
                                          long long P) {
  const float* q = W + P * 6;
  Cell c;
  c.rho = q[0];
  c.mx = q[1];
  c.my = q[2];
  c.mz = q[3];
  c.rhoE = q[4];
  c.nut = q[5];
  c.u = c.mx / c.rho;
  c.v = c.my / c.rho;
  c.w = c.mz / c.rho;
  c.p = GM1 * (c.rhoE - 0.5f * (c.mx * c.mx + c.my * c.my + c.mz * c.mz)
                            / c.rho);
  c.T = GAMMA * c.p / c.rho;
  return c;
}

__device__ __forceinline__ float field(const Cell& c, int f) {
  return f == 0 ? c.u : f == 1 ? c.v : f == 2 ? c.w : f == 3 ? c.T : c.nut;
}

__device__ __forceinline__ float sutherland(float T, float mu_inf,
                                            float s_suth) {
  return mu_inf * (T * sqrtf(T)) * (1.0f + s_suth) / (T + s_suth);
}

__device__ __forceinline__ float sens(float pm, float p0, float pp) {
  return fabsf(pp - 2.0f * p0 + pm) / (pp + 2.0f * p0 + pm);
}

__device__ __forceinline__ float scale3(float ra, float rb, float rc,
                                        float expo) {
  const float eps = 1e-30f;
  return ra * (1.0f + powf(rb / (ra + eps), expo)
               + powf(rc / (ra + eps), expo));
}

// ---------------------------------------------------------------------------
// pass 1: derived fields on the one-ring extended grid
// ---------------------------------------------------------------------------
__global__ void rans_pass1(const float* __restrict__ W,
                           const float* __restrict__ siE,
                           const float* __restrict__ sjE,
                           const float* __restrict__ skE,
                           const float* __restrict__ vol,
                           float* __restrict__ scr, Grid g, float expo,
                           float mu_inf, float s_suth) {
  const long long ne = g.n_ext();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ne) return;
  const int ek = (int)(t % (g.nk + 2));
  const int ej = (int)((t / (g.nk + 2)) % (g.nj + 2));
  const int ei = (int)(t / ((long long)(g.nk + 2) * (g.nj + 2)));

  const long long P = g.pad(ei + 1, ej + 1, ek + 1);
  const long long stride[3] = {(long long)(g.nj + 4) * (g.nk + 4),
                               (long long)(g.nk + 4), 1};
  const float* sE[3] = {siE, sjE, skE};
  const int e3[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};

  const Cell c = load_cell(W, P);
  const float mu = sutherland(c.T, mu_inf, s_suth);
  const float nut_p0 = fmaxf(c.nut, 0.0f);
  const float chi = c.rho * nut_p0 / mu;
  const float chi3 = chi * chi * chi;
  const float mut = c.rho * nut_p0 * (chi3 / (chi3 + CV1_3));
  const float mu_eff = mu + mut;
  const float k_eff = mu / (PR_LAMINAR * GM1) + mut / (PR_TURB * GM1);
  const float nue = mu / c.rho + nut_p0;

  const float csound = sqrtf(GAMMA * c.p / c.rho);
  float nu_s = 0.0f;
  float rad[3];
  float grad[15];
  for (int q = 0; q < 15; ++q) grad[q] = 0.0f;

  for (int a = 0; a < 3; ++a) {
    const Cell lo = load_cell(W, P - stride[a]);
    const Cell hi = load_cell(W, P + stride[a]);
    const float sa = sens(lo.p, c.p, hi.p);
    nu_s = (a == 0) ? sa : fmaxf(nu_s, sa);

    const float* Slo = sE[a] + 3 * g.face(a, ei, ej, ek);
    const float* Shi = sE[a] + 3 * g.face(a, ei + e3[a][0], ej + e3[a][1],
                                          ek + e3[a][2]);
    const float sx = 0.5f * (Slo[0] + Shi[0]);
    const float sy = 0.5f * (Slo[1] + Shi[1]);
    const float sz = 0.5f * (Slo[2] + Shi[2]);
    rad[a] = fabsf(c.u * sx + c.v * sy + c.w * sz)
             + csound * sqrtf(sx * sx + sy * sy + sz * sz);

    for (int f = 0; f < 5; ++f) {
      const float pc = field(c, f);
      const float dm = 0.5f * (field(lo, f) - pc);
      const float dp = 0.5f * (field(hi, f) - pc);
      for (int m = 0; m < 3; ++m)
        grad[3 * f + m] += dp * Shi[m] - dm * Slo[m];
    }
  }
  const float vc = vol[P];

  float* o = scr + t;
  o[S_U * ne] = c.u;
  o[S_V * ne] = c.v;
  o[S_W * ne] = c.w;
  o[S_P * ne] = c.p;
  o[S_T * ne] = c.T;
  o[S_MU * ne] = mu_eff;
  o[S_K * ne] = k_eff;
  o[S_NUE * ne] = nue;
  o[S_SENS * ne] = nu_s;
  o[S_SRI * ne] = scale3(rad[0], rad[1], rad[2], expo);
  o[S_SRJ * ne] = scale3(rad[1], rad[0], rad[2], expo);
  o[S_SRK * ne] = scale3(rad[2], rad[0], rad[1], expo);
  for (int q = 0; q < 15; ++q) o[(S_G0 + q) * ne] = grad[q] / vc;
}

// ---------------------------------------------------------------------------
// pass 2: face fluxes and SA source per interior cell
// ---------------------------------------------------------------------------
struct FaceFlux {
  float F[5];      // inviscid central - JST dissipation
  float fm[3];     // viscous momentum flux tau . S
  float fen;       // viscous energy flux
  float q;         // u_f . S
  float fadv;      // SA upwind advection
  float fdif;      // SA diffusion
};

// Face along axis a between ext cells EL = (I, J, K) and ER = EL + e_a.
__device__ __forceinline__ FaceFlux face_flux(
    int a, int I, int J, int K, const Grid& g,
    const float* __restrict__ W, const float* __restrict__ sEa,
    const float* __restrict__ porA, const float* __restrict__ xc,
    const float* __restrict__ scr, float vis2, float vis4) {
  const int dI = a == 0, dJ = a == 1, dK = a == 2;
  const long long ne = g.n_ext();
  const long long stride_p = a == 0 ? (long long)(g.nj + 4) * (g.nk + 4)
                             : a == 1 ? (long long)(g.nk + 4) : 1;
  const long long stride_e = a == 0 ? (long long)(g.nj + 2) * (g.nk + 2)
                             : a == 1 ? (long long)(g.nk + 2) : 1;
  const long long PL = g.pad(I + 1, J + 1, K + 1);
  const long long eL = g.ext(I, J, K);
  const long long eR = eL + stride_e;

  const float* S = sEa + 3 * g.face(a, I + dI, J + dJ, K + dK);
  const float sx = S[0], sy = S[1], sz = S[2];
  const float por = porA[g.por(a, I + dI, J + dJ, K + dK)];

  FaceFlux out;

  // ---- inviscid central flux + JST dissipation ----------------------------
  const Cell cLL = load_cell(W, PL - stride_p);
  const Cell cL = load_cell(W, PL);
  const Cell cR = load_cell(W, PL + stride_p);
  const Cell cRR = load_cell(W, PL + 2 * stride_p);
  const float qL = (cL.mx * sx + cL.my * sy + cL.mz * sz) / cL.rho * por;
  const float qR = (cR.mx * sx + cR.my * sy + cR.mz * sz) / cR.rho * por;
  const float pa = 0.5f * (cL.p + cR.p);
  float central[5];
  central[0] = 0.5f * (cL.rho * qL + cR.rho * qR);
  central[1] = 0.5f * (cL.mx * qL + cR.mx * qR) + pa * sx;
  central[2] = 0.5f * (cL.my * qL + cR.my * qR) + pa * sy;
  central[3] = 0.5f * (cL.mz * qL + cR.mz * qR) + pa * sz;
  central[4] = 0.5f * ((cL.rhoE + cL.p) * qL + (cR.rhoE + cR.p) * qR);

  const float lam = 0.5f * (scr[(S_SRI + a) * ne + eL]
                            + scr[(S_SRI + a) * ne + eR]);
  const float e2 = vis2 * fmaxf(scr[S_SENS * ne + eL],
                                scr[S_SENS * ne + eR]);
  const float eps2 = e2 * por;
  const float eps4 = fmaxf(0.0f, vis4 - e2) * por;
  const float dLL[5] = {cLL.rho, cLL.mx, cLL.my, cLL.mz, cLL.rhoE + cLL.p};
  const float dL[5] = {cL.rho, cL.mx, cL.my, cL.mz, cL.rhoE + cL.p};
  const float dR[5] = {cR.rho, cR.mx, cR.my, cR.mz, cR.rhoE + cR.p};
  const float dRR[5] = {cRR.rho, cRR.mx, cRR.my, cRR.mz, cRR.rhoE + cRR.p};
  for (int c = 0; c < 5; ++c) {
    const float d1 = dR[c] - dL[c];
    const float d3 = dRR[c] - 3.0f * dR[c] + 3.0f * dL[c] - dLL[c];
    out.F[c] = central[c] - lam * (eps2 * d1 - eps4 * d3);
  }

  // ---- normal-corrected face gradients ------------------------------------
  const float* xL = xc + 3 * eL;
  const float* xR = xc + 3 * eR;
  const float del[3] = {xR[0] - xL[0], xR[1] - xL[1], xR[2] - xL[2]};
  const float dist = sqrtf(fmaxf(
      del[0] * del[0] + del[1] * del[1] + del[2] * del[2], 1e-30f));
  const float eh[3] = {del[0] / dist, del[1] / dist, del[2] / dist};
  const float phL[5] = {scr[S_U * ne + eL], scr[S_V * ne + eL],
                        scr[S_W * ne + eL], scr[S_T * ne + eL], cL.nut};
  const float phR[5] = {scr[S_U * ne + eR], scr[S_V * ne + eR],
                        scr[S_W * ne + eR], scr[S_T * ne + eR], cR.nut};
  float gf[5][3];
  for (int f = 0; f < 5; ++f) {
    float gb[3];
    for (int m = 0; m < 3; ++m)
      gb[m] = 0.5f * (scr[(S_G0 + 3 * f + m) * ne + eL]
                      + scr[(S_G0 + 3 * f + m) * ne + eR]);
    const float g_e = gb[0] * eh[0] + gb[1] * eh[1] + gb[2] * eh[2];
    const float corr = (phR[f] - phL[f]) / dist - g_e;
    for (int m = 0; m < 3; ++m) gf[f][m] = gb[m] + corr * eh[m];
  }

  // ---- viscous stress and heat flux ---------------------------------------
  const float mu_f = 0.5f * (scr[S_MU * ne + eL] + scr[S_MU * ne + eR]);
  const float k_f = 0.5f * (scr[S_K * ne + eL] + scr[S_K * ne + eR]);
  const float s3[3] = {sx, sy, sz};
  const float div = gf[0][0] + gf[1][1] + gf[2][2];
  for (int m = 0; m < 3; ++m) {
    float acc = 0.0f;
    for (int n = 0; n < 3; ++n) {
      float tau = gf[m][n] + gf[n][m];
      if (m == n) tau -= (2.0f / 3.0f) * div;
      acc += (mu_f * tau) * s3[n];
    }
    out.fm[m] = acc;
  }
  const float vf[3] = {0.5f * (phL[0] + phR[0]), 0.5f * (phL[1] + phR[1]),
                       0.5f * (phL[2] + phR[2])};
  out.fen = (vf[0] * out.fm[0] + vf[1] * out.fm[1] + vf[2] * out.fm[2])
            + k_f * (gf[3][0] * sx + gf[3][1] * sy + gf[3][2] * sz);

  // ---- SA advection (first-order upwind) and diffusion --------------------
  out.q = vf[0] * sx + vf[1] * sy + vf[2] * sz;
  out.fadv = out.q * (out.q >= 0.0f ? cL.nut : cR.nut);
  const float nue_f = 0.5f * (scr[S_NUE * ne + eL] + scr[S_NUE * ne + eR]);
  out.fdif = (1.0f / SIGMA) * nue_f
             * (gf[4][0] * sx + gf[4][1] * sy + gf[4][2] * sz);
  return out;
}

__global__ void rans_pass2(const float* __restrict__ W,
                           const float* __restrict__ siE,
                           const float* __restrict__ sjE,
                           const float* __restrict__ skE,
                           const float* __restrict__ vol,
                           const float* __restrict__ xc,
                           const float* __restrict__ dist,
                           const float* __restrict__ porI,
                           const float* __restrict__ porJ,
                           const float* __restrict__ porK,
                           const float* __restrict__ scr,
                           float* __restrict__ out, Grid g, float vis2,
                           float vis4, float mu_inf, float s_suth,
                           int use_ft2, float turb_scale) {
  const long long n = (long long)g.ni * g.nj * g.nk;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int k = (int)(t % g.nk);
  const int j = (int)((t / g.nk) % g.nj);
  const int i = (int)(t / ((long long)g.nk * g.nj));
  const int I = i + 1, J = j + 1, K = k + 1;     // ext coords
  const long long ne = g.n_ext();
  const long long e = g.ext(I, J, K);
  const long long P = g.pad(I + 1, J + 1, K + 1);

  // ---- SA source terms ----------------------------------------------------
  const float* gc = scr + S_G0 * ne + e;   // gradient q at gc[q * ne]
  const float wx = gc[(3 * 2 + 1) * ne] - gc[(3 * 1 + 2) * ne];
  const float wy = gc[(3 * 0 + 2) * ne] - gc[(3 * 2 + 0) * ne];
  const float wz = gc[(3 * 1 + 0) * ne] - gc[(3 * 0 + 1) * ne];
  const float omega = sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, 1e-32f));
  const float gn0 = gc[12 * ne], gn1 = gc[13 * ne], gn2 = gc[14 * ne];
  const float gnut2 = gn0 * gn0 + gn1 * gn1 + gn2 * gn2;

  const float rho_c = W[P * 6];
  const float nut_c = W[P * 6 + 5];
  const float nu_c = sutherland(scr[S_T * ne + e], mu_inf, s_suth) / rho_c;
  const float vol_c = vol[P];
  const float d_c = fmaxf(dist[e], 1e-12f);
  const float nut_pos = fmaxf(nut_c, 1e-14f);
  const float chi = nut_pos / nu_c;
  const float chi3 = chi * chi * chi;
  const float fv1 = chi3 / (chi3 + CV1_3);
  const float fv2 = 1.0f - chi / (1.0f + chi * fv1);
  const float inv_k2d2 = 1.0f / (KARMAN * KARMAN * (d_c * d_c));
  float s_tilde = omega + nut_pos * fv2 * inv_k2d2;
  s_tilde = fmaxf(s_tilde, 0.3f * omega + 1e-16f);
  const float ft2 = use_ft2 ? CT3 * expf(-CT4 * chi * chi) : 0.0f;
  const float r = fminf(nut_pos * inv_k2d2 / s_tilde, 10.0f);
  const float r2 = r * r;
  const float gfw = fminf(r + CW2 * (r2 * r2 * r2 - r), 100.0f);
  const float g2 = gfw * gfw;
  const float fw = gfw * powf((1.0f + CW3_6) / (g2 * g2 * g2 + CW3_6),
                              1.0f / 6.0f);
  const float prod = CB1 * (1.0f - ft2) * s_tilde * nut_c;
  const float nd = nut_c / d_c;
  const float destr = (CW1 * fw - CB1 / (KARMAN * KARMAN) * ft2) * (nd * nd);
  float Rt = -(prod - destr) * vol_c;
  Rt = Rt - (CB2 / SIGMA) * gnut2 * vol_c;

  // ---- face sweeps --------------------------------------------------------
  const float* sE[3] = {siE, sjE, skE};
  const float* pA[3] = {porI, porJ, porK};
  float Rinv[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float Rvis[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float qdiv = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const int dI = a == 0, dJ = a == 1, dK = a == 2;
    const FaceFlux lo = face_flux(a, I - dI, J - dJ, K - dK, g, W, sE[a],
                                  pA[a], xc, scr, vis2, vis4);
    const FaceFlux hi = face_flux(a, I, J, K, g, W, sE[a], pA[a], xc, scr,
                                  vis2, vis4);
    for (int c = 0; c < 5; ++c) Rinv[c] += hi.F[c] - lo.F[c];
    for (int m = 0; m < 3; ++m) Rvis[1 + m] -= hi.fm[m] - lo.fm[m];
    Rvis[4] -= hi.fen - lo.fen;
    Rt = Rt + (hi.fadv - lo.fadv);
    qdiv += hi.q - lo.q;
    Rt = Rt - (hi.fdif - lo.fdif);
  }
  Rt = Rt - nut_c * qdiv;

  float* o = out + t * 6;
  for (int c = 0; c < 5; ++c) o[c] = Rinv[c] + Rvis[c];
  o[5] = Rt * turb_scale;
}

}  // namespace

extern "C" int rans_residual_scratch_fields() { return N_SCRATCH; }

// Launch both passes on ``stream``; returns cudaGetLastError() (0 = ok).
// ``scratch`` holds N_SCRATCH * (ni+2)(nj+2)(nk+2) floats.
extern "C" int rans_residual_launch(
    const float* w, const float* siE, const float* sjE, const float* skE,
    const float* vol, const float* xc, const float* dist, const float* porI,
    const float* porJ, const float* porK, float* scratch, float* out, int ni,
    int nj, int nk, float vis2, float vis4, float expo, float mu_inf,
    float s_suth, int use_ft2, float turb_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{ni, nj, nk};
  const int threads = 256;
  const long long ne = (long long)(ni + 2) * (nj + 2) * (nk + 2);
  const long long n = (long long)ni * nj * nk;
  rans_pass1<<<(unsigned)((ne + threads - 1) / threads), threads, 0, s>>>(
      w, siE, sjE, skE, vol, scratch, g, expo, mu_inf, s_suth);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rans_pass2<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      w, siE, sjE, skE, vol, xc, dist, porI, porJ, porK, scratch, out, g,
      vis2, vis4, mu_inf, s_suth, use_ft2, turb_scale);
  return (int)cudaGetLastError();
}
