// Central flux with JST scalar dissipation of one halo-filled block: the
// five mean-flow residual channels.
//
// Replaces the TPU kernel adflow_tpu/ops/pallas_residual.py::_kernel (K2).
// It computes the same discretization as the plain PyTorch version
// adflow_torch/ops/cuda_inviscid.py::inviscid_residual_reference:
//   JST pressure sensor (max over the three directions)
//   spectral radii |u . s| + c |s| with directional scaling
//     r_a (1 + (r_b / r_a)^x + (r_c / r_a)^x)
//   central flux (average of the two cells' analytic fluxes) minus the
//     2nd/4th-difference dissipation, energy row differenced on rhoE + p,
//     convection and dissipation switched off at zero-porosity wall faces
//
// Layout: channels last, as the JAX package and the port keep their arrays
// (w5 (ni+4, nj+4, nk+4, 5), p (ni+4, nj+4, nk+4), siE (ni+3, nj+2, nk+2, 3),
// sjE (ni+2, nj+3, nk+2, 3), skE (ni+2, nj+2, nk+3, 3), porI (ni+1, nj, nk),
// porJ (ni, nj+1, nk), porK (ni, nj, nk+1)); out (ni, nj, nk, 5).
//
// Design (first version, simple and deterministic):
//   pass 1: one thread per cell of the one-ring extended grid
//           (ni+2)(nj+2)(nk+2) writes the sensor and the three scaled radii
//           to a scratch buffer (structure of arrays).
//   pass 2: one thread per interior cell computes its six faces and writes
//           its five channels. Each face is computed by both of its cells
//           with the same code, so there are no atomics and sums run in a
//           fixed order (i faces, then j, then k, as the plain version).
// The bound on this card is device-memory bytes: about 104 MB in and out per
// evaluation at 256x64x64 against ~0.4 GFLOP. This version adds the 17 MB
// scratch round trip and the neighbour re-reads (served by L1/L2) on top.
//
// Every constant is a float literal and only float math functions are used,
// so nothing runs in double. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr float GAMMA = 1.4f;

// scratch field slots (each a plane of ne floats)
enum { S_SENS = 0, S_SRI, S_SRJ, S_SRK, N_SCRATCH };

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
  // extended face array
  __device__ long long face(int a, int I, int J, int K) const {
    if (a == 0) return ((long long)I * (nj + 2) + J) * (nk + 2) + K;
    if (a == 1) return ((long long)I * (nj + 3) + J) * (nk + 2) + K;
    return ((long long)I * (nj + 2) + J) * (nk + 3) + K;
  }
  // interior face porosity for the same face
  __device__ long long por(int a, int I, int J, int K) const {
    const int i = I - 1, j = J - 1, k = K - 1;
    if (a == 0) return ((long long)i * nj + j) * nk + k;
    if (a == 1) return ((long long)i * (nj + 1) + j) * nk + k;
    return ((long long)i * nj + j) * (nk + 1) + k;
  }
};

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
// pass 1: sensor and scaled radii on the one-ring extended grid
// ---------------------------------------------------------------------------
__global__ void inviscid_pass1(const float* __restrict__ W,
                               const float* __restrict__ Pr,
                               const float* __restrict__ siE,
                               const float* __restrict__ sjE,
                               const float* __restrict__ skE,
                               float* __restrict__ scr, Grid g, float expo) {
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

  const float* q = W + P * 5;
  const float rho = q[0];
  const float u = q[1] / rho, v = q[2] / rho, w = q[3] / rho;
  const float p0 = Pr[P];
  const float csound = sqrtf(GAMMA * p0 / rho);

  float nu_s = 0.0f;
  float rad[3];
  for (int a = 0; a < 3; ++a) {
    const float sa = sens(Pr[P - stride[a]], p0, Pr[P + stride[a]]);
    nu_s = (a == 0) ? sa : fmaxf(nu_s, sa);

    const float* Slo = sE[a] + 3 * g.face(a, ei, ej, ek);
    const float* Shi = sE[a] + 3 * g.face(a, ei + e3[a][0], ej + e3[a][1],
                                          ek + e3[a][2]);
    const float sx = 0.5f * (Slo[0] + Shi[0]);
    const float sy = 0.5f * (Slo[1] + Shi[1]);
    const float sz = 0.5f * (Slo[2] + Shi[2]);
    rad[a] = fabsf(u * sx + v * sy + w * sz)
             + csound * sqrtf(sx * sx + sy * sy + sz * sz);
  }

  float* o = scr + t;
  o[S_SENS * ne] = nu_s;
  o[S_SRI * ne] = scale3(rad[0], rad[1], rad[2], expo);
  o[S_SRJ * ne] = scale3(rad[1], rad[0], rad[2], expo);
  o[S_SRK * ne] = scale3(rad[2], rad[0], rad[1], expo);
}

// ---------------------------------------------------------------------------
// pass 2: face fluxes per interior cell
// ---------------------------------------------------------------------------

// Total flux (central - dissipation) of the face along axis a between ext
// cells EL = (I, J, K) and ER = EL + e_a.
__device__ __forceinline__ void face_flux(
    int a, int I, int J, int K, const Grid& g, const float* __restrict__ W,
    const float* __restrict__ Pr, const float* __restrict__ sEa,
    const float* __restrict__ porA, const float* __restrict__ scr,
    float vis2, float vis4, float F[5]) {
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

  float cLL[5], cL[5], cR[5], cRR[5];
  for (int c = 0; c < 5; ++c) {
    cLL[c] = W[(PL - stride_p) * 5 + c];
    cL[c] = W[PL * 5 + c];
    cR[c] = W[(PL + stride_p) * 5 + c];
    cRR[c] = W[(PL + 2 * stride_p) * 5 + c];
  }
  const float pLL = Pr[PL - stride_p], pL = Pr[PL];
  const float pR = Pr[PL + stride_p], pRR = Pr[PL + 2 * stride_p];

  // central flux; convection off at wall faces (por = 0)
  const float qL = (cL[1] * sx + cL[2] * sy + cL[3] * sz) / cL[0] * por;
  const float qR = (cR[1] * sx + cR[2] * sy + cR[3] * sz) / cR[0] * por;
  const float pa = 0.5f * (pL + pR);
  float central[5];
  central[0] = 0.5f * (cL[0] * qL + cR[0] * qR);
  central[1] = 0.5f * (cL[1] * qL + cR[1] * qR) + pa * sx;
  central[2] = 0.5f * (cL[2] * qL + cR[2] * qR) + pa * sy;
  central[3] = 0.5f * (cL[3] * qL + cR[3] * qR) + pa * sz;
  central[4] = 0.5f * ((cL[4] + pL) * qL + (cR[4] + pR) * qR);

  // JST dissipation on (rho, rho u, rho v, rho w, rhoE + p)
  const float lam = 0.5f * (scr[(S_SRI + a) * ne + eL]
                            + scr[(S_SRI + a) * ne + eR]);
  const float e2 = vis2 * fmaxf(scr[S_SENS * ne + eL],
                                scr[S_SENS * ne + eR]);
  const float eps2 = e2 * por;
  const float eps4 = fmaxf(0.0f, vis4 - e2) * por;
  cLL[4] += pLL;
  cL[4] += pL;
  cR[4] += pR;
  cRR[4] += pRR;
  for (int c = 0; c < 5; ++c) {
    const float d1 = cR[c] - cL[c];
    const float d3 = cRR[c] - 3.0f * cR[c] + 3.0f * cL[c] - cLL[c];
    F[c] = central[c] - lam * (eps2 * d1 - eps4 * d3);
  }
}

__global__ void inviscid_pass2(const float* __restrict__ W,
                               const float* __restrict__ Pr,
                               const float* __restrict__ siE,
                               const float* __restrict__ sjE,
                               const float* __restrict__ skE,
                               const float* __restrict__ porI,
                               const float* __restrict__ porJ,
                               const float* __restrict__ porK,
                               const float* __restrict__ scr,
                               float* __restrict__ out, Grid g, float vis2,
                               float vis4) {
  const long long n = (long long)g.ni * g.nj * g.nk;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int k = (int)(t % g.nk);
  const int j = (int)((t / g.nk) % g.nj);
  const int i = (int)(t / ((long long)g.nk * g.nj));
  const int I = i + 1, J = j + 1, K = k + 1;     // ext coords

  const float* sE[3] = {siE, sjE, skE};
  const float* pA[3] = {porI, porJ, porK};
  float R[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int a = 0; a < 3; ++a) {
    const int dI = a == 0, dJ = a == 1, dK = a == 2;
    float lo[5], hi[5];
    face_flux(a, I - dI, J - dJ, K - dK, g, W, Pr, sE[a], pA[a], scr, vis2,
              vis4, lo);
    face_flux(a, I, J, K, g, W, Pr, sE[a], pA[a], scr, vis2, vis4, hi);
    for (int c = 0; c < 5; ++c) R[c] += hi[c] - lo[c];
  }
  float* o = out + t * 5;
  for (int c = 0; c < 5; ++c) o[c] = R[c];
}

}  // namespace

extern "C" int inviscid_residual_scratch_fields() { return N_SCRATCH; }

// Launch both passes on ``stream``; returns cudaGetLastError() (0 = ok).
// ``scratch`` holds N_SCRATCH * (ni+2)(nj+2)(nk+2) floats.
extern "C" int inviscid_residual_launch(
    const float* w5, const float* p, const float* siE, const float* sjE,
    const float* skE, const float* porI, const float* porJ, const float* porK,
    float* scratch, float* out, int ni, int nj, int nk, float vis2,
    float vis4, float expo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{ni, nj, nk};
  const int threads = 256;
  const long long ne = (long long)(ni + 2) * (nj + 2) * (nk + 2);
  const long long n = (long long)ni * nj * nk;
  inviscid_pass1<<<(unsigned)((ne + threads - 1) / threads), threads, 0, s>>>(
      w5, p, siE, sjE, skE, scratch, g, expo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  inviscid_pass2<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      w5, p, siE, sjE, skE, porI, porJ, porK, scratch, out, g, vis2, vis4);
  return (int)cudaGetLastError();
}
