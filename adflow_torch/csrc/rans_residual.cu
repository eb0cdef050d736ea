// Fused RANS-SA residual of one halo-filled block: all six channels.
//
// Replaces the TPU kernel adflow_tpu/ops/pallas_rans.py::_kernel (K1,
// pallas_call at :512, entry fused_rans_residual :635). It computes the same
// discretization as the plain PyTorch version
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
// Bound on an H100: device-memory bytes. One evaluation at 256x64x64 must
// read its inputs once and write its output once, 130.5 MB, or 39 us at
// 3.35 TB/s, against about 1.6 GFLOP, 23 us at 67 TFLOP/s in f32.
//
// Design: one launch, one pass, no scratch in device memory.
//   Each block owns a j-k tile of TJ x TK = 8 x 16 interior columns and
//   marches along i over a segment of SI interior planes (blockIdx.x: k
//   tile, .y: j tile, .z: segment; all three edges ragged and masked; SI
//   from cuda_rans.k1_tile_plan). A segment reads SI + 4 padded planes of w.
//   Padded plane P+3 lands in one raw plane of shared memory by cp.async
//   while the block computes interior plane P from planes P-1 .. P+2; then
//   the block converts it, once, into a plane of Cells (load_cell's 11
//   floats a cell, structure of arrays) in a ring of four. A plane spans
//   (TJ+4)(TK+4) cells. Rows are copied 16 bytes at a time where the tile
//   plan proves every row start 16-byte aligned, else 4 bytes at a time.
//   The 22 derived fields of each extended cell of the tile's one-ring
//   (mu_eff, k_eff, nu_eff, sensor, three scaled radii, 15 gradient
//   components; the four corners, which no face reads, are skipped) live in
//   shared memory for the current plane and the next.
//   Every face is computed once: the j- and k-faces of the current plane by
//   one thread each, through one code path, into shared memory; the i-face
//   above a column by the column's first thread, which keeps it in registers
//   as the next plane's lower face. Two threads serve a column (256 a
//   block): both share the plane's derived cells and faces; then the first
//   computes the i-face while the second computes the SA source. Each cell
//   sums its faces in a fixed order (i, j, k; hi - lo), so there are no
//   atomics and two launches give the same bits.
//   Before its first plane a segment computes one warm-up plane: the derived
//   fields of the extended plane below it and the i-face between the two.
//   Shared memory: raw plane 5,760 B + Cells 42,240 B + derived 31,680 B +
//   face fluxes 13,440 B + SA sources 512 B = 93,632 B a block. nvcc
//   -Xptxas -v: 128 registers, no spills; two blocks (16 warps) a SM, which
//   the registers cap (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//   What holds it back is latency, not bytes: each thread runs long chains
//   of IEEE f32 divisions, square roots and powf, and 16 warps a SM hide
//   little of them. Without the Cell ring (load_cell recomputed at every
//   use), or with one thread a column, it ran 1.3-1.45x slower.
//   No tensor-core path applies: this is a stencil with no matrix product.
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

// derived-field slots of one extended cell (each a plane of (TJ+2)(TK+2)
// floats in shared memory)
enum {
  D_MU = 0, D_K, D_NUE, D_SENS, D_SRI, D_SRJ, D_SRK, D_G0,
  N_DERIVED = D_G0 + 15
};
constexpr int N_FACE = 12;   // floats of one FaceFlux in shared memory
constexpr int N_CELL = 11;   // floats of one Cell in shared memory

// the tile and its shared-memory plan (cuda_rans.k1_tile_plan mirrors it)
constexpr int TJ = 8, TK = 16;
constexpr int NC = TJ * TK;                   // columns
constexpr int NT = 2 * NC;                    // threads: two a column
constexpr int RK = TK + 4;                    // ring cells a row
constexpr int NCELL = (TJ + 4) * RK;          // ring cells a plane
constexpr int RPLANE = NCELL * 6;             // floats a raw w plane
constexpr int CPLANES = 4;                    // planes of Cells
constexpr int DK = TK + 2;                    // derived cells a row
constexpr int DPLANE = (TJ + 2) * DK;         // floats a derived field
constexpr int DITEMS = (DPLANE + 31) / 32 * 32;   // in whole warps
constexpr int NFJ = (TJ + 1) * TK;            // j-faces a plane
constexpr int NFK = TJ * (TK + 1);            // k-faces a plane
constexpr int SMEM_FLOATS = RPLANE + CPLANES * N_CELL * NCELL
                            + 2 * N_DERIVED * DPLANE + N_FACE * (NFJ + NFK)
                            + NC;

struct Grid {
  int ni, nj, nk;
  __device__ long long pad(int I, int J, int K) const {       // padded cell
    return ((long long)I * (nj + 4) + J) * (nk + 4) + K;
  }
  __device__ long long ext(int I, int J, int K) const {       // ext cell
    return ((long long)I * (nj + 2) + J) * (nk + 2) + K;
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
// asynchronous copies into shared memory
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Padded plane p of w, rows j0 .. j0+TJ+3 and cells k0 .. k0+TK+3, into the
// raw plane (rows past the block's edge repeat its last row or cell, so every
// cell holds finite data). One commit group per plane.
__device__ __forceinline__ void load_plane(float* dst,
                                           const float* __restrict__ W,
                                           const Grid& g, int p, int j0,
                                           int k0, bool wide) {
  constexpr int RJ = TJ + 4, ROW = RK * 6;
  static_assert(ROW % 4 == 0, "a ring row is a whole number of 16 B");
  if (wide) {
    // every row lies inside the block and starts 16-byte aligned
    constexpr int ROW4 = ROW / 4;
    for (int e = threadIdx.x; e < RJ * ROW4; e += NT) {
      const int r = e / ROW4, c = e - r * ROW4;
      const int J = min(j0 + r, g.nj + 3);
      cp_async16(dst + r * ROW + 4 * c, W + g.pad(p, J, k0) * 6 + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < RJ * ROW; e += NT) {
      const int r = e / ROW, c = e - r * ROW;
      const int J = min(j0 + r, g.nj + 3);
      const int K = min(k0 + c / 6, g.nk + 3);
      cp_async4(dst + e, W + g.pad(p, J, K) * 6 + (c % 6));
    }
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// derived fields of one extended cell
// ---------------------------------------------------------------------------
// Ext cell (I, J, K): its Cell c and its neighbours below and above along
// i, j and k. Writes field f to d[f * ds].
__device__ __forceinline__ void derived_cell(
    const Cell& c, const Cell& im, const Cell& ip, const Cell& jm,
    const Cell& jp, const Cell& km, const Cell& kp,
    const float* __restrict__ siE, const float* __restrict__ sjE,
    const float* __restrict__ skE, const float* __restrict__ vol,
    const Grid& g, int I, int J, int K, float expo, float mu_inf,
    float s_suth, float* d, int ds) {
  const float* sE[3] = {siE, sjE, skE};
  const int e3[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};

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

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const Cell& lo = a == 0 ? im : a == 1 ? jm : km;
    const Cell& hi = a == 0 ? ip : a == 1 ? jp : kp;
    const float sa = sens(lo.p, c.p, hi.p);
    nu_s = (a == 0) ? sa : fmaxf(nu_s, sa);

    const float* Slo = sE[a] + 3 * g.face(a, I, J, K);
    const float* Shi = sE[a] + 3 * g.face(a, I + e3[a][0], J + e3[a][1],
                                          K + e3[a][2]);
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
  const float vc = vol[g.pad(I + 1, J + 1, K + 1)];

  d[D_MU * ds] = mu_eff;
  d[D_K * ds] = k_eff;
  d[D_NUE * ds] = nue;
  d[D_SENS * ds] = nu_s;
  d[D_SRI * ds] = scale3(rad[0], rad[1], rad[2], expo);
  d[D_SRJ * ds] = scale3(rad[1], rad[0], rad[2], expo);
  d[D_SRK * ds] = scale3(rad[2], rad[0], rad[1], expo);
  for (int q = 0; q < 15; ++q) d[(D_G0 + q) * ds] = grad[q] / vc;
}

// ---------------------------------------------------------------------------
// one face's fluxes
// ---------------------------------------------------------------------------
struct FaceFlux {
  float F[5];      // inviscid central - JST dissipation
  float fm[3];     // viscous momentum flux tau . S
  float fen;       // viscous energy flux
  float q;         // u_f . S
  float fadv;      // SA upwind advection
  float fdif;      // SA diffusion
};

// Face along axis a between ext cells L and R = L + e_a: the four cells
// LL, L, R, RR along a, the face vector S, its porosity, the derived fields
// of L and R (field f at dL[f * ds], dR[f * ds]) and their cell centres.
__device__ __forceinline__ FaceFlux face_flux(
    int a, const Cell& cLL, const Cell& cL, const Cell& cR, const Cell& cRR,
    const float* __restrict__ S, float por, const float* dL,
    const float* dR, int ds, const float* __restrict__ xL,
    const float* __restrict__ xR, float vis2, float vis4) {
  const float sx = S[0], sy = S[1], sz = S[2];

  FaceFlux out;

  // ---- inviscid central flux + JST dissipation ----------------------------
  const float qL = (cL.mx * sx + cL.my * sy + cL.mz * sz) / cL.rho * por;
  const float qR = (cR.mx * sx + cR.my * sy + cR.mz * sz) / cR.rho * por;
  const float pa = 0.5f * (cL.p + cR.p);
  float central[5];
  central[0] = 0.5f * (cL.rho * qL + cR.rho * qR);
  central[1] = 0.5f * (cL.mx * qL + cR.mx * qR) + pa * sx;
  central[2] = 0.5f * (cL.my * qL + cR.my * qR) + pa * sy;
  central[3] = 0.5f * (cL.mz * qL + cR.mz * qR) + pa * sz;
  central[4] = 0.5f * ((cL.rhoE + cL.p) * qL + (cR.rhoE + cR.p) * qR);

  const float lam = 0.5f * (dL[(D_SRI + a) * ds] + dR[(D_SRI + a) * ds]);
  const float e2 = vis2 * fmaxf(dL[D_SENS * ds], dR[D_SENS * ds]);
  const float eps2 = e2 * por;
  const float eps4 = fmaxf(0.0f, vis4 - e2) * por;
  const float dLL[5] = {cLL.rho, cLL.mx, cLL.my, cLL.mz, cLL.rhoE + cLL.p};
  const float dL5[5] = {cL.rho, cL.mx, cL.my, cL.mz, cL.rhoE + cL.p};
  const float dR5[5] = {cR.rho, cR.mx, cR.my, cR.mz, cR.rhoE + cR.p};
  const float dRR[5] = {cRR.rho, cRR.mx, cRR.my, cRR.mz, cRR.rhoE + cRR.p};
  for (int c = 0; c < 5; ++c) {
    const float d1 = dR5[c] - dL5[c];
    const float d3 = dRR[c] - 3.0f * dR5[c] + 3.0f * dL5[c] - dLL[c];
    out.F[c] = central[c] - lam * (eps2 * d1 - eps4 * d3);
  }

  // ---- normal-corrected face gradients ------------------------------------
  const float del[3] = {xR[0] - xL[0], xR[1] - xL[1], xR[2] - xL[2]};
  const float dist = sqrtf(fmaxf(
      del[0] * del[0] + del[1] * del[1] + del[2] * del[2], 1e-30f));
  const float eh[3] = {del[0] / dist, del[1] / dist, del[2] / dist};
  const float phL[5] = {cL.u, cL.v, cL.w, cL.T, cL.nut};
  const float phR[5] = {cR.u, cR.v, cR.w, cR.T, cR.nut};
  float gf[5][3];
  for (int f = 0; f < 5; ++f) {
    float gb[3];
    for (int m = 0; m < 3; ++m)
      gb[m] = 0.5f * (dL[(D_G0 + 3 * f + m) * ds]
                      + dR[(D_G0 + 3 * f + m) * ds]);
    const float g_e = gb[0] * eh[0] + gb[1] * eh[1] + gb[2] * eh[2];
    const float corr = (phR[f] - phL[f]) / dist - g_e;
    for (int m = 0; m < 3; ++m) gf[f][m] = gb[m] + corr * eh[m];
  }

  // ---- viscous stress and heat flux ---------------------------------------
  const float mu_f = 0.5f * (dL[D_MU * ds] + dR[D_MU * ds]);
  const float k_f = 0.5f * (dL[D_K * ds] + dR[D_K * ds]);
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
  const float nue_f = 0.5f * (dL[D_NUE * ds] + dR[D_NUE * ds]);
  out.fdif = (1.0f / SIGMA) * nue_f
             * (gf[4][0] * sx + gf[4][1] * sy + gf[4][2] * sz);
  return out;
}

__device__ __forceinline__ void store_face(float* b, int n,
                                           const FaceFlux& f) {
  for (int c = 0; c < 5; ++c) b[c * n] = f.F[c];
  for (int m = 0; m < 3; ++m) b[(5 + m) * n] = f.fm[m];
  b[8 * n] = f.fen;
  b[9 * n] = f.q;
  b[10 * n] = f.fadv;
  b[11 * n] = f.fdif;
}

__device__ __forceinline__ FaceFlux load_face(const float* b, int n) {
  FaceFlux f;
  for (int c = 0; c < 5; ++c) f.F[c] = b[c * n];
  for (int m = 0; m < 3; ++m) f.fm[m] = b[(5 + m) * n];
  f.fen = b[8 * n];
  f.q = b[9 * n];
  f.fadv = b[10 * n];
  f.fdif = b[11 * n];
  return f;
}

// One axis's face differences, in the order the plain version sums them.
__device__ __forceinline__ void add_axis(const FaceFlux& lo,
                                         const FaceFlux& hi, float* Rinv,
                                         float* Rvis, float& Rt,
                                         float& qdiv) {
  for (int c = 0; c < 5; ++c) Rinv[c] += hi.F[c] - lo.F[c];
  for (int m = 0; m < 3; ++m) Rvis[1 + m] -= hi.fm[m] - lo.fm[m];
  Rvis[4] -= hi.fen - lo.fen;
  Rt = Rt + (hi.fadv - lo.fadv);
  qdiv += hi.q - lo.q;
  Rt = Rt - (hi.fdif - lo.fdif);
}

// SA production, destruction and cb2 term of one interior cell, times its
// volume: the SA residual before the face sums. Gradient q at gc[q * ds].
__device__ __forceinline__ float sa_source(const float* gc, int ds,
                                           const Cell& c, float vol_c,
                                           float dist_c, float mu_inf,
                                           float s_suth, int use_ft2) {
  const float wx = gc[(3 * 2 + 1) * ds] - gc[(3 * 1 + 2) * ds];
  const float wy = gc[(3 * 0 + 2) * ds] - gc[(3 * 2 + 0) * ds];
  const float wz = gc[(3 * 1 + 0) * ds] - gc[(3 * 0 + 1) * ds];
  const float omega = sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, 1e-32f));
  const float gn0 = gc[12 * ds], gn1 = gc[13 * ds], gn2 = gc[14 * ds];
  const float gnut2 = gn0 * gn0 + gn1 * gn1 + gn2 * gn2;

  const float rho_c = c.rho;
  const float nut_c = c.nut;
  const float nu_c = sutherland(c.T, mu_inf, s_suth) / rho_c;
  const float d_c = fmaxf(dist_c, 1e-12f);
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
  return Rt;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_cell(float* b, int n, const Cell& c) {
  b[0 * n] = c.rho;
  b[1 * n] = c.mx;
  b[2 * n] = c.my;
  b[3 * n] = c.mz;
  b[4 * n] = c.rhoE;
  b[5 * n] = c.u;
  b[6 * n] = c.v;
  b[7 * n] = c.w;
  b[8 * n] = c.p;
  b[9 * n] = c.T;
  b[10 * n] = c.nut;
}

__device__ __forceinline__ Cell read_cell(const float* b, int n) {
  Cell c;
  c.rho = b[0 * n];
  c.mx = b[1 * n];
  c.my = b[2 * n];
  c.mz = b[3 * n];
  c.rhoE = b[4 * n];
  c.u = b[5 * n];
  c.v = b[6 * n];
  c.w = b[7 * n];
  c.p = b[8 * n];
  c.T = b[9 * n];
  c.nut = b[10 * n];
  return c;
}

__global__ void __launch_bounds__(NT, 2) rans_residual_kernel(
    const float* __restrict__ W, const float* __restrict__ siE,
    const float* __restrict__ sjE, const float* __restrict__ skE,
    const float* __restrict__ vol, const float* __restrict__ xc,
    const float* __restrict__ dist, const float* __restrict__ porI,
    const float* __restrict__ porJ, const float* __restrict__ porK,
    float* __restrict__ out, Grid g, int si, int wide, float vis2,
    float vis4, float expo, float mu_inf, float s_suth, int use_ft2,
    float turb_scale) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);    // [RPLANE], cp.async
  float* cells = raw + RPLANE;                     // [CPLANES][N_CELL][NCELL]
  float* dsh = cells + CPLANES * N_CELL * NCELL;   // [2][N_DERIVED][DPLANE]
  float* fjb = dsh + 2 * N_DERIVED * DPLANE;       // [N_FACE][NFJ]
  float* fkb = fjb + N_FACE * NFJ;                 // [N_FACE][NFK]
  float* sab = fkb + N_FACE * NFK;                 // [NC] SA sources

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ;
  const int i0 = blockIdx.z * si, i1 = min(i0 + si, g.ni);
  // padded planes of the segment's first and last interior cells
  const int P0 = i0 + 2, PE = i1 + 1;

  // padded plane p's Cells and derived fields
  auto cell_slot = [&](int p) {
    return cells + (p % CPLANES) * N_CELL * NCELL;
  };
  auto dslot = [&](int p) { return dsh + (p & 1) * N_DERIVED * DPLANE; };
  auto cell = [&](int p, int P) { return read_cell(cell_slot(p) + P, NCELL); };

  // derived fields of padded plane p (ext plane p - 1) over the one-ring
  auto derived = [&](int p, int it) {
    const int jj = it / DK, kk = it - jj * DK;
    const int J = j0 + jj, K = k0 + kk;
    const bool corner = (jj == 0 || jj == TJ + 1) && (kk == 0 || kk == TK + 1);
    if (it < DPLANE && !corner && J <= g.nj + 1 && K <= g.nk + 1)
      derived_cell(cell(p, (jj + 1) * RK + kk + 1),
                   cell(p - 1, (jj + 1) * RK + kk + 1),
                   cell(p + 1, (jj + 1) * RK + kk + 1),
                   cell(p, jj * RK + kk + 1), cell(p, (jj + 2) * RK + kk + 1),
                   cell(p, (jj + 1) * RK + kk), cell(p, (jj + 1) * RK + kk + 2),
                   siE, sjE, skE, vol, g, p - 1, J, K, expo, mu_inf, s_suth,
                   dslot(p) + it, DPLANE);
  };

  // planes P0-2 .. P0+1 straight from device memory into their Cells
  for (int p = P0 - 2; p <= P0 + 1; ++p)
    for (int it = tid; it < NCELL; it += NT) {
      const int r = it / RK, c = it - r * RK;
      store_cell(cell_slot(p) + it, NCELL,
                 load_cell(W, g.pad(p, min(j0 + r, g.nj + 3),
                                    min(k0 + c, g.nk + 3))));
    }
  __syncthreads();
  for (int it = tid; it < DPLANE; it += NT) derived(P0 - 1, it);   // warm-up

  // this thread's column: the first of its two threads computes the i-face
  // and sums, the second the SA source
  const int cid = tid % NC;
  const bool first = tid < NC;
  const int jl = cid / TK, kl = cid - jl * TK;
  const int j = j0 + jl, k = k0 + kl;
  const bool col = j < g.nj && k < g.nk;
  const int Pc = (jl + 2) * RK + kl + 2;     // its cell in a ring plane
  const int Dc = (jl + 1) * DK + kl + 1;     // its cell in a derived plane
  FaceFlux lo = {};                          // its i-face below plane Q

  // step Q: derived fields of plane Q+1, the i-face between Q and Q+1 and,
  // from Q = P0 on, the residual of interior plane Q
  for (int Q = P0 - 1; Q <= PE; ++Q) {
    cp_async_wait_all();           // plane Q+2 has landed in the raw plane
    __syncthreads();
    if (Q >= P0) {                 // into plane Q-2's slot, which is free
      for (int it = tid; it < NCELL; it += NT)
        store_cell(cell_slot(Q + 2) + it, NCELL, load_cell(raw, it));
      __syncthreads();
    }
    if (Q < PE) load_plane(raw, W, g, Q + 3, j0, k0, wide);

    // derived items first, in whole warps, then the j- and k-faces of plane
    // Q through one code path
    const int n_items = Q >= P0 ? DITEMS + NFJ + NFK : DPLANE;
    const float* d0 = dslot(Q);
    for (int it = tid; it < n_items; it += NT) {
      if (it < DITEMS) {
        derived(Q + 1, it);
        continue;
      }
      // j-face f between ext (Q-1, J, K) and (Q-1, J+1, K), or k-face
      // between ext (Q-1, J, K) and (Q-1, J, K+1)
      const int f = it - DITEMS;
      const bool jf = f < NFJ;
      const int fb = jf ? f : f - NFJ;       // in its axis's face buffer
      const int row = jf ? fb / TK : fb / (TK + 1);
      const int cl = jf ? fb - row * TK : fb - row * (TK + 1);
      const int J = jf ? j0 + row : j0 + row + 1;
      const int K = jf ? k0 + cl + 1 : k0 + cl;
      if (J > g.nj || K > g.nk) continue;
      const int P = jf ? row * RK + cl + 2 : (row + 2) * RK + cl;
      const int step = jf ? RK : 1;
      const float* dL = d0 + (jf ? row * DK + cl + 1 : (row + 1) * DK + cl);
      const int JR = J + jf, KR = K + !jf;
      const FaceFlux ff = face_flux(
          jf ? 1 : 2, cell(Q, P), cell(Q, P + step), cell(Q, P + 2 * step),
          cell(Q, P + 3 * step),
          jf ? sjE + 3 * g.face(1, Q - 1, JR, KR)
             : skE + 3 * g.face(2, Q - 1, JR, KR),
          jf ? porJ[g.por(1, Q - 1, JR, KR)] : porK[g.por(2, Q - 1, JR, KR)],
          dL, dL + (jf ? DK : 1), DPLANE, xc + 3 * g.ext(Q - 1, J, K),
          xc + 3 * g.ext(Q - 1, JR, KR), vis2, vis4);
      if (jf)
        store_face(fjb + fb, NFJ, ff);
      else
        store_face(fkb + fb, NFK, ff);
    }
    __syncthreads();

    // SA source of the column's cell of plane Q (second thread); then the
    // i-face between ext (Q-1, j+1, k+1) and (Q, j+1, k+1) and the sums
    // (first thread)
    const int J = j + 1, K = k + 1;
    const float* dc = d0 + Dc;
    if (!first && col && Q >= P0)
      sab[cid] = sa_source(dc + D_G0 * DPLANE, DPLANE, cell(Q, Pc),
                           vol[g.pad(Q, J + 1, K + 1)],
                           dist[g.ext(Q - 1, J, K)], mu_inf, s_suth, use_ft2);
    __syncthreads();
    if (!first || !col) continue;
    const Cell c = cell(Q, Pc);
    const FaceFlux hi = face_flux(
        0, cell(Q - 1, Pc), c, cell(Q + 1, Pc), cell(Q + 2, Pc),
        siE + 3 * g.face(0, Q, J, K), porI[g.por(0, Q, J, K)], dc,
        dslot(Q + 1) + Dc, DPLANE, xc + 3 * g.ext(Q - 1, J, K),
        xc + 3 * g.ext(Q, J, K), vis2, vis4);
    if (Q >= P0) {
      float Rt = sab[cid];
      float Rinv[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float Rvis[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float qdiv = 0.0f;
      add_axis(lo, hi, Rinv, Rvis, Rt, qdiv);
      add_axis(load_face(fjb + jl * TK + kl, NFJ),
               load_face(fjb + (jl + 1) * TK + kl, NFJ), Rinv, Rvis, Rt,
               qdiv);
      add_axis(load_face(fkb + jl * (TK + 1) + kl, NFK),
               load_face(fkb + jl * (TK + 1) + kl + 1, NFK), Rinv, Rvis, Rt,
               qdiv);
      Rt = Rt - c.nut * qdiv;

      float* o = out + (((long long)(Q - 2) * g.nj + j) * g.nk + k) * 6;
      for (int m = 0; m < 5; ++m) o[m] = Rinv[m] + Rvis[m];
      o[5] = Rt * turb_scale;
    }
    lo = hi;
  }
}

}  // namespace

// Launch the kernel on ``stream`` with the tile plan of
// adflow_torch/ops/cuda_rans.py::k1_tile_plan: its tile (tj x tk), threads
// and dynamic shared bytes must be this source's; the segment si and the
// copy width (4 or 16 bytes) are the plan's. Returns cudaGetLastError()
// (0 = ok).
extern "C" int rans_residual_launch(
    const float* w, const float* siE, const float* sjE, const float* skE,
    const float* vol, const float* xc, const float* dist, const float* porI,
    const float* porJ, const float* porK, float* out, int ni, int nj, int nk,
    int tj, int tk, int threads, int si, int copy_width, int smem_bytes,
    float vis2, float vis4, float expo, float mu_inf, float s_suth,
    int use_ft2, float turb_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{ni, nj, nk};
  constexpr int bytes = SMEM_FLOATS * 4;
  if (tj != TJ || tk != TK || threads != NT || smem_bytes != bytes ||
      si < 1 || (copy_width != 4 && copy_width != 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rans_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nk + TK - 1) / TK, (nj + TJ - 1) / TJ, (ni + si - 1) / si);
  rans_residual_kernel<<<grid, NT, bytes, s>>>(
      w, siE, sjE, skE, vol, xc, dist, porI, porJ, porK, out, g, si,
      copy_width == 16, vis2, vis4, expo, mu_inf, s_suth, use_ft2,
      turb_scale);
  return (int)cudaGetLastError();
}
