// Central flux with JST scalar dissipation of one halo-filled block: the
// five mean-flow residual channels.
//
// Replaces the TPU kernel adflow_tpu/ops/pallas_residual.py::_kernel (K2,
// pallas_call at :225, entry fused_inviscid_residual :303). It computes the
// same discretization as the plain PyTorch version
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
// Bound on an H100: device-memory bytes. One evaluation at 256x64x64 must
// read its inputs once and write its output once, 103.5 MB, or 31 us at
// 3.35 TB/s, against about 0.44 GFLOP, 6.5 us at 67 TFLOP/s in f32.
//
// Design: one launch, one pass, no scratch in device memory (the design of
// rans_residual.cu, K1).
//   Each block owns a j-k tile of TJ x TK = 8 x 16 interior columns and
//   marches along i over a segment of SI interior planes (blockIdx.x: k
//   tile, .y: j tile, .z: segment; all three edges ragged and masked; SI
//   from cuda_inviscid.k2_tile_plan). A segment reads SI + 4 padded planes
//   of w5 and p. Two threads serve a column (256 a block). Padded plane P+3
//   of both lands by cp.async in one raw plane of shared memory while the
//   block computes the faces of interior plane P from planes P-1 .. P+2;
//   the second threads then convert it, once, into a plane of Cells (rho,
//   u, v, w, p, rhoE + p; structure of arrays) in a ring of five and start
//   the copy of plane P+4, while the first threads compute the i-faces. So
//   1/rho is taken once a cell and plane.
//   A plane spans (TJ+4)(TK+4) cells. Rows are copied 16 bytes at a time
//   where the tile plan proves every row start 16-byte aligned, else 4
//   bytes at a time.
//   The sensor and the three scaled radii of each extended cell of the
//   tile's one-ring (the four corners, which no face reads, are skipped)
//   live in shared memory for the current plane and the next. The face
//   vectors they need come from device memory, once an extended cell.
//   Every face is computed once: the j- and k-faces of the current plane by
//   one thread each, through one code path, into shared memory; the i-face
//   above a column by the column's first thread, which keeps it in shared
//   memory as the next plane's lower face, and sums the column's cell. Each
//   cell sums its faces in a fixed order (i, j, k; hi - lo), so there are no
//   atomics and two launches give the same bits.
//   Before its first plane a segment computes one warm-up plane: the derived
//   fields of the extended plane below it and the i-face between the two.
//   Shared memory: raw plane 5,760 B + Cells 28,800 B + derived 5,760 B +
//   j- and k-face fluxes 5,600 B + i-face fluxes 2,560 B = 48,480 B a block;
//   four blocks (32 warps) an SM, which caps a thread at 64 registers. So
//   offsets are 32-bit and the carried i-face lives in shared memory, not
//   in registers, and nothing spills.
//   What holds it back is latency and issue, not bytes: the derived fields
//   of an extended cell are long chains of square roots and transcendentals.
//   So they take no powf and one division each: the scaled radii as
//   2^(x (log2 r_b - log2 (r_a + eps))), the sensor's largest ratio chosen
//   by cross products before its one division; a Cell's velocities by one
//   reciprocal. These round differently from the plain version, within the
//   kernel's tolerance (PERF.md has each step's time).
//   No tensor-core path applies: this is a stencil with no matrix product.
//
// Every constant is a float literal and only float math functions are used,
// so nothing runs in double. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr float GAMMA = 1.4f;

// derived-field slots of one extended cell (each a plane of (TJ+2)(TK+2)
// floats in shared memory)
enum { D_SENS = 0, D_SRI, D_SRJ, D_SRK, N_DERIVED };
// Cell slots (each a plane of NCELL floats in shared memory)
enum { C_RHO = 0, C_U, C_V, C_W, C_P, C_E, N_CELL };
constexpr int N_FACE = 5;    // floats of one face flux in shared memory

// the tile and its shared-memory plan (cuda_inviscid.k2_tile_plan mirrors
// it)
constexpr int TJ = 8, TK = 16;
constexpr int NC = TJ * TK;                   // columns
constexpr int TPC = 2;                        // threads a column
constexpr int NT = TPC * NC;                  // threads a block
constexpr int MIN_BLOCKS = 4;                 // blocks an SM
constexpr int RJ = TJ + 4, RK = TK + 4;       // ring rows, cells a row
constexpr int NCELL = RJ * RK;                // ring cells a plane
constexpr int RPLANE = NCELL * 6;             // floats a raw w5 + p plane
constexpr int CPLANES = 5;                    // planes of Cells a ring
constexpr int DK = TK + 2;                    // derived cells a row
constexpr int DPLANE = (TJ + 2) * DK;         // floats a derived field
constexpr int DITEMS = (DPLANE + 31) / 32 * 32;   // in whole warps
constexpr int NFJ = (TJ + 1) * TK;            // j-faces a plane
constexpr int NFK = TJ * (TK + 1);            // k-faces a plane
constexpr int SMEM_FLOATS = RPLANE + CPLANES * N_CELL * NCELL
                            + 2 * N_DERIVED * DPLANE + N_FACE * (NFJ + NFK)
                            + N_FACE * NC;

// Offsets are 32-bit: the launch refuses a block whose w5 holds 2^31
// floats or more, so every offset into every operand fits an int.
struct Grid {
  int ni, nj, nk;
  __device__ int pad(int I, int J, int K) const {             // padded cell
    return (I * (nj + 4) + J) * (nk + 4) + K;
  }
  // face between ext cells E - e_a and E, addressed by E, in the axis-a
  // extended face array (siE (ni+3,nj+2,nk+2), sjE (ni+2,nj+3,nk+2), ...)
  __device__ int face(int a, int I, int J, int K) const {
    if (a == 0) return (I * (nj + 2) + J) * (nk + 2) + K;
    if (a == 1) return (I * (nj + 3) + J) * (nk + 2) + K;
    return (I * (nj + 2) + J) * (nk + 3) + K;
  }
  // interior face porosity for the same face (porI (ni+1,nj,nk), ...)
  __device__ int por(int a, int I, int J, int K) const {
    const int i = I - 1, j = J - 1, k = K - 1;
    if (a == 0) return (i * nj + j) * nk + k;
    if (a == 1) return (i * (nj + 1) + j) * nk + k;
    return (i * nj + j) * (nk + 1) + k;
  }
};

struct Cell {
  float rho, u, v, w, p, e;    // e = rhoE + p
};

// The directionally scaled radii r_a (1 + (r_b / (r_a + eps))^x +
// (r_c / (r_a + eps))^x), each power as 2^(x (log2 r_b - log2 (r_a + eps))):
// six log2f and six exp2f, no division and no powf.
__device__ __forceinline__ void scaled_radii(const float rad[3], float expo,
                                             float sr[3]) {
  const float eps = 1e-30f;
  float lr[3], le[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lr[a] = log2f(rad[a]);
    le[a] = log2f(rad[a] + eps);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b = a == 0 ? 1 : 0, c = a == 2 ? 1 : 2;
    sr[a] = rad[a] * (1.0f + exp2f(expo * (lr[b] - le[a]))
                      + exp2f(expo * (lr[c] - le[a])));
  }
}

// A Cell from the five conservative values q and the pressure p.
__device__ __forceinline__ Cell make_cell(const float* q, float p) {
  Cell c;
  c.rho = q[0];
  const float r = 1.0f / c.rho;
  c.u = q[1] * r;
  c.v = q[2] * r;
  c.w = q[3] * r;
  c.p = p;
  c.e = q[4] + p;
  return c;
}

__device__ __forceinline__ void store_cell(float* b, const Cell& c) {
  b[C_RHO * NCELL] = c.rho;
  b[C_U * NCELL] = c.u;
  b[C_V * NCELL] = c.v;
  b[C_W * NCELL] = c.w;
  b[C_P * NCELL] = c.p;
  b[C_E * NCELL] = c.e;
}

__device__ __forceinline__ Cell read_cell(const float* b) {
  Cell c;
  c.rho = b[C_RHO * NCELL];
  c.u = b[C_U * NCELL];
  c.v = b[C_V * NCELL];
  c.w = b[C_W * NCELL];
  c.p = b[C_P * NCELL];
  c.e = b[C_E * NCELL];
  return c;
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

// Padded plane i of w5 and of p, rows j0 .. j0+TJ+3 and cells k0 .. k0+TK+3,
// into the raw plane: w5 rows first (5 floats a cell), then p rows (rows
// past the block's edge repeat its last row or cell, so every cell holds
// finite data). Called by the NC second threads of the columns only; one
// commit group per plane.
__device__ __forceinline__ void load_plane(float* dst,
                                           const float* __restrict__ W,
                                           const float* __restrict__ Pr,
                                           const Grid& g, int i, int j0,
                                           int k0, bool wide) {
  constexpr int WROW = RK * 5;            // floats of a w5 row
  static_assert(WROW % 4 == 0 && RK % 4 == 0,
                "a ring row is a whole number of 16 B");
  float* dp = dst + NCELL * 5;
  if (wide) {
    // every row lies inside the block and starts 16-byte aligned
    constexpr int W4 = WROW / 4, P4 = RK / 4;
    for (int e = threadIdx.x - NC; e < RJ * (W4 + P4); e += NC) {
      if (e < RJ * W4) {
        const int r = e / W4, c = e - r * W4;
        const int row = g.pad(i, min(j0 + r, g.nj + 3), k0);
        cp_async16(dst + r * WROW + 4 * c, W + row * 5 + 4 * c);
      } else {
        const int f = e - RJ * W4;
        const int r = f / P4, c = f - r * P4;
        const int row = g.pad(i, min(j0 + r, g.nj + 3), k0);
        cp_async16(dp + r * RK + 4 * c, Pr + row + 4 * c);
      }
    }
  } else {
    for (int e = threadIdx.x - NC; e < NCELL * 6; e += NC) {
      if (e < NCELL * 5) {
        const int r = e / WROW, c = e - r * WROW;
        const int J = min(j0 + r, g.nj + 3);
        const int K = min(k0 + c / 5, g.nk + 3);
        cp_async4(dst + e, W + g.pad(i, J, K) * 5 + (c % 5));
      } else {
        const int f = e - NCELL * 5;
        const int r = f / RK, c = f - r * RK;
        const int J = min(j0 + r, g.nj + 3);
        const int K = min(k0 + c, g.nk + 3);
        cp_async4(dp + f, Pr + g.pad(i, J, K));
      }
    }
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// derived fields of one extended cell: sensor and scaled radii
// ---------------------------------------------------------------------------
// Ext cell (I, J, K): its Cell c and the pressures of its neighbours below
// and above along i, j and k. Writes field f to d[f * DPLANE].
__device__ __forceinline__ void derived_cell(
    const Cell& c, const float pn[3][2], const float* __restrict__ siE,
    const float* __restrict__ sjE, const float* __restrict__ skE,
    const Grid& g, int I, int J, int K, float expo, float* d) {
  const float* sE[3] = {siE, sjE, skE};
  const int e3[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  const float csound = sqrtf(GAMMA * c.p / c.rho);
  // the sensor: the largest |d2p| / (p- + 2 p + p+) of the three axes,
  // chosen by cross products, then one division
  float num = 0.0f, den = 1.0f;
  float rad[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float n = fabsf(pn[a][1] - 2.0f * c.p + pn[a][0]);
    const float dd = pn[a][1] + 2.0f * c.p + pn[a][0];
    if (a == 0 || n * den > num * dd) {
      num = n;
      den = dd;
    }

    const float* Slo = sE[a] + 3 * g.face(a, I, J, K);
    const float* Shi = sE[a] + 3 * g.face(a, I + e3[a][0], J + e3[a][1],
                                          K + e3[a][2]);
    const float sx = 0.5f * (Slo[0] + Shi[0]);
    const float sy = 0.5f * (Slo[1] + Shi[1]);
    const float sz = 0.5f * (Slo[2] + Shi[2]);
    rad[a] = fabsf(c.u * sx + c.v * sy + c.w * sz)
             + csound * sqrtf(sx * sx + sy * sy + sz * sz);
  }
  float sr[3];
  scaled_radii(rad, expo, sr);
  d[D_SENS * DPLANE] = num / den;
  d[D_SRI * DPLANE] = sr[0];
  d[D_SRJ * DPLANE] = sr[1];
  d[D_SRK * DPLANE] = sr[2];
}

// ---------------------------------------------------------------------------
// one face's flux
// ---------------------------------------------------------------------------
// Total flux (central - dissipation) of the face along axis a between ext
// cells L and R = L + e_a: the four cells LL, L, R, RR along a, the face
// vector S, its porosity and the derived fields of L and R (field f at
// dL[f * DPLANE], dR[f * DPLANE]).
__device__ __forceinline__ void face_flux(
    int a, const Cell& cLL, const Cell& cL, const Cell& cR, const Cell& cRR,
    const float* __restrict__ S, float por, const float* dL,
    const float* dR, float vis2, float vis4, float F[5]) {
  const float sx = S[0], sy = S[1], sz = S[2];

  // central flux; convection off at wall faces (por = 0)
  const float qL = (cL.u * sx + cL.v * sy + cL.w * sz) * por;
  const float qR = (cR.u * sx + cR.v * sy + cR.w * sz) * por;
  const float pa = 0.5f * (cL.p + cR.p);
  const float mL[3] = {cL.rho * cL.u, cL.rho * cL.v, cL.rho * cL.w};
  const float mR[3] = {cR.rho * cR.u, cR.rho * cR.v, cR.rho * cR.w};
  float central[5];
  central[0] = 0.5f * (cL.rho * qL + cR.rho * qR);
  central[1] = 0.5f * (mL[0] * qL + mR[0] * qR) + pa * sx;
  central[2] = 0.5f * (mL[1] * qL + mR[1] * qR) + pa * sy;
  central[3] = 0.5f * (mL[2] * qL + mR[2] * qR) + pa * sz;
  central[4] = 0.5f * (cL.e * qL + cR.e * qR);

  // JST dissipation on (rho, rho u, rho v, rho w, rhoE + p)
  const float lam = 0.5f * (dL[(D_SRI + a) * DPLANE]
                            + dR[(D_SRI + a) * DPLANE]);
  const float e2 = vis2 * fmaxf(dL[D_SENS * DPLANE], dR[D_SENS * DPLANE]);
  const float eps2 = e2 * por;
  const float eps4 = fmaxf(0.0f, vis4 - e2) * por;
  const float dLL[5] = {cLL.rho, cLL.rho * cLL.u, cLL.rho * cLL.v,
                        cLL.rho * cLL.w, cLL.e};
  const float dL5[5] = {cL.rho, mL[0], mL[1], mL[2], cL.e};
  const float dR5[5] = {cR.rho, mR[0], mR[1], mR[2], cR.e};
  const float dRR[5] = {cRR.rho, cRR.rho * cRR.u, cRR.rho * cRR.v,
                        cRR.rho * cRR.w, cRR.e};
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float d1 = dR5[c] - dL5[c];
    const float d3 = dRR[c] - 3.0f * dR5[c] + 3.0f * dL5[c] - dLL[c];
    F[c] = central[c] - lam * (eps2 * d1 - eps4 * d3);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT, MIN_BLOCKS) inviscid_residual_kernel(
    const float* __restrict__ W, const float* __restrict__ Pr,
    const float* __restrict__ siE, const float* __restrict__ sjE,
    const float* __restrict__ skE, const float* __restrict__ porI,
    const float* __restrict__ porJ, const float* __restrict__ porK,
    float* __restrict__ out, Grid g, int si, int wide, float vis2,
    float vis4, float expo) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);    // [RPLANE], cp.async
  float* cells = raw + RPLANE;                     // [CPLANES][N_CELL][NCELL]
  float* dsh = cells + CPLANES * N_CELL * NCELL;   // [2][N_DERIVED][DPLANE]
  float* fjb = dsh + 2 * N_DERIVED * DPLANE;       // [N_FACE][NFJ]
  float* fkb = fjb + N_FACE * NFJ;                 // [N_FACE][NFK]
  float* fib = fkb + N_FACE * NFK;                 // [N_FACE][NC] i-faces

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
  auto cell = [&](int p, int P) { return read_cell(cell_slot(p) + P); };
  auto pres = [&](int p, int P) { return cell_slot(p)[C_P * NCELL + P]; };

  // derived fields of padded plane p (ext plane p - 1) over the one-ring
  auto derived = [&](int p, int it) {
    const int jj = it / DK, kk = it - jj * DK;
    const int J = j0 + jj, K = k0 + kk;
    const bool corner = (jj == 0 || jj == TJ + 1) && (kk == 0 || kk == TK + 1);
    if (it < DPLANE && !corner && J <= g.nj + 1 && K <= g.nk + 1) {
      const int P = (jj + 1) * RK + kk + 1;
      const float pn[3][2] = {{pres(p - 1, P), pres(p + 1, P)},
                              {pres(p, P - RK), pres(p, P + RK)},
                              {pres(p, P - 1), pres(p, P + 1)}};
      derived_cell(cell(p, P), pn, siE, sjE, skE, g, p - 1, J, K, expo,
                   dslot(p) + it);
    }
  };

  // planes P0-2 .. P0+1 straight from device memory into their Cells
  for (int p = P0 - 2; p <= P0 + 1; ++p)
    for (int it = tid; it < NCELL; it += NT) {
      const int r = it / RK, c = it - r * RK;
      const int P = g.pad(p, min(j0 + r, g.nj + 3), min(k0 + c, g.nk + 3));
      store_cell(cell_slot(p) + it, make_cell(W + P * 5, Pr[P]));
    }
  __syncthreads();
  for (int it = tid; it < DPLANE; it += NT) derived(P0 - 1, it);   // warm-up
  if (tid >= NC) load_plane(raw, W, Pr, g, P0 + 2, j0, k0, wide);

  // this thread's column; its first thread computes the i-face and sums
  const int cid = tid % NC;
  const bool first = tid < NC;
  const int jl = cid / TK, kl = cid - jl * TK;
  const int j = j0 + jl, k = k0 + kl;
  const bool col = first && j < g.nj && k < g.nk;
  const int Pc = (jl + 2) * RK + kl + 2;     // its cell in a ring plane
  const int Dc = (jl + 1) * DK + kl + 1;     // its cell in a derived plane

  // step Q: derived fields of plane Q+1, the i-face between Q and Q+1 and,
  // from Q = P0 on, the residual of interior plane Q
  for (int Q = P0 - 1; Q <= PE; ++Q) {
    __syncthreads();               // plane Q+2's Cells are in their slot

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
      float F[5];
      face_flux(jf ? 1 : 2, cell(Q, P), cell(Q, P + step),
                cell(Q, P + 2 * step), cell(Q, P + 3 * step),
                jf ? sjE + 3 * g.face(1, Q - 1, JR, KR)
                   : skE + 3 * g.face(2, Q - 1, JR, KR),
                jf ? porJ[g.por(1, Q - 1, JR, KR)]
                   : porK[g.por(2, Q - 1, JR, KR)],
                dL, dL + (jf ? DK : 1), vis2, vis4, F);
      float* fb5 = (jf ? fjb : fkb) + fb;
      const int n = jf ? NFJ : NFK;
#pragma unroll
      for (int c = 0; c < 5; ++c) fb5[c * n] = F[c];
    }
    __syncthreads();

    // the second threads: plane Q+3 from the raw plane into plane Q-2's
    // slot, which is free, then plane Q+4 into the raw plane
    if (!first) {
      if (Q < PE) {
        cp_async_wait_all();
        asm volatile("bar.sync 1, %0;" :: "n"(NC));
        for (int it = tid - NC; it < NCELL; it += NC)
          store_cell(cell_slot(Q + 3) + it,
                     make_cell(raw + 5 * it, raw[NCELL * 5 + it]));
        asm volatile("bar.sync 1, %0;" :: "n"(NC));
      }
      if (Q + 1 < PE) load_plane(raw, W, Pr, g, Q + 4, j0, k0, wide);
      continue;
    }
    // the i-face between ext (Q-1, j+1, k+1) and (Q, j+1, k+1), then the
    // sums of the column's cell of plane Q
    if (!col) continue;
    const int J = j + 1, K = k + 1;
    float hi[5];
    face_flux(0, cell(Q - 1, Pc), cell(Q, Pc), cell(Q + 1, Pc),
              cell(Q + 2, Pc), siE + 3 * g.face(0, Q, J, K),
              porI[g.por(0, Q, J, K)], d0 + Dc, dslot(Q + 1) + Dc, vis2,
              vis4, hi);
    // the i-face below plane Q, kept in shared memory from the last step
    float* lo = fib + cid;
    if (Q >= P0) {
      const int fj = jl * TK + kl, fk = jl * (TK + 1) + kl;
      float* o = out + (((Q - 2) * g.nj + j) * g.nk + k) * 5;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        float R = 0.0f;
        R += hi[c] - lo[c * NC];
        R += fjb[c * NFJ + fj + TK] - fjb[c * NFJ + fj];
        R += fkb[c * NFK + fk + 1] - fkb[c * NFK + fk];
        o[c] = R;
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) lo[c * NC] = hi[c];
  }
}

}  // namespace

// Launch the kernel on ``stream`` with the tile plan of
// adflow_torch/ops/cuda_inviscid.py::k2_tile_plan: its tile (tj x tk),
// threads and dynamic shared bytes must be this source's; the segment si and
// the copy width (4 or 16 bytes) are the plan's. Returns cudaGetLastError()
// (0 = ok).
extern "C" int inviscid_residual_launch(
    const float* w5, const float* p, const float* siE, const float* sjE,
    const float* skE, const float* porI, const float* porJ, const float* porK,
    float* out, int ni, int nj, int nk, int tj, int tk, int threads, int si,
    int copy_width, int smem_bytes, float vis2, float vis4, float expo,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{ni, nj, nk};
  constexpr int bytes = SMEM_FLOATS * 4;
  if (tj != TJ || tk != TK || threads != NT || smem_bytes != bytes ||
      si < 1 || (copy_width != 4 && copy_width != 16) ||
      5LL * (ni + 4) * (nj + 4) * (nk + 4) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inviscid_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nk + TK - 1) / TK, (nj + TJ - 1) / TJ, (ni + si - 1) / si);
  inviscid_residual_kernel<<<grid, NT, bytes, s>>>(
      w5, p, siE, sjE, skE, porI, porJ, porK, out, g, si, copy_width == 16,
      vis2, vis4, expo);
  return (int)cudaGetLastError();
}
