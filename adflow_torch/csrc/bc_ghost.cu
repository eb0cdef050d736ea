// The physical-BC ghost fill of one subface: both halo layers of every
// cell of the subface's extended tangential extent, all nw channels, in one
// launch; and, from the same source, its tangent.
//
// Replaces no TPU kernel: the JAX package writes its BCs as plain jnp
// (adflow_tpu/physics/bc.py, no Pallas kernel). It was added because the
// port's plain pass (adflow_torch/physics/bc.py, the per-op loop kept as
// adflow_torch/ops/cuda_bc.py::bc_pass_reference) runs a chain of 10-60
// small elementwise launches a ghost layer, each op's normals and edge pads
// rebuilt with index tensors copied to the card from pageable memory, and
// under torch.func.jvp every op of that chain again on dual tensors: the
// BC passes set the pace of the RK cycle and of the ANK jvp matvec on a card
// that idles under them.
//
// It computes, formula for formula, the branches of bc.py _ghost_state
// that take this kernel (ops/cuda_bc.py KINDS):
//   K_REFLECT   SYMMETRY, SYMMETRY_POLAR, static EULER_WALL: the momentum
//               mirrored about the unit outward normal, the rest copied
//   K_NS_WALL   static NS_WALL_ADIABATIC without wall functions: momentum
//               and turbulence negated, rho and rhoE copied
//   K_FARFIELD  _farfield_state: Riemann invariants, the supersonic
//               overrides, c_b clamped at 1e-6, the tanh blend of width
//               0.01 c_b between the interior's and the free stream's
//               entropy, tangential velocity and turbulence
//   K_COPY      SUPERSONIC_OUTFLOW, EXTRAPOLATE: the mirror cell
// The unit outward normal is sign * s at the face, over max(|s|, 1e-30);
// the tangential edge pad of the plain pass (bc.py _edge_pad2) is the
// tangential index clamped into the subface's face range. No index or
// normal array is made on the host.
//
// Layout: the padded state w (N1, N2, N3, nw), channels last, contiguous;
// the face-area array of the op's axis (si (ni+1, nj, nk, 3), sj, sk), one
// face plane of it passed as a base pointer and its strides. Offsets are
// 64-bit.
//
// Work split: one launch a subface; one thread a tangential cell of the
// extended extent, which reads its two mirror cells and writes its two
// ghost cells, all channels. Ops run in order on the stream, so a later
// subface's extended extent reads the ghosts an earlier one wrote (the
// plain pass's corner semantics). Within one launch no thread reads what
// another writes: the ghost layers of an op are never its mirror layers.
//
// Forward and tangent from one source: the ghost map is written once,
// templated on its scalar: float for the forward, Dual {v, t} for the
// tangent, whose +, -, *, /, sqrt, tanh, pow, clamp and selection carry
// the derivative as torch's forward-mode rules do. The tangent launch reads
// the primal and the tangent of the mirror cells and of the free stream,
// recomputes the primal ghost in registers, writes the tangent, and writes
// the primal ghost into the primal copy it walks, so that later ops of the
// same pass read the state the forward pass read.
//
// Bound on an H100: device-memory bytes, and mostly not of this kernel: the
// pass clones the padded block first, 2 x 24-29 MB at 256x64x64 (nw 5 to
// 6), about 15-18 us at 3.35 TB/s, which is the least the pass must move.
// The kernel writes 2 ghost layers of 260 x 68 cells on each of the wing's
// four subfaces, 141,440 cells or 2.8 MB at nw 5, and reads as many mirror
// cells: another 12% of the clone's bytes. The design moves just those: one
// pass of the extended extent, no shared memory, no scratch.
//
// Every constant is a float literal and only float math functions are used,
// so nothing runs in double. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int H = 2;              // halo depth
constexpr int NW_MAX = 8;         // channels a cell at most
constexpr int THREADS = 128;      // threads a block
constexpr float GAMMA = 1.4f;
constexpr float GM1 = 0.4f;       // GAMMA - 1
constexpr float INV_GM1 = 2.5f;   // 1 / (GAMMA - 1), as float32 rounds it
constexpr float BLEND = 0.01f;    // bc.py FARFIELD_BLEND_WIDTH

enum Kind { K_REFLECT = 0, K_NS_WALL = 1, K_FARFIELD = 2, K_COPY = 3 };

// A value and its tangent. A float converts to a constant (tangent 0).
struct Dual {
  float v, t;
  __device__ Dual() {}
  __device__ Dual(float v_, float t_ = 0.0f) : v(v_), t(t_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual(a.v + b.v, a.t + b.t);
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual(a.v - b.v, a.t - b.t);
}
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.t); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.t * b.v + a.v * b.t);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.t - q * b.t) / b.v);
}

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ float val(Dual a) { return a.v; }

__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual sqrt_(Dual a) {
  const float s = sqrtf(a.v);
  return Dual(s, a.t / (2.0f * s));
}
__device__ __forceinline__ float tanh_(float a) { return tanhf(a); }
__device__ __forceinline__ Dual tanh_(Dual a) {
  const float y = tanhf(a.v);
  return Dual(y, a.t * (1.0f - y * y));
}
// a^e for a constant exponent e
__device__ __forceinline__ float pow_(float a, float e) { return powf(a, e); }
__device__ __forceinline__ Dual pow_(Dual a, float e) {
  return Dual(powf(a.v, e), a.t * (e * powf(a.v, e - 1.0f)));
}
// torch.clamp(a, min=lo): the tangent passes where a >= lo
__device__ __forceinline__ float clamp_lo(float a, float lo) {
  return a >= lo ? a : lo;
}
__device__ __forceinline__ Dual clamp_lo(Dual a, float lo) {
  return a.v >= lo ? a : Dual(lo);
}

__device__ __forceinline__ void load(float& x, const float* w, const float*,
                                     long long off) {
  x = w[off];
}
__device__ __forceinline__ void load(Dual& x, const float* w, const float* dw,
                                     long long off) {
  x = Dual(w[off], dw[off]);
}
__device__ __forceinline__ void store(float x, float* w, float*,
                                      long long off) {
  w[off] = x;
}
__device__ __forceinline__ void store(Dual x, float* w, float* dw,
                                      long long off) {
  w[off] = x.v;
  dw[off] = x.t;
}

// the free stream, with its tangent where one is given
__device__ __forceinline__ float load_inf(const float* winf, const float*,
                                          int c, float) {
  return winf[c];
}
__device__ __forceinline__ Dual load_inf(const float* winf,
                                         const float* dwinf, int c, Dual) {
  return Dual(winf[c], dwinf != nullptr ? dwinf[c] : 0.0f);
}

// thermo.py pressure: (gamma - 1) (rhoE - 0.5 |m|^2 / rho)
template <class T>
__device__ __forceinline__ T pressure(const T* w) {
  const T ke = 0.5f * (w[1] * w[1] + w[2] * w[2] + w[3] * w[3]) / w[0];
  return GM1 * (w[4] - ke);
}

// bc.py _farfield_state
template <class T>
__device__ __forceinline__ void farfield(int nw, const T* wi, const float* n,
                                         const T* wf, T* out) {
  const T rho_i = wi[0];
  T v_i[3], v_f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) v_i[a] = wi[1 + a] / rho_i;
  const T p_i = pressure(wi);
  const T c_i = sqrt_(GAMMA * p_i / rho_i);
  const T un_i = v_i[0] * n[0] + v_i[1] * n[1] + v_i[2] * n[2];

  const T rho_f = wf[0];
#pragma unroll
  for (int a = 0; a < 3; ++a) v_f[a] = wf[1 + a] / rho_f;
  const T p_f = pressure(wf);
  const T c_f = sqrt_(GAMMA * p_f / rho_f);
  const T un_f = v_f[0] * n[0] + v_f[1] * n[1] + v_f[2] * n[2];

  T rplus = un_i + 2.0f * c_i / GM1;     // leaves through the boundary
  T rminus = un_f - 2.0f * c_f / GM1;    // enters from outside
  // supersonic overrides
  if (val(un_i) < -val(c_i)) rplus = un_f + 2.0f * c_f / GM1;
  if (val(un_i) > val(c_i)) rminus = un_i - 2.0f * c_i / GM1;

  const T un_b = 0.5f * (rplus + rminus);
  const T c_b = clamp_lo(0.25f * GM1 * (rplus - rminus), 1e-6f);

  // smooth inflow/outflow blend over a few percent of the sound speed
  const T sig = 0.5f * (1.0f + tanh_(un_b / (BLEND * c_b)));
  const T s_up = sig * (p_i / pow_(rho_i, GAMMA))
                 + (1.0f - sig) * (p_f / pow_(rho_f, GAMMA));
  T v_b[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T vt_i = v_i[a] - un_i * n[a];
    const T vt_f = v_f[a] - un_f * n[a];
    v_b[a] = sig * vt_i + (1.0f - sig) * vt_f + un_b * n[a];
  }
  const T c_b2 = c_b * c_b;
  const T rho_b = pow_(c_b2 / (GAMMA * s_up), INV_GM1);
  const T p_b = rho_b * c_b2 / GAMMA;
  out[0] = rho_b;
#pragma unroll
  for (int a = 0; a < 3; ++a) out[1 + a] = rho_b * v_b[a];
  out[4] = p_b / GM1
           + 0.5f * rho_b * (v_b[0] * v_b[0] + v_b[1] * v_b[1]
                             + v_b[2] * v_b[2]);
#pragma unroll
  for (int c = 5; c < NW_MAX; ++c)
    if (c < nw) out[c] = sig * wi[c] + (1.0f - sig) * wf[c];
}

// bc.py _ghost_state for the kernel's kinds: the ghost of mirror cell wi
template <class T>
__device__ __forceinline__ void ghost_state(int kind, int nw, const T* wi,
                                            const float* n, const T* wf,
                                            T* out) {
#pragma unroll
  for (int c = 0; c < NW_MAX; ++c)
    if (c < nw) out[c] = wi[c];
  if (kind == K_REFLECT) {
    const T mn2 = 2.0f * (wi[1] * n[0] + wi[2] * n[1] + wi[3] * n[2]);
#pragma unroll
    for (int a = 0; a < 3; ++a) out[1 + a] = wi[1 + a] - mn2 * n[a];
  } else if (kind == K_NS_WALL) {
#pragma unroll
    for (int a = 0; a < 3; ++a) out[1 + a] = -wi[1 + a];
#pragma unroll
    for (int c = 5; c < NW_MAX; ++c)
      if (c < nw) out[c] = -wi[c];
  } else if (kind == K_FARFIELD) {
    farfield(nw, wi, n, wf, out);
  }
}

// One subface: where its layers lie in w and its faces in s.
struct Op {
  long long sn, s1, s2;   // w's strides (floats): normal, tangential axes
  long long f1, f2, fc;   // the face plane's strides: tangential, component
  int g0, g1, m0, m1;     // ghost and mirror layers along the normal
  int lo1, n1, lo2, n2;   // extended tangential extent (padded indices)
  int a0, a1, b0, b1;     // the subface's face range (interior indices)
  float sign;             // +1 where the stored normal points outward
  int kind, nw;
};

template <class T>
__global__ void __launch_bounds__(THREADS)
    bc_ghost_kernel(float* w, float* dw, const float* s, const float* winf,
                    const float* dwinf, Op op) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)op.n1 * op.n2) return;
  const int p1 = op.lo1 + (int)(idx / op.n2);
  const int p2 = op.lo2 + (int)(idx % op.n2);

  // unit outward normal at the face under the (edge-padded) cell
  const int e1 = min(max(p1 - H, op.a0), op.a1 - 1);
  const int e2 = min(max(p2 - H, op.b0), op.b1 - 1);
  const float* sf = s + e1 * op.f1 + e2 * op.f2;
  float n[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) n[a] = op.sign * sf[a * op.fc];
  const float mag = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]),
                          1e-30f);
#pragma unroll
  for (int a = 0; a < 3; ++a) n[a] = n[a] / mag;

  T wf[NW_MAX];
#pragma unroll
  for (int c = 0; c < NW_MAX; ++c)
    if (c < op.nw) wf[c] = load_inf(winf, dwinf, c, T());

  const long long col = p1 * op.s1 + p2 * op.s2;
#pragma unroll
  for (int d = 0; d < H; ++d) {
    const long long mo = col + (d == 0 ? op.m0 : op.m1) * op.sn;
    const long long go = col + (d == 0 ? op.g0 : op.g1) * op.sn;
    T wi[NW_MAX], out[NW_MAX];
#pragma unroll
    for (int c = 0; c < NW_MAX; ++c)
      if (c < op.nw) load(wi[c], w, dw, mo + c);
    ghost_state(op.kind, op.nw, wi, n, wf, out);
#pragma unroll
    for (int c = 0; c < NW_MAX; ++c)
      if (c < op.nw) store(out[c], w, dw, go + c);
  }
}

}  // namespace

// One op of the pass on stream `stream`, in place in w: the forward where
// dw is null, else the tangent (w the primal copy the pass walks, dw the
// tangent's; dwinf may be null). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an op the kernel does not take.
extern "C" int bc_ghost_launch(
    float* w, float* dw, const float* s, const float* winf,
    const float* dwinf, long long sn, long long s1, long long s2,
    long long f1, long long f2, long long fc, int g0, int g1, int m0, int m1,
    int lo1, int n1, int lo2, int n2, int a0, int a1, int b0, int b1,
    float sign, int kind, int nw, void* stream) {
  if (nw < 5 || nw > NW_MAX || kind < K_REFLECT || kind > K_COPY || n1 < 1 ||
      n2 < 1 || a1 <= a0 || b1 <= b0)
    return (int)cudaErrorInvalidValue;
  const Op op{sn, s1, s2, f1, f2, fc, g0, g1, m0, m1, lo1, n1, lo2, n2,
              a0, a1, b0, b1, sign, kind, nw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)n1 * n2;
  const unsigned blocks = (unsigned)((cells + THREADS - 1) / THREADS);
  if (dw == nullptr)
    bc_ghost_kernel<float><<<blocks, THREADS, 0, st>>>(w, nullptr, s, winf,
                                                       nullptr, op);
  else
    bc_ghost_kernel<Dual><<<blocks, THREADS, 0, st>>>(w, dw, s, winf, dwinf,
                                                      op);
  return (int)cudaGetLastError();
}
