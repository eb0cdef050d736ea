// Implicit residual smoothing (residual averaging) of one block along one
// axis: x = (I - eps d^2)^-1 r on every grid line of that axis, all nv
// channels, the line's ends with diagonal 1 + eps and no coupling past them
// (reference residualAveraging, residuals.F90:1785).
//
// Replaces no TPU kernel: the JAX package runs the smoothing as a Thomas
// recurrence in lax.scan (adflow_tpu/solvers/smoothers.py), and the port's
// plain version (adflow_torch/solvers/smoothers.py::residual_averaging)
// runs it as 2 (n - 1) multiply-adds over whole planes an axis, 762
// launches an RK stage on the 256x64x64 wing. The multigrid smoother applies
// it at every RK stage of every level, so it was the longest chain of small
// launches of a W-cycle after the residuals.
//
// The system's coefficients are the same on every line, so the forward
// elimination's factors (g, denom, cp) of length n are computed once on the
// host in float64, rounded to float32 and kept on the card
// (ops/cuda_irs.py); this kernel runs the two sweeps the plain version runs
// with them:
//   forward   x_0 = r_0 / denom_0,  x_m = r_m / denom_m - g_m x_{m-1}
//   backward  x_m = x_m - cp_m x_{m+1}
// Layout: channels last, (n0, n1, n2, nv) row-major; a line of axis a is the
// cells that differ only in index a, ``inner`` = the product of the dims
// after a apart, so line L starts at ((L / inner) n inner + L % inner) nv.
//
// Bound on an H100: device-memory bytes. One launch must read r and write x
// once, 8 nv bytes a cell: 50.3 MB on the 256x64x64 block with nv 6, 15 us
// at 3.35 TB/s, against 5 operations a cell and channel.
//
// Design: one thread a line, all nv channels (NV a template argument, so
// the line's running values live in registers), in and out distinct. The
// forward sweep writes x, the backward sweep reads it back from the same
// thread's writes. Neighbouring threads take neighbouring lines; along
// axis 0 and 1 they read neighbouring cells, along axis 2 each thread walks
// a contiguous row. Every cell's arithmetic is the plain version's, in the
// same order, so the result differs from it by rounding only.
//
// Every constant is a float literal and only float math is used. Build
// without --use_fast_math (the division is IEEE).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <int NV>
__global__ void __launch_bounds__(THREADS) irs_line_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const float* __restrict__ fac, int n, int inner, int n_lines) {
  const int line = blockIdx.x * THREADS + threadIdx.x;
  if (line >= n_lines) return;
  const long long stride = (long long)inner * NV;
  const long long base =
      ((long long)(line / inner) * n * inner + line % inner) * NV;
  const float* g = fac;
  const float* den = fac + n;
  const float* cp = fac + 2 * n;

  float x[NV];
  {
    const float d = den[0];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      x[c] = in[base + c] / d;
      out[base + c] = x[c];
    }
  }
  for (int m = 1; m < n; ++m) {
    const long long o = base + m * stride;
    const float d = den[m], gm = g[m];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      x[c] = in[o + c] / d - gm * x[c];
      out[o + c] = x[c];
    }
  }
  for (int m = n - 2; m >= 0; --m) {
    const long long o = base + m * stride;
    const float cm = cp[m];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      x[c] = out[o + c] - cm * x[c];
      out[o + c] = x[c];
    }
  }
}

template <int NV>
int launch(const float* in, float* out, const float* fac, int n, int inner,
           int n_lines, cudaStream_t s) {
  const int blocks = (n_lines + THREADS - 1) / THREADS;
  irs_line_kernel<NV><<<blocks, THREADS, 0, s>>>(in, out, fac, n, inner,
                                                  n_lines);
  return (int)cudaGetLastError();
}

}  // namespace

// Smooth the (n0, n1, n2, nv) float32 block ``in`` along the axis whose
// length is ``n`` and whose later dims multiply to ``inner`` into ``out``
// (distinct from ``in``), with the (3, n) factors ``fac`` (g, denom, cp),
// on ``stream``: ``n_lines`` = n0 n1 n2 / n lines, one thread each,
// ``threads`` a block (this source's THREADS). nv is 5, 6 or 7. Returns
// cudaGetLastError() (0 = ok).
extern "C" int irs_axis_launch(const float* in, float* out, const float* fac,
                               int n, int inner, int n_lines, int nv,
                               int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads != THREADS || n < 1 || inner < 1 || n_lines < 1)
    return (int)cudaErrorInvalidValue;
  switch (nv) {
    case 5: return launch<5>(in, out, fac, n, inner, n_lines, s);
    case 6: return launch<6>(in, out, fac, n, inner, n_lines, s);
    case 7: return launch<7>(in, out, fac, n, inner, n_lines, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
