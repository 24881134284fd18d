// J-DOB's (partition x edge-frequency) energy grid (paper Alg. 2) for
// Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/jdob_sweep.py:64
// (jdob_sweep_kernel; its body _kernel at :27).  Per grid cell (nt, f):
// greedy batching membership th <= f, batch size B_o and tightest deadline
// l_o over the members, the Eq. 6 GPU-availability check, the Eqs. 19-20
// device DVFS clip, the Eq. 21 energy, +inf where infeasible.
//
// Design.  One thread block per partition row nt, one thread per sweep
// frequency, and a loop over the M users (sorted per row by the host, as
// Alg. 1 line 5 sorts them).  Each operation is an explicitly rounded
// float32 intrinsic and the row sum runs in user order, so the kernel is
// bitwise equal to its plain PyTorch version (kernels/jdob_sweep.py) and
// reproducible run to run; the file is also built with -fmad=false so no
// multiply-add is contracted behind the intrinsics' back.
//
// What bounds it.  The grid is (N+1) x K cells of O(M) work: at the
// serving shape (41 x 65 cells, M <= 6 users) it reads ~30 KB and does
// ~0.1 MFLOP, far below what bytes or FLOPs would take on this card — a
// call costs the launch.  Keeping the whole Alg. 2 sweep in one launch
// (instead of the plain version's many small elementwise ops) is what the
// design does about that.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void jdob_sweep(const float* __restrict__ th,
                           const float* __restrict__ sufft,
                           const float* __restrict__ our,
                           const float* __restrict__ eup,
                           const float* __restrict__ eloc,
                           const float* __restrict__ zeta,
                           const float* __restrict__ ku,
                           const float* __restrict__ fmin,
                           const float* __restrict__ fmax,
                           const float* __restrict__ scal,
                           const float* __restrict__ fsweep,
                           float* __restrict__ out, int m, int kdim) {
  const int nt = blockIdx.x;
  const size_t row = (size_t)nt * m;
  const float* s = scal + (size_t)nt * 8;
  const float phi_b = s[0], phi_s = s[1], psi_b = s[2], psi_s = s[3];
  const float v_nt = s[4], u_nt = s[5], t_free = s[6];
  const float dev_tol = 1.0f + 1e-9f;   // == 1.0f in float32, as the reference
  for (int kk = threadIdx.x; kk < kdim; kk += blockDim.x) {
    const float f = fsweep[(size_t)nt * kdim + kk];
    // greedy batching set under f (Alg. 2 lines 7-12)
    float b_o = 0.f;
    float l_o = INFINITY;
    for (int u = 0; u < m; ++u) {
      if (th[row + u] <= f) {
        b_o = __fadd_rn(b_o, 1.f);
        l_o = fminf(l_o, sufft[row + u]);
      }
    }
    const bool has = b_o > 0.f;
    const float phi = __fadd_rn(phi_b, __fmul_rn(phi_s, b_o));
    const float psi = __fadd_rn(psi_b, __fmul_rn(psi_s, b_o));
    const bool gpu_ok = __fmul_rn(f, __fsub_rn(l_o, t_free)) >= phi;  // Eq. 6
    const float phi_f = __fdiv_rn(phi, f);
    bool dev_ok = true;
    float acc = 0.f;
    for (int u = 0; u < m; ++u) {
      const size_t i = row + u;
      float e;
      if (th[i] <= f) {
        const float slack = __fsub_rn(__fsub_rn(l_o, our[i]), phi_f);
        const float g_off =
            slack > 0.f
                ? __fdiv_rn(__fmul_rn(zeta[i], v_nt), fmaxf(slack, 1e-30f))
                : INFINITY;                                        // Eq. 19
        const float fd = fminf(fmaxf(g_off, fmin[i]), fmax[i]);    // Eq. 20
        if (!(g_off <= __fmul_rn(fmax[i], dev_tol))) dev_ok = false;
        e = __fadd_rn(__fmul_rn(__fmul_rn(ku[i], u_nt), __fmul_rn(fd, fd)),
                      eup[i]);                                     // Eq. 21
      } else {
        e = eloc[i];
      }
      acc = __fadd_rn(acc, e);
    }
    const float energy =
        __fadd_rn(acc, has ? __fmul_rn(psi, __fmul_rn(f, f)) : 0.f);
    out[(size_t)nt * kdim + kk] = (has && gpu_ok && dev_ok) ? energy : INFINITY;
  }
}

}  // namespace

extern "C" int jdob_sweep_f32(const void* th, const void* sufft,
                              const void* our, const void* eup,
                              const void* eloc, const void* zeta,
                              const void* ku, const void* fmin,
                              const void* fmax, const void* scal,
                              const void* fsweep, void* out, int np, int m,
                              int kdim, void* stream) {
  if (np < 1 || m < 1 || kdim < 1) return (int)cudaErrorInvalidValue;
  const int threads = kdim >= 128 ? 128 : ((kdim + 31) / 32) * 32;
  jdob_sweep<<<np, threads, 0, (cudaStream_t)stream>>>(
      (const float*)th, (const float*)sufft, (const float*)our,
      (const float*)eup, (const float*)eloc, (const float*)zeta,
      (const float*)ku, (const float*)fmin, (const float*)fmax,
      (const float*)scal, (const float*)fsweep, (float*)out, m, kdim);
  return (int)cudaGetLastError();
}
