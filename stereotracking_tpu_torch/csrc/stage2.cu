// Fused backbone stage: 3x3 stride-2 entry conv + CSP chain, one launch.
//
// Replaces: stereotracking_tpu/ops/stage2_pallas.py, stage2_fold_pallas /
// _stage2_kernel (reached through pallas_stage2_out).  Generic over
// (C_in, C_out, num_blocks) as long as its shared memory fits: the
// flagship's stage 2 is (64, 128, 3).  Stage 3 (128, 256, 3) does not fit
// a 16 x 16 region and has its own two-launch kernel (stage3.cu).
//
// What it computes: see csp_chain.cuh.  Input (S, hin, win, C_in) bf16
// NHWC, output (S, hin/2, win/2, C_out) bf16 NHWC; one launch covers the S
// streams (grid z).
//
// What bounds it on an H100: the TPU kernel existed because XLA sent each of
// the chain's eleven intermediates through device memory (8.4 MB each per
// 1088x1920 frame); fused, the stage reads 16.7 MB and writes 8.4 MB.  Its
// 15 GFLOP per frame (about 39 GFLOP with the halo recompute) then bound
// it.  Design: one block per 16 x 16 region = a 10 x 10 output tile plus
// the 3 rings the bottlenecks consume, recomputed per tile instead of being
// exchanged; every convolution is a bf16 tensor-core GEMM (wmma) with
// float32 accumulation from shared memory; the 33 x 33 x 64 input patch
// (139 KB) and z (64 KB) fill 213 KB of shared memory, so one block runs
// per SM.  One launch holds the whole chain: nothing but the input, the
// weights and the output touches device memory.
#include "csp_chain.cuh"

namespace {

using namespace st_chain;

constexpr int GH = 16;

__global__ void __launch_bounds__(THREADS)
stage_csp_kernel(const bf16* __restrict__ x, int hin, int win, StageDims d,
                 const bf16* __restrict__ weights,
                 const float* __restrict__ sb, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hout = hin / 2, wout = win / 2;
  const int e = d.nb, th = GH - 2 * e, tw = GW - 2 * e;
  const Layout L = layout<GH>(d, 0);
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * tw;
  x += (size_t)blockIdx.z * hin * win * d.cin;
  out += (size_t)blockIdx.z * hout * wout * d.cout;
  bf16* result = reinterpret_cast<bf16*>(smem + L.z);
  region_chain<GH, WMMA>(x, hin, win, hout, wout, d,
                         weight_ptrs(weights, sb, d), oy0 - e, ox0 - e, smem,
                         L, result);
  store_tile(result, e, th, tw, d.cout, oy0, ox0, hout, wout, out);
}

}  // namespace

// x: (n, h, w, cin); out: (n, h/2, w/2, cout)
ST_EXPORT int st_stage_csp(const void* x, int n, int h, int w, int cin,
                           int cout, int mid, int nb, const void* weights,
                           const void* sb, void* out, void* stream) {
  const StageDims d{cin, cout, mid, nb};
  if (cin % 16 || cout % 16 || mid % 16 || nb < 1 || 2 * nb >= GH || n < 1)
    return cudaErrorInvalidValue;
  const size_t bytes = layout<GH>(d, 0).total;
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage_csp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int hout = h / 2, wout = w / 2, th = GH - 2 * nb, tw = GW - 2 * nb;
  dim3 grid((wout + tw - 1) / tw, (hout + th - 1) / th, n);
  stage_csp_kernel<<<grid, THREADS, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), h, w, d, static_cast<const bf16*>(weights),
      static_cast<const float*>(sb), static_cast<bf16*>(out));
  return cudaGetLastError();
}
