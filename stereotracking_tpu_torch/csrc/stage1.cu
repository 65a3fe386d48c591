// Fused dual stage 1: both branches' stage-1 chains and their average.
//
// Replaces: stereotracking_tpu/ops/stage1_pallas.py, stage1_dual_pallas /
// _stage1_kernel (reached through pallas_stage1_out).
//
// What it computes: for the RGB and the disparity stem activations
// (hin, win, C) bf16, the stage chain of csp_chain.cuh with ONE bottleneck
// (C = 32 -> O = 64 in the flagship), then out = bf16((rgb + disp) * 0.5),
// (hin/2, win/2, O) bf16 NHWC.
//
// What bounds it on an H100: fused, it reads the two stems (2 x 33 MB at
// 1088x1920) and writes 16.7 MB; every intermediate stays on chip.  Its
// 19 GFLOP per frame (about 25 GFLOP with the halo recompute) then bound
// it.  Design: one block per 16 x 16 region = a 14 x 14 output tile plus the
// one ring the bottleneck consumes, recomputed per tile; every convolution
// is a bf16 tensor-core GEMM (wmma) with float32 accumulation from shared
// memory; the RGB branch's region result (32 KB) waits in shared memory
// while the disparity branch reuses the chain buffers, so it never goes to
// device memory before the average.  143 KB of shared memory per block.
#include "csp_chain.cuh"

namespace {

using namespace st_chain;

__global__ void __launch_bounds__(THREADS)
stage1_dual_kernel(const bf16* __restrict__ x_rgb,
                   const bf16* __restrict__ x_disp, int hin, int win,
                   StageDims d, const bf16* __restrict__ w_rgb,
                   const float* __restrict__ sb_rgb,
                   const bf16* __restrict__ w_disp,
                   const float* __restrict__ sb_disp,
                   bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hout = hin / 2, wout = win / 2;
  const int e = d.nb, th = GH - 2 * e, tw = GW - 2 * e;
  const Layout L = layout(d, (size_t)P * d.cout * sizeof(bf16));
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * tw;
  bf16* rgb = reinterpret_cast<bf16*>(smem + L.extra);
  bf16* dsp = reinterpret_cast<bf16*>(smem + L.z);
  region_chain(x_rgb, hin, win, hout, wout, d, weight_ptrs(w_rgb, sb_rgb, d),
               oy0 - e, ox0 - e, smem, L, rgb);
  region_chain(x_disp, hin, win, hout, wout, d,
               weight_ptrs(w_disp, sb_disp, d), oy0 - e, ox0 - e, smem, L,
               dsp);
  for (int i = threadIdx.x; i < th * tw * d.cout; i += THREADS) {
    const int o = i % d.cout, p = i / d.cout;
    const int ty = p / tw, tx = p % tw;
    const int y = oy0 + ty, xx = ox0 + tx;
    if (y < hout && xx < wout) {
      const int q = ((ty + e) * GW + tx + e) * d.cout + o;
      const float v = (st_f(rgb[q]) + st_f(dsp[q])) * 0.5f;
      out[((size_t)y * wout + xx) * d.cout + o] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

ST_EXPORT int st_stage1_dual(const void* x_rgb, const void* x_disp, int h,
                             int w, int cin, int cout, int mid, int nb,
                             const void* w_rgb, const void* sb_rgb,
                             const void* w_disp, const void* sb_disp,
                             void* out, void* stream) {
  const StageDims d{cin, cout, mid, nb};
  if (cin % 16 || cout % 16 || mid % 16 || nb < 1 || 2 * nb >= GH)
    return cudaErrorInvalidValue;
  const size_t bytes = layout(d, (size_t)P * cout * sizeof(bf16)).total;
  cudaError_t err = cudaFuncSetAttribute(
      stage1_dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int hout = h / 2, wout = w / 2, th = GH - 2 * nb, tw = GW - 2 * nb;
  dim3 grid((wout + tw - 1) / tw, (hout + th - 1) / th);
  stage1_dual_kernel<<<grid, THREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x_rgb), static_cast<const bf16*>(x_disp), h,
      w, d, static_cast<const bf16*>(w_rgb), static_cast<const float*>(sb_rgb),
      static_cast<const bf16*>(w_disp), static_cast<const float*>(sb_disp),
      static_cast<bf16*>(out));
  return cudaGetLastError();
}
