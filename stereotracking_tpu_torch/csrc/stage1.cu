// Fused dual stage 1: both branches' stage-1 chains and their average.
//
// Replaces: stereotracking_tpu/ops/stage1_pallas.py, stage1_dual_pallas /
// _stage1_kernel (reached through pallas_stage1_out), and the A/B variants
// of tools/probe_stage1_variants.py (make_variant(...).run).
//
// What it computes: for the RGB and the disparity stem activations
// (S, hin, win, C) bf16, the stage chain of csp_chain.cuh with ONE
// bottleneck (C = 32 -> O = 64 in the flagship), then out = bf16((rgb +
// disp) * 0.5), (S, hin/2, win/2, O) bf16 NHWC.  One launch covers the S
// streams (grid z).
//
// What bounds it on an H100: fused, it reads the two stems (2 x 33 MB per
// 1088x1920 frame) and writes 16.7 MB; every intermediate stays on chip.
// Its 19 GFLOP per frame (about 25 GFLOP with the halo recompute) then
// bound it.  Design: one block per 16 x 16 region = a 14 x 14 output tile
// plus the one ring the bottleneck consumes, recomputed per tile; every
// convolution is a bf16 tensor-core GEMM (wmma) with float32 accumulation
// from shared memory; the RGB branch's region result (32 KB) waits in
// shared memory while the disparity branch reuses the chain buffers, so it
// never goes to device memory before the average.  143 KB of shared memory
// per block.
//
// Variants (the card's counterpart of the TPU probe's layout variants):
// the region height (16 or 8 rows) and the GEMM inner loop (wmma or scalar
// float32 FMA), four instantiations of this one kernel; variant 0 is the
// production kernel.
#include "csp_chain.cuh"

namespace {

using namespace st_chain;

template <int GH, int INNER>
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
  const Layout L = layout<GH>(d, (size_t)Geom<GH>::P * d.cout * sizeof(bf16));
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * tw;
  const size_t in_off = (size_t)blockIdx.z * hin * win * d.cin;
  out += (size_t)blockIdx.z * hout * wout * d.cout;
  bf16* rgb = reinterpret_cast<bf16*>(smem + L.extra);
  bf16* dsp = reinterpret_cast<bf16*>(smem + L.z);
  region_chain<GH, INNER>(x_rgb + in_off, hin, win, hout, wout, d,
                          weight_ptrs(w_rgb, sb_rgb, d), oy0 - e, ox0 - e,
                          smem, L, rgb);
  region_chain<GH, INNER>(x_disp + in_off, hin, win, hout, wout, d,
                          weight_ptrs(w_disp, sb_disp, d), oy0 - e, ox0 - e,
                          smem, L, dsp);
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

template <int GH, int INNER>
cudaError_t launch(const void* x_rgb, const void* x_disp, int n, int h,
                   int w, StageDims d, const void* w_rgb, const void* sb_rgb,
                   const void* w_disp, const void* sb_disp, void* out,
                   cudaStream_t stream) {
  if (2 * d.nb >= GH) return cudaErrorInvalidValue;
  const size_t bytes =
      layout<GH>(d, (size_t)Geom<GH>::P * d.cout * sizeof(bf16)).total;
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage1_dual_kernel<GH, INNER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int hout = h / 2, wout = w / 2, th = GH - 2 * d.nb,
            tw = GW - 2 * d.nb;
  dim3 grid((wout + tw - 1) / tw, (hout + th - 1) / th, n);
  stage1_dual_kernel<GH, INNER><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x_rgb), static_cast<const bf16*>(x_disp), h,
      w, d, static_cast<const bf16*>(w_rgb), static_cast<const float*>(sb_rgb),
      static_cast<const bf16*>(w_disp), static_cast<const float*>(sb_disp),
      static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // namespace

// x_rgb, x_disp: (n, h, w, cin); out: (n, h/2, w/2, cout).  variant: 0 =
// 16x16 region, wmma (production); 1 = 8x16, wmma; 2 = 16x16, FMA;
// 3 = 8x16, FMA.
ST_EXPORT int st_stage1_dual(const void* x_rgb, const void* x_disp, int n,
                             int h, int w, int cin, int cout, int mid,
                             int nb, const void* w_rgb, const void* sb_rgb,
                             const void* w_disp, const void* sb_disp,
                             void* out, int variant, void* stream) {
  const StageDims d{cin, cout, mid, nb};
  if (cin % 16 || cout % 16 || mid % 16 || nb < 1 || n < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return launch<16, WMMA>(x_rgb, x_disp, n, h, w, d, w_rgb, sb_rgb,
                              w_disp, sb_disp, out, st);
    case 1:
      return launch<8, WMMA>(x_rgb, x_disp, n, h, w, d, w_rgb, sb_rgb,
                             w_disp, sb_disp, out, st);
    case 2:
      return launch<16, FMA>(x_rgb, x_disp, n, h, w, d, w_rgb, sb_rgb,
                             w_disp, sb_disp, out, st);
    case 3:
      return launch<8, FMA>(x_rgb, x_disp, n, h, w, d, w_rgb, sb_rgb,
                            w_disp, sb_disp, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}
