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
// Its 19 GFLOP per frame (about 25 GFLOP with the halo recompute of a
// 16 x 16 region, 31 with an 8 x 16 one) bound it at the tensor cores'
// rate.
//
// Production design (mma_chain.cuh, variants r16x16_mma and r8x16_mma, C =
// 32 only): one block per GH x 16 region = a (GH - 2) x 14 output tile plus
// the one ring the bottleneck consumes, recomputed per tile.  The block runs
// entry_part + chain_part on the RGB stem, its final epilogue writing the
// region result into a P x 64 bf16 buffer after the weight ring; then on the
// disparity stem, whose final epilogue writes bf16((rgb + dsp) * 0.5) of its
// own bf16 word and the RGB word into z, stored as 16-byte chunks.  Every
// convolution is an mma.sync bf16 GEMM from swizzled shared memory; each
// branch's 13 weight slices of 8 KB (StageKernel.ws) stream through the
// cp.async ring, so each weight byte leaves L2 once per region.  Shared memory:
// 118,912 B for the core + 32,768 B (GH = 16, one block per SM) or 68,736 +
// 16,384 B (GH = 8, two blocks per SM, at most 128 registers a thread).
// On an H100 (700 W) at 8 streams of 1080p the 8 x 16 region is the faster
// (1.80 against 2.03 ms; the wmma 16 x 16 kernel took 10.68): two blocks
// per SM hide each other's per-slice barriers and copies, which outweighs
// its 1.52x recompute against 1.31x.  What is left (tools/ablate_kernels.py):
// the SFU's SiLU (a fifth of the time: stage 1's GEMMs are narrow, so it
// has many outputs per operation), tensor-core issue, the barriers.
//
// Variants (the card's counterpart of the TPU probe's layout variants):
// the region height (16 or 8 rows) and the GEMM inner loop: wmma or scalar
// float32 FMA on csp_chain.cuh (B fragments from device memory), or
// mma.sync on mma_chain.cuh.  ops/stage1_cuda.py
// names them and picks the production one.
#include "csp_chain.cuh"
#include "mma_chain.cuh"

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

namespace mc = st_mma_chain;

template <int GH>
__global__ void __launch_bounds__(mc::THREADS, GH == 8 ? 2 : 1)
stage1_mma_kernel(const bf16* __restrict__ x_rgb,
                  const bf16* __restrict__ x_disp, int hin, int win,
                  const bf16* __restrict__ ws_rgb,
                  const float* __restrict__ sb_rgb,
                  const bf16* __restrict__ ws_disp,
                  const float* __restrict__ sb_disp, bf16* __restrict__ out) {
  constexpr int C = 32, O = 2 * C, TH = GH - 2, TW = mc::GW - 2;
  constexpr StageDims d{C, O, C, 1};
  extern __shared__ __align__(128) unsigned char smem[];
  const int hout = hin / 2, wout = win / 2;
  const mc::Layout L =
      mc::layout<GH>(d, (size_t)mc::Region<GH>::P * O * sizeof(bf16));
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const size_t in_off = (size_t)blockIdx.z * hin * win * C;
  out += (size_t)blockIdx.z * hout * wout * O;
  const uint32_t ring = mc::smem_u32(smem) + L.ring;

  // RGB: the region result into the extra buffer
  const StageWeightPtrs wr = weight_ptrs(ws_rgb, sb_rgb, d);
  mc::Pipe pr = mc::make_pipe(ws_rgb, 0, mc::chain_slices(d), ring);
  mc::entry_part<GH, C>(pr, x_rgb + in_off, hin, win, wr, oy0 - 1, ox0 - 1,
                        smem, L, mc::to_main_short<C>(smem, L));
  mc::chain_part<GH, C>(pr, 1, hout, wout, wr, oy0 - 1, ox0 - 1, smem, L,
                        [] {}, mc::to_buffer<O>(smem, L.extra));
  // disparity: bf16((rgb + dsp) * 0.5) into z
  const StageWeightPtrs wd = weight_ptrs(ws_disp, sb_disp, d);
  mc::Pipe pd = mc::make_pipe(ws_disp, 0, mc::chain_slices(d), ring);
  mc::entry_part<GH, C>(pd, x_disp + in_off, hin, win, wd, oy0 - 1, ox0 - 1,
                        smem, L, mc::to_main_short<C>(smem, L));
  mc::chain_part<GH, C>(
      pd, 1, hout, wout, wd, oy0 - 1, ox0 - 1, smem, L, [] {},
      [&](int p, int n, uint32_t v) {
        using namespace st_mma;
        const uint32_t r =
            *mc::smem_word(smem, L.extra + mc::swz_word(p, n, O));
        *mc::smem_word(smem, L.z + mc::swz_word(p, n, O)) = pack_bf16x2(
            __float2bfloat16_rn((st_f(lo_bf16(v)) + st_f(lo_bf16(r))) * 0.5f),
            __float2bfloat16_rn((st_f(hi_bf16(v)) + st_f(hi_bf16(r))) * 0.5f));
      });
  mc::store_tile(smem, L.z, 1, TH, TW, O, oy0, ox0, hout, wout, out);
}

template <int GH>
cudaError_t launch_mma(const void* x_rgb, const void* x_disp, int n, int h,
                       int w, StageDims d, const void* ws_rgb,
                       const void* sb_rgb, const void* ws_disp,
                       const void* sb_disp, void* out, cudaStream_t stream) {
  if (d.cin != 32 || d.mid != 32 || d.cout != 64 || d.nb != 1)
    return cudaErrorInvalidValue;
  const size_t bytes =
      mc::layout<GH>(d, (size_t)mc::Region<GH>::P * d.cout * sizeof(bf16))
          .total;
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage1_mma_kernel<GH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int hout = h / 2, wout = w / 2, th = GH - 2, tw = mc::GW - 2;
  dim3 grid((wout + tw - 1) / tw, (hout + th - 1) / th, n);
  stage1_mma_kernel<GH><<<grid, mc::THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x_rgb), static_cast<const bf16*>(x_disp), h,
      w, static_cast<const bf16*>(ws_rgb), static_cast<const float*>(sb_rgb),
      static_cast<const bf16*>(ws_disp), static_cast<const float*>(sb_disp),
      static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // namespace

// x_rgb, x_disp: (n, h, w, cin); out: (n, h/2, w/2, cout).  variant: 0 =
// 16x16 region, wmma; 1 = 8x16, wmma; 2 = 16x16, FMA; 3 = 8x16, FMA (w_rgb,
// w_disp: the flat weights of weight_ptrs); 4 = 16x16, mma.sync; 5 = 8x16,
// mma.sync (w_rgb, w_disp: the packed slices of pack_slices; C = 32 only).
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
    case 4:
      return launch_mma<16>(x_rgb, x_disp, n, h, w, d, w_rgb, sb_rgb, w_disp,
                            sb_disp, out, st);
    case 5:
      return launch_mma<8>(x_rgb, x_disp, n, h, w, d, w_rgb, sb_rgb, w_disp,
                           sb_disp, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}
