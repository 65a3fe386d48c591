// Fused stage 3 (3x3 stride-2 entry conv + CSP chain) in two launches.
//
// Replaces: stereotracking_tpu/ops/stage2_pallas.py, stage2_fold_pallas
// reached through pallas_stage3_out (the generic stage kernel on the
// stage-3 weights: 128 -> 256 channels, mid 128, 3 bottlenecks in the
// flagship).
//
// What it computes: the chain of csp_chain.cuh, the same roundings as the
// one-launch stage kernel (stage2.cu).  Input (S, hin, win, 128) bf16 NHWC,
// output (S, hin/2, win/2, 256) bf16 NHWC; each launch covers the S streams
// (grid z).  Built for C_in = mid = C_out / 2 = 128.
//
// Why two launches: the one-launch kernel's 16 x 16 region needs a
// 33 x 33 x 128 bf16 input patch (278,784 B) at these widths, more than a
// block's 232,448 B; an 8 x 16 region would fit, but with 3 bottlenecks its
// exact tile is 2 x 10 of 128 region pixels: 6.4x the chain's work.  So each
// launch runs one half of mma_chain.cuh's chain:
//   A. entry_part per 8 x 16 tile, no halo (GH = 8, no recompute): input
//      patch 17 x 33 x 128 (143,616 B) + z 128 x 256 (65,536 B) + ring
//      (16,384 B) = 225,536 B.  [main | short] goes into the patch's dead
//      bytes, then as 16-byte chunks to the (S, hout, wout, 2 mid) bf16
//      scratch, 4.2 MB per 1088x1920 frame.  It streams slices [0, 88) of
//      the packed weights: the entry conv's 72 and main|short's 16.
//   B. chain_part on 16 x 16 regions of main with a 3-ring halo (a 10 x 10
//      tile, 2.56x recompute of that part): main and its next version
//      (2 x 65,536 B), conv1 with its flat pads (74,240 B) and the ring:
//      221,696 B.  short is read into conv1's dead buffer before the final
//      GEMM, whose epilogue writes the clipped tile straight to the output.
//      It streams slices [88, 224) from the offset the wrapper passes.
//
// What bounds it on an H100: 14.97 GFLOP per 1088x1920 frame against
// 8.4 MB read, 4.2 MB written and 1.8 MB of weights: the operations (about
// 15 us per frame at the dense bf16 rate).  With B's recompute the kernel
// does about 29 GFLOP per frame; the extra 8.4 MB of [main | short]
// traffic costs under 3 us.  Every convolution is an mma.sync bf16 GEMM
// from swizzled shared memory, its weights through the cp.async ring, so
// each weight byte leaves L2 once per tile or region (0.72 MB per A tile,
// 1.11 MB per B region); one block per SM.
// What is left (tools/ablate_kernels.py, H100 at 700 W): tensor-core issue
// and the per-slice barriers (a quarter of the time each), then the SiLU.
#include "mma_chain.cuh"

namespace {

using namespace st_mma_chain;

constexpr int C = 128;      // C_in = mid = C_out / 2
constexpr int GH_A = 8;     // launch A: tile = region, 8 x 16
constexpr int GH_B = 16;    // launch B: 16 x 16 region, tile 16 - 2 nb

// Launch B's buffers: main, its next version, conv1 with its flat pads
// (short once conv1 is dead), the ring.
__host__ __device__ inline Layout layout_b() {
  constexpr size_t P = Region<GH_B>::P, mb = P * C * 2;
  Layout L{};
  L.m = 0;
  L.m2 = mb;
  L.c1 = 2 * mb;
  L.s = L.c1;
  L.ring = L.c1 + align128((P + 2 * PAD) * C * 2);
  L.extra = L.total = L.ring + STAGES * SLICE_BYTES;
  return L;
}

// Copies channels [c0, c0 + C) of the 16 x 16 pixels from (y0, x0) of the
// (h, w, 2 C) map src into the swizzled buffer at shared address dst (C
// channels per pixel) by cp.async, zeros outside the map; commits a group.
__device__ inline void load_half(uint32_t dst, const bf16* __restrict__ src,
                                 int h, int w, int c0, int y0, int x0) {
  constexpr int C8 = C / 8;
  for (int i = threadIdx.x; i < Region<GH_B>::P * C8; i += THREADS) {
    const int ch = i % C8, p = i / C8;
    const int y = y0 + p / GW, xx = x0 + p % GW;
    const bool ok = y >= 0 && y < h && xx >= 0 && xx < w;
    cp_async16(dst + swz(p, ch, C, p),
               ok ? src + ((size_t)y * w + xx) * 2 * C + c0 + ch * 8 : src,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 1)
stage3_entry_kernel(const bf16* __restrict__ x, int hin, int win,
                    StageDims d, const bf16* __restrict__ ws,
                    const float* __restrict__ sb, bf16* __restrict__ ms) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hout = hin / 2, wout = win / 2;
  const Layout L = layout<GH_A>(d);
  const int oy0 = blockIdx.y * GH_A, ox0 = blockIdx.x * GW;
  x += (size_t)blockIdx.z * hin * win * C;
  ms += (size_t)blockIdx.z * hout * wout * 2 * C;
  Pipe pipe = make_pipe(ws, 0, entry_slices(d), smem_u32(smem) + L.ring);
  // [main | short] into the patch's bytes, 2 C channels per pixel
  entry_part<GH_A, C>(pipe, x, hin, win, st_chain::weight_ptrs(ws, sb, d),
                      oy0, ox0, smem, L, to_buffer<2 * C>(smem, L.m));
  __syncthreads();
  store_tile(smem, L.m, 0, GH_A, GW, 2 * C, oy0, ox0, hout, wout, ms);
}

__global__ void __launch_bounds__(THREADS, 1)
stage3_chain_kernel(const bf16* __restrict__ ms, int hout, int wout,
                    StageDims d, const bf16* __restrict__ ws, int first,
                    const float* __restrict__ sb, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = d.nb, th = GH_B - 2 * e, tw = GW - 2 * e;
  const Layout L = layout_b();
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * tw;
  const int ry0 = oy0 - e, rx0 = ox0 - e;       // region origin
  ms += (size_t)blockIdx.z * hout * wout * 2 * C;
  out += (size_t)blockIdx.z * hout * wout * 2 * C;
  const uint32_t base = smem_u32(smem);

  // main of the region, zeros outside the map: only conv1 reads it there,
  // and conv1's outputs outside the map are zeroed
  load_half(base + L.m, ms, hout, wout, 0, ry0, rx0);
  Pipe pipe = make_pipe(ws, first, chain_slices(d) - first, base + L.ring);
  pipe.start();
  chain_part<GH_B, C>(
      pipe, d.nb, hout, wout, st_chain::weight_ptrs(ws, sb, d), ry0, rx0,
      smem, L,
      [&] {
        // short into conv1's buffer once every warp is past the last conv2;
        // the final GEMM's first barrier makes it visible
        __syncthreads();
        load_half(base + L.s, ms, hout, wout, C, ry0, rx0);
        cp_async_wait<0>();
      },
      [&](int p, int n, uint32_t v) {
        const int ty = p / GW - e, tx = p % GW - e;
        const int y = oy0 + ty, xx = ox0 + tx;
        if (ty >= 0 && ty < th && tx >= 0 && tx < tw && y < hout &&
            xx < wout)
          *reinterpret_cast<uint32_t*>(
              out + ((size_t)y * wout + xx) * 2 * C + n) = v;
      });
}

}  // namespace

// x: (n, h, w, cin); weights: the packed slices (ops/stage2_cuda.py
// pack_slices); b_slice: the first slice of launch B (the first
// bottleneck's, slice_offsets in ops/stage2_cuda.py); ms: (n, h/2, w/2,
// 2 mid) scratch; out: (n, h/2, w/2, cout).  Built for cin = mid = cout / 2
// = 128.
ST_EXPORT int st_stage3(const void* x, int n, int h, int w, int cin,
                        int cout, int mid, int nb, const void* weights,
                        const void* sb, int b_slice, void* ms, void* out,
                        void* stream) {
  const StageDims d{cin, cout, mid, nb};
  if (cin != C || mid != C || cout != 2 * C || nb < 1 || 2 * nb >= GH_B ||
      n < 1 || b_slice != entry_slices(d))
    return cudaErrorInvalidValue;
  const size_t ba = layout<GH_A>(d).total, bb = layout_b().total;
  if (ba > st_chain::MAX_SMEM || bb > st_chain::MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage3_entry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ba));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stage3_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bb));
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hout = h / 2, wout = w / 2;
  const bf16* wt = static_cast<const bf16*>(weights);
  const float* s = static_cast<const float*>(sb);
  bf16* msb = static_cast<bf16*>(ms);
  dim3 grid_a((wout + GW - 1) / GW, (hout + GH_A - 1) / GH_A, n);
  stage3_entry_kernel<<<grid_a, THREADS, ba, st>>>(
      static_cast<const bf16*>(x), h, w, d, wt, s, msb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int th = GH_B - 2 * nb, tw = GW - 2 * nb;
  dim3 grid_b((wout + tw - 1) / tw, (hout + th - 1) / th, n);
  stage3_chain_kernel<<<grid_b, THREADS, bb, st>>>(
      msb, hout, wout, d, wt, b_slice, s, static_cast<bf16*>(out));
  return cudaGetLastError();
}
