// Fused backbone stage: 3x3 stride-2 entry conv + CSP chain, one launch.
//
// Replaces: stereotracking_tpu/ops/stage2_pallas.py, stage2_fold_pallas /
// _stage2_kernel (reached through pallas_stage2_out).  Built for YOLOX's
// stage-2 shape, C_in = mid = C_out / 2, at C_in 32 and 64 (template C);
// the flagship's stage 2 is (64, 128, 3 blocks).  Stage 3 (128, 256, 3)
// does not fit a 16 x 16 region and runs the same chain in two launches
// (stage3.cu); stage 1 runs it twice per region, once per branch
// (stage1.cu).
//
// What it computes: see csp_chain.cuh.  Input (S, hin, win, C_in) bf16
// NHWC, output (S, hin/2, win/2, C_out) bf16 NHWC; one launch covers the S
// streams (grid z).
//
// What bounds it on an H100: fused, the stage reads 16.7 MB and writes 8.4
// MB per 1088x1920 frame; its 15 GFLOP per frame (39 with the 2.56x halo
// recompute, 310 GFLOP per 8-stream call) bound it at the tensor cores'
// rate.  The wmma chain of csp_chain.cuh (the stage-1 probe's wmma variants)
// loads every B fragment straight from the weight buffer in device memory,
// once per (m tile, n group) item: on this stage each 16 x 16 region would
// read the whole 0.46 MB of weights 16 times, 7.3 MB of L2 reads per region
// and about 20 GB per 8-stream call (2,688 regions), each load a serial wait
// that 8 warps per SM cannot hide; and it sends every accumulator through a
// float32 scratch tile one element at a time, with st_act reading scale and
// bias from device memory per element.
//
// Design (mma_chain.cuh, entry_part then chain_part): one block per 16 x 16
// region = a 10 x 10 output tile plus the 3 rings the bottlenecks consume,
// recomputed per tile; every convolution an mma.sync bf16 GEMM from shared
// memory through ldmatrix, on swizzled buffers.  The weights stream through
// a 2-slot ring of 8 KB slices by cp.async, the next slice in flight while
// one is multiplied: each weight byte leaves L2 once per region (0.46 MB per
// region, about 1.2 GB per 8-stream call).  Epilogues run in registers
// (scale and bias in registers, act_fast) and write bf16x2 words.  The
// widths are template constants, so the operand addresses of the shifted and
// strided views cost no integer division.  Shared memory: the 33 x 33 x 64
// input patch (139 KB), z (64 KB) and the ring (16 KB): 221,312 B, one block
// per SM.  What is left (tools/ablate_kernels.py): the SFU's SiLU, the
// per-slice barriers, and ldmatrix/mma issue with 8 warps per SM.
#include "mma_chain.cuh"

namespace {

using namespace st_mma_chain;

constexpr int GH = 16;    // region rows

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
stage_csp_kernel(const bf16* __restrict__ x, int hin, int win, StageDims d,
                 const bf16* __restrict__ ws, const float* __restrict__ sb,
                 bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hout = hin / 2, wout = win / 2;
  const int e = d.nb, th = GH - 2 * e, tw = GW - 2 * e;
  const Layout L = layout<GH>(d);
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * tw;
  x += (size_t)blockIdx.z * hin * win * d.cin;
  out += (size_t)blockIdx.z * hout * wout * d.cout;
  const StageWeightPtrs w = st_chain::weight_ptrs(ws, sb, d);
  Pipe pipe = make_pipe(ws, 0, chain_slices(d), smem_u32(smem) + L.ring);
  entry_part<GH, C>(pipe, x, hin, win, w, oy0 - e, ox0 - e, smem, L,
                    to_main_short<C>(smem, L));
  chain_part<GH, C>(pipe, d.nb, hout, wout, w, oy0 - e, ox0 - e, smem, L,
                    [] {}, to_buffer<2 * C>(smem, L.z));
  store_tile(smem, L.z, e, th, tw, d.cout, oy0, ox0, hout, wout, out);
}

template <int C>
cudaError_t launch(const bf16* x, int n, int h, int w, StageDims d,
                   const bf16* ws, const float* sb, bf16* out,
                   cudaStream_t stream) {
  const size_t bytes = layout<GH>(d).total;
  if (bytes > st_chain::MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage_csp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int hout = h / 2, wout = w / 2;
  const int th = GH - 2 * d.nb, tw = GW - 2 * d.nb;
  dim3 grid((wout + tw - 1) / tw, (hout + th - 1) / th, n);
  stage_csp_kernel<C><<<grid, THREADS, bytes, stream>>>(x, h, w, d, ws, sb,
                                                        out);
  return cudaGetLastError();
}

}  // namespace

// x: (n, h, w, cin); weights: the packed slices (ops/stage2_cuda.py
// pack_slices); out: (n, h/2, w/2, cout).  Built for cin = mid = cout / 2
// in {32, 64} (YOLOX's stage 2 at widen 0.25 and 0.5): the swizzle needs a
// power-of-two count of 16-byte chunks per pixel or a multiple of 8.
ST_EXPORT int st_stage_csp(const void* x, int n, int h, int w, int cin,
                           int cout, int mid, int nb, const void* weights,
                           const void* sb, void* out, void* stream) {
  const StageDims d{cin, cout, mid, nb};
  if (mid != cin || cout != 2 * cin || nb < 1 || 2 * nb >= GH || n < 1)
    return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* ws = static_cast<const bf16*>(weights);
  const float* s = static_cast<const float*>(sb);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cin) {
    case 32:
      return launch<32>(xp, n, h, w, d, ws, s, o, st);
    case 64:
      return launch<64>(xp, n, h, w, d, ws, s, o, st);
    default:
      return cudaErrorInvalidValue;
  }
}
