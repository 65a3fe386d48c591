// Fused stage 3 (3x3 stride-2 entry conv + CSP chain) in two launches.
//
// Replaces: stereotracking_tpu/ops/stage2_pallas.py, stage2_fold_pallas
// reached through pallas_stage3_out (the generic stage kernel on the
// stage-3 weights: 128 -> 256 channels, mid 128, 3 bottlenecks in the
// flagship).
//
// What it computes: the chain of csp_chain.cuh, the same roundings as the
// one-launch stage kernel (stage2.cu).  Input (S, hin, win, C_in) bf16 NHWC,
// output (S, hin/2, win/2, C_out) bf16 NHWC; each launch covers the S
// streams (grid z).
//
// Why two launches: the one-launch kernel's 16 x 16 region needs a
// 33 x 33 x 128 bf16 input patch (278,784 B) at these widths, more than a
// block's 232,448 B.  An 8 x 16 region would fit (217,344 B), but with 3
// bottlenecks its exact tile is 2 x 10 of 128 region pixels: 6.4x the
// chain's work.  Instead:
//   A. entry conv + main|short per 8 x 16 tile, no halo (no recompute):
//      input patch 17 x 33 x 128 (143,616 B) + z 128 x 256 (65,536 B) +
//      scratch (8,192 B) = 217,344 B; [main | short] (S, hout, wout,
//      2 mid) bf16 goes to device memory, 4.2 MB per 1088x1920 frame.
//   B. the 3 bottlenecks + the final 1x1 on a 16 x 16 region of main with a
//      3-ring halo (a 10 x 10 tile, 2.56x recompute of that part): main,
//      its next version and the padded conv1 output, 3 x 64 KB + pads +
//      scratch = 213,504 B; short is read back into conv1's buffer for the
//      final GEMM, and the result goes straight from its epilogue to the
//      output.
//
// What bounds it on an H100: 14.97 GFLOP per 1088x1920 frame against
// 8.4 MB read, 4.2 MB written and 1.8 MB of weights: the operations (about
// 15 us per frame at the dense bf16 rate).  With B's recompute the kernel
// does about 29 GFLOP per frame; the extra 8.4 MB of [main | short]
// traffic costs under 3 us.  Every convolution is a bf16 tensor-core GEMM
// (wmma) with float32 accumulation from shared memory; one block per SM.
#include "csp_chain.cuh"

namespace {

using namespace st_chain;

constexpr int GH_A = 8;     // launch A: tile = region, 8 x 16
constexpr int GH_B = 16;    // launch B: 16 x 16 region, tile 16 - 2 nb

__host__ __device__ inline size_t bytes_a(StageDims d) {
  using G = Geom<GH_A>;
  const size_t in = align128((size_t)G::IH * G::IW * d.cin * sizeof(bf16));
  const size_t z = align128((size_t)G::P * d.cout * sizeof(bf16));
  const size_t ms = align128((size_t)G::P * 2 * d.mid * sizeof(bf16));
  return (in > ms ? in : ms) + z + SCRATCH_BYTES;
}

__host__ __device__ inline size_t bytes_b(StageDims d) {
  using G = Geom<GH_B>;
  const size_t m = align128((size_t)G::P * d.mid * sizeof(bf16));
  const size_t c1 =
      align128((size_t)(G::P + 2 * G::PAD) * d.mid * sizeof(bf16));
  return 2 * m + c1 + SCRATCH_BYTES;
}

__global__ void __launch_bounds__(THREADS)
stage3_entry_kernel(const bf16* __restrict__ x, int hin, int win,
                    StageDims d, const bf16* __restrict__ weights,
                    const float* __restrict__ sb, bf16* __restrict__ ms) {
  using G = Geom<GH_A>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int hout = hin / 2, wout = win / 2, mid2 = 2 * d.mid;
  const StageWeightPtrs w = weight_ptrs(weights, sb, d);
  const size_t in_bytes =
      align128((size_t)G::IH * G::IW * d.cin * sizeof(bf16));
  const size_t ms_bytes = align128((size_t)G::P * mid2 * sizeof(bf16));
  bf16* in = reinterpret_cast<bf16*>(smem);
  bf16* res = reinterpret_cast<bf16*>(smem);     // once the patch is dead
  const size_t z_off = in_bytes > ms_bytes ? in_bytes : ms_bytes;
  bf16* z = reinterpret_cast<bf16*>(smem + z_off);
  const size_t z_bytes = align128((size_t)G::P * d.cout * sizeof(bf16));
  float* scratch = reinterpret_cast<float*>(smem + z_off + z_bytes) +
                   (threadIdx.x >> 5) * 256;
  const int oy0 = blockIdx.y * GH_A, ox0 = blockIdx.x * GW;
  x += (size_t)blockIdx.z * hin * win * d.cin;
  ms += (size_t)blockIdx.z * hout * wout * mid2;

  load_region<G::IW>(x, hin, win, d.cin, 0, d.cin, 2 * oy0 - 1, 2 * ox0 - 1,
                     G::IH, in);
  __syncthreads();
  entry_conv<GH_A, WMMA>(in, d, w, z, scratch);
  main_short<GH_A, WMMA>(z, d, w, scratch, [&](int p, int n, bf16 v) {
    res[p * mid2 + n] = v;
  });
  store_tile(res, 0, GH_A, GW, mid2, oy0, ox0, hout, wout, ms);
}

__global__ void __launch_bounds__(THREADS)
stage3_chain_kernel(const bf16* __restrict__ ms, int hout, int wout,
                    StageDims d, const bf16* __restrict__ weights,
                    const float* __restrict__ sb, bf16* __restrict__ out) {
  using G = Geom<GH_B>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int mid = d.mid, cout = d.cout;
  const int e = d.nb, th = GH_B - 2 * e, tw = GW - 2 * e;
  const StageWeightPtrs w = weight_ptrs(weights, sb, d);
  const size_t mb = align128((size_t)G::P * mid * sizeof(bf16));
  bf16* m = reinterpret_cast<bf16*>(smem);
  bf16* m2 = reinterpret_cast<bf16*>(smem + mb);
  bf16* c1 = reinterpret_cast<bf16*>(smem + 2 * mb);
  float* scratch =
      reinterpret_cast<float*>(
          smem + 2 * mb +
          align128((size_t)(G::P + 2 * G::PAD) * mid * sizeof(bf16))) +
      (threadIdx.x >> 5) * 256;
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * tw;
  const int ry0 = oy0 - e, rx0 = ox0 - e;       // region origin
  ms += (size_t)blockIdx.z * hout * wout * 2 * mid;
  out += (size_t)blockIdx.z * hout * wout * cout;

  // main of the region, zeros outside the map: only conv1 reads it there,
  // and conv1's outputs outside the map are zeroed
  load_region<GW>(ms, hout, wout, 2 * mid, 0, mid, ry0, rx0, GH_B, m);
  __syncthreads();
  const bf16* mf = bottlenecks<GH_B, WMMA>(m, m2, c1, d, w, ry0, rx0, hout,
                                           wout, scratch);
  load_region<GW>(ms, hout, wout, 2 * mid, mid, mid, ry0, rx0, GH_B, c1);
  __syncthreads();
  final_conv<GH_B, WMMA>(mf, c1, d, w, scratch, [&](int p, int n, bf16 v) {
    const int ty = p / GW - e, tx = p % GW - e;
    const int y = oy0 + ty, xx = ox0 + tx;
    if (ty >= 0 && ty < th && tx >= 0 && tx < tw && y < hout && xx < wout)
      out[((size_t)y * wout + xx) * cout + n] = v;
  });
}

}  // namespace

// x: (n, h, w, cin); ms: (n, h/2, w/2, 2 mid) scratch; out: (n, h/2, w/2,
// cout)
ST_EXPORT int st_stage3(const void* x, int n, int h, int w, int cin,
                        int cout, int mid, int nb, const void* weights,
                        const void* sb, void* ms, void* out, void* stream) {
  const StageDims d{cin, cout, mid, nb};
  if (cin % 16 || cout % 16 || mid % 16 || nb < 1 || 2 * nb >= GH_B ||
      n < 1)
    return cudaErrorInvalidValue;
  const size_t ba = bytes_a(d), bb = bytes_b(d);
  if (ba > MAX_SMEM || bb > MAX_SMEM) return cudaErrorInvalidValue;
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
      msb, hout, wout, d, wt, s, static_cast<bf16*>(out));
  return cudaGetLastError();
}
