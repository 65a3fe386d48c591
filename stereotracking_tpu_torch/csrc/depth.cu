// Per-box depth statistics over the fixed-point disparity map.
//
// Replaces: stereotracking_tpu/ops/depth_pallas.py, _stats_pallas /
// _kernel_impl (reached through extract_box_depths_disp_pallas).
//
// What it computes, for each box (one block per box, the boxes of all S
// streams in one launch; each box names its stream's map): the crop x crop
// window of the disparity map at pyramid level l (stride 2^l in rows and
// columns), as integer raw values round(disp * 16), masked to the box, the
// frame and raw >= rmin (the integer form of 0 < depth < 150); n = number
// of valid pixels; the value at seven ranks by a 16-step bisection over
// [0, 65535]; the max; and for six of the rank values v the count and the
// float32 sum of depth = bf / (raw / 16 + 1e-6) over the pixels with raw > v.
// The row written is the Pallas kernel's 24-float row:
//   [n, r_raw[8] = (mid, we0, we1, we2, ws0, ws1, max, fb),
//    cnt_lt[7] = (we0, we1, we2, ws0, ws1, 0, fb),
//    sum_lt[7] = (we0, we1, we2, ws0, ws1, 0, fb), 0].
// Every integer in the row is exact; the sums differ from the JAX paths
// only by float32 reassociation.
//
// What bounds it on an H100: launch latency and block-wide reductions, not
// bytes or FLOPs.  A 96 x 96 window is 9,216 pixels (36 KB of int32);
// 64 boxes read at most 2.4 MB of a 8.4 MB map.  The 16 bisection steps
// each need one block reduction, so the design keeps the window in shared
// memory once, resolves all seven ranks in the same pass per step (seven
// counts per thread, one fused reduction), and needs no pyramid copy of
// the map: the block reads its strided window straight from the map.
// Float arithmetic that decides integers (the rank fractions, the depth
// formula) uses the _rn intrinsics so no FMA contraction changes a result.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NRANK = 7;
constexpr int NOUT = 24;

__device__ __forceinline__ float f_depth(int r, float bf) {
  return __fdiv_rn(bf, __fadd_rn(__fdiv_rn(static_cast<float>(r), 16.0f),
                                 1e-6f));
}

// Block-wide sums of NV ints (all threads get the result).
template <int NV>
__device__ void block_sum(int (&v)[NV], int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    int x = v[j];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(~0u, x, off);
    if (lane == 0) red[warp * NV + j] = x;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    int s = 0;
    for (int k = 0; k < WARPS; ++k) s += red[k * NV + j];
    v[j] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
box_depth_stats_kernel(const float* __restrict__ disp, int h, int w,
                       const int* __restrict__ scal, int crop, float bf,
                       float* __restrict__ out) {
  extern __shared__ int win[];               // crop * crop raw values or -1
  __shared__ int red[WARPS * 8];
  __shared__ float redf[WARPS * 6];
  __shared__ int redmax[WARPS];
  const int* s = scal + blockIdx.x * 8;
  const int y0 = s[1], x0 = s[2], nr = s[3], nc = s[4], stride = s[5],
            rmin = s[6];
  disp += (size_t)s[7] * h * w;
  const int tid = threadIdx.x, npix = crop * crop;

  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = tid; i < npix; i += THREADS) {
    const int rr = i / crop, cc = i % crop;
    int v = -1;
    if (rr < nr && cc < nc) {
      const int y = (y0 + rr) * stride, x = (x0 + cc) * stride;
      if (y < h && x < w) {
        const int r = __float2int_rn(__fmul_rn(disp[(size_t)y * w + x],
                                               16.0f));
        if (r >= rmin) v = r;
      }
    }
    win[i] = v;
    cnt[0] += v >= 0;
  }
  __syncthreads();
  block_sum<8>(cnt, red);
  const int n = cnt[0];

  const float nf = static_cast<float>(n);
  const float a04 = __fmul_rn(0.4f, nf), a025 = __fmul_rn(0.25f, nf),
              a06 = __fmul_rn(0.6f, nf);
  const int ws0 = static_cast<int>(a04), ws1 = static_cast<int>(a025);
  const int we0 = static_cast<int>(__fadd_rn(a04, a06));
  const int we1 = static_cast<int>(__fadd_rn(a025, a06));
  const int we2 = static_cast<int>(a06);
  const int m_fb = max(n > 1 ? n - 1 : n, 1);
  const int rank[NRANK] = {max(n / 2, 0),      max(we0, 1) - 1,
                           max(we1, 1) - 1,    max(we2, 1) - 1,
                           max(ws0, 1) - 1,    max(ws1, 1) - 1,
                           m_fb - 1};

  // value at each rank: largest v with count(raw >= v) >= rank + 1
  int lo[NRANK], hi[NRANK];
#pragma unroll
  for (int j = 0; j < NRANK; ++j) { lo[j] = 0; hi[j] = 65535; }
  for (int step = 0; step < 16; ++step) {
    int mid[NRANK];
    int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < NRANK; ++j) mid[j] = lo[j] + (hi[j] - lo[j] + 1) / 2;
    for (int i = tid; i < npix; i += THREADS) {
      const int v = win[i];
#pragma unroll
      for (int j = 0; j < NRANK; ++j) c[j] += v >= mid[j];
    }
    block_sum<8>(c, red);
#pragma unroll
    for (int j = 0; j < NRANK; ++j) {
      if (c[j] >= rank[j] + 1) lo[j] = mid[j];
      else hi[j] = mid[j] - 1;
    }
  }

  // max, and count / depth sum above each boundary (ranks 1..6)
  int vmax = -1;
  int cl[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float sl[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < npix; i += THREADS) {
    const int v = win[i];
    vmax = max(vmax, v);
    if (v < 0) continue;
    const float d = f_depth(v, bf);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (v > lo[j + 1]) {
        cl[j] += 1;
        sl[j] += d;
      }
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  for (int off = 16; off > 0; off >>= 1)
    vmax = max(vmax, __shfl_xor_sync(~0u, vmax, off));
  if (lane == 0) redmax[warp] = vmax;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float x = sl[j];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(~0u, x, off);
    if (lane == 0) redf[warp * 6 + j] = x;
  }
  block_sum<8>(cl, red);   // its barriers also publish redmax and redf
  if (tid == 0) {
    int vm = -1;
    float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < WARPS; ++k) {
      vm = max(vm, redmax[k]);
      for (int j = 0; j < 6; ++j) sums[j] += redf[k * 6 + j];
    }
    float* row = out + (size_t)blockIdx.x * NOUT;
    row[0] = nf;
    const int rr[8] = {lo[0], lo[1], lo[2], lo[3], lo[4], lo[5], max(vm, 0),
                       lo[6]};
    for (int j = 0; j < 8; ++j) row[1 + j] = static_cast<float>(rr[j]);
    // cnt_lt / sum_lt in the order (we0, we1, we2, ws0, ws1, 0, fb)
    for (int j = 0; j < 5; ++j) {
      row[9 + j] = static_cast<float>(cl[j]);
      row[16 + j] = sums[j];
    }
    row[14] = 0.f;
    row[21] = 0.f;
    row[15] = static_cast<float>(cl[5]);
    row[22] = sums[5];
    row[23] = 0.f;
  }
}

}  // namespace

// disp: (n, h, w) float32; scal: (nbox, 8) int32 per box
// [level, y0, x0, nrows, ncols, stride, rmin, stream] with (y0, x0) the
// window origin in level coordinates and stream < n; out: (nbox, 24)
// float32.
ST_EXPORT int st_box_depth_stats(const void* disp, int h, int w,
                                 const void* scal, int nbox, int crop,
                                 float bf, void* out, void* stream) {
  if (nbox == 0) return cudaSuccess;
  const size_t bytes = (size_t)crop * crop * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      box_depth_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  box_depth_stats_kernel<<<nbox, THREADS, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp), h, w, static_cast<const int*>(scal),
      crop, bf, static_cast<float*>(out));
  return cudaGetLastError();
}
