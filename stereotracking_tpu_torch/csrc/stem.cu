// Focus stem with the frame preprocess fused into its load.
//
// Replaces: stereotracking_tpu/ops/stem_pallas.py, focus_stem_pallas /
// _stem_kernel (reached through pallas_stem_outputs).
//
// What it computes, for each of S frames (one launch, grid z = frame):
// out[oy, ox, o] = bf16(SiLU(scale[o] * acc + bias[o])),
// acc = sum over the 6x6 taps (uy, ux) and input channels c of
// x[2*oy + uy - 2, 2*ox + ux - 2, c] * w[uy, ux, c, o], where x is the
// preprocessed frame zero-padded to (out_h, out_w) and by (2, 3) around:
//   image:     x = float(u8)
//   disparity: x = bf16(raw == 65535 ? 0 : raw / 16)   (one channel; the
//              caller passes the kernel summed over the three channels)
//
// What bounds it on an H100: device-memory bytes.  At 1088x1920 it reads
// the raw frame once (6.2 MB image, 4.1 MB disparity) and writes the bf16
// activation once (33 MB at 32 channels); its 3.6 GFLOP (image) are far
// below the card's float32 rate.  Design: one block per 8x32 output tile
// stages its (20 x 68 x C) input patch — preprocessed on the load — and the
// whole kernel (at most 27 KB) in shared memory; each thread owns one output
// pixel and keeps its O float32 sums in registers, so the only device
// traffic is the raw read and one coalesced bf16 store of O contiguous
// channels per pixel.  No tensor cores yet (K = 108 is small).
#include "common.cuh"

namespace {

constexpr int TH = 8;     // output rows per block
constexpr int TW = 32;    // output cols per block
constexpr int PH = 2 * TH + 4;
constexpr int PW = 2 * TW + 4;

template <int C, int O>
__global__ void __launch_bounds__(TH * TW)
focus_stem_kernel(const void* __restrict__ frame, int h, int w, int hout,
                  int wout, const float* __restrict__ weight,
                  const float* __restrict__ sb, bf16* __restrict__ out) {
  __shared__ float patch[PH * PW * C];
  __shared__ float wsm[36 * C * O];
  const int tid = threadIdx.x;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const size_t frame_px = (size_t)blockIdx.z * h * w;
  out += (size_t)blockIdx.z * hout * wout * O;
  const int y0 = 2 * oy0 - 2, x0 = 2 * ox0 - 2;

  for (int i = tid; i < PH * PW * C; i += TH * TW) {
    const int c = i % C, p = i / C;
    const int y = y0 + p / PW, x = x0 + p % PW;
    float v = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      if (C == 1) {
        const unsigned r = static_cast<const uint16_t*>(
            frame)[frame_px + (size_t)y * w + x];
        v = r == 65535u ? 0.0f
                        : __bfloat162float(__float2bfloat16_rn(
                              __fdiv_rn(static_cast<float>(r), 16.0f)));
      } else {
        v = static_cast<float>(static_cast<const uint8_t*>(
            frame)[(frame_px + (size_t)y * w + x) * C + c]);
      }
    }
    patch[i] = v;
  }
  for (int i = tid; i < 36 * C * O; i += TH * TW) wsm[i] = weight[i];
  __syncthreads();

  const int ty = tid / TW, tx = tid % TW;
  const int oy = oy0 + ty, ox = ox0 + tx;
  float acc[O];
#pragma unroll
  for (int o = 0; o < O; ++o) acc[o] = 0.0f;
  for (int uy = 0; uy < 6; ++uy) {
    for (int ux = 0; ux < 6; ++ux) {
      const float* px = &patch[((2 * ty + uy) * PW + 2 * tx + ux) * C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = px[c];
        const float* wk = &wsm[((uy * 6 + ux) * C + c) * O];
#pragma unroll
        for (int o = 0; o < O; ++o) acc[o] += v * wk[o];
      }
    }
  }
  if (oy < hout && ox < wout) {
    bf16* dst = out + ((size_t)oy * wout + ox) * O;
#pragma unroll
    for (int o = 0; o < O; ++o) dst[o] = st_act(acc[o], sb[o], sb[O + o]);
  }
}

template <int C>
cudaError_t launch_c(const void* frame, int n, int h, int w, int hout,
                     int wout, int cout, const float* weight, const float* sb,
                     bf16* out, cudaStream_t stream) {
  dim3 grid((wout + TW - 1) / TW, (hout + TH - 1) / TH, n);
  switch (cout) {
    case 8:
      focus_stem_kernel<C, 8><<<grid, TH * TW, 0, stream>>>(
          frame, h, w, hout, wout, weight, sb, out);
      break;
    case 16:
      focus_stem_kernel<C, 16><<<grid, TH * TW, 0, stream>>>(
          frame, h, w, hout, wout, weight, sb, out);
      break;
    case 32:
      focus_stem_kernel<C, 32><<<grid, TH * TW, 0, stream>>>(
          frame, h, w, hout, wout, weight, sb, out);
      break;
    case 64:
      focus_stem_kernel<C, 64><<<grid, TH * TW, 0, stream>>>(
          frame, h, w, hout, wout, weight, sb, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// frame: (n, h, w, 3) uint8 or (n, h, w) uint16; out: (n, out_h/2,
// out_w/2, cout)
ST_EXPORT int st_focus_stem(const void* frame, int is_disp, int n, int h,
                            int w, int out_h, int out_w, int cout,
                            const void* weight, const void* sb, void* out,
                            void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const int hout = out_h / 2, wout = out_w / 2;
  const float* wt = static_cast<const float*>(weight);
  const float* s = static_cast<const float*>(sb);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_disp)
    return launch_c<1>(frame, n, h, w, hout, wout, cout, wt, s, o, st);
  return launch_c<3>(frame, n, h, w, hout, wout, cout, wt, s, o, st);
}
