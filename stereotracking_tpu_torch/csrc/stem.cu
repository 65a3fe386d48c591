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
// What bounds it on an H100: at 8 x 1088x1920 it reads 50 MB of raw
// frames (image and disparity) and writes 534 MB of bf16 activations (32
// channels): 0.18 ms at 3.35 TB/s.  Its 38.5 GFLOP are exact in bf16
// (pixels 0-255, bf16(disp / 16), bf16-valued weights), so the tensor
// cores' bf16 rate applies: 0.04 ms.  SiLU costs an exponential and a
// reciprocal per output on the special-function units (16 per clock per
// SM): 1.07 G of them, 0.26-0.29 ms, above the bytes; with st_act's IEEE
// division and exponential the SiLU alone takes about twice that.  One
// thread per output pixel would store its 32 channels as 2-byte stores
// 64 B apart across the warp (32 sectors per instruction) and sum 19 G
// float32 FMAs out of shared memory.
//
// Design: an implicit GEMM per block of 16 x 32 output pixels, M = pixels,
// N = O, K = 36 C in (uy, ux, c) order, zero-padded to a multiple of 16
// (108 -> 112 image, 36 -> 48 disparity).
// - Load: each patch row's in-image span is read as aligned 16-byte words
//   (an aligned word holding an in-bounds byte lies in the allocation) and
//   preprocessed into a bf16 (36 x 68 x C) patch in shared memory; only
//   blocks on the frame's border zero the patch first.  The (K, O) bf16
//   weight matrix, packed once per weight version on the host
//   (ops/stem_cuda.py stem_matrix), is staged transposed, rows padded by
//   8 bf16 so the B fragments' rows fall in different banks.
// - Product: mma.sync m16n8k16 bf16 -> float32.  Each warp owns output rows
//   (two m tiles of 16 pixels each) and gathers its A fragments straight
//   from the patch: a pair (k, k + 1) with k even never crosses a tap row
//   (6 C is even) and lies at an even offset, so each A register is one
//   32-bit load, and the 8 pixels of a fragment are 12 B (image) or 4 B
//   (disparity) apart: no bank conflicts, no im2col tile.
// - Epilogue in registers: BN + SiLU in float32 (scale and bias from shared
//   memory) with act_fast (mma.cuh: two SFU operations, within one bf16
//   ulp of st_act), one bf16 rounding, bf16x2 words into a per-warp tile of
//   16 pixels x O (16-byte chunks XOR-swizzled by pixel, conflict-free),
//   then 16-byte stores in which neighbouring lanes write neighbouring
//   addresses (a tile row of 16 pixels is 16 O bytes contiguous).
//
// Widths: O is any multiple of 8 up to 80 that the launch switch lists
// (8, 16, 24, 32, 48, 64, 80: YOLOX nano to x).  A pixel holds CP = O / 8
// chunks.  The 8 pixels of one epilogue store must hit 8 different 16-byte
// bank groups: for CP a power of two the chunks are XOR-swizzled by pixel;
// an odd CP spreads them by itself (CP * px mod 8 is a permutation); an
// even CP that is no power of two (6, 10) gets a pixel pitch of CP + 1
// chunks, odd again.  The tile is read back in address order, so those
// reads are conflict-free whatever the layout.  At O = 80 the block needs
// 57 KB of shared memory, above the 48 KB a static allocation may take,
// so it is all dynamic.
//
// Accumulation: the tensor cores add the 16 products of one m16n8k16 step
// and the running sum with at least float32's precision per addition
// (products of bf16 operands are exact), so the sum over K differs from the
// plain version's float32 convolution by reassociation, bounded by
// 2 K 2^-24 sum|x w|; with the bf16 rounding, one bf16 ulp more (the
// tolerance of chip_smoke.py and tests/test_torch_port_cuda.py).
#include "mma.cuh"

namespace {

using namespace st_mma;

constexpr int TH = 16;    // output rows per block
constexpr int TW = 32;    // output cols per block: two m tiles per row
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PH = 2 * TH + 4;
constexpr int PW = 2 * TW + 4;

template <int C>
struct Dims {
  static constexpr int K = 36 * C;
  static constexpr int KP = (K + 15) / 16 * 16;
  static constexpr int KSTEPS = KP / 16;
  static constexpr int BPITCH = KP + 8;   // bf16 per transposed weight row
};

__device__ __forceinline__ bf16 preprocess(uint8_t v) {
  return __float2bfloat16_rn(static_cast<float>(v));
}

__device__ __forceinline__ bf16 preprocess(uint16_t r) {
  return r == 65535u ? __float2bfloat16_rn(0.0f)
                     : __float2bfloat16_rn(
                           __fdiv_rn(static_cast<float>(r), 16.0f));
}

// The per-warp output tile: 16 pixels of CP 16-byte chunks each, at a
// pitch of PITCH chunks per pixel; slot(px, j) is where chunk j of pixel px
// lies within its pixel, an involution, so slot(px, slot(px, j)) == j.
// The 8 pixels of one store instruction land in different bank groups.
template <int CP>
struct Tile {
  static constexpr bool POW2 = (CP & (CP - 1)) == 0;
  static constexpr int PITCH = (POW2 || CP % 2) ? CP : CP + 1;
  __device__ __forceinline__ static int slot(int px, int j) {
    return POW2 ? j ^ (((px * CP) >> 3) & (CP - 1)) : j;
  }
};

template <int C, int O>
struct Smem {
  using D = Dims<C>;
  static constexpr int PATCH = 0;
  static constexpr int WT = PATCH + (PH * PW * C * 2 + 15) / 16 * 16;
  static constexpr int TILE = WT + (O * D::BPITCH * 2 + 15) / 16 * 16;
  static constexpr int SB = TILE + WARPS * 16 * Tile<O / 8>::PITCH * 16;
  static constexpr int BYTES = SB + 2 * O * 4;
};

template <typename T, int C, int O>
__global__ void __launch_bounds__(THREADS)
focus_stem_kernel(const T* __restrict__ frame, int h, int w, int hout,
                  int wout, const bf16* __restrict__ wk,
                  const float* __restrict__ sb, bf16* __restrict__ out) {
  using D = Dims<C>;
  using L = Smem<C, O>;
  constexpr int CP = O / 8;   // 16-byte chunks per output pixel
  constexpr int NT = O / 8;   // n tiles
  constexpr int PITCH = Tile<CP>::PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* patch = reinterpret_cast<bf16*>(smem + L::PATCH);
  bf16* wt = reinterpret_cast<bf16*>(smem + L::WT);
  float* ssb = reinterpret_cast<float*>(smem + L::SB);
  uint4* tile = reinterpret_cast<uint4*>(smem + L::TILE) +
                (threadIdx.x >> 5) * 16 * PITCH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int y0 = 2 * oy0 - 2, x0 = 2 * ox0 - 2;
  frame += (size_t)blockIdx.z * h * w * C;
  out += (size_t)blockIdx.z * hout * wout * O;

  for (int i = tid; i < D::KP * O; i += THREADS)
    wt[(i % O) * D::BPITCH + i / O] = wk[i];
  for (int i = tid; i < 2 * O; i += THREADS) ssb[i] = sb[i];
  if (y0 < 0 || y0 + PH > h || x0 < 0 || x0 + PW > w) {
    for (int i = tid; i < PH * PW * C / 2; i += THREADS)
      reinterpret_cast<uint32_t*>(patch)[i] = 0u;
    __syncthreads();
  }
  // each patch row's in-image span [xa, xb) as aligned 16-byte words
  const int xa = max(x0, 0), xb = min(x0 + PW, w);
  constexpr int ES = sizeof(T);
  constexpr int WORDS = (PW * C * ES + 15) / 16 + 1;
  for (int i = tid; i < PH * WORDS && xa < xb; i += THREADS) {
    const int r = i / WORDS, y = y0 + r;
    if (y < 0 || y >= h) continue;
    const T* row = frame + (size_t)y * w * C;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row + xa * C);
    const uintptr_t hi = reinterpret_cast<uintptr_t>(row + xb * C);
    const uintptr_t a = (lo & ~static_cast<uintptr_t>(15)) + 16 * (i % WORDS);
    if (a >= hi) continue;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(a));
    const T* vals = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int e = 0; e < 16 / ES; ++e) {
      const uintptr_t ea = a + e * ES;
      if (ea < lo || ea >= hi) continue;
      const int idx = static_cast<int>(
          (ea - reinterpret_cast<uintptr_t>(row)) / ES);
      const int x = idx / C, c = idx - x * C;
      patch[(r * PW + x - x0) * C + c] = preprocess(vals[e]);
    }
  }
  __syncthreads();

  // this lane's A offsets in the patch for k = 16 ks + 2t (+ 8): tap row
  // uy = k / 6C, then (ux, c) contiguous; -1 past K (zero operand)
  const int g = lane >> 2, t = lane & 3;
  int koff[D::KSTEPS][2];
#pragma unroll
  for (int ks = 0; ks < D::KSTEPS; ++ks) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = ks * 16 + 2 * t + 8 * hh;
      koff[ks][hh] = k < D::K ? (k / (6 * C)) * PW * C + k % (6 * C) : -1;
    }
  }
  uint32_t* tw32 = reinterpret_cast<uint32_t*>(tile);

  for (int row = warp; row < TH; row += WARPS) {
    const int oy = oy0 + row;
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D::KSTEPS; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* p0 = patch + (2 * row * PW + 2 * (16 * i + g)) * C;
        const bf16* p1 = p0 + 16 * C;   // pixel g + 8
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = koff[ks][hh];
          a[i][2 * hh] =
              o < 0 ? 0u : *reinterpret_cast<const uint32_t*>(p0 + o);
          a[i][2 * hh + 1] =
              o < 0 ? 0u : *reinterpret_cast<const uint32_t*>(p1 + o);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* bp = wt + (j * 8 + g) * D::BPITCH + ks * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = j * 8 + 2 * t;
        const float s0 = ssb[n], s1 = ssb[n + 1];
        const float b0 = ssb[O + n], b1 = ssb[O + n + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int px = g + 8 * hh;
          tw32[(px * PITCH + Tile<CP>::slot(px, j)) * 4 + t] =
              pack_bf16x2(act_fast(acc[i][j][2 * hh], s0, b0),
                          act_fast(acc[i][j][2 * hh + 1], s1, b1));
        }
      }
      __syncwarp();
      for (int c = lane; c < 16 * PITCH; c += 32) {
        const int px = c / PITCH, sl = c - px * PITCH;
        const int ox = ox0 + 16 * i + px;
        if (sl < CP && oy < hout && ox < wout)
          reinterpret_cast<uint4*>(out + ((size_t)oy * wout + ox) *
                                   O)[Tile<CP>::slot(px, sl)] = tile[c];
      }
      __syncwarp();
    }
  }
}

template <typename T, int C, int O>
cudaError_t launch_o(const T* frame, dim3 grid, int h, int w, int hout,
                     int wout, const bf16* wk, const float* sb, bf16* out,
                     cudaStream_t stream) {
  constexpr int bytes = Smem<C, O>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      focus_stem_kernel<T, C, O>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  focus_stem_kernel<T, C, O><<<grid, THREADS, bytes, stream>>>(
      frame, h, w, hout, wout, wk, sb, out);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_c(const void* frame, int n, int h, int w, int hout,
                     int wout, int cout, const bf16* wk, const float* sb,
                     bf16* out, cudaStream_t stream) {
  dim3 grid((wout + TW - 1) / TW, (hout + TH - 1) / TH, n);
  const T* f = static_cast<const T*>(frame);
  switch (cout) {
#define ST_STEM_CASE(O_)                                                  \
  case O_:                                                                \
    return launch_o<T, C, O_>(f, grid, h, w, hout, wout, wk, sb, out, stream);
    ST_STEM_CASE(8)
    ST_STEM_CASE(16)
    ST_STEM_CASE(24)
    ST_STEM_CASE(32)
    ST_STEM_CASE(48)
    ST_STEM_CASE(64)
    ST_STEM_CASE(80)
#undef ST_STEM_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// frame: (n, h, w, 3) uint8 or (n, h, w) uint16; weight: (K padded, cout)
// bf16; sb: (2, cout) float32; out: (n, out_h/2, out_w/2, cout) bf16
ST_EXPORT int st_focus_stem(const void* frame, int is_disp, int n, int h,
                            int w, int out_h, int out_w, int cout,
                            const void* weight, const void* sb, void* out,
                            void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const int hout = out_h / 2, wout = out_w / 2;
  const bf16* wk = static_cast<const bf16*>(weight);
  const float* s = static_cast<const float*>(sb);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_disp)
    return launch_c<uint16_t, 1>(frame, n, h, w, hout, wout, cout, wk, s, o,
                                 st);
  return launch_c<uint8_t, 3>(frame, n, h, w, hout, wout, cout, wk, s, o, st);
}
