// One CSPDarknet stage evaluated for one GH x 16 region, every intermediate
// in shared memory, on wmma or scalar FMA GEMMs whose B fragments come
// straight from device memory.  The stage-1 probe's wmma and FMA variants
// (stage1.cu) run it; the production stage kernels run mma_chain.cuh, which
// computes the same chain with the same halo scheme and rounding points and
// takes the weight and dimension structs below.
//
// Stage: z = ConvBNAct 3x3 stride 2 (C_in -> C_out); main / short = ConvBNAct
// 1x1 (C_out -> mid, mid = C_out / 2); nb bottlenecks
// m = bf16(ConvBNAct3x3(ConvBNAct1x1(m)) + m); out = ConvBNAct 1x1 on
// [m | short] (2 mid -> C_out).  Each ConvBNAct accumulates in float32 and
// rounds to bf16 once (st_act), the rounding points of the Pallas kernels.
//
// Two template parameters choose the variant (the stage-1 probe A/Bs all
// four): the region height GH (16 or 8; the width is one wmma M tile, 16
// pixels) and the GEMMs' inner loop, WMMA (bf16 tensor cores, float32
// accumulate) or FMA (scalar float32 FMAs of the same bf16 operands).
//
// Halo: the region is the output tile plus nb rings.  z and main are exact
// on the whole region; each bottleneck 3x3 is evaluated on the whole region
// too, reading its input as a flat (pixel-major) array with the row offsets
// -17..+17, so a ring pixel reads a neighbour of the wrong row or a pad: the
// exact area shrinks by one ring per bottleneck and after nb of them is the
// tile (the Pallas kernels' shrinking-margin scheme).  conv1 outputs outside
// the image are zeroed first (the 3x3's SAME zero padding); the entry conv
// reads zeros outside the input.
//
// Shared memory: region A holds the entry conv's input patch, then main,
// short, conv1 and the next main once the patch is dead; region Z holds z,
// then the region's result; each warp owns a 16 x 16 float32 scratch tile
// for its accumulator epilogues.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace st_chain {

using namespace nvcuda;

constexpr int GW = 16;             // region width: one wmma M tile per row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WMMA = 0;            // GEMM inner loops
constexpr int FMA = 1;

template <int GH>
struct Geom {
  static constexpr int P = GH * GW;      // region pixels
  static constexpr int IH = 2 * GH + 1;  // entry conv input patch
  static constexpr int IW = 2 * GW + 1;
  static constexpr int PAD = GW + 1;     // flat pad (pixels) around conv1
};

struct StageDims {
  int cin, cout, mid, nb;
};

// Weights: bf16 (K, N) row-major matrices; folded BN: float32 [scale; bias].
// Field order of stage_weights() (ops/stage2_cuda.py).
struct StageWeightPtrs {
  const bf16 *entry_w, *ms_w, *c1_w, *c2_w, *fin_w;
  const float *entry_sb, *ms_sb, *c1_sb, *c2_sb, *fin_sb;
};

__host__ __device__ inline StageWeightPtrs weight_ptrs(const bf16* w,
                                                       const float* sb,
                                                       StageDims d) {
  StageWeightPtrs p;
  p.entry_w = w;  w += 9 * d.cin * d.cout;
  p.ms_w = w;     w += d.cout * 2 * d.mid;
  p.c1_w = w;     w += d.nb * d.mid * d.mid;
  p.c2_w = w;     w += d.nb * 9 * d.mid * d.mid;
  p.fin_w = w;
  p.entry_sb = sb;  sb += 2 * d.cout;
  p.ms_sb = sb;     sb += 4 * d.mid;
  p.c1_sb = sb;     sb += d.nb * 2 * d.mid;
  p.c2_sb = sb;     sb += d.nb * 2 * d.mid;
  p.fin_sb = sb;
  return p;
}

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

constexpr size_t SCRATCH_BYTES = WARPS * 256 * sizeof(float);
constexpr size_t MAX_SMEM = 232448;     // per block on sm_90

// Byte offsets of the shared-memory buffers of region_chain.
struct Layout {
  size_t in, z, m, s, c1, m2, scratch, extra, total;
};

template <int GH>
__host__ __device__ inline Layout layout(StageDims d, size_t extra_bytes) {
  using G = Geom<GH>;
  Layout L;
  const size_t e = sizeof(bf16);
  L.in = 0;
  L.m = 0;
  L.s = L.m + align128(G::P * d.mid * e);
  L.m2 = L.s + align128(G::P * d.mid * e);
  L.c1 = L.m2 + align128(G::P * d.mid * e);
  const size_t chain_end = L.c1 + align128((G::P + 2 * G::PAD) * d.mid * e);
  const size_t in_end = align128((size_t)G::IH * G::IW * d.cin * e);
  L.z = chain_end > in_end ? chain_end : in_end;
  L.scratch = L.z + align128(G::P * d.cout * e);
  L.extra = L.scratch + SCRATCH_BYTES;
  L.total = L.extra + align128(extra_bytes);
  return L;
}

// out[p, n] for p < 16 m_tiles, n < 16 n_tiles: a_ptr(mt, ks) is the
// 16 x 16 A block of k step ks (leading dimension lda), B the (K, N) weight
// matrix; epi(p, n, acc) consumes each float32 sum.  WMMA: the warps share
// (m tile, group of up to four n tiles) items, each accumulator goes out
// through the warp's scratch tile.  FMA: the warps share (m tile, n tile)
// items, each lane sums one row and eight columns in registers.
template <int INNER, class APtr, class Epi>
__device__ __forceinline__ void gemm(int m_tiles, int n_tiles, int k_steps,
                                     int lda, APtr a_ptr, const bf16* B,
                                     int ldb, float* scratch, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (INNER == WMMA) {
    const int groups = (n_tiles + 3) / 4;
    for (int item = warp; item < m_tiles * groups; item += WARPS) {
      const int mt = item / groups, nt0 = (item % groups) * 4;
      const int nn = min(4, n_tiles - nt0);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
      for (int ks = 0; ks < k_steps; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_ptr(mt, ks), lda);
        const bf16* brow = B + (size_t)ks * 16 * ldb + nt0 * 16;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nn) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                b;
            wmma::load_matrix_sync(b, brow + j * 16, ldb);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nn) {
          wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
          __syncwarp();
          for (int i = lane; i < 256; i += 32)
            epi(mt * 16 + i / 16, (nt0 + j) * 16 + i % 16, scratch[i]);
          __syncwarp();
        }
      }
    }
  } else {
    const int r = lane & 15, c0 = (lane >> 4) * 8;
    for (int item = warp; item < m_tiles * n_tiles; item += WARPS) {
      const int mt = item / n_tiles, nt = item % n_tiles;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
      for (int ks = 0; ks < k_steps; ++ks) {
        const bf16* a = a_ptr(mt, ks) + r * lda;
        const bf16* b = B + (size_t)ks * 16 * ldb + nt * 16 + c0;
#pragma unroll 4
        for (int kk = 0; kk < 16; ++kk) {
          const float av = st_f(a[kk]);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[j] = fmaf(av, st_f(b[kk * ldb + j]), acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) epi(mt * 16 + r, nt * 16 + c0 + j, acc[j]);
    }
  }
}

// Copies the IH x IW x c input patch of the NHWC map src (h, w, c) from
// pixel (y0, x0) into dst, pixel-major, 16-byte chunks; zeros outside the
// map.
template <int GH>
__device__ inline void load_patch(const bf16* __restrict__ src, int h, int w,
                                  int c, int y0, int x0, bf16* dst) {
  using G = Geom<GH>;
  const int c8 = c / 8;
  for (int i = threadIdx.x; i < G::IH * G::IW * c8; i += THREADS) {
    const int cc = (i % c8) * 8, p = i / c8;
    const int y = y0 + p / G::IW, x = x0 + p % G::IW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (y >= 0 && y < h && x >= 0 && x < w)
      v = *reinterpret_cast<const uint4*>(src + ((size_t)y * w + x) * c + cc);
    *reinterpret_cast<uint4*>(dst + (size_t)p * c + cc) = v;
  }
}

// z = ConvBNAct 3x3 stride 2 on the input patch `in` (IH x IW x cin): m tile
// = one region row, A rows two input pixels apart (lda = 2 cin).
template <int GH, int INNER>
__device__ inline void entry_conv(const bf16* in, StageDims d,
                                  const StageWeightPtrs& w, bf16* z,
                                  float* scratch) {
  using G = Geom<GH>;
  const int cin = d.cin, cout = d.cout, cpt = cin / 16;
  gemm<INNER>(GH, cout / 16, 9 * cpt, 2 * cin,
              [&](int mt, int ks) {
                const int tap = ks / cpt, c0 = (ks % cpt) * 16;
                return in + ((2 * mt + tap / 3) * G::IW + tap % 3) * cin + c0;
              },
              w.entry_w, cout, scratch, [&](int p, int n, float acc) {
                z[p * cout + n] =
                    st_act(acc, w.entry_sb[n], w.entry_sb[cout + n]);
              });
  __syncthreads();
}

// main | short (one 1x1 GEMM, N = 2 mid) over the region; epi(p, n, v)
// takes each bf16 result, n < mid main, n >= mid short.
template <int GH, int INNER, class Epi>
__device__ inline void main_short(const bf16* z, StageDims d,
                                  const StageWeightPtrs& w, float* scratch,
                                  Epi epi) {
  const int cout = d.cout, mid = d.mid;
  gemm<INNER>(Geom<GH>::P / 16, 2 * mid / 16, cout / 16, cout,
              [&](int mt, int ks) { return z + mt * 16 * cout + ks * 16; },
              w.ms_w, 2 * mid, scratch, [&](int p, int n, float acc) {
                epi(p, n, st_act(acc, w.ms_sb[n], w.ms_sb[2 * mid + n]));
              });
  __syncthreads();
}

// nb bottlenecks on the region's main m (ping-ponging with m2); c1_base
// holds (P + 2 PAD) x mid.  (oy0, ox0): the region's origin in the output
// (hout, wout).  Returns the buffer that holds the last main.
template <int GH, int INNER>
__device__ inline bf16* bottlenecks(bf16* m, bf16* m2, bf16* c1_base,
                                    StageDims d, const StageWeightPtrs& w,
                                    int oy0, int ox0, int hout, int wout,
                                    float* scratch) {
  using G = Geom<GH>;
  const int mid = d.mid;
  bf16* c1 = c1_base + G::PAD * mid;
  for (int i = threadIdx.x; i < G::PAD * mid; i += THREADS) {  // flat pads
    c1[i - G::PAD * mid] = __float2bfloat16_rn(0.0f);
    c1[G::P * mid + i] = __float2bfloat16_rn(0.0f);
  }
  for (int b = 0; b < d.nb; ++b) {
    const float* sb1 = w.c1_sb + b * 2 * mid;
    gemm<INNER>(G::P / 16, mid / 16, mid / 16, mid,
                [&](int mt, int ks) { return m + mt * 16 * mid + ks * 16; },
                w.c1_w + b * mid * mid, mid, scratch,
                [&](int p, int n, float acc) {
                  const int y = oy0 + p / GW, xx = ox0 + p % GW;
                  const bool inside =
                      y >= 0 && y < hout && xx >= 0 && xx < wout;
                  c1[p * mid + n] = inside ? st_act(acc, sb1[n], sb1[mid + n])
                                           : __float2bfloat16_rn(0.0f);
                });
    __syncthreads();
    const float* sb2 = w.c2_sb + b * 2 * mid;
    const int cpt = mid / 16;
    gemm<INNER>(G::P / 16, mid / 16, 9 * cpt, mid,
                [&](int mt, int ks) {
                  const int tap = ks / cpt, c0 = (ks % cpt) * 16;
                  const int off = (tap / 3 - 1) * GW + tap % 3 - 1;
                  return c1 + (mt * 16 + off) * mid + c0;
                },
                w.c2_w + b * 9 * mid * mid, mid, scratch,
                [&](int p, int n, float acc) {
                  const float v = st_f(st_act(acc, sb2[n], sb2[mid + n]));
                  m2[p * mid + n] =
                      __float2bfloat16_rn(v + st_f(m[p * mid + n]));
                });
    __syncthreads();
    bf16* t = m;
    m = m2;
    m2 = t;
  }
  return m;
}

// final 1x1 on [m | s] over the region; epi(p, n, v) takes each bf16 result.
template <int GH, int INNER, class Epi>
__device__ inline void final_conv(const bf16* m, const bf16* s, StageDims d,
                                  const StageWeightPtrs& w, float* scratch,
                                  Epi epi) {
  const int mid = d.mid, cout = d.cout, cpt = mid / 16;
  gemm<INNER>(Geom<GH>::P / 16, cout / 16, 2 * cpt, mid,
              [&](int mt, int ks) {
                return ks < cpt ? m + mt * 16 * mid + ks * 16
                                : s + mt * 16 * mid + (ks - cpt) * 16;
              },
              w.fin_w, cout, scratch, [&](int p, int n, float acc) {
                epi(p, n, st_act(acc, w.fin_sb[n], w.fin_sb[cout + n]));
              });
  __syncthreads();
}

// Evaluates the stage on the region whose output origin is (oy0, ox0) (the
// tile starts nb rings further in) and leaves the region's result in
// `result` as P x cout bf16 (exact on the centre tile).  x: (hin, win, cin)
// bf16 NHWC in device memory; (hout, wout) = (hin / 2, win / 2).  All
// threads of the block must call it; channel counts are multiples of 16.
template <int GH, int INNER>
__device__ inline void region_chain(const bf16* __restrict__ x, int hin,
                                    int win, int hout, int wout,
                                    StageDims d, const StageWeightPtrs& w,
                                    int oy0, int ox0, unsigned char* smem,
                                    const Layout& L, bf16* result) {
  const int mid = d.mid, cout = d.cout;
  bf16* in = reinterpret_cast<bf16*>(smem + L.in);
  bf16* z = reinterpret_cast<bf16*>(smem + L.z);
  bf16* m = reinterpret_cast<bf16*>(smem + L.m);
  bf16* s = reinterpret_cast<bf16*>(smem + L.s);
  bf16* m2 = reinterpret_cast<bf16*>(smem + L.m2);
  bf16* c1 = reinterpret_cast<bf16*>(smem + L.c1);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) +
                   (threadIdx.x >> 5) * 256;

  load_patch<GH>(x, hin, win, d.cin, 2 * oy0 - 1, 2 * ox0 - 1, in);
  __syncthreads();
  entry_conv<GH, INNER>(in, d, w, z, scratch);
  main_short<GH, INNER>(z, d, w, scratch, [&](int p, int n, bf16 v) {
    if (n < mid) m[p * mid + n] = v;
    else s[p * mid + n - mid] = v;
  });
  m = bottlenecks<GH, INNER>(m, m2, c1, d, w, oy0, ox0, hout, wout, scratch);
  final_conv<GH, INNER>(m, s, d, w, scratch, [&](int p, int n, bf16 v) {
    result[p * cout + n] = v;
  });
}

}  // namespace st_chain
