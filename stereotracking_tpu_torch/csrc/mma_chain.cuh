// One CSPDarknet stage on one GH x 16 region, every intermediate in shared
// memory, on mma.sync tensor cores with the weights streamed through a
// shared-memory ring.  Stages 1, 2 and 3 run it (stage1.cu, stage2.cu,
// stage3.cu); it computes what csp_chain.cuh's region_chain computes (same
// stage, same halo scheme, same rounding points), whose WMMA and FMA paths
// the stage-1 probe's other variants keep.
//
// Region: GH x 16 pixels, GH in {16, 8} (P = GH * 16 pixels, GH m tiles of
// 16, MT = GH / 8 per warp): the output tile plus nb halo rings, conv1
// zeroed outside the image, the 3x3s reading the flat pixel-major buffer
// with row offsets -17..+17 (see csp_chain.cuh).
//
// The stage is split at the seam of stage 3's two launches: entry_part (the
// input patch, the entry 3x3 s2, main|short) and chain_part (conv1's pads,
// the nb bottlenecks, the final 1x1, whose words go to an epilogue the
// caller gives).  Stages 1 and 2 run both parts in one block.
//
// GEMMs (entry 3x3 s2, main|short, per block conv1 and conv2, final): each
// walks N in passes of up to SLICE columns and K in slices of up to SLICE
// rows.  Each warp keeps its (16 MT) x 64 share of a pass's accumulators in
// registers (32 MT float32) over the whole K walk.
// - Weights: the host packs every GEMM's (K, N) matrix as zero-padded
//   SLICE x SLICE tiles in run order (ops/stage2_cuda.py pack_slices), one
//   stream of slices for the whole chain.  All threads copy the slices with
//   cp.async into a STAGES-deep ring; slice s + STAGES - 1 (of this GEMM or
//   the next) is in flight while slice s is multiplied, so each weight byte
//   leaves L2 once per region and nothing waits on it in series.  A pipe
//   may start at any slice of the stream (make_pipe), so a launch that runs
//   only part of the chain streams only its slices.
// - Operands: ldmatrix from shared memory, .trans for the row-major (k, n)
//   slices.  Every buffer is pixel-major in 16-byte channel chunks, laid
//   out so that the 8 rows of an ldmatrix, and the 8 pixels of an epilogue
//   store, fall in different banks (swz): at 4 chunks a pixel or a multiple
//   of 8 (the flagship's widths) the chunks are XOR-swizzled by pixel index
//   (by pixel / 2 in the entry conv's input patch, whose A rows are two
//   pixels apart); at 2, 3, 6 or 12 chunks (YOLOX-nano's and -tiny's
//   widths, where an XOR would leave the pixel) a pixel takes an odd
//   number of chunks, nch | 1, unswizzled, and the input patch keeps each
//   row's even columns before its odd ones, so the entry conv's A rows are
//   consecutive.  Both are functions of the absolute pixel index, so the
//   shifted 3x3 views still read the right chunks.
// - K steps of 16 channels: at an even chunk count a step lies in one tap
//   (or in main or short); at C = 24 (K = 24 and 216 GEMMs) each lane reads
//   its own chunk k8 = 2 ks + lane / 16 (tap_chunk), so a step may straddle
//   two taps or [main | short].  A lane past K reads a zeroed chunk
//   (L.zero), against the zero rows pack_slices pads K with: zeros add
//   exactly.
// - Epilogue in registers: folded BN + SiLU (act_fast) with the pass's
//   scale and bias held in registers, one bf16 rounding, bf16x2 words
//   straight into the destination buffer (the residual of conv2 read the
//   same way).
#pragma once

#include "csp_chain.cuh"
#include "mma.cuh"

namespace st_mma_chain {

using namespace st_mma;
using st_chain::align128;
using st_chain::StageDims;
using st_chain::StageWeightPtrs;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GW = 16;                     // region width: one m tile
constexpr int PAD = GW + 1;                // flat pad (pixels) around conv1
constexpr int SLICE = 64;                  // weight slice: SLICE k x SLICE n
constexpr int SLICE_BYTES = SLICE * SLICE * 2;
// ring depth: slice s + 1 is copied while slice s is multiplied; a third
// slot measured 5% slower (tools/ablate_kernels.py, ring3)
constexpr int STAGES = 2;

template <int GH>
struct Region {
  static_assert(GH == 16 || GH == 8, "regions are 16 or 8 rows high");
  static constexpr int P = GH * GW;                     // region pixels
  static constexpr int IH = 2 * GH + 1, IW = 2 * GW + 1;   // input patch
  static constexpr int MT = GH / WARPS;                 // m tiles per warp
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int gemm_slices(int k, int n) {
  return cdiv(k, SLICE) * cdiv(n, SLICE);
}

// slices of the entry part (entry conv, main|short), in pack_slices order:
// the chain part's first slice
__host__ __device__ inline int entry_slices(StageDims d) {
  return gemm_slices(9 * d.cin, d.cout) + gemm_slices(d.cout, 2 * d.mid);
}

// slices of the whole chain, in pack_slices order
__host__ __device__ inline int chain_slices(StageDims d) {
  return entry_slices(d) +
         d.nb * (gemm_slices(d.mid, d.mid) + gemm_slices(9 * d.mid, d.mid)) +
         gemm_slices(2 * d.mid, d.cout);
}

// A buffer of `chans` channels a pixel (a multiple of 8: chans / 8 chunks of
// 16 bytes) is XOR-swizzled at 4 chunks a pixel or a multiple of 8, else
// padded to an odd pitch of (chans / 8) | 1 chunks: either way 8
// consecutive pixels' chunk ch lie in 8 different 16-byte bank groups (at
// 4 chunks, 2 apart: the flagship's layout, kept as it was).
__host__ __device__ constexpr bool xor_layout(int chans) {
  return chans / 8 == 4 || (chans / 8) % 8 == 0;
}

__host__ __device__ constexpr int pitch_bytes(int chans) {
  return 16 * (xor_layout(chans) ? chans / 8 : (chans / 8) | 1);
}

// The stage's widths leave K of some GEMM off a multiple of 16 (C = 24):
// its A reads past K come from a zeroed chunk.
__host__ __device__ inline bool ragged_k(StageDims d) {
  return d.cin % 16 != 0 || d.mid % 16 != 0;
}

// Byte offsets of the shared-memory buffers: `in` (the entry conv's input
// patch) is dead once z exists, and m, s, m2 and c1 reuse its bytes; `zero`
// (16 bytes after the ring, where ragged_k) is the zeroed chunk; `extra`
// (extra_bytes after it) is the caller's.
struct Layout {
  size_t in, z, m, s, m2, c1, ring, zero, extra, total;
};

template <int GH>
__host__ __device__ inline Layout layout(StageDims d, size_t extra_bytes = 0) {
  using R = Region<GH>;
  Layout L;
  const size_t pm = pitch_bytes(d.mid);
  L.in = 0;
  L.m = 0;
  L.s = L.m + align128(R::P * pm);
  L.m2 = L.s + align128(R::P * pm);
  L.c1 = L.m2 + align128(R::P * pm);
  const size_t chain_end = L.c1 + align128((R::P + 2 * PAD) * pm);
  const size_t in_end =
      align128((size_t)R::IH * R::IW * pitch_bytes(d.cin));
  L.z = chain_end > in_end ? chain_end : in_end;
  L.ring = L.z + align128(R::P * pitch_bytes(d.cout));
  L.zero = L.ring + STAGES * SLICE_BYTES;
  L.extra = L.zero + (ragged_k(d) ? 128 : 0);
  L.total = L.extra + align128(extra_bytes);
  return L;
}

// Byte offset of channel chunk ch (8 channels) of pixel p in a buffer of
// CHANS channels per pixel: XOR layouts XOR the chunk index with the key's
// low bits, odd-pitch layouts ignore the key.
template <int CHANS>
__device__ __forceinline__ uint32_t swz(int p, int ch, int key) {
  constexpr int nch = CHANS / 8;
  if constexpr (xor_layout(CHANS)) {
    constexpr int mask = (nch < 8 ? nch : 8) - 1;
    return static_cast<uint32_t>(p * CHANS * 2 + ((ch ^ (key & mask)) << 4));
  } else {
    return static_cast<uint32_t>(p * pitch_bytes(CHANS) + (ch << 4));
  }
}

// Byte offset of channel n (even) of pixel p: the bf16x2 word (n, n + 1).
template <int CHANS>
__device__ __forceinline__ uint32_t swz_word(int p, int n) {
  return swz<CHANS>(p, n >> 3, p) + (n & 7) * 2;
}

// Byte offset of chunk ch of the input patch's pixel (py, px), IW pixels a
// row: XOR layouts number the pixels row-major and swizzle by index / 2;
// odd-pitch layouts keep each row's even columns, then its odd ones, so the
// entry conv's A rows (columns two apart) are consecutive pixels.
template <int CIN, int IW>
__device__ __forceinline__ uint32_t patch_off(int py, int px, int ch) {
  if constexpr (xor_layout(CIN)) {
    const int p = py * IW + px;
    return swz<CIN>(p, ch, p >> 1);
  } else {
    const int q = py * IW + ((px & 1) ? (IW + 1) / 2 + (px >> 1) : px >> 1);
    return swz<CIN>(q, ch, 0);
  }
}

__device__ __forceinline__ uint32_t* smem_word(unsigned char* smem,
                                               size_t off) {
  return reinterpret_cast<uint32_t*>(smem + off);
}

// The tap and the chunk (of NCH in a tap) of this lane's A chunk k8 = 2 ks
// + lc at k step ks of a GEMM whose K is taps x NCH chunks: for an even
// NCH a step stays in one tap, uniform over the lanes (the flagship's
// form); for an odd NCH (C = 24) the lanes' chunks may straddle two taps.
template <int NCH>
__device__ __forceinline__ int2 tap_chunk(int ks, int lc) {
  if constexpr (NCH % 2 == 0) {
    return make_int2(ks / (NCH / 2), (ks % (NCH / 2)) * 2 + lc);
  } else {
    const int k8 = 2 * ks + lc;
    return make_int2(k8 / NCH, k8 % NCH);
  }
}

// The zeroed chunk, where the stage's K is ragged; ordered before any read
// by the barrier of the GEMM's first slice.  All threads call it.
template <int C>
__device__ __forceinline__ void zero_chunk(unsigned char* smem,
                                           const Layout& L) {
  if constexpr (C % 16 != 0) {
    if (threadIdx.x < 4) *smem_word(smem, L.zero + 4 * threadIdx.x) = 0u;
  }
}

// The ring of weight slices, fed from the packed stream `src`.
struct Pipe {
  const bf16* src;
  uint32_t ring;      // shared address of the ring
  int total;          // slices in the stream
  int issued;
  int cur;

  // copy slice `issued` into its ring slot (rows 128 B apart, 16-byte
  // chunks XOR-swizzled by row); commit a group even past the end so that
  // the group count stays in step
  __device__ __forceinline__ void issue() {
    if (issued < total) {
      const bf16* s = src + (size_t)issued * SLICE * SLICE;
      const uint32_t dst = ring + (issued % STAGES) * SLICE_BYTES;
      for (int i = threadIdx.x; i < SLICE * SLICE / 8; i += THREADS) {
        const int k = i >> 3, c = i & 7;
        cp_async16(dst + k * 128 + ((c ^ (k & 7)) << 4), s + i * 8, 16);
      }
    }
    cp_async_commit();
    ++issued;
  }

  // the first STAGES - 1 slices, after the caller's own copies
  __device__ __forceinline__ void start() {
    for (int s = 0; s < STAGES - 1; ++s) issue();
  }

  // Wait for slice `cur` (and everything before it), make it visible to the
  // block, start the copy of slice cur + STAGES - 1 into the slot that
  // every warp finished with before this barrier, and return cur's slot.
  __device__ __forceinline__ uint32_t next() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue();
    return ring + (cur++ % STAGES) * SLICE_BYTES;
  }
};

// A pipe over slices [first, first + count) of the packed stream ws, its
// ring at the shared address `ring`.
__device__ __forceinline__ Pipe make_pipe(const bf16* ws, int first,
                                          int count, uint32_t ring) {
  return Pipe{ws + (size_t)first * SLICE * SLICE, ring, count, 0, 0};
}

// out = A (P x K) * W (K x N) over the region, the weights from the pipe.
// a_addr(mt, ks): shared address of this lane's ldmatrix row of m tile mt
// at k step ks (16 k), lane l giving row l % 16, k chunk l / 16.
// sb: [scale (N); bias (N)].  epi(p, n, v): the bf16x2 word v of columns
// (n, n + 1) of pixel p after BN + SiLU and the bf16 rounding.  MT, K and N
// are compile-time, so a full slice (K, N multiples of SLICE) runs
// unguarded.  K and N are multiples of 8: a last K step of 8 reads the
// zero rows the slices are padded with (and a_addr's zeroed chunk); an odd
// count of n tiles computes one more from the zero columns and drops it.
template <int MT, int K, int N, class AAddr, class Epi>
__device__ __forceinline__ void gemm(Pipe& pipe, const float* __restrict__ sb,
                                     AAddr a_addr, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mt0 = MT * warp;
  for (int n0 = 0; n0 < N; n0 += SLICE) {
    const int nt = N % SLICE == 0 ? 8 : min(SLICE, N - n0) / 8;
    float acc[MT][8][4];
    float2 sc[8], bi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
      }
      if (j < nt) {
        sc[j] = *reinterpret_cast<const float2*>(sb + n0 + 8 * j + 2 * t);
        bi[j] = *reinterpret_cast<const float2*>(sb + N + n0 + 8 * j + 2 * t);
      }
    }
    for (int k0 = 0; k0 < K; k0 += SLICE) {
      const uint32_t slot = pipe.next();
      const int ksn = K % SLICE == 0 ? 4 : cdiv(min(SLICE, K - k0), 16);
#pragma unroll
      for (int kk = 0; kk < SLICE / 16; ++kk) {
        if (kk < ksn) {
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            ldmatrix_x4(a[i], a_addr(mt0 + i, k0 / 16 + kk));
          const int kr = kk * 16 + (lane & 15);
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (2 * jp < nt) {
              uint32_t b[4];
              ldmatrix_x4_trans(
                  b, slot + kr * 128 + (((2 * jp + (lane >> 4)) ^ (kr & 7))
                                        << 4));
#pragma unroll
              for (int i = 0; i < MT; ++i)
                mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
#pragma unroll
              for (int i = 0; i < MT; ++i)
                mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = (mt0 + i) * 16 + g + 8 * hh;
            epi(p, n0 + 8 * j + 2 * t,
                pack_bf16x2(
                    act_fast(acc[i][j][2 * hh], sc[j].x, bi[j].x),
                    act_fast(acc[i][j][2 * hh + 1], sc[j].y, bi[j].y)));
          }
        }
      }
    }
  }
}

// Epilogue of main|short into the m and s buffers (C channels each).
template <int C>
__device__ __forceinline__ auto to_main_short(unsigned char* smem,
                                              const Layout& L) {
  return [smem, &L](int p, int n, uint32_t v) {
    *smem_word(smem, n < C ? L.m + swz_word<C>(p, n)
                           : L.s + swz_word<C>(p, n - C)) = v;
  };
}

// Epilogue into the swizzled buffer at byte offset `off`, `chans` channels.
template <int CHANS>
__device__ __forceinline__ auto to_buffer(unsigned char* smem, size_t off) {
  return [smem, off](int p, int n, uint32_t v) {
    *smem_word(smem, off + swz_word<CHANS>(p, n)) = v;
  };
}

// The stage's first two GEMMs (C_in = mid = C, C_out = 2 C) on the region
// whose output origin is (oy0, ox0): the input patch (zeros outside the map)
// from x, (hin, win, C) bf16 NHWC in device memory; the entry 3x3 stride 2
// into z; main | short, each bf16x2 word handed to ms(p, n, v) (n < C main,
// n >= C short) once every warp is past the entry GEMM, so it may write
// into the patch's bytes.  Starts `pipe`, whose first slices are the entry
// GEMM's.  w: the scale/bias pointers.  All threads call it.
template <int GH, int C, class MsEpi>
__device__ inline void entry_part(Pipe& pipe, const bf16* __restrict__ x,
                                  int hin, int win, const StageWeightPtrs& w,
                                  int oy0, int ox0, unsigned char* smem,
                                  const Layout& L, MsEpi ms) {
  using R = Region<GH>;
  constexpr int CIN = C, COUT = 2 * C, IW = R::IW;
  const int lane = threadIdx.x & 31, lr = lane & 15, lc = lane >> 4;
  const uint32_t base = smem_u32(smem);
  const uint32_t in_s = base + L.in, z_s = base + L.z, zero_s = base + L.zero;

  // the input patch (zeros outside the map), then the first slices
  constexpr int C8 = CIN / 8;
  const int y0 = 2 * oy0 - 1, x0 = 2 * ox0 - 1;
  for (int i = threadIdx.x; i < R::IH * IW * C8; i += THREADS) {
    const int ch = i % C8, p = i / C8;
    const int y = y0 + p / IW, xx = x0 + p % IW;
    const bool ok = y >= 0 && y < hin && xx >= 0 && xx < win;
    cp_async16(in_s + (xor_layout(CIN) ? swz<CIN>(p, ch, p >> 1)
                                       : patch_off<CIN, IW>(p / IW, p % IW,
                                                            ch)),
               ok ? x + ((size_t)y * win + xx) * CIN + ch * 8 : x,
               ok ? 16 : 0);
  }
  cp_async_commit();
  zero_chunk<C>(smem, L);
  pipe.start();

  // z = entry 3x3 stride 2: m tile = one region row, rows two pixels apart
  gemm<R::MT, 9 * CIN, COUT>(
      pipe, w.entry_sb,
      [&](int mt, int ks) {
        if constexpr (C % 16 != 0) {
          if (2 * ks + lc >= 9 * C8) return zero_s;
        }
        const int2 tc = tap_chunk<C8>(ks, lc);
        return in_s + patch_off<CIN, IW>(2 * mt + tc.x / 3,
                                         2 * lr + tc.x % 3, tc.y);
      },
      to_buffer<COUT>(smem, L.z));
  // main | short
  gemm<R::MT, COUT, 2 * C>(
      pipe, w.ms_sb,
      [&](int mt, int ks) {
        const int p = mt * 16 + lr;
        return z_s + swz<COUT>(p, 2 * ks + lc, p);
      },
      ms);
}

// The rest of the stage on the region whose output origin is (oy0, ox0),
// (hout, wout) the output map: conv1's flat pads, the nb bottlenecks on main
// (L.m, ping-ponging with L.m2, conv1 into L.c1), then before_final() (all
// threads), then the final 1x1 on [main | short (L.s)], each bf16x2 word
// handed to fin(p, n, v).  The pipe must be at the first bottleneck's
// slices.  Ends with a barrier.  All threads call it.
template <int GH, int C, class BeforeFinal, class FinEpi>
__device__ inline void chain_part(Pipe& pipe, int nb, int hout, int wout,
                                  const StageWeightPtrs& w, int oy0, int ox0,
                                  unsigned char* smem, const Layout& L,
                                  BeforeFinal before_final, FinEpi fin) {
  using R = Region<GH>;
  constexpr int MID = C, COUT = 2 * C, M8 = MID / 8;
  constexpr int PB = pitch_bytes(MID);
  const int lane = threadIdx.x & 31, lr = lane & 15, lc = lane >> 4;
  const uint32_t base = smem_u32(smem);
  const uint32_t s_s = base + L.s, c1_s = base + L.c1, zero_s = base + L.zero;

  // conv1's flat pads: nothing reads these bytes any more (every warp is
  // past main|short's first barrier), and the barrier of the next GEMM
  // orders these stores before the first conv2 reads them
  for (int i = threadIdx.x; i < PAD * PB / 4; i += THREADS) {
    *smem_word(smem, L.c1 + i * 4) = 0u;
    *smem_word(smem, L.c1 + (size_t)(PAD + R::P) * PB + i * 4) = 0u;
  }
  zero_chunk<C>(smem, L);

  size_t m = L.m, m2 = L.m2;
  for (int b = 0; b < nb; ++b) {
    const uint32_t m_s = base + m;
    gemm<R::MT, MID, MID>(
        pipe, w.c1_sb + b * 2 * MID,
        [&](int mt, int ks) {
          const int p = mt * 16 + lr, k8 = 2 * ks + lc;
          if constexpr (C % 16 != 0) {
            if (k8 >= M8) return zero_s;
          }
          return m_s + swz<MID>(p, k8, p);
        },
        [&](int p, int n, uint32_t v) {
          const int y = oy0 + p / GW, xx = ox0 + p % GW;
          const bool inside = y >= 0 && y < hout && xx >= 0 && xx < wout;
          *smem_word(smem, L.c1 + swz_word<MID>(p + PAD, n)) =
              inside ? v : 0u;
        });
    gemm<R::MT, 9 * MID, MID>(
        pipe, w.c2_sb + b * 2 * MID,
        [&](int mt, int ks) {
          if constexpr (C % 16 != 0) {
            if (2 * ks + lc >= 9 * M8) return zero_s;
          }
          const int2 tc = tap_chunk<M8>(ks, lc);
          const int q =
              mt * 16 + lr + (tc.x / 3 - 1) * GW + tc.x % 3 - 1 + PAD;
          return c1_s + swz<MID>(q, tc.y, q);
        },
        [&](int p, int n, uint32_t v) {
          const uint32_t r = *smem_word(smem, m + swz_word<MID>(p, n));
          *smem_word(smem, m2 + swz_word<MID>(p, n)) = pack_bf16x2(
              __float2bfloat16_rn(st_f(lo_bf16(v)) + st_f(lo_bf16(r))),
              __float2bfloat16_rn(st_f(hi_bf16(v)) + st_f(hi_bf16(r))));
        });
    const size_t tmp = m;
    m = m2;
    m2 = tmp;
  }
  before_final();
  // final 1x1 on [m | s]: K = 2 MID chunks, taps m and s
  const uint32_t m_s = base + m;
  gemm<R::MT, 2 * MID, COUT>(
      pipe, w.fin_sb,
      [&](int mt, int ks) {
        const int p = mt * 16 + lr;
        if constexpr (M8 % 2 == 0) {
          constexpr int MPT = M8 / 2;
          return ks < MPT ? m_s + swz<MID>(p, 2 * ks + lc, p)
                          : s_s + swz<MID>(p, 2 * (ks - MPT) + lc, p);
        } else {
          const int2 tc = tap_chunk<M8>(ks, lc);
          return (tc.x == 0 ? m_s : s_s) + swz<MID>(p, tc.y, p);
        }
      },
      fin);
  __syncthreads();
}

// Copies the centre tile (th x tw, e rings in) of the region result in the
// swizzled buffer at byte offset `off` (CH channels per pixel) to the NHWC
// output (hout, wout, CH) at (oy0, ox0), 16-byte chunks, clipped.
template <int CH>
__device__ inline void store_tile(const unsigned char* smem, size_t off,
                                  int e, int th, int tw, int oy0, int ox0,
                                  int hout, int wout,
                                  bf16* __restrict__ out) {
  constexpr int c8 = CH / 8;
  for (int i = threadIdx.x; i < th * tw * c8; i += THREADS) {
    const int ch = i % c8, p = i / c8;
    const int ty = p / tw, tx = p % tw;
    const int y = oy0 + ty, xx = ox0 + tx, rp = (ty + e) * GW + tx + e;
    if (y < hout && xx < wout)
      *reinterpret_cast<uint4*>(out + ((size_t)y * wout + xx) * CH + ch * 8) =
          *reinterpret_cast<const uint4*>(smem + off + swz<CH>(rp, ch, rp));
  }
}

// The whole stage in one block per GH x 16 region (a (GH - 2 nb) x
// (16 - 2 nb) output tile): entry_part, chain_part, the tile stored; x and
// out at stream blockIdx.z.  Stage 2, and stage 3 at C = 64.
template <int GH, int C>
__device__ inline void fused_stage(const bf16* __restrict__ x, int hin,
                                   int win, StageDims d,
                                   const bf16* __restrict__ ws,
                                   const float* __restrict__ sb,
                                   bf16* __restrict__ out,
                                   unsigned char* smem) {
  const int hout = hin / 2, wout = win / 2;
  const int e = d.nb, th = GH - 2 * e, tw = GW - 2 * e;
  const Layout L = layout<GH>(d);
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * tw;
  x += (size_t)blockIdx.z * hin * win * C;
  out += (size_t)blockIdx.z * hout * wout * 2 * C;
  const StageWeightPtrs w = st_chain::weight_ptrs(ws, sb, d);
  Pipe pipe = make_pipe(ws, 0, chain_slices(d), smem_u32(smem) + L.ring);
  entry_part<GH, C>(pipe, x, hin, win, w, oy0 - e, ox0 - e, smem, L,
                    to_main_short<C>(smem, L));
  chain_part<GH, C>(pipe, d.nb, hout, wout, w, oy0 - e, ox0 - e, smem, L,
                    [] {}, to_buffer<2 * C>(smem, L.z));
  store_tile<2 * C>(smem, L.z, e, th, tw, oy0, ox0, hout, wout, out);
}

}  // namespace st_mma_chain
