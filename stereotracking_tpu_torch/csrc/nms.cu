// Greedy NMS keep set of S streams' score-sorted candidates in one launch:
// a suppression bitmask, then a word-level scan per stream that stops once
// max_keep candidates are kept.
//
// Replaces: stereotracking_tpu/ops/nms.py, batched_nms (line 31), the
// fixed-point suppression loop (lines 62-85) that the JAX package runs on
// the device as a lax.while_loop over a dense (k, k) IoU matrix.  It is
// not a Pallas kernel: it is XLA device code of the detector's
// post-processing, which the port ran as dense passes with a host check
// of the fixed point every 8 passes.
//
// What it computes, for each stream s and its k candidates in descending
// score order (boxes already shifted by their class offset, as the plain
// path shifts them): keep[j] = finite[j] and no kept i < j has
// iou(i, j) > thr, for the first max_keep such j; every candidate after
// the max_keep-th kept one is not kept.  Without the cap that is the
// unique fixed point of the plain version's recurrence keep = ~any(sup &
// keep), sup[i, j] = iou > thr & i < j & finite[i] & finite[j], which
// greedy order reaches in one pass; greedy order decides candidate j from
// the candidates before it alone, so the capped set is the first max_keep
// of the full one.
//   1. mask: mask[s][i][w] bit b = sup[i, 64 w + b] for the words w >= i /
//      64 (the scan reads no word left of the diagonal, and none is
//      written).  One block per 64 rows x 4 words, one thread per (row,
//      word), the 256 column boxes staged in shared memory.  A thread
//      first computes, with selects and no branch, which of its 64 pairs
//      intersect at all; only those (and pairs with a non-finite box) go
//      through the full IoU and its division, one at a time.
//   2. scan: the last block of a stream to finish (a per-stream ticket
//      after a __threadfence) resolves the candidates 64 at a time with
//      one warp.  Lane l holds word l of the removed set and of the finite
//      set.  For word w: live = finite & ~removed (one shuffle from lane
//      w); the word's diagonal 64 x 64 block resolves as the fixed point
//      of kept = live & ~(OR of the kept rows' diagonal words), each pass
//      two warp OR-reductions over the rows the lanes hold, as many passes
//      as the longest chain of suppressions inside the word, plus one (one
//      pass where nothing in the word suppresses); then each lane l > w
//      ORs word l of the kept rows into its removed word, 8 rows' loads in
//      flight at a time.  Row block w + 1 (64 rows x the words >= w + 1,
//      at most 16 KB) is copied into shared memory with cp.async while
//      word w resolves.
// The IoU is bbox_iou_matrix's (structures/bbox.py) operation for
// operation, each float op rounded on its own (_rn intrinsics) and
// max / min / clamp propagating NaN as torch's do, so each
// iou > thr decision is the plain version's bit for bit.  The first pass
// gives the same decision with fewer instructions: where both boxes have
// finite coordinates and areas, min / max / clamp meet no NaN, so they are
// the plain fminf / fmaxf, and an intersection of +-0 (with a union that
// is a number) makes the IoU +-0 and the decision 0 > thr; a NaN
// intersection (inf * 0) goes to the full IoU.
//
// What bounds it on an H100: instruction issue in the mask, latency in
// the scan.  The mask is k^2 / 2 IoUs a stream (2.1 M; 16.8 M at 8
// streams), ~15-25 instructions each (12 of them float32 operations), and
// k^2 / 8 bytes (4 MB at 8 streams) that stay in L2 for the scan.  The
// scan's dependent chain per stream is at most ceil(k / 64) word steps
// (32 at k = 2048); with the cap (max_out = 300 on the main path) it ends
// after ~5 words.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int WORD = 64;       // columns per mask word
constexpr int MAX_WORDS = 32;  // one scanning warp: k <= 2048
constexpr int QW = 4;          // column words per mask block
constexpr int THREADS = WORD * QW;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// bbox_iou_matrix's IoU of boxes a and b, with their areas, > thr.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float eps,
                                           float thr) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)),
                          0.0f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)),
                          0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = max_nan(__fsub_rn(__fadd_rn(area_a, area_b), inter), eps);
  return __fdiv_rn(inter, uni) > thr;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// bit 0: a finite candidate; bit 1: its coordinates and area are finite
__device__ __forceinline__ unsigned char box_flags(float4 b, float a,
                                                   unsigned char fin) {
  const bool ok = isfinite(b.x) && isfinite(b.y) && isfinite(b.z) &&
                  isfinite(b.w) && isfinite(a);
  return static_cast<unsigned char>((fin ? 1 : 0) | (ok ? 2 : 0));
}

// Mask words per row: the words rounded up to even, so that every pair of
// words from an even index on is one aligned 16-byte copy.
__host__ __device__ __forceinline__ int mask_stride(int words) {
  return words + (words & 1);
}

// Mask blocks of a stream: row block rb covers the column groups of 4
// words from the one holding word rb on.
__host__ __device__ __forceinline__ int mask_blocks(int words) {
  const int groups = (words + QW - 1) / QW;
  int total = 0;
  for (int rb = 0; rb < words; ++rb) total += groups - rb / QW;
  return total;
}

// One warp scans stream s: ms its mask (k rows of ``wst`` words), fs its
// finite flags, keep its output; buf two row-block buffers.
__device__ void scan(const unsigned long long* __restrict__ ms, int wst,
                     const unsigned char* __restrict__ fs, int k, int cap,
                     unsigned char* __restrict__ keep,
                     unsigned long long (*buf)[WORD][MAX_WORDS]) {
  const int lane = threadIdx.x;
  const int words = (k + WORD - 1) / WORD;
  // row block rb into buf[rb & 1]: rows 64 rb.., words from the even one
  // at or left of rb (that word may be left of the diagonal: never read)
  auto stage = [&](int rb) {
    unsigned long long(*dst)[MAX_WORDS] = buf[rb & 1];
    const int rows = min(WORD, k - rb * WORD);
    const int c0 = rb & ~1;
    const int pair = lane & 15;
    const unsigned long long* src = ms + (size_t)rb * WORD * wst + c0;
    if (pair < (wst - c0) >> 1)
      for (int r = lane >> 4; r < rows; r += 2)
        st_mma::cp_async16(st_mma::smem_u32(&dst[r][c0 + 2 * pair]),
                           src + (size_t)r * wst + 2 * pair, 16);
    st_mma::cp_async_commit();
  };
  if (cap > 0) stage(0);
  // word ``lane`` of the finite set
  unsigned long long fin = 0ull;
  if (lane < words) {
    const int base = lane * WORD, n = min(WORD, k - base);
#pragma unroll 16
    for (int c = 0; c < n; ++c)
      fin |= (unsigned long long)(fs[base + c] != 0) << c;
  }
  unsigned long long removed = 0ull;   // word ``lane`` of the removed set
  int kept_total = 0, w = 0;
  for (; w < words && kept_total < cap; ++w) {
    if (w + 1 < words) {
      stage(w + 1);
      st_mma::cp_async_wait<1>();
    } else {
      st_mma::cp_async_wait<0>();
    }
    __syncwarp();
    unsigned long long(*rows)[MAX_WORDS] = buf[w & 1];
    // the diagonal block: the fixed point of kept = live & ~(OR of the
    // kept rows' diagonal words), lane l holding rows l and l + 32; each
    // pass is two warp OR-reductions, and bit b is final after at most
    // (the longest chain of suppressions ending at b) + 1 passes
    const unsigned long long live = __shfl_sync(FULL, fin & ~removed, w);
    const unsigned long long d_lo = rows[lane][w], d_hi = rows[lane + 32][w];
    unsigned long long kept = live;
    while (true) {                                          // uniform
      const unsigned long long mine = ((kept >> lane) & 1ull ? d_lo : 0ull) |
                                      ((kept >> (lane + 32)) & 1ull ? d_hi
                                                                    : 0ull);
      const unsigned lo = __reduce_or_sync(FULL, static_cast<unsigned>(mine));
      const unsigned hi =
          __reduce_or_sync(FULL, static_cast<unsigned>(mine >> 32));
      const unsigned long long next =
          live & ~((static_cast<unsigned long long>(hi) << 32) | lo);
      if (next == kept) break;
      kept = next;
    }
    // the cap: drop the word's last kept candidates past max_keep
    for (int over = kept_total + __popcll(kept) - cap; over > 0; --over)
      kept &= ~(1ull << (63 - __clzll(static_cast<long long>(kept))));
    kept_total += __popcll(kept);
    const int j = w * WORD + lane;
    if (j < k) keep[j] = static_cast<unsigned char>((kept >> lane) & 1ull);
    if (j + 32 < k)
      keep[j + 32] = static_cast<unsigned char>((kept >> (lane + 32)) & 1ull);
    // the kept rows' later words, each lane its own word: one predicated
    // load per kept row, all independent
    if (kept_total < cap && lane > w && lane < words) {
      unsigned long long acc = 0ull;
#pragma unroll
      for (int b = 0; b < WORD; ++b)
        if ((kept >> b) & 1ull) acc |= rows[b][lane];
      removed |= acc;
    }
    __syncwarp();     // every lane is done with buf[w & 1] before refill
  }
  st_mma::cp_async_wait<0>();
  for (int j = w * WORD + lane; j < k; j += 32) keep[j] = 0;  // past the cap
}

// grid (mask_blocks(words), S), block 256 threads: block (rb, column
// group g) writes words 4 g .. 4 g + 3 (those >= rb) of rows 64 rb ..
// 64 rb + 63; thread (q, r) = (tid / 64, tid % 64) word 4 g + q of row
// 64 rb + r.
__global__ void __launch_bounds__(THREADS)
    nms_kernel(const float4* __restrict__ boxes,
               const unsigned char* __restrict__ finite, int k, float thr,
               float eps, int cap, unsigned long long* __restrict__ mask,
               unsigned int* __restrict__ tickets,
               unsigned char* __restrict__ keep) {
  __shared__ float4 cb[THREADS];
  __shared__ float ca[THREADS];
  __shared__ unsigned cand_w[THREADS / 32], fast_w[THREADS / 32];
  __shared__ __align__(16) unsigned long long buf[2][WORD][MAX_WORDS];
  __shared__ bool last;
  const int words = (k + WORD - 1) / WORD;
  const int wst = mask_stride(words);
  const int groups = (words + QW - 1) / QW;
  int rb = 0, g = blockIdx.x;
  while (g >= groups - rb / QW) {
    g -= groups - rb / QW;
    ++rb;
  }
  g += rb / QW;
  const int s = blockIdx.y;
  const float4* bs = boxes + (size_t)s * k;
  const unsigned char* fs = finite + (size_t)s * k;
  unsigned long long* ms = mask + (size_t)s * k * wst;
  const int t = threadIdx.x;

  const int jc = g * QW * WORD + t;
  unsigned char fl = 0;
  if (jc < k) {
    cb[t] = bs[jc];
    ca[t] = area(cb[t]);
    fl = box_flags(cb[t], ca[t], fs[jc]);
  }
  // per column word: the candidates, and those with finite coordinates
  {
    const unsigned cand = __ballot_sync(FULL, fl & 1);
    const unsigned fast = __ballot_sync(FULL, (fl & 3) == 3);
    if ((t & 31) == 0) {
      cand_w[t / 32] = cand;
      fast_w[t / 32] = fast;
    }
  }
  __syncthreads();
  const int q = t / WORD, r = t % WORD, i = rb * WORD + r;
  const int cw = g * QW + q;
  if (cw >= rb && cw < words && i < k) {
    unsigned long long bits = 0ull;
    if (fs[i]) {
      const float4 bi = bs[i];
      const float ai = area(bi);
      const int n = min(WORD, k - cw * WORD);
      // the columns that this row may suppress: candidates, j < k, j > i
      unsigned long long live =
          (static_cast<unsigned long long>(cand_w[2 * q + 1]) << 32) |
          cand_w[2 * q];
      if (n < WORD) live &= (1ull << n) - 1;
      if (cw == rb) live &= r == WORD - 1 ? 0ull : ~0ull << (r + 1);
      const unsigned long long fast =
          (static_cast<unsigned long long>(fast_w[2 * q + 1]) << 32) |
          fast_w[2 * q];
      // pass 1, where both boxes are finite: the intersection alone, with
      // selects; an empty one decides 0 > thr
      unsigned long long exact = live;
      if (box_flags(bi, ai, 1) == 3) {
        unsigned long long overlap = 0ull;
#pragma unroll
        for (int c = 0; c < WORD; ++c) {
          const float4 b = cb[q * WORD + c];
          const float w =
              fmaxf(__fsub_rn(fminf(bi.z, b.z), fmaxf(bi.x, b.x)), 0.0f);
          const float h =
              fmaxf(__fsub_rn(fminf(bi.w, b.w), fmaxf(bi.y, b.y)), 0.0f);
          overlap |= __fmul_rn(w, h) != 0.0f ? 1ull << c : 0ull;
        }
        exact = live & (overlap | ~fast);
        if (0.0f > thr) bits = live & fast & ~overlap;
      }
      // pass 2: the full IoU of the rest, one column at a time
      while (exact != 0ull) {
        const int c = __ffsll(static_cast<long long>(exact)) - 1;
        exact &= exact - 1;
        const int sc = q * WORD + c;
        if (suppresses(bi, ai, cb[sc], ca[sc], eps, thr)) bits |= 1ull << c;
      }
    }
    ms[(size_t)i * wst + cw] = bits;
  }

  // the last block of this stream scans it
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(tickets + s, 1u) == (unsigned)(mask_blocks(words) - 1);
  __syncthreads();
  if (!last || t >= 32) return;
  __threadfence();
  scan(ms, wst, fs, k, cap, keep + (size_t)s * k, buf);
}

}  // namespace

// boxes: (n, k, 4) float32 (class-shifted); finite: (n, k) bool bytes;
// max_keep: candidates kept at most per stream (>= k: no cap); mask: (n,
// k, words + words % 2) uint64 scratch, words = ceil(k / 64); tickets:
// (n,) uint32, zero (left counted); keep: (n, k) bool bytes.  k <= 2048.
ST_EXPORT int st_nms_keep(const void* boxes, const void* finite, int n, int k,
                          float thr, float eps, int max_keep, void* mask,
                          void* tickets, void* keep, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  const int words = (k + WORD - 1) / WORD;
  if (words > MAX_WORDS || n > 65535) return cudaErrorInvalidValue;
  nms_kernel<<<dim3(mask_blocks(words), n), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes),
      static_cast<const unsigned char*>(finite), k, thr, eps,
      max_keep < 0 ? 0 : max_keep,
      static_cast<unsigned long long*>(mask),
      static_cast<unsigned int*>(tickets),
      static_cast<unsigned char*>(keep));
  return cudaGetLastError();
}
