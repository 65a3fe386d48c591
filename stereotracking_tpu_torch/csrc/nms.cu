// Greedy NMS keep set of S streams' score-sorted candidates in one launch:
// a suppression bitmask, then one in-order scan per stream.
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
// iou(i, j) > thr.  That is the unique fixed point of the plain version's
// recurrence keep = ~any(sup & keep), sup[i, j] = iou > thr & i < j &
// finite[i] & finite[j], which greedy order reaches in one pass.
//   1. mask: mask[s][i][w] bit b = sup[i, 64 w + b], one thread per
//      (row i, 64-column word w), the word's 64 boxes staged in shared
//      memory; words left of the diagonal are 0.
//   2. scan: the last block of a stream to finish (a per-stream ticket
//      after a __threadfence) walks the candidates in order with one warp,
//      lane l holding word l of the removed set: candidate i is kept if it
//      is finite and its bit is clear, and a kept row's 32 words are ORed
//      in.  Rows are read ahead 16 at a time.
// The IoU is bbox_iou_matrix's (structures/bbox.py) operation for
// operation, each float op rounded on its own (_rn intrinsics) and
// max / min / clamp propagating NaN as torch's do, so each
// iou > thr decision is the plain version's bit for bit.
//
// What bounds it on an H100: the scan, a chain of k dependent steps per
// stream (a shuffle and an OR each; ~2048 at the flagship's
// pre_nms_top_k).  The mask is k^2 / 2 IoUs a stream (2.1 M; 16.8 M at 8
// streams), a few microseconds of the card's float32 rate, and k^2 / 8
// bytes (4 MB at 8 streams) that stay in L2 for the scan.  The design
// keeps the chain to register work: the removed set lives in the scanning
// warp's registers, one shuffle fetches the word a candidate falls in, and
// the next 16 rows' words are loaded before the current 16 are scanned.
#include "common.cuh"

namespace {

constexpr int WORD = 64;       // columns per mask word
constexpr int MAX_WORDS = 32;  // one scanning warp: k <= 2048
constexpr int AHEAD = 16;      // rows read ahead by the scan

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// bbox_iou_matrix's IoU of boxes a and b, with their areas.
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b, float eps) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)),
                          0.0f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)),
                          0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = max_nan(__fsub_rn(__fadd_rn(area_a, area_b), inter), eps);
  return __fdiv_rn(inter, uni);
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ void scan(const unsigned long long* __restrict__ mask,
                     const unsigned char* __restrict__ finite, int k,
                     int words, unsigned char* __restrict__ keep) {
  const int lane = threadIdx.x;
  unsigned long long removed = 0ull;
  unsigned long long cur[AHEAD], nxt[AHEAD];
  auto load = [&](unsigned long long* dst, int base) {
#pragma unroll
    for (int r = 0; r < AHEAD; ++r)
      dst[r] = (lane < words && base + r < k)
                   ? __ldcg(mask + (size_t)(base + r) * words + lane)
                   : 0ull;
  };
  load(cur, 0);
  for (int base = 0; base < k; base += AHEAD) {
    load(nxt, base + AHEAD);
    const bool fin = lane < AHEAD && base + lane < k && finite[base + lane];
    const unsigned fin_bits = __ballot_sync(0xffffffffu, fin);
    unsigned char kept_mine = 0;
#pragma unroll
    for (int r = 0; r < AHEAD; ++r) {
      const int i = base + r;
      if (i >= k) break;                                   // uniform
      const unsigned long long word =
          __shfl_sync(0xffffffffu, removed, i / WORD);
      const bool kept = ((fin_bits >> r) & 1u) && !((word >> (i % WORD)) & 1ull);
      if (kept) removed |= cur[r];
      if (lane == r) kept_mine = kept;
    }
    if (lane < AHEAD && base + lane < k) keep[base + lane] = kept_mine;
#pragma unroll
    for (int r = 0; r < AHEAD; ++r) cur[r] = nxt[r];
  }
}

// grid (words, words, S), block 64 threads: block (cw, rb) writes word cw
// of rows 64 rb .. 64 rb + 63.
__global__ void nms_kernel(const float4* __restrict__ boxes,
                           const unsigned char* __restrict__ finite, int k,
                           float thr, float eps,
                           unsigned long long* __restrict__ mask,
                           unsigned int* __restrict__ tickets,
                           unsigned char* __restrict__ keep) {
  __shared__ float4 cb[WORD];
  __shared__ float ca[WORD];
  __shared__ unsigned char cf[WORD];
  __shared__ bool last;
  const int words = gridDim.x;
  const int cw = blockIdx.x, rb = blockIdx.y, s = blockIdx.z;
  const float4* bs = boxes + (size_t)s * k;
  const unsigned char* fs = finite + (size_t)s * k;
  unsigned long long* ms = mask + (size_t)s * k * words;
  const int t = threadIdx.x;
  const int i = rb * WORD + t;

  if (cw >= rb) {            // words left of the diagonal stay 0
    const int jc = cw * WORD + t;
    if (jc < k) {
      cb[t] = bs[jc];
      ca[t] = area(cb[t]);
      cf[t] = fs[jc];
    }
    __syncthreads();
    if (i < k) {
      unsigned long long bits = 0ull;
      if (fs[i]) {
        const float4 bi = bs[i];
        const float ai = area(bi);
        const int n = min(WORD, k - cw * WORD);
        for (int c = 0; c < n; ++c) {
          const int j = cw * WORD + c;
          if (j > i && cf[c] && iou(bi, ai, cb[c], ca[c], eps) > thr)
            bits |= 1ull << c;
        }
      }
      ms[(size_t)i * words + cw] = bits;
    }
  } else if (i < k) {
    ms[(size_t)i * words + cw] = 0ull;
  }

  // the last block of this stream scans it
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(tickets + s, 1u) == (unsigned)(words * words - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t < 32) scan(ms, fs, k, words, keep + (size_t)s * k);
}

}  // namespace

// boxes: (n, k, 4) float32 (class-shifted); finite: (n, k) bool bytes;
// mask: (n, k, ceil(k / 64)) uint64 scratch; tickets: (n,) uint32, zero
// (left counted); keep: (n, k) bool bytes.  k <= 2048.
ST_EXPORT int st_nms_keep(const void* boxes, const void* finite, int n, int k,
                          float thr, float eps, void* mask, void* tickets,
                          void* keep, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  const int words = (k + WORD - 1) / WORD;
  if (words > MAX_WORDS) return cudaErrorInvalidValue;
  nms_kernel<<<dim3(words, words, n), WORD, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes),
      static_cast<const unsigned char*>(finite), k, thr, eps,
      static_cast<unsigned long long*>(mask),
      static_cast<unsigned int*>(tickets),
      static_cast<unsigned char*>(keep));
  return cudaGetLastError();
}
