// Per-box corner-guided depth from the fixed-point disparity map: box
// scalars, rank statistics and corner-vote epilogue in one launch.
//
// Replaces: stereotracking_tpu/ops/depth_pallas.py, _stats_pallas /
// _kernel_impl (reached through extract_box_depths_disp_pallas), with the
// XLA code the JAX package fuses around it: _prep_scalars (box scalars) and
// _epilogue (corner vote, truncated-window mean).
//
// What it computes, for each box (one block per box, the boxes of all S
// streams in one launch: block i takes box i % nbox of stream i / nbox):
//   1. prologue: the box's integer corners (truncated toward 0, as torch's
//      float -> int32 cast on the card, __float2int_rz), its pyramid level
//      l = ceil(log2(max(bw, bh) / crop)) clipped to 0-3 (in integers), the
//      window origin and its rows and columns at stride 2^l, and whether the
//      box is skipped (invalid, degenerate or wider than 800 px);
//   2. the window: raw = round(disp * 16) at the strided pixels in the box
//      and the frame with raw >= rmin (the integer form of 0 < depth < 150),
//      read once and compacted into a dense per-warp list in shared memory;
//      n = its length;
//   3. seven order statistics (the (rank + 1)-th largest raw value at the
//      ranks of the median, the three window ends, two window starts and
//      the fallback; 0 when fewer than rank + 1 are valid) by a two-pass
//      radix select on the 16-bit values: a 256-bin histogram of the high
//      bytes, one scan that finds each rank's high byte and its rank inside
//      that bin, then one low-byte histogram per distinct high byte and the
//      same scan;
//   4. the max, and for six of the rank values v the count and the float32
//      sum of depth = bf / (raw / 16 + 1e-6) over the values > v;
//   5. the epilogue of ops/depth_cuda.py depth_epilogue: the four 2x2 corner
//      means of the unfiltered map, the vote and its rank window, the
//      window's mean (the depth) and scale = clip(depth^2, 1, 3); -1 and 1
//      for skipped boxes and boxes with n = 0.
// Outputs per box: depth, scale, and the Pallas kernel's 24-float row
//   [n, r_raw[8] = (mid, we0, we1, we2, ws0, ws1, max, fb),
//    cnt_lt[7] = (we0, we1, we2, ws0, ws1, 0, fb),
//    sum_lt[7] = (we0, we1, we2, ws0, ws1, 0, fb), 0].
// Every integer is exact (integer atomics only, whose sums do not depend
// on their order).  The float sums are deterministic: each warp walks its
// own list in a fixed order, then warp shuffles and a fixed warp order
// combine them; they differ from the plain version only by float32
// reassociation.  Values above 65535 rank as 65535, as the bisection over
// [0, 65535] of the plain version ranks them.
//
// What bounds it on an H100: neither bytes nor operations (a 96 x 96
// window is 9,216 pixels, 36 KB; 512 boxes read ~5 MB) but the number of
// dependent passes and block barriers per box, and the launches around it.
// The design: one read of the window, after which every pass scans the n
// valid values a warp compacted (not crop^2); the rank search takes two
// histogram passes instead of 16 bisection passes; 6 block barriers in
// all; and the box scalars and the epilogue, some 200 small torch launches
// per extraction as eager ops, run inside the same block.  Float
// arithmetic that decides an integer or that torch runs as its own kernel
// uses the _rn intrinsics, so no FMA contraction changes a result: a
// one-ulp change in a corner mean can flip the vote.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NRANK = 7;
constexpr int NOUT = 24;
constexpr int NBIN = 256;
constexpr int PYR_LEVELS = 4;
constexpr float MAX_BOX_W = 800.0f;
constexpr int MAXCH = 4;     // 32-column chunks of a window row (crop <= 128)

__device__ __forceinline__ float f_depth(int r, float bf) {
  return __fdiv_rn(bf, __fadd_rn(__fdiv_rn(static_cast<float>(r), 16.0f),
                                 1e-6f));
}

// int32 arithmetic that wraps as torch's int32 tensors do
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
// floor division by b > 0 (torch.div(..., rounding_mode='floor'))
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// the disparity pixel as an integer raw value, round(disp * 16)
__device__ __forceinline__ int raw_at(const float* p) {
  return __float2int_rn(__fmul_rn(*p, 16.0f));
}
// 16-bit key of a valid raw value: values above 65535 rank as 65535
__device__ __forceinline__ int key16(int v) { return min(v, 65535); }

// One warp finds, for each rank j with slot[j] == want (all ranks when
// want < 0), the bin t of a 256-bin histogram whose keys hold that rank
// counting from the largest: cum(> t) <= rank[j] < cum(>= t).  Writes the
// bin to bin_out[j] and the rank left inside the bin to rank_out[j].
__device__ void find_bins(const int* hist, const int* rank, const int* slot,
                          int want, int* bin_out, int* rank_out) {
  const int lane = threadIdx.x & 31;
  int c[8], total = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[k] = hist[8 * lane + k];
    total += c[k];
  }
  int above = total;            // inclusive suffix sum over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_down_sync(~0u, above, off);
    if (lane + off < 32) above += v;
  }
  int g = above - total;        // keys in the bins above this lane's
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    for (int j = 0; j < NRANK; ++j) {
      if ((want < 0 || slot[j] == want) && g <= rank[j] &&
          rank[j] < g + c[k]) {
        bin_out[j] = 8 * lane + k;
        rank_out[j] = rank[j] - g;
      }
    }
    g += c[k];
  }
}

__global__ void __launch_bounds__(THREADS)
box_depths_kernel(const float* __restrict__ disp, int h, int w,
                  const float* __restrict__ boxes, int box_stride,
                  const unsigned char* __restrict__ valid, int valid_stride,
                  int nbox, int crop, float bf, int rmin,
                  float* __restrict__ depth_out,
                  float* __restrict__ scale_out,
                  float* __restrict__ stats_out) {
  extern __shared__ int vals[];            // WARPS lists of cap values
  __shared__ int hist1[NBIN];              // high-byte histogram
  __shared__ int hist2[NRANK * NBIN];      // low bytes, per distinct slot
  __shared__ int slot_of[NBIN];            // high byte -> slot, or -1
  __shared__ int rank_s[NRANK], hb[NRANK], res[NRANK], slot[NRANK],
      lo_byte[NRANK], res2[NRANK], nslot_s;
  __shared__ int wcount[WARPS], pmax[WARPS], pcnt[WARPS][6];
  __shared__ float psum[WARPS][6];
  __shared__ float cpx[16];                // corner pixels, in depth

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sidx = blockIdx.x / nbox, bidx = blockIdx.x % nbox;
  disp += (size_t)sidx * h * w;

  // 1. prologue, in every thread (a broadcast read of 4 floats)
  const float* bx = boxes + (size_t)sidx * box_stride + 4 * bidx;
  const float fx1 = bx[0], fy1 = bx[1];
  const int x1 = __float2int_rz(fx1), y1 = __float2int_rz(fy1);
  const int x2 = __float2int_rz(bx[2]), y2 = __float2int_rz(bx[3]);
  const int bw = wsub(x2, x1), bh = wsub(y2, y1);
  const int size = max(bw, bh);
  int level = 0;
#pragma unroll
  for (int l = 0; l < PYR_LEVELS - 1; ++l) level += size > (crop << l);
  const int stride = 1 << level;
  const int y0 = clampi(y1, 0, h) / stride, x0 = clampi(x1, 0, w) / stride;
  const int nr = min(floor_div(wadd(bh, stride - 1), stride), crop);
  const int nc = min(floor_div(wadd(bw, stride - 1), stride), crop);

  for (int i = tid; i < NRANK * NBIN; i += THREADS) hist2[i] = 0;
  for (int i = tid; i < NBIN; i += THREADS) {
    hist1[i] = 0;
    slot_of[i] = -1;
  }
  if (tid < NRANK) {
    hb[tid] = -1;
    lo_byte[tid] = 0;
  }
  if (warp == 1 && lane < 16) {
    // a corner pixel: corner lane / 4 at offset (lane / 2 % 2, lane % 2)
    const int c = lane >> 2, dy = (lane >> 1) & 1, dx = lane & 1;
    const int pw = w + crop + 2;
    const int cy = c < 2 ? clampi(y1, 0, h + crop)
                         : clampi(wsub(y2, 2), 0, h + crop);
    const int cx = (c & 1) == 0 ? clampi(x1, 0, pw - 2)
                                : clampi(wsub(x2, 2), 0, pw - 2);
    const int yy = cy + dy, xx = cx + dx;
    float v = 0.0f;
    if (yy < h && xx < w) v = f_depth(raw_at(disp + (size_t)yy * w + xx), bf);
    cpx[lane] = v;
  }
  __syncthreads();

  // 2. the window, one read: warp w takes rows w, w + WARPS, ...; its
  //    valid values go to its own list in row-major order, and into the
  //    high-byte histogram (lanes with one bin add once, by their leader).
  //    Two rows of up to MAXCH 32-column chunks are loaded before any is
  //    used, so that 8 loads per lane are in flight at once.
  const int cap = (crop + WARPS - 1) / WARPS * crop;
  int* list = vals + warp * cap;
  const unsigned lt = (1u << lane) - 1;
  int cnt = 0;
  for (int r0 = warp; r0 < nr; r0 += 2 * WARPS) {
    int raw[2][MAXCH];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int rr = r0 + q * WARPS;
      const int y = (y0 + rr) * stride;
      const bool row_in = rr < nr && y < h;
      const float* row = disp + (size_t)y * w;
#pragma unroll
      for (int k = 0; k < MAXCH; ++k) {
        const int cc = 32 * k + lane;
        const int x = (x0 + cc) * stride;
        raw[q][k] = row_in && cc < nc && x < w ? raw_at(row + x) : -1;
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int k = 0; k < MAXCH; ++k) {
        const int v = raw[q][k];
        const bool ok = v >= rmin;         // rmin >= 0: -1 is never valid
        const unsigned m = __ballot_sync(~0u, ok);
        if (m == 0) continue;
        if (ok) list[cnt + __popc(m & lt)] = v;
        const int key = ok ? key16(v) >> 8 : -1;
        const unsigned peers = __match_any_sync(~0u, key);
        if (ok && lane == __ffs(peers) - 1)
          atomicAdd(&hist1[key], __popc(peers));
        cnt += __popc(m);
      }
    }
  }
  if (lane == 0) wcount[warp] = cnt;
  __syncthreads();

  int n = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) n += wcount[k];
  const float nf = static_cast<float>(n);
  const float a04 = __fmul_rn(0.4f, nf), a025 = __fmul_rn(0.25f, nf),
              a06 = __fmul_rn(0.6f, nf);
  const int ws0 = static_cast<int>(a04), ws1 = static_cast<int>(a025);
  const int we0 = static_cast<int>(__fadd_rn(a04, a06));
  const int we1 = static_cast<int>(__fadd_rn(a025, a06));
  const int we2 = static_cast<int>(a06);
  const int m_fb = max(n > 1 ? n - 1 : n, 1);

  // 3a. each rank's high byte (one warp scans the histogram)
  if (warp == 0) {
    if (lane == 0) {
      const int rank[NRANK] = {max(n / 2, 0),   max(we0, 1) - 1,
                               max(we1, 1) - 1, max(we2, 1) - 1,
                               max(ws0, 1) - 1, max(ws1, 1) - 1, m_fb - 1};
      for (int j = 0; j < NRANK; ++j) rank_s[j] = rank[j];
    }
    __syncwarp();
    find_bins(hist1, rank_s, slot, -1, hb, res);
    __syncwarp();
    if (lane == 0) {            // one slot per distinct high byte
      int ns = 0;
      for (int j = 0; j < NRANK; ++j) {
        if (hb[j] < 0) continue;
        if (slot_of[hb[j]] < 0) slot_of[hb[j]] = ns++;
        slot[j] = slot_of[hb[j]];
      }
      for (int j = 0; j < NRANK; ++j)
        if (hb[j] < 0) slot[j] = -1;
      nslot_s = ns;
    }
  }
  __syncthreads();

  // 3b. low-byte histograms of the values in those high bytes
  for (int i0 = 0; i0 < cnt; i0 += 32) {
    const int i = i0 + lane;
    int key = -1;
    if (i < cnt) {
      const int k = key16(list[i]);
      const int s = slot_of[k >> 8];
      if (s >= 0) key = (s << 8) | (k & 255);
    }
    const unsigned peers = __match_any_sync(~0u, key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist2[key], __popc(peers));
  }
  __syncthreads();

  // 3c. each rank's low byte: warp s scans slot s
  if (warp < nslot_s)
    find_bins(hist2 + warp * NBIN, res, slot, warp, lo_byte, res2);
  __syncthreads();

  int lo[NRANK];
#pragma unroll
  for (int j = 0; j < NRANK; ++j)
    lo[j] = hb[j] < 0 ? 0 : (hb[j] << 8) | lo_byte[j];

  // 4. max, and count / depth sum above ranks 1..6, per warp over its list
  int vmax = -1;
  int cl[6] = {0, 0, 0, 0, 0, 0};
  float sl[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = lane; i < cnt; i += 32) {
    const int v = list[i];
    vmax = max(vmax, v);
    const float d = f_depth(v, bf);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (v > lo[j + 1]) {
        cl[j] += 1;
        sl[j] = __fadd_rn(sl[j], d);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    vmax = max(vmax, __shfl_xor_sync(~0u, vmax, off));
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      cl[j] += __shfl_xor_sync(~0u, cl[j], off);
      sl[j] = __fadd_rn(sl[j], __shfl_xor_sync(~0u, sl[j], off));
    }
  }
  if (lane == 0) {
    pmax[warp] = vmax;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      pcnt[warp][j] = cl[j];
      psum[warp][j] = sl[j];
    }
  }
  __syncthreads();
  if (tid != 0) return;

  // 5. the stats row and the epilogue, one thread
  int vm = -1, cnt_a[6] = {0, 0, 0, 0, 0, 0};
  float sum_a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < WARPS; ++k) {
    vm = max(vm, pmax[k]);
    for (int j = 0; j < 6; ++j) {
      cnt_a[j] += pcnt[k][j];
      sum_a[j] = __fadd_rn(sum_a[j], psum[k][j]);
    }
  }
  const int r_raw[8] = {lo[0], lo[1], lo[2], lo[3], lo[4], lo[5],
                        max(vm, 0), lo[6]};
  // cnt_lt / sum_lt in the order (we0, we1, we2, ws0, ws1, 0, fb)
  const int cnt_lt[7] = {cnt_a[0], cnt_a[1], cnt_a[2], cnt_a[3], cnt_a[4],
                         0, cnt_a[5]};
  const float sum_lt[7] = {sum_a[0], sum_a[1], sum_a[2], sum_a[3], sum_a[4],
                           0.f, sum_a[5]};
  float* row = stats_out + (size_t)blockIdx.x * NOUT;
  row[0] = nf;
  for (int j = 0; j < 8; ++j) row[1 + j] = static_cast<float>(r_raw[j]);
  for (int j = 0; j < 7; ++j) {
    row[9 + j] = static_cast<float>(cnt_lt[j]);
    row[16 + j] = sum_lt[j];
  }
  row[23] = 0.f;

  float rv[8];
  for (int j = 0; j < 8; ++j) rv[j] = f_depth(r_raw[j], bf);
  int votes = 0;
  for (int c = 0; c < 4; ++c) {
    // the corner's four pixels added in the order (0, 0), (0, 1), (1, 0),
    // (1, 1), as ops/depth_cuda.py corner_means adds them
    const float* p = cpx + 4 * c;
    const float mean = __fdiv_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[2]), p[3]), 4.0f);
    votes += mean > rv[0];
  }
  const int branch = votes <= 2 ? 0 : (votes == 3 ? 1 : 2);
  const int cand_ws[3] = {ws0, ws1, 0}, cand_we[3] = {we0, we1, we2};
  const int ms[7] = {max(we0, 1), max(we1, 1), max(we2, 1), max(ws0, 1),
                     max(ws1, 1), 1, m_fb};
  float pref[7];
  for (int j = 0; j < 7; ++j)
    pref[j] = __fadd_rn(sum_lt[j],
                        __fmul_rn(static_cast<float>(ms[j] - cnt_lt[j]),
                                  rv[j + 1]));
  const int ws = cand_ws[branch], we = cand_we[branch];
  const float seg_cnt = static_cast<float>(we - ws);
  const float seg_sum = __fsub_rn(we > ws ? pref[branch] : 0.f,
                                  ws > 0 ? pref[branch + 3] : 0.f);
  const float fb_cnt = static_cast<float>(max(n - 1, 1));
  float d = we <= ws ? __fdiv_rn(pref[6], fb_cnt)
                     : __fdiv_rn(seg_sum, fmaxf(seg_cnt, 1.0f));

  const bool is_valid = valid[(size_t)sidx * valid_stride + bidx] != 0;
  const bool skip = !is_valid || x1 < 0 || y1 < 0 || bw <= 0 || bh <= 0 ||
                    fx1 >= static_cast<float>(w) ||
                    fy1 >= static_cast<float>(h) ||
                    static_cast<float>(bw) > MAX_BOX_W;
  float sc = 1.0f;
  if (skip || n < 1) {
    d = -1.0f;
  } else {
    const float d2 = __fmul_rn(d, d);
    sc = d2 < 1.0f ? 1.0f : (d2 > 3.0f ? 3.0f : d2);
  }
  depth_out[blockIdx.x] = d;
  scale_out[blockIdx.x] = sc;
}

}  // namespace

// disp: (n, h, w) float32; boxes: n streams of nbox (x1, y1, x2, y2)
// float32, stream s at boxes + s * box_stride; valid: bool bytes, stream s
// at valid + s * valid_stride; depth, scale: (n, nbox) float32; stats:
// (n * nbox, 24) float32.  rmin >= 0.
ST_EXPORT int st_box_depths(const void* disp, int n, int h, int w,
                            const void* boxes, int box_stride,
                            const void* valid, int valid_stride, int nbox,
                            int crop, float bf, int rmin, void* depth,
                            void* scale, void* stats, void* stream) {
  if (n == 0 || nbox == 0) return cudaSuccess;
  const size_t bytes =
      (size_t)WARPS * ((crop + WARPS - 1) / WARPS) * crop * sizeof(int);
  // the attribute belongs to the current device, so it is set on every
  // launch (crop 128 needs 64 KiB, above the 48 KiB default)
  cudaError_t err = cudaFuncSetAttribute(
      box_depths_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  box_depths_kernel<<<n * nbox, THREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp), h, w,
      static_cast<const float*>(boxes), box_stride,
      static_cast<const unsigned char*>(valid), valid_stride, nbox, crop, bf,
      rmin, static_cast<float*>(depth), static_cast<float*>(scale),
      static_cast<float*>(stats));
  return cudaGetLastError();
}
