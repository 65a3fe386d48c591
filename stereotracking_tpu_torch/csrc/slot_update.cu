// Steps 5-7 of the tracker's main path on the card, eight threads per
// (stream, track slot): the online smoothing replay of recovered tracks,
// the Kalman update of matched tracks and the per-slot bookkeeping.
//
// Replaces: stereotracking_tpu/models/tracker.py, the smoothing
// while_loop of the main path (lines 334-348, kalman.update on the virtual
// boxes up to the step's largest unmatch_len) and the update and
// bookkeeping after it.  It is not a Pallas kernel: the JAX package leaves
// this to XLA.  The port ran it as an op chain (ops/slot_update_cuda.py,
// slot_update_plain): replay_bound(cfg) = num_frames_retain - 1 full
// kalman.update calls on every slot of every stream, each some 45-50 small
// launches (cholesky_ex, two cuBLAS triangular solves, three bmm, the
// selects), their results thrown away wherever i >= unmatch_len.
//
// What it computes, for slot t = (s, k) with det = slot_det[s][k]:
//   matched = det >= 0 (an active slot; the merge of the three
//   assignments stays in PyTorch), recovered = matched && !tracked,
//   unmatch_len = recovered ? miss_count : 0;
//   mean, cov = recovered ? saved : the predicted state;
//   unmatch_len (at most max_replay) Kalman updates on the virtual boxes
//   last_bbox + (i + 1) * (match_bbox - last_bbox) / (unmatch_len + 1),
//   then, on a matched slot, the update on match_bbox; an unmatched slot
//   keeps its mean and cov bit for bit;
//   hits, tentative, tracked, the observation ring, obs_count, the
//   velocity direction from the k-step observation, miss_count,
//   last_bbox, last_frame, and the matched detection's score, scale,
//   depth and label, as the op chain's selects leave them.
// The replay updates applied are added to counts[0] (one atomicAdd per
// block) and the launch to counts[1] (the tracer's counter; counts may be
// NULL).
//
// The arithmetic is kalman.update's, in float32, in its order: project
// (cov[:4,:4] + diag(std^2)), a lower Cholesky factor of the 4x4 from its
// lower triangle, the gain from two triangular solves of cov[:, :4]^T
// (forward, then backward), the innovation, mean + gain * innovation and
// cov - (gain * proj_cov) * gain^T.  Square roots and divisions are IEEE
// (no fast math); the elementwise steps that PyTorch rounds one by one
// (box arithmetic, std^2, the virtual boxes, the velocity) use the _rn
// intrinsics, so nvcc contracts none of them into an FMA.  The products
// and sums of the matrix steps fuse as cuBLAS's do, in another order than
// the op chain's: they agree to float32 rounding, not bit for bit.
//
// What bounds it on an H100: latency.  A slot's work is a chain of up to
// max_replay + 1 dependent updates of some 600 flops and 70 divisions and
// square roots each; the bytes (a slot's ~700 B of state in and out) and
// operations are microseconds at the card's rates.  One thread per slot,
// the whole 8x8 covariance in its registers, took 8 us an update: every
// instruction of the chain waited on the one before.  So a slot has eight
// lanes of one warp, lane r holding row r of the covariance and mean[r]
// in registers through the whole chain (the lanes of a slot read its 256
// B of covariance together).  Each lane computes the 4x4 Cholesky factor
// itself from the projected block, shuffled from lanes 0-3; lane r solves
// column r of the gain (8 divisions, not 64), updates mean[r] and, with
// the gain's columns shuffled from the other lanes, its covariance row.
// Every element takes the same operations in the same order as in one
// thread.  The bookkeeping runs in lane 0.  A warp holds four slots, which
// step through their updates apart (shuffles within a slot's lanes only).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int LANES = 8;                  // threads per slot
constexpr float STD_POS = 1.0f / 20;      // kalman._STD_WEIGHT_POS
constexpr float STD_ASPECT = 1e-1f;       // project's aspect std

// The pointer arguments, in the order of ops/slot_update_cuda.py's
// POINTERS: the state after the prediction, the merged assignment, the
// frame ids, the detections, the outputs and the counter.
enum Ptr {
  MEAN, COV, SAVED_MEAN, SAVED_COV, ACTIVE, TENTATIVE, TRACKED, HITS,
  MISS_COUNT, OBS_COUNT, LAST_FRAME, LABELS, LAST_BBOX, VELOCITY, SCORES,
  SCALES, DEPTHS, OBS_RING, OBS_RING_VALID,
  SLOT_DET, FRAME_ID,
  DET_BBOXES, DET_SCORES, DET_SCALES, DET_DEPTHS, DET_LABELS,
  O_MEAN, O_COV, O_HITS, O_TENTATIVE, O_TRACKED, O_OBS_RING,
  O_OBS_RING_VALID, O_OBS_COUNT, O_VELOCITY, O_MISS_COUNT, O_LAST_BBOX,
  O_LAST_FRAME, O_SCORES, O_SCALES, O_DEPTHS, O_LABELS,
  COUNTS,
  N_PTRS
};

// The integer arguments, in the order of ops/slot_update_cuda.py's DIMS.
enum Dim {
  STREAMS, SLOTS, DETS, RING, VEL_DELTA_T, NUM_TENTATIVES, MAX_REPLAY,
  DET_BBOXES_STRIDE, DET_SCORES_STRIDE, DET_SCALES_STRIDE,
  DET_DEPTHS_STRIDE, DET_LABELS_STRIDE,
  N_DIMS
};

struct Args {
  void* p[N_PTRS];
  int d[N_DIMS];
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int i) {
  return static_cast<const T*>(a.p[i]);
}

template <typename T>
__device__ __forceinline__ T* out(const Args& a, int i) {
  return static_cast<T*>(a.p[i]);
}

// bbox_xyxy_to_cxcyah
__device__ __forceinline__ void cxcyah(const float b[4], float z[4]) {
  z[0] = __fdiv_rn(__fadd_rn(b[2], b[0]), 2.0f);
  z[1] = __fdiv_rn(__fadd_rn(b[3], b[1]), 2.0f);
  z[3] = __fsub_rn(b[3], b[1]);
  z[2] = __fdiv_rn(__fsub_rn(b[2], b[0]), z[3]);
}

// kalman.update(m, c, z) on lane r of a slot's eight (``mask``): m_r =
// mean[r], c_r = row r of the covariance, in place.
__device__ __forceinline__ void kalman_update(float& m_r, float c_r[8],
                                              const float z[4],
                                              unsigned mask) {
  float p[4][4], m4[4];                           // proj_cov, mean[:4]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = __shfl_sync(mask, c_r[j], i, LANES);
    m4[i] = __shfl_sync(mask, m_r, i, LANES);
  }
  const float sp = __fmul_rn(STD_POS, m4[3]);
  const float var_pos = __fmul_rn(sp, sp);
  const float var[4] = {var_pos, var_pos, __fmul_rn(STD_ASPECT, STD_ASPECT),
                        var_pos};
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i][i] = __fadd_rn(p[i][i], var[i]);
  float l[4][4];                                  // its lower factor
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float d = p[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = fmaf(-l[j][k], l[j][k], d);
    l[j][j] = __fsqrt_rn(d);
#pragma unroll
    for (int i = j + 1; i < 4; ++i) {
      float v = p[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v = fmaf(-l[i][k], l[j][k], v);
      l[i][j] = __fdiv_rn(v, l[j][j]);
    }
  }
  // g = column r of gain^T: L half = cov[r, :4]^T, then L^T g = half
  float g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = c_r[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v = fmaf(-l[i][k], g[k], v);
    g[i] = __fdiv_rn(v, l[i][i]);
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    float v = g[i];
#pragma unroll
    for (int k = i + 1; k < 4; ++k) v = fmaf(-l[k][i], g[k], v);
    g[i] = __fdiv_rn(v, l[i][i]);
  }
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) v = fmaf(g[i], __fsub_rn(z[i], m4[i]), v);
  m_r = __fadd_rn(m_r, v);
  // row r of (gain proj_cov) gain^T, with each lane's gain column
  float gp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float w = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) w = fmaf(g[k], p[k][j], w);
    gp[j] = w;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float w = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w = fmaf(gp[k], __shfl_sync(mask, g[k], q, LANES), w);
    c_r[q] = __fsub_rn(c_r[q], w);
  }
}

__device__ __forceinline__ int mod(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

// Slot t's steps 5-7 on lane r of its eight (``mask``); returns the
// replay updates it applied, in lane 0.
__device__ int update_slot(const Args& a, int t, int r, unsigned mask) {
  const int K = a.d[SLOTS], R = a.d[RING], s = t / K;
  const int det = in<int>(a, SLOT_DET)[t];
  const bool matched = det >= 0;
  const bool active = in<uint8_t>(a, ACTIVE)[t] != 0;
  const bool tracked = in<uint8_t>(a, TRACKED)[t] != 0;
  const bool tentative = in<uint8_t>(a, TENTATIVE)[t] != 0;
  const bool recovered = matched && !tracked;
  const int miss = in<int>(a, MISS_COUNT)[t];
  const int safe = min(max(det, 0), a.d[DETS] - 1);
  float mb[4], lb[4];                            // match_bbox, last_bbox
  const float* db = in<float>(a, DET_BBOXES) +
                    (size_t)s * a.d[DET_BBOXES_STRIDE] + safe * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mb[j] = db[j];
    lb[j] = in<float>(a, LAST_BBOX)[(size_t)t * 4 + j];
  }

  // 5-6. smoothing replay; 7. the update on the matched box
  float m_r = in<float>(a, recovered ? SAVED_MEAN : MEAN)[(size_t)t * 8 + r];
  const float* csrc = in<float>(a, recovered ? SAVED_COV : COV) +
                      (size_t)t * 64 + r * 8;
  float c_r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c_r[j] = csrc[j];
  int replays = 0;
  if (matched) {
    const int unmatch_len = recovered ? miss : 0;
    replays = max(min(unmatch_len, a.d[MAX_REPLAY]), 0);
    const float denom = __fadd_rn(static_cast<float>(unmatch_len), 1.0f);
    float shift[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      shift[j] = __fdiv_rn(__fsub_rn(mb[j], lb[j]), denom);
    for (int i = 0; i < replays; ++i) {
      const float f = static_cast<float>(i + 1);
      float virt[4], z[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        virt[j] = __fadd_rn(lb[j], __fmul_rn(f, shift[j]));
      cxcyah(virt, z);
      kalman_update(m_r, c_r, z, mask);
    }
    float z[4];
    cxcyah(mb, z);
    kalman_update(m_r, c_r, z, mask);
  }
  out<float>(a, O_MEAN)[(size_t)t * 8 + r] = m_r;
  float* oc = out<float>(a, O_COV) + (size_t)t * 64 + r * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) oc[j] = c_r[j];
  if (r != 0) return 0;

  // 7. bookkeeping
  const int hits = in<int>(a, HITS)[t] + (matched ? 1 : 0);
  out<int>(a, O_HITS)[t] = hits;
  const bool now_confirmed =
      tentative && matched && hits >= a.d[NUM_TENTATIVES];
  out<uint8_t>(a, O_TENTATIVE)[t] = tentative && !now_confirmed;

  const int obs = in<int>(a, OBS_COUNT)[t];
  const int pos_w = mod(obs, R);                 // the ring slot written
  const float* ring = in<float>(a, OBS_RING) + (size_t)t * R * 4;
  const uint8_t* ring_ok = in<uint8_t>(a, OBS_RING_VALID) + (size_t)t * R;
  float* o_ring = out<float>(a, O_OBS_RING) + (size_t)t * R * 4;
  uint8_t* o_ring_ok = out<uint8_t>(a, O_OBS_RING_VALID) + (size_t)t * R;
  for (int q = 0; q < R; ++q) {
    const bool w = active && q == pos_w;
#pragma unroll
    for (int j = 0; j < 4; ++j) o_ring[q * 4 + j] = w ? mb[j] : ring[q * 4 + j];
    o_ring_ok[q] = w ? matched : ring_ok[q] != 0;
  }
  const int new_obs = active ? obs + 1 : obs;
  out<int>(a, O_OBS_COUNT)[t] = new_obs;
  float new_last[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    new_last[j] = matched ? mb[j] : lb[j];
    out<float>(a, O_LAST_BBOX)[(size_t)t * 4 + j] = new_last[j];
  }

  // the velocity direction from the k-step observation (of the new ring,
  // count and last box) to the matched box
  const int dt = a.d[VEL_DELTA_T];
  const int pos_k = mod(new_obs - 1 - dt, R);
  const bool k_written = active && pos_k == pos_w;
  const bool k_valid = k_written ? matched : ring_ok[pos_k] != 0;
  const bool use_ring = new_obs > dt && k_valid;
  float kb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    kb[j] = !use_ring ? new_last[j] : k_written ? mb[j] : ring[pos_k * 4 + j];
  float* o_vel = out<float>(a, O_VELOCITY) + (size_t)t * 2;
  const float* vel = in<float>(a, VELOCITY) + (size_t)t * 2;
  if (matched) {
    const float c1x = __fdiv_rn(__fadd_rn(kb[0], kb[2]), 2.0f);
    const float c1y = __fdiv_rn(__fadd_rn(kb[1], kb[3]), 2.0f);
    const float c2x = __fdiv_rn(__fadd_rn(mb[0], mb[2]), 2.0f);
    const float c2y = __fdiv_rn(__fadd_rn(mb[1], mb[3]), 2.0f);
    const float sy = __fsub_rn(c2y, c1y), sx = __fsub_rn(c2x, c1x);
    const float norm = __fadd_rn(
        __fsqrt_rn(__fadd_rn(__fmul_rn(sy, sy), __fmul_rn(sx, sx))), 1e-6f);
    const bool invalid =
        __fadd_rn(__fadd_rn(__fadd_rn(kb[0], kb[1]), kb[2]), kb[3]) < 0.0f ||
        __fadd_rn(__fadd_rn(__fadd_rn(mb[0], mb[1]), mb[2]), mb[3]) < 0.0f;
    o_vel[0] = invalid ? -1.0f : __fdiv_rn(sy, norm);
    o_vel[1] = invalid ? -1.0f : __fdiv_rn(sx, norm);
  } else {
    o_vel[0] = vel[0];
    o_vel[1] = vel[1];
  }

  out<uint8_t>(a, O_TRACKED)[t] = active ? matched : tracked;
  out<int>(a, O_MISS_COUNT)[t] = matched ? 0 : active ? miss + 1 : miss;
  out<int>(a, O_LAST_FRAME)[t] =
      matched ? in<int>(a, FRAME_ID)[s] : in<int>(a, LAST_FRAME)[t];
  const size_t at = (size_t)s * a.d[DET_SCORES_STRIDE] + safe;
  out<float>(a, O_SCORES)[t] =
      matched ? in<float>(a, DET_SCORES)[at] : in<float>(a, SCORES)[t];
  out<float>(a, O_SCALES)[t] =
      matched ? in<float>(a, DET_SCALES)[(size_t)s * a.d[DET_SCALES_STRIDE] +
                                         safe]
              : in<float>(a, SCALES)[t];
  out<float>(a, O_DEPTHS)[t] =
      matched ? in<float>(a, DET_DEPTHS)[(size_t)s * a.d[DET_DEPTHS_STRIDE] +
                                         safe]
              : in<float>(a, DEPTHS)[t];
  out<int>(a, O_LABELS)[t] =
      matched ? in<int>(a, DET_LABELS)[(size_t)s * a.d[DET_LABELS_STRIDE] +
                                       safe]
              : in<int>(a, LABELS)[t];
  return replays;
}

__global__ void __launch_bounds__(THREADS)
    ocsort_slot_update_kernel(const Args a) {
  __shared__ unsigned int block_total;
  if (threadIdx.x == 0) block_total = 0;
  __syncthreads();
  const int t = blockIdx.x * (THREADS / LANES) + threadIdx.x / LANES;
  const int r = threadIdx.x % LANES;
  const unsigned mask = 0xffu << ((threadIdx.x & 31) & ~(LANES - 1));
  int replays = 0;
  if (t < a.d[STREAMS] * a.d[SLOTS]) replays = update_slot(a, t, r, mask);
  const unsigned warp_total =
      __reduce_add_sync(0xffffffffu, static_cast<unsigned>(replays));
  if ((threadIdx.x & 31) == 0 && warp_total)
    atomicAdd(&block_total, warp_total);
  __syncthreads();
  unsigned long long* counts = static_cast<unsigned long long*>(a.p[COUNTS]);
  if (threadIdx.x == 0 && counts != nullptr) {
    if (block_total) atomicAdd(&counts[0], block_total);
    if (blockIdx.x == 0) atomicAdd(&counts[1], 1ull);
  }
}

}  // namespace

// ptrs: N_PTRS pointers in the order of enum Ptr (COUNTS may be NULL);
// dims: N_DIMS ints in the order of enum Dim.  Every state tensor (S, K,
// ...) and the outputs are dense; a detection field is dense inside a
// stream, its streams DET_*_STRIDE elements apart.
ST_EXPORT int st_slot_update(void* const* ptrs, int n_ptrs, const int* dims,
                             int n_dims, void* stream) {
  if (n_ptrs != N_PTRS || n_dims != N_DIMS) return cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < N_PTRS; ++i) a.p[i] = ptrs[i];
  for (int i = 0; i < N_DIMS; ++i) a.d[i] = dims[i];
  const long long n = (long long)a.d[STREAMS] * a.d[SLOTS];
  if (n == 0) return cudaSuccess;
  if (a.d[DETS] < 1 || a.d[RING] < 1 || n > (1ll << 30))
    return cudaErrorInvalidValue;
  constexpr int SLOTS_PER_BLOCK = THREADS / LANES;
  const int blocks =
      static_cast<int>((n + SLOTS_PER_BLOCK - 1) / SLOTS_PER_BLOCK);
  ocsort_slot_update_kernel<<<blocks, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
