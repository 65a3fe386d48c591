// Shortest-augmenting-path Jonker-Volgenant assignment on the card, one
// block per stream.
//
// Replaces: stereotracking_tpu/ops/assignment.py, _solve_rect_lap with a
// scan mask (reached through linear_assignment_with_limit, line 209), which
// the JAX package runs on the device as lax.while_loops.  It is not a
// Pallas kernel: it is the XLA device code of the tracker's three
// assignments per step, which the port ran in numpy on the host (one
// device-to-host copy each).
//
// What it computes, for each stream s: the K x C float32 problem cost[s]
// (K <= C), rows with need[s][i] != 0 assigned in ascending index order
// (the order outer_body takes them with argmax(remaining)), each by one
// Dijkstra over the columns with row potentials u and column potentials v,
// then the augment along the predecessor columns (aug_body).  Output:
// row2col[s][i], -1 for the rows not scanned.
//
// Bit-exact with the numpy plain version (ops/assignment.py,
// solve_rect_lap): the same float32 operations in the same order, each
// rounded on its own (the _rn intrinsics, so nvcc neither contracts an FMA
// nor reassociates): cur = (cost[i0] - u[i0]) - v, u + delta, v - delta,
// minv - delta; every argmin takes the lowest index among equal values and
// ranks NaN below every number, as np.argmin and jnp.argmin do.
//
// What bounds it on an H100: latency.  The work is a chain of dependent
// Dijkstra steps, each a row read (C floats from L2), an argmin over C
// columns and a potential update; the bytes (cost once, ~32 KB a stream)
// and operations are nothing next to the chain.  The design keeps the chain
// short: one thread per column holds that column's v, minv, way and used in
// registers, u lives in shared memory, and each step costs one block
// argmin (warp shuffles, one barrier, every thread folding the per-warp
// results itself) and one barrier; all streams' problems run side by side
// in one launch.
#include "common.cuh"

namespace {

constexpr int MAX_C = 1024;
constexpr int MAX_K = 1024;
constexpr float BIG_INF = 1e18f;   // Dijkstra sentinel (_INF)

// (value, index) a precedes (value, index) b: NaN first, then smaller
// values, ties to the lower index.
__device__ __forceinline__ bool before(float va, int ja, float vb, int jb) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return na && (!nb || ja < jb);
  return va < vb || (va == vb && ja < jb);
}

// Block argmin of (val, idx) over all threads; every thread returns the
// result.  ``red_v``/``red_j`` hold one entry per warp; one barrier.  The
// caller puts a barrier between two calls.
__device__ __forceinline__ void block_argmin(float val, int idx,
                                             float* red_v, int* red_j,
                                             float* out_v, int* out_j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, val, off);
    const int oj = __shfl_down_sync(0xffffffffu, idx, off);
    if (before(ov, oj, val, idx)) {
      val = ov;
      idx = oj;
    }
  }
  if (lane == 0) {
    red_v[warp] = val;
    red_j[warp] = idx;
  }
  __syncthreads();
  float bv = red_v[0];
  int bj = red_j[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) {
    if (before(red_v[w], red_j[w], bv, bj)) {
      bv = red_v[w];
      bj = red_j[w];
    }
  }
  *out_v = bv;
  *out_j = bj;
}

__global__ void jv_kernel(const float* __restrict__ cost,
                          const unsigned char* __restrict__ need, int K,
                          int C, int* __restrict__ row2col_out) {
  extern __shared__ unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);               // K
  int* col2row = reinterpret_cast<int*>(u + K);            // C
  int* way_s = col2row + C;                                // C
  int* row2col = way_s + C;                                // K
  float* red_v = reinterpret_cast<float*>(row2col + K);    // 32
  int* red_j = reinterpret_cast<int*>(red_v + 32);         // 32

  const int s = blockIdx.x;
  const int j = threadIdx.x;            // this thread's column
  const bool col = j < C;
  const float* cs = cost + (size_t)s * K * C;
  const unsigned char* ns = need + (size_t)s * K;

  for (int t = j; t < K; t += blockDim.x) {
    u[t] = 0.0f;
    row2col[t] = -1;
  }
  if (col) col2row[j] = -1;
  float v = 0.0f;
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    if (!ns[i]) continue;                                   // uniform
    // the first relaxation, from row i
    float minv = col ? __fsub_rn(__fsub_rn(cs[(size_t)i * C + j], u[i]), v)
                     : BIG_INF;
    int way = -1;
    bool used = false;
    bool row_used = false;     // thread t < K: row t's flag
    float delta;
    int j0;
    block_argmin(col ? minv : __int_as_float(0x7f800000), col ? j : MAX_C,
                 red_v, red_j, &delta, &j0);
    __syncthreads();                    // red_* and u[i] reads are done
    if (j == i) u[i] = __fadd_rn(u[i], delta);
    minv = __fsub_rn(minv, delta);
    __syncthreads();

    while (col2row[j0] != -1) {                             // uniform
      const int i0 = col2row[j0];
      if (j == j0) used = true;
      if (j == i0) row_used = true;
      const float ui0 = u[i0];
      float masked = BIG_INF;
      if (col) {
        const float cur =
            __fsub_rn(__fsub_rn(cs[(size_t)i0 * C + j], ui0), v);
        if (!used && cur < minv) {
          minv = cur;
          way = j0;
        }
        masked = used ? BIG_INF : minv;
      }
      int j1;
      block_argmin(masked, col ? j : MAX_C, red_v, red_j, &delta, &j1);
      // u of the rows on the tree, and of row i
      if (j < K && (row_used || j == i)) u[j] = __fadd_rn(u[j], delta);
      if (col) {
        if (used)
          v = __fsub_rn(v, delta);
        else
          minv = __fsub_rn(minv, delta);
      }
      j0 = j1;
      __syncthreads();
    }

    // augment along the predecessor columns (aug_body), one thread
    if (col) way_s[j] = way;
    __syncthreads();
    if (j == 0) {
      int jc = j0;
      while (true) {
        const int jprev = way_s[jc];
        const int new_row = jprev == -1 ? i : col2row[jprev];
        col2row[jc] = new_row;
        row2col[new_row] = jc;
        if (jprev == -1) break;
        jc = jprev;
      }
    }
    __syncthreads();
  }
  for (int t = j; t < K; t += blockDim.x)
    row2col_out[(size_t)s * K + t] = row2col[t];
}

}  // namespace

// cost: (n, k, c) float32; need: (n, k) bool bytes; row2col: (n, k) int32.
// k <= c <= 1024.
ST_EXPORT int st_jv_assign(const void* cost, const void* need, int n, int k,
                           int c, void* row2col, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  if (k > c || c > MAX_C || k > MAX_K) return cudaErrorInvalidValue;
  const int threads = (c + 31) / 32 * 32;
  const size_t bytes = (size_t)(2 * k + 2 * c + 64) * 4;
  jv_kernel<<<n, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost),
      static_cast<const unsigned char*>(need), k, c,
      static_cast<int*>(row2col));
  return cudaGetLastError();
}
