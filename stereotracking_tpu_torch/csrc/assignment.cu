// Shortest-augmenting-path Jonker-Volgenant assignment on the card, one
// warp per stream.
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
// Bit-exact with the numpy plain version (ops/assignment_cuda.py,
// solve_rect_lap): the same float32 operations in the same order, each
// rounded on its own (the _rn intrinsics, so nvcc neither contracts an FMA
// nor reassociates): cur = (cost[i0] - u[i0]) - v, u + delta, v - delta,
// minv - delta; every argmin takes the lowest index among equal values and
// ranks NaN below every number, as np.argmin and jnp.argmin do.
//
// What bounds it on an H100: latency.  The work is a chain of dependent
// Dijkstra steps, each a row read, an argmin over C columns and a
// potential update; the bytes (cost once, 32 KB a stream on the main path)
// and operations are nothing next to the chain.  The design keeps each
// step inside one warp, with no block barrier and no global read:
//   - the stream's cost matrix is copied into shared memory once, with
//     cp.async, when it fits (K * C * 4 <= 192 KB, the STAGED instance;
//     otherwise the rows are read from global memory, the same kernel
//     chosen by shape); `need` becomes a bitmask whose set bits are
//     visited with __ffs;
//   - lane l holds the CPL = C / 32 columns l * CPL .. l * CPL + CPL - 1
//     (CPL 4, 8, 16 or 32, a template parameter) with their v, minv, way,
//     used flag and col2row in registers, and the rows l, l + 32, ... with
//     their row_used flag; a step's work on a column is selects, with no
//     branch, so that the lane's columns interleave (one warp per SM
//     sub-partition hides no latency: every instruction on the chain
//     costs its full latency);
//   - u lives in shared memory and is not updated inside the step: each
//     step's delta goes to a log, and at the end of the row's Dijkstra
//     each tree row adds the deltas logged since it joined, in order (the
//     same float32 additions as the plain version's, later); a step reads
//     u only of the row it reaches, which has not joined yet (or, if a
//     visited column wins at the 1e18 sentinel, after a flush of the log);
//   - the argmin is a select chain over the lane's columns, then one warp
//     reduction, on a monotone 32-bit key (NaN below every number, -0.0
//     as +0.0, so that equal values have equal keys as for np.argmin):
//     __reduce_min_sync, a __ballot_sync of the lanes holding the minimum
//     and __ffs for the lowest of them, which holds the lowest column
//     since each lane's columns are contiguous; three shuffles from that
//     lane bring the column, its value and the row it is assigned to;
//   - the augment walk runs in one lane, with way and col2row in shared
//     memory.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int MAX_C = 1024;
constexpr float BIG_INF = 1e18f;              // Dijkstra sentinel (_INF)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_COLUMN = 0xffffffffu;   // key above every number
constexpr size_t STAGE_BYTES = 192 * 1024;    // largest staged cost matrix
// Dijkstra steps for one row before it is given up.  A step visits a new
// column unless every unvisited minv exceeds the sentinel (costs near
// 1e18 or +inf); on +inf the plain version never ends, and the kernel
// leaves such a row unassigned instead of hanging the card.
constexpr int MAX_STEPS = 1 << 20;

// Monotone key of x for the argmin: NaN first (0), then the numbers in
// ascending order with -0.0 and +0.0 equal; +inf's key is 0xff800000, so
// NO_COLUMN ranks after every column.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = x == 0.0f ? 0u : __float_as_uint(x);
  const unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return x != x ? 0u : k;
}

// The row of a visited column in First's result: its u must be brought up
// to date before the step reads it.
constexpr int IN_TREE = 1 << 30;

// A lane's first minimum over its columns, offered in ascending order
// (the lower column wins ties), with selects only; then the warp's.
struct First {
  unsigned key = NO_COLUMN;
  int col = 0;
  float val = 0.0f;
  int row = -1;
  __device__ __forceinline__ void offer(unsigned k, int c, float v, int r) {
    const bool better = k < key;
    key = better ? k : key;
    col = better ? c : col;
    val = better ? v : val;
    row = better ? r : row;
  }
  // The warp's first minimum: its column, value and row.  One reduction
  // over the lanes' keys; the lowest lane holding the least key holds the
  // lowest such column.
  __device__ __forceinline__ void reduce(int* col_out, float* val_out,
                                         int* row_out) const {
    const unsigned kmin = __reduce_min_sync(FULL, key);
    const int src = __ffs(__ballot_sync(FULL, key == kmin)) - 1;
    *col_out = __shfl_sync(FULL, col, src);
    *val_out = __shfl_sync(FULL, val, src);
    *row_out = __shfl_sync(FULL, row, src);
  }
};

// row[j .. j + 3] (0 past C); ``vec``: row and C are 16-byte aligned
// (one float4 load).
__device__ __forceinline__ float4 load4(const float* row, int j, int C,
                                        bool vec) {
  if (vec) {
    return j < C ? *reinterpret_cast<const float4*>(row + j)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(j < C ? row[j] : 0.0f, j + 1 < C ? row[j + 1] : 0.0f,
                     j + 2 < C ? row[j + 2] : 0.0f,
                     j + 3 < C ? row[j + 3] : 0.0f);
}

__device__ __forceinline__ float part(float4 x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <int CPL, bool STAGED>
__global__ void __launch_bounds__(32)
    jv_kernel(const float* __restrict__ cost,
              const unsigned char* __restrict__ need, int K, int C,
              int* __restrict__ row2col_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cost_s = reinterpret_cast<float*>(smem);        // K * C if STAGED
  float* u = cost_s + (STAGED ? (size_t)K * C : 0);      // K
  int* col2row = reinterpret_cast<int*>(u + K);          // C
  int* way_s = col2row + C;                              // C
  int* row2col = way_s + C;                              // K
  int* join = row2col + K;                               // K
  float* dl = reinterpret_cast<float*>(join + K);        // C + 1

  const int lane = threadIdx.x;
  const int s = blockIdx.x;
  const int c_first = lane * CPL;
  const int n_mine = max(0, min(CPL, C - c_first));   // this lane's columns
  const float* cs = cost + (size_t)s * K * C;
  const float* rows = STAGED ? cost_s : cs;
  const bool vec =
      C % 4 == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0;

  if (STAGED) {
    const size_t n = (size_t)K * C;
    size_t done = 0;
    if ((reinterpret_cast<uintptr_t>(cs) & 15) == 0) {
      done = n & ~size_t(3);
      for (size_t q = 4 * lane; q < done; q += 4 * 32)
        st_mma::cp_async16(st_mma::smem_u32(cost_s + q), cs + q, 16);
      st_mma::cp_async_commit();
    }
    for (size_t q = done + lane; q < n; q += 32) cost_s[q] = cs[q];
  }
  // need[32 g .. 32 g + 31] as the bits of lane g's word
  const int groups = (K + 31) / 32;
  unsigned need_bits = 0u;
  if (lane < groups) {
    const unsigned char* ns = need + (size_t)s * K + 32 * lane;
    const int n = min(32, K - 32 * lane);
#pragma unroll 8
    for (int t = 0; t < n; ++t) need_bits |= (unsigned)(ns[t] != 0) << t;
  }
  for (int r = lane; r < K; r += 32) {
    u[r] = 0.0f;
    row2col[r] = -1;
  }
  for (int j = lane; j < C; j += 32) col2row[j] = -1;
  float v[CPL];
  int c2r[CPL];               // col2row of this lane's columns
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    v[c] = 0.0f;
    c2r[c] = -1;
  }
  if (STAGED) st_mma::cp_async_wait<0>();
  __syncwarp();

  for (int g = 0; g < groups; ++g) {
    unsigned todo = __shfl_sync(FULL, need_bits, g);
    while (todo != 0u) {                                    // uniform
      const int i = 32 * g + __ffs(todo) - 1;
      todo &= todo - 1;
      const bool owns_i = (i & 31) == lane;
      float minv[CPL];
      int way[CPL];
      unsigned used = 0u;       // bit c: column c_first + c
      unsigned row_used = 0u;   // bit t: row lane + 32 t

      // u stays as it was when the row's Dijkstra began until flush():
      // dl[t] is its t-th delta, and tree row r (row i included) adds
      // dl[join[r]..] to u[r] in order, so the step's chain holds no u
      // update; flush() runs at the end, when the log is full, and when a
      // visited column wins (its row's u is read next)
      int nlog = 0;
      auto flush = [&]() {
        __syncwarp();
        unsigned mine = row_used | (owns_i ? 1u << (i >> 5) : 0u);
        while (mine != 0u) {
          const int r = lane + 32 * (__ffs(mine) - 1);
          mine &= mine - 1;
          float ur = u[r];
          for (int t = join[r]; t < nlog; ++t) ur = __fadd_rn(ur, dl[t]);
          u[r] = ur;
          join[r] = 0;
        }
        nlog = 0;
        __syncwarp();
      };

      // the first relaxation, from row i; every column's work below is
      // selects, no branch, so the lane's columns interleave
      const float ui = u[i];
      const float* ri = rows + (size_t)i * C + c_first;
      First first;
#pragma unroll
      for (int q = 0; q < CPL; q += 4) {
        const float4 x4 = load4(ri, q, C - c_first, vec);
#pragma unroll
        for (int c = q; c < q + 4; ++c) {
          way[c] = -1;
          minv[c] = __fsub_rn(__fsub_rn(part(x4, c - q), ui), v[c]);
          first.offer(c < n_mine ? order_key(minv[c]) : NO_COLUMN,
                      c_first + c, minv[c], c2r[c]);
        }
      }
      int j0, i0;
      float delta;
      first.reduce(&j0, &delta, &i0);
      if (owns_i) join[i] = 0;
      if (lane == 0) dl[0] = delta;
      nlog = 1;
#pragma unroll
      for (int c = 0; c < CPL; ++c) minv[c] = __fsub_rn(minv[c], delta);

      int steps = 0;
      while (i0 != -1 && ++steps <= MAX_STEPS) {            // uniform
        if (i0 & IN_TREE) {
          i0 &= ~IN_TREE;
          flush();
        } else if ((i0 & 31) == lane) {
          join[i0] = nlog;
        }
        used |= j0 / CPL == lane ? 1u << (j0 % CPL) : 0u;
        row_used |= (i0 & 31) == lane ? 1u << (i0 >> 5) : 0u;
        const float ui0 = u[i0];
        const float* r0 = rows + (size_t)i0 * C + c_first;
        First step;
#pragma unroll
        for (int q = 0; q < CPL; q += 4) {
          const float4 x4 = load4(r0, q, C - c_first, vec);
#pragma unroll
          for (int c = q; c < q + 4; ++c) {
            const bool used_c = (used >> c) & 1u;
            const float cur =
                __fsub_rn(__fsub_rn(part(x4, c - q), ui0), v[c]);
            const bool better = !used_c && cur < minv[c];
            minv[c] = better ? cur : minv[c];
            way[c] = better ? j0 : way[c];
            const float masked = used_c ? BIG_INF : minv[c];
            step.offer(c < n_mine ? order_key(masked) : NO_COLUMN,
                       c_first + c, masked,
                       used_c ? c2r[c] | IN_TREE : c2r[c]);
          }
        }
        step.reduce(&j0, &delta, &i0);
        if (lane == 0) dl[nlog] = delta;
        ++nlog;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const bool used_c = (used >> c) & 1u;
          const float vd = __fsub_rn(v[c], delta);
          const float md = __fsub_rn(minv[c], delta);
          v[c] = used_c ? vd : v[c];
          minv[c] = used_c ? minv[c] : md;
        }
        if (nlog > C) flush();                   // the log is full
      }
      flush();

      if (i0 != -1) continue;               // given up: row i unassigned
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c < n_mine) way_s[c_first + c] = way[c];
      __syncwarp();
      // augment along the predecessor columns (aug_body), one lane
      if (lane == 0) {
        int jc = j0;
        for (int n = 0; n < C; ++n) {        // a path has at most C columns
          const int jprev = way_s[jc];
          const int new_row = jprev == -1 ? i : col2row[jprev];
          col2row[jc] = new_row;
          row2col[new_row] = jc;
          if (jprev == -1) break;
          jc = jprev;
        }
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c_first + c < C) c2r[c] = col2row[c_first + c];
    }
  }
  for (int r = lane; r < K; r += 32)
    row2col_out[(size_t)s * K + r] = row2col[r];
}

template <int CPL, bool STAGED>
cudaError_t launch(const void* cost, const void* need, int n, int k, int c,
                   void* row2col, cudaStream_t stream) {
  const size_t bytes =
      (STAGED ? (size_t)k * c * 4 : 0) + (size_t)(3 * k + 3 * c + 1) * 4;
  // the attribute belongs to the current device, so it is set on every
  // launch (the staged main-path problem needs 35 KB, the largest 216 KB)
  cudaError_t err = cudaFuncSetAttribute(
      jv_kernel<CPL, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  jv_kernel<CPL, STAGED><<<n, 32, bytes, stream>>>(
      static_cast<const float*>(cost),
      static_cast<const unsigned char*>(need), k, c,
      static_cast<int*>(row2col));
  return cudaGetLastError();
}

template <bool STAGED>
cudaError_t launch_cpl(const void* cost, const void* need, int n, int k,
                       int c, void* row2col, cudaStream_t stream) {
  if (c <= 128) return launch<4, STAGED>(cost, need, n, k, c, row2col, stream);
  if (c <= 256) return launch<8, STAGED>(cost, need, n, k, c, row2col, stream);
  if (c <= 512)
    return launch<16, STAGED>(cost, need, n, k, c, row2col, stream);
  return launch<32, STAGED>(cost, need, n, k, c, row2col, stream);
}

}  // namespace

// cost: (n, k, c) float32; need: (n, k) bool bytes; row2col: (n, k) int32.
// k <= c <= 1024.  The instance: columns per lane the least of 4, 8, 16,
// 32 with 32 * CPL >= c; the cost staged in shared memory when k * c * 4
// <= 192 KB, else read from global memory.
ST_EXPORT int st_jv_assign(const void* cost, const void* need, int n, int k,
                           int c, void* row2col, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  if (k > c || c > MAX_C) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((size_t)k * c * 4 <= STAGE_BYTES)
    return launch_cpl<true>(cost, need, n, k, c, row2col, st);
  return launch_cpl<false>(cost, need, n, k, c, row2col, st);
}
