// The phase clock of the tracker step (utils/trace.py): one thread reads
// the device's nanosecond timer and stores it into the phase ring, which
// lives in pinned host memory written through its mapped address.
//
// rows: n_rows x n_cols int64, a row = step, on the device (1), then one
// stamp per phase; ctl: the device's (step, open) pair.  Phase 0 opens the
// next step's row (its number, the flag, its stamp, the later stamps
// zeroed); a later phase stores its stamp while the row is open, and the
// last phase closes it.  With ctl NULL the stamp goes to rows[0] alone
// (the clock offset's round trip).  The rows are read after the host has
// waited for the step, which makes the device's writes visible.
#include "common.cuh"

namespace {

__global__ void phase_mark_kernel(long long* rows, long long* ctl,
                                  int n_rows, int n_cols, int phase) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  volatile long long* out = rows;
  if (ctl == nullptr) {
    out[0] = t;
    __threadfence_system();   // the host spins on it
  } else if (phase == 0) {
    const long long step = ctl[0] + 1;
    ctl[0] = step;
    ctl[1] = 1;
    volatile long long* row = out + (step % n_rows) * n_cols;
    row[0] = step;
    row[1] = 1;
    row[2] = t;
    for (int c = 3; c < n_cols; ++c) row[c] = 0;
  } else if (ctl[1] != 0) {
    volatile long long* row = out + (ctl[0] % n_rows) * n_cols;
    row[2 + phase] = t;
    if (phase == n_cols - 3) ctl[1] = 0;
  }
}

}  // namespace

ST_EXPORT int st_phase_mark(long long* rows, long long* ctl, int n_rows,
                            int n_cols, int phase, cudaStream_t stream) {
  phase_mark_kernel<<<1, 1, 0, stream>>>(rows, ctl, n_rows, n_cols, phase);
  return static_cast<int>(cudaGetLastError());
}
