"""Fused stage 3 (entry conv + CSP chain) in two launches: CUDA + plain.

Replaces the Pallas kernel ``stereotracking_tpu/ops/stage2_pallas.py``
``stage2_fold_pallas`` as reached through ``pallas_stage3_out``: the generic
stage kernel on the stage-3 weights (the flagship's 128 -> 256 channels,
mid 128, 3 bottlenecks).  It computes what ``stage_csp`` computes, with the
same bf16 rounding points, so the plain version is ``stage_csp_plain``.

At these widths the one-launch kernel's 16 x 16 region does not fit a
block's shared memory, so ``csrc/stage3.cu`` runs the two halves of the
``mma_chain.cuh`` chain as two launches: launch A (the entry conv and
main|short per 8 x 16 tile) writes [main | short] (S, H/2, W/2, C_out) bf16
to a scratch buffer that this wrapper allocates; launch B runs the
bottlenecks and the final 1x1 on 16 x 16 regions of main with a 3-ring
halo, streaming the packed weight slices from the first bottleneck's
(``slice_offsets``), which this wrapper passes.  The kernel is built for
C_in = mid = C_out / 2 = 128.  The two launches count as one launch of the
stage-3 kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from .stage2_cuda import (CHAIN_GEMM, StageKernel, chain_dims_problem,
                          check_aligned, check_chain_dims, check_stage_input,
                          kernel_dims_problem, launch_stage, slice_offsets,
                          stage_csp_plain)

stage3_csp_plain = stage_csp_plain
STAGE3_WIDTHS = (128,)      # C_in the stage-3 kernel is built for


def dims_problem(dims) -> Optional[str]:
    """Why ``stage3_csp``'s kernel cannot run a stage of dims (C_in, C_out,
    mid, num_blocks), or None."""
    return (kernel_dims_problem(dims)
            or chain_dims_problem(dims, STAGE3_WIDTHS))


def stage3_csp(x: torch.Tensor, k: StageKernel) -> torch.Tensor:
    """(S, H, W, C_in) bf16 -> (S, H/2, W/2, C_out) bf16 through the
    two-launch stage kernel, both launches covering the S streams.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    check_stage_input('stage3_csp', x, k)
    if x.device.type == 'cpu':
        return stage3_csp_plain(x, k)
    check_chain_dims('stage3_csp', k, STAGE3_WIDTHS)
    check_aligned('stage3_csp', x)
    n, h, w = x.shape[:3]
    ms = torch.empty((n, h // 2, w // 2, 2 * k.dims[2]),
                     dtype=torch.bfloat16, device=x.device)
    return launch_stage('st_stage3', 'stage3', x, k, ms,
                        ints=(slice_offsets(k.dims)[CHAIN_GEMM],))
