"""One CUDA graph per tracker step: the port's counterpart of the JAX
package's jitted step (``jax.jit`` of ``_step_raw``, ``lax.scan`` in
``track_raw_chunk``).

``CapturedStep`` runs the raw-frame step (``mot.step_raw``:
preprocess and ``predict_frames_batched``) for one tracker object
(``OCSORTDisparity``, ``MultiStreamTracker``).  On the CPU it
runs the step eagerly.  On the card it captures the step into a
``torch.cuda.CUDAGraph`` on first use for each key, and every later call
replays that graph: one launch from the host for the whole step instead of
one per operation.  The step reads nothing back to the host (branch-free
tracker, assignment and NMS on the card), which is what makes it
capturable; a capture that fails raises, it never runs the step eagerly in
its place.

Key: the raw frames' shapes and dtypes (so the stream count and frame
size), whether ground-truth depth comes in, cuDNN's and TF32's switches,
the detector's weights (storage and version of every parameter and
buffer), the track state's buffers and, with camera-motion compensation,
the ``GMCConfig``, the camera-motion state's buffers and whether the warp
comes from the host.  Only the latest graph is kept: a
new key drops it and captures anew, so the memory the graphs hold stays
that of one step.

What capture has to respect, and how:
- inputs: a host-to-device copy inside a capture would replay the host
  buffer it captured, so the frames, the frame ids, the scale factor
  (sf_x, sf_y, sf_x, sf_y) and the depth are copied into the graph's own
  device buffers (``copy_``) before each replay; the scale factor is an
  input, not a key, so a keep-ratio resize of any size replays one graph;
- state: the graph reads the tracker's state tensors and writes the new
  state back into them in place as its last operations, so the caller's
  ``states`` stay the same tensors (``reset`` writes into them too:
  ``tracker.assign_state``); the camera-motion state (``mot.CMCState``,
  the previous small gray) likewise;
- the host's warp (``GMCConfig(backend='opencv')``): computed before the
  step from the host's frames, it is an input like the frames, (S, 2, 3)
  float32 and an (S,) bool "warp on", copied into the graph's buffers;
- outputs: the graph owns its result tensors and the next replay
  overwrites them, so each call returns clones, safe to fetch at any time;
- warm-up: one eager step on a side stream before the capture builds what
  the step caches on first use (kernel library, packed kernel weights,
  bf16 weights, cuDNN and cuBLAS handles); the state is saved before it and
  put back after, so the warm-up leaves no trace;
- launch counts: the kernels' wrappers count the launches they make, in
  the warm-up and into the capture; a replay runs the captured kernels
  without a wrapper call and counts nothing (a ``torch.profiler`` trace of
  the replays sees each kernel);
- every kernel launches on ``torch.cuda.current_stream()``, the capture
  stream during capture; cuDNN's algorithm choice is the same under
  capture as long as ``torch.backends.cudnn.benchmark`` is off, which the
  capture requires.
"""
from __future__ import annotations

import itertools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import tracker as trk


class _Graph:
    """One captured step: its graph, its input buffers and its result
    tensors."""

    def __init__(self, step, state: list, img_u8, disp_u16, frame_ids,
                 scale_factor, depth_raw, host_warp):
        dev = img_u8.device
        n = img_u8.shape[0]
        self.img = torch.empty_like(img_u8)
        self.disp = torch.empty_like(disp_u16)
        self.fid = torch.empty(n, dtype=torch.int32, device=dev)
        self.sf = torch.empty(4, dtype=torch.float32, device=dev)
        self.depth = None if depth_raw is None else torch.empty_like(
            depth_raw)
        self.warp = None if host_warp is None else (
            torch.empty((n, 2, 3), dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev))
        self.load(img_u8, disp_u16, frame_ids, scale_factor, depth_raw,
                  host_warp)
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(self.img, self.disp, self.fid, self.sf, self.depth,
                 self.warp)                                     # warm-up
        torch.cuda.current_stream().wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.out = step(self.img, self.disp, self.fid, self.sf,
                            self.depth, self.warp)

    def load(self, img_u8, disp_u16, frame_ids, scale_factor,
             depth_raw, host_warp) -> None:
        self.img.copy_(img_u8, non_blocking=True)
        self.disp.copy_(disp_u16, non_blocking=True)
        if torch.is_tensor(frame_ids):
            self.fid.copy_(frame_ids.reshape(-1), non_blocking=True)
        else:
            self.fid.copy_(_pinned(frame_ids, np.int32), non_blocking=True)
        sx, sy = scale_factor
        self.sf.copy_(_pinned([sx, sy, sx, sy], np.float32),
                      non_blocking=True)
        if depth_raw is not None:
            self.depth.copy_(depth_raw, non_blocking=True)
        if host_warp is not None:
            warp, on = host_warp
            self.warp[0].view(-1).copy_(_pinned(warp, np.float32),
                                        non_blocking=True)
            self.warp[1].copy_(_pinned(on, np.bool_), non_blocking=True)

    def replay(self) -> NamedTuple:
        self.graph.replay()
        return type(self.out)(*(t.clone() for t in self.out))


def _pinned(values, dtype) -> torch.Tensor:
    """Host values as a flat pinned tensor, for an asynchronous copy."""
    return torch.from_numpy(np.asarray(values, dtype).reshape(-1)
                            ).pin_memory()


class CapturedStep:
    """The step of one tracker object, replayed from a CUDA graph on the
    card and run eagerly on the CPU.  ``step(states, img_u8, disp_u16,
    frame_ids, scale_factor, depth_raw, cmc, host_warp)`` writes the new
    state into ``states`` (and the camera-motion state ``cmc``) and
    returns the step's result, a tuple of tensors; on the card it gets the
    scale factor as a (4,) float32 device tensor (sf_x, sf_y, sf_x, sf_y)
    and the host's warp as device tensors.  ``module`` is the detector
    whose weights it reads; ``cmc`` the tracker's ``GMCConfig`` (or None);
    ``captures`` counts the graphs captured so far."""

    def __init__(self, module: torch.nn.Module, step: Callable,
                 cmc=None):
        self.module = module
        self.step = step
        self.cmc = cmc
        self.captures = 0
        self._graph: Optional[_Graph] = None
        self._key = None

    def _weights_key(self) -> tuple:
        return tuple((t.data_ptr(), t._version) for t in itertools.chain(
            self.module.parameters(), self.module.buffers()))

    def __call__(self, states: trk.TrackState, img_u8: torch.Tensor,
                 disp_u16: torch.Tensor, frame_ids,
                 scale_factor: Tuple[float, float] = (1.0, 1.0),
                 depth_raw: Optional[torch.Tensor] = None,
                 cmc: Optional[NamedTuple] = None,
                 host_warp: Optional[Tuple[np.ndarray, np.ndarray]] = None
                 ) -> NamedTuple:
        """Advance ``states`` (a leading stream axis, updated in place) one
        frame from raw (S, H, W, 3) uint8 / (S, H, W) uint16 frames on the
        state's device; ``frame_ids`` S ints or an (S,) tensor; ``cmc`` the
        camera-motion state (updated in place), ``host_warp`` the host's
        (warps (S, 2, 3), on (S,)) as numpy."""
        sf = tuple(float(f) for f in scale_factor)
        if img_u8.device.type != 'cuda':
            warp = None if host_warp is None else tuple(
                torch.from_numpy(np.asarray(x)).to(img_u8.device)
                for x in host_warp)
            return self.step(states, img_u8, disp_u16, frame_ids, sf,
                             depth_raw, cmc, warp)
        if torch.backends.cudnn.benchmark:
            raise RuntimeError('CapturedStep: torch.backends.cudnn.benchmark '
                               'is on; cuDNN could pick other algorithms '
                               'under capture than outside it')
        key = (tuple(img_u8.shape), img_u8.dtype, tuple(disp_u16.shape),
               disp_u16.dtype,
               None if depth_raw is None else tuple(depth_raw.shape),
               torch.backends.cudnn.enabled,
               torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32,
               tuple(t.data_ptr() for t in states), self._weights_key(),
               self.cmc, None if cmc is None else tuple(
                   t.data_ptr() for t in cmc), host_warp is None)
        if key != self._key:
            self._graph = self._key = None     # its memory goes first

            def step(img, disp, fid, sf_dev, depth, warp):
                return self.step(states, img, disp, fid, sf_dev, depth, cmc,
                                 warp)

            self._graph = _Graph(step, [*states, *(cmc or ())], img_u8,
                                 disp_u16, frame_ids, sf, depth_raw,
                                 host_warp)
            self._key = key
            self.captures += 1
        else:
            self._graph.load(img_u8, disp_u16, frame_ids, sf, depth_raw,
                             host_warp)
        return self._graph.replay()
