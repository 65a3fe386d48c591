"""Time the NMS and JV kernels of a checkout on one NVIDIA GPU.

    python3 stereotracking_tpu_torch/tools/time_nms_jv.py --record FILE
    python3 stereotracking_tpu_torch/tools/time_nms_jv.py --inputs FILE
        [--root DIR] [--iters N]

``--record`` makes the inputs with the checkout that holds this script
(``chip_smoke.nms_jv_inputs``): the flagship at 8 streams of seeded 1080p
frames, random weights from seed 0, and two eager main-path steps whose
second hands ``jv_assign`` its 3 problems and ``nms_keep`` its
class-shifted, score-sorted candidates; beside them the all-conflicted JV
problem and the suppressing NMS candidates at the same shapes.  It saves
them with ``torch.save`` (CPU tensors) to FILE.

``--inputs`` imports ``stereotracking_tpu_torch`` from the checkout
``--root`` (by default the one that holds this script) and times its
``nms_cuda.nms_keep`` and ``assignment_cuda.jv_assign`` on FILE's inputs,
each checked against that checkout's plain version first:

- ``nms``: ``main`` (the main path's candidates, with the main path's cap
  ``max_keep`` where the checkout's ``nms_keep`` takes one), ``main_full``
  (no cap), ``main_mask`` (cap 0: the suppression mask alone, the scan
  stopping before its first word), ``suppress`` and ``suppress_full`` (the
  suppressing candidates);
- ``jv``: ``main`` (the main path's problem with the most rows to assign)
  and ``conflicted``.

Each entry has ``ms`` (back-to-back calls timed with CUDA events, the
wrapper's host work included) and ``device_ms`` (the kernel's device time
in ``torch.profiler``, taken after every CUDA-event timing, since a
profiler session slows the host work of the process after it).  Run two
checkouts one after the other on the same card (parent, change, change,
parent) to time them by one method on the same inputs.

Prints the card's ``nvidia-smi`` name and power limit and one JSON line.
"""
import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_smoke():
    """chip_smoke.py of the checkout that holds this script."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, check=True).stdout.strip()


def record(path, smoke, device):
    """The phase-3 JV and NMS inputs of chip_smoke.py at 8 streams."""
    import torch
    frames = [smoke.make_frames(2, smoke.FRAME_H, smoke.FRAME_W, 100 + s)
              for s in range(smoke.N_STREAMS)]
    model = smoke.build_flagship(device)
    ins = smoke.nms_jv_inputs(model, [f[0] for f in frames],
                              [f[1] for f in frames], device)

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(v) for v in x)
        return x

    torch.save({k: cpu(v) for k, v in ins.items()}, path)
    print(json.dumps(dict(recorded=path, jv_rows=[
        int(nd.sum()) for _, nd in ins['jv']], nms_shape=list(
            ins['nms'][1].shape), max_keep=ins['nms'][3])))


def time_checkout(path, smoke, device, iters):
    import torch
    from stereotracking_tpu_torch.ops import assignment_cuda as ac
    from stereotracking_tpu_torch.ops import nms_cuda
    from stereotracking_tpu_torch.tools.probe_stage1_variants import cuda_ms
    ins = torch.load(path)

    def card(x):
        return x.to(device) if isinstance(x, torch.Tensor) else x

    capped = 'max_keep' in inspect.signature(nms_cuda.nms_keep).parameters
    calls = {}
    for what, (b, f, t, cap) in (('main', ins['nms']),
                                 ('suppress', ins['suppressing'])):
        b, f = card(b), card(f)
        for name, mk in ((what, cap), (what + '_full', None)) + (
                ((what + '_mask', 0),) if what == 'main' else ()):
            if mk is not None and not capped:
                continue              # the checkout's nms_keep has no cap
            args = (b, f, t) if mk is None else (b, f, t, mk)
            got = nms_cuda.nms_keep(*args)
            if not torch.equal(got, nms_cuda.nms_keep_plain(*args)):
                raise SystemExit(f'time_nms_jv: nms {name} differs from the '
                                 f'plain version')
            calls[('nms', name)] = (lambda a=args: nms_cuda.nms_keep(*a),
                                    'nms_kernel')
    main = max(ins['jv'], key=lambda p: int(p[1].sum()))
    for name, (e, nd) in (('main', main), ('conflicted', ins['conflicted'])):
        e, nd = card(e), card(nd)
        if not torch.equal(ac.jv_assign(e, nd).cpu(),
                           ac.jv_assign_plain(e.cpu(), nd.cpu())):
            raise SystemExit(f'time_nms_jv: jv {name} differs from the '
                             f'plain version')
        calls[('jv', name)] = (lambda e=e, nd=nd: ac.jv_assign(e, nd),
                               'jv_kernel')
    r = dict(nms={}, jv={})
    for (kind, name), (fn, _) in calls.items():
        r[kind][name] = dict(ms=cuda_ms(fn, 10 * iters))
    for (kind, name), (fn, sym) in calls.items():
        r[kind][name]['device_ms'] = smoke.device_ms(fn, sym, iters)
    r['jv']['main']['rows'] = int(main[1].sum())
    r['nms']['max_keep'] = ins['nms'][3] if capped else None
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--record', metavar='FILE')
    ap.add_argument('--inputs', metavar='FILE')
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--iters', type=int, default=100)
    args = ap.parse_args(argv)
    if (args.record is None) == (args.inputs is None):
        ap.error('give one of --record and --inputs')
    root = os.path.abspath(HERE if args.record else args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('time_nms_jv: needs an NVIDIA GPU')
    smoke = load_smoke()
    device = torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    if args.record:
        print(card)
        record(args.record, smoke, device)
        return
    r = time_checkout(args.inputs, smoke, device, args.iters)
    print(card)
    print(json.dumps(dict(root=root, **r)))


if __name__ == '__main__':
    main()
