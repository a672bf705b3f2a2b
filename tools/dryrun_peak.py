"""Where one dry-run step reaches its peak of live bytes, for the pair's
full config (CPU only; no card):

    PYTHONPATH=src python tools/dryrun_peak.py --arch A --shape S \
        [--mesh single|multi] [--ops GIB] [--forward] [--out F]

prints one JSON object: the record's `temp_size`, the live bytes when
the model is built (after the gathers made before the step's first
layer), the autograd node and the model frames of the op that set the
peak, and the largest storages live at that moment (GiB, shape, dtype);
and, from the specs, the bytes one rank holds of the layer stacks'
weights gathered over the data axes ('model' shards kept), all layers
and one layer. With `--ops GIB`, also the first 60 local ops whose
outputs hold more than GIB GiB, in order: the op, its input and output
shapes, the live GiB before it, and its frames (DTensor's own
included); with `--forward` (the step runs under autograd's anomaly
mode, which keeps each node's forward stack) also, for an op of the
backward, the model frames of the forward op whose gradient it
computes. Run with another tree's `src` on PYTHONPATH to read that
tree's plan (`run_one`, `_LocalCounter` and the specs are all it uses;
a tree before `specs.LAYER_STACKS` gives no gathered bytes).
"""
from __future__ import annotations

import argparse
import json
import re
import traceback

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import axis_size, make_production_mesh


class _PeakCounter(dryrun._LocalCounter):
    """`_LocalCounter` that also keeps each live storage's shape and, at
    every new peak, where the step is."""

    runs: list = []
    ops_gib = None      # `--ops`: list the ops whose outputs pass it
    forward = False     # `--forward`: each op's forward frames

    def __init__(self):
        super().__init__()
        self.shapes, self.where, self.ops = {}, None, []
        _PeakCounter.runs.append(self)

    def _count(self, func, args, kwargs, out):
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        gib = sum(t.numel() * t.element_size() for t in outs) / 2**30
        if self.ops_gib is not None and gib > self.ops_gib \
                and len(self.ops) < 60:
            ins = [tuple(t.shape) for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            frames = [f"{f.name}:{f.lineno}"
                      for f in traceback.extract_stack()
                      if "repro_torch" in f.filename
                      or "distributed/tensor" in f.filename][-7:]
            self.ops.append({"op": str(func), "in": ins,
                             "out": [tuple(t.shape) for t in outs],
                             "out_gib": round(gib, 3),
                             "live_gib": round(self.live / 2**30, 3),
                             "frames": frames})
            if self.forward:
                self.ops[-1]["forward"] = _forward_frames()
        return super()._count(func, args, kwargs, out)

    def _free(self, key):
        self.shapes.pop(key, None)
        super()._free(key)

    def _storage(self, t, new, nbytes=None):
        before = self.peak
        key = super()._storage(t, new, nbytes)
        if new and key is not None and self._held.get(key) \
                and key not in self.shapes:
            self.shapes[key] = (self._held[key], tuple(t.shape), str(t.dtype))
        if self.peak > before:
            node = torch._C._current_autograd_node()
            frames = [f"{f.name}:{f.lineno}"
                      for f in traceback.extract_stack()
                      if "repro_torch" in f.filename
                      and not f.filename.endswith("dryrun.py")]
            top = sorted(self.shapes.values(), reverse=True)[:6]
            self.where = {
                "node": node.name() if node is not None else "forward",
                "frames": frames[-6:],
                "top": [(round(b / 2**30, 3), s, d) for b, s, d in top]}
        return key


def _forward_frames():
    """The current backward node (None in the forward) and the model
    frames of the forward op it differentiates, as anomaly mode kept
    them."""
    node = torch._C._current_autograd_node()
    if node is None:
        return None
    frame = re.compile(r'File "[^"]*repro_torch[^"]*", line (\d+), '
                       r'in (\w+)')
    frames = [f"{m[2]}:{m[1]}"
              for line in node.metadata.get("traceback_", [])
              for m in frame.finditer(line)]
    return {"node": node.name(), "frames": frames[-6:]}


def gathered_layer_bytes(arch: str, shape: str, multi: bool):
    """Bytes a rank holds of the layer stacks' weights with their data
    axes gathered: all layers, and one layer's share (None on a tree
    whose specs name no layer stacks)."""
    stacks = getattr(specs, "LAYER_STACKS", None)
    if stacks is None:
        return None
    mesh = make_production_mesh(multi_pod=multi)
    cfg = specs.tp_config(get_config(arch), mesh)
    _, p = specs.params_struct(cfg)
    fsdp = specs.use_fsdp(cfg, SHAPES[shape], mesh)
    spec = specs.param_shardings(mesh, p, fsdp=fsdp)
    tp = axis_size(mesh, "model")
    total = 0
    for key, leaf in p.items():
        if key.split("/")[0] in stacks:
            model = any("model" in (e if isinstance(e, tuple) else (e,))
                        for e in spec[key] if e is not None)
            total += leaf.numel() * leaf.element_size() // (tp if model
                                                            else 1)
    return {"fsdp": fsdp, "layers_gib": total / 2**30,
            "one_layer_gib": total / cfg.n_layers / 2**30}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--ops", type=float, default=None)
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    _PeakCounter.forward = args.forward
    _PeakCounter.ops_gib = args.ops
    built = []
    build = specs.build_model

    def build_model(*a, **kw):      # the step's model, after its gathers
        if _PeakCounter.runs:
            built.append(_PeakCounter.runs[-1].live)
        return build(*a, **kw)
    specs.build_model = build_model
    dryrun._LocalCounter = _PeakCounter
    with torch.autograd.set_detect_anomaly(args.forward, check_nan=False):
        rec = dryrun.run_one(args.arch, args.shape, multi)
    out = {"arch": args.arch, "shape": args.shape, "mesh": rec["mesh"],
           "ok": rec["ok"], "error": rec.get("error"),
           "temp_gib": rec["memory"]["temp_size"] / 2**30
           if rec["ok"] else None,
           "live_at_build_gib": built[0] / 2**30 if built else None,
           "peak": _PeakCounter.runs[-1].where if _PeakCounter.runs else None,
           "gathered": gathered_layer_bytes(args.arch, args.shape, multi)}
    if args.ops is not None and _PeakCounter.runs:
        out["ops"] = _PeakCounter.runs[-1].ops
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
