"""Where an exported program's outputs first part from the eager model's.

    python -m gwdepth_tpu_torch.tools.export_bisect [--artifact PATH]

Builds the shipped `GWDepthConfig(dropout=0.0, use_pallas=True)` model
from seed 5 (the weights `chip_smoke.py` phase 16 exports), exports its
eval forward with `export.export_forward`, saves and loads the artifact
with `export.load_exported`, and runs, in this one process, on the first
of phase 5's images (seeded synthetic 720x1280, through
`predict.preprocess` onto the 768x1024 canvas):

- the eager model twice (a control: run to run, op by op);
- the loaded artifact's program under `graphs.disable()` (its ops one by
  one, as the captured graph holds them), on the default stream and on
  a side stream (where `graphs.compiled` warms up and captures);
- the loaded call, eagerly and through its compiled call (one capture
  and replay), and the program once more after the capture;
- every node of the program from one replay of a CUDA graph
  of it (each node's value kept alive) against the same nodes eagerly;
  and, bisecting over the nodes, the program cut after one node and run
  through `graphs.compiled` (the capture `load_exported` serves with)
  against the same node eagerly: the first node whose value the
  compiled call moves.

Every ATen op that either run dispatches is recorded (a
`TorchDispatchMode`) with a fingerprint of its tensor inputs and outputs
(the float64 sum and sum of magnitudes of each, on the device) and the
module that called it (eager: forward hooks; artifact: the graph node's
`nn_module_stack`). Two runs' op sequences are aligned (the program's
metadata asserts and constant copies left out), and the first op whose
outputs differ is reported (program against eager; side stream against
default stream), with its module, whether its inputs were equal, its
input and output shapes and strides, both values (the largest
difference of its inputs and outputs and the relative L2 of each) and
the seg and depth gaps at the end. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 5
# what the program runs besides eager's ops (tests/test_torch_export.py)
SKIP = ("aten._assert_tensor_metadata", "aten.lift_fresh",
        "aten.lift_fresh_copy", "aten.detach", "aten.alias")


def phase5_first_image(hw):
    """Phase 5's first image (`chip_smoke.write_serve_images`: seed 2,
    720x1280, "wide") as the serving canvas and its validity mask."""
    from PIL import Image

    from gwdepth_tpu_torch.predict import preprocess

    rng = np.random.default_rng(2)
    arr = (rng.random((720, 1280, 3)) * 255).astype(np.uint8)
    canvas, valid, _ = preprocess(Image.fromarray(arr), hw)
    return canvas, valid


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    return out


def _print(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point() and not t.is_complex():
        t = t.to(torch.float64)
    t = t.detach().to(torch.float64)
    return torch.stack([t.sum(), t.abs().sum()])


class Recorder(TorchDispatchMode):
    """Each op: its name, the module that called it, the shapes and the
    fingerprints of its tensor inputs and outputs; with `keep`, the
    outputs of the op at that index (after `SKIP`)."""

    def __init__(self, where, keep=None):
        super().__init__()
        self.where = where
        self.keep = keep
        self.ops, self.kept = [], None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if name in SKIP:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.keep is not None and len(self.ops) == self.keep:
            self.kept = ([t.detach().clone() for t in ins],
                         [t.detach().clone() for t in outs])
        self.ops.append({
            "op": str(func), "module": self.where(),
            "in_shapes": [list(t.shape) for t in ins],
            "in_strides": [list(t.stride()) for t in ins],
            "out_shapes": [list(t.shape) for t in outs],
            "ins": [_print(t) for t in ins],
            "outs": [_print(t) for t in outs]})
        return out


def eager_where(model):
    """Forward hooks that keep the innermost module's name; returns the
    function that reads it."""
    stack = []

    def leave(mod, args, out):
        stack.pop()     # returns None: the output stays

    for name, mod in model.named_modules():
        mod.register_forward_pre_hook(
            lambda m, a, n=name: stack.append(n))
        mod.register_forward_hook(leave)
    return lambda: stack[-1] if stack else ""


class _NodeInterpreter(torch.fx.Interpreter):
    def __init__(self, gm):
        super().__init__(gm)
        self.node = None

    def run_node(self, n):
        self.node = n
        return super().run_node(n)

    def where(self):
        st = (self.node.meta.get("nn_module_stack") or {}) if self.node \
            else {}
        return list(st.values())[-1][0] if st else ""


class _KeepInterpreter(_NodeInterpreter):
    """Keeps every node's value (`vals`, in node order)."""

    def __init__(self, gm):
        super().__init__(gm)
        self.vals = []

    def run_node(self, n):
        out = super().run_node(n)
        if n.op == "call_function":
            self.vals.append((n, out))
        return out


def node_prints(vals) -> list:
    return [[_print(t).cpu().tolist() for t in _tensors(out)]
            for _, out in vals]


def graph_vs_eager_nodes(gm, x, v) -> dict:
    """The program's every node value from one CUDA graph replay (the
    capture keeps each node's output alive in the graph's memory) against
    the same nodes run eagerly: the first node whose value differs, its
    target and module, whether its tensor inputs were equal, and both
    values."""
    with torch.no_grad():
        eager = _KeepInterpreter(gm)
        eager.run(x, v)
        e_prints = node_prints(eager.vals)
        del eager
        xs, vs = x.clone(), v.clone()
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _NodeInterpreter(gm).run(xs, vs)        # warm-up, as PyTorch asks
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        kept = _KeepInterpreter(gm)
        with torch.cuda.graph(graph):
            kept.run(xs, vs)
        graph.replay()
        torch.cuda.synchronize()
        g_prints = node_prints(kept.vals)
    first = None
    for i, (a, b) in enumerate(zip(e_prints, g_prints)):
        if a != b:
            first = i
            break
    res = {"nodes": len(g_prints), "index": first}
    if first is None:
        return res
    node, g_out = kept.vals[first]
    args = [a for a in node.all_input_nodes]
    index = {n: j for j, (n, _) in enumerate(kept.vals)}
    res.update({
        "node": node.name, "target": str(node.target),
        "module": (list((node.meta.get("nn_module_stack") or {}).values())
                   or [("", None)])[-1][0],
        "inputs": [a.name for a in args],
        "inputs_equal": all(e_prints[index[a]] == g_prints[index[a]]
                            for a in args if a in index),
        "differing_nodes": sum(a != b for a, b in zip(e_prints, g_prints))})
    # the node again, eagerly, on the replay's own inputs: does the same
    # op on the same operands give the replay's value?
    env = {a: out for a, out in kept.vals}
    with torch.no_grad():
        eager_args = torch.fx.node.map_arg(
            node.args, lambda n: env[n] if n in env else None)
        eager_kwargs = torch.fx.node.map_arg(
            node.kwargs, lambda n: env[n] if n in env else None)
        if all(a in env for a in args):
            again = node.target(*eager_args, **eager_kwargs)
            res["same_inputs_eager_vs_graph"] = [
                _gap(p, q) for p, q in zip(_tensors(again), _tensors(g_out))
                if p.is_floating_point()]
            res["in_shapes"] = [list(t.shape) for t in
                                _tensors((eager_args, eager_kwargs))]
            res["in_strides"] = [list(t.stride()) for t in
                                 _tensors((eager_args, eager_kwargs))]
            res["values"] = [{"eager": p.flatten()[:4].tolist(),
                              "graph": q.flatten()[:4].tolist()}
                             for p, q in zip(_tensors(again),
                                             _tensors(g_out))
                             if p.is_floating_point()]
    return res


class _Stop(Exception):
    def __init__(self, value):
        super().__init__("stop")
        self.value = value      # not in args: fx rewrites those


class _PrefixInterpreter(_NodeInterpreter):
    """Runs the program up to its `stop`-th call_function node and returns
    that node's value (earlier values freed after their last use, as the
    program frees them)."""

    def __init__(self, gm, stop: int):
        super().__init__(gm)
        self.extra_traceback = False
        self.stop, self.seen = stop, 0

    def run_node(self, n):
        out = super().run_node(n)
        if n.op == "call_function":
            if self.seen == self.stop:
                raise _Stop(out)
            self.seen += 1
        return out

    def run(self, *args):
        try:
            super().run(*args)
        except _Stop as s:
            return s.value
        raise IndexError(f"the program has no call_function node "
                         f"{self.stop}")


def prefix_value(program, stop: int, images, valid):
    """The value of the program's `stop`-th call_function node."""
    return _PrefixInterpreter(program, stop).run(images, valid)


def compiled_prefix_bisect(gm, x, v, e_prints) -> dict:
    """The first call_function node whose value, computed by
    `graphs.compiled` (the capture `load_exported` makes: its warm-ups,
    stream, shared pool and error mode) over the program cut after that
    node, differs from the eager value; by bisection over the nodes with
    tensor values, the whole program first."""
    from gwdepth_tpu_torch import graphs

    run = graphs.compiled(prefix_value)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    with_values = [i for i, p in enumerate(e_prints) if p]
    captures = 0

    def differs(i) -> bool:
        nonlocal captures
        with torch.no_grad():
            got = [_print(t).cpu().tolist() for t in _tensors(
                run(gm, i, x, v))]
        captures += 1
        return got != e_prints[i]

    lo, hi = 0, len(with_values) - 1
    if not differs(with_values[hi]):
        return {"whole_program_differs": False, "captures": captures}
    while lo < hi:
        mid = (lo + hi) // 2
        if differs(with_values[mid]):
            hi = mid
        else:
            lo = mid + 1
    i = with_values[lo]
    node = nodes[i]
    index = {n: j for j, n in enumerate(nodes)}
    with torch.no_grad():
        graphed = [t.clone() for t in _tensors(run(gm, i, x, v))]
        eager = [t.clone() for t in _tensors(prefix_value(gm, i, x, v))]
        ins = [prefix_value(gm, index[a], x, v)
               for a in node.all_input_nodes if a in index]
    stack = list((node.meta.get("nn_module_stack") or {}).values())
    return {"whole_program_differs": True, "captures": captures + 2,
            "index": i, "node": node.name, "target": str(node.target),
            "module": stack[-1][0] if stack else "",
            "module_type": str(stack[-1][1]) if stack else "",
            "inputs": [a.name for a in node.all_input_nodes],
            "in_shapes": [list(t.shape) for t in _tensors(ins)],
            "in_strides": [list(t.stride()) for t in _tensors(ins)],
            "in_dtypes": [str(t.dtype) for t in _tensors(ins)],
            "gaps": [_gap(g, e) for g, e in zip(graphed, eager)
                     if g.is_floating_point()],
            "values": [{"graphed": g.flatten()[:4].tolist(),
                        "eager": e.flatten()[:4].tolist()}
                       for g, e in zip(graphed, eager)
                       if g.is_floating_point()]}


def _finish(rec) -> list:
    for r in rec:
        r["ins"] = [p.cpu().tolist() for p in r["ins"]]
        r["outs"] = [p.cpu().tolist() for p in r["outs"]]
    return rec


def first_parting(a: list, b: list) -> dict:
    """The first op of two aligned records whose outputs differ, and
    whether its inputs were equal; or where the sequences part."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x["op"] != y["op"] or x["out_shapes"] != y["out_shapes"]:
            return {"index": i, "aligned": False, "a": x["op"],
                    "b": y["op"], "module": x["module"]}
        if x["outs"] != y["outs"]:
            return {"index": i, "aligned": True, "op": x["op"],
                    "module_eager": x["module"], "module_program": y["module"],
                    "inputs_equal": x["ins"] == y["ins"],
                    "in_shapes": x["in_shapes"],
                    "in_strides_eager": x["in_strides"],
                    "in_strides_program": y["in_strides"],
                    "out_shapes": x["out_shapes"]}
    return {"index": None, "ops": [len(a), len(b)]}


def _gap(x: torch.Tensor, y: torch.Tensor) -> dict:
    x, y = x.double(), y.double()
    return {"max_abs": float((x - y).abs().max()),
            "rel_l2": float((x - y).norm() / y.norm().clamp(min=1e-30))}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", default="export_bisect.pt2",
                   help="where the exported program is written")
    args = p.parse_args(argv)

    from gwdepth_tpu_torch import export, graphs
    from gwdepth_tpu_torch.config import GWDepthConfig
    from gwdepth_tpu_torch.models import build_glassrgbd

    if not torch.cuda.is_available():
        raise SystemExit("export_bisect needs an NVIDIA card")
    dev = torch.device("cuda")
    cfg = GWDepthConfig(dropout=0.0, use_pallas=True)
    cfg.set_matmul_precision()
    model = build_glassrgbd(cfg, SEED, device="cpu").to(dev).eval()
    torch.export.save(export.export_forward(cfg, model, 1, "cuda"),
                      args.artifact)
    call = export.load_exported(args.artifact)
    canvas, valid = phase5_first_image(cfg.eval_hw)
    x = torch.from_numpy(canvas[None]).to(dev)
    v = torch.from_numpy(valid[None]).to(dev)
    keys = ("depth", "seg")

    # hooks once, for every eager run
    where = eager_where(model)

    def run_eager(keep=None):
        rec = Recorder(where, keep)
        with torch.no_grad(), rec:
            o = export.EvalForward(model)(x, v)
        return rec, o

    gm = call.program.module()

    def run_program(keep=None, stream=None):
        interp = _NodeInterpreter(gm)
        rec = Recorder(interp.where, keep)
        with torch.no_grad(), graphs.disable(), rec, (
                torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext()):
            o = interp.run(x, v)
        if stream is not None:
            torch.cuda.current_stream().wait_stream(stream)
        return rec, o

    side = torch.cuda.Stream(dev)
    e1, out_e1 = run_eager()
    e2, out_e2 = run_eager()
    pr, out_p = run_program()
    ps, out_ps = run_program(stream=side)
    with torch.no_grad(), graphs.disable():
        out_call = [t.clone() for t in call(x, v)]
    with torch.no_grad():
        out_graphed = [t.clone() for t in call(x, v)]
    pr2, out_p2 = run_program()
    recs = {k: _finish(r.ops) for k, r in (("e1", e1), ("e2", e2),
                                           ("p", pr), ("ps", ps),
                                           ("p2", pr2))}
    res = {"config": "GWDepthConfig(dropout=0.0, use_pallas)", "ops": {
               "eager": len(recs["e1"]), "program": len(recs["p"])},
           "eager_vs_eager": first_parting(recs["e1"], recs["e2"]),
           "program_vs_eager": first_parting(recs["e1"], recs["p"]),
           "side_stream_vs_default": first_parting(recs["p"], recs["ps"]),
           "program_after_capture_vs_before": first_parting(recs["p"],
                                                            recs["p2"])}

    def both(i, name):
        return {"program_vs_eager": _gap(out_p[i], out_e1[i]),
                "loaded_call_vs_eager": _gap(out_call[i], out_e1[i]),
                "graphed_vs_eager": _gap(out_graphed[i], out_e1[i]),
                "side_stream_vs_eager": _gap(out_ps[i], out_e1[i]),
                "graphed_vs_side_stream_bit_equal":
                    bool(torch.equal(out_graphed[i], out_ps[i])),
                "graphed_vs_loaded_call_bit_equal":
                    bool(torch.equal(out_graphed[i], out_call[i])),
                "program_after_capture_bit_equal":
                    bool(torch.equal(out_p2[i], out_p[i])),
                "eager_rerun_bit_equal": bool(torch.equal(out_e2[i],
                                                          out_e1[i]))}

    res["outputs"] = {name: both(i, name) for i, name in enumerate(keys)}
    res["graph_vs_eager_nodes"] = graph_vs_eager_nodes(gm, x, v)
    with torch.no_grad():
        eager_nodes = _KeepInterpreter(gm)
        eager_nodes.run(x, v)
        e_prints = node_prints(eager_nodes.vals)
        del eager_nodes
    res["compiled_prefix_vs_eager"] = compiled_prefix_bisect(gm, x, v,
                                                             e_prints)
    for label, (a_run, b_run), first in (
            ("program_vs_eager", (run_eager, run_program),
             res["program_vs_eager"]),
            ("side_stream_vs_default",
             (run_program, lambda keep: run_program(keep, side)),
             res["side_stream_vs_default"])):
        if not first.get("aligned"):
            continue
        i = first["index"]
        ka, _ = a_run(keep=i)
        kb, _ = b_run(keep=i)
        (ia, oa), (ib, ob) = ka.kept, kb.kept
        first["inputs"] = [_gap(q, p) for q, p in zip(ib, ia)
                           if q.is_floating_point()]
        first["outputs"] = [_gap(q, p) for q, p in zip(ob, oa)
                            if q.is_floating_point()]
        first["output_values"] = [
            {"a": oa[j].flatten()[:4].tolist(),
             "b": ob[j].flatten()[:4].tolist()}
            for j in range(len(oa)) if oa[j].is_floating_point()]
        ref = recs["e1"] if label == "program_vs_eager" else recs["p"]
        first["context"] = [{"op": r["op"], "module": r["module"]}
                            for r in ref[max(0, i - 3):i + 2]]
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
