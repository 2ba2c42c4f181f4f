"""The port's kernel bindings as `torch.library` custom ops, and its
`export.py` against the JAX package's, on the CPU, at the tiny test
config.

- `torch.library.opcheck` on `gwdepth::ref_attn_diffusion` (K1) and
  `gwdepth::conv3x3_ln_act` (K2) at small shapes, with and without
  gradients, K2 with and without its LayerNorm and residual: the schema,
  the fake implementation against the real one, the autograd
  registration, and a trace through AOT autograd.
- The tiny model exported through `export.main` on the float32 plain path
  (`--device cpu`, weights from `--resume`), loaded in a fresh process
  that never imports `gwdepth_tpu_torch.models`: equal to the eager port
  within EAGER_TOL, and to the JAX package's own `save_exported` /
  `load_exported` artifact of the same weights within
  `test_torch_model.F32_TOL`, as the eager forwards are held.
- The tiny model exported with `use_pallas`: its graph holds one custom
  op node for every call the eager forward makes to the K1 and K2
  wrappers, so a trace that inlined the plain versions fails here; the
  program equals the eager forward within EAGER_TOL, and runs every
  compute op of the eager forward as often.
- A program of the two ops alone, saved and loaded in the same fresh
  process: its graph keeps both op nodes and its outputs equal the
  eager entries'.

Cost: the fresh process loads while this one traces the `use_pallas`
program and builds and runs JAX's artifact (one XLA compile); the whole
file takes about 90 s on one core.

Weights and inputs are `test_torch_model.model_run("shipped")`'s: the
port's seeded init carried into a flax tree, perturbed, and loaded back
into the port strictly.
"""

import collections
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.export import load_exported as jax_load_exported
from gwdepth_tpu.export import save_exported as jax_save_exported

from gwdepth_tpu_torch import export
from gwdepth_tpu_torch.ops import (fused_conv, interpolate,
                                   ref_attn_diffusion, tables, window_msa)

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import F32_TOL, _close, model_run

# an exported program against the eager forward it was traced from: the
# same ops on the same thread count, so only what the export's graph
# reorders could move a result
EAGER_TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# loads the model artifact and the two-op program in a process of its own
# on one torch thread, runs them on the saved inputs, and writes the
# outputs, the op nodes of the loaded two-op graph and the modules it
# imported
_LOADER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from gwdepth_tpu_torch import graphs
from gwdepth_tpu_torch.export import load_exported
inp = np.load(sys.argv[1])
model, ops, win = sys.argv[3:]
call = load_exported(model)
out = call(torch.from_numpy(inp["x"]), torch.from_numpy(inp["valid"]))
np.savez(model + ".out.npz", *[o.numpy() for o in out])
nodes = {}
for path, n_in in ((ops, 5), (win, 6)):
    ep = torch.export.load(path)
    with torch.no_grad():
        out = ep.module()(*[torch.from_numpy(inp[f"{path}{i}"])
                            for i in range(n_in)])
    np.savez(path + ".out.npz", *[o.numpy() for o in out])
    nodes[path] = sorted(str(n.target) for n in ep.graph.nodes
                         if str(n.target).startswith("gwdepth."))
json.dump({"in_avals": [[list(s), str(d)] for s, d in call.in_avals],
           "op_nodes": nodes[ops], "window_op_nodes": nodes[win],
           "stats": {k: graphs.stats["exported_forward", k]
                     for k in ("captures", "replays", "eager_runs")},
           "modules": sorted(m for m in sys.modules
                             if m.startswith("gwdepth"))},
          open(sys.argv[2], "w"))
"""


class _BothOps(torch.nn.Module):
    """K1's and K2's entries, one call each."""

    def forward(self, a, w, b, x, w2):
        return (ref_attn_diffusion.ref_attn_diffusion(a, w, b),
                fused_conv.conv3x3_ln_act(x, w2, act="gelu"))


class _WindowOps(torch.nn.Module):
    """K3's and K4's entries: the fused window attention (both ops) and
    the fence alone."""

    def forward(self, x, wqkv, bqkv, wproj, bproj, bias):
        return (window_msa.fused_window_attention(x, wqkv, bqkv, wproj,
                                                  bproj, bias, None, 2),
                window_msa.layout_fence(wqkv))


def _window_inputs():
    g = torch.Generator().manual_seed(5)
    return (torch.randn(1, 3, 4, 8, generator=g),
            torch.randn(24, 8, generator=g) * 0.2,
            torch.randn(24, generator=g) * 0.1,
            torch.randn(8, 8, generator=g) * 0.2,
            torch.randn(8, generator=g) * 0.1,
            torch.randn(2, 4, 4, generator=g))


def _op_inputs():
    g = torch.Generator().manual_seed(2)
    return (torch.randn(1, 6, 5, 4, generator=g),
            torch.randn(3, 3, 4, 4, generator=g) * 0.2,
            torch.randn(4, generator=g) * 0.1,
            torch.randn(1, 5, 6, 8, generator=g),
            torch.randn(3, 3, 8, 16, generator=g) * 0.2)


def _opcheck(op, args):
    res = torch.library.opcheck(op, args)
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("requires_grad", [False, True])
def test_k1_custom_op_passes_opcheck(requires_grad):
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(1, 6, 5, 4, generator=g),
            torch.randn(3, 3, 4, 4, generator=g) * 0.2,
            torch.randn(4, generator=g) * 0.1)
    _opcheck(torch.ops.gwdepth.ref_attn_diffusion.default,
             tuple(t.requires_grad_(requires_grad) for t in args))


@pytest.mark.parametrize("with_ln_res", [False, True])
@pytest.mark.parametrize("requires_grad", [False, True])
def test_k2_custom_op_passes_opcheck(requires_grad, with_ln_res):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 5, 6, 8, generator=g)
    w = torch.randn(3, 3, 8, 16, generator=g) * 0.2
    opt = [None, None, None]
    if with_ln_res:
        opt = [1 + 0.1 * torch.randn(16, generator=g),
               0.1 * torch.randn(16, generator=g),
               torch.randn(1, 5, 6, 16, generator=g)]
    tensors = [t if t is None else t.requires_grad_(requires_grad)
               for t in (x, w, *opt)]
    _opcheck(torch.ops.gwdepth.conv3x3_ln_act.default,
             (*tensors, "gelu" if with_ln_res else "none", True))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("requires_grad", [False, True])
def test_k3_custom_op_passes_opcheck(requires_grad, with_mask):
    """`gwdepth::window_msa` at a small site, q scaled inside the op as
    the fused entry asks it."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 3, 2, 5, 4, generator=g) for _ in range(3))
    bias = torch.randn(2, 5, 5, generator=g)
    mask = (torch.rand(3, 5, 5, generator=g) < 0.2) * -100.0 \
        if with_mask else None
    tensors = [t if t is None else t.requires_grad_(requires_grad)
               for t in (q, k, v, bias, mask)]
    _opcheck(torch.ops.gwdepth.window_msa.default, (*tensors, 0.5))


@pytest.mark.parametrize("requires_grad", [False, True])
def test_k4_custom_op_passes_opcheck(requires_grad):
    """`gwdepth::layout_fence` on a contiguous tensor and on the fused
    entry's kind of input, a channel slice of wider rows."""
    g = torch.Generator().manual_seed(4)
    wide = torch.randn(6, 5, 12, generator=g)
    for x in (wide[..., :8].contiguous(), wide[..., 4:]):
        _opcheck(torch.ops.gwdepth.layout_fence.default,
                 (x.detach().requires_grad_(requires_grad),))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The plain-path artifact from `export.main` and the two-op program,
    both loaded and run in a fresh process; the `use_pallas` program and
    its outputs; JAX's artifact of the same weights and its outputs."""
    run = model_run("shipped")
    tmp = tmp_path_factory.mktemp("export")
    ckpt = tmp / "ckpt.pth"
    torch.save({"model": run["model"].state_dict()}, ckpt)
    B = run["x"].shape[0]
    plain = str(tmp / "plain.pt2")
    assert export.main(["--output", plain, "--tiny", "--device", "cpu",
                        "--batch", str(B), "--resume", str(ckpt)]) == plain
    ops = str(tmp / "ops.pt2")
    torch.export.save(torch.export.export(_BothOps(), _op_inputs(),
                                          strict=False), ops)
    win = str(tmp / "win.pt2")
    torch.export.save(torch.export.export(_WindowOps(), _window_inputs(),
                                          strict=False), win)
    np.savez(tmp / "inputs.npz", x=run["x"], valid=run["valid"],
             **{f"{ops}{i}": t.numpy() for i, t in enumerate(_op_inputs())},
             **{f"{win}{i}": t.numpy()
                for i, t in enumerate(_window_inputs())})
    loader = subprocess.Popen(
        [sys.executable, "-c", _LOADER, str(tmp / "inputs.npz"),
         str(tmp / "res.json"), plain, ops, win],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=tmp)
    try:
        program = export.export_forward(run["cfg"].replace(use_pallas=True),
                                        run["model"], B, "cpu")
        with torch.no_grad():
            kernels = program.module()(torch.from_numpy(run["x"]),
                                       torch.from_numpy(run["valid"]))
        jpath = jax_save_exported(str(tmp / "jax.shlo"), jax_tiny(),
                                  {"params": run["params"]}, B)
        jax_out = jax_load_exported(jpath)(jnp.asarray(run["x"]),
                                           jnp.asarray(run["valid"]))
    finally:
        assert loader.wait() == 0
    res = json.loads((tmp / "res.json").read_text())

    def outputs(path):
        with np.load(path + ".out.npz") as z:
            return [z[f"arr_{i}"] for i in range(len(z.files))]

    return dict(run=run, res=res, plain=outputs(plain), program=program,
                kernels=[k.numpy() for k in kernels], ops=outputs(ops),
                win=outputs(win),
                jax=[np.asarray(o) for o in jax_out])


def _eager(out):
    return [out["pred_depth"][-1], out["pred_seg"], out["pred_logits"],
            out["pred_lines"]]


def test_artifact_loads_without_the_model_code(exported):
    res = exported["res"]
    assert not [m for m in res["modules"]
                if m.startswith("gwdepth_tpu_torch.models")], res["modules"]
    assert "gwdepth_tpu_torch.ops.ref_attn_diffusion" in res["modules"]
    x = exported["run"]["x"]
    assert res["in_avals"] == [[list(x.shape), "torch.float32"],
                               [list(x.shape[:3]), "torch.bool"]]


def test_saved_ops_load_and_run_in_a_fresh_process(exported):
    """The two-op program keeps both custom-op nodes through save and
    load, and runs them to the eager entries' outputs."""
    assert exported["res"]["op_nodes"] == [
        "gwdepth.conv3x3_ln_act.default",
        "gwdepth.ref_attn_diffusion.default"]
    with torch.no_grad():
        want = _BothOps()(*_op_inputs())
    for g, w in zip(exported["ops"], want):
        _close(torch.from_numpy(g), w.numpy(), EAGER_TOL)


def test_saved_window_ops_load_in_a_fresh_process(exported):
    """A program of K3's and K4's entries keeps their op nodes (the fused
    entry one of each, the fence alone one more) through save and a load
    after `load_exported` (its `OP_MODULES` register the ops), and runs
    them to the eager entries' outputs."""
    assert exported["res"]["window_op_nodes"] == [
        "gwdepth.layout_fence.default", "gwdepth.layout_fence.default",
        "gwdepth.window_msa.default"]
    with torch.no_grad():
        want = _WindowOps()(*_window_inputs())
    for g, w in zip(exported["win"], want):
        _close(torch.from_numpy(g), w.numpy(), EAGER_TOL)


def test_loaded_call_runs_the_program_eagerly_on_cpu(exported):
    """On CPU tensors the compiled call runs the program as it is: one
    eager run, no capture, no replay."""
    assert exported["res"]["stats"] == {"captures": 0, "replays": 0,
                                        "eager_runs": 1}


def test_plain_artifact_matches_eager_and_jax_artifact(exported):
    """Four outputs, as JAX's artifact returns them: the full-resolution
    depth, seg, logits and lines."""
    got = exported["plain"]
    want = _eager(exported["run"]["got"][False])
    assert len(got) == len(want) == len(exported["jax"]) == 4
    for g, w, j in zip(got, want, exported["jax"]):
        assert g.shape == tuple(w.shape) == j.shape
        _close(torch.from_numpy(g), w.numpy(), EAGER_TOL)
        _close(torch.from_numpy(g), j, F32_TOL)


def test_kernel_artifact_holds_the_custom_ops(exported):
    """One graph node per eager call of each kernel wrapper (K1 2, K2 26
    at the tiny config), and the program equals the eager `use_pallas`
    forward."""
    targets = [n.target for n in exported["program"].graph.nodes
               if n.op == "call_function"]
    k1 = targets.count(torch.ops.gwdepth.ref_attn_diffusion.default)
    k2 = targets.count(torch.ops.gwdepth.conv3x3_ln_act.default)
    assert {"k1": k1, "k2": k2} == exported["run"]["calls"][True] == \
        {"k1": 2, "k2": 26}
    for g, w in zip(exported["kernels"],
                    _eager(exported["run"]["got"][True])):
        _close(torch.from_numpy(g), w.numpy(), EAGER_TOL)


class _OpCounts(TorchDispatchMode):
    """Counts each aten op (by overload packet) run under it."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


# what the exported program runs besides eager's ops: host-side checks of
# tensor metadata, and a copy of each lifted constant (`lift_fresh_copy`)
# where eager wraps the fresh tensor (`lift_fresh`)
_EXPORT_ONLY = ("aten._assert_tensor_metadata", "aten.lift_fresh_copy")


def test_kernel_artifact_runs_the_eager_ops(exported):
    """The `use_pallas` program, run here, dispatches every compute op as
    often as the eager forward does; it adds only metadata asserts and
    swaps each `lift_fresh` for a `lift_fresh_copy`."""
    run = exported["run"]
    x, v = torch.from_numpy(run["x"]), torch.from_numpy(run["valid"])
    with torch.no_grad(), _OpCounts() as eager:
        export.EvalForward(run["model"].eval())(x, v)
    with torch.no_grad(), _OpCounts() as program:
        exported["program"].module()(x, v)
    e, p = eager.counts, program.counts
    assert e.pop("aten.lift_fresh", 0) == p["aten.lift_fresh_copy"]
    extra = {name: p.pop(name, 0) for name in _EXPORT_ONLY}
    assert p == e
    print(f"eager's {sum(e.values())} compute ops, and in the program "
          f"also {extra}")


def test_export_entries_bind_the_ops_once():
    """The Python entries call the custom ops, and no autograd.Function
    binding is left beside them."""
    assert not hasattr(ref_attn_diffusion, "_RefAttnDiffusion")
    assert not hasattr(fused_conv, "_Conv3x3LnAct")
    assert ref_attn_diffusion._op._qualname == "gwdepth::ref_attn_diffusion"
    assert fused_conv._op._qualname == "gwdepth::conv3x3_ln_act"


class _Resize(torch.nn.Module):
    """A bilinear resize: its lerp tables come from `ops/tables.py`."""

    def forward(self, x):
        return interpolate.resize_bilinear(x, (11, 13))


def test_tables_built_while_tracing_leave_the_artifact_loadable(tmp_path):
    """A table first built inside `torch.export`'s trace (as in a fresh
    process: nothing cached yet) becomes a constant of the program and
    leaves no grad-mode region behind: such a region's node has no
    value, and the saved artifact failed to load ("Node.meta
    wrap_with_set_grad_enabled is missing val field")."""
    x = torch.randn(1, 2, 5, 7, generator=torch.Generator().manual_seed(6))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tables, "_tables", collections.OrderedDict())
        with torch.no_grad():
            program = torch.export.export(_Resize(), (x,), strict=False)
        assert not tables.cached_keys()     # a tracer's tables are not kept
    assert not [n for n in program.graph.nodes
                if "set_grad_enabled" in str(n.target)]
    torch.export.save(program, tmp_path / "resize.pt2")
    loaded = torch.export.load(tmp_path / "resize.pt2")
    with torch.no_grad():
        _close(loaded.module()(x), _Resize()(x).numpy(), EAGER_TOL)


class _ResizeModel(torch.nn.Module):
    """A stand-in for the model at the serving entry: its outputs come
    from a table of `ops/tables.py`."""

    def forward(self, images, valid):
        x = images.permute(0, 3, 1, 2)
        return {"pred_depth": [interpolate.resize_bilinear(x, (11, 13))],
                "pred_seg": x.mean(dim=1), "pred_logits": None}


def test_export_forward_traces_with_the_tables_cached():
    """`export_forward` runs the forward once before it traces, so the
    tables are cached on the export's device and the program holds those
    as constants. Built inside the trace instead (a fresh process), a
    card's program held host arrays copied in at every call, which a CUDA
    graph cannot capture (the served artifact's capture raised)."""
    from types import SimpleNamespace

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tables, "_tables", collections.OrderedDict())
        program = export.export_forward(SimpleNamespace(eval_hw=(5, 7)),
                                        _ResizeModel(), 1, "cpu")
        cached = tables.cached_tensors()
    assert cached
    consts = list(program.constants.values())
    assert all(any(c is t for c in consts) for t in cached)


@pytest.mark.parametrize("flag", ["--resume", "--torch_init"])
def test_export_cli_refuses_a_url(tmp_path, flag):
    with pytest.raises(SystemExit, match="URL"):
        export.main(["--output", str(tmp_path / "m.pt2"), "--tiny",
                     "--device", "cpu", flag, "https://example.com/m.pth"])
