"""Ahead-of-time model export for serving (`torch.export` artifacts).

Saves the eval forward (images + validity mask -> depth / seg / line
outputs, weights included) as a `.pt2` file with `torch.export`, so a
serving process runs the model without the Python model code: load and
call. The counterpart of `gwdepth_tpu.export`, which writes a StableHLO
artifact with `jax.export`.

Usage:
  python -m gwdepth_tpu_torch.export --output model.pt2 \\
      [--resume ckpt.pth | --torch_init ref.pth] [--tiny] [--batch 1] \\
      [--device cuda|cpu]

  # serving side:
  from gwdepth_tpu_torch.export import load_exported
  fwd = load_exported("model.pt2")
  depth, seg, logits, lines = fwd(images, valid)   # fixed shapes

Kernels. On `--device cuda` (the default) the model is traced with
`use_pallas`, as `predict.py` runs it on the card, and the artifact holds
K1 and K2 as nodes of the custom ops `gwdepth::ref_attn_diffusion` and
`gwdepth::conv3x3_ln_act`: each op dispatches by the device of its
inputs, so the loaded program launches the kernels on the card.
`--device cpu` traces the float32 plain path, the path JAX's export
lowers: JAX cannot put its Pallas kernels into its artifact, which
lowers for the CPU too. An artifact runs on the device it was exported
on. Shapes are static (`cfg.eval_hw`, `--batch`), as in JAX, so K1's
schedule is fixed when the program is traced.

Serving. JAX's `exp.call` runs the deserialized artifact as one compiled
XLA program; `load_exported` runs the loaded program through
`graphs.compiled`, as `predict.make_forward` runs the model: on CUDA
tensors the first call of an input signature captures one CUDA graph
(after its eager warm-ups), and every later call copies the inputs into
the graph's static inputs and replays it, one graph launch and no kernel
launch from the host. The outputs are the graph's static outputs, valid
until the next compiled call on that device (copy one to keep it).
Under `graphs.disable()` the call runs the program eagerly, op by op; on
CPU tensors it always does.

`load_exported` imports only the modules that register the ops
(`OP_MODULES`: K1, K2, and K3 and K4 of the window-attention entries),
never `gwdepth_tpu_torch.models`, and sets full float32 matmuls and
convolutions (no TF32), the precision the exported config runs at.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

import torch

# the modules whose import registers the custom ops an artifact may hold
OP_MODULES = ("gwdepth_tpu_torch.ops.ref_attn_diffusion",
              "gwdepth_tpu_torch.ops.fused_conv",
              "gwdepth_tpu_torch.ops.window_msa")


class EvalForward(torch.nn.Module):
    """The eval forward as JAX's export returns it: (pred_depth[-1],
    pred_seg), then (pred_logits, pred_lines) with the line branch."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor, valid: torch.Tensor):
        out = self.model(images, valid)
        res = (out["pred_depth"][-1], out["pred_seg"])
        if out["pred_logits"] is not None:
            res += (out["pred_logits"], out["pred_lines"])
        return res


def export_forward(cfg, model: torch.nn.Module, batch_size: int = 1,
                   device="cuda") -> torch.export.ExportedProgram:
    """Trace the eval forward of `model` (built from `cfg`) on `device` at
    `cfg.eval_hw`: (B, H, W, 3) float32 images and a (B, H, W) bool mask,
    static shapes, after one eager call (see below). Returns the program;
    its state holds the weights, its constants the tables."""
    model = model.to(device).eval()
    H, W = cfg.eval_hw
    images = torch.zeros((batch_size, H, W, 3), device=device)
    valid = torch.ones((batch_size, H, W), dtype=torch.bool, device=device)
    with torch.no_grad():
        # one eager call first, so that every table of `ops/tables.py` is
        # cached on the device and the program holds it as a device
        # constant: a table first built inside the trace is a host array
        # that the program would copy to the card at every call, a copy
        # no CUDA graph can capture
        EvalForward(model)(images, valid)
        return torch.export.export(EvalForward(model), (images, valid),
                                   strict=False)


def save_exported(path: str, cfg, model: torch.nn.Module,
                  batch_size: int = 1, device="cuda") -> str:
    torch.export.save(export_forward(cfg, model, batch_size, device), path)
    return path


def exported_forward(program: torch.nn.Module, images: torch.Tensor,
                     valid: torch.Tensor):
    """One call of a loaded program (the function `load_exported`
    compiles; the program is an argument, so the cache key holds it and
    its fingerprint the weights)."""
    return program(images, valid)


def load_exported(path: str) -> Callable:
    """Load an artifact into a callable (images, valid) -> outputs, with
    `call.in_avals` the (shape, dtype) of its two inputs; a CUDA graph a
    signature on a card (see the module docstring; `call.program` is the
    loaded `ExportedProgram`)."""
    import importlib

    from gwdepth_tpu_torch import graphs

    for name in OP_MODULES:
        importlib.import_module(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ep = torch.export.load(path)
    fwd = ep.module()
    user = set(ep.graph_signature.user_inputs)
    avals = tuple((tuple(n.meta["val"].shape), n.meta["val"].dtype)
                  for n in ep.graph.nodes
                  if n.op == "placeholder" and n.name in user)

    run = graphs.compiled(exported_forward)

    def call(images, valid):
        with torch.no_grad():
            return run(fwd, images, valid)

    call.in_avals = avals
    call.program = ep
    return call


def orbax_refusal(resume: str) -> str:
    """The message for a `--resume` directory without `checkpoint.pth`,
    such as the JAX package's orbax directories: how to convert one."""
    return (f"--resume {resume}: no checkpoint.pth. The port reads its own "
            "torch.save checkpoints, not the JAX package's orbax "
            "directories; convert one in two steps:\n"
            f"  1. python -m gwdepth_tpu.convert.export_torch --resume "
            f"{resume} --template T.pth --out X.pth\n"
            "     (T.pth: any checkpoint of this port's main.py, or an "
            "original-code .pth, of the same model config)\n"
            "  2. --torch_init X.pth")


def load_weights(model: torch.nn.Module, resume: str,
                 torch_init: str) -> Optional[str]:
    """`--torch_init`: an original-code `.pth` through
    `predict.load_original_checkpoint`, as `main.py` warm-starts from it;
    else `--resume`: the weights of this port's `torch.save` checkpoint (a
    file, or a directory holding `checkpoint.pth`). Returns what was
    loaded, None for neither. A URL is refused."""
    from types import SimpleNamespace

    from gwdepth_tpu_torch.main import local_checkpoint
    from gwdepth_tpu_torch.predict import load_original_checkpoint
    from gwdepth_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                    restore_file)

    if torch_init:
        n = load_original_checkpoint(
            model, local_checkpoint(torch_init, "--torch_init"),
            warm_start=True)
        return f"{torch_init}: {n} tensors"
    if resume:
        path = local_checkpoint(resume, "--resume")
        if os.path.isdir(path):
            path = CheckpointManager(path).latest()
            if path is None:
                raise SystemExit(orbax_refusal(resume))
        restore_file(SimpleNamespace(model=model), path, params_only=True)
        return path
    return None


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser("GW-Depth model export (PyTorch/CUDA port)")
    p.add_argument("--output", required=True)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--torch_init", type=str, default="")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--eval_h", type=int, default=0)
    p.add_argument("--eval_w", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from gwdepth_tpu_torch.config import GWDepthConfig, tiny_test_config
    from gwdepth_tpu_torch.models import GlassRGBD, init_weights

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but CUDA is not available")
    cfg = tiny_test_config() if args.tiny else GWDepthConfig(dropout=0.0)
    if args.eval_h and args.eval_w:
        cfg = cfg.replace(eval_hw=(args.eval_h, args.eval_w))
    cfg = cfg.replace(use_pallas=args.device == "cuda")
    cfg.set_matmul_precision()

    # weights from seed 0 unless a checkpoint replaces them, as JAX's come
    # from PRNGKey(0)
    model = init_weights(GlassRGBD(cfg), 0)
    loaded = load_weights(model, args.resume, args.torch_init)
    if loaded:
        print(f"loaded {loaded}")
    out = save_exported(args.output, cfg, model, args.batch, args.device)
    print(f"exported {os.path.getsize(out) / 1e6:.1f} MB -> {out}")
    return out


if __name__ == "__main__":
    main()
