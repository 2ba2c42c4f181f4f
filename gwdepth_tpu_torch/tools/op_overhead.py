"""Host cost of the ways to bind K1 and K2 to PyTorch, on one card.

Each binding reaches the same launch (`_launch` of `ops/ref_attn_diffusion`
and `ops/fused_conv`) and, with gradients, the same backward
(`_setup_context` and `_backward` of each module):

- `bare`: `_launch` itself, no binding;
- `function`: a `torch.autograd.Function` around `_launch`, the binding
  the custom ops replaced;
- `custom_op`: the shipped op (`torch.ops.gwdepth.*`, registered with
  `torch.library.custom_op`), called directly;
- `entry`: the public entry (`ref_attn_diffusion`, `conv3x3_ln_act`), the
  op behind its device check and dtype cast;
- `library`: the same launch registered with `torch.library.Library`
  (`define`, an `impl` for the CUDA dispatch key, `register_fake`,
  `register_autograd`) in a namespace of its own.

At a serving K1 plane (1, 980, 40, 16) and a serving K2 link (1/4 level,
1 x 192 x 256, 160 -> 160 channels, LayerNorm, GELU), each binding is
timed on the host clock over `--calls` calls without a synchronisation
(so the time is the host's, while the card works through the queue): no
gradients, inputs that require gradients (the train step's forward), and
forward and backward (`torch.autograd.grad`, `--calls` // 10 a repeat, so
the queue never fills). Each binding is read twice, the second pass in
reverse order; the median of `--repeats` repeats of each reading, in us a
call, goes out as one JSON line, with the card's name and power limit:

    python -m gwdepth_tpu_torch.tools.op_overhead [--calls 200] [--repeats 7]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from gwdepth_tpu_torch.ops import fused_conv as k2
from gwdepth_tpu_torch.ops import ref_attn_diffusion as k1


def _function(launch, setup_context, backward):
    """`launch` as a `torch.autograd.Function` with the module's own
    context setup and backward."""

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            out = launch(*args)
            setup_context(ctx, args, out)
            return out

        @staticmethod
        def backward(ctx, ct):
            return backward(ctx, ct)

    return Fn.apply


def _k2_launch(x, w, g, b, r, act, fast):
    return k2._launch(x, w, g, b, r, None if act == "none" else act, fast)


def _library():
    """Both launches as `torch.library.Library` ops; returns the library
    (keep it alive) and the two op overloads."""
    lib = torch.library.Library("gwdepth_probe", "FRAGMENT")
    lib.define("k1(Tensor a, Tensor w, Tensor b) -> Tensor")
    lib.define("k2(Tensor x, Tensor w, Tensor? g, Tensor? b, Tensor? r, "
               "str act, bool fast) -> Tensor")
    lib.impl("k1", k1._launch, "CUDA")
    lib.impl("k2", _k2_launch, "CUDA")
    torch.library.register_fake(
        "gwdepth_probe::k1",
        lambda a, w, b: a.new_empty(a.shape, dtype=torch.float32), lib=lib)
    torch.library.register_fake(
        "gwdepth_probe::k2",
        lambda x, w, g, b, r, act, fast: x.new_empty(
            (*x.shape[:3], w.shape[3]), dtype=torch.float32), lib=lib)
    torch.library.register_autograd(
        "gwdepth_probe::k1", k1._backward, setup_context=k1._setup_context,
        lib=lib)
    torch.library.register_autograd(
        "gwdepth_probe::k2", k2._backward, setup_context=k2._setup_context,
        lib=lib)
    return lib, torch.ops.gwdepth_probe.k1.default, \
        torch.ops.gwdepth_probe.k2.default


def _inputs(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((1, 980, 40, 16), device=dev, generator=g)
    w = 0.1 * torch.randn((3, 3, 16, 16), device=dev, generator=g)
    b = 0.1 * torch.randn((16,), device=dev, generator=g)
    x = torch.randn((1, 192, 256, 160), device=dev, generator=g)
    w2 = 0.05 * torch.randn((3, 3, 160, 160), device=dev, generator=g)
    g2 = torch.ones((160,), device=dev)
    b2 = torch.zeros((160,), device=dev)
    return (a, w, b), (x, w2, g2, b2, None, "gelu", True)


def _host_us(fn, args, calls, repeats, grad_of=None):
    """Median over `repeats` of the host time of `calls` calls, in us a
    call; with `grad_of` (indices of args), each call also runs the
    backward to those inputs."""
    def once():
        y = fn(*args)
        if grad_of is not None:
            torch.autograd.grad(y, [args[i] for i in grad_of],
                                torch.ones_like(y))

    for _ in range(3):
        once()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            once()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("host cost of the K1/K2 bindings")
    p.add_argument("--calls", type=int, default=200)
    p.add_argument("--repeats", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, lib_k1, lib_k2 = _library()
    k1_args, k2_args = _inputs("cuda")
    bindings = {
        "k1": {"bare": k1._launch,
               "function": _function(k1._launch, k1._setup_context,
                                     k1._backward),
               "custom_op": torch.ops.gwdepth.ref_attn_diffusion.default,
               "entry": k1.ref_attn_diffusion,
               "library": lib_k1},
        "k2": {"bare": _k2_launch,
               "function": _function(_k2_launch, k2._setup_context,
                                     k2._backward),
               "custom_op": torch.ops.gwdepth.conv3x3_ln_act.default,
               "entry": lambda x, w, g, b, r, act, fast: k2.conv3x3_ln_act(
                   x, w, g, b, r, act, fast),
               "library": lib_k2}}
    res = {"card": card(), "calls": args.calls, "repeats": args.repeats}
    names = list(bindings["k1"])
    # two passes, the second in reverse order, so drift shows as a
    # difference between a binding's two readings
    for order in (names, names[::-1]):
        for kernel, base in (("k1", k1_args), ("k2", k2_args)):
            grad_args = tuple(t.detach().requires_grad_()
                              if isinstance(t, torch.Tensor) else t
                              for t in base)
            inputs = [i for i, t in enumerate(base[:4])
                      if isinstance(t, torch.Tensor)]
            for name in order:
                fn = bindings[kernel][name]
                rec = res.setdefault(f"{kernel}_{name}", {})
                with torch.no_grad():
                    rec.setdefault("no_grad_us", []).append(
                        _host_us(fn, base, args.calls, args.repeats))
                if name == "bare":
                    continue
                rec.setdefault("grad_fwd_us", []).append(
                    _host_us(fn, grad_args, args.calls, args.repeats))
                rec.setdefault("fwd_bwd_us", []).append(
                    _host_us(fn, grad_args, max(1, args.calls // 10),
                             args.repeats, grad_of=inputs))
    del lib
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
