"""Import hygiene of the PyTorch port.

The port (`gwdepth_tpu_torch/`, `chip_smoke.py` and the card tests in
`tests/test_torch_cuda.py`, which run where JAX is absent) must never
import JAX, flax or the JAX package `gwdepth_tpu`, not even its
numpy-only modules (importing any of them runs `gwdepth_tpu/__init__.py`,
which pulls in `jax.numpy`). A `sys.modules` check inside this process cannot show that,
since the test harness imports jax first, so the first check reads every
source file's syntax tree, and the second runs the port in a fresh
interpreter in which those packages, and triton, cannot be imported and
no CUDA device is visible.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "gwdepth_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "tests/test_torch_cuda.py"])
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gwdepth_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if fname in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_port_files_found():
    assert "gwdepth_tpu_torch/__init__.py" in PORT_FILES
    assert "gwdepth_tpu_torch/ops/fused_conv.py" in PORT_FILES
    for rel in ("main.py", "engine.py", "ops/lap.py", "losses/criterion.py",
                "parallel/train_state.py", "parallel/train_step.py",
                "data/batch.py", "data/dataset.py", "tools/synthetic.py",
                "utils/logging.py", "utils/checkpoint.py",
                "ops/window_msa.py", "parallel/mesh.py",
                "data/depth_only.py", "models/geometry.py",
                "models/points.py", "tools/sne.py",
                "tools/depth_completion.py", "tools/reflection.py",
                "tools/raw_capture.py", "tools/pred_compare.py",
                "utils/profiling.py", "ops/tables.py",
                "tools/dispatch_census.py"):
        assert f"gwdepth_tpu_torch/{rel}" in PORT_FILES, rel
    assert len(PORT_FILES) >= 41


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_jax(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [f"{rel}:{line} imports {name}"
           for line, name in _imported_names(tree) if _forbidden(name)]
    assert not bad, "\n".join(bad)


def test_ast_check_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom gwdepth_tpu.config import x\n"
           "import importlib\nimportlib.import_module('flax.linen')\n"
           "from gwdepth_tpu_torch import ops\nimport torch\n")
    names = [n for _, n in _imported_names(ast.parse(src)) if _forbidden(n)]
    assert names == ["jax.numpy", "gwdepth_tpu.config", "flax.linen"]


_FRESH = r"""
import importlib, pkgutil, sys
import numpy as np
import torch

for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None        # any import of it now raises

assert not torch.cuda.is_available()
import gwdepth_tpu_torch
for mod in pkgutil.walk_packages(gwdepth_tpu_torch.__path__,
                                 'gwdepth_tpu_torch.'):
    importlib.import_module(mod.name)

from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.models import build_glassrgbd
cfg = tiny_test_config()
H, W = cfg.eval_hw
model = build_glassrgbd(cfg, 0, device='cpu')
x = torch.from_numpy(np.random.default_rng(0).normal(
    size=(1, H, W, 3)).astype(np.float32))
with torch.no_grad():
    out = model(x)
assert tuple(out['pred_depth'][-1].shape) == (1, H, W)
assert tuple(out['pred_seg'].shape) == (1, H, W, 2)
assert all(torch.isfinite(d).all() for d in out['pred_depth'])

from gwdepth_tpu_torch.data.batch import dummy_batch
from gwdepth_tpu_torch.parallel import create_train_state, make_train_step
state = create_train_state(cfg, model)
state, logs = make_train_step(cfg)(state, dummy_batch(cfg, 2),
                                   torch.Generator().manual_seed(0))
assert torch.isfinite(logs).all() and state.step == 1
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in BLOCKED and sys.modules[m] is not None)
assert not loaded, loaded
print('FRESH-OK')
"""


def test_port_runs_without_jax_triton_or_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    code = f"BLOCKED = {FORBIDDEN + ('triton',)!r}\n" + _FRESH
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "FRESH-OK" in res.stdout, \
        res.stdout[-2000:] + res.stderr[-4000:]
