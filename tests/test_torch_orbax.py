"""A model trained under JAX served by the port: the JAX package's orbax
checkpoint, converted by `gwdepth_tpu.convert.export_torch` with a
checkpoint written by the port's own `CheckpointManager` as the
template, loads strictly into the port and gives JAX's forward, on the
CPU, at the tiny config.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.convert import export_torch
from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.models import GlassRGBD
from gwdepth_tpu.parallel import create_train_state as jax_train_state
from gwdepth_tpu.utils.checkpoint import CheckpointManager as JaxManager

from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.export import load_weights
from gwdepth_tpu_torch.models import build_glassrgbd
from gwdepth_tpu_torch.parallel import create_train_state
from gwdepth_tpu_torch.predict import load_original_checkpoint
from gwdepth_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import _perturb

FWD_TOL = 1e-4


def test_orbax_checkpoint_serves_the_same_forward(tmp_path):
    cfg = jax_tiny()
    H, W = cfg.eval_hw
    model = GlassRGBD(cfg)
    image = np.random.default_rng(40).normal(
        size=(1, H, W, 3)).astype(np.float32)
    # JAX weights: a seeded port model's, through the JAX importer, then
    # perturbed, so that neither the template nor an init gives them
    src = build_glassrgbd(tiny_test_config(), 3, device="cpu")
    params = _perturb(glassrgbd_torch_to_flax(
        {k: v.numpy() for k, v in src.state_dict().items()}),
        np.random.default_rng(41))

    # the JAX package writes its orbax checkpoint
    jdir = tmp_path / "orbax"
    mgr = JaxManager(str(jdir))
    mgr.save(0, jax_train_state(cfg, jax.tree.map(jnp.asarray, params)),
             config=cfg)
    mgr.wait()
    mgr.close()

    # the port refuses the directory with the command that converts it
    port = build_glassrgbd(tiny_test_config(), 1, device="cpu")
    with pytest.raises(SystemExit, match="export_torch --resume"):
        load_weights(port, str(jdir), "")

    # the template: a checkpoint of the port's own writer
    pdir = tmp_path / "port"
    template = CheckpointManager(str(pdir)).save(
        0, create_train_state(tiny_test_config(), port))
    out = tmp_path / "from_jax.pth"
    # JAX's forward compiles in a thread while the converter compiles the
    # model's init (XLA compiles outside the interpreter lock)
    with ThreadPoolExecutor(1) as pool:
        jax_forward = pool.submit(lambda: jax.device_get(jax.jit(
            model.apply)({"params": params}, jnp.asarray(image))))
        export_torch.main(["--resume", str(jdir), "--template", template,
                           "--out", str(out)])
        want = jax_forward.result()

    served = build_glassrgbd(tiny_test_config(), 2, device="cpu").eval()
    n = load_original_checkpoint(served, str(out))
    assert n == len(served.state_dict())
    served.load_state_dict(torch.load(out, weights_only=False)["model"],
                           strict=True)
    with torch.no_grad():
        got = served(torch.from_numpy(image))
    # the served weights are the orbax checkpoint's, not the template's
    sd = served.state_dict()
    assert not torch.equal(sd["query_embed.weight"],
                           port.state_dict()["query_embed.weight"])
    pairs = [(got["pred_depth"][-1], want["pred_depth"][-1]),
             (got["pred_seg"], want["pred_seg"]),
             (got["pred_logits"], want["pred_logits"]),
             (got["pred_lines"], want["pred_lines"])]
    for g, w in pairs:
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=FWD_TOL * scale)
