"""Data parallelism of the port (`parallel/mesh.py`) on two gloo ranks on
the CPU, against the JAX package's step on a 2-device `data` mesh and
against the port in one process; tensor parallelism
(`parallel/partition.py`) on a `(1, 2)` and a `(2, 2)` mesh.

Two worker groups of W = 2 processes (`tests/torch_parallel_worker.py`,
torchrun's environment set by hand, one torch thread each, importing only
the port) start first: `lib` drives the library, `cli` the two CLIs; a
third worker, `one`, runs the training CLI in one process without
torchrun; `tp` (2 ranks, a `(1, 2)` mesh) drives tensor parallelism
through the library and `main.main --mesh 1,2`, and `tp4` (4 ranks, a
`(2, 2)` mesh) a toy module. All start at once. Meanwhile this process computes the JAX side on conftest's
virtual devices (`make_mesh((2,), ("data",))`; of the two meshed train
steps, two programs, one runs in a spawned process). Every rank takes its contiguous part of each global batch.

Tolerances:
  - `compute_losses` on 1 image a rank against JAX's on the 2-image batch:
    rtol 1e-5, atol 1e-6 (float32 against float32, reassociation only);
    the gradients of the total with respect to the model outputs, rank
    parts side by side, against one process's: 1e-6 of the largest.
  - 3 train steps against JAX's meshed step: losses 1e-5 relative
    (BF16_TAP_TOL with `use_pallas`); the first-step gradients (Adam's
    first moments / 0.1) within 1e-4 of the model's largest; the
    parameters by the Adam rule of
    `test_torch_train.test_trajectory_parameters_match_jax` (`PARAM_FAR`).
  - the same steps against one process of the port: losses 1e-6
    relative, the first step's gradients before the clip within 1e-6 of
    the largest (BF16_TAP_TOL and 1e-4 with `use_pallas`); `grad_accum=2`
    likewise, its gradients within 1e-5; parameters by the Adam rule.
  - `evaluate` against one process: metrics 1e-6 relative, line dumps
    1e-5; `main.main`'s first epoch (one step) 1e-6 relative; predict's
    depth `.npy` 1e-6 against one process at the ranks' batch size.
  - tensor parallel on `(1, 2)`, both ranks on the whole batch, against
    one process: losses 1e-6 relative, the first gradients before the
    clip within 1e-6 of the largest, the parameters after N_STEPS within
    1e-6 x max(1, |w|), with and without `use_pallas` (the clip takes
    the one-process norm, so the runs agree bit for bit on the CPU);
    against JAX's meshed step at the data-parallel test's bounds; the
    CLI's log.txt at 1e-6 relative; on `(2, 2)`, the toy's losses and
    clip norms at 1e-6 relative, its gradients within 1e-6 of the
    largest and its parameters within 1e-2 lr after 2 steps.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.data.batch import dummy_batch as jax_dummy_batch
from gwdepth_tpu.models import GlassRGBD as JGlassRGBD
from gwdepth_tpu.parallel import make_mesh as jax_make_mesh
from gwdepth_tpu.parallel import place_replicated
from gwdepth_tpu.parallel import train_state as jts
from gwdepth_tpu.parallel import train_step as jstep

from gwdepth_tpu_torch import main as pmain
from gwdepth_tpu_torch import predict as ppredict
from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.data.batch import dummy_batch
from gwdepth_tpu_torch.data.dataset import Loader
from gwdepth_tpu_torch.tools.synthetic import generate_dataset

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import _jax_adam_mu
from torch_parallel_worker import (FOCAL, N_STEPS, PLANE, FakeDS, cli_args,
                                   fake_outputs, loader_batches,
                                   losses_and_grads, mlp_for, mlp_input,
                                   model_for, predict_args)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
W = 2


# every worker group's processes end within this many seconds of their
# start (the fixture's setup alone took 141 s on an idle 8-core machine);
# a rank that cannot meet the others stops itself after the worker's
# JOIN_S, a stuck collective after COLLECTIVE_S
DEADLINE_S = 480
MODES = {"lib": W, "cli": W, "one": 1, "tp": 2, "tp4": 4}


def _spawn(mode, out, root, world=W):
    """`world` worker processes of `mode`; one alone runs without
    torchrun's environment, as a plain one-process run. Rank 0 of a group
    picks the rendezvous port itself (the worker's `join`), so no port
    chosen here can be taken by another process before the ranks meet."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT))
    if world > 1:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT="0",
                   WORLD_SIZE=str(world))
    procs = []
    for r in range(world):
        log = open(out / f"{mode}{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(out), str(root)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)) if world > 1
            else env, cwd=str(out), stdout=log, stderr=subprocess.STDOUT))
    return procs


def _wait(procs, mode, out, deadline):
    for p in procs:
        p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    for r, p in enumerate(procs):
        assert p.returncode == 0, (out / f"{mode}{r}.log").read_text()[-6000:]
    return [json.loads((out / f"{mode}{r}.json").read_text())
            for r in range(len(procs))]


def _jax_params(cfg):
    sd = {k: v.numpy() for k, v in model_for(cfg).state_dict().items()}
    return jax.tree.map(jnp.asarray, glassrgbd_torch_to_flax(sd))


def _jax_losses(kw):
    """JAX's compute_losses on the 2-image batch of the workers."""
    cfg = tiny_test_config(**kw)
    jcfg = jax_tiny(matcher="scipy", **kw)
    out = jax.tree.map(jnp.asarray, fake_outputs(cfg, 7))
    batch = jax_dummy_batch(jcfg, 2, num_lines=5, seed=7)
    _, logs = jax.jit(lambda o, b: jstep.compute_losses(jcfg, o, b))(
        out, batch)
    return {k: float(v) for k, v in logs.items()}


def _jax_cpu():
    """A spawned process's JAX on conftest's 8 virtual CPU devices (its
    XLA_FLAGS are inherited; the platform is set before any backend
    starts, as conftest sets it)."""
    jax.config.update("jax_platforms", "cpu")


def _jax_trajectory(use_pallas):
    """N_STEPS of JAX's train step on a 2-device data mesh: the log
    vectors, the first moments after step 1 and the final parameters,
    by the port's parameter names."""
    cfg = tiny_test_config(matcher="scipy", use_pallas=use_pallas)
    jcfg = jax_tiny(matcher="scipy", use_pallas=use_pallas)
    mesh = jax_make_mesh((W,), ("data",))
    state = place_replicated(jts.create_train_state(
        jcfg, _jax_params(cfg), steps_per_epoch=2), mesh)
    step = jstep.make_train_step(jcfg, JGlassRGBD(jcfg), mesh)
    logs, mu = [], None
    for i in range(N_STEPS):
        with mesh:
            state, vec = step(state, jax_dummy_batch(
                jcfg, 2, num_lines=3 + i, seed=i), jax.random.PRNGKey(i))
        logs.append(np.asarray(vec))
        if i == 0:
            mu = _jax_adam_mu(state)
    like = dict(model_for(cfg).named_parameters())
    return {"keys": list(step.log_keys), "logs": np.stack(logs),
            "mu": jax_params_to_state_dict(mu, {
                n: p for n, p in like.items() if p.requires_grad}),
            "params": jax_params_to_state_dict(
                jax.tree.map(np.asarray, state.params), like)}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    generate_dataset(str(root), 4, 3, height=96, width=128, seed=1)
    (root / "rgb_val").mkdir()
    for name in (root / "val.txt").read_text().split():
        shutil.copy(root / "rgb" / f"{name}.png", root / "rgb_val")
    outs = {m: tmp_path_factory.mktemp(m) for m in MODES}
    deadline = time.monotonic() + DEADLINE_S
    procs = {m: _spawn(m, outs[m], root, n) for m, n in MODES.items()}
    try:
        # the two meshed JAX steps (use_pallas off and on) are two
        # programs, traced and compiled at once: the second in a process
        # of its own, as the tracing holds the interpreter's lock
        with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"),
                                 initializer=_jax_cpu) as pool:
            other = pool.submit(_jax_trajectory, True)
            jax_side = {"losses": {n: _jax_losses(kw) for n, kw in (
                ("ce_plane", PLANE), ("focal", FOCAL))}}
            jax_side["train"] = {False: _jax_trajectory(False),
                                 True: other.result()}
        res = {m: _wait(procs[m], m, outs[m], deadline) for m in MODES}
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
    ckpt = str(outs["cli"] / "exp" / "checkpoints" / "checkpoint.pth")
    one = outs["one"]
    for sub, extra in (("pred", ["--resume", ckpt]),
                       ("pred_b1", ["--resume", ckpt, "--batch", "1"]),
                       ("pred_init", ["--torch_init", ckpt])):
        ppredict.main(predict_args(root, str(one / sub)) + extra)
    return dict(root=root, outs=outs, jax=jax_side, **res)


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------

def test_loader_shares_are_contiguous_parts_of_the_global_batches(dp):
    one_eval = loader_batches(Loader(FakeDS(5), 4, shuffle=False,
                                     drop_last=False, pad_to_batch=True,
                                     num_workers=1))
    one_train = loader_batches(Loader(FakeDS(9), 4, seed=3, num_workers=2),
                               epoch=1)
    for key, one in (("eval_batches", one_eval),
                     ("train_batches", one_train)):
        parts = [r[key] for r in dp["lib"]]
        assert all(len(p) == len(one) for p in parts)
        for bi, (names, depth, ok) in enumerate(one):
            got = [parts[r][bi] for r in range(W)]
            # rank r holds the r-th half of the global batch
            assert sum((g[0] for g in got), []) == names, key
            assert sum((g[1] for g in got), []) == depth, key
            assert sum((g[2] for g in got), []) == ok, key
    # the odd tail: rank 0 holds s4 and a pad, rank 1 two pads
    assert one_eval[-1] == (["s4"], [5.0, 0.0, 0.0, 0.0],
                            [True, False, False, False])
    assert dp["lib"][1]["eval_batches"][-1] == [[], [0.0, 0.0],
                                                [False, False]]


def test_meter_sync_sums_count_and_total(dp):
    for r in range(W):
        assert dp["lib"][r]["meter"] == [3, 13.0]


def test_checkpoint_written_once_and_restored_on_every_rank(dp):
    for r in range(W):
        res = dp["lib"][r]
        assert res["ckpt_files"] == ["checkpoint.pth"]
        assert res["ckpt_epoch"] == 1 and res["ckpt_equal"]


@pytest.mark.parametrize("name", ["ce_plane", "focal"])
def test_compute_losses_over_ranks_match_jax(dp, name):
    kw = dict(ce_plane=PLANE, focal=FOCAL)[name]
    want = dp["jax"]["losses"][name]
    got = [dp["lib"][r]["losses"][name] for r in range(W)]
    assert got[0] == got[1]                      # one global value
    assert set(got[0]) == set(want)
    if name == "ce_plane":
        assert "loss_plane" in want and want["loss_plane"] > 0
    for k in want:
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the gradients: each rank's part is the global loss's gradient
    cfg = tiny_test_config(**kw)
    _, one = losses_and_grads(cfg, fake_outputs(cfg, 7), slice(None),
                              dummy_batch(cfg, 2, num_lines=5, seed=7))
    parts = [np.load(dp["outs"]["lib"] / f"loss_grads_{name}{r}.npz")
             for r in range(W)]
    top = max(float(np.abs(g).max()) for g in one)
    for i, g in enumerate(one):
        got_g = np.concatenate([p[f"arr_{i}"] for p in parts])
        np.testing.assert_allclose(got_g, g, rtol=0, atol=1e-6 * top,
                                   err_msg=f"output {i}")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# Adam moves an element by about lr x the sign of its first gradient, so an
# element whose gradient is float noise around zero (another summation
# order, another batch split) may move up to 2 lr a step the other way;
# every element is held to that bound, and all but PARAM_FAR of them to
# 1e-2 lr, as `test_torch_train.test_trajectory_parameters_match_jax`.
# With K2's bf16 taps the first gradients differ by about 1e-4 relative L2
# (4e-3 in the dense branch's backbone projections), and the elements that
# small a change turns are more: 0.41 % past 1e-2 lr against JAX, 0.35 %
# against one process, so PARAM_FAR_BF16.
PARAM_FAR = 1e-3
PARAM_FAR_BF16 = 1e-2
# K2's bf16 taps (`use_pallas`) turn float32 noise that puts an activation
# on the other side of a bf16 rounding boundary into a bf16 step of that
# tap; the whole tiny model is held to this in `tests/test_torch_model.py`
BF16_TAP_TOL = 1e-4


def _lr(cfg, name):
    return cfg.lr_backbone if name.startswith("backbone.") else cfg.lr


def _check_logs(got, want, rtol):
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * np.maximum(1.0, np.abs(want)) + 1e-12)


def _check_grads(got, want, tol):
    """Every element within tol of the model's largest gradient."""
    G = max(float(v.abs().max()) for v in want.values())
    assert set(got) == set(want)
    for n, w in want.items():
        gap = float((got[n].double() - w.double()).abs().max())
        assert gap <= tol * G, (n, gap / G)


def _check_params(got, want, cfg, steps):
    far = total = 0
    frac = PARAM_FAR_BF16 if cfg.use_pallas else PARAM_FAR
    for n, w in want.items():
        diff = (got[n].double() - w.double()).abs()
        lr = _lr(cfg, n)
        assert float(diff.max()) <= 2 * lr * steps + 1e-6, n
        far += int((diff > 1e-2 * lr).sum())
        total += diff.numel()
    assert far <= frac * total, (far, total)


def _train(dp, up):
    return torch.load(dp["outs"]["lib"] / f"train_{up}.pt",
                      weights_only=False)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_steps_over_ranks_match_jax_meshed_step(dp, use_pallas):
    """3 steps, one image a rank, against JAX's step on a 2-device data
    mesh over the 2-image batch; both ranks log the same global vector
    and hold the same parameters."""
    run, jrun = _train(dp, use_pallas)["dp"], dp["jax"]["train"][use_pallas]
    cfg = tiny_test_config(use_pallas=use_pallas)
    assert run["keys"] == jrun["keys"]
    for r in range(W):
        res = dp["lib"][r]["train"][str(use_pallas)]
        np.testing.assert_array_equal(res["logs"], run["logs"])
        assert res["rank_gap"] == 0.0
    _check_logs(run["logs"], jrun["logs"],
                BF16_TAP_TOL if use_pallas else 1e-5)
    _check_grads(run["mu"], jrun["mu"], 1e-4)
    _check_params(run["params"], jrun["params"], cfg, N_STEPS)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_steps_over_ranks_match_one_process(dp, use_pallas):
    """The same steps against the port's one-process step on the 2-image
    batch. Each rank's forward runs at batch 1, whose CPU kernels block
    the sums otherwise: float32 noise, which K2's bf16 taps turn into
    rounding flips (BF16_TAP_TOL)."""
    runs = _train(dp, use_pallas)
    run, one = runs["dp"], runs["one"]
    cfg = tiny_test_config(use_pallas=use_pallas)
    assert run["keys"] == one["keys"]
    _check_logs(run["logs"], one["logs"], BF16_TAP_TOL if use_pallas
                else 1e-6)
    _check_grads(run["grads"], one["grads"], 1e-4 if use_pallas else 1e-6)
    _check_params(run["params"], one["params"], cfg, N_STEPS)


def test_grad_accum_over_ranks_matches_one_process(dp):
    """`grad_accum=2` with 2 images a rank (image i of the 4 in microbatch
    i % 2 on either side) against one process's step on the 4 images."""
    runs = torch.load(dp["outs"]["lib"] / "accum.pt", weights_only=False)
    run, one = runs["dp"], runs["one"]
    _check_logs(run["logs"], one["logs"], 1e-6)
    _check_grads(run["grads"], one["grads"], 1e-5)
    _check_params(run["params"], one["params"],
                  tiny_test_config(grad_accum=2), 1)


def test_evaluate_over_ranks_matches_one_process(dp):
    """3 images at eval_batch_size 2 (the last batch padded, rank 1's part
    of it padding only): every rank has the global metrics; rank 0 has the
    line dumps in dataset order."""
    (s0, d0), (s1, d1) = dp["lib"][0]["eval"], dp["lib"][1]["eval"]
    so, do = dp["lib"][0]["eval_one"]
    assert s0 == s1 and d1 == []
    assert set(s0) == set(so)
    for k in so:
        np.testing.assert_allclose(s0[k], so[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    assert [d["name"] for d in d0] == [d["name"] for d in do] == [
        "synth_00004", "synth_00005", "synth_00006"]
    for a, b in zip(d0, do):
        assert a["extent"] == b["extent"]
        for k in ("pred_logits", "pred_lines"):
            # batch 1 a rank against batch 2: float32 noise
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _tp_train(dp, up):
    return torch.load(dp["outs"]["tp"] / f"tp_train_{up}.pt",
                      weights_only=False)


def test_split_mlp_matches_the_replicated_one(dp):
    """`linear1` split by output features and `linear2` by input features
    over 2 gloo ranks, gathered at use: the replicated MLP's output (the
    port's `test_partition.py::test_place_params_and_matmul_semantics`)."""
    with torch.no_grad():
        want = mlp_for()(mlp_input()).numpy()
    for r in range(2):
        got = dp["tp"][r]["mlp"]
        assert got["shards"] == {
            "linear1.weight": [8, 8], "linear1.bias": [16],
            "linear2.weight": [4, 8], "linear2.bias": [4],
            "norm.weight": [4], "norm.bias": [4]}
        np.testing.assert_allclose(np.asarray(got["y"]), want, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tensor_parallel_steps_match_one_process_and_jax(dp, use_pallas):
    """N_STEPS of the train step on a (1, 2) mesh, each rank on the whole
    2-image batch with half of every split weight, against the port's one
    process on that batch and JAX's step on a 2-device data mesh; each
    split tensor and its AdamW moments are half of the full size on each
    rank."""
    run = _tp_train(dp, use_pallas)
    one = _train(dp, use_pallas)["one"]
    jrun = dp["jax"]["train"][use_pallas]
    cfg = tiny_test_config(use_pallas=use_pallas)
    for r in range(2):
        np.testing.assert_array_equal(
            dp["tp"][r][f"train_{use_pallas}"]["logs"], run["logs"])
    assert run["keys"] == one["keys"] == jrun["keys"]
    _check_logs(run["logs"], one["logs"], 1e-6)
    _check_grads(run["grads"], one["grads"], 1e-6)
    assert set(run["params"]) == set(one["params"])
    for n, w in one["params"].items():
        gap = (run["params"][n].double() - w.double()).abs()
        assert bool((gap <= 1e-6 * w.double().abs().clamp(min=1.0)).all()), n
    _check_logs(run["logs"], jrun["logs"],
                BF16_TAP_TOL if use_pallas else 1e-5)
    _check_grads(run["mu"], jrun["mu"], 1e-4)
    _check_params(run["params"], jrun["params"], cfg, N_STEPS)
    sizes = dp["tp"][0][f"train_{use_pallas}"]["sizes"]
    assert len(sizes) > 100
    for n, (full, local, moment) in sizes.items():
        assert 2 * local == full and moment in (local, None), n
    assert any(m is not None for _, _, m in sizes.values())


def test_two_axis_mesh_counts_each_image_and_shard_once(dp):
    """A (2, 2) mesh of 4 ranks: each data coordinate's contiguous half
    of the batch on both its model ranks; sums, meters and gathers over
    the data group only; the toy's two steps (losses, gradients before
    the clip, the clip's norm, parameters) against one process on the
    whole batch."""
    res = dp["tp4"]
    for r, x in enumerate(res):
        d = r // 2
        assert (x["data_rank"], x["model_rank"]) == (d, r % 2)
        assert x["share"] == [2 * d, 2 * d + 2]
        assert x["loader"] == [[[f"s{2 * d}", f"s{2 * d + 1}"],
                                [2.0 * d + 1, 2.0 * d + 2], [True, True]]]
        assert x["sum_host"] == [3.0] and x["meter"] == [2, 5.0]
        assert x["tp"]["local"]["linear1.weight"] == [8, 8]
        assert x["tp"]["local"]["linear2.weight"] == [4, 8]
        assert x["tp"]["losses"] == res[0]["tp"]["losses"]
    assert res[0]["gather"] == [["obj", 0, 0], ["obj", 1, 0]]
    assert all(x["gather"] is None for x in res[1:])
    tp, one = res[0]["tp"], res[0]["one"]
    np.testing.assert_allclose(tp["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(tp["norms"], one["norms"], rtol=1e-6)
    # the clip is active: the norm is above the configured 0.05
    assert min(one["norms"]) > 0.05
    for got, want in zip(tp["grads"], one["grads"]):
        top = max(np.abs(np.asarray(v)).max() for v in want.values())
        for n, w in want.items():
            np.testing.assert_allclose(np.asarray(got[n]), np.asarray(w),
                                       rtol=0, atol=1e-6 * top, err_msg=n)
    lr = tiny_test_config(lr=1e-2).lr
    for n, w in one["params"].items():
        np.testing.assert_allclose(np.asarray(tp["params"][n]),
                                   np.asarray(w), rtol=0, atol=1e-2 * lr,
                                   err_msg=n)


def test_main_tensor_parallel_logs_and_checkpoints_as_one_process(dp):
    """`main.main --mesh 1,2` (2 epochs, the second after `--resume`):
    the one-process log.txt; its checkpoint holds whole tensors and
    restores in one process to the ranks' gathered weights; restored on
    the split mesh (`--resume`) it gives them back, and a one-process
    checkpoint restored there gives back its weights and AdamW moments."""
    got = _log(dp["outs"]["tp"] / "exp" / "log.txt")
    want = _log(dp["outs"]["one"] / "exp" / "log.txt")
    assert [l["epoch"] for l in got] == [l["epoch"] for l in want] == [0, 1]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=1e-6, err_msg=k)
    for x in dp["tp"]:
        assert x["cli_step"] == 2 and x["resume_epoch"] == 2
        assert x["resume_equal"] and x["resume_local_shapes"]
        assert x["solo_epoch"] == 1 and x["solo_params_equal"]
        assert x["solo_moments_equal"]
    from gwdepth_tpu_torch.parallel import create_train_state
    from gwdepth_tpu_torch.utils.checkpoint import restore_file

    ckpt = dp["outs"]["tp"] / "exp" / "checkpoints" / "checkpoint.pth"
    cfg = pmain.config_from_args(pmain.build_argparser().parse_args(
        cli_args(dp["root"], "unused")))
    state = create_train_state(cfg, model_for(cfg))
    assert restore_file(state, str(ckpt)) == 2 and state.step == 2
    final = torch.load(dp["outs"]["tp"] / "tp_cli_params.pt",
                       weights_only=False)
    params = dict(state.model.named_parameters())
    assert set(final) == set(params)
    for n, p in params.items():
        assert torch.equal(p.detach(), final[n]), n
    split = set(dp["tp"][0]["split_names"])
    moments = {n: state.optimizer.state[p]["exp_avg"]
               for n, p in params.items() if p in state.optimizer.state}
    assert split & set(moments)
    for n in split & set(moments):
        assert moments[n].shape == params[n].shape, n


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_kernels_refuse_a_dtensor(dp, kernel):
    """K1's and K2's entries raise on a DTensor weight, on either rank,
    rather than take any path with it."""
    for x in dp["tp"]:
        msg = x["guard"][kernel]
        assert msg is not None and "DTensor" in msg, msg


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _log(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_main_over_ranks_logs_the_one_process_losses(dp):
    """`main.main` on 2 ranks: one log.txt and eval_results.txt (rank 0's),
    the first epoch's train losses those of one process (one step of 4
    images, 2 a rank), the same parameters on both ranks, and `--resume`
    continuing on both ranks from rank 0's checkpoint."""
    got = _log(dp["outs"]["cli"] / "exp" / "log.txt")
    want = _log(dp["outs"]["one"] / "exp" / "log.txt")
    assert [l["epoch"] for l in got] == [l["epoch"] for l in want] == [0, 1]
    assert list(got[0]) == list(want[0])
    for k, v in want[0].items():
        if k.startswith("train_"):
            np.testing.assert_allclose(got[0][k], v, rtol=1e-6, err_msg=k)
    evals = (dp["outs"]["cli"] / "exp" / "eval_results.txt").read_text()
    assert len(evals.splitlines()) == 2
    for r in range(W):
        assert dp["cli"][r]["step"] == 2 and dp["cli"][r]["rank_gap"] == 0.0
    ckpt = torch.load(dp["outs"]["cli"] / "exp" / "checkpoints" /
                      "checkpoint.pth", weights_only=False)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 2
    assert sorted(os.listdir(dp["outs"]["cli"] / "exp" / "checkpoints")) \
        == ["checkpoint.pth"]


def _files(d):
    return sorted(os.listdir(d))


def test_predict_mesh_writes_the_one_process_files(dp):
    """`predict.main --mesh 2 --batch 2` (each rank its image of every
    batch, the tail batch padded): the files of one process at `--batch 1`
    (the same forward per image), byte for byte but the depth `.npy`
    (1e-6), and the depth of one process at `--batch 2` within float32
    noise of the other batch size."""
    got, one = dp["outs"]["cli"] / "pred", dp["outs"]["one"]
    assert _files(got) == _files(one / "pred_b1") == _files(one / "pred")
    assert len(_files(got)) == 3 * 4
    for f in _files(got):
        a = got / f
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(a),
                                       np.load(one / "pred_b1" / f),
                                       rtol=0, atol=1e-6)
            want = np.load(one / "pred" / f)
            np.testing.assert_allclose(np.load(a), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        else:
            assert a.read_bytes() == (one / "pred_b1" / f).read_bytes(), f


def test_predict_resume_reads_the_ports_checkpoint(dp):
    """`--resume checkpoint.pth` of `main.py` loads the weights that
    `--torch_init` of the same file loads: the same outputs."""
    one = dp["outs"]["one"]
    assert _files(one / "pred") == _files(one / "pred_init")
    for f in _files(one / "pred"):
        assert (one / "pred" / f).read_bytes() == \
            (one / "pred_init" / f).read_bytes(), f


def test_predict_resume_refuses_an_orbax_directory(dp, tmp_path):
    (tmp_path / "ckpt" / "0").mkdir(parents=True)
    with pytest.raises(SystemExit, match="not the JAX package's orbax"):
        ppredict.main(["--images", str(dp["root"] / "rgb_val"),
                       "--output_dir",
                       str(tmp_path / "o"), "--tiny", "--device", "cpu",
                       "--resume", str(tmp_path / "ckpt")])


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "1"], "spans the torchrun world, 2"),
    (["--mesh", "4"], "spans the torchrun world, 2"),
    (["--mesh", "2,2"], "tensor parallelism"),
    (["--mesh", "2", "--batch_size", "3"], "--batch_size 3 must be a "
                                           "multiple of the 2 ranks"),
    (["--eval_batch_size", "1"], "--eval_batch_size 1 must be a multiple"),
    (["--grad_accum", "4"], "--grad_accum 4 must divide each rank.s batch, 2"),
])
def test_main_refuses_a_mesh_or_batch_the_world_does_not_fit(
        tmp_path, monkeypatch, argv, match):
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        pmain.main(cli_args(tmp_path, str(tmp_path / "o")) + argv)


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "1"], "spans the torchrun world, 2"),
    (["--mesh", "2", "--batch", "3"], "--batch 3 must be a multiple of "
                                      "--mesh 2"),
])
def test_predict_refuses_a_mesh_or_batch_the_world_does_not_fit(
        tmp_path, monkeypatch, argv, match):
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        ppredict.main(predict_args(tmp_path, str(tmp_path / "o"))[:-2]
                      + argv)
