"""One gloo rank on the CPU for `tests/test_torch_parallel.py`.

Run with torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`), or for `one` without it, as

    python tests/torch_parallel_worker.py lib|cli|one OUT_DIR DATA_ROOT

Run as a script it imports only the port: the JAX packages are blocked
before anything else is imported (the test imports its helpers). `lib` drives the library (loader shares, meters,
checkpoint, `compute_losses`, the train step with and without
`use_pallas`, `grad_accum`, `evaluate`), rank 0 also the one-process
references; `cli` drives `main.main` (an epoch, then `--resume`) and
`predict.main --mesh 2`; `one` drives `main.main` in one process, the
reference of `cli`. Each rank writes `{mode}{rank}.json`; rank 0
writes the train runs' tensors to `{mode}_*.pt`.
"""

import sys

if __name__ == "__main__":
    for _name in ("jax", "jaxlib", "flax", "optax", "orbax", "gwdepth_tpu"):
        sys.modules[_name] = None            # any import of them raises

import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

N_STEPS = 3
FOCAL = dict(label_loss_func="focal_loss")
PLANE = dict(with_plane_norm_loss=True, num_queries=28)


class FakeDS:
    """n samples; sample i's depth is i + 1 everywhere."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, seed=None):
        return {"images": np.zeros((4, 6, 3), np.float32),
                "valid": np.ones((4, 6), bool),
                "depth": np.full((4, 6), float(i + 1), np.float32),
                "seg": np.zeros((4, 6), np.int32),
                "lines": np.zeros((2, 6), np.float32),
                "line_mask": np.zeros((2,), bool),
                "name": f"s{i}"}


def loader_batches(loader, epoch=0):
    """[(names, first depth value per image, image valid)] of an epoch."""
    return [(names, batch.depth[:, 0, 0].tolist(),
             batch.valid.any(dim=2).any(dim=1).tolist())
            for batch, names in loader.epoch(epoch)]


def fake_outputs(cfg, seed, B=2):
    """Seeded model outputs at `cfg`'s train canvas, as numpy arrays: the
    line head's logits and lines (final and 2 aux layers), the 4 depth
    scales and the seg logits (NHWC)."""
    rng = np.random.default_rng(seed)
    H, W = cfg.train_hw
    Q = cfg.num_queries

    def f(*shape, lo=None, hi=None):
        if lo is not None:
            return rng.uniform(lo, hi, shape).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    logits = f(B, Q, 2)
    logits[..., 0] += 1.5                    # plane-loss triangles pass
    out = {"pred_logits": logits, "pred_lines": f(B, Q, 6, lo=0.05, hi=0.95),
           "aux_outputs": [{"pred_logits": f(B, Q, 2),
                            "pred_lines": f(B, Q, 6, lo=0.05, hi=0.95)}
                           for _ in range(2)],
           "pred_depth": [f(B, H // s, W // s, lo=0.5, hi=9.0)
                          for s in (16, 8, 4, 1)],
           "pred_seg": f(B, H, W, 2)}
    return out


def torch_outputs(out, sl):
    """The numpy outputs' images `sl` as leaf tensors that want grads."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[sl])).requires_grad_()
    return {"pred_logits": t(out["pred_logits"]),
            "pred_lines": t(out["pred_lines"]),
            "aux_outputs": [{k: t(v) for k, v in a.items()}
                            for a in out["aux_outputs"]],
            "pred_depth": [t(d) for d in out["pred_depth"]],
            "pred_seg": t(out["pred_seg"])}


def output_leaves(out):
    return [out["pred_logits"], out["pred_lines"],
            *[v for a in out["aux_outputs"] for v in a.values()],
            *out["pred_depth"], out["pred_seg"]]


def losses_and_grads(cfg, out, sl, batch, reduce=None):
    """compute_losses on images `sl` of the outputs: (logs, grads of the
    total with respect to every output, in `output_leaves` order)."""
    from gwdepth_tpu_torch.parallel import compute_losses

    t = torch_outputs(out, sl)
    kw = {} if reduce is None else {"reduce": reduce}
    total, logs = compute_losses(cfg, t, batch.map(lambda x: x[sl]), **kw)
    total.backward()
    return ({k: float(v.detach()) for k, v in logs.items()},
            [x.grad.numpy() for x in output_leaves(t)])


def solo():
    """This process alone, also inside a process group."""
    from gwdepth_tpu_torch.parallel.mesh import DataMesh
    return DataMesh((1,), ("data",), 0, 1, False)


def model_for(cfg):
    from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights
    return init_weights(GlassRGBD(cfg), 0)


def train_run(cfg, batches, mesh=None, part=slice(None)):
    """N steps of the port's train step from the seeded weights, each on
    images `part` of its batch, over `mesh` (default: this process
    alone): the log vectors, the gradients of step 1
    before the clip (summed over ranks: a sum or mean slip would show
    here, where the clip and Adam would hide a common factor), the first
    moments after step 1 (the clipped gradient x 0.1) and the final
    parameters."""
    from gwdepth_tpu_torch.parallel import create_train_state, make_train_step

    model = model_for(cfg)
    state = create_train_state(cfg, model, steps_per_epoch=2,
                               mesh=mesh or solo())
    step = make_train_step(cfg)
    clip = torch.nn.utils.clip_grad_norm_
    first = {}

    def spy(params, *args, **kw):
        params = list(params)
        if not first:
            first.update({id(p): p.grad.clone() for p in params})
        return clip(params, *args, **kw)

    logs, mu = [], None
    torch.nn.utils.clip_grad_norm_ = spy
    try:
        for i, batch in enumerate(batches):
            state, vec = step(state, batch.map(lambda t: t[part]),
                              torch.Generator().manual_seed(i))
            logs.append(vec.numpy())
            if i == 0:
                mu = {n: state.optimizer.state[p]["exp_avg"].clone()
                      for n, p in model.named_parameters()
                      if p.requires_grad}
    finally:
        torch.nn.utils.clip_grad_norm_ = clip
    return {"keys": list(step.log_keys), "logs": np.stack(logs), "mu": mu,
            "grads": {n: first[id(p)] for n, p in model.named_parameters()
                      if id(p) in first},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}


def max_rank_gap(mesh, tensors):
    """Largest |rank r's tensor - rank 0's| over the tensors."""
    gap = 0.0
    for t in tensors:
        ref = t.clone()
        mesh.broadcast_([ref])
        gap = max(gap, float((t - ref).abs().max()))
    return gap


def lib(mesh, out_dir, root):
    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.data.batch import dummy_batch
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.engine import evaluate
    from gwdepth_tpu_torch.parallel import (create_train_state,
                                            make_eval_step)
    from gwdepth_tpu_torch.utils.checkpoint import CheckpointManager
    from gwdepth_tpu_torch.utils.logging import SmoothedValue

    r, W = mesh.rank, mesh.world
    res = {"rank": r}
    # loader shares: a padded odd tail, and a shuffled train epoch
    res["eval_batches"] = loader_batches(Loader(
        FakeDS(5), 4, shuffle=False, drop_last=False, pad_to_batch=True,
        num_workers=1, rank=r, world=W))
    res["train_batches"] = loader_batches(Loader(
        FakeDS(9), 4, seed=3, num_workers=2, rank=r, world=W), epoch=1)

    m = SmoothedValue()
    for v in ([1.0, 2.0] if r == 0 else [10.0]):
        m.update(v)
    m.sync(mesh)
    res["meter"] = [m.count, m.total]

    # compute_losses on 1 image a rank, against the 2-image batch
    res["losses"] = {}
    for name, kw in (("ce_plane", PLANE), ("focal", FOCAL)):
        cfg = tiny_test_config(**kw)
        out = fake_outputs(cfg, 7)
        batch = dummy_batch(cfg, 2, num_lines=5, seed=7)
        logs, grads = losses_and_grads(cfg, out, mesh.share(2), batch,
                                       mesh.all_sum)
        res["losses"][name] = logs
        np.savez(os.path.join(out_dir, f"loss_grads_{name}{r}.npz"), *grads)

    # the train step, 3 steps, without and with use_pallas
    res["train"] = {}
    for up in (False, True):
        cfg = tiny_test_config(matcher="scipy", use_pallas=up)
        batches = [dummy_batch(cfg, 2, num_lines=3 + i, seed=i)
                   for i in range(N_STEPS)]
        dp = train_run(cfg, batches, mesh, mesh.share(2))
        res["train"][str(up)] = {
            "logs": dp["logs"].tolist(), "keys": dp["keys"],
            "rank_gap": max_rank_gap(mesh, list(dp["params"].values()))}
        if mesh.is_main:
            torch.save({"dp": dp, "one": train_run(cfg, batches)},
                       os.path.join(out_dir, f"train_{up}.pt"))

    # grad_accum 2 with 2 images a rank, against one process's 4
    cfg = tiny_test_config(matcher="scipy", grad_accum=2)
    batches = [dummy_batch(cfg, 4, num_lines=4, seed=11)]
    dp = train_run(cfg, batches, mesh, mesh.share(4))
    if mesh.is_main:
        torch.save({"dp": dp, "one": train_run(cfg, batches)},
                   os.path.join(out_dir, "accum.pt"))

    # checkpoint: rank 0 writes one file, both ranks restore it
    cfg = tiny_test_config()
    state = create_train_state(cfg, model_for(cfg), mesh=mesh)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
    ckpt.save(0, state, cfg)
    fresh = create_train_state(cfg, model_for(cfg), mesh=mesh)
    res["ckpt_epoch"] = ckpt.restore(fresh)
    res["ckpt_equal"] = all(torch.equal(a, b) for a, b in zip(
        state.model.parameters(), fresh.model.parameters()))
    res["ckpt_files"] = sorted(os.listdir(os.path.join(out_dir, "ckpt")))

    # evaluate: 3 images at eval_batch_size 2 (the last batch padded)
    cfg = tiny_test_config(
        data_path=f"{root}/rgb", gt_depth_path=f"{root}/depth",
        gt_seg_path=f"{root}/seg", gt_line_path=f"{root}/lines",
        filenames_file_train=f"{root}/train.txt",
        filenames_file_eval=f"{root}/val.txt")
    model = model_for(cfg)
    ds = GlassRGBDDataset(cfg, "val")

    def run_eval(m, rank, world):
        loader = Loader(ds, 2, shuffle=False, drop_last=False,
                        pad_to_batch=True, num_workers=1, rank=rank,
                        world=world)
        stats = evaluate(cfg, model, make_eval_step(cfg), loader, "cpu",
                         collect_lines=True, mesh=m)
        dumps = stats.pop("line_dumps")
        return stats, [{k: (v.tolist() if k != "name" else v)
                        for k, v in d.items()} for d in dumps]

    res["eval"] = run_eval(mesh, r, W)
    if mesh.is_main:
        res["eval_one"] = run_eval(solo(), 0, 1)
    return res


def train_cli(out_dir, root):
    """`main.main` for an epoch, then a second one after `--resume`."""
    from gwdepth_tpu_torch import main as pmain

    argv = cli_args(root, os.path.join(out_dir, "exp"))
    pmain.main(argv + ["--epochs", "1"])
    return pmain.main(argv + ["--epochs", "2", "--resume", "auto"])


def one(mesh, out_dir, root):
    """The training CLI in one process, without torchrun."""
    assert not mesh.distributed
    return {"step": train_cli(out_dir, root).step}


def cli(mesh, out_dir, root):
    from gwdepth_tpu_torch import predict

    state = train_cli(out_dir, root)
    res = {"rank": mesh.rank, "step": state.step,
           "rank_gap": max_rank_gap(mesh, list(state.model.parameters()))}
    predict.main(predict_args(root, os.path.join(out_dir, "pred"))
                 + ["--mesh", "2", "--resume", os.path.join(
                     out_dir, "exp", "checkpoints", "checkpoint.pth")])
    return res


def cli_args(root, out):
    """The tiny training CLI on the synthetic set at `root`."""
    return ["--tiny", "--device", "cpu", "--num_workers", "1",
            "--with_line", "--with_dense", "--with_center",
            "--batch_size", "4", "--eval_batch_size", "2",
            "--data_path", f"{root}/rgb", "--gt_depth_path", f"{root}/depth",
            "--gt_seg_path", f"{root}/seg", "--gt_line_path",
            f"{root}/lines", "--filenames_file_train", f"{root}/train.txt",
            "--filenames_file_eval", f"{root}/val.txt", "--output_dir", out]


def predict_args(root, out):
    """predict on the synthetic set's 3 validation images, 2 a batch."""
    return ["--images", f"{root}/rgb_val", "--output_dir", out, "--tiny",
            "--device", "cpu", "--batch", "2"]


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, out_dir, root = sys.argv[1:4]
    from gwdepth_tpu_torch.parallel import make_mesh, setup

    setup("cpu")
    mesh = make_mesh((-1,))
    res = {"lib": lib, "cli": cli, "one": one}[mode](mesh, out_dir, root)
    with open(os.path.join(out_dir, f"{mode}{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    from gwdepth_tpu_torch.parallel.mesh import teardown
    teardown()
