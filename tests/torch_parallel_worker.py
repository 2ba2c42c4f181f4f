"""One gloo rank on the CPU for `tests/test_torch_parallel.py`.

Run with torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`), or for `one` without it, as

    python tests/torch_parallel_worker.py lib|cli|one|tp|tp4 OUT_DIR DATA_ROOT

Run as a script it imports only the port: the JAX packages are blocked
before anything else is imported (the test imports its helpers). `lib` drives the library (loader shares, meters,
checkpoint, `compute_losses`, the train step with and without
`use_pallas`, `grad_accum`, `evaluate`), rank 0 also the one-process
references; `cli` drives `main.main` (an epoch, then `--resume`) and
`predict.main --mesh 2`; `one` drives `main.main` in one process, the
reference of `cli`. `tp` (2 ranks, a `(1, 2)` mesh) drives tensor
parallelism: a column- then row-split MLP, the train step with and
without `use_pallas`, `main.main --mesh 1,2` and its checkpoints, and
the DTensor guard of K1 and K2; `tp4` (4 ranks, a `(2, 2)` mesh) a toy
module's shares, sums, gradients and clip. Each rank writes
`{mode}{rank}.json`; rank 0 writes the train runs' tensors to `*.pt`.

The ranks meet without a fixed port: rank 0 opens the rendezvous store
on a port the system picks and writes it to `OUT_DIR/port`, where the
others read it (`join`); the store, the wait for the file and every
collective have their own time limits.
"""

import sys

if __name__ == "__main__":
    for _name in ("jax", "jaxlib", "flax", "optax", "orbax", "gwdepth_tpu"):
        sys.modules[_name] = None            # any import of them raises

import datetime  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

N_STEPS = 3
JOIN_S = 120              # the rendezvous: store, port file
COLLECTIVE_S = 300        # any one collective
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
    parameters, the split ones gathered whole. `sizes` has, per split
    parameter, its full, local and first-moment element counts (None for
    a frozen one, which AdamW holds no moments of)."""
    from gwdepth_tpu_torch.parallel import create_train_state, make_train_step
    from gwdepth_tpu_torch.parallel import train_state as ts
    from gwdepth_tpu_torch.parallel.partition import placed, unshard

    model = model_for(cfg)
    full = {n: p.numel() for n, p in model.named_parameters()}
    state = create_train_state(cfg, model, steps_per_epoch=2,
                               mesh=mesh or solo())
    step = make_train_step(cfg)
    clip = ts.clip_grad_norm_
    first = {}

    def spy(params, *args, **kw):
        params = list(params)
        if not first:
            first.update({id(p): p.grad.clone() for p in params})
        return clip(params, *args, **kw)

    logs, mu = [], None
    ts.clip_grad_norm_ = spy
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
        ts.clip_grad_norm_ = clip
    pl = placed(model)
    moments = {id(p): st["exp_avg"].numel()
               for p, st in state.optimizer.state.items()}
    sizes = {} if pl is None else {
        n: [full[n], p.numel(), moments.get(id(p))]     # None: frozen
        for n, p in zip(pl.names, pl.params)}
    return {"keys": list(step.log_keys), "logs": np.stack(logs),
            "mu": unshard(model, mu),
            "grads": unshard(model, {n: first[id(p)]
                                     for n, p in model.named_parameters()
                                     if id(p) in first}),
            "params": unshard(model, {n: p.detach().clone()
                                      for n, p in model.named_parameters()}),
            "sizes": sizes}


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


def train_cli(out_dir, root, extra=()):
    """`main.main` for an epoch, then a second one after `--resume`."""
    from gwdepth_tpu_torch import main as pmain

    argv = cli_args(root, os.path.join(out_dir, "exp")) + list(extra)
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


class MLP(torch.nn.Module):
    """Two linears named as the JAX rule's column and row pair, and a
    norm: `linear1` splits by output features, `linear2` by input
    features, `norm` and the biases stay whole."""

    def __init__(self, d=8, h=16, o=4):
        super().__init__()
        self.linear1 = torch.nn.Linear(d, h)
        self.linear2 = torch.nn.Linear(h, o)
        self.norm = torch.nn.LayerNorm(o)

    def forward(self, x):
        return self.norm(self.linear2(torch.relu(self.linear1(x))))


def mlp_for(seed=0):
    torch.manual_seed(seed)
    return MLP()


def mlp_input():
    return torch.from_numpy(np.random.default_rng(5).normal(
        size=(6, 8)).astype(np.float32))


def guard_errors():
    """K1's and K2's entries given a DTensor weight (replicated over a
    device mesh of the world): the errors they raise, by kernel."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from gwdepth_tpu_torch.ops.fused_conv import conv3x3_ln_act
    from gwdepth_tpu_torch.ops.ref_attn_diffusion import ref_attn_diffusion

    dm = init_device_mesh("cpu", (int(os.environ["WORLD_SIZE"]),))

    def dt(t):
        return distribute_tensor(t, dm, [Replicate()])

    calls = {"k2": lambda: conv3x3_ln_act(torch.zeros(1, 4, 4, 8),
                                          dt(torch.zeros(3, 3, 8, 16))),
             "k1": lambda: ref_attn_diffusion(torch.zeros(1, 4, 4, 16),
                                              dt(torch.zeros(3, 3, 16, 16)),
                                              torch.zeros(16))}
    out = {}
    for k, call in calls.items():
        try:
            call()
            out[k] = None
        except TypeError as e:
            out[k] = str(e)
    return out


def tp(mesh, out_dir, root):
    """Tensor parallelism on a (1, 2) mesh: the MLP, the train step, the
    CLI and its checkpoints, the DTensor guard."""
    from gwdepth_tpu_torch import main as pmain
    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.data.batch import dummy_batch
    from gwdepth_tpu_torch.parallel import create_train_state
    from gwdepth_tpu_torch.parallel.partition import (gathered, place_params,
                                                      placed, unshard)
    from gwdepth_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                    restore_file)

    assert mesh.shape == (1, 2) and mesh.model_size == 2
    res = {"rank": mesh.rank, "model_rank": mesh.model_rank,
           "data_rank": mesh.data_rank, "share": [mesh.share(2).start,
                                                  mesh.share(2).stop]}
    # the column- then row-split MLP against the replicated one (the test)
    mlp = place_params(mlp_for(), mesh)
    with gathered(mlp):
        y = mlp(mlp_input())
    res["mlp"] = {"y": y.tolist(), "shards": {
        n: list(p.shape) for n, p in mlp.named_parameters()}}

    # the train step, without and with use_pallas, the whole batch a rank
    for up in (False, True):
        cfg = tiny_test_config(matcher="scipy", use_pallas=up)
        batches = [dummy_batch(cfg, 2, num_lines=3 + i, seed=i)
                   for i in range(N_STEPS)]
        run = train_run(cfg, batches, mesh, mesh.share(2))
        res[f"train_{up}"] = {"logs": run["logs"].tolist(),
                              "sizes": run["sizes"]}
        if mesh.is_main:
            torch.save(run, os.path.join(out_dir, f"tp_train_{up}.pt"))

    # main.main --mesh 1,2: 2 epochs (the second after --resume)
    state = train_cli(out_dir, root, ["--mesh", "1,2"])
    final = unshard(state.model, {n: p.detach().clone() for n, p in
                                  state.model.named_parameters()})
    res["cli_step"] = state.step
    ckpt = os.path.join(out_dir, "exp", "checkpoints", "checkpoint.pth")
    if mesh.is_main:
        torch.save(final, os.path.join(out_dir, "tp_cli_params.pt"))

    # the CLI's checkpoint restored into a fresh split state (--resume)
    cfg = pmain.config_from_args(pmain.build_argparser().parse_args(
        cli_args(root, os.path.join(out_dir, "exp"))))
    fresh = create_train_state(cfg, model_for(cfg), mesh=mesh)
    res["resume_epoch"] = restore_file(fresh, ckpt)
    got = unshard(fresh.model, {n: p.detach() for n, p in
                                fresh.model.named_parameters()})
    res["resume_equal"] = all(torch.equal(got[n], final[n]) for n in final)
    res["resume_local_shapes"] = all(
        list(p.shape) == list(q.shape) for p, q in zip(
            fresh.model.parameters(), state.model.parameters()))

    # a one-process checkpoint (one step, so AdamW has moments) restored
    # into a split state: the whole weights and moments come back
    solo_dir = os.path.join(out_dir, "solo_ckpt")
    one_state = create_train_state(cfg, model_for(cfg), mesh=solo())
    with torch.no_grad():
        for p in one_state.model.parameters():
            p.add_(0.25)
    for p in one_state.trainable:
        p.grad = torch.full_like(p, 0.01)
    one_state.apply_gradients()
    if mesh.is_main:
        CheckpointManager(solo_dir).save(0, one_state, cfg)
    mesh.barrier()
    split = create_train_state(cfg, model_for(cfg), mesh=mesh)
    res["solo_epoch"] = CheckpointManager(solo_dir).restore(split)
    got = unshard(split.model, {n: p.detach() for n, p in
                                split.model.named_parameters()})
    res["solo_params_equal"] = all(
        torch.equal(got[n], p.detach())
        for n, p in one_state.model.named_parameters())
    pl = placed(split.model)
    names = {id(p): n for n, p in split.model.named_parameters()}
    one_p = dict(one_state.model.named_parameters())
    mu = unshard(split.model, {names[id(p)]: split.optimizer.state[p][
        "exp_avg"] for p in split.trainable})
    res["solo_moments_equal"] = all(
        torch.equal(mu[n], one_state.optimizer.state[one_p[n]]["exp_avg"])
        for n in mu)
    res["split_names"] = list(pl.names)

    res["guard"] = guard_errors()
    return res


def tp4(mesh, out_dir, root):
    """A (2, 2) mesh of 4 ranks on the MLP: shares, sums over the data
    group, the meters, the gather, and two train steps (gradients before
    the clip, the clip's norm, the parameters) against one process on
    the global batch of 4, which rank 0 also runs."""
    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.data.dataset import Loader
    from gwdepth_tpu_torch.parallel import create_train_state
    from gwdepth_tpu_torch.parallel import train_state as ts
    from gwdepth_tpu_torch.parallel.partition import gathered, unshard
    from gwdepth_tpu_torch.utils.logging import SmoothedValue

    assert mesh.shape == (2, 2)
    sl = mesh.share(4)
    res = {"rank": mesh.rank, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank, "share": [sl.start, sl.stop]}
    # one image-count per data coordinate: 1 + data rank (each model rank
    # of a data coordinate adds the same)
    res["sum_host"] = mesh.sum_host([1.0 + mesh.data_rank]).tolist()
    m = SmoothedValue()
    m.update(2.0 + mesh.data_rank)
    m.sync(mesh)
    res["meter"] = [m.count, m.total]
    got = mesh.gather(("obj", mesh.data_rank, mesh.model_rank))
    res["gather"] = got
    res["loader"] = loader_batches(Loader(FakeDS(4), 4, shuffle=False,
                                          num_workers=1, rank=mesh.data_rank,
                                          world=mesh.data_size))

    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 4, 8)).astype(np.float32))
    cfg = tiny_test_config(clip_max_norm=0.05, lr=1e-2, weight_decay=1e-3)

    def run(mesh_, part):
        model = mlp_for(3)
        state = create_train_state(cfg, model, mesh=mesh_)
        clip = ts.clip_grad_norm_
        rec = {"grads": [], "norms": [], "losses": []}

        def spy(params, *args, **kw):
            params = list(params)
            rec["grads"].append({id(p): p.grad.clone() for p in params})
            norm = clip(params, *args, **kw)
            rec["norms"].append(float(norm))
            return norm

        ts.clip_grad_norm_ = spy
        try:
            for xb in x:
                xb = xb[part]
                with gathered(model):
                    y = model(xb)
                    # the mean over the global batch: images counted by
                    # the data group's sums
                    loss = (mesh_.all_sum((y ** 2).sum())
                            / mesh_.all_sum(torch.tensor(float(len(xb)))))
                    loss.backward()
                rec["losses"].append(float(loss))
                state.apply_gradients()
        finally:
            ts.clip_grad_norm_ = clip
        names = {id(p): n for n, p in model.named_parameters()}
        return {"losses": rec["losses"], "norms": rec["norms"],
                "grads": [{k: v.tolist() for k, v in unshard(model, {
                    names[i]: g for i, g in step.items()}).items()}
                    for step in rec["grads"]],
                "params": {k: v.tolist() for k, v in unshard(model, {
                    n: p.detach() for n, p in model.named_parameters()
                }).items()},
                "local": {n: list(p.shape)
                          for n, p in model.named_parameters()}}

    res["tp"] = run(mesh, sl)
    if mesh.is_main:
        res["one"] = run(solo(), slice(None))
    return res


def join():
    """Join this rank's gloo group through a store on a port that the
    system picks (see the module docstring)."""
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    path = os.path.join(os.getcwd(), "port")
    limit = datetime.timedelta(seconds=JOIN_S)
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world, True, timeout=limit,
                              wait_for_workers=False)
        with open(path + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(path + ".tmp", path)
    else:
        t0 = time.monotonic()
        while not os.path.exists(path):
            if time.monotonic() - t0 > JOIN_S:
                raise TimeoutError(f"no {path} after {JOIN_S} s")
            time.sleep(0.05)
        with open(path) as f:
            port = int(f.read())
        store = dist.TCPStore("127.0.0.1", port, world, False, timeout=limit)
    os.environ["MASTER_PORT"] = str(store.port)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_S))


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
    from gwdepth_tpu_torch.parallel.mesh import launched, teardown

    if launched():
        join()
    setup("cpu")
    mesh = make_mesh(*{"tp": ((1, 2), ("data", "model")),
                       "tp4": ((2, 2), ("data", "model"))}.get(
        mode, ((-1,), ("data",))))
    res = {"lib": lib, "cli": cli, "one": one, "tp": tp, "tp4": tp4}[mode](
        mesh, out_dir, root)
    with open(os.path.join(out_dir, f"{mode}{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    teardown()
