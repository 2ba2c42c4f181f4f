"""The port's `jax.jit` counterpart (`graphs.py`) and the loops that read
its static outputs, on the CPU.

- `compiled`'s cache key: one entry per shape, dtype, grad mode and
  module mode, as jit keys its cache; equal keys otherwise.
- `disable()` nests; CPU tensors reach the plain function as they are.
- Launch counts deferred while a graph is captured (`count`), tables held
  by the capture (every table cached at its end).
- The train state's two halves (`update`, `advance`) are
  `apply_gradients`; `snapshot` puts back what warm-up steps wrote; the
  learning-rate tensors survive the schedule and a state dict; a
  checkpoint holds float learning rates; a state dict written with
  `capturable` AdamW restores into a CPU state.
- `engine.train_one_epoch` and `engine.evaluate` driven by steps that
  return ONE buffer overwritten in place at every call (a replayed
  graph's static outputs) give the meters, sums and line dumps of steps
  that return fresh tensors.

Cheap by design: no JAX model, no JAX step, the tiny config's data only.
The card's side (capture, replay, generators, tables under eviction, the
gloo guard) is in `tests/test_torch_cuda.py` and `chip_smoke.py` phase
24.
"""

import copy
import math
import threading

import numpy as np
import pytest
import torch
import torch.nn as nn

from gwdepth_tpu_torch import engine, graphs
from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.data.batch import dummy_batch
from gwdepth_tpu_torch.ops import tables
from gwdepth_tpu_torch.parallel import create_train_state
from gwdepth_tpu_torch.parallel.train_state import _keep_lr_tensors
from gwdepth_tpu_torch.utils.logging import MetricLogger


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module, as the other port tests."""
    found = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(found)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 3)
        self.register_buffer("scale", torch.ones(3))

    def forward(self, x):
        return self.lin(x) * self.scale


def _key(fn, *args, grad=True):
    with torch.set_grad_enabled(grad):
        return fn.key(*args)


def test_cache_key_is_distinct_for_shape_dtype_grad_and_train_mode():
    fn = graphs.compiled(lambda m, x: m(x))
    net = _Net()
    x = torch.zeros(2, 4)
    base = _key(fn, net, x)
    assert _key(fn, net, torch.ones(2, 4)) == base       # values: copied in
    others = [_key(fn, net, torch.zeros(3, 4)),
              _key(fn, net, x.double()),
              _key(fn, net, x, grad=False)]
    net.eval()
    others.append(_key(fn, net, x))
    net.train()
    others.append(_key(fn, _Net(), x))                    # another module
    assert _key(fn, net, x) == base
    assert len({base, *others}) == len(others) + 1


@pytest.mark.parametrize("args", [
    (2, "a"), ({"a": torch.zeros(1)}, [torch.zeros(2), None])])
def test_cache_key_reads_python_values_and_containers(args):
    fn = graphs.compiled(lambda *a: a)
    assert fn.key(*args) == fn.key(*args)
    changed = (3, "a") if args[0] == 2 else (
        {"a": torch.zeros(1)}, [torch.zeros(2), torch.zeros(1)])
    assert fn.key(*changed) != fn.key(*args)


def test_disable_nests():
    assert graphs.enabled()
    with graphs.disable():
        assert not graphs.enabled()
        with graphs.disable():
            assert not graphs.enabled()
        assert not graphs.enabled()
    assert graphs.enabled()


def test_cpu_tensors_pass_through_to_the_plain_function():
    net = _Net()
    seen = []

    def fn(m, x, scale=None):
        seen.append(x)
        return {"y": m(x), "pair": (x, 1)}

    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    c = graphs.compiled(fn)
    graphs.stats.clear()
    got = c(net, x)
    assert seen == [x] and seen[0] is x
    assert torch.equal(got["y"], net(x)) and got["pair"][0] is x
    assert graphs.stats == {("fn", "eager_runs"): 1}
    with pytest.raises(TypeError):
        c(net, None)


def test_count_defers_inside_a_capture_and_hold_keeps_tensors():
    class K:
        launches = 0
        by_shape = {"a": 0}

    tables.clear()
    graphs.count(K, "launches")
    graphs.count(K, "by_shape", "a")
    assert (K.launches, K.by_shape["a"]) == (1, 1)
    t = tables.device_table(("graphs-count-test",),
                            lambda: np.zeros(1, np.float32), "cpu")
    with graphs._capturing(graphs._Capture()) as cap:
        graphs.count(K, "launches")
        # the backward's launches come from autograd's thread
        worker = threading.Thread(target=graphs.count, args=(K, "launches"))
        worker.start()
        worker.join()
    assert K.launches == 1 and cap.counts == [(K, "launches", None)] * 2
    # the capture keeps every cached table, built before it
    assert len(cap.held) == 1 and cap.held[0] is t
    tables.clear()
    for obj, attr, k in cap.counts:                       # one replay
        graphs._bump(obj, attr, k)
    assert K.launches == 3


def test_a_table_asked_for_during_a_capture_is_held():
    tables.clear()
    build = lambda: np.arange(3, dtype=np.float32)       # noqa: E731
    first = tables.device_table(("graphs-test", 3), build, "cpu")
    with graphs._capturing(graphs._Capture()) as cap:
        again = tables.device_table(("graphs-test", 3), build, "cpu")
    assert again is first and len(cap.held) == 1 and cap.held[0] is first
    # the cache's bound drops its own reference only
    tables.clear()
    assert cap.held[0] is first and torch.equal(first, torch.arange(3.0))


def _state(cfg, seed=0):
    torch.manual_seed(seed)
    return create_train_state(cfg, _Net(), steps_per_epoch=1)


def _one_step(state, seed):
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(seed))
    state.model(x).square().sum().backward()


def _flat(state):
    return ([p.detach().clone() for p in state.model.parameters()]
            + [t.clone() for st in state.optimizer.state.values()
               for t in st.values()])


def test_update_then_advance_is_apply_gradients():
    cfg = tiny_test_config(lr_drop=1)
    a, b = _state(cfg), _state(cfg)
    for i in range(3):
        _one_step(a, i)
        a.apply_gradients()
        _one_step(b, i)
        b.update()
        b.advance()
    assert a.step == b.step == 3
    assert [g["lr"] for g in a.optimizer.param_groups] == \
        [g["lr"] for g in b.optimizer.param_groups]
    assert all(torch.equal(u, v) for u, v in zip(_flat(a), _flat(b)))
    assert all(p.grad is None for p in b.model.parameters())


@pytest.mark.parametrize("steps_before", [0, 2])
def test_snapshot_puts_back_what_warm_up_steps_wrote(steps_before):
    """Warm-up steps between `snapshot()` and its restore leave no trace:
    the next step equals the step of a state that never warmed up, from a
    fresh optimizer (its state made by the warm-ups goes back to zeros)
    and from one that has stepped."""
    cfg = tiny_test_config()
    warm, ref = _state(cfg), _state(cfg)
    for s in (warm, ref):
        for i in range(steps_before):
            _one_step(s, i)
            s.update()
    restore = warm.snapshot()
    for i in range(2):
        _one_step(warm, 10 + i)
        warm.update()
    restore()
    for s in (warm, ref):
        _one_step(s, 99)
        s.update()
    assert all(torch.equal(u, v) for u, v in zip(_flat(warm), _flat(ref)))


def test_learning_rate_tensors_survive_the_schedule_and_a_state_dict():
    """On a card each group's learning rate is a device tensor a graph
    reads in place; the schedule and `load_optimizer_state` write into it
    (here the same rule on a CPU tensor)."""
    cfg = tiny_test_config(lr_drop=1)
    state = _state(cfg)
    lrs = [torch.tensor(float(g["lr"])) for g in state.optimizer.param_groups]
    for g, t in zip(state.optimizer.param_groups, lrs):
        g["lr"] = t
    state.advance()                          # epoch 1: x0.1
    assert all(g["lr"] is t for g, t in zip(state.optimizer.param_groups,
                                            lrs))
    assert math.isclose(float(lrs[0]), cfg.lr * 0.1, rel_tol=1e-6)
    sd = state.optimizer.state_dict()
    sd["param_groups"] = [dict(g, lr=0.5) for g in sd["param_groups"]]
    state.load_optimizer_state(sd)
    assert all(g["lr"] is t and float(t) == 0.5
               for g, t in zip(state.optimizer.param_groups, lrs))
    # a schedule that assigns floats: the tensor takes the value back
    state.optimizer.param_groups[0]["lr"] = 0.25
    _keep_lr_tensors(state.optimizer, lrs)
    assert state.optimizer.param_groups[0]["lr"] is lrs[0]
    assert float(lrs[0]) == 0.25


def test_a_capturable_state_dict_restores_into_a_cpu_state():
    """A card writes its optimizer state with `capturable=True` and float32
    step counts; restored on the CPU, the groups keep the CPU optimizer's
    flag and the next step equals the one from a CPU-written state dict."""
    cfg = tiny_test_config()
    src = _state(cfg)
    _one_step(src, 0)
    src.apply_gradients()
    sd = src.optimizer.state_dict()
    card = {"state": {i: dict(st, step=st["step"].to(torch.float32))
                      for i, st in sd["state"].items()},
            "param_groups": [dict(g, capturable=True)
                             for g in sd["param_groups"]]}
    runs = []
    for written in (sd, card):
        state = _state(cfg, seed=1)
        state.model.load_state_dict(src.model.state_dict())
        # loading on the same device keeps the dict's tensors: a copy each
        state.load_optimizer_state(copy.deepcopy(written))
        assert not any(g["capturable"]
                       for g in state.optimizer.param_groups)
        _one_step(state, 1)
        state.update()
        runs.append(_flat(state))
    assert all(torch.equal(u, v) for u, v in zip(*runs))


def test_checkpoint_holds_float_learning_rates(tmp_path):
    from gwdepth_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = tiny_test_config()
    state = _state(cfg)
    for g in state.optimizer.param_groups:
        g["lr"] = torch.tensor(float(g["lr"]))
    path = CheckpointManager(str(tmp_path)).save(0, state)
    groups = torch.load(path, weights_only=False)["optimizer"]["param_groups"]
    assert all(type(g["lr"]) is float for g in groups)
    # the float32 tensor's value
    assert [g["lr"] for g in groups] == [
        float(torch.tensor(v)) for v in (cfg.lr, cfg.lr_backbone)]


class _Loader:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def epoch(self, epoch=0, pin_memory=False):
        return iter(self.items)


class _TrainStep:
    """Log vectors from the batch, in one buffer overwritten in place
    (`reuse`) or fresh at every call."""
    log_keys = ["loss", "loss_ce"]

    def __init__(self, reuse: bool):
        self.buf = torch.zeros(2) if reuse else None

    def __call__(self, state, batch, generator):
        v = torch.stack([batch.images.mean(), batch.depth.mean()])
        if self.buf is None:
            return state, v
        self.buf.copy_(v)
        return state, self.buf


@pytest.mark.parametrize("print_freq", [1, 3])
def test_train_one_epoch_keeps_log_vectors_of_a_reused_buffer(print_freq):
    cfg = tiny_test_config()
    loader = _Loader([(dummy_batch(cfg, 1, seed=i), [f"s{i}"])
                      for i in range(5)])
    meters = []
    for reuse in (False, True):
        logger = MetricLogger(print_freq=print_freq)
        _, avg = engine.train_one_epoch(None, _TrainStep(reuse), loader, 0,
                                        None, "cpu", logger=logger)
        meters.append(({k: (list(m.deque), m.total, m.count)
                        for k, m in logger.meters.items()}, avg))
    assert meters[0] == meters[1]
    assert len(set(meters[0][0]["loss"][0])) == 5


class _EvalStep:
    """The eval step's outputs from the batch, in buffers overwritten in
    place (`reuse`) or fresh at every call."""

    def __init__(self, cfg, reuse: bool):
        self.cfg, self.reuse, self.bufs = cfg, reuse, None

    def __call__(self, model, batch):
        B = batch.batch_size
        Q = self.cfg.num_queries
        m = batch.images.mean(dim=(1, 2, 3))
        res = {"depth_sums": torch.cat([batch.depth.mean().repeat(9),
                                        torch.ones(1)]),
               "confusion": torch.stack([m.sum(), m.sum() ** 2, m.abs().sum(),
                                         torch.ones(())]).reshape(2, 2),
               "eval_losses": torch.stack([m.sum(), 2 * m.sum(),
                                           3 * m.sum()]),
               "eval_loss_count": torch.tensor(float(B)),
               "pred_logits": m[:, None, None].expand(B, Q, 2) + 0.0,
               "pred_lines": m[:, None, None].expand(
                   B, Q, self.cfg.line_dim) * 0.5,
               "extent": torch.full((B, 2), 7, dtype=torch.int64)}
        if not self.reuse:
            return res
        if self.bufs is None:
            self.bufs = {k: torch.empty_like(v) for k, v in res.items()}
        for k, v in res.items():
            self.bufs[k].copy_(v)
        return dict(self.bufs)


def test_evaluate_keeps_sums_and_line_dumps_of_reused_buffers():
    cfg = tiny_test_config()
    loader = _Loader([(dummy_batch(cfg, 2, seed=20 + i),
                       [f"v{i}a", f"v{i}b"]) for i in range(3)])
    runs = [engine.evaluate(cfg, None, _EvalStep(cfg, reuse), loader, "cpu",
                            collect_lines=True)
            for reuse in (False, True)]
    fresh, reused = runs
    dumps = [r.pop("line_dumps") for r in runs]
    assert fresh == reused
    assert [d["name"] for d in dumps[1]] == [d["name"] for d in dumps[0]]
    for a, b in zip(*dumps):
        for k in ("pred_logits", "pred_lines", "extent"):
            assert np.array_equal(a[k], b[k])
    assert len({float(d["pred_logits"][0, 0]) for d in dumps[1]}) == 6
