"""The port's tensor-parallel rule (`gwdepth_tpu_torch/parallel/partition.py`)
against the JAX package's (`gwdepth_tpu/parallel/partition.py`), and the
(data, model) mesh arithmetic of `parallel/mesh.py` and `main._refuse`.

JAX's rule is asked on JAX's own terms: every parameter of the port's
model goes, as an `arange` probe, through the JAX package's importer
(`glassrgbd_torch_to_flax`, the original names -> flax leaves), and
`param_shardings` shards the leaves over a `(8 / M, M)` mesh of
conftest's 8 virtual CPU devices. The port must split the same tensor,
and its chunk k along its split dim must hold exactly the elements of
JAX's chunk k; where JAX replicates, the port replicates. The runs over
gloo ranks are in `tests/test_torch_parallel.py`.
"""

import numpy as np
import pytest
import torch

from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.parallel import make_mesh as jax_make_mesh
from gwdepth_tpu.parallel import param_shardings

from gwdepth_tpu_torch import main as pmain
from gwdepth_tpu_torch.config import GWDepthConfig, tiny_test_config
from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD
from gwdepth_tpu_torch.parallel.mesh import make_mesh, resolve_shape
from gwdepth_tpu_torch.parallel.partition import param_placements, spec_for

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

CONFIGS = {"tiny": tiny_test_config, "shipped": GWDepthConfig}


def _leaf_path(tree, prefix=()):
    """The one (path, leaf) of a converter overlay holding one tensor."""
    found = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            found.append((path, node))

    walk(tree, prefix)
    assert len(found) == 1, [p for p, _ in found]
    return found[0]


def _jax_chunks(name, shape, jmesh, M):
    """JAX's split of the tensor `name`: None (replicated), or per model
    coordinate the sorted flat indices of the PyTorch tensor it holds."""
    size = int(np.prod(shape))
    probe = np.arange(size, dtype=np.float64).reshape(shape)
    tree = glassrgbd_torch_to_flax({name: probe})
    path, leaf = _leaf_path(tree)
    spec = _leaf_path(param_shardings(tree, jmesh))[1].spec
    axes = [i for i, a in enumerate(spec) if a == "model"]
    if not axes:
        return None
    return [np.sort(c.ravel()).astype(np.int64)
            for c in np.split(np.asarray(leaf), M, axis=axes[0])]


@pytest.fixture(scope="module")
def models():
    # built without a forward; the rule reads names and shapes only
    return {k: GlassRGBD(make()) for k, make in CONFIGS.items()}


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("config", ["tiny", "shipped"])
def test_spec_for_splits_what_jax_splits(models, config, M):
    model = models[config]
    jmesh = jax_make_mesh((8 // M, M), ("data", "model"))
    mesh = type("Mesh", (), {"model_size": M})()
    placements = param_placements(model, mesh)
    split = total = 0
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        want = _jax_chunks(name, shape, jmesh, M)
        dim = placements[name]
        if want is None:
            assert dim is None, (name, shape, dim)
            continue
        assert dim is not None, (name, shape)
        flat = np.arange(int(np.prod(shape))).reshape(shape)
        got = [np.sort(c.ravel()) for c in np.split(flat, M, axis=dim)]
        for k in range(M):
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)
        split += p.numel()
    for p in model.parameters():
        total += p.numel()
    # the split share of the parameters is most of the model
    assert split > total / 2, (split, total)


def test_spec_heuristics():
    """The port's counterpart of `tests/test_partition.py::
    test_spec_heuristics`, on PyTorch names and layouts."""
    # column: a (dout, din) weight splits dim 0
    assert spec_for("transformer.encoder.layers.0.linear1.weight",
                    (64, 32), 2) == 0
    # row: dim 1
    assert spec_for("transformer.encoder.layers.0.linear2.weight",
                    (32, 64), 2) == 1
    assert spec_for("dense_encoder.dense_transformer.blocks.0.attn.qkv."
                    "weight", (96, 32), 2) == 0
    # the depth heads' Sequential indices are flax's fc1 / fc2
    assert spec_for("dense_encoder.depth_pred16.0.weight", (6, 8), 2) == 0
    assert spec_for("dense_encoder.depth_pred16.1.weight", (1, 6), 2) == 1
    # indivisible output -> replicated; trivial model axis -> replicated
    assert spec_for("x.linear1.weight", (63, 32), 2) is None
    assert spec_for("x.linear1.weight", (64, 32), 1) is None
    # biases, norms, embeddings, K1's weight: replicated
    assert spec_for("x.linear1.bias", (64,), 2) is None
    assert spec_for("query_embed.weight", (100, 256), 2) is None
    assert spec_for("a.attn.ref_attn_diffusion.weight", (16, 16, 3, 3),
                    2) is None
    # other linears need dout >= 4 M; convs O >= 8 M
    assert spec_for("x.head.weight", (6, 8), 2) is None
    assert spec_for("x.head.weight", (8, 8), 2) == 0
    assert spec_for("x.conv.weight", (8, 4, 3, 3), 2) is None
    assert spec_for("x.conv.weight", (16, 4, 3, 3), 2) == 0
    # the fused in_proj (3C, C) splits per head group
    assert spec_for("a.self_attn.in_proj_weight", (48, 16), 2) == 0
    assert spec_for("a.self_attn.in_proj_weight", (9, 3), 2) is None


@pytest.mark.parametrize("shape,world,want", [
    ((-1,), 4, (4,)), ((2, 2), 4, (2, 2)), ((-1, 2), 4, (2, 2)),
    ((2, -1), 8, (2, 4)), ((1, 1), 1, (1, 1)),
    ((3, 2), 4, None), ((-1, 3), 4, None), ((-1, -1), 4, None),
    ((0, 2), 4, None),
])
def test_resolve_shape(shape, world, want):
    if want is None:
        with pytest.raises(ValueError):
            resolve_shape(shape, world)
    else:
        assert resolve_shape(shape, world) == want


def test_one_process_two_axis_mesh():
    """`--mesh 1,1` without torchrun: one rank, no groups, the data and
    model coordinates 0."""
    mesh = make_mesh((1, 1), ("data", "model"))
    assert (mesh.shape, mesh.data_size, mesh.model_size) == ((1, 1), 1, 1)
    assert (mesh.data_rank, mesh.model_rank) == (0, 0)
    assert not mesh.distributed and mesh.share(3) == slice(0, 3)
    with pytest.raises(ValueError, match="axes"):
        make_mesh((1, 1), ("model", "data"))
    with pytest.raises(ValueError, match="world has 1"):
        make_mesh((1, 2), ("data", "model"))


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2,2"], None),
    (["--mesh=-1,2"], None),
    (["--mesh", "1,4", "--batch_size", "2"], None),
    (["--mesh", "3,2"], "tensor parallelism spans the torchrun world, 4"),
    (["--mesh", "2,2", "--batch_size", "3"],
     "--batch_size 3 must be a multiple of the 2 ranks of the data axis"),
    (["--mesh", "4,1", "--batch_size", "4", "--grad_accum", "2"],
     "--grad_accum 2 must divide each rank.s batch, 1"),
])
def test_refuse_checks_a_two_axis_mesh(monkeypatch, argv, match):
    """`main._refuse` on a world of 4: a (data, model) mesh runs when it
    spans the world and the batch splits over its data axis."""
    for k, v in dict(RANK="0", WORLD_SIZE="4", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    args = pmain.build_argparser().parse_args(
        ["--tiny", "--eval_batch_size", "4"] + argv)
    cfg = pmain.config_from_args(args)
    if match is None:
        pmain._refuse(args, cfg)
        assert cfg.mesh_axes == ("data", "model")
    else:
        with pytest.raises(SystemExit, match=match):
            pmain._refuse(args, cfg)


def test_place_params_without_a_model_axis_splits_nothing():
    """A data mesh (or M = 1) leaves every parameter whole and the model
    unplaced, so the data-parallel path runs as before."""
    from gwdepth_tpu_torch.parallel.partition import place_params, placed

    model = torch.nn.Linear(8, 16)
    before = [p.clone() for p in model.parameters()]
    place_params(model, make_mesh((1, 1), ("data", "model")))
    assert placed(model) is None
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                  model.parameters()))
