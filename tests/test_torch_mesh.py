"""The port's mesh against ``vilbert_tpu.parallel.mesh``, on the CPU.

- ``param_sharding_rules`` picks the leaves that JAX's picks, along the
  same logical axis, on the full-width ``bert_base_6layer_6conect`` tree
  (the JAX side from ``jax.eval_shape``, the port's model on the meta
  device: no weights are made), at model sizes 1, 2 and 4 and thresholds
  2^20 and 1024;
- the rank -> (data, model) layout is JAX's ``make_mesh((2, 2))`` device
  grid;
- ``make_mesh()`` without a device raises when there is no CUDA device;
- an optimizer that holds a slice of each sharded parameter updates it as
  the replicated optimizer does, bit for bit, with moments of the slice's
  size, and has no ``state_dict`` to checkpoint.
"""

import numpy as np
import pytest
import torch

import jax

from vilbert_tpu.core.importer import _flatten

CONFIG = "configs/bert_base_6layer_6conect.json"


@pytest.fixture(scope="module")
def full_width():
    """(port model on the meta device, JAX eval_shape params) of the
    full-width pretraining model."""
    from vilbert_tpu.core.config import ModelConfig as JaxConfig
    from vilbert_tpu.models.vilbert import ViLBERTForPretraining as JaxModel
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining

    with torch.device("meta"):
        model = ViLBERTForPretraining(ModelConfig.from_json_file(CONFIG))
    cfg = JaxConfig.from_json_file(CONFIG)
    ids = np.zeros((1, 4), np.int32)
    feats = np.zeros((1, 3, cfg.v_feature_size), np.float32)
    locs = np.zeros((1, 3, 5), np.float32)
    shapes = jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0), ids, feats, locs)
    return model, shapes["params"]


def _jax_axes(params, model_size, min_size):
    """{flax path: the flax axis JAX shards over "model", or None}."""
    from vilbert_tpu.parallel.mesh import make_mesh, param_sharding_rules

    mesh = make_mesh((8 // model_size, model_size), ("data", "model"))
    rules = param_sharding_rules(params, mesh, min_size_to_shard=min_size)
    axes = {}
    for path, sharding in _flatten(rules).items():
        spec = tuple(sharding.spec)
        axes[path] = spec.index("model") if "model" in spec else None
    return axes


def _port_axes(model, model_size, min_size):
    """{flax path: the flax axis the port shards, or None}."""
    from vilbert_tpu_torch.core.importer import _needs_transpose, _to_flax_key
    from vilbert_tpu_torch.parallel.mesh import Mesh, param_sharding_rules

    rules = param_sharding_rules(model, Mesh(model_size=model_size), min_size_to_shard=min_size)
    shapes = dict(model.named_parameters())
    axes = {}
    for name, dim in rules.items():
        if dim is not None and _needs_transpose(name):
            dim = shapes[name].dim() - 1 - dim
        axes[_to_flax_key(name)] = dim
    return axes


@pytest.mark.parametrize("min_size", [2 ** 20, 1024])
@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_sharding_rules_match_jax(full_width, model_size, min_size):
    model, params = full_width
    want = _jax_axes(params, model_size, min_size)
    got = _port_axes(model, model_size, min_size)
    assert len(got) == len(want) == 508
    assert got == want
    if model_size == 1:
        assert not any(v is not None for v in got.values())


def test_sharding_rules_at_the_default_threshold(full_width):
    """The full-width model's sizing: 112 of the 508 leaves at model size 2, holding 188.1M of the 239.0M parameters; 111 at model size 4,
    where the 30,522-row word table does not divide; a 1024 x 1024 kernel
    shards its flax axis 0, which is the port weight's dim 1."""
    from vilbert_tpu_torch.parallel.mesh import Mesh, param_sharding_rules

    model, _ = full_width
    params = dict(model.named_parameters())
    for size, leaves, elements in ((2, 112, 188.1e6), (4, 111, 164.6e6)):
        rules = param_sharding_rules(model, Mesh(model_size=size))
        sharded = [n for n, d in rules.items() if d is not None]
        assert len(sharded) == leaves
        assert abs(sum(params[n].numel() for n in sharded) - elements) < 0.05e6
    rules = param_sharding_rules(model, Mesh(model_size=2))
    square = "bert.encoder.c_layer.0.biattention.query1.weight"
    assert tuple(params[square].shape) == (1024, 1024) and rules[square] == 1
    word = "bert.embeddings.word_embeddings.weight"
    assert rules[word] == 0
    assert param_sharding_rules(model, Mesh(model_size=4))[word] is None


@pytest.mark.parametrize("rank", range(4))
def test_rank_layout_matches_the_jax_grid(rank, monkeypatch):
    """Rank r at (r // 2, r % 2), where JAX's ``make_mesh((2, 2))`` puts
    the r-th device."""
    from vilbert_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vilbert_tpu_torch.parallel import distributed
    from vilbert_tpu_torch.parallel.mesh import make_mesh

    grid = jax_make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    (d, m), = np.argwhere(grid.devices == jax.devices()[rank])
    monkeypatch.setattr(distributed, "process_shard", lambda mesh=None: (rank, 4))
    mesh = make_mesh((2, -1), ("data", "model"), device="cpu")
    assert (mesh.data_rank, mesh.model_rank) == (d, m)
    assert mesh.shape == dict(grid.shape) == {"data": 2, "model": 2}
    assert mesh.is_primary == (rank == 0)


def test_make_mesh_without_a_device_raises_without_cuda(monkeypatch):
    from vilbert_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="axes"):
        make_mesh((1,), ("model",), device="cpu")
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh((2, 2), ("data", "model"), device="cpu")


def test_loaders_read_the_data_coordinate():
    from vilbert_tpu_torch.parallel.distributed import process_shard
    from vilbert_tpu_torch.parallel.mesh import Mesh

    assert process_shard(Mesh(data_rank=1, data_size=3, model_rank=1, model_size=2)) == (1, 3)
    assert process_shard() == (0, 1)


def _tiny_params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "bert.encoder.layer.0.intermediate.dense.weight": torch.randn(8, 6, generator=g),
        "bert.encoder.layer.0.intermediate.dense.bias": torch.randn(8, generator=g),
        "bert.embeddings.word_embeddings.weight": torch.randn(10, 4, generator=g),
        "bert.encoder.layer.0.output.LayerNorm.weight": torch.randn(6, generator=g),
    }


@pytest.mark.parametrize("name,moments", [("adamw", "float32"), ("adamw", "bfloat16"),
                                          ("radam", "float32")])
def test_sharded_update_is_the_replicated_update(name, moments):
    """Three steps with the global-norm clip on: the slices of two sharded
    optimizers, put together, are the replicated optimizer's parameters and
    moments bit for bit; each holds moments of its slice's shape."""
    from vilbert_tpu_torch.core.config import OptimizerConfig
    from vilbert_tpu_torch.train.optim import build_optimizer

    cfg = OptimizerConfig(name=name, learning_rate=1e-2, schedule="constant", weight_decay=0.01,
                          grad_clip_norm=0.5, first_moment_dtype=moments,
                          second_moment_dtype=moments)
    shards = {"bert.encoder.layer.0.intermediate.dense.weight": 1,
              "bert.embeddings.word_embeddings.weight": 0}
    full = _tiny_params()
    ref, _ = build_optimizer(cfg, full, 10)
    parts = []
    for index in range(2):
        params = {k: v.clone() for k, v in _tiny_params().items()}
        opt, _ = build_optimizer(cfg, params, 10)
        opt.shard_(shards, index, 2)
        parts.append((params, opt))
    g = torch.Generator().manual_seed(5)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in full.items()}
        ref.step(grads)
        for _, opt in parts:
            opt.step(grads)
    for n, want in full.items():
        if n not in shards:
            for params, _ in parts:
                assert torch.equal(params[n], want), n
            continue
        dim = shards[n]
        got = torch.cat([params[n].narrow(dim, i * (want.shape[dim] // 2), want.shape[dim] // 2)
                         for i, (params, _) in enumerate(parts)], dim)
        assert torch.equal(got, want), n

    def moments_of(opt):
        if name == "adamw":
            return [opt.state.mu, opt.state.nu]
        return [st.mu for st in opt.state.values()] + [st.nu for st in opt.state.values()]

    for which, want in enumerate(moments_of(ref)):
        for n, w in want.items():
            slices = [moments_of(opt)[which][n] for _, opt in parts]
            if n in shards:
                assert all(s.shape[shards[n]] * 2 == w.shape[shards[n]] for s in slices)
                assert torch.equal(torch.cat(slices, shards[n]), w), n
            else:
                assert all(torch.equal(s, w) for s in slices), n


def test_a_sharded_state_has_no_checkpoint(tmp_path):
    from vilbert_tpu_torch.core.config import OptimizerConfig
    from vilbert_tpu_torch.parallel.train_step import TrainState, train_state_dict
    from vilbert_tpu_torch.train.optim import build_optimizer

    opt, _ = build_optimizer(OptimizerConfig(schedule="constant"), _tiny_params(), 10)
    model = torch.nn.Linear(2, 2)
    assert set(train_state_dict(TrainState(0, model, opt))["optimizer"]) == {"count", "mu", "nu"}
    opt.shard_({"bert.embeddings.word_embeddings.weight": 0}, 1, 2)
    with pytest.raises(ValueError, match="model-sharded"):
        train_state_dict(TrainState(0, model, opt))
    with pytest.raises(ValueError, match="sharded already"):
        opt.shard_({"bert.embeddings.word_embeddings.weight": 0}, 1, 2)
