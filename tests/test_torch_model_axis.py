"""The model axis and ``in_batch_pairs`` across ranks, on the CPU over gloo.

Four processes form a 2 x 2 (data, model) mesh and two more a data-only
mesh of two ranks (``WORKER``); the JAX side runs in this process on a
(2, 2) mesh of the virtual CPU devices:

- the dry run's sharded pretraining step (``parallel.dryrun.pretrain_step``,
  ``param_sharding_rules(min_size_to_shard=1024)``) from the weights of
  ``__graft_entry__._dryrun_impl``'s step at the dry run's widths
  (``DRYRUN_CONFIG``, the model it runs on every device), carried across with
  ``core.weights``: the loss within 1e-5, every updated parameter within
  1e-5 of its max, the moment slices of a data row's two ranks put
  together within 1e-6 of each max of the JAX step's moments (each with
  a floor for two packages' fp32 gradients, the tests say why), and each
  rank's optimizer holding its slices alone;
- ``run_pretraining`` and ``MultiTaskTrainer`` (dropout 0.1) over the
  2 x 2 mesh, which replicates the state over "model", bit-equal to the
  data-only run of two ranks;
- ``in_batch_pairs`` over the two data ranks: each rank's pair rows within
  1e-4 of its rows of flax ``BertModel`` on the global batch, and the
  gradients averaged over the ranks within 1e-4 of each max of the flax
  gradients, with and without ``fast_mode``;
- the port's dry run, ``python -m vilbert_tpu_torch.parallel.dryrun
  --processes 4 --device cpu``.
"""

import concurrent.futures
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from vilbert_tpu.core.importer import _flatten

REPO = Path(__file__).resolve().parents[1]

#: the pairs model: small, two connection layers, no dropout (eval mode)
PAIRS_CFG = dict(
    vocab_size=40, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=32, max_position_embeddings=32, v_feature_size=12, v_hidden_size=16,
    v_num_hidden_layers=2, v_num_attention_heads=2, v_intermediate_size=32, v_target_size=7,
    bi_hidden_size=16, bi_num_attention_heads=2, v_biattention_id=(0, 1),
    t_biattention_id=(0, 1), compute_dtype="float32", in_batch_pairs=True)
PAIRS_B, PAIRS_T, PAIRS_R = 4, 6, 5
LR = 1e-3  # the dry run's learning rate

WORKER = r'''
import os, sys
import numpy as np
import torch

role, out_dir, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
torch.set_num_threads(1)

from vilbert_tpu_torch.core.config import ModelConfig, OptimizerConfig
from vilbert_tpu_torch.models.vilbert import (
    ViLBERTForPretraining, ViLBERTForVLTasks, set_pair_mesh)
from vilbert_tpu_torch.parallel import dryrun
from vilbert_tpu_torch.parallel.distributed import (
    all_mean_, initialize_distributed, shutdown_distributed)
from vilbert_tpu_torch.parallel.mesh import make_mesh
from vilbert_tpu_torch.train.pretrain import run_pretraining

inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
kind, rank = role[:-1], int(role[-1])
initialize_distributed(f"localhost:{port}", 4 if kind == "grid" else 2, rank, device="cpu")
mesh = (make_mesh((2, 2), ("data", "model"), device="cpu") if kind == "grid"
        else make_mesh(device="cpu"))


def cc_batch(seed):
    """A pretraining batch of two rows a data row, masked at random."""
    cfg, r = dryrun.dryrun_config(), np.random.RandomState(seed)
    b = 2 * mesh.data_size
    target = r.rand(b, 5, cfg.v_target_size).astype(np.float32)
    return dryrun.data_rows({
        "input_ids": r.randint(1, cfg.vocab_size, (b, 12)).astype(np.int32),
        "image_feat": r.randn(b, 6, cfg.v_feature_size).astype(np.float32),
        "image_loc": r.rand(b, 6, 5).astype(np.float32),
        "segment_ids": r.randint(0, 2, (b, 12)).astype(np.int32),
        "input_mask": np.ones((b, 12), np.int32),
        "image_mask": np.ones((b, 6), np.int32),
        "lm_label_ids": np.where(r.rand(b, 12) < 0.3, r.randint(0, cfg.vocab_size, (b, 12)),
                                 -1).astype(np.int32),
        "image_label": np.where(r.rand(b, 5) < 0.3, 1, -1).astype(np.int32),
        "image_target": target / target.sum(-1, keepdims=True),
        "is_next": r.randint(0, 2, (b,)).astype(np.int32),
    }, mesh)


def run_trainers():
    metrics = []
    state = run_pretraining(
        dryrun.dryrun_config(), OptimizerConfig(learning_rate=1e-3, schedule="constant"),
        [cc_batch(s) for s in range(2)], num_steps=2, seed=0, device="cpu", log_every=0,
        mesh=mesh, hooks=[lambda s, st, m: metrics.append({k: v.item() for k, v in m.items()})])
    losses, ev, model = dryrun.multitask_iteration(mesh)
    return {"cc_metrics": metrics, "cc_params": state.model.state_dict(),
            "mt_losses": losses, "mt_eval": ev, "mt_params": model.state_dict()}


def run_pairs(fast):
    """The encoder on this rank's texts and images, the loss of its pair
    rows against the cotangents, the gradients averaged over the ranks."""
    whole = ViLBERTForVLTasks(ModelConfig(**inputs["pairs_cfg"], fast_mode=fast))
    whole.load_state_dict(inputs["pairs_state"])
    model = set_pair_mesh(whole.bert.eval(), mesh)
    b = len(inputs["pairs_x"][fast][1]) // 2
    local = [torch.from_numpy(a if (fast and i in (0, 3, 4)) else a[rank * b:(rank + 1) * b])
             for i, a in enumerate(inputs["pairs_x"][fast])]
    out = model(*local)[:4]
    n = out[0].shape[0]
    loss = sum((o * torch.from_numpy(c[rank * n:(rank + 1) * n])).sum()
               for o, c in zip(out, inputs["pairs_cot"][fast])) / n
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    all_mean_(list(grads.values()), group=mesh.data_group)
    return {"outputs": [o.detach() for o in out], "grads": grads}


res = {"mesh": (mesh.data_rank, mesh.model_rank, mesh.data_size, mesh.model_size)}
if kind == "grid":
    model = ViLBERTForPretraining(dryrun.dryrun_config())
    model.load_state_dict(inputs["dryrun_state"])
    metrics, model, opt = dryrun.pretrain_step(mesh, model)
    res["step"] = {"metrics": metrics, "params": model.state_dict(), "mu": dict(opt.state.mu),
                   "nu": dict(opt.state.nu), "shards": dict(opt.shards)}
res["trainers"] = run_trainers()
if kind == "dp":
    res["pairs"] = {fast: run_pairs(fast) for fast in (False, True)}
torch.save(res, os.path.join(out_dir, f"{role}.pt"))
shutdown_distributed()
print("WORKER_OK", role, flush=True)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_config(**kw):
    from vilbert_tpu.core.config import ModelConfig

    return ModelConfig(**kw)


def _dryrun_weights():
    """``_dryrun_impl``'s model at the port's dry-run widths, its config
    and batch, and its initial params."""
    from __graft_entry__ import _example_batch
    from vilbert_tpu.models.vilbert import ViLBERTForPretraining
    from vilbert_tpu_torch.parallel.dryrun import DRYRUN_CONFIG

    cfg = _jax_config(**DRYRUN_CONFIG)
    model = ViLBERTForPretraining(cfg)
    batch = _example_batch(cfg, batch=4, seq=12, regions=6)
    batch["lm_label_ids"][:, 1] = 7
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch["input_ids"],
                                 batch["image_feat"], batch["image_loc"])["params"]
    return cfg, model, batch, params


def _jax_dryrun_step(cfg, model, batch, params):
    """``_dryrun_impl``'s sharded step on a (2, 2) mesh: (loss, params,
    mu, nu), flattened by flax path."""
    from vilbert_tpu.core.config import OptimizerConfig
    from vilbert_tpu.parallel.mesh import batch_sharding, make_mesh, param_sharding_rules
    from vilbert_tpu.parallel.train_step import TrainState, make_train_step
    from vilbert_tpu.train.optim import build_optimizer
    from vilbert_tpu.train.pretrain import make_pretrain_loss_fn

    mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    rules = param_sharding_rules(params, mesh, min_size_to_shard=1024)
    params = jax.tree.map(jax.device_put, params, rules)
    tx, _ = build_optimizer(OptimizerConfig(learning_rate=1e-3, schedule="constant"), params, 10)
    state = TrainState.create(params, tx)
    step_fn = make_train_step(make_pretrain_loss_fn(model, cfg, deterministic=True), tx)
    sharding = batch_sharding(mesh, "data")
    batch = jax.tree.map(lambda x: jax.device_put(x, sharding), batch)
    state, metrics = step_fn(state, batch, jax.random.PRNGKey(1))
    flat = [{k: np.array(v) for k, v in _flatten(t).items()}
            for t in (state.params, state.opt_state.mu, state.opt_state.nu)]
    return (float(metrics["loss"]), *flat)


def _pairs_inputs():
    """The pairs model's weights, the global inputs (one text under
    fast_mode) and the cotangents of the encoder's four outputs."""
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks

    whole = ViLBERTForVLTasks(ModelConfig(**PAIRS_CFG),
                              generator=torch.Generator().manual_seed(8))
    rng = np.random.RandomState(8)
    B, T, R = PAIRS_B, PAIRS_T, PAIRS_R
    am = np.ones((B, T), np.int32)
    am[:, -2:] = 0
    im = np.ones((B, R), np.int32)
    im[1, -2:] = 0
    x = [rng.randint(0, PAIRS_CFG["vocab_size"], (B, T)).astype(np.int32),
         rng.randn(B, R, PAIRS_CFG["v_feature_size"]).astype(np.float32),
         rng.rand(B, R, 5).astype(np.float32), rng.randint(0, 2, (B, T)).astype(np.int32),
         am, im]
    xs, cots = {}, {}
    for fast in (False, True):
        xs[fast] = [a[:1] if fast and i in (0, 3, 4) else a for i, a in enumerate(x)]
        rows = B if fast else B * B
        cots[fast] = [rng.randn(rows, *shape).astype(np.float32) for shape in (
            (T, PAIRS_CFG["hidden_size"]), (R, PAIRS_CFG["v_hidden_size"]),
            (PAIRS_CFG["bi_hidden_size"],), (PAIRS_CFG["bi_hidden_size"],))]
    return whole.state_dict(), xs, cots


def _flax_pairs(state, x, cots, fast):
    """flax ``BertModel`` on the global batch: its four outputs and the
    gradients of the mean over the pair rows of their products with the
    cotangents, by flax path."""
    from vilbert_tpu.models.vilbert import BertModel
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    model = BertModel(_jax_config(**PAIRS_CFG, fast_mode=fast))
    params = flax_from_state_dict(state)["bert"]

    def loss(p):
        out = model.apply({"params": p}, *x)
        rows = out[0].shape[0]
        return sum((o * c).sum() for o, c in zip(out[:4], cots)) / rows, out[:4]

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return [np.asarray(o) for o in out], {k: np.asarray(v) for k, v in _flatten(grads).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The six ranks' results, and the JAX references computed meanwhile."""
    from vilbert_tpu_torch.core.weights import state_dict_from_flax
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining
    from vilbert_tpu_torch.parallel.dryrun import dryrun_config

    out = tmp_path_factory.mktemp("model_axis")
    cfg, model, batch, params = _dryrun_weights()
    keys = ViLBERTForPretraining(dryrun_config()).state_dict().keys()
    pairs_state, pairs_x, pairs_cot = _pairs_inputs()
    torch.save({"dryrun_state": state_dict_from_flax(params, keys), "pairs_cfg": PAIRS_CFG,
                "pairs_state": pairs_state, "pairs_x": pairs_x, "pairs_cot": pairs_cot},
               out / "inputs.pt")
    (out / "worker.py").write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    ports = {"grid": _free_port(), "dp": _free_port()}
    roles = [f"grid{r}" for r in range(4)] + [f"dp{r}" for r in range(2)]
    procs = {role: subprocess.Popen(
        [sys.executable, str(out / "worker.py"), role, str(out), str(ports[role[:-1]])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for role in roles}
    # the port's dry run as a user starts it, alongside
    procs["dryrun"] = subprocess.Popen(
        [sys.executable, "-m", "vilbert_tpu_torch.parallel.dryrun", "--processes", "4",
         "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        # XLA compiles outside the GIL: the three references side by side
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            step = pool.submit(_jax_dryrun_step, cfg, model, batch, params)
            pairs = {fast: pool.submit(_flax_pairs, pairs_state, pairs_x[fast],
                                       pairs_cot[fast], fast) for fast in (False, True)}
            jax_step, flax_pairs = step.result(), {k: f.result() for k, f in pairs.items()}
        logs = {role: proc.communicate(timeout=300)[0] for role, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    dryrun = procs.pop("dryrun").returncode, logs.pop("dryrun")
    for role, proc in procs.items():
        assert proc.returncode == 0 and "WORKER_OK" in logs[role], \
            f"{role} failed:\n{logs[role][-4000:]}"
    ranks = {role: torch.load(out / f"{role}.pt", weights_only=False) for role in roles}
    return ranks, jax_step, flax_pairs, batch, dryrun


def _flax(state_dict):
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    return _flatten(flax_from_state_dict(state_dict))


def test_the_dryrun_batch_is_the_jax_dryrun_batch(runs):
    from vilbert_tpu_torch.parallel.dryrun import dryrun_config, pretrain_batch

    *_, batch, _ = runs
    got = pretrain_batch(dryrun_config(), 2)
    assert set(got) == set(batch)
    assert all(np.array_equal(got[k], batch[k]) for k in batch)


def test_grid_layout(runs):
    ranks, *_ = runs
    assert [ranks[f"grid{r}"]["mesh"] for r in range(4)] == [
        (0, 0, 2, 2), (0, 1, 2, 2), (1, 0, 2, 2), (1, 1, 2, 2)]
    assert [ranks[f"dp{r}"]["mesh"] for r in range(2)] == [(0, 0, 2, 1), (1, 0, 2, 1)]


def test_sharded_step_matches_the_jax_dryrun(runs):
    """The loss within 1e-5 on every rank, and every parameter after the
    step within 1e-5 of its max plus 1e-4 of the learning rate, and never
    beyond 1e-4 of its max plus 1e-5 of the learning rate; the ranks'
    parameters bit-equal. The floor is the fp32 gradients' and not the
    sharding's (``test_sharded_update_is_the_replicated_update`` holds the
    sharded update to the replicated one bit for bit): XLA and the port sum
    the backward in other orders, and Adam's first step divides by
    |g| + eps, so an element whose gradient is near eps follows the
    gradient's last bits; a bias that starts at zero is one step of the
    learning rate after it, and its elements differ by up to ~4e-5 of that
    step. The attention key biases start at zero under a softmax that
    cancels their gradient, which is rounding noise, and move by far less
    than 1e-5 of the learning rate."""
    ranks, (loss, want_params, _, _), *_ = runs
    for r in range(4):
        got = ranks[f"grid{r}"]["step"]
        assert abs(got["metrics"]["loss"] - loss) <= 1e-5 * abs(loss), (got["metrics"], loss)
        params = _flax(got["params"])
        assert set(params) == set(want_params)
        for path, w in want_params.items():
            err, top = float(np.abs(params[path] - w).max()), float(np.abs(w).max())
            assert err <= min(1e-5 * top + 1e-4 * LR, 1e-4 * top + 1e-5 * LR), (path, err)
    first = ranks["grid0"]["step"]["params"]
    for r in range(1, 4):
        assert all(torch.equal(ranks[f"grid{r}"]["step"]["params"][k], v)
                   for k, v in first.items())


def test_moment_slices_put_together_match_the_jax_moments(runs):
    """Within a data row the two ranks' moment slices, concatenated along
    the sharded dim, are the JAX step's moments within 1e-6 of each max,
    plus 1e-7 of the model's largest: the first moment is 0.1 g, the
    second 0.001 g^2, and the floor covers the key biases, whose gradients
    are rounding noise (``test_sharded_step_matches_the_jax_dryrun``)."""
    ranks, (_, _, want_mu, want_nu), *_ = runs
    for row in (0, 1):
        a, b = ranks[f"grid{2 * row}"]["step"], ranks[f"grid{2 * row + 1}"]["step"]
        assert a["shards"] and set(a["shards"]) == set(b["shards"])
        for which, want in (("mu", want_mu), ("nu", want_nu)):
            full = {n: torch.cat([a[which][n], b[which][n]], a["shards"][n][0])
                    if n in a["shards"] else a[which][n] for n in a[which]}
            got = _flax(full)
            assert set(got) == set(want)
            top = max(float(np.abs(w).max()) for w in want.values())
            for path, w in want.items():
                err = float(np.abs(got[path] - w).max())
                assert err <= 1e-6 * float(np.abs(w).max()) + 1e-7 * top, (which, path, err)


def test_each_rank_holds_only_its_slices(runs):
    """A sharded parameter's moments are half its size, on the model rank's
    own index; the rest are whole; the model holds every parameter whole."""
    ranks, *_ = runs
    for r in range(4):
        step = ranks[f"grid{r}"]["step"]
        params = step["params"]
        for n, (dim, index, parts) in step["shards"].items():
            assert (index, parts) == (r % 2, 2)
            for which in ("mu", "nu"):
                assert step[which][n].shape[dim] * 2 == params[n].shape[dim]
        held = sum(v.numel() for which in ("mu", "nu") for v in step[which].values())
        whole = 2 * sum(v.numel() for v in params.values())
        halved = 2 * sum(params[n].numel() // 2 for n in step["shards"])
        assert held == whole - halved


def test_trainers_on_the_grid_are_the_data_only_run(runs):
    """Dropout 0.1: every rank of the 2 x 2 mesh, bit for bit, the rank of
    its data row in the data-only run."""
    ranks, *_ = runs
    for r in range(4):
        got, want = ranks[f"grid{r}"]["trainers"], ranks[f"dp{r // 2}"]["trainers"]
        assert got["cc_metrics"] == want["cc_metrics"]
        assert got["mt_losses"] == want["mt_losses"] and got["mt_eval"] == want["mt_eval"]
        for key in ("cc_params", "mt_params"):
            assert all(torch.equal(got[key][k], v) for k, v in want[key].items()), key


@pytest.mark.parametrize("fast_mode", [False, True])
def test_in_batch_pairs_across_data_ranks(runs, fast_mode):
    """Each rank's pair rows (its texts with every image, or under
    fast_mode the one text with its images) within 1e-4 of its rows of the
    flax encoder on the global batch; the gradients averaged over the ranks
    within 1e-4 of each max of the flax gradients, plus 1e-7 of the largest
    (the attention key biases' gradients are rounding noise)."""
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    ranks, _, flax_pairs, *_ = runs
    want_out, want_grads = flax_pairs[fast_mode]
    for r in range(2):
        got = ranks[f"dp{r}"]["pairs"][fast_mode]
        rows = (PAIRS_B // 2) * (1 if fast_mode else PAIRS_B)
        for o, w in zip(got["outputs"], want_out):
            assert o.shape[0] == rows
            np.testing.assert_allclose(o.numpy(), w[r * rows:(r + 1) * rows], atol=1e-4,
                                       rtol=1e-4)
        grads = _flatten(flax_from_state_dict(
            {f"bert.{k}": v for k, v in got["grads"].items()})["bert"])
        assert set(grads) == set(want_grads)
        top = max(float(np.abs(w).max()) for w in want_grads.values())
        for path, w in want_grads.items():
            err = float(np.abs(grads[path] - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()) + 1e-7 * top, (path, err)
    assert all(torch.equal(ranks["dp0"]["pairs"][fast_mode]["grads"][k], v)
               for k, v in ranks["dp1"]["pairs"][fast_mode]["grads"].items())


def test_port_dryrun_on_the_cpu(runs):
    """``python -m vilbert_tpu_torch.parallel.dryrun --processes 4 --device
    cpu``: both lines of the JAX dry run, on a {'data': 2, 'model': 2}
    mesh, the ranks alike."""
    rc, log = runs[-1]
    assert rc == 0, log[-4000:]
    lines = log.strip().splitlines()[-2:]
    assert lines[0].startswith("dryrun_multichip(4): ok, loss=")
    assert lines[0].endswith("mesh={'data': 2, 'model': 2}")
    assert lines[1].startswith("dryrun_multitask: ok, losses={'TASK_A': ")
