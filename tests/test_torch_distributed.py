"""Data parallelism of the port over ``torch.distributed`` (gloo), on the CPU.

The port's counterpart of ``tests/test_distributed.py``. The JAX step runs
on the global batch; the port's ranks each run their shard and average the
gradients. Two gloo processes and one single process run the same program
(``WORKER``): the ranks on their shards, the single process on the global
batch they make together (the ranks' microbatches concatenated in rank
order, as ``make_array_from_process_local_data`` assembles them), from the
same seed, at fp32 with dropout 0.1 at every site:

- 3 CC steps with ``grad_accum`` 2 and masked counts that differ between
  the ranks (rank 0's rows are masked far more often), and 2 NCE steps:
  every step's loss within 1e-5 and every gradient within 1e-4 of its
  max of the single process's; the validation pass likewise;
- 2 multi-task iterations over two tasks with ``grad_accum`` 2: each
  task's loss and gradients likewise, and the per-task evaluation's sums;
- the ranks end with bit-equal parameters; ``in_batch_pairs`` pairs each
  rank's texts with every rank's images, and its pretraining run raises as
  the single process's does;
- both CLIs run with ``--coordinator --num_processes --process_id``, and a
  one-rank process group gives the no-group run's numbers bit for bit.

The masks: a rank's hidden-dropout offset and attention seed shift give
the global batch's masks, against ``hash_keep_mask`` of the JAX package on
the global shape too.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

WORKER = r'''
import json, os, sys
import numpy as np
import torch

role, out_dir = sys.argv[1], sys.argv[2]
ports = [int(p) for p in sys.argv[3].split(",")]
torch.set_num_threads(1)

from vilbert_tpu_torch.core.config import ModelConfig, OptimizerConfig, TaskConfig, TrainConfig
from vilbert_tpu_torch.parallel.distributed import (
    initialize_distributed, process_shard, shutdown_distributed)
from vilbert_tpu_torch.parallel.mesh import make_mesh
from vilbert_tpu_torch.train import optim
from vilbert_tpu_torch.train.multitask import MultiTaskTrainer
from vilbert_tpu_torch.train.pretrain import evaluate_pretraining, run_pretraining

GRADS = []  # every optimizer step's gradients, in order
_step = optim.ReferenceAdamW.step


def _recording_step(self, grads, **kw):
    GRADS.append({k: v.detach().clone() for k, v in grads.items()})
    return _step(self, grads, **kw)


optim.ReferenceAdamW.step = _recording_step

WORLD, GA, BM = 2, 2, 2      # ranks, microbatches a step, a rank's rows a microbatch
BG = WORLD * GA * BM          # rows of a global batch
T, R = 7, 5
cfg = ModelConfig(
    vocab_size=50, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=32, max_position_embeddings=32, v_feature_size=12, v_hidden_size=16,
    v_num_hidden_layers=1, v_num_attention_heads=2, v_intermediate_size=32, v_target_size=7,
    bi_hidden_size=16, bi_num_attention_heads=2, v_biattention_id=(0,), t_biattention_id=(1,),
    compute_dtype="float32", hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
    v_hidden_dropout_prob=0.1, v_attention_probs_dropout_prob=0.1)
# global row g of a microbatch-major batch belongs to rank (g % (WORLD*BM)) // BM
ROW_RANK = (np.arange(BG) % (WORLD * BM)) // BM


def rows_of(rank):
    """A rank's rows of the global batch: its BM rows of each microbatch."""
    return [m * WORLD * BM + rank * BM + i for m in range(GA) for i in range(BM)]


def cc_global(seed, vt=0):
    r = np.random.RandomState(seed)
    dim = cfg.v_feature_size if vt else cfg.v_target_size
    target = r.rand(BG, R - 1, dim).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    p = np.where(ROW_RANK == 0, 0.7, 0.15)[:, None]  # unequal masked counts
    return {
        "input_ids": r.randint(1, cfg.vocab_size, (BG, T)).astype(np.int32),
        "image_feat": r.randn(BG, R, cfg.v_feature_size).astype(np.float32),
        "image_loc": r.rand(BG, R, 5).astype(np.float32),
        "segment_ids": r.randint(0, 2, (BG, T)).astype(np.int32),
        "input_mask": np.ones((BG, T), np.int32),
        "image_mask": np.ones((BG, R), np.int32),
        "lm_label_ids": np.where(r.rand(BG, T) < p, r.randint(0, cfg.vocab_size, (BG, T)),
                                 -1).astype(np.int32),
        "image_label": np.where(r.rand(BG, R - 1) < p, 1, -1).astype(np.int32),
        "image_target": target,
        "is_next": r.randint(0, 2, (BG,)).astype(np.int32),
    }


def task_global(key, seed):
    """A task batch of 2 * BM rows (two ranks' loader batches, rank order)."""
    r = np.random.RandomState(seed)
    b = WORLD * BM
    return {
        "question": r.randint(1, cfg.vocab_size, (b, 6)).astype(np.int64),
        "features": r.randn(b, R, cfg.v_feature_size).astype(np.float32),
        "spatials": r.rand(b, R, 5).astype(np.float32),
        "segment_ids": np.zeros((b, 6), np.int64),
        "input_mask": np.ones((b, 6), np.int64),
        "image_mask": np.ones((b, R), np.int64),
        "target": (r.rand(b, 13).astype(np.float32) if key == "TASK1"
                   else r.randint(0, 3, (b,)).astype(np.int64)),
    }


class Loader(list):
    pass


def run_all(mesh, shard):
    """Every scenario; ``shard(batch, kind)`` cuts a global batch to this
    process's rows (the identity for the single process): "cc" its rows of
    each microbatch (``rows_of``), "halves" its contiguous share."""
    out = {}
    opt = OptimizerConfig(learning_rate=1e-3, schedule="constant")
    for name, vt, steps, grad_dtype in (("cc", 0, 3, ""), ("nce", 2, 2, ""),
                                        ("bf16_grads", 0, 1, "bfloat16")):
        c = cfg.replace(visual_target=vt, num_negative=5)
        batches = [shard(cc_global(100 + 10 * vt + s, vt), "cc") for s in range(steps)]
        GRADS.clear()
        metrics = []
        state = run_pretraining(
            c, opt, batches, num_steps=steps, seed=0, device="cpu", lm_gather=3,
            grad_accum=GA, log_every=0, mesh=mesh, grad_dtype=grad_dtype,
            hooks=[lambda s, st, m: metrics.append({k: v.item() for k, v in m.items()})])
        out[name] = {"metrics": metrics, "grads": list(GRADS),
                     "params": state.model.state_dict(),
                     "lm_counts": [int((b["lm_label_ids"] != -1).sum()) for b in batches]}
        # no microbatches in the validation pass: the ranks' halves in order
        val = [shard(cc_global(300 + 10 * vt + s, vt), "halves") for s in range(2)]
        out[name]["val"] = evaluate_pretraining(c, state.model, val, lm_gather=3,
                                                device="cpu", seed=1, mesh=mesh)

    tasks = {
        "TASK1": TaskConfig(task_id=1, name="VQA", type="VL-classifier",
                            loss="BCEWithLogitLoss", batch_size=WORLD * BM * GA, lr=4e-4,
                            num_epoch=2, num_labels=13),
        "TASK9": TaskConfig(task_id=9, name="VE", type="VL-tri-classifier",
                            loss="CrossEntropyLoss", batch_size=WORLD * BM * GA, lr=2e-4,
                            num_epoch=2, num_labels=3),
    }
    loaders, vals = {}, {}
    for i, key in enumerate(tasks):
        loaders[key] = Loader(shard(task_global(key, 400 + 10 * i + s), "halves")
                              for s in range(4))
        vals[key] = Loader(shard(task_global(key, 500 + 10 * i + s), "halves")
                           for s in range(2))
    for ld in (*loaders.values(), *vals.values()):
        ld.batch_size = len(ld[0]["question"])
    GRADS.clear()
    trainer = MultiTaskTrainer(
        cfg, tasks, loaders, val_loaders=vals, num_labels=13, seed=0, device="cpu",
        dropout_prob=0.1, mesh=mesh, num_train_epochs=2,
        opt_cfg=OptimizerConfig(learning_rate=2e-4, schedule="warmup_linear",
                                warmup_proportion=0.25, correct_bias=False),
        train_cfg=TrainConfig(gradient_accumulation_steps=GA))
    losses = []
    for it in range(2):
        m = trainer.train_iteration(it)
        losses.append({k: v["loss"].item() for k, v in m.items()})
    out["multitask"] = {"losses": losses, "grads": list(GRADS),
                        "params": trainer.model.state_dict(),
                        "eval": {k: trainer.evaluate(k) for k in tasks}}
    trainer.close()
    return out


def in_batch_pairs(mesh, shard):
    """The pretraining model under in_batch_pairs on this process's rows of
    a batch: each text paired with the images of every rank (the global
    batch's pair rows of its texts), and the pretraining run, which raises
    on the pairs as one process does (and as the JAX loss does); across
    ranks, the model with no mesh set, which raises rather than pair
    within the rank."""
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining, set_pair_mesh

    c = cfg.replace(in_batch_pairs=True)
    batch = {k: torch.from_numpy(v) for k, v in shard(cc_global(700), "halves").items()}
    model = ViLBERTForPretraining(c, generator=torch.Generator().manual_seed(0)).eval()
    set_pair_mesh(model, mesh)
    args = (batch["input_ids"], batch["image_feat"], batch["image_loc"],
            batch["segment_ids"], batch["input_mask"], batch["image_mask"])
    with torch.no_grad():
        out = model(*args)
        unset = None
        if mesh is not None:
            try:
                set_pair_mesh(model, None)(*args)
            except ValueError as e:
                unset = str(e)
    try:
        run_pretraining(c, OptimizerConfig(), [shard(cc_global(700), "halves")], num_steps=1,
                        device="cpu", mesh=mesh, log_every=0)
        error = None
    except ValueError as e:
        error = str(e)
    return {"nsp": out.seq_relationship_score, "error": error, "unset": unset}


tiny_cli = os.path.join(out_dir, "tiny.json")
if role == "single":
    results = run_all(None, lambda b, kind: b)
    results["in_batch_pairs"] = in_batch_pairs(None, lambda b, kind: b)
    # a one-rank process group: the same numbers, bit for bit
    initialize_distributed(f"localhost:{ports[0]}", 1, 0, device="cpu")
    one = run_all(make_mesh(device="cpu"), lambda b, kind: b)
    shutdown_distributed()
    results["one_rank"] = one
    # the CC CLI with and without --coordinator (one process)
    from vilbert_tpu_torch.cli import train_concap
    flags = ["--synthetic", "--device", "cpu", "--num_steps", "2", "--batch_size", "8",
             "--config", tiny_cli]
    train_concap.main(flags + ["--output_dir", os.path.join(out_dir, "cli_plain")])
    train_concap.main(flags + ["--output_dir", os.path.join(out_dir, "cli_one_rank"),
                               "--coordinator", f"localhost:{ports[1]}", "--num_processes",
                               "1", "--process_id", "0"])
else:
    rank = int(role[-1])
    initialize_distributed(f"localhost:{ports[0]}", WORLD, rank, device="cpu")
    assert process_shard() == (rank, WORLD)
    mesh = make_mesh(device="cpu")

    def shard(batch, kind):
        n = len(next(iter(batch.values()))) // WORLD
        rows = rows_of(rank) if kind == "cc" else list(range(rank * n, (rank + 1) * n))
        return {k: v[rows] for k, v in batch.items()}

    results = run_all(mesh, shard)
    results["in_batch_pairs"] = in_batch_pairs(mesh, shard)
    # both CLIs, data-parallel over the same two processes
    from vilbert_tpu_torch.cli import train_concap, train_tasks
    dist = ["--coordinator", f"localhost:{ports[0]}", "--num_processes", str(WORLD),
            "--process_id", str(rank)]
    mt = train_tasks.train(train_tasks.build_parser().parse_args(
        ["--synthetic", "--device", "cpu", "--tasks", "1-12", "--num_iterations", "1",
         "--config", tiny_cli, "--output_dir", os.path.join(out_dir, "cli_mt")] + dist))
    results["cli_mt"] = mt.model.state_dict()
    mt.close()
    state = train_concap.main(["--synthetic", "--device", "cpu", "--num_steps", "2",
                               "--batch_size", "8", "--config", tiny_cli,
                               "--output_dir", os.path.join(out_dir, "cli_cc")] + dist)
    results["cli_cc"] = state.model.state_dict()
torch.save(results, os.path.join(out_dir, f"{role}.pt"))
print("WORKER_OK", role, flush=True)
'''

_TINY_CLI = dict(
    vocab_size=99, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=32, max_position_embeddings=64, v_feature_size=2048,
    v_hidden_size=16, v_num_hidden_layers=1, v_num_attention_heads=2,
    v_intermediate_size=32, v_target_size=1601, bi_hidden_size=16,
    bi_num_attention_heads=2, v_biattention_id=[0], t_biattention_id=[1],
)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks and the single process, run side by side."""
    out = tmp_path_factory.mktemp("ddp")
    (out / "worker.py").write_text(WORKER)
    (out / "tiny.json").write_text(json.dumps(_TINY_CLI))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    rank_ports, single_ports = _free_ports(1), _free_ports(2)
    procs = {
        role: subprocess.Popen(
            [sys.executable, str(out / "worker.py"), role, str(out),
             ",".join(map(str, single_ports if role == "single" else rank_ports))],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for role in ("rank0", "rank1", "single")
    }
    logs = {}
    try:
        for role, proc in procs.items():
            logs[role], _ = proc.communicate(timeout=240)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for role, proc in procs.items():
        assert proc.returncode == 0 and "WORKER_OK" in logs[role], \
            f"{role} failed:\n{logs[role][-4000:]}"
    return {role: torch.load(out / f"{role}.pt", weights_only=False) for role in procs}, out


def _close_grads(got, want):
    """Each gradient within 1e-4 of its max|grad|, plus 1e-7 of the largest
    gradient of the step: a floor for gradients that are a sum cancelling to
    rounding noise (the alignment head's bias: softmax minus one-hot summed
    over the rows), whose rounding follows the sum's terms, not its value."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        top = max(float(v.abs().max()) for v in w.values())
        for name in w:
            bound = 1e-4 * float(w[name].abs().max()) + 1e-7 * top
            err = float((g[name] - w[name]).abs().max())
            assert err <= bound, (name, err, bound)


def _close(a, b, rel=1e-5):
    assert abs(a - b) <= rel * max(abs(b), 1e-6), (a, b)


@pytest.mark.parametrize("run", ["cc", "nce"])
def test_pretraining_matches_the_single_process(runs, run):
    """Dropout 0.1, grad_accum 2, unequal masked counts (and NCE's
    negatives across the global batch): each step's metrics within 1e-5
    and each gradient within 1e-4 of its max of the single process's."""
    res, _ = runs
    want = res["single"][run]
    for rank in ("rank0", "rank1"):
        got = res[rank][run]
        assert len(got["metrics"]) == len(want["metrics"])
        for g, w in zip(got["metrics"], want["metrics"]):
            for k in ("loss", "masked_loss_t", "masked_loss_v", "next_sentence_loss"):
                _close(g[k], w[k])
        _close_grads(got["grads"], want["grads"])


def test_bf16_gradients_match_within_their_rounding(runs):
    """``--bf16_grads`` with grad_accum 2: the ranks' bf16 gradients, summed
    over the microbatches in fp32 and averaged over the ranks in their own
    dtype, within two bf16 roundings of each gradient's max (2^-7) of the
    single process's: a rank's microbatch gradient rounds a sum over its own
    rows to bf16, and the all-reduce rounds the ranks' sum to bf16 again;
    plus one bf16 rounding of the step's largest gradient (2^-8), the floor
    for a sum that cancels to its rounding noise (the alignment head's
    bias), as ``_close_grads``'s 1e-7 is for fp32. The loss within 1e-5."""
    res, _ = runs
    want = res["single"]["bf16_grads"]
    for rank in ("rank0", "rank1"):
        got = res[rank]["bf16_grads"]
        _close(got["metrics"][0]["loss"], want["metrics"][0]["loss"])
        for g, w in zip(got["grads"], want["grads"]):
            top = max(float(v.float().abs().max()) for v in w.values())
            for name in w:
                bound = 2.0 ** -7 * float(w[name].float().abs().max()) + 2.0 ** -8 * top
                assert float((g[name].float() - w[name].float()).abs().max()) <= bound, name


def test_masked_counts_differ_between_the_ranks(runs):
    """The steps above divide by counts that differ between the ranks, so
    averaging each rank's own mean would not give the global loss."""
    res, _ = runs
    for run in ("cc", "nce"):
        c0, c1 = res["rank0"][run]["lm_counts"], res["rank1"][run]["lm_counts"]
        assert all(a > 2 * b for a, b in zip(c0, c1)), (c0, c1)
        assert [a + b for a, b in zip(c0, c1)] == res["single"][run]["lm_counts"]


def test_validation_is_the_global_batches(runs):
    res, _ = runs
    for run in ("cc", "nce"):
        want = res["single"][run]["val"]
        for rank in ("rank0", "rank1"):
            got = res[rank][run]["val"]
            assert set(got) == set(want)
            for k in want:
                _close(got[k], want[k])
        assert res["rank0"][run]["val"] == res["rank1"][run]["val"]


def test_multitask_matches_the_single_process(runs):
    """Two round-robin iterations over two tasks with grad_accum 2: each
    task's loss within 1e-5 and each step's gradients within 1e-4 of
    their max."""
    res, _ = runs
    want = res["single"]["multitask"]
    for rank in ("rank0", "rank1"):
        got = res[rank]["multitask"]
        assert [set(m) for m in got["losses"]] == [set(m) for m in want["losses"]]
        for g, w in zip(got["losses"], want["losses"]):
            for k in w:
                _close(g[k], w[k])
        _close_grads(got["grads"], want["grads"])


def test_task_evaluation_sums_over_the_ranks(runs):
    """Every rank sees the global (loss, score) of the task's validation
    set, so the stop controllers stay in lockstep."""
    res, _ = runs
    want = res["single"]["multitask"]["eval"]
    a, b = res["rank0"]["multitask"]["eval"], res["rank1"]["multitask"]["eval"]
    assert a == b
    for key, w in want.items():
        _close(a[key]["loss"], w["loss"], 1e-6)
        _close(a[key]["score"], w["score"], 1e-6)


@pytest.mark.parametrize("run", ["cc", "nce", "bf16_grads", "multitask", "cli_mt", "cli_cc"])
def test_ranks_end_with_equal_parameters(runs, run):
    res, _ = runs
    a, b = res["rank0"][run], res["rank1"][run]
    a, b = (a["params"], b["params"]) if "params" in a else (a, b)
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_in_batch_pairs_raises_across_processes(runs):
    """in_batch_pairs runs across the processes: each rank's texts are
    paired with every rank's images, its rows those of the single
    process's pairs (rank-major texts, then images), within 1e-5; the
    pretraining run then raises the single process's ValueError, which
    names in_batch_pairs, where the JAX loss fails too. A model with no
    mesh set raises across ranks rather than pair within its rank."""
    res, _ = runs
    want = res["single"]["in_batch_pairs"]
    assert "in_batch_pairs" in want["error"]
    n = want["nsp"].shape[0] // 2
    assert n == 4 * 8  # 4 texts a rank x 8 images
    for r, rank in enumerate(("rank0", "rank1")):
        got = res[rank]["in_batch_pairs"]
        assert got["error"] is not None and "in_batch_pairs" in got["error"]
        assert got["unset"] is not None and "set_pair_mesh" in got["unset"]
        torch.testing.assert_close(got["nsp"], want["nsp"][r * n:(r + 1) * n], rtol=1e-5,
                                   atol=1e-5)


def test_one_rank_group_is_the_single_process_bit_for_bit(runs):
    res, out = runs
    single, one = res["single"], res["single"]["one_rank"]
    for run in ("cc", "nce", "bf16_grads"):
        assert one[run]["metrics"] == single[run]["metrics"]
        assert one[run]["val"] == single[run]["val"]
        assert all(torch.equal(one[run]["params"][k], single[run]["params"][k])
                   for k in single[run]["params"])
    assert one["multitask"]["losses"] == single["multitask"]["losses"]
    with np.load(out / "cli_plain" / "params_final.npz") as a, \
            np.load(out / "cli_one_rank" / "params_final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_clis_write_from_rank_0(runs):
    _, out = runs
    with np.load(out / "cli_cc" / "params_final.npz") as z:
        assert "bert.embeddings.word_embeddings.embedding" in z.files
    assert (out / "cli_mt" / "logs" / "out.txt").exists()


# -- the masks of a rank -----------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 2 ** 32 - 5])
def test_hidden_mask_offset_gives_the_global_mask(seed):
    """Rank r's mask of its [B_local, S, H] block, at offset r * numel, is
    rows r * B_local ... of the global batch's mask, which is the JAX
    package's ``hash_keep_mask`` on the global shape."""
    import jax.numpy as jnp

    from vilbert_tpu.ops.dropout import hash_keep_mask as jax_mask
    from vilbert_tpu_torch.ops.dropout import hash_keep_mask

    world, b, s, h = 3, 2, 5, 8
    full = hash_keep_mask((world * b, s, h), 0.1, seed)
    parts = [hash_keep_mask((b, s, h), 0.1, seed, offset=r * b * s * h) for r in range(world)]
    assert torch.equal(torch.cat(parts), full)
    want = np.asarray(jax_mask((world * b, s, h), 0.1, jnp.uint32(seed)))
    np.testing.assert_array_equal(full.numpy(), want)


@pytest.mark.parametrize("seed", [11, 2 ** 32 - 3])
def test_attention_seed_shift_gives_the_global_mask(seed):
    """Rank r's attention call with ``shard_seed`` draws tiles (b + r * B,
    h) of the global call: the ranks' masks concatenated are the global
    batch's ``attention_keep_mask``."""
    from vilbert_tpu_torch.ops.dropout import attention_keep_mask, shard_seed

    world, b, heads, sq, sk = 2, 3, 4, 5, 6
    full = attention_keep_mask(world * b, heads, sq, sk, 0.1, seed)
    parts = [attention_keep_mask(b, heads, sq, sk, 0.1, shard_seed(seed, r, b, heads))
             for r in range(world)]
    assert torch.equal(torch.cat(parts), full)
    assert shard_seed(seed, 0, b, heads) == seed


def test_a_model_at_rank_1_drops_the_global_rows():
    """A train-mode forward at ``set_dropout_generator(rank=1)`` on the
    second half of a batch equals the second half of the rank-0 forward on
    the whole batch (hidden and attention dropout at every site)."""
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.models.layers import set_dropout_generator
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining

    cfg = ModelConfig(
        vocab_size=40, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=32, v_feature_size=12, v_hidden_size=16,
        v_num_hidden_layers=1, v_num_attention_heads=2, v_intermediate_size=32,
        v_target_size=7, bi_hidden_size=16, bi_num_attention_heads=2, v_biattention_id=(0,),
        t_biattention_id=(1,), compute_dtype="float32", hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1, v_hidden_dropout_prob=0.1,
        v_attention_probs_dropout_prob=0.1)
    model = ViLBERTForPretraining(cfg, generator=torch.Generator().manual_seed(0)).train()
    g = torch.Generator().manual_seed(1)
    x = (torch.randint(1, 40, (4, 6), generator=g), torch.randn(4, 5, 12, generator=g),
         torch.rand(4, 5, 5, generator=g))
    set_dropout_generator(model, torch.Generator().manual_seed(3), rank=0)
    full = model(*x)
    set_dropout_generator(model, torch.Generator().manual_seed(3), rank=1)
    half = model(*(t[2:] for t in x))
    for name in ("prediction_scores_t", "prediction_scores_v", "seq_relationship_score"):
        torch.testing.assert_close(getattr(half, name), getattr(full, name)[2:],
                                   rtol=1e-5, atol=1e-6)


def test_initialize_refuses_incomplete_flags():
    from vilbert_tpu_torch.parallel.distributed import initialize_distributed, process_shard

    with pytest.raises(ValueError, match="--coordinator"):
        initialize_distributed(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="--process_id"):
        initialize_distributed("localhost:1", 2, None, device="cpu")
    with pytest.raises(ValueError, match="--process_id needs"):
        initialize_distributed(None, None, 1, device="cpu")
    assert initialize_distributed(device="cpu") == torch.device("cpu")
    assert process_shard() == (0, 1)
