"""The PyTorch port never imports jax, flax or the JAX package.

The card machine has no jax. This file's tests run the port in a fresh
interpreter (tests/conftest.py has already imported jax into this one) in
which ``vilbert_tpu`` cannot be imported (``sys.modules["vilbert_tpu"] =
None``): import every module of ``vilbert_tpu_torch``, run the eval CLI and
the two training CLIs, the retrieval CLI and the demo end to end on a tiny
config on the CPU, and check that neither jax nor flax was loaded.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_TINY = dict(
    vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, max_position_embeddings=64, v_feature_size=2048,
    v_hidden_size=24, v_num_hidden_layers=2, v_num_attention_heads=4,
    v_intermediate_size=48, v_target_size=11, bi_hidden_size=32,
    bi_num_attention_heads=4, v_biattention_id=[0, 1], t_biattention_id=[0, 1],
)

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["vilbert_tpu"] = None  # any import of the JAX package fails
import vilbert_tpu_torch
for m in pkgutil.walk_packages(vilbert_tpu_torch.__path__, "vilbert_tpu_torch."):
    importlib.import_module(m.name)
from vilbert_tpu_torch.cli.eval_tasks import main
main(sys.argv[1:])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not leaked, leaked
print("JAX_FREE_OK")
"""


def test_port_runs_without_jax(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, "--synthetic", "--tasks", "1",
         "--config", str(cfg), "--device", "cpu", "--output_dir", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout
    records = json.loads((out / "VQA_val_result.json").read_text())
    assert len(records) == 16 and set(records[0]) == {"question_id", "answer"}
    metrics = json.loads((out / "metrics_VQA_val.json").read_text())
    assert metrics["num_samples"] == 16


_TRAIN_SCRIPT = """
import sys
sys.modules["vilbert_tpu"] = None  # any import of the JAX package fails
from vilbert_tpu_torch.cli.train_concap import main
main(sys.argv[1:])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("JAX_FREE_OK")
"""


def test_train_cli_runs_without_jax(tmp_path):
    """The training slice (model, dropout, losses, optimizer, step, data,
    checkpoint writer) on the CPU, with no jax, flax or optax loaded."""
    import numpy as np

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(_TINY, v_target_size=1601)))  # the synthetic CC targets
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_SCRIPT, "--synthetic", "--device", "cpu",
         "--num_steps", "2", "--batch_size", "8", "--config", str(cfg),
         "--output_dir", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout
    with np.load(out / "params_final.npz") as z:
        assert "bert.embeddings.word_embeddings.embedding" in z.files
        assert "cls.predictions.bias" in z.files


_TASKS_SCRIPT = """
import sys
sys.modules["vilbert_tpu"] = None  # any import of the JAX package fails
from vilbert_tpu_torch.cli.train_tasks import main
trainer = main(sys.argv[1:])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not leaked, leaked
assert trainer.global_step == 2, trainer.global_step
cfg, out = sys.argv[sys.argv.index("--config") + 1], sys.argv[sys.argv.index("--output_dir") + 1]
base = main(["--synthetic", "--device", "cpu", "--baseline", "--tasks", "1-4-7-9",
             "--num_iterations", "1", "--config", cfg, "--output_dir", out + "_baseline"])
assert base.global_step == 1 and base.model.family == "basebert", base.model.family
try:
    main(["--synthetic", "--device", "cpu", "--num_processes", "2"])
except ValueError as e:
    assert "--coordinator" in str(e), e
else:
    raise AssertionError("--num_processes without --coordinator was not refused")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("JAX_FREE_OK")
"""


def test_multitask_cli_runs_without_jax(tmp_path):
    """The multi-task slice (task heads and losses, masks, the host LR
    schedule, the trainer, controllers, logger) through the CLI on the CPU:
    two round-robin iterations over six task types with task tokens, and
    one of the single-stream baseline over four, with no jax, flax or optax
    loaded; a refused flag raises."""
    import numpy as np

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _TASKS_SCRIPT, "--synthetic", "--device", "cpu",
         "--tasks", "1-4-7-9-12-13", "--task_specific_tokens", "--num_iterations", "2",
         "--config", str(cfg), "--output_dir", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout
    with np.load(out / "params_final.npz") as z:
        assert "vil_prediction.dense1.kernel" in z.files
        assert "bert.embeddings.task_embeddings.embedding" in z.files
    with np.load(f"{out}_baseline/params_final.npz") as z:
        assert "bert.layer_1.attention_self.query.kernel" in z.files
        assert "vil_prediction_1.kernel" in z.files


def test_no_jax_import_statement_in_port():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M)
    offenders = [
        str(p.relative_to(REPO))
        for p in (REPO / "vilbert_tpu_torch").rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert not offenders


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: no statement of it imports jax,
    flax or the JAX package. The configuration it takes through
    ``vilbert_tpu_torch`` is the port's own copy, with the JAX package's
    fields and defaults, parsing every config file alike."""
    import dataclasses

    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|vilbert_tpu)\b", re.M)
    assert not pattern.findall((REPO / "chip_smoke.py").read_text())
    from vilbert_tpu.core import config as jax_config
    from vilbert_tpu_torch.core import config

    def fields(cls):
        return [(f.name, f.default if f.default_factory is dataclasses.MISSING
                 else f.default_factory()) for f in dataclasses.fields(cls)]

    for name in ("ModelConfig", "OptimizerConfig", "TaskConfig"):
        assert getattr(config, name) is not getattr(jax_config, name)
        assert fields(getattr(config, name)) == fields(getattr(jax_config, name)), name
    for path in sorted((REPO / "configs").glob("*.json")):
        assert dataclasses.asdict(config.ModelConfig.from_json_file(str(path))) == \
            dataclasses.asdict(jax_config.ModelConfig.from_json_file(str(path))), path.name
    try:
        import yaml  # noqa: F401
    except ImportError:
        return
    tasks_yml = str(REPO / "configs" / "tasks.yml")
    port, ref = config.load_task_configs(tasks_yml), jax_config.load_task_configs(tasks_yml)
    assert {k: dataclasses.asdict(t) for k, t in port.items()} == \
        {k: dataclasses.asdict(t) for k, t in ref.items()}


_EVAL_SCRIPT = """
import sys
sys.modules["vilbert_tpu"] = None  # any import of the JAX package fails
from vilbert_tpu_torch.cli import demo, eval_retrieval
cfg, out = sys.argv[1:3]
metrics = eval_retrieval.main(["--synthetic", "--device", "cpu", "--config", cfg,
                               "--fast_mode", "--output", out])
assert metrics["num_captions"] == 40 and metrics["pool_size"] == 8, metrics
eval_retrieval.main(["--synthetic", "--device", "cpu", "--config", cfg, "--zero_shot",
                     "--output", out + ".zs"])
demo.main(["--synthetic", "--device", "cpu", "--config", cfg])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("JAX_FREE_OK")
"""


def test_retrieval_and_demo_run_without_jax(tmp_path):
    """The retrieval CLI (fine-tuned with fast_mode, and zero-shot) and the
    demo on the CPU, with no jax, flax or optax loaded."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _EVAL_SCRIPT, str(cfg), str(tmp_path / "r.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout and "grounded region:" in proc.stdout
    assert set(json.loads((tmp_path / "r.json").read_text())) == {
        "r1", "r5", "r10", "medr", "meanr", "num_captions", "pool_size"}


_OPTIONS_SCRIPT = """
import sys
sys.modules["vilbert_tpu"] = None  # any import of the JAX package fails
import torch
from vilbert_tpu_torch.cli import demo, eval_tasks, train_concap
from vilbert_tpu_torch.core.config import ModelConfig
from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks
from vilbert_tpu_torch.ops.quant import calibrating
cfg, cc_cfg, out = sys.argv[1:4]
eval_tasks.main(["--synthetic", "--tasks", "1", "--int8", "--config", cfg, "--device", "cpu",
                 "--output_dir", out])
demo.main(["--synthetic", "--device", "cpu", "--config", cfg, "--int8"])
state = train_concap.main(["--synthetic", "--device", "cpu", "--num_steps", "2",
                           "--batch_size", "4", "--remat", "--config", cc_cfg,
                           "--output_dir", out + "_cc"])
assert state.model.cfg.remat
mcfg = ModelConfig.from_json_file(cfg, int8_static=True, visualization=True)
model = ViLBERTForVLTasks(mcfg).eval()
x = (torch.randint(0, 99, (2, 5)), torch.randn(2, 3, 2048), torch.rand(2, 3, 5))
with torch.no_grad(), calibrating(model):
    model(*x)
with torch.no_grad():
    maps = model(*x).attention_probs
assert len(maps) == 8, sorted(maps)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("JAX_FREE_OK")
"""


def test_model_options_run_without_jax(tmp_path):
    """The model options of ``ops/quant.py`` and the encoder on the CPU, with
    no jax, flax or optax loaded: ``eval_tasks --int8``, ``demo --int8``,
    ``train_concap --remat``, and a static-int8 model calibrated under
    ``calibrating`` returning its ``visualization`` maps."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    cc_cfg = tmp_path / "tiny_cc.json"
    cc_cfg.write_text(json.dumps(dict(_TINY, v_target_size=1601)))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _OPTIONS_SCRIPT, str(cfg), str(cc_cfg), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout
    assert "vqa answer idx:" in proc.stdout
    assert json.loads((out / "metrics_VQA_val.json").read_text())["num_samples"] == 16


_PARALLEL_SCRIPT = """
import socket, sys
sys.modules["vilbert_tpu"] = None  # any import of the JAX package fails
import numpy as np
from vilbert_tpu_torch.cli import train_concap
from vilbert_tpu_torch.core.config import ModelConfig
from vilbert_tpu_torch.core.tf_import import load_tf_weights
from vilbert_tpu_torch.data import native_vfs
from vilbert_tpu_torch.data.feature_store import InMemoryFeatureStore, VrfWriter
from vilbert_tpu_torch.data.prefetch import device_prefetch, to_tensors
from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining
from vilbert_tpu_torch.parallel.distributed import is_initialized

cfg, out = sys.argv[1:3]
staged = list(device_prefetch(iter([{"x": np.full(2, i)} for i in range(3)]), size=2,
                              device="cpu", transform=to_tensors))
assert [int(b["x"][0]) for b in staged] == [0, 1, 2]
store = InMemoryFeatureStore.synthetic(num_images=2, num_boxes=3, feature_dim=8, target_dim=4)
with VrfWriter(out + ".vfr", feature_dim=8, target_dim=4) as w:
    for k in store.keys():
        w.add(k, store.get(k))
reader = native_vfs.NativeVrfFeatureStore(out + ".vfr")
assert np.array_equal(reader.get("0").features, store.get("0").features)
reader.close()
mcfg = ModelConfig.from_json_file(cfg)
model = ViLBERTForPretraining(mcfg)
words = np.ones((mcfg.vocab_size, mcfg.hidden_size), np.float32)
assert load_tf_weights(model, {"bert/embeddings/word_embeddings": words}).loaded
sock = socket.socket(); sock.bind(("localhost", 0)); port = sock.getsockname()[1]; sock.close()
train_concap.main(["--synthetic", "--device", "cpu", "--num_steps", "2", "--batch_size", "8",
                   "--config", cfg, "--output_dir", out, "--coordinator", f"localhost:{port}",
                   "--num_processes", "1", "--process_id", "0"])
assert not is_initialized()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("JAX_FREE_OK")
"""


def test_parallel_prefetch_import_and_reader_run_without_jax(tmp_path):
    """The modules of the last slice with no jax, flax or optax loaded: the
    staging thread, the native VFR reader (built into ``build/``), the TF
    import into a model, and the CC CLI over a one-rank gloo process group
    (``--coordinator``), which it leaves at the end."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(_TINY, v_target_size=1601)))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _PARALLEL_SCRIPT, str(cfg), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout
    assert (out / "params_final.npz").exists()
