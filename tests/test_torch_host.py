"""The port's own copies of the JAX package's host modules, against the originals.

``vilbert_tpu_torch`` imports nothing of ``vilbert_tpu``: it keeps its own
copies of the configuration classes, the weight importer, the datasets and
loaders, two helpers of the multi-task CLI and the stop controllers. Here,
from the same seeds and inputs, each copy gives what its original gives:
the same fields and defaults, the same parsed configs, bit-equal batches,
ids, keys and prefixes, the same source. ``chip_smoke.py`` builds the
flagship recipe's task configs in code (the card has no PyYAML); they equal
``configs/tasks.yml``'s.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.json"))
_IMPORT = re.compile(r"^\s*(import|from)\s+vilbert_tpu(\.|\s|$)", re.M)


def _defaults(cls) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
        else:
            out[f.name] = dataclasses.MISSING
    return out


def _assert_batches_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# -- the rule: no import of the JAX package ------------------------------------

def test_port_files_import_nothing_of_the_jax_package():
    offenders = [str(p.relative_to(REPO)) for p in (REPO / "vilbert_tpu_torch").rglob("*.py")
                 if _IMPORT.search(p.read_text())]
    assert not offenders


def test_chip_smoke_imports_nothing_of_the_jax_package():
    lines = [line for line in (REPO / "chip_smoke.py").read_text().splitlines()
             if _IMPORT.match(line)]
    assert not lines


# -- core/config.py --------------------------------------------------------------

@pytest.mark.parametrize("name", ["ModelConfig", "OptimizerConfig", "TaskConfig"])
def test_config_classes_have_the_same_fields_and_defaults(name):
    from vilbert_tpu.core import config as jax_config
    from vilbert_tpu_torch.core import config as port_config

    port_cls, jax_cls = getattr(port_config, name), getattr(jax_config, name)
    assert port_cls is not jax_cls
    assert _defaults(port_cls) == _defaults(jax_cls)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_model_configs_parse_alike(path):
    from vilbert_tpu.core.config import ModelConfig as JaxModelConfig
    from vilbert_tpu_torch.core.config import ModelConfig

    port = ModelConfig.from_json_file(str(path))
    assert dataclasses.asdict(port) == dataclasses.asdict(JaxModelConfig.from_json_file(str(path)))
    # derived properties and replace() agree too
    jax_cfg = JaxModelConfig.from_json_file(str(path), task_specific_tokens=True)
    port = ModelConfig.from_json_file(str(path), task_specific_tokens=True)
    assert dataclasses.asdict(port.replace(compute_dtype="float32")) == dataclasses.asdict(
        jax_cfg.replace(compute_dtype="float32"))


def test_task_configs_parse_alike():
    pytest.importorskip("yaml")
    from vilbert_tpu.core.config import load_task_configs as jax_load
    from vilbert_tpu_torch.core.config import load_task_configs

    path = str(REPO / "configs" / "tasks.yml")
    port, ref = load_task_configs(path), jax_load(path)
    assert list(port) == list(ref) and len(port) >= 12
    for key in ref:
        assert dataclasses.asdict(port[key]) == dataclasses.asdict(ref[key]), key


def test_optimizer_config_alike():
    from vilbert_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
    from vilbert_tpu_torch.core.config import OptimizerConfig

    kw = dict(learning_rate=1e-4, warmup_proportion=0.2, schedule="constant", beta2=0.98)
    assert dataclasses.asdict(OptimizerConfig(**kw)) == dataclasses.asdict(
        JaxOptimizerConfig(**kw))


# -- core/importer.py -----------------------------------------------------------

def test_importer_keys_over_the_port_state_dict(tiny_config):
    from vilbert_tpu.core import importer as jax_importer
    from vilbert_tpu_torch.core import importer
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining, ViLBERTForVLTasks

    names = set()
    for cls in (ViLBERTForVLTasks, ViLBERTForPretraining):
        names |= set(cls(tiny_config, generator=torch.Generator().manual_seed(0)).state_dict())
    # the reference names the importer skips or migrates
    names |= {"cls.predictions.decoder.weight", "bert.embeddings.LayerNorm.gamma",
              "module.bert.pooler.dense.weight", "bert.encoder.layer.0.biOutput.q_dense1.weight"}
    assert len(names) > 100
    for name in sorted(names):
        assert importer._to_flax_key(name) == jax_importer._to_flax_key(name), name
        assert importer._needs_transpose(name) == jax_importer._needs_transpose(name), name


def test_importer_state_dict_import_alike(tiny_config):
    from vilbert_tpu.core import importer as jax_importer
    from vilbert_tpu_torch.core import importer
    from vilbert_tpu_torch.core.weights import flax_from_state_dict
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks

    def model(seed):
        return ViLBERTForVLTasks(tiny_config, generator=torch.Generator().manual_seed(seed))

    target = flax_from_state_dict(model(0).state_dict())
    sd = {k: v.numpy() for k, v in model(1).state_dict().items()}
    # a reference checkpoint: gamma/beta names, the tied decoder, one key missing
    sd["bert.embeddings.LayerNorm.gamma"] = sd.pop("bert.embeddings.LayerNorm.weight")
    sd["cls.predictions.decoder.weight"] = np.zeros((3, 3), np.float32)
    del sd["bert.t_pooler.dense.bias"]
    port_params, port_report = importer.import_torch_state_dict(sd, target)
    jax_params, jax_report = jax_importer.import_torch_state_dict(sd, target)
    port_flat, jax_flat = importer._flatten(port_params), jax_importer._flatten(jax_params)
    assert port_flat.keys() == jax_flat.keys()
    for k in jax_flat:
        np.testing.assert_array_equal(port_flat[k], jax_flat[k], err_msg=k)
    assert tuple(port_report) == tuple(jax_report)


# -- data/ ------------------------------------------------------------------------

def test_hash_tokenizer_ids_alike():
    from vilbert_tpu.data.tokenization import HashTokenizer as JaxHashTokenizer
    from vilbert_tpu.data.tokenization import add_special_pair as jax_pair
    from vilbert_tpu_torch.data.tokenization import HashTokenizer, add_special_pair

    texts = ["what color is the couch?", "A Man riding a horse, on the beach.", "",
             "naïve café — 12 items / 3 rows", "the the the"]
    for vocab in (99, 30522):
        port, ref = HashTokenizer(vocab), JaxHashTokenizer(vocab)
        for text in texts:
            assert port.encode(text) == ref.encode(text), (vocab, text)
        assert len(port) == len(ref)
        assert (port.cls_token_id, port.sep_token_id, port.pad_token_id, port.mask_token_id) == (
            ref.cls_token_id, ref.sep_token_id, ref.pad_token_id, ref.mask_token_id)
        a, b = port.encode(texts[0]), port.encode(texts[1])
        assert add_special_pair(port, a, b) == jax_pair(ref, a, b)


def test_boxes_alike(rng_np):
    from vilbert_tpu.data import boxes as jax_boxes
    from vilbert_tpu_torch.data import boxes

    x1, y1 = rng_np.uniform(0, 50, (9,)), rng_np.uniform(0, 50, (9,))
    a = np.stack([x1, y1, x1 + rng_np.uniform(1, 60, 9), y1 + rng_np.uniform(1, 60, 9)], 1)
    np.testing.assert_array_equal(boxes.iou(a, a[:4]), jax_boxes.iou(a, a[:4]))
    np.testing.assert_array_equal(boxes.normalize_locations(a, 120, 90),
                                  jax_boxes.normalize_locations(a, 120, 90))


def test_feature_store_vrf_round_trip_alike(tmp_path):
    from vilbert_tpu.data import feature_store as jax_fs
    from vilbert_tpu_torch.data import feature_store as fs

    store = fs.InMemoryFeatureStore.synthetic(num_images=4, num_boxes=5, feature_dim=8,
                                              target_dim=3)
    ref_store = jax_fs.InMemoryFeatureStore.synthetic(num_images=4, num_boxes=5,
                                                      feature_dim=8, target_dim=3)
    assert store.keys() == ref_store.keys()
    path = str(tmp_path / "s.vfr")
    with fs.VrfWriter(path, feature_dim=8, target_dim=3) as w:
        for k in store.keys():
            w.add(k, store.get(k))
    port, ref = fs.VrfFeatureStore(path), jax_fs.VrfFeatureStore(path)
    for k in ref_store.keys():
        for x, y, z in ((port.get(k), ref.get(k), ref_store.get(k)),):
            for field in ("features", "boxes", "target"):
                np.testing.assert_array_equal(getattr(x, field), getattr(y, field))
                np.testing.assert_array_equal(getattr(x, field), getattr(z, field))
        for x, y in zip(fs.read_with_global(port.get(k)), jax_fs.read_with_global(ref.get(k))):
            np.testing.assert_array_equal(x, y)
    port.close()
    ref.close()


def test_lmdb_writer_and_reader_alike(tmp_path):
    from vilbert_tpu.data.lmdb_reader import LmdbReader as JaxLmdbReader
    from vilbert_tpu_torch.data.lmdb_reader import LmdbReader, LmdbWriter

    rng = np.random.RandomState(0)
    items = {f"key{i:04d}".encode(): rng.bytes(int(rng.randint(1, 9000))) for i in range(300)}
    path = str(tmp_path / "db")
    with LmdbWriter(path) as w:
        for k, v in items.items():
            w.put(k, v)
    port, ref = LmdbReader(path), JaxLmdbReader(path)
    assert list(port.items()) == list(ref.items()) == sorted(items.items())


def _vqa_world(pkg):
    """A synthetic VQA dataset and loader built from ``pkg``'s own modules."""
    import importlib

    syn = importlib.import_module(f"{pkg}.data.synthetic")
    tasks = importlib.import_module(f"{pkg}.data.tasks")
    tok = importlib.import_module(f"{pkg}.data.tokenization")
    store = syn.synthetic_store(num_images=16, num_boxes=12, feature_dim=32)
    ds = tasks.VQADataset(syn.vqa_annotations(num=20, num_labels=50), store, num_labels=50,
                          tokenizer=tok.HashTokenizer(99), max_seq_length=9,
                          max_region_num=13)
    return tasks.DataLoader(ds, batch_size=6, seed=3)


@pytest.mark.parametrize("epochs", [1, 2])
def test_vqa_loader_batches_alike(epochs):
    port, ref = _vqa_world("vilbert_tpu_torch"), _vqa_world("vilbert_tpu")
    n = 0
    for _ in range(epochs):
        for a, b in zip(port, ref, strict=True):
            _assert_batches_equal(a, b)
            n += 1
    assert n == epochs * len(ref) > 0


def test_pad_batch_alike():
    from vilbert_tpu.data.tasks import pad_batch as jax_pad
    from vilbert_tpu_torch.data.tasks import pad_batch

    batch = next(iter(_vqa_world("vilbert_tpu_torch")))
    got, want = pad_batch(batch, 10), jax_pad(batch, 10)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        _assert_batches_equal(got[0], want[0])
        assert got[1:] == want[1:]
    else:
        _assert_batches_equal(got, want)


def _cc_loader(pkg, num_workers=0):
    import importlib

    cc = importlib.import_module(f"{pkg}.data.concap")
    fs = importlib.import_module(f"{pkg}.data.feature_store")
    tok = importlib.import_module(f"{pkg}.data.tokenization")
    store = fs.InMemoryFeatureStore.synthetic(num_images=24, num_boxes=8, feature_dim=16,
                                              target_dim=7)
    captions = {k: f"a caption describing image {k} in words" for k in store.keys()}
    return cc.ConceptCapLoader(
        store, captions, tok.HashTokenizer(64), batch_size=8,
        cfg=cc.ConceptCapSampleConfig(seq_len=12, region_len=8, feature_dim=16, target_dim=7),
        seed=3, num_workers=num_workers)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_concap_loader_batches_alike(num_workers):
    port, ref = _cc_loader("vilbert_tpu_torch", num_workers), _cc_loader("vilbert_tpu")
    n = 0
    for _ in range(2):  # two epochs: the shuffle is keyed by epoch
        for a, b in zip(port, ref, strict=True):
            _assert_batches_equal(a, b)
            n += 1
    assert n == 2 * len(ref) > 0


@pytest.mark.parametrize("spec", ["", "-1", "0", "3", "bert.embeddings., vil_prediction",
                                  "not_a_number"])
def test_freeze_prefixes_alike(spec):
    from vilbert_tpu.cli.train_tasks import freeze_prefixes as jax_freeze
    from vilbert_tpu_torch.cli.train_tasks import freeze_prefixes

    assert freeze_prefixes(spec) == jax_freeze(spec)


def test_synthetic_world_alike():
    """The eval CLI's synthetic loaders for the tasks of tasks.yml (all but
    VisualDialog, whose synthetic world fails in the JAX package too: its
    dataset wants dialog annotations, and ``_synthetic_world`` hands it
    plain ones)."""
    pytest.importorskip("yaml")
    from vilbert_tpu.cli.train_tasks import _synthetic_world as jax_world
    from vilbert_tpu_torch.cli.train_tasks import _synthetic_world
    from vilbert_tpu_torch.core.config import load_task_configs

    tasks = {k: t for k, t in load_task_configs(str(REPO / "configs" / "tasks.yml")).items()
             if t.name != "VisualDialog"}
    assert len(tasks) >= 17
    port, ref = _synthetic_world(tasks, 99), jax_world(tasks, 99)
    assert list(port) == list(ref) == list(tasks)
    for key in tasks:
        a, b = next(iter(port[key])), next(iter(ref[key]))
        _assert_batches_equal(a, b)


def test_synthetic_pointing_uses_the_ports_region_offset():
    """``pointing_annotations`` takes ``MC_REGION_OFFSET`` from the port's
    own ``train/multitask.py``, with the JAX package's value."""
    from vilbert_tpu.data import synthetic as jax_syn
    from vilbert_tpu.train.multitask import MC_REGION_OFFSET as JAX_OFFSET
    from vilbert_tpu_torch.data import synthetic as syn
    from vilbert_tpu_torch.train.multitask import MC_REGION_OFFSET

    assert MC_REGION_OFFSET == JAX_OFFSET
    store = syn.synthetic_store(num_images=8, num_boxes=8, feature_dim=16)
    ref_store = jax_syn.synthetic_store(num_images=8, num_boxes=8, feature_dim=16)
    got = syn.pointing_annotations(store, num=6)
    want = jax_syn.pointing_annotations(ref_store, num=6)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(np.asarray(da[k], dtype=object),
                                          np.asarray(db[k], dtype=object), err_msg=k)


# -- train/controllers.py, HostLRScheduler -------------------------------------

def _code(path: Path) -> str:
    """A module's source without its docstring (the copy's names its origin)."""
    text = path.read_text()
    return text[text.index('"""', 3) + 3:]


def test_controllers_copy_is_the_original():
    assert _code(REPO / "vilbert_tpu_torch/train/controllers.py") == _code(
        REPO / "vilbert_tpu/train/controllers.py")


def test_host_lr_scheduler_copy_is_the_original():
    import inspect

    from vilbert_tpu.train import optim as jax_optim
    from vilbert_tpu_torch.train import optim

    assert inspect.getsource(optim.HostLRScheduler) == inspect.getsource(
        jax_optim.HostLRScheduler)
    assert optim.EPOCH_SCHEDULES == jax_optim.EPOCH_SCHEDULES
    assert optim.LR_REDUCE_EPOCHS == jax_optim.LR_REDUCE_EPOCHS
    assert optim.ALL_HEAD_MODULES == jax_optim.ALL_HEAD_MODULES
    assert optim.HEAD_MODULE_FOR_TYPE == jax_optim.HEAD_MODULE_FOR_TYPE


@pytest.mark.parametrize("name", ["tf_name_to_flax", "import_tf_weights", "_TF_SKIP"])
def test_tf_import_copy_is_the_original(name):
    """``core/tf_import.py`` keeps the JAX module's mapping and import
    verbatim (``tests/test_torch_tf_import.py`` runs them against it)."""
    import inspect

    from vilbert_tpu.core import tf_import as jax_tf
    from vilbert_tpu_torch.core import tf_import

    port, ref = getattr(tf_import, name), getattr(jax_tf, name)
    if callable(port):
        assert inspect.getsource(port) == inspect.getsource(ref)
    else:
        assert port.pattern == ref.pattern
    assert [(p.pattern, r) for p, r in tf_import._TF_REWRITES] == [
        (p.pattern, r) for p, r in jax_tf._TF_REWRITES]


def test_native_vfs_binding_is_the_originals():
    """``data/native_vfs.py`` binds the same C entry points with the same
    record layout and reader class as the JAX module; only the build
    (into ``build/``, raising on failure) differs."""
    import inspect

    from vilbert_tpu.data import native_vfs as jax_vfs
    from vilbert_tpu_torch.data import native_vfs

    def body(cls, name):  # the method's source, whitespace and line breaks aside
        return "".join(inspect.getsource(getattr(cls, name)).split())

    assert native_vfs._VfsRecord._fields_ == jax_vfs._VfsRecord._fields_
    for name in ("get", "prefetch", "keys", "close"):
        assert body(native_vfs.NativeVrfFeatureStore, name) == body(
            jax_vfs.NativeVrfFeatureStore, name), name


# -- chip_smoke.py's task configs -------------------------------------------------

def test_chip_smoke_task_configs_are_the_yml():
    """The twelve ``TaskConfig``s of the flagship recipe that chip_smoke.py
    builds in code equal ``load_task_configs("configs/tasks.yml")`` field by
    field, so that a change to the yml cannot leave the card run behind."""
    pytest.importorskip("yaml")
    import importlib.util

    from vilbert_tpu_torch.core.config import TaskConfig, load_task_configs

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.flagship_tasks()
    want = load_task_configs(str(REPO / "configs" / "tasks.yml"))
    assert list(got) == [f"TASK{n}" for n in (1, 2, 4, 7, 8, 9, 10, 11, 12, 13, 15, 17)]
    for key, cfg in got.items():
        assert type(cfg) is TaskConfig
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[key]), key
    assert smoke.task1() == want["TASK1"]


def test_chip_smoke_ln_shapes_are_each_paths_launches(monkeypatch):
    """chip_smoke.py's K4 shapes (phase 5 times each one; phases 4-8 hold
    the recorded launches to them) add up, path by path, to the launches
    its phases count: 63 a VQA forward, 64 a CC step, 750 a multi-task
    iteration; the heads' LayerNorms are among them at their batches."""
    import importlib.util

    from vilbert_tpu_torch.core.config import ModelConfig

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.chdir(REPO)
    shapes = smoke.ln_shapes()
    cfg = ModelConfig.from_json_file(smoke.CONFIG)
    total = {p: sum(row[p] for row in shapes.values()) for p in smoke.LN_PATHS}
    mt_cfg = cfg.replace(task_specific_tokens=True)
    assert total == {
        "vqa": smoke.kernel_calls_per_forward(cfg)[1],
        "cc": smoke.kernel_calls_per_step(cfg)["layer_norm"],
        "multitask": smoke.multitask_launches(smoke.flagship_tasks(), mt_cfg, 1, 0)["layer_norm"],
    } == {"vqa": 63, "cc": 64, "multitask": 750}
    heads = {key: row["label"] for key, row in shapes.items() if not key[3] and key[2] != "float32"
             and "embedding" not in row["label"]}
    assert heads == {(1024, 2048, "bfloat16", False): "VQA classifier",
                     (3072, 768, "bfloat16", False): "CC LM transform",
                     (128, 2048, "bfloat16", False): "TASK1,TASK2,TASK15 classifier",
                     (5248, 768, "bfloat16", False): "TASK12 LM transform",
                     (64, 2048, "bfloat16", False): "TASK12 classifier"}
    assert shapes[(9472, 1024, "bfloat16", False)]["cc"] == 2  # embedding + image transform


def test_chip_smoke_baseline_shapes_and_launches(monkeypatch):
    """chip_smoke.py's expectations of the single-stream baseline: K4 26
    launches a VQA forward (the two embeddings in fp32, two a layer with
    the residual), 28 a CC step (and the LM and image transforms), 26 a
    step of each task; K1 and K2 one a layer over T + R keys, K1 on "wg" at
    96 < T + R <= 128 and past 512 (GuessWhatPointing's 562), on "long_tc"
    at 131 and 220, K2 on "wg" (every task's T + R is past 64 at d = 64),
    over the nine flagship tasks the baseline has heads for."""
    import importlib.util

    from vilbert_tpu_torch.core.config import ModelConfig

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.chdir(REPO)
    shapes = smoke.baseline_ln_shapes()
    total = {p: sum(row[p] for row in shapes.values()) for p in smoke.BASELINE_LN_PATHS}
    assert total == {"baseline_vqa": 26, "baseline_cc": 28, "baseline_multitask": 9 * 26}
    assert shapes[(1024 * 124, 768, "bfloat16", True)]["baseline_vqa"] == 24
    assert shapes[(1024 * 101, 768, "float32", False)]["label"] == "baseline VQA"
    # Visual7w's 256 x 220 rows, retrieval's 128 x 4 pairs x 131, GuessWhatPointing's 64 x 562
    assert shapes[(256 * 220, 768, "bfloat16", True)]["label"] == "baseline TASK4"
    assert shapes[(512 * 131, 768, "bfloat16", True)]["baseline_multitask"] == 48
    assert shapes[(64 * 562, 768, "bfloat16", True)]["baseline_multitask"] == 24
    tasks = smoke.baseline_tasks()
    assert sorted(tasks, key=lambda k: int(k[4:])) == [
        "TASK1", "TASK2", "TASK4", "TASK7", "TASK8", "TASK9", "TASK10", "TASK11", "TASK17"]
    # every (model batch, T + R) of the tasks checked and timed, with the backward
    steps = {(a[5], a[4]) for a in smoke.baseline_attentions() if a[7] and a[6] == (0.0, 0.1)}
    assert {smoke.baseline_task_geometry(t) for t in tasks.values()} <= steps
    assert len({a[0] for a in smoke.baseline_attentions()}) == len(smoke.baseline_attentions())
    cfg = ModelConfig.from_json_file(smoke.BASELINE_CONFIG)
    want = smoke.baseline_multitask_launches(tasks, cfg, 1)
    # K1 on wg at TASK1, TASK2 (124, 127 keys), TASK9-11 (121) and TASK17
    # (562), on long_tc at TASK4 (220), TASK7 and TASK8 (131); K2 on wg at
    # every one (d 64)
    assert want == {"attention": 108, "attention_bwd": 108, "attention_wg": 72,
                    "attention_long_tc": 36, "attention_bwd_wg": 108}


def test_vcr_copy_matches(tmp_path):
    """``eval/vcr.py``: joint Q->AR accuracy and the submission CSV equal the
    original's on the same results (a question missing from QA->R, one
    missing from the targets, ties)."""
    from vilbert_tpu.eval import vcr as ref
    from vilbert_tpu_torch.eval import vcr as port

    assert port is not ref
    rng = np.random.RandomState(3)
    qa = [{"question_id": i, "answer": rng.rand(4).round(2).tolist()} for i in range(12)]
    qar = [{"question_id": i, "answer": rng.rand(4).round(2).tolist()} for i in range(11)]
    qa[5]["answer"] = [0.5, 0.5, 0.1, 0.1]
    qa_t = {i: int(rng.randint(4)) for i in range(13)}
    qar_t = {i: int(rng.randint(4)) for i in range(12) if i != 3}
    got = port.vcr_joint_accuracy(qa, qar, qa_t, qar_t)
    assert got == ref.vcr_joint_accuracy(qa, qar, qa_t, qar_t)
    assert got["num_samples"] == 11 and 0 < got["qa_accuracy"] < 1
    a = port.write_vcr_submission_csv(qa, qar, str(tmp_path / "port.csv"))
    b = ref.write_vcr_submission_csv(qa, qar, str(tmp_path / "ref.csv"))
    assert open(a).read() == open(b).read()
    (tmp_path / "r.json").write_text(__import__("json").dumps(qa))
    assert port.load_results(str(tmp_path / "r.json")) == ref.load_results(str(tmp_path / "r.json"))
