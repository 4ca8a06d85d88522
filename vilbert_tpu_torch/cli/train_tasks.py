"""The multi-task trainer's CLI helpers that other parts of the port use.

Counterpart of ``vilbert_tpu/cli/train_tasks.py``: so far only
``freeze_prefixes`` (``--freeze`` expanded into parameter-path prefixes,
used by ``cli/train_concap.py``) and ``_synthetic_world`` (synthetic
loaders for every task family, used by ``cli/eval_tasks.py``), copied as
they stand. The multi-task trainer itself comes with its slice.
"""

from __future__ import annotations


def freeze_prefixes(spec: str):
    """Expand --freeze into param-path prefixes.

    An integer N reproduces the reference (train_tasks.py:381-393: freeze
    the params named in the bert weight manifest whose layer number ≤ N —
    i.e. the TEXT embeddings and text encoder layers 0..N; -1 = none).
    Otherwise: comma-separated literal path prefixes.
    """
    spec = spec.strip()
    if not spec:
        return ()
    try:
        n = int(spec)
    except ValueError:
        return tuple(s.strip() for s in spec.split(",") if s.strip())
    if n < 0:
        return ()
    # both family spellings: two-stream vilbert nests text layers under
    # bert.encoder.layer_N, the single-stream baseline under bert.layer_N
    # (prefixes that match nothing are inert)
    return ("bert.embeddings.",) + tuple(
        f"bert.encoder.layer_{i}." for i in range(n + 1)
    ) + tuple(
        f"bert.layer_{i}." for i in range(n + 1)
    )


def _synthetic_world(task_cfgs, tokenizer_vocab):
    """Synthetic loaders for the selected tasks (tests/dev machines)."""
    from vilbert_tpu_torch.data import synthetic as syn
    from vilbert_tpu_torch.data.tasks import DATASET_REGISTRY, DataLoader
    from vilbert_tpu_torch.data.tokenization import HashTokenizer

    tok = HashTokenizer(tokenizer_vocab)
    store = syn.synthetic_store(num_images=16, num_boxes=8, feature_dim=2048)
    loaders = {}
    for key, t in task_cfgs.items():
        mk = dict(tokenizer=tok, max_seq_length=t.max_seq_length,
                  max_region_num=min(t.max_region_num, 20))
        cls = DATASET_REGISTRY[t.name]
        if t.type in ("VL-classifier", "VL-classifier-GQA"):
            ds = cls(syn.vqa_annotations(num=16, num_labels=3129), store,
                     num_labels=3129, **mk)
        elif t.type == "VL-logit" and t.process == "expand":
            ds = cls(syn.expand_annotations(num=8), store, **mk)
        elif t.type == "VL-logit":
            ds = cls(syn.retrieval_annotations(num=8), store, **mk)
        elif t.type == "V-logit":
            ds = cls(syn.grounding_annotations(store, num=16), store, **mk)
        elif t.type == "V-logit-mc":
            mk["max_region_num"] = 108
            ds = cls(syn.pointing_annotations(store, num=8), store, **mk)
        elif t.type == "VL-binary-classifier" and t.process == "nlvr":
            ds = cls(syn.nlvr2_annotations(num=8), store, **mk)
        else:
            ds = DATASET_REGISTRY["VisualEntailment"](
                syn.classification_annotations(num=16), store, **mk
            )
        loaders[key] = DataLoader(ds, batch_size=min(t.batch_size, 4), seed=0)
    return loaders
