"""Annotation-file loaders for the reference dataset artifacts.

The port's own copy of ``vilbert_tpu/data/annotations.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

Each loader parses the SAME files the reference datasets consume and returns
neutral ``Annotation`` records for vilbert_tpu_torch.data.tasks. Formats cited
per function. All loaders are pure functions of file paths (no LMDB access
here).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from vilbert_tpu_torch.data.tasks import Annotation


def _jsonlines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_clean_ids(dataroot: str, which: str) -> List[int]:
    """Test-set image ids to drop from training ("clean_datasets" in the
    reference: cache/{coco|flickr}_test_ids.npy, e.g.
    visual_entailment_dataset.py:47-52, retreival_dataset.py:35-43).
    Returns [] when the cache file is absent."""
    path = os.path.join(dataroot, "cache", f"{which}_test_ids.npy")
    if not os.path.exists(path):
        return []
    return [int(x) for x in np.load(path)]


def filter_clean(
    annotations: List[Annotation], remove_ids: Sequence[int]
) -> List[Annotation]:
    """Drop training annotations whose image appears in a test pool."""
    if not remove_ids:
        return annotations
    remove = {str(int(i)) for i in remove_ids}
    return [a for a in annotations if a.image_id not in remove]


def load_vqa(
    dataroot: str, split: str = "train"
) -> List[Annotation]:
    """VQA v2: questions json {"questions":[{question_id,image_id,question}]}
    + cached soft targets cache/<split>_target.pkl with
    {question_id,image_id,labels,scores} (reference vqa_dataset.py:37-157)."""
    name = {"train": "train2014", "val": "val2014", "test": "test2015"}.get(
        split, split
    )
    qpath = os.path.join(
        dataroot, f"v2_OpenEnded_mscoco_{name}_questions.json"
    )
    questions = sorted(
        json.load(open(qpath))["questions"], key=lambda x: x["question_id"]
    )
    out = []
    target_path = os.path.join(dataroot, "cache", f"{split}_target.pkl")
    if os.path.exists(target_path):
        answers = sorted(
            pickle.load(open(target_path, "rb")), key=lambda x: x["question_id"]
        )
        for q, a in zip(questions, answers):
            assert q["question_id"] == a["question_id"]
            out.append(
                Annotation(
                    question_id=q["question_id"],
                    image_id=str(q["image_id"]),
                    text=q["question"],
                    labels=a["labels"],
                    scores=a["scores"],
                )
            )
    else:  # test split: no targets
        for q in questions:
            out.append(
                Annotation(
                    question_id=q["question_id"],
                    image_id=str(q["image_id"]),
                    text=q["question"],
                )
            )
    return out


def load_label2ans(dataroot: str, prefix: str = "trainval") -> List[str]:
    """cache/<prefix>_label2ans.pkl (answer vocabulary)."""
    return pickle.load(
        open(os.path.join(dataroot, "cache", f"{prefix}_label2ans.pkl"), "rb")
    )


def load_gqa(dataroot: str, split: str = "train") -> List[Annotation]:
    """GQA balanced questions json {qid: {imageId, question, answer}}
    (reference gqa_dataset.py)."""
    path = os.path.join(dataroot, f"{split}_balanced_questions.json")
    data = json.load(open(path))
    ans2label_path = os.path.join(dataroot, "cache", "trainval_ans2label.pkl")
    ans2label = (
        pickle.load(open(ans2label_path, "rb"))
        if os.path.exists(ans2label_path)
        else {}
    )
    out = []
    for qid, item in data.items():
        labels, scores = [], []
        ans = item.get("answer")
        if ans is not None and ans in ans2label:
            labels, scores = [ans2label[ans]], [1.0]
        out.append(
            Annotation(
                question_id=qid,
                image_id=str(item["imageId"]),
                text=item["question"],
                labels=labels,
                scores=scores,
            )
        )
    return out


def load_nlvr2(dataroot: str, split: str = "train") -> List[Annotation]:
    """NLVR2 jsonl {identifier, sentence, label}; image ids derived as
    <identifier-prefix>-img0/-img1 (reference nlvr2_dataset.py:36-69)."""
    out = []
    for i, ann in enumerate(_jsonlines(os.path.join(dataroot, f"{split}.json"))):
        prefix = "-".join(ann["identifier"].split("-")[:-1])
        out.append(
            Annotation(
                question_id=i,
                image_id=prefix + "-img0",
                image_id_b=prefix + "-img1",
                text=str(ann["sentence"]),
                label=0 if str(ann["label"]) == "False" else 1,
            )
        )
    return out


_SNLI_LABELS = {"contradiction": 0, "neutral": 1, "entailment": 2}


def load_snli_ve(dataroot: str, split: str = "train") -> List[Annotation]:
    """SNLI-VE jsonl {Flikr30kID, sentence2, gold_label} (reference
    visual_entailment_dataset.py:40-75); '-' gold labels are skipped."""
    out = []
    path = os.path.join(dataroot, f"snli_ve_{split}.jsonl")
    for i, ann in enumerate(_jsonlines(path)):
        gold = str(ann["gold_label"])
        if gold == "-":
            continue
        out.append(
            Annotation(
                question_id=i,
                image_id=str(int(ann["Flikr30kID"].split(".")[0])),
                text=str(ann["sentence2"]),
                label=_SNLI_LABELS[gold],
            )
        )
    return out


def load_retrieval(
    annotations_jsonpath: str, task: str = "RetrievalCOCO"
) -> List[Annotation]:
    """Retrieval jsonlines: COCO {id, sentences:[...]}; Flickr30k
    {img_path, sentences:[...]} (reference retreival_dataset.py:25-60)."""
    out = []
    count = 0
    for ann in _jsonlines(annotations_jsonpath):
        if task == "RetrievalCOCO":
            image_id = ann["id"]
        else:
            image_id = int(ann["img_path"].split(".")[0])
        for sent in ann["sentences"]:
            out.append(
                Annotation(question_id=count, image_id=str(image_id), text=sent)
            )
            count += 1
    return out


def load_refer(
    dataroot: str, dataset: str = "refcoco+", split: str = "train",
    split_by: str = "unc",
) -> List[Annotation]:
    """RefCOCO family via the REFER pickle layout (tools/refer submodule:
    refs(<split_by>).p — list of {ref_id, ann_id, image_id, split,
    sentences:[{sent}]} — plus instances.json for the referred box;
    reference refer_expression_dataset.py:62-110)."""
    refs_path = os.path.join(dataroot, dataset, f"refs({split_by}).p")
    refs = pickle.load(open(refs_path, "rb"))
    inst_path = os.path.join(dataroot, dataset, "instances.json")
    instances = json.load(open(inst_path))
    ann_by_id = {a["id"]: a for a in instances["annotations"]}
    out = []
    for ref in refs:
        if ref["split"] != split:
            continue
        ann = ann_by_id.get(ref["ann_id"])
        if ann is None:
            continue
        x, y, w, h = ann["bbox"]
        box = np.array([x, y, x + w, y + h], np.float32)
        for sent in ref["sentences"]:
            out.append(
                Annotation(
                    question_id=ref["ref_id"],
                    image_id=str(ref["image_id"]),
                    text=sent["sent"],
                    ref_box=box,
                )
            )
    return out


def load_vcr(
    annotations_jsonpath: str, mode: str = "QA"
) -> List[Annotation]:
    """VCR jsonl {objects, question, answer_choices, answer_label,
    rationale_choices, rationale_label, metadata_fn} (reference
    vcr_dataset.py:118-200). Person tags like [0] are replaced with neutral
    names per object index (the reference samples random unisex names,
    vcr_dataset.py:161-166 — we use a fixed cycle for determinism).

    mode "QA": question -> answer options; "QAR": question+right answer ->
    rationale options.
    """
    names = ["Casey", "Riley", "Jessie", "Jackie", "Avery", "Jaime", "Peyton",
             "Kerry", "Jody", "Kendall"]

    def detokenize(tokens, objects):
        words = []
        for tok in tokens:
            if isinstance(tok, list):
                for j, idx in enumerate(tok):
                    if objects[idx] == "person":
                        words.append(names[idx % len(names)])
                    else:
                        words.append(objects[idx])
                    if j < len(tok) - 1:
                        words.append("and")
            else:
                words.append(str(tok))
        return " ".join(words)

    out = []
    for i, ann in enumerate(_jsonlines(annotations_jsonpath)):
        objects = ann["objects"]
        q = detokenize(ann["question"], objects)
        answers = [detokenize(a, objects) for a in ann["answer_choices"]]
        img_id = os.path.splitext(os.path.basename(ann["metadata_fn"]))[0]
        if mode == "QA":
            out.append(
                Annotation(
                    question_id=i, image_id=img_id, text=q, options=answers,
                    label=int(ann.get("answer_label", -1)),
                )
            )
        else:
            right = answers[int(ann["answer_label"])]
            rationales = [detokenize(r, objects) for r in ann["rationale_choices"]]
            out.append(
                Annotation(
                    question_id=i, image_id=img_id, text=q, text_b=right,
                    options=rationales,
                    label=int(ann.get("rationale_label", -1)),
                )
            )
    return out


def load_visual7w_pointing(
    dataroot: str, split: str = "train", clean_datasets: bool = True
) -> List[Annotation]:
    """Visual7w pointing json dataset_v7w_pointing.json: images with qa_pairs
    {question, answer (box id), multiple_choices (box ids)} + boxes
    (reference visual7w_pointing_dataset.py:128-183).

    mc_idx: per image, the GT feature store's rows follow the SORTED set of
    every box id mentioned by that image's qa_pairs; each qa's 4 options
    (sorted multiple_choices + answer) become indices into that order —
    resolved by PointingDataset to mixed rows 101+idx
    (visual7w_pointing_dataset.py:159-176, :263-268).

    Feature-store keys carry the reference's "v7w_" prefix
    (visual7w_pointing_dataset.py:240-242). Train drops genome test-pool
    images; "mteval" keeps ONLY them (reference :131-138,:155-159).
    """
    remove_ids: set = set()
    if clean_datasets or split == "mteval":
        path = os.path.join(dataroot, "cache", "genome_test_ids.npy")
        if os.path.exists(path):
            remove_ids = {int(x) for x in np.load(path)}
    data = json.load(
        open(os.path.join(dataroot, "dataset_v7w_pointing.json"))
    )
    boxes_by_id = {
        b["box_id"]: [b["x"], b["y"], b["x"] + b["width"], b["y"] + b["height"]]
        for b in data.get("boxes", [])
    }
    eff_split = "train" if split == "mteval" else split
    out = []
    for image in data["images"]:
        if image["split"] != eff_split:
            continue
        img_id = int(image["image_id"])
        if split == "train" and img_id in remove_ids:
            continue
        if split == "mteval" and img_id not in remove_ids:
            continue
        bboxes: List[int] = []
        for qa in image["qa_pairs"]:
            bboxes.extend(qa["multiple_choices"])
            bboxes.append(qa["answer"])
        bboxes = sorted(set(bboxes))
        for qa in image["qa_pairs"]:
            mc_idx = [
                bboxes.index(a)
                for a in sorted(qa["multiple_choices"] + [qa["answer"]])
            ]
            out.append(
                Annotation(
                    question_id=qa["qa_id"],
                    image_id=f"v7w_{img_id}",
                    text=qa["question"],
                    ref_box=np.asarray(boxes_by_id[qa["answer"]], np.float32),
                    mc_idx=np.asarray(mc_idx, np.int64),
                )
            )
    return out


def load_guesswhat_pointing(
    dataroot: str, split: str = "train", clean_datasets: bool = True
) -> List[Annotation]:
    """TASK17 GuessWhat?! pointing (reference
    guesswhat_pointing_dataset.py:133-202).

    Inputs: guesswhat.{split}.jsonl games plus two caches built with the
    GT-box feature extraction: cache/image_bbox_list.pkl
    (image_id -> {"bboxes": [object ids]}, defining the GT store's row
    order as the sorted unique ids) and cache/bboxes_dict.pkl
    (object id -> [x1,y1,x2,y2]).

    Text is the whole dialogue flattened "start {q} answer {a} stop ..."
    (:212-215); mc_idx holds the game's (sorted) object ids resolved into
    the per-image GT row order — PointingDataset pads them to num_options
    with the out-of-range row the reference uses (:252-253: mc + [204]*204).
    Train drops coco test-pool images; "mteval" keeps only them.
    """
    remove_ids: set = set()
    if clean_datasets or split == "mteval":
        path = os.path.join(dataroot, "cache", "coco_test_ids.npy")
        if os.path.exists(path):
            remove_ids = {int(x) for x in np.load(path)}
    with open(os.path.join(dataroot, "cache", "image_bbox_list.pkl"), "rb") as f:
        all_images = pickle.load(f)
    with open(os.path.join(dataroot, "cache", "bboxes_dict.pkl"), "rb") as f:
        boxes_dict = pickle.load(f)
    eff_split = "train" if split == "mteval" else split
    path = os.path.join(dataroot, f"guesswhat.{eff_split}.jsonl")
    out = []
    for game in _jsonlines(path):
        img_id = int(game["image"]["id"])
        if split == "train" and img_id in remove_ids:
            continue
        if split == "mteval" and img_id not in remove_ids:
            continue
        text = "".join(
            f"start {qa['question']} answer {qa['answer']} stop "
            for qa in game["qas"]
        )
        total_bboxes = sorted(set(all_images[game["image"]["id"]]["bboxes"]))
        mc_idx = [
            total_bboxes.index(o["id"]) for o in sorted(
                game["objects"], key=lambda o: o["id"]
            )
        ]
        out.append(
            Annotation(
                question_id=game["id"],
                image_id=str(img_id),
                text=text,
                ref_box=np.asarray(boxes_dict[game["object_id"]], np.float32),
                mc_idx=np.asarray(mc_idx, np.int64),
            )
        )
    return out


def _flickr_sentences(path: str) -> List[Dict]:
    """Parse a Flickr30k Entities sentence file: phrases are bracketed
    "[/EN#id/type words...]" spans (reference
    flickr_grounding_dataset.py:63-132)."""
    out = []
    with open(path) as f:
        for sentence in f.read().split("\n"):
            if not sentence:
                continue
            phrases, current, pid = [], [], []
            in_phrase = False
            for token in sentence.split():
                if in_phrase:
                    if token.endswith("]"):
                        in_phrase = False
                        current.append(token[:-1])
                        phrases.append(" ".join(current))
                        current = []
                    else:
                        current.append(token)
                elif token.startswith("["):
                    in_phrase = True
                    pid.append(token.split("/")[1][3:])  # EN#<id>
            out.append(
                {"phrases": [
                    {"phrase": ph, "phrase_id": i}
                    for ph, i in zip(phrases, pid)
                ]}
            )
    return out


def _flickr_boxes(path: str) -> Dict[str, List[List[int]]]:
    """Parse a Flickr30k Entities annotation xml: object/name holds the
    phrase id, bndbox the (1-based) corners (reference
    flickr_grounding_dataset.py:135-179)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    boxes: Dict[str, List[List[int]]] = {}
    for obj in root.findall("object"):
        for names in obj.findall("name"):
            box_id = names.text
            bnd = obj.findall("bndbox")
            if bnd:
                coords = [
                    int(bnd[0].findall(t)[0].text) - 1
                    for t in ("xmin", "ymin", "xmax", "ymax")
                ]
                boxes.setdefault(box_id, []).append(coords)
    return boxes


def load_flickr_grounding(
    dataroot: str, split: str = "train", clean_datasets: bool = True
) -> List[Annotation]:
    """TASK18 Flickr30k Entities grounding (reference
    flickr_grounding_dataset.py:253-299): {split}.txt lists image ids;
    Sentences/{img}.txt + Annotations/{img}.xml give per-phrase boxes. Every
    phrase with at least one box becomes a V-logit example (first box is the
    target, :287-296)."""
    remove_ids: set = set()
    if clean_datasets:
        path = os.path.join(dataroot, "cache", "flickr_test_ids.npy")
        if os.path.exists(path):
            remove_ids = {int(x) for x in np.load(path)}
    with open(os.path.join(dataroot, f"{split}.txt")) as f:
        images = f.read().splitlines()
    out = []
    for img in images:
        if not img:
            continue
        if split == "train" and int(img) in remove_ids:
            continue
        boxes = _flickr_boxes(
            os.path.join(dataroot, "Annotations", f"{img}.xml")
        )
        sentences = _flickr_sentences(
            os.path.join(dataroot, "Sentences", f"{img}.txt")
        )
        for sent in sentences:
            for phrase in sent["phrases"]:
                pid = str(phrase["phrase_id"])
                if pid in boxes:
                    out.append(
                        Annotation(
                            question_id=int(pid),
                            image_id=str(int(img)),
                            text=phrase["phrase"],
                            ref_box=np.asarray(boxes[pid][0], np.float32),
                        )
                    )
    return out


def load_guesswhat(
    annotations_jsonpath: str
) -> List[Annotation]:
    """GuessWhat?! jsonl {id, image:{id}, qas:[{question, answer}], status}
    → per-QA-pair yes/no/na 3-class (reference guesswhat_dataset.py:38-76)."""
    label_map = {"yes": 0, "no": 1, "n/a": 2}
    out = []
    count = 0
    for game in _jsonlines(annotations_jsonpath):
        for qa in game["qas"]:
            out.append(
                Annotation(
                    question_id=count,
                    image_id=str(game["image"]["id"]),
                    text=qa["question"],
                    label=label_map[qa["answer"].lower()],
                )
            )
            count += 1
    return out


def load_visdial(annotations_jsonpath: str, num_options: int = 100):
    """VisDial v1.0 json: {data: {dialogs, questions, answers}} with dialogs
    holding index-coded rounds (reference visdial_dataset.py:100-160).
    Returns DialogAnnotation records for data.tasks.VisDialDataset."""
    from vilbert_tpu_torch.data.tasks import DialogAnnotation

    data = json.load(open(annotations_jsonpath))["data"]
    questions = data["questions"]
    answers = data["answers"]
    out = []
    for i, d in enumerate(data["dialogs"]):
        rounds = []
        for rnd in d["dialog"]:
            opts_idx = rnd.get("answer_options", [])[:num_options]
            rounds.append(
                {
                    "question": questions[rnd["question"]],
                    "answer": answers[rnd["answer"]],
                    # index of the GT answer within options (reference uses
                    # answer_options[gt_index] as candidate 0, :219-227)
                    "gt_index": int(rnd.get("gt_index", 0)),
                    "options": [answers[j] for j in opts_idx],
                }
            )
        out.append(
            DialogAnnotation(
                question_id=i,
                image_id=str(d["image_id"]),
                caption=d.get("caption", ""),
                rounds=rounds,
            )
        )
    return out


def load_foil(annotations_jsonpath: str) -> List[Annotation]:
    """FOIL coco-captions-style json {annotations:[{id, image_id, caption,
    foil}]} → binary real/foil (reference foil_dataset.py)."""
    data = json.load(open(annotations_jsonpath))
    out = []
    for ann in data["annotations"]:
        out.append(
            Annotation(
                question_id=ann["id"],
                image_id=str(ann["image_id"]),
                text=ann["caption"],
                label=int(bool(ann.get("foil", False))),
            )
        )
    return out
