"""Per-task dataset pipelines (the reference's vilbert/datasets/*, ~5,700 LoC).

The port's own copy of ``vilbert_tpu/data/tasks.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

Design: one ``TaskDataset`` base handles the shared batch contract —
tokenize/truncate/pad text, region features with the prepended global row,
padding to max_region_num, co-attention mask — mirroring the 9-tuple consumed
by the reference trainer (task_utils.py:189-196):

  features [B,R,2048], spatials [B,R,5], image_mask [B,R], question [B,T],
  target, input_mask [B,T], segment_ids [B,T], co_attention_mask [B,R,T],
  question_id  (+ multiple_choice_ids for the -mc tasks)

Annotations come through a neutral ``Annotation`` record so the same dataset
classes run off reference artifacts (loader helpers) or synthetic fixtures.

Each concrete dataset cites the reference file it reimplements.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from vilbert_tpu_torch.data.boxes import iou
from vilbert_tpu_torch.data.feature_store import FeatureStore, read_with_global
from vilbert_tpu_torch.data.tokenization import (
    Tokenizer,
    add_special_pair,
    add_special_single,
)


@dataclass
class Annotation:
    """One task example in neutral form."""

    question_id: Any
    image_id: str
    text: str = ""
    text_b: str = ""                    # second sentence (VCR rationale etc.)
    options: Sequence[str] = ()         # candidate answers (ranking tasks)
    label: int = -1                     # integer class / option index
    labels: Sequence[int] = ()          # soft-label indices (VQA)
    scores: Sequence[float] = ()        # soft-label scores (VQA)
    ref_box: Optional[np.ndarray] = None   # [4] xyxy (grounding tasks)
    image_id_b: str = ""                # second image (NLVR2)
    mc_idx: Optional[np.ndarray] = None  # indices into region rows (mc tasks)


def _pad_text(
    ids: List[int], max_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ids = ids[:max_len]
    mask = [1] * len(ids) + [0] * (max_len - len(ids))
    seg = [0] * max_len
    ids = ids + [0] * (max_len - len(ids))
    return (
        np.asarray(ids, np.int32),
        np.asarray(mask, np.int32),
        np.asarray(seg, np.int32),
    )


class TaskDataset:
    """Base: feature reading + text encoding + padding (reference pattern of
    e.g. vqa_dataset.py:220-310)."""

    #: filled by subclasses
    task_type: str = "VL-classifier"
    process: str = "normal"

    def __init__(
        self,
        annotations: Sequence[Annotation],
        store: FeatureStore,
        tokenizer: Tokenizer,
        *,
        max_seq_length: int = 23,
        max_region_num: int = 101,
        num_labels: int = 0,
        store_gt: Optional[FeatureStore] = None,
        split: str = "train",
    ):
        self.annotations = list(annotations)
        self.store = store
        self.store_gt = store_gt
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.max_region_num = max_region_num
        self.num_labels = num_labels
        self.split = split
        #: digest -> original question id (submission files need the true
        #: string ids for GQA/VCR; the batch tensor carries an int64 digest)
        self.qid_map: Dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self.annotations)

    # -- shared pieces ------------------------------------------------------

    def _image_tensors(self, image_id: str, max_regions: Optional[int] = None):
        """features/spatials/mask padded to max_region_num, global row first
        (reference _image_features_reader contract + per-dataset padding)."""
        max_regions = max_regions or self.max_region_num
        out = read_with_global(self.store.get(image_id))
        n = min(out.num_boxes, max_regions)
        feats = np.zeros((max_regions, out.features.shape[1]), np.float32)
        spatials = np.zeros((max_regions, 5), np.float32)
        mask = np.zeros((max_regions,), np.int32)
        feats[:n] = out.features[:n]
        spatials[:n] = out.locations[:n]
        mask[:n] = 1
        return feats, spatials, mask, n

    def _mixed_image_tensors(
        self,
        image_id: str,
        max_regions: Optional[int] = None,
        det_block: Optional[int] = None,
    ):
        """Detector + GT boxes merged (reference refer/visual7w pattern,
        refer_expression_dataset.py:247-278). Returns also the pixel boxes of
        every kept row for IoU targets.

        With ``det_block`` the detector rows occupy exactly [0, det_block)
        (truncated or zero-padded) and GT rows start at ``det_block`` — the
        row layout the mc gather offset 101 assumes (the reference relies on
        its artifacts always holding 100 detector boxes + global row,
        visual7w_pointing_dataset.py:263-268)."""
        max_regions = max_regions or self.max_region_num
        det = read_with_global(self.store.get(image_id))
        n_det = min(det.num_boxes, det_block or max_regions, max_regions)
        gt_start = det_block if det_block is not None else n_det
        rows = [(0, n_det, det.features, det.locations, det.locations_ori)]
        n_total = n_det
        mask_rows = [(0, n_det)]
        if self.store_gt is not None and gt_start < max_regions:
            gt = read_with_global(self.store_gt.get(image_id))
            # skip the gt global row (reference keeps gt boxes 1..)
            g = min(gt.num_boxes - 1, max_regions - gt_start)
            if g > 0:
                rows.append(
                    (gt_start, g, gt.features[1:], gt.locations[1:],
                     gt.locations_ori[1:])
                )
                mask_rows.append((gt_start, g))
                n_total = gt_start + g
        feats = np.zeros((max_regions, rows[0][2].shape[1]), np.float32)
        spatials = np.zeros((max_regions, 5), np.float32)
        mask = np.zeros((max_regions,), np.int32)
        boxes = np.zeros((max_regions, 4), np.float32)
        for start, n, f, loc, loc_ori in rows:
            feats[start : start + n] = f[:n]
            spatials[start : start + n] = loc[:n]
            boxes[start : start + n] = loc_ori[:n, :4]
        for start, n in mask_rows:
            mask[start : start + n] = 1
        return feats, spatials, mask, boxes, n_total

    def _encode_single(self, text: str):
        ids = add_special_single(
            self.tokenizer,
            list(self.tokenizer.encode(text))[: self.max_seq_length - 2],
        )
        return _pad_text(ids, self.max_seq_length)

    def _encode_pair(self, a: str, b: str):
        ia = list(self.tokenizer.encode(a))
        ib = list(self.tokenizer.encode(b))
        # truncate the longer first (BERT convention)
        while len(ia) + len(ib) > self.max_seq_length - 3:
            (ia if len(ia) > len(ib) else ib).pop()
        ids = add_special_pair(self.tokenizer, ia, ib)
        ids, mask, seg = _pad_text(ids, self.max_seq_length)
        seg = seg.copy()
        seg[len(ia) + 2 : len(ia) + 2 + len(ib) + 1] = 1
        return ids, mask, seg

    def _base_item(self, ann: Annotation) -> Dict[str, np.ndarray]:
        feats, spatials, img_mask, _ = self._image_tensors(ann.image_id)
        q, q_mask, seg = self._encode_single(ann.text)
        return {
            "features": feats,
            "spatials": spatials,
            "image_mask": img_mask,
            "question": q,
            "input_mask": q_mask,
            "segment_ids": seg,
            "co_attention_mask": np.zeros(
                (self.max_region_num, self.max_seq_length), np.float32
            ),
            "question_id": np.asarray(self._qid_for(ann), np.int64),
        }

    def _qid_for(self, ann: Annotation) -> int:
        q = _qid(ann.question_id)
        if not isinstance(ann.question_id, (int, np.integer)):
            self.qid_map[q] = ann.question_id
        return q

    # -- subclass hook ------------------------------------------------------

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def _qid(qid: Any) -> int:
    if isinstance(qid, (int, np.integer)):
        return int(qid)
    # stable digest — NOT hash(): PYTHONHASHSEED randomizes str hashes per
    # process, which would make submission ids irreproducible across runs
    import hashlib

    digest = hashlib.md5(str(qid).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") % 2**62


class VQADataset(TaskDataset):
    """TASK1/TASK2/TASK15 soft-label VQA classification (reference
    vqa_dataset.py / visual_genome_dataset.py / gqa_dataset.py)."""

    task_type = "VL-classifier"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ann = self.annotations[idx]
        item = self._base_item(ann)
        target = np.zeros((self.num_labels,), np.float32)
        if len(ann.labels):
            target[np.asarray(ann.labels, np.int64)] = np.asarray(
                ann.scores, np.float32
            )
        item["target"] = target
        return item


class ClassificationDataset(TaskDataset):
    """Integer-class tasks: SNLI-VE (VL-tri, visual_entailment_dataset.py),
    GuessWhat (guesswhat_dataset.py), FOIL (foil_dataset.py)."""

    task_type = "VL-tri-classifier"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ann = self.annotations[idx]
        item = self._base_item(ann)
        item["target"] = np.asarray(ann.label, np.int64)
        return item


class ExpandDataset(TaskDataset):
    """Option-ranking with one image broadcast over N text options — VCR
    Q->A / QA->R (reference vcr_dataset.py, process "expand")."""

    task_type = "VL-logit"
    process = "expand"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ann = self.annotations[idx]
        feats, spatials, img_mask, _ = self._image_tensors(ann.image_id)
        qs, masks, segs = [], [], []
        for opt in ann.options:
            if ann.text_b:
                # QA->R style: question+answer as sentence A, option as B
                q, m, s = self._encode_pair(ann.text + " " + ann.text_b, opt)
            else:
                q, m, s = self._encode_pair(ann.text, opt)
            qs.append(q); masks.append(m); segs.append(s)
        return {
            "features": feats,
            "spatials": spatials,
            "image_mask": img_mask,
            "question": np.stack(qs),          # [N, T]
            "input_mask": np.stack(masks),
            "segment_ids": np.stack(segs),
            "target": np.asarray(ann.label, np.int64),
            "co_attention_mask": np.zeros(
                (self.max_region_num, self.max_seq_length), np.float32
            ),
            "question_id": np.asarray(self._qid_for(ann), np.int64),
        }


class RetrievalDataset(TaskDataset):
    """TASK7/8 image-text retrieval training (reference
    retreival_dataset.py:1-324): each item = 4 (caption, image) pairs —
    (true, hard/random caption negative, random image negative, hard
    negative from a 100-NN pool)."""

    task_type = "VL-logit"
    process = "retrieval"

    def __init__(self, *args, hard_negative_pool: Optional[Dict[str, List[str]]] = None,
                 seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.pool = hard_negative_pool or {}
        self.rng = np.random.default_rng(seed)
        self._by_image: Dict[str, List[int]] = {}
        for i, a in enumerate(self.annotations):
            self._by_image.setdefault(a.image_id, []).append(i)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ann = self.annotations[idx]
        # 1) true pair
        items = [(ann.text, ann.image_id)]
        # 2) random caption negative (other image's caption)
        j = int(self.rng.integers(0, len(self.annotations)))
        while self.annotations[j].image_id == ann.image_id:
            j = int(self.rng.integers(0, len(self.annotations)))
        items.append((self.annotations[j].text, ann.image_id))
        # 3) random image negative
        k = int(self.rng.integers(0, len(self.annotations)))
        while self.annotations[k].image_id == ann.image_id:
            k = int(self.rng.integers(0, len(self.annotations)))
        items.append((ann.text, self.annotations[k].image_id))
        # 4) hard negative image from the NN pool (random fallback)
        hard = self.pool.get(str(ann.image_id))
        if hard:
            items.append((ann.text, hard[int(self.rng.integers(0, len(hard)))]))
        else:
            m = int(self.rng.integers(0, len(self.annotations)))
            items.append((ann.text, self.annotations[m].image_id))

        feats, spats, masks, qs, qmasks, segs = [], [], [], [], [], []
        for text, image_id in items:
            f, s, im, _ = self._image_tensors(image_id)
            q, qm, sg = self._encode_single(text)
            feats.append(f); spats.append(s); masks.append(im)
            qs.append(q); qmasks.append(qm); segs.append(sg)
        return {
            "features": np.stack(feats),       # [4, R, D]
            "spatials": np.stack(spats),
            "image_mask": np.stack(masks),
            "question": np.stack(qs),
            "input_mask": np.stack(qmasks),
            "segment_ids": np.stack(segs),
            "target": np.asarray(0, np.int64),  # true pair is option 0
            "co_attention_mask": np.zeros(
                (4, self.max_region_num, self.max_seq_length), np.float32
            ),
            "question_id": np.asarray(self._qid_for(ann), np.int64),
        }


class GroundingDataset(TaskDataset):
    """V-logit grounding: refcoco family / Flickr (reference
    refer_expression_dataset.py, flickr_grounding_dataset.py). Target is the
    per-region IoU(region, ref box) >= 0.5 indicator."""

    task_type = "V-logit"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ann = self.annotations[idx]
        if self.store_gt is not None and self.split == "train":
            feats, spatials, img_mask, boxes, n = self._mixed_image_tensors(
                ann.image_id
            )
        else:
            feats, spatials, img_mask, n = self._image_tensors(ann.image_id)
            rf = self.store.get(ann.image_id)
            boxes = np.zeros((self.max_region_num, 4), np.float32)
            k = min(rf.boxes.shape[0], self.max_region_num - 1)
            boxes[1 : 1 + k] = rf.boxes[:k]
        q, q_mask, seg = self._encode_single(ann.text)
        target = np.zeros((self.max_region_num, 1), np.float32)
        if ann.ref_box is not None and n > 1:
            overlaps = iou(boxes[:n], ann.ref_box[None])
            target[:n, 0] = (overlaps[:, 0] >= 0.5).astype(np.float32)
            target[0] = 0  # global row is never the answer
        return {
            "features": feats,
            "spatials": spatials,
            "image_mask": img_mask,
            "question": q,
            "input_mask": q_mask,
            "segment_ids": seg,
            "target": target,
            "co_attention_mask": np.zeros(
                (self.max_region_num, self.max_seq_length), np.float32
            ),
            "question_id": np.asarray(self._qid_for(ann), np.int64),
        }


class PointingDataset(GroundingDataset):
    """V-logit-mc pointing: Visual7w / GuessWhatPointing (reference
    visual7w_pointing_dataset.py:232-303, guesswhat_pointing_dataset.py:
    247-306). Multiple-choice indices point into the GT rows appended behind
    the detector block (rows 101+); the target is gathered at those rows,
    matching the trainer's logit gather.

    ``num_options`` fixes the mc width: 4 for Visual7w (3 distractors +
    answer), 204 for GuessWhatPointing, padded with the last in-range row —
    the reference pads with the literal 204 = max_region_num-101-1
    (guesswhat_pointing_dataset.py:252-253), which lands on an all-zero
    padded row so the extra options contribute 0 loss."""

    task_type = "V-logit-mc"

    #: option rows start after the 100 detector boxes + global row
    #: (reference task_utils.py:353, visual7w_pointing_dataset.py:263-268)
    region_offset = 101

    def __init__(self, *args, num_options: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_options = num_options

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ann = self.annotations[idx]
        # GT option boxes always merged (both splits), detector block pinned
        # to rows [0, 101) so mc indices resolve identically to the reference
        feats, spatials, img_mask, boxes, n = self._mixed_image_tensors(
            ann.image_id, det_block=self.region_offset
        )
        q, q_mask, seg = self._encode_single(ann.text)
        full = np.zeros((self.max_region_num, 1), np.float32)
        if ann.ref_box is not None and n > 1:
            overlaps = iou(boxes[:n], ann.ref_box[None])
            full[:n, 0] = (overlaps[:, 0] >= 0.5).astype(np.float32)
            full[0] = 0  # global row is never the answer
        pad_row = self.max_region_num - self.region_offset - 1
        mc = np.full((self.num_options,), pad_row, np.int64)
        if ann.mc_idx is not None:
            k = min(len(ann.mc_idx), self.num_options)
            mc[:k] = np.asarray(ann.mc_idx[:k], np.int64)
        target = full[self.region_offset :, 0][mc][:, None]
        return {
            "features": feats,
            "spatials": spatials,
            "image_mask": img_mask,
            "question": q,
            "input_mask": q_mask,
            "segment_ids": seg,
            "target": target,
            "multiple_choice_ids": mc,
            "co_attention_mask": np.zeros(
                (self.max_region_num, self.max_seq_length), np.float32
            ),
            "question_id": np.asarray(self._qid_for(ann), np.int64),
        }


class NLVR2Dataset(TaskDataset):
    """TASK12: statement over an image pair (reference nlvr2_dataset.py:
    183-243): the two images' regions are concatenated into 2*max_region rows
    per sample; the trainer splits them into a 2B pseudo-batch."""

    task_type = "VL-binary-classifier"
    process = "nlvr"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ann = self.annotations[idx]
        half = self.max_region_num
        f1, s1, m1, _ = self._image_tensors(ann.image_id, half)
        f2, s2, m2, _ = self._image_tensors(ann.image_id_b, half)
        q, q_mask, seg = self._encode_single(ann.text)
        return {
            "features": np.concatenate([f1, f2]),      # [2R, D]
            "spatials": np.concatenate([s1, s2]),
            "image_mask": np.concatenate([m1, m2]),
            "question": q,
            "input_mask": q_mask,
            "segment_ids": seg,
            "target": np.asarray(ann.label, np.int64),
            "co_attention_mask": np.zeros(
                (2 * half, self.max_seq_length), np.float32
            ),
            "question_id": np.asarray(self._qid_for(ann), np.int64),
        }


@dataclass
class DialogAnnotation:
    """One VisDial game: caption + rounds of (question, answer options)."""

    question_id: Any
    image_id: str
    caption: str
    rounds: Sequence[Dict[str, Any]]  # {question, answer, gt_index, options}


class VisDialDataset(TaskDataset):
    """TASK3 Visual Dialog (reference visdial_dataset.py:176-297).

    Per image, 10 rounds × ``num_options``(=4) candidates. Candidate 0 is the
    round's GT answer ``options[gt_index]`` and the distractors are a random
    permutation of the other option indices (reference
    answer_candidate/:219-227 — it uses the global numpy RNG; here a seeded
    per-dataset RNG so epochs are reproducible). Targets are therefore
    zeros(10).

    Each candidate is encoded to ``total_seq_length``(=50, reference
    _total_seq_length) as
      [CLS] q [SEP](seg0)  a [SEP](seg1)  fact [SEP](seg0)
    where fact = (q_j [SEP] a_j) over the last ``max_history_rounds``(=3)
    rounds joined by [SEP], then [SEP] + caption — truncated from the FRONT
    to 50 - len(q) - len(a) - 4 (reference _truncate_seq pops index 0,
    :160-174, :229-262)."""

    task_type = "VL-logit"
    process = "dialog"

    def __init__(self, annotations: Sequence[DialogAnnotation], *args,
                 num_rounds: int = 10, num_options: int = 4,
                 max_history_rounds: int = 3, total_seq_length: int = 50,
                 seed: int = 0, **kwargs):
        # bypass TaskDataset's Annotation typing; same plumbing otherwise
        super().__init__([], *args, **kwargs)
        self.dialogs = list(annotations)
        self.num_rounds = num_rounds
        self.num_options = num_options
        self.max_history_rounds = max_history_rounds
        self.total_seq_length = total_seq_length
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.dialogs)

    def _encode_candidate(self, q_ids, a_ids, fact_ids):
        tok = self.tokenizer
        budget = self.total_seq_length - len(q_ids) - len(a_ids) - 4
        f_ids = list(fact_ids)
        while len(f_ids) > max(budget, 0):
            f_ids.pop(0)  # reference truncates the fact FRONT (:160-174)
        ids = (
            [tok.cls_token_id] + list(q_ids) + [tok.sep_token_id]
            + list(a_ids) + [tok.sep_token_id] + f_ids + [tok.sep_token_id]
        )
        seg = (
            [0] * (len(q_ids) + 2) + [1] * (len(a_ids) + 1)
            + [0] * (len(f_ids) + 1)
        )
        ids, mask, _ = _pad_text(ids, self.total_seq_length)
        seg = (seg + [0] * self.total_seq_length)[: self.total_seq_length]
        return ids, mask, np.asarray(seg, np.int32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        d = self.dialogs[idx]
        tok = self.tokenizer
        sep = tok.sep_token_id
        feats, spatials, img_mask, _ = self._image_tensors(d.image_id)
        T = self.total_seq_length
        qs = np.zeros((self.num_rounds, self.num_options, T), np.int32)
        masks = np.zeros_like(qs)
        segs = np.zeros_like(qs)
        cap_ids = list(tok.encode(d.caption))
        enc_q = [list(tok.encode(r["question"])) for r in d.rounds]
        enc_a = [list(tok.encode(r["answer"])) for r in d.rounds]
        for r in range(self.num_rounds):
            rnd = d.rounds[r % len(d.rounds)]
            # fact = last max_history_rounds (q [SEP] a) pairs, then caption
            # (reference :199-216)
            fact: List[int] = []
            for j in range(r % len(d.rounds)):
                if r % len(d.rounds) - self.max_history_rounds <= j:
                    pair = enc_q[j] + [sep] + enc_a[j]
                    fact = fact + [sep] + pair if fact else list(pair)
            tokens_f = fact + [sep] + cap_ids if fact else cap_ids
            # candidate 0 = GT option; distractors = random non-gt indices
            gt = int(rnd.get("gt_index", 0))
            options = rnd["options"]
            cands = [gt]
            for c in self.rng.permutation(len(options)):
                if len(cands) >= self.num_options:
                    break
                if int(c) != gt:
                    cands.append(int(c))
            while len(cands) < self.num_options:  # tiny fixtures
                cands.append(gt)
            q_ids = enc_q[r % len(d.rounds)]
            for i, ci in enumerate(cands):
                a_ids = list(tok.encode(options[ci]))
                qs[r, i], masks[r, i], segs[r, i] = self._encode_candidate(
                    q_ids, a_ids, tokens_f
                )
        return {
            "features": feats,
            "spatials": spatials,
            "image_mask": img_mask,
            "question": qs,                       # [rounds, options, T]
            "input_mask": masks,
            "segment_ids": segs,
            "target": np.zeros((self.num_rounds,), np.int64),
            "co_attention_mask": np.zeros(
                (self.max_region_num, T), np.float32
            ),
            "question_id": np.asarray(_qid(d.question_id), np.int64),
        }


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def pad_batch(
    batch: Dict[str, np.ndarray], to_size: int
) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad every leaf's batch dim to ``to_size`` by repeating the last sample.

    Keeps eval shapes static (one XLA compile per task instead of one per
    ragged final-batch size); callers slice metrics back to the returned
    valid count. Repeating a real sample (instead of zeros) keeps the padded
    forward numerically safe."""
    n = int(next(iter(batch.values())).shape[0])
    if n >= to_size:
        return batch, n

    def pad(x):
        x = np.asarray(x)
        reps = np.repeat(x[-1:], to_size - n, axis=0)
        return np.concatenate([x, reps], axis=0)

    return {k: pad(v) for k, v in batch.items()}, n


class DataLoader:
    """Minimal deterministic batch loader over a TaskDataset."""

    def __init__(self, dataset: TaskDataset, batch_size: int, *, shuffle=True,
                 seed=0, drop_last=True, shard_id=0, num_shards=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0

    def __len__(self):
        n = (len(self.dataset) + self.num_shards - 1) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        order = order[self.shard_id :: self.num_shards]
        buf = []
        for i in order:
            buf.append(self.dataset[int(i)])
            if len(buf) == self.batch_size:
                yield collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield collate(buf)
        self.epoch += 1


#: name -> dataset class registry (reference DatasetMapTrain/Eval,
#: vilbert/datasets/__init__.py:52-93)
DATASET_REGISTRY: Dict[str, type] = {
    "VisualDialog": VisDialDataset,
    "VQA": VQADataset,
    "GenomeQA": VQADataset,
    "GQA": VQADataset,
    "VisualEntailment": ClassificationDataset,
    "GuessWhat": ClassificationDataset,
    "Foil": ClassificationDataset,
    "VCR_Q-A": ExpandDataset,
    "VCR_QA-R": ExpandDataset,
    "RetrievalCOCO": RetrievalDataset,
    "RetrievalFlickr30k": RetrievalDataset,
    "refcoco": GroundingDataset,
    "refcoco+": GroundingDataset,
    "refcocog": GroundingDataset,
    "FlickrGrounding": GroundingDataset,
    "Visual7w": PointingDataset,
    "GuessWhatPointing": PointingDataset,
    "NLVR2": NLVR2Dataset,
}
