"""Cells at a tiny width for the CPU tests: the cells of BENCHMARK.json with
their sizes and traffic cut down, the generators and the limits kept."""

from __future__ import annotations

import copy

from harness import spec

TINY_SIZES = dict(
    vocab_size=101, hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
    intermediate_size=48, max_position_embeddings=64, v_feature_size=24, v_target_size=12,
    v_hidden_size=32, v_num_hidden_layers=2, v_num_attention_heads=2, v_intermediate_size=40,
    bi_hidden_size=32, bi_num_attention_heads=2, v_biattention_id=[0, 1],
    t_biattention_id=[1, 2],
)

TINY_TRAFFIC = {
    "pretrain": dict(batch_size=4, seq_len=8, regions=5, text_len=[3, 8], lm_gather=3,
                     log_every=2, trace_units=2),
    "task_eval": dict(num_labels=17, distinct=2, text_len=[3, 7], boxes=[2, 5],
                      reference_block=3, trace_units=2),
    "multitask": dict(trace_units=12),
}
TINY_TASK = dict(max_seq_length=7, max_region_num=6, eval_batch_size=5)
#: the multi-task mix's tasks at 3 rows, 5 tokens and 6 regions (104 for the
#: multiple-choice tasks, whose options lie past the 101-row detector block)
TINY_MULTITASK = dict(num_labels=17, loader_batches=4, reference_rows=4)


def tiny_cell(name: str, compute_dtype: str = "float32") -> spec.Cell:
    cell = copy.deepcopy(spec.cell(name))
    cell.config.update(TINY_SIZES, compute_dtype=compute_dtype)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    if "task" in cell.traffic:
        cell.traffic["task"].update(TINY_TASK)
    if cell.traffic["kind"] == "multitask":
        cell.traffic.update(TINY_MULTITASK)
        for task in cell.traffic["tasks"].values():
            mc = task["type"] == "V-logit-mc"
            task.update(batch_size=3, max_seq_length=5, max_region_num=104 if mc else 6)
            if task["type"] == "VL-classifier":
                task["num_labels"] = TINY_MULTITASK["num_labels"]
            if mc:
                task["options"] = 3
    return cell
