"""The yardstick's counts against hand counts and against counted products."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from harness import cell as run_cell
from harness import trace, yardstick
from reference.model import PRETRAINING, Config, ViLBERTForVLTasks
from reference.train import first_masked


def test_attention_cost_by_hand():
    # B=1, h=1, d=2, Sq=3, Sk=4, bf16: q 12 B, k and v 16 B each, bias 16 B, out 12 B
    cost = yardstick.attention_cost(1, 1, 2, 3, 4)
    assert cost["fwd"] == (12 + 16 + 16 + 16 + 12, 4.0 * 24)
    # K2: q, k, v, g, bias in (12 + 16 + 16 + 12 + 16), dq, dk, dv out (12 + 16 + 16)
    assert cost["bwd"] == (12 + 16 + 16 + 12 + 16 + 12 + 16 + 16, 10.0 * 24)


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0.0, 989e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_matmul_and_attention_flops_by_hand():
    sites = [yardstick.matmul("a", 2, 3, 4, count=5),
             yardstick.attention("b", 2, 3, 4, 5, 6, count=7),
             yardstick.layernorm("c", 8, 9)]
    fwd = 2 * 2 * 3 * 4 * 5 + 4 * 2 * 3 * 4 * 5 * 6 * 7
    assert yardstick.forward_flops(sites) == fwd
    assert yardstick.model_flops(sites, train=True) == 3 * fwd


def _counted(model, *args, **kw) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(*args, **kw)
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["vilbert_6l6c.cc_pretrain", "baseline_bert.cc_pretrain"])
def test_pretrain_sites_count_every_product(name):
    """The sites of a CC step, forward, equal the products the plain
    reference's forward runs (counted by torch) at a tiny width."""
    cell = tiny.tiny_cell(name)
    driver = cell.generator().Driver(run_cell.Context(cell, 3, "cpu"))
    p = cell.traffic
    batch = cell.generator().make_ring(p, cell.config, 3, "cpu")[0]
    ref = PRETRAINING[cell.config["family"]](Config(cell.config)).eval()
    for t in ref.parameters():
        torch.nn.init.normal_(t, std=0.02)
    pos, _ = first_masked(batch["lm_label_ids"], p["lm_gather"])
    counted = _counted(ref, batch["input_ids"], batch["image_feat"], batch["image_loc"],
                       batch["segment_ids"], batch["input_mask"], batch["image_mask"],
                       lm_positions=pos)
    assert yardstick.forward_flops(driver.unit_sites("step")) == counted


def test_eval_sites_count_every_product():
    cell = tiny.tiny_cell("vilbert_6l6c.vqa_eval")
    driver = cell.generator().Driver(run_cell.Context(cell, 3, "cpu"))
    task, p = cell.traffic["task"], cell.traffic
    b, t, r = task["eval_batch_size"], task["max_seq_length"], task["max_region_num"]
    ref = ViLBERTForVLTasks(Config(cell.config), num_labels=p["num_labels"]).eval()
    ids = torch.ones(b, t, dtype=torch.long)
    counted = _counted(ref, ids, torch.randn(b, r, cell.config["v_feature_size"]),
                       torch.rand(b, r, 5), torch.zeros_like(ids), ids,
                       torch.ones(b, r, dtype=torch.long), head="vil_prediction")
    assert yardstick.forward_flops(driver.unit_sites("batch")) == counted


def test_trace_summary_by_hand(tmp_path):
    """Busy time is the union of device intervals inside the window; gaps are
    the rest, labelled by the host's innermost span and operator."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "attention_fwd_tc_kernel", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 70, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 95, "dur": 50},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.load(str(path))
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((30 + 10 + 5) * 1e-6)
    assert s.h2d_s == pytest.approx(10e-6)
    assert s.kernel_launches == 3
    assert s.kernel_seconds(yardstick.is_eager) == pytest.approx(5e-6)
    assert [g[1] for g in s.gaps] == pytest.approx([30e-6, 15e-6, 10e-6])
    assert s.gaps[0][0] == "bench.step / aten::mm"


def test_kernel_classes():
    assert not yardstick.is_eager("void attention_bwd_wg_dq_kernel<64>(Args, int)")
    assert not yardstick.is_eager("sm90_xmma_gemm_bf16bf16_bf16f32")
    assert not yardstick.is_eager("void layer_norm_fwd_kernel<bf16, 768>")
    assert yardstick.is_eager("void at::native::vectorized_elementwise_kernel<4>")
    assert yardstick.is_eager("void at::native::(anonymous)::cunn_SoftMaxForward")


def test_device_only_trace_spans_its_activities(tmp_path):
    """A trace of the device alone has no host span: its window runs from the
    first device activity to the last."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 100, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 130, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 90, "dur": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.load(str(path))
    assert s.window_s == pytest.approx(50e-6) and s.busy_s == pytest.approx(30e-6)
    assert [g[1] for g in s.gaps] == pytest.approx([20e-6])
