"""The plain float32 reference that decides a cell's ``correct``.

Plain PyTorch, written from the published ViLBERT (facebookresearch/
vilbert-multi-task: ``vilbert/vilbert.py``, ``vilbert/basebert.py``,
``vilbert/task_utils.py``, pytorch_transformers' AdamW). It imports nothing
of the measured program: it builds its own modules, with the reference's
``state_dict`` names, so that the benchmark's seeded weights load into it
and into the program alike, and works out everything from those weights
and the benchmark's inputs again.

Dropout is the counter hash both sides are given (``reference.dropout``):
the masks are a function of a seed and a position, and the seeds come from
a CPU ``torch.Generator`` that the benchmark seeds, drawn one per dropout
call in forward order.

Departures from the program, on purpose: gelu is the exact erf form
everywhere (the program uses a rational erf under bf16); every product is
float32 with TF32 off (the caller sets ``torch.backends``); nothing is
rounded to bf16. ``precision="fp8"`` puts float8 products in (the control).
"""
