"""``launches_per_sample`` in the evaluation cells, where it moves ``questions_per_s``."""

from pathlib import Path

from harness.spec import load_module

read = load_module(Path(__file__).with_name("launches_per_sample.py")).read
