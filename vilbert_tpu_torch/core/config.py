"""The port's configuration classes.

The JAX package's configuration dataclasses import no jax, so the port
shares them instead of copying them: a ``configs/*.json`` file or a
``configs/tasks.yml`` entry means the same model, task or optimizer on both
sides. Every module of the port takes them from here.
"""

from vilbert_tpu.core.config import (  # noqa: F401  (re-exported)
    ModelConfig,
    OptimizerConfig,
    TaskConfig,
    load_task_configs,
)
