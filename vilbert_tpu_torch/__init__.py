"""vilbert_tpu_torch — the ViLBERT port to PyTorch and hand-written Hopper
(sm_90a) CUDA kernels, beside the JAX package ``vilbert_tpu``.

The JAX package is the reference: module and parameter names are the
reference torch ``state_dict`` names, so weights move between the two
packages through ``vilbert_tpu.core.importer``. Host modules of
``vilbert_tpu`` that do not import jax (configs, the importer, datasets and
loaders) are imported, not copied; this package never imports jax.

Layout mirrors ``vilbert_tpu``: ``ops`` (attention and LayerNorm, each a
plain PyTorch version plus the CUDA kernel from ``csrc``), ``models``,
``core`` (weights), ``train`` (task losses, batch reshapes), ``eval``,
``cli``.
"""
