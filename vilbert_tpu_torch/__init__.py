"""vilbert_tpu_torch — the ViLBERT port to PyTorch and hand-written Hopper
(sm_90a) CUDA kernels, beside the JAX package ``vilbert_tpu``.

The JAX package is the reference, but the port imports nothing of it: it
runs where ``vilbert_tpu`` (and jax) are not installed. Module and parameter
names are the reference torch ``state_dict`` names, so weights move between
the two packages through the port's own ``core.importer``. The host modules
it shares with the JAX package are its own copies, held to the originals by
``tests/test_torch_host.py``: ``core/config.py``, ``core/importer.py``,
``data/{boxes,feature_store,lmdb_reader,tokenization,tasks,annotations,
loading,synthetic,concap}.py`` and two helpers of ``cli/train_tasks.py``.

Layout mirrors ``vilbert_tpu``: ``ops`` (attention and LayerNorm, each a
plain PyTorch version plus the CUDA kernel from ``csrc``), ``models``,
``core`` (configuration, weights), ``data``, ``train`` (losses, optimizer,
pretraining), ``eval``, ``cli``.
"""
