"""The port's attention maps (``visualization``) against the JAX package, on
the CPU.

The JAX models sow each attention site's probabilities into flax's
``intermediates`` (read as ``tests/test_encoder_modes.py`` reads them, with
``capture_intermediates``); the port returns them on the output under names
``core.weights.flax_path`` maps onto those paths. At rate 0 in fp32 the
maps agree within 1e-5 (both are the fp32 softmax; the JAX visualization
path runs it in XLA). Under dropout the JAX package masks its maps with
XLA's hash or threefry and the port with the kernels' ``_keep_mask``
(ROADMAP C1), so there the port's maps are held to P times the Pallas
kernels' mask, and to the plain version, for the same seed.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

B, T, R = 3, 7, 5


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    am = np.ones((B, T), np.int32)
    am[:, -2:] = 0
    im = np.ones((B, R), np.int32)
    im[1, -2:] = 0
    return dict(
        input_txt=rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32),
        input_imgs=rng.randn(B, R, cfg.v_feature_size).astype(np.float32),
        image_loc=rng.rand(B, R, cfg.num_locs).astype(np.float32),
        token_type_ids=rng.randint(0, 2, (B, T)).astype(np.int32),
        attention_mask=am,
        image_attention_mask=im,
    )


def _classes(family):
    if family == "vilbert":
        from vilbert_tpu.models.vilbert import ViLBERTForVLTasks as jax_cls
        from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks as port_cls
    else:
        from vilbert_tpu.models.basebert import BaseBertForVLTasks as jax_cls
        from vilbert_tpu_torch.models.basebert import BaseBertForVLTasks as port_cls
    return jax_cls, port_cls


def _port(family, cfg, seed=0):
    return _classes(family)[1](cfg, generator=torch.Generator().manual_seed(seed)).eval()


def _run(model, x, heads=("vil_prediction",)):
    with torch.inference_mode():
        return model(**{k: torch.from_numpy(v) for k, v in x.items()}, heads=heads)


def _flax_maps(family, cfg, params, x, heads=("vil_prediction",)):
    """(output, {dotted intermediates path: map}) of the flax apply."""
    apply = functools.partial(
        _classes(family)[0](cfg).apply, heads=heads, mutable=["intermediates"],
        capture_intermediates=lambda mdl, name: name == "attention_probs")
    out, inter = jax.jit(apply)({"params": params}, **x)
    maps = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(inter["intermediates"])[0]:
        keys = [p.key for p in path if isinstance(p, jax.tree_util.DictKey)]
        maps[".".join(keys)] = np.asarray(leaf)
    return out, maps


@pytest.mark.parametrize("family", ["vilbert", "basebert"])
def test_maps_match_flax_intermediates(tiny_config, family):
    """Rate 0, fp32: one map per flax sow, under the same path, each within
    1e-5 of flax's; the logits within 1e-4."""
    from vilbert_tpu_torch.core.weights import flax_from_state_dict, flax_path

    cfg = tiny_config.replace(visualization=True)
    model = _port(family, cfg)
    x = _inputs(cfg)
    want_out, want = _flax_maps(family, cfg, flax_from_state_dict(model.state_dict(), family), x)
    got_out = _run(model, x)
    got = {flax_path(name, family): m for name, m in got_out.attention_probs.items()}
    n_sites = (cfg.num_hidden_layers if family == "basebert" else
               cfg.num_hidden_layers + cfg.v_num_hidden_layers + 2 * cfg.num_connection_layers)
    assert sorted(got) == sorted(want) and len(got) == n_sites
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        np.testing.assert_allclose(got[path].numpy(), w, rtol=0, atol=1e-5, err_msg=path)
    np.testing.assert_allclose(got_out.vil_prediction.numpy(),
                               np.asarray(want_out.vil_prediction), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["vilbert", "basebert"])
def test_maps_shapes_and_rows(tiny_config, family):
    """Text self-attention maps are [B, h, T, T], the co-attention's
    ``attention_probs`` [B, h, T, R] (text queries) and
    ``attention_probs_v`` [B, h, R, T]; each row sums to 1 at rate 0."""
    model = _port(family, tiny_config.replace(visualization=True))
    maps = _run(model, _inputs(tiny_config)).attention_probs
    h = tiny_config.num_attention_heads
    for name, m in maps.items():
        assert torch.allclose(m.sum(-1), torch.ones(()), atol=1e-5), name
    if family == "basebert":
        assert {tuple(m.shape) for m in maps.values()} == {(B, h, T + R, T + R)}
        return
    assert tuple(maps["bert.encoder.layer.0.attention.self.attention_probs"].shape) == (
        B, h, T, T)
    bh = tiny_config.bi_num_attention_heads
    assert tuple(maps["bert.encoder.c_layer.0.biattention.attention_probs"].shape) == (
        B, bh, T, R)
    assert tuple(maps["bert.encoder.c_layer.0.biattention.attention_probs_v"].shape) == (
        B, bh, R, T)


@pytest.mark.parametrize("family", ["vilbert", "basebert"])
def test_logits_unchanged_by_visualization(tiny_config, family):
    """Every head bit-equal with and without maps: in eval mode, and in
    train mode with dropout 0.1 from one generator seed (the maps draw no
    seed of their own)."""
    from vilbert_tpu_torch.models.layers import set_dropout_generator

    cfg = tiny_config.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                              v_hidden_dropout_prob=0.1, v_attention_probs_dropout_prob=0.1)
    x = _inputs(cfg, seed=1)
    plain, maps = _port(family, cfg, seed=2), _port(family, cfg.replace(visualization=True),
                                                    seed=2)
    for train in (False, True):
        outs = []
        for m in (plain, maps):
            m.train(train)
            set_dropout_generator(m, torch.Generator().manual_seed(4))
            outs.append(_run(m, x, heads=None))
        assert outs[0].attention_probs is None and len(outs[1].attention_probs) > 0
        for name in outs[0]._fields:
            a, b = getattr(outs[0], name), getattr(outs[1], name)
            if name != "attention_probs" and a is not None:
                assert torch.equal(a, b), (train, name)


def test_maps_collected_once_by_the_called_model_and_none_kept_by_remat(tiny_config):
    """Train mode, dropout 0.1, one generator seed: the task model and its
    encoder model, each called on its own, return the same maps under
    paths from themselves; with ``remat`` the maps are bit-equal to those
    without; after the backward, whose recompute runs every attention site
    again, no module holds a tensor outside its parameters and buffers."""
    from vilbert_tpu_torch.models.layers import set_dropout_generator

    cfg = tiny_config.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                              v_hidden_dropout_prob=0.1, v_attention_probs_dropout_prob=0.1,
                              visualization=True)
    x = {k: torch.from_numpy(v) for k, v in _inputs(cfg, seed=5).items()}
    runs = {}
    for remat in (False, True):
        model = _port("vilbert", cfg.replace(remat=remat), seed=6).train()
        set_dropout_generator(model, torch.Generator().manual_seed(7))
        out = model(**x, heads=("vil_prediction",))
        out.vil_prediction.float().sum().backward()
        assert not any(isinstance(v, torch.Tensor) for m in model.modules()
                       for v in vars(m).values()), remat
        runs[remat] = out.attention_probs
    assert list(runs[True]) == list(runs[False]) and len(runs[True]) > 0
    for name, probs in runs[False].items():
        assert torch.equal(runs[True][name], probs), name
    model.eval()
    with torch.no_grad():
        inner = model.bert(x["input_txt"], x["input_imgs"], x["image_loc"],
                           x["token_type_ids"], x["attention_mask"],
                           x["image_attention_mask"]).attention_probs
        outer = model(**x, heads=("vil_prediction",)).attention_probs
    assert ["bert." + name for name in inner] == list(outer)
    for name, probs in inner.items():
        assert torch.equal(outer["bert." + name], probs), name


def test_maps_under_dropout_are_p_times_the_kernel_mask():
    """Rate 0.1: ``attention(..., return_probs=True)`` gives P (the JAX fp32
    softmax) times 1/(1 - rate) where the Pallas kernels' ``_keep_mask``
    keeps, tile seed seed + (b h + head) 7919, and the plain version gives
    the same maps; the context is those maps times v."""
    from vilbert_tpu.ops.pallas_attention_train import _keep_mask
    from vilbert_tpu_torch.ops.attention import attention, attention_ref

    rng = np.random.RandomState(3)
    b, h, d, sq, sk, rate, seed = 2, 3, 8, 6, 9, 0.1, 2 ** 31 + 12345
    q, k, v = (rng.randn(b, s, h * d).astype(np.float32) for s in (sq, sk, sk))
    bias = np.zeros((b, 1, 1, sk), np.float32)
    bias[1, ..., -3:] = -10000.0
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    ctx, probs = attention(*t, num_heads=h, dropout_rate=rate, seed=seed, return_probs=True)
    _, plain = attention_ref(*t, num_heads=h, dropout_rate=rate, seed=seed, return_probs=True)
    heads = lambda a: jnp.asarray(a.reshape(b, -1, h, d).transpose(0, 2, 1, 3))  # noqa: E731
    scores = jnp.einsum("bhqd,bhkd->bhqk", heads(q), heads(k)) / math.sqrt(d) + bias
    p = np.asarray(jax.nn.softmax(scores, axis=-1))
    s32 = np.array(seed, np.uint32).view(np.int32)
    keep = np.stack([np.asarray(_keep_mask((sq, sk), rate, jnp.int32(s32) + jnp.int32(i) * 7919))
                     for i in range(b * h)]).reshape(b, h, sq, sk)
    want = np.where(keep, p * np.float32(1.0 / (1.0 - rate)), 0.0)
    assert tuple(probs.shape) == (b, h, sq, sk) and probs.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(probs, plain)
    want_ctx = (probs @ torch.from_numpy(v).reshape(b, sk, h, d).transpose(1, 2))
    np.testing.assert_allclose(ctx.numpy(), want_ctx.transpose(1, 2).reshape(b, sq, h * d),
                               rtol=0, atol=1e-6)


def test_maps_carry_no_gradient(tiny_config):
    """The context's gradient is the attention's, the maps take none."""
    from vilbert_tpu_torch.ops.attention import attention

    q, k, v = (torch.randn(2, 4, 16, requires_grad=True) for _ in range(3))
    ctx, probs = attention(q, k, v, None, num_heads=2, return_probs=True)
    assert not probs.requires_grad
    ctx.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))


class _FakeLibrary:
    """Records each kernel entry point's arguments; returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("variant,dtype,sk", [("tc", torch.bfloat16, 101),
                                              ("long_tc", torch.bfloat16, 200),
                                              ("cc", torch.float32, 101)])
def test_kernel_launch_with_probabilities(monkeypatch, variant, dtype, sk):
    """What the wrapper hands each K1 variant with and without
    ``return_probs`` (the library replaced by a recorder; the kernels run
    on a card): a [B, h, Sq, Sk] output in v's dtype before the stream, or
    a null pointer, and ``attention.launches_probs`` beside the variant's
    count."""
    import contextlib
    import types

    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.ops.attention import _fwd_cuda, attention

    for counter in ("launches", f"launches_{variant}", "launches_probs"):
        monkeypatch.setattr(attention, counter, 0)
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    q = torch.zeros(2, 23, 1024, dtype=dtype)
    kv = torch.zeros(2, sk, 1024, dtype=dtype)
    bias = torch.zeros(2, sk)
    out = _fwd_cuda(q, kv, kv, bias, 8, 0.0, None, variant)
    out2, probs = _fwd_cuda(q, kv, kv, bias, 8, 0.0, None, variant, True)
    assert out.shape == out2.shape == q.shape
    assert tuple(probs.shape) == (2, 8, 23, sk) and probs.dtype == dtype
    (_, plain_args), (_, prob_args) = lib.calls
    assert plain_args[-2] is None and prob_args[-2] == probs.data_ptr()
    assert plain_args[5:-2] == prob_args[5:-2]  # the same geometry, strides and dropout
    assert (attention.launches, getattr(attention, f"launches_{variant}"),
            attention.launches_probs) == (2, 2, 1)
