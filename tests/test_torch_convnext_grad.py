"""The port's extractors are differentiable, against ``jax.grad`` of the
JAX package's linen modules, and the ConvNeXt route rule.

With grad enabled and something requiring it, the ConvNeXt blocks run the
linen math on the live parameters (no kernel); under ``torch.no_grad``, or
when nothing requires grad, they run K2 (``convnext_block_fused``), whose
plain version on the CPU rounds to bf16 inside. Tolerance: both sides are
float32 with sums in other orders; every gradient is held to GRAD_RTOL of
its tensor's largest (expected <= 1e-4 relative).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import _randomize, tiny_card, tiny_card_v0

torch.set_num_threads(4)

GRAD_RTOL = 1e-4
S = 64


def _extractor_pair(card: dict, seed: int):
    """(linen module, randomised JAX variables, port extractor with them)."""
    from videoseal_tpu.models.extractor import build_extractor as jax_build
    from videoseal_tpu_torch.models.extractor import build_extractor
    from videoseal_tpu_torch.utils.convert import from_jax_variables
    x = card["extractor"]
    jspec = jax_build(x["model"], copy.deepcopy(x["params"]), S, 16)
    v = jax.jit(jspec.module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, S, S, 3)))
    v = _randomize(v, np.random.default_rng(seed))
    port = build_extractor(x["model"], copy.deepcopy(x["params"]), S, 16).module
    _, sd = from_jax_variables({"params": {"unet": {}}}, v)
    port.load_state_dict(sd)
    return jspec.module, v, port


def _hold_grads(module, v, port):
    from videoseal_tpu_torch.utils.convert import from_jax_variables
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    r = rng.normal(size=(2, 17)).astype(np.float32)

    def loss(params, xx):
        return jnp.sum(module.apply({"params": params}, xx) * r)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(x))
    _, want = from_jax_variables({"params": {"unet": {}}},
                                 {"params": jax.tree_util.tree_map(np.asarray, gp)})
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt) * torch.from_numpy(r)).sum().backward()
    names = [n for n, _ in port.named_parameters()]
    assert set(names) == set(want)
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(w).max()) + 1e-7, err_msg=name)
    gx = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0,
                               atol=GRAD_RTOL * float(np.abs(gx).max()))


def test_convnext_extractor_grads_match_jax():
    """Every parameter of the tiny convnext_tiny extractor (depths
    [1, 1, 1, 1], dims [8, 16, 32, 64]) and its input get jax.grad's
    gradient."""
    module, v, port = _extractor_pair(tiny_card(img_size=S), 0)
    _hold_grads(module, v, port)


def test_vit_extractor_grads_match_jax():
    """videoseal_0.0's SAM ViT extractor at narrow widths, the same way."""
    module, v, port = _extractor_pair(tiny_card_v0(img_size=S), 1)
    _hold_grads(module, v, port)


def test_unet_embedder_grads_match_jax():
    """The UNet embedder with its message processor in train mode (batch
    statistics), against jax.grad of the linen module with train=True."""
    from videoseal_tpu.models.embedder import build_embedder as jax_build
    from videoseal_tpu_torch.models.embedder import build_embedder
    from videoseal_tpu_torch.utils.convert import from_jax_variables
    e = tiny_card(img_size=S)["embedder"]
    jspec = jax_build(e["model"], e["params"], 16, 2)
    v = jax.jit(jspec.module.init)(jax.random.PRNGKey(2), jnp.zeros((1, S, S, 1)),
                                   jnp.zeros((1, 16), jnp.int32))
    v = _randomize(v, np.random.default_rng(2))
    port = build_embedder(e["model"], e["params"], 16, 2).module.train()
    emb, _ = from_jax_variables(v, {"params": {"encoder": {}}})
    port.load_state_dict(emb)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (3, S, S, 1)).astype(np.float32)
    m = rng.integers(0, 2, (3, 16)).astype(np.int32)
    r = rng.normal(size=(3, S, S, 1)).astype(np.float32)

    def loss(params):
        out, _ = jspec.module.apply({"params": params, "batch_stats": v["batch_stats"]},
                                    jnp.asarray(x), jnp.asarray(m), train=True,
                                    mutable=["batch_stats"])
        return jnp.sum(out * r)

    gp = jax.jit(jax.grad(loss))(v["params"])
    want, _ = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, gp)},
                                 {"params": {"encoder": {}}})
    (port(torch.from_numpy(x), torch.from_numpy(m).long()) * torch.from_numpy(r)).sum().backward()
    for name, p in port.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(w).max()) + 1e-7, err_msg=name)


@pytest.fixture
def k2_calls(monkeypatch):
    """Counts the calls into K2's wrapper from the block and the extractor's
    fused route."""
    from videoseal_tpu_torch.kernels import convnext_fused
    from videoseal_tpu_torch.kernels.convnext_block import convnext_block_fused
    from videoseal_tpu_torch.modules import convnext
    calls = []

    def counting(x, p):
        calls.append(tuple(x.shape))
        return convnext_block_fused(x, p)

    monkeypatch.setattr(convnext, "convnext_block_fused", counting)
    monkeypatch.setattr(convnext_fused, "convnext_block_fused", counting)
    return calls


def test_route_rule(k2_calls):
    """Under no_grad the block and the extractor call K2 (one call a
    block); with grad enabled they do not, and every parameter gets a
    gradient; with grad enabled but nothing requiring it, K2 again."""
    from videoseal_tpu_torch.modules.convnext import ConvNeXtBlock
    from videoseal_tpu_torch.models.extractor import build_extractor
    blk = ConvNeXtBlock(32)
    x = torch.randn(2, 5, 7, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        blk(x)
    assert k2_calls == [(2, 5, 7, 32)]
    blk(x).sum().backward()
    assert len(k2_calls) == 1
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in blk.parameters()), [n for n, p in blk.named_parameters() if p.grad is None]

    ext = build_extractor("convnext_tiny", tiny_card(img_size=S)["extractor"]["params"],
                          S, 16).module
    imgs = torch.rand(2, S, S, 3, generator=torch.Generator().manual_seed(1))
    k2_calls.clear()
    with torch.no_grad():
        ext(imgs)
    assert len(k2_calls) == 4                    # depths [1, 1, 1, 1]
    k2_calls.clear()
    ext(imgs).sum().backward()
    assert k2_calls == []
    assert all(p.grad is not None for p in ext.parameters())
    ext.requires_grad_(False)
    ext(imgs)
    assert len(k2_calls) == 4
