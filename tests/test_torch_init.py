"""The port's random init (`models/videoseal.init_weights`) against flax's
`init` of the JAX package's modules, parameter by parameter through the
weight bridge (`utils/convert.from_jax_variables`), for the tiny training
card and videoseal_1.0's embedder and extractor.

* A parameter the JAX module starts at a constant (norms' scales 1 and
  biases 0, conv and dense biases 0, GRN's gamma and beta 0) is that
  constant exactly in both.
* A conv, transposed conv or dense kernel is lecun_normal in both: a normal
  truncated at two deviations with variance 1 / fan_in, fan_in on flax's
  kernel layout. Each tensor's mean and standard deviation lie within
  STD_ERRS standard errors of 0 and 1 / sqrt(fan_in) (the standard errors of
  an untruncated normal's, which the truncation only narrows), and |w| is
  at most the truncation point.
* The message table is N(0, 1) in both, held alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import JAX_COMPILE_OPTIONS
from torch_port import TRAIN_EMB_CFG, TRAIN_EXT_CFG
from torch_port import TRAIN_NBITS as NBITS
from torch_port import TRAIN_SIZE as SIZE

STD_ERRS = 5.0
TRUNC_STD = 0.87962566103423978        # a unit normal's deviation truncated at +-2


def _cards():
    from videoseal_tpu_torch.cards import CARDS
    card = CARDS["videoseal_1.0"]
    return {"tiny": (("unet_tiny_yuv", TRAIN_EMB_CFG), ("convnext_tiny", TRAIN_EXT_CFG),
                     NBITS, SIZE),
            "videoseal_1.0": ((card["embedder"]["model"], card["embedder"]["params"]),
                              (card["extractor"]["model"], card["extractor"]["params"]),
                              32, 128)}


def _built(name: str):
    """(port embedder, port extractor, JAX's flax-initialised variables as
    the port's state dicts) for a card."""
    from videoseal_tpu.models.embedder import build_embedder as jax_embedder
    from videoseal_tpu.models.extractor import build_extractor as jax_extractor
    from videoseal_tpu_torch.models.embedder import build_embedder
    from videoseal_tpu_torch.models.extractor import build_extractor
    from videoseal_tpu_torch.models.videoseal import init_weights
    from videoseal_tpu_torch.utils.convert import from_jax_variables
    (emb_name, emb_cfg), (ext_name, ext_cfg), nbits, size = _cards()[name]
    je = jax_embedder(emb_name, emb_cfg, nbits, 2).module
    jx = jax_extractor(ext_name, ext_cfg, size, nbits).module
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    cpu = jax.devices("cpu")[0]
    in_c = 1 if "yuv" in emb_name else 3
    with jax.default_device(cpu):
        # compiled at XLA's backend level 0 (test_torch_train's options): the
        # compile is most of the time
        args = (k1, jnp.zeros((1, size, size, in_c)), jnp.zeros((1, nbits), jnp.int32))
        ev = jax.jit(je.init).lower(*args).compile(JAX_COMPILE_OPTIONS)(*args)
        args = (k2, jnp.zeros((1, size, size, 3)))
        xv = jax.jit(jx.init).lower(*args).compile(JAX_COMPILE_OPTIONS)(*args)
    ev, xv = jax.tree_util.tree_map(np.asarray, (dict(ev), dict(xv)))
    emb = build_embedder(emb_name, emb_cfg, nbits, 2).module
    ext = build_extractor(ext_name, ext_cfg, size, nbits).module
    gen = torch.Generator().manual_seed(0)
    for m in (emb, ext):
        init_weights(m, gen)
    return emb, ext, from_jax_variables(ev, xv)


@pytest.fixture(scope="module", params=["tiny", "videoseal_1.0"])
def built(request):
    return request.param, _built(request.param)


def _kinds(module: torch.nn.Module) -> dict:
    """{parameter name: ("lecun", fan_in) | ("normal", 1) | ("constant", None)}."""
    from videoseal_tpu_torch.models.videoseal import _fan_in
    from videoseal_tpu_torch.modules.discriminator import SNConv2d
    kernels = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear, torch.nn.ConvTranspose2d,
               SNConv2d)
    out = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(m, kernels) and pname == "weight":
                out[name] = ("lecun", _fan_in(m))
            elif isinstance(m, torch.nn.Embedding):
                out[name] = ("normal", 1)
            else:
                out[name] = ("constant", None)
    return out


def _hold_draw(w: np.ndarray, kind: str, fan_in: int, what: str) -> None:
    w = w.astype(np.float64).ravel()
    sigma = fan_in ** -0.5
    n = w.size
    mean, std = w.mean(), w.std()
    assert abs(mean) <= STD_ERRS * sigma / np.sqrt(n), (what, mean, sigma, n)
    assert abs(std - sigma) <= STD_ERRS * sigma / np.sqrt(2 * n), (what, std, sigma, n)
    if kind == "lecun":
        assert np.abs(w).max() <= 2 * sigma / TRUNC_STD * (1 + 1e-6), (what, np.abs(w).max())


def test_init_matches_flax(built):
    name, (emb, ext, (jemb, jext)) = built
    counts = {"lecun": 0, "normal": 0, "constant": 0}
    for module, want in ((emb, jemb), (ext, jext)):
        kinds = _kinds(module)
        params = dict(module.named_parameters())
        assert set(kinds) == set(params)
        for pname, p in params.items():
            kind, fan_in = kinds[pname]
            got, ref = p.detach().numpy(), want[pname].numpy()
            assert got.shape == ref.shape, pname
            counts[kind] += 1
            if kind == "constant":
                assert np.unique(ref).size == 1 and float(ref.flat[0]) in (0.0, 1.0), pname
                np.testing.assert_array_equal(got, ref, err_msg=pname)
            else:
                _hold_draw(got, kind, fan_in, f"{name} port {pname}")
                _hold_draw(ref, kind, fan_in, f"{name} JAX {pname}")
    # every kind is present: kernels, biases and norms, the message table
    assert all(counts.values()), counts


def test_transposed_and_temporal_fan_in():
    """flax's fan-in for the layers whose torch layout differs from flax's:
    a transposed conv (flax's (kh, kw, I, O), the port's (I, O, kh, kw)), a
    depthwise conv, a 3D conv and the 2+1D temporal kernel."""
    from videoseal_tpu_torch.models.videoseal import _fan_in, init_weights
    from videoseal_tpu_torch.modules.common import ConvTranspose, TemporalConv
    layers = {"transposed": (ConvTranspose(6, 10, 2, stride=2), 2 * 2 * 6),
              "depthwise": (torch.nn.Conv2d(40, 40, 7, groups=40), 49),
              "3d": (torch.nn.Conv3d(5, 7, 3), 27 * 5),
              "temporal": (TemporalConv(12, 12, 3), 3 * 12)}
    gen = torch.Generator().manual_seed(1)
    for what, (m, fan_in) in layers.items():
        assert _fan_in(m) == fan_in, what
        init_weights(m, gen)
        _hold_draw(m.weight.detach().numpy(), "lecun", fan_in, what)
        if m.bias is not None:
            assert not m.bias.detach().any(), what
