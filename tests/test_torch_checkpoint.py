"""Checkpoint I/O and loading by path (videoseal_tpu_torch.utils.checkpoint,
utils.convert.to_jax_variables, utils.cfg, presets) against the JAX
package: each package reads the `.npz` the other writes."""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from torch_port import jax_model, port_model, tiny_card, tiny_card_v0, tiny_preset_card

import videoseal_tpu_torch as vt
from videoseal_tpu.utils import cfg as jcfg
from videoseal_tpu.utils import checkpoint as jckpt
from videoseal_tpu_torch import presets
from videoseal_tpu_torch.utils import cfg as pcfg
from videoseal_tpu_torch.utils import checkpoint as pckpt
from videoseal_tpu_torch.utils.convert import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "videoseal_tpu", "configs")
# the model a file loads into against the same package's model holding the
# written weights: the same weights bit for bit, the same f32 arithmetic
LOGIT_ATOL = 1e-5
CARDS = {"bn_convnext": lambda: tiny_card(img_size=64),
         "rgb_convnext": lambda: tiny_card(img_size=64, out_channels=3),
         "rms_vit": lambda: tiny_card_v0(img_size=64)}


@pytest.fixture(scope="module")
def jax_models():
    """One JAX model per card, built at first use (JAX's init and its jitted
    embed and detect are the slow part of this file)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jax_model(CARDS[name](), seed=2)
        return cache[name]
    return get


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(dict(v), p))
        else:
            out[p] = np.asarray(v)
    return out


def _frames(seed, n=2, h=64, w=96):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(CARDS))
def test_to_jax_inverts_from_jax(name, jax_models):
    """to_jax_variables(from_jax_variables(v)) == v, bit for bit, on the
    batch-norm and RMS-norm UNets, the ConvNeXt and the SAM ViT."""
    card = CARDS[name]()
    jm = jax_models(name)
    norm = card["embedder"]["params"]["unet"]["normalization"]
    emb, ext = to_jax_variables(*from_jax_variables(jm.embedder_vars, jm.extractor_vars),
                                unet_norm=norm)
    for want, got in ((jm.embedder_vars, emb), (jm.extractor_vars, ext)):
        fw, fg = _flat(want), _flat(got)
        assert set(fw) == set(fg)
        for k, v in fw.items():
            assert fg[k].dtype == v.dtype and fg[k].shape == v.shape, k
            assert np.array_equal(fg[k], v), k


@pytest.mark.parametrize("name", list(CARDS))
def test_port_save_jax_load(name, tmp_path, jax_models):
    """The port's save_npz -> the JAX package's load_npz/load_into: the
    variables of the JAX model that held the weights, and its logits and
    embed output within LOGIT_ATOL."""
    card = CARDS[name]()
    jm = jax_models(name)
    pm = port_model(card, jm)
    path = str(tmp_path / "port.npz")
    pckpt.save_npz(path, pm, args=card["args"])
    emb, ext = jckpt.load_npz(path)
    assert set(_flat(emb)) == set(_flat(jm.embedder_vars))
    evars, xvars = jckpt.load_into(path, card, jm.embedder_vars, jm.extractor_vars)
    loaded = copy.copy(jm)      # the same jitted functions, the loaded variables
    loaded.embedder_vars, loaded.extractor_vars = evars, xvars
    frames = _frames(3)
    np.testing.assert_allclose(np.asarray(loaded.detect(frames)["preds"]),
                               np.asarray(jm.detect(frames)["preds"]), atol=LOGIT_ATOL)
    msgs = jnp.asarray(np.random.default_rng(4).integers(0, 2, (2, 16)), jnp.int32)
    np.testing.assert_allclose(np.asarray(loaded.embed(frames, msgs=msgs)["imgs_w"]),
                               np.asarray(jm.embed(frames, msgs=msgs)["imgs_w"]),
                               atol=LOGIT_ATOL)
    assert jcfg._checkpoint_args(path) == card["args"]


@pytest.mark.parametrize("name", list(CARDS))
def test_jax_save_port_load(name, tmp_path, jax_models):
    """The JAX package's save_npz -> the port's from_card(checkpoint=...):
    the port's model that holds the same weights, logits within LOGIT_ATOL;
    and the port's own save_npz of it writes the same arrays."""
    card = CARDS[name]()
    jm = jax_models(name)
    path = str(tmp_path / "jax.npz")
    jckpt.save_npz(path, jm.embedder_vars, jm.extractor_vars, args=card["args"])
    got = vt.VideoSeal.from_card(copy.deepcopy(card), checkpoint=path, device="cpu", seed=9)
    want = port_model(card, jm)
    frames = torch.from_numpy(_frames(6))
    np.testing.assert_allclose(got.detect(frames)["preds"].numpy(),
                               want.detect(frames)["preds"].numpy(), atol=LOGIT_ATOL)
    again = str(tmp_path / "again.npz")
    pckpt.save_npz(again, got, args=card["args"])
    with np.load(path) as a, np.load(again) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def _preset_card_model(tmp_path, seed=0):
    """A model of the presets a checkpoint's args name, saved with those args."""
    card, args = tiny_preset_card()
    model = vt.VideoSeal.from_card(card, device="cpu", seed=seed)
    path = str(tmp_path / "preset.npz")
    pckpt.save_npz(path, model, args=args)
    return model, path


def test_load_by_path_builds_jax_card(tmp_path):
    """vt.load("x.npz") rebuilds the card that the JAX package's
    get_config_from_checkpoint builds, and holds the file's weights."""
    model, path = _preset_card_model(tmp_path)
    want = jcfg.get_config_from_checkpoint(path)
    assert pcfg.get_config_from_checkpoint(path) == want
    got = vt.load(path, device="cpu", seed=3)
    assert got.card == want
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    assert got.supports_planar and got.cfg.step_size == 2 and got.nbits == 16


def test_load_card_name_with_checkpoint(tmp_path):
    """A card name with checkpoint= loads the file's weights into that card."""
    want = vt.load("videoseal_1.0", device="cpu", seed=7)
    path = str(tmp_path / "v1.npz")
    pckpt.save_npz(path, want)
    got = vt.load("videoseal_1.0", checkpoint=path, device="cpu", seed=8)
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


def test_missing_args_raises(tmp_path):
    """An .npz without __args__ cannot be loaded by path, in either package."""
    card = tiny_card(img_size=64)
    model = vt.VideoSeal.from_card(copy.deepcopy(card), device="cpu")
    path = str(tmp_path / "bare.npz")
    pckpt.save_npz(path, model)
    with pytest.raises(KeyError, match="__args__"):
        jcfg.get_config_from_checkpoint(path)
    with pytest.raises(KeyError, match="__args__"):
        vt.load(path, device="cpu")


def test_yaml_string_args_raise(tmp_path):
    """A .pth whose args are a YAML string: the JAX package parses it, the
    port raises ValueError with the reason (no YAML parser on the machine
    that serves it)."""
    path = str(tmp_path / "yaml_args.pth")
    torch.save({"model": {}, "args": "nbits: 16\nimg_size_proc: 64\n"}, path)
    assert jcfg._checkpoint_args(path) == {"nbits": 16, "img_size_proc": 64}
    with pytest.raises(ValueError, match="YAML"):
        vt.load(path, device="cpu")


def test_pth_dict_args(tmp_path):
    """A .pth with dict args (reference names) rebuilds the same card as the
    JAX package's and loads its weights."""
    model, npz = _preset_card_model(tmp_path, seed=4)
    path = str(tmp_path / "ref.pth")
    args = pcfg._checkpoint_args(npz)
    torch.save({"model": model.state_dict(), "args": args}, path)
    assert pcfg.get_config_from_checkpoint(path) == jcfg.get_config_from_checkpoint(path)
    got = vt.load(path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


def test_baseline_raises():
    """A baseline by name alone raises FileNotFoundError, as the JAX
    package's does: its TorchScript files are not in the repository
    (models/baselines.build_baseline takes their paths)."""
    import videoseal_tpu as vs
    for load in (vs.load, lambda n: vt.load(n, device="cpu")):
        with pytest.raises(FileNotFoundError, match="TorchScript"):
            load("baseline/trustmark")


def test_other_config_file_raises(tmp_path):
    model, _ = _preset_card_model(tmp_path)
    path = str(tmp_path / "other.npz")
    pckpt.save_npz(path, model, args={"embedder_config": "my_embedders.yaml"})
    with pytest.raises(ValueError, match="my_embedders.yaml"):
        pcfg.get_config_from_checkpoint(path)


def test_load_into_checks_shapes(tmp_path):
    """A checkpoint of another width raises ValueError; one with a tensor
    missing raises KeyError, as the JAX package's load_into does."""
    small = vt.VideoSeal.from_card(tiny_card(img_size=64), device="cpu")
    path = str(tmp_path / "small.npz")
    pckpt.save_npz(path, small)
    card = tiny_card(img_size=64)
    card["embedder"]["params"]["unet"]["z_channels"] = 8
    with pytest.raises(ValueError, match="shape mismatch"):
        vt.VideoSeal.from_card(card, checkpoint=path, device="cpu")
    with np.load(path) as data:
        kept = {k: data[k] for k in data.files if "outc" not in k}
    np.savez(str(tmp_path / "missing.npz"), **kept)
    with pytest.raises(KeyError, match="outc"):
        vt.VideoSeal.from_card(tiny_card(img_size=64), checkpoint=str(tmp_path / "missing.npz"),
                               device="cpu")


@pytest.mark.parametrize("kind", ["embedder", "extractor"])
def test_presets_equal_yaml(kind):
    with open(os.path.join(_CONFIGS, f"{kind}.yaml")) as f:
        want = yaml.safe_load(f)
    assert getattr(presets, kind.upper()) == want


def test_available_cards():
    assert pcfg.available_cards() == jcfg.available_cards()
