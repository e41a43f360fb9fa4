"""The port's weight bridge and its cards (videoseal_tpu_torch.utils.convert,
videoseal_tpu_torch.cards)."""

import copy
import glob
import os

import numpy as np
import pytest
import torch
import yaml

from torch_port import LOGIT_ATOL, jax_model, port_model, tiny_card

from videoseal_tpu.utils.torch_convert import convert_model
from videoseal_tpu_torch import VideoSeal, load_card
from videoseal_tpu_torch.cards import CARDS
from videoseal_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

_CARD_DIR = os.path.join(os.path.dirname(__file__), "..", "videoseal_tpu", "cards")


class TestWeightBridge:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_round_trip_through_reference_names(self, seed):
        """port state_dict (reference names) -> torch_convert.convert_model ->
        from_jax_variables gives back every tensor exactly."""
        card = tiny_card()
        model = VideoSeal.from_card(copy.deepcopy(card), device="cpu", seed=seed)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        emb_vars, ext_vars = convert_model(sd, card)
        emb, ext = from_jax_variables(emb_vars, ext_vars)
        for got, mod in ((emb, model.embedder), (ext, model.extractor)):
            want = mod.state_dict()
            assert set(got) == set(want)
            for k, v in want.items():
                assert got[k].shape == v.shape, k
                assert torch.equal(got[k].to(v.dtype), v), k

    def test_checkpoint_load(self, tmp_path):
        """A reference-style checkpoint ({"model": state_dict}, embedder.* and
        detector.* names) loads through from_card(checkpoint=...)."""
        card = tiny_card()
        a = VideoSeal.from_card(copy.deepcopy(card), device="cpu", seed=5)
        path = str(tmp_path / "ckpt.pth")
        torch.save({"model": {f"module.{k}": v for k, v in a.state_dict().items()}}, path)
        b = VideoSeal.from_card(copy.deepcopy(card), checkpoint=path, device="cpu",
                                seed=6)
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k

    def test_jax_npz_checkpoint_load(self, tmp_path):
        """Random JAX variables written by the JAX package's save_npz load
        through from_card(checkpoint=....npz) and give the JAX model's logits
        on the same frames, within LOGIT_ATOL (torch_port: K2 rounds to bf16
        inside, the JAX extractor on the CPU is all f32)."""
        from videoseal_tpu.utils.checkpoint import save_npz
        card = tiny_card(img_size=64)
        jm = jax_model(card, seed=7)
        path = str(tmp_path / "ckpt.npz")
        save_npz(path, jm.embedder_vars, jm.extractor_vars, args=card["args"])
        got = VideoSeal.from_card(copy.deepcopy(card), checkpoint=path, device="cpu", seed=8)
        want = port_model(card, jm)
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
        frames = np.random.default_rng(9).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
        logits = got.detect(torch.from_numpy(frames))["preds"].numpy()
        np.testing.assert_allclose(logits, np.asarray(jm.detect(frames)["preds"]),
                                   atol=LOGIT_ATOL)

    def test_url_checkpoint_is_skipped(self):
        """An http(s) checkpoint is skipped, as in the JAX package: the model
        keeps its random init from the seed and nothing is fetched."""
        card = tiny_card()
        a = VideoSeal.from_card(copy.deepcopy(card), device="cpu", seed=2)
        b = VideoSeal.from_card(copy.deepcopy(card), checkpoint="https://example.invalid/x.pth",
                                device="cpu", seed=2)
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k

    def test_load_strict(self):
        """The converted dicts load with strict=True into fresh modules."""
        card = tiny_card()
        a = VideoSeal.from_card(copy.deepcopy(card), device="cpu", seed=3)
        b = VideoSeal.from_card(copy.deepcopy(card), device="cpu", seed=4)
        emb, ext = from_jax_variables(*convert_model(
            {k: v.numpy() for k, v in a.state_dict().items()}, card))
        b.embedder.load_state_dict(emb, strict=True)
        b.extractor.load_state_dict(ext, strict=True)
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k


class TestCards:
    @pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(_CARD_DIR, "*.yaml"))))
    def test_card_equals_yaml(self, path):
        name = os.path.basename(path)[:-5]
        with open(path) as f:
            want = yaml.safe_load(f)
        assert CARDS[name] == want
        assert load_card(name) == want

    def test_cards_cover_yaml_dir(self):
        names = {os.path.basename(p)[:-5] for p in glob.glob(os.path.join(_CARD_DIR, "*.yaml"))}
        assert set(CARDS) == names
        assert load_card("videoseal") == CARDS["videoseal_1.0"]

    def test_default_device_is_the_card(self):
        """from_card and load build on the CUDA device unless asked for the
        CPU: without one they raise instead of building on the CPU."""
        from videoseal_tpu_torch import load
        if torch.cuda.is_available():
            assert VideoSeal.from_card(tiny_card()).device.type == "cuda"
            return
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VideoSeal.from_card(tiny_card())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load("videoseal_1.0")
        assert VideoSeal.from_card(tiny_card(), device="cpu").device.type == "cpu"

    def test_unported_cards_raise(self):
        """videoseal_0.0's card with the DINO or the DVMark extractor, which
        the port once refused, builds, and its extractor matches the JAX
        package's on the same weights (at 28 px: the JAX oracle on the CPU).
        The hidden extractor's preset builds too (tests/test_torch_presets.py
        holds it against JAX's)."""
        import jax
        import jax.numpy as jnp
        from torch_port import jax_random_vars, to_np

        from videoseal_tpu.models.extractor import build_extractor as jbuild_extractor
        from videoseal_tpu_torch import presets
        from videoseal_tpu_torch.utils.convert import extractor_from_jax
        x = np.random.default_rng(0).uniform(0, 1, (2, 28, 28, 3)).astype(np.float32)
        for model in ("dino2s_indices", "dvmark"):
            card = copy.deepcopy(load_card("videoseal_0.0"))
            card["extractor"] = {"model": model, "params": {}}
            ext = VideoSeal.from_card(card, device="cpu").extractor
            jm = jbuild_extractor(model, {}, 256, 96).module
            v = jax_random_vars(jm, jnp.zeros((1, 28, 28, 3)))
            ext.load_state_dict(extractor_from_jax(v))
            with torch.no_grad():
                got = to_np(ext(torch.from_numpy(x)))
            np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(v, x)), atol=5e-5,
                                       rtol=1e-4)
        card = copy.deepcopy(load_card("videoseal_0.0"))
        card["extractor"] = {"model": "hidden", "params": presets.EXTRACTOR["hidden"]}
        assert VideoSeal.from_card(card, device="cpu").extractor_spec.nbits == 96
