"""The offline tools: the LPIPS/Watson-VGG/DISTS weight converter against
the JAX package's on random ``.pth`` files in the reference layouts (small
widths: the converter reorders, it does not check widths),
`tools.eval_checkpoint` on a train state of the port and of the JAX
package, and `augmentation.doaugs`.
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_port import TRAIN_EMB_CFG, TRAIN_EXT_CFG, TRAIN_NBITS, TRAIN_SIZE, train_weights

torch.set_num_threads(4)

VGG_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
SLICE = {i: s for s, r in enumerate([range(0, 4), range(4, 9), range(9, 16), range(16, 23),
                                     range(23, 30)], start=1) for i in r}


def _conv(rng, cout, cin, k=3):
    return (torch.from_numpy(rng.normal(size=(cout, cin, k, k)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)))


def _pth_files(d, rng) -> dict:
    """Random state dicts in the torchvision, lpips, Watson-VGG and DISTS
    layouts, saved with torch.save."""
    sds = {"vgg16": {}, "alexnet": {}, "lpips": {}, "lpips_alex": {}, "watson": {},
           "dists": {"alpha": torch.rand(1, 6, 1, 1), "beta": torch.rand(1, 6, 1, 1)},
           "dists_stages": {"alpha": torch.rand(1, 6, 1, 1), "beta": torch.rand(1, 6, 1, 1)}}
    for i, idx in enumerate(VGG_IDX):
        w, b = _conv(rng, 4 + i, 3 + i)
        sds["vgg16"][f"features.{idx}.weight"], sds["vgg16"][f"features.{idx}.bias"] = w, b
        sds["watson"][f"vgg.slice{SLICE[idx]}.{idx}.weight"] = w * 2
        sds["watson"][f"vgg.slice{SLICE[idx]}.{idx}.bias"] = b * 2
        stage = SLICE[idx] if idx != 23 else 5
        sds["dists_stages"][f"stage{stage}.{idx}.weight"] = w * 3
        sds["dists_stages"][f"stage{stage}.{idx}.bias"] = b * 3
    for i, idx in enumerate((0, 3, 6, 8, 10)):
        w, b = _conv(rng, 5 + i, 3 + i, 5)
        sds["alexnet"][f"features.{idx}.weight"], sds["alexnet"][f"features.{idx}.bias"] = w, b
    for i in range(5):
        sds["lpips"][f"lin{i}.model.1.weight"] = torch.rand(1, 4 + i, 1, 1)
        sds["lpips_alex"][f"lins.{i}.model.1.weight"] = torch.rand(1, 5 + i, 1, 1)
        sds["watson"][f"t{i}_tild"] = torch.rand(3 + i)
        sds["watson"][f"w{i}_tild"] = torch.rand(3 + i)
    sds["watson"]["beta"] = torch.rand(())
    paths = {}
    for k, sd in sds.items():
        paths[k] = os.path.join(d, f"{k}.pth")
        torch.save({"state_dict": sd} if k == "dists" else sd, paths[k])
    return paths


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    return _pth_files(str(tmp_path_factory.mktemp("pth")), np.random.default_rng(0))


@pytest.mark.parametrize("out,args,jax_fn", [
    ("lpips_vgg.npz", ("vgg16", "lpips"), "convert_lpips"),
    ("lpips_alex.npz", ("alexnet", "lpips_alex"), "convert_lpips_alex"),
    ("watson_vgg.npz", ("watson",), "convert_watson_vgg"),
    ("dists.npz", ("vgg16", "dists"), "convert_dists"),
    ("dists.npz", ("dists_stages",), "convert_dists")])
def test_convert_lpips_matches_jax(tmp_path, pth, out, args, jax_fn):
    from videoseal_tpu.tools import convert_lpips as J
    from videoseal_tpu.utils.checkpoint import flatten_tree
    from videoseal_tpu_torch.tools import convert_lpips as P
    flags = {"vgg16": "--vgg16", "lpips": "--lpips", "alexnet": "--alexnet",
             "lpips_alex": "--lpips_alex", "watson": "--watson", "dists": "--dists",
             "dists_stages": "--dists"}
    argv = ["--out", str(tmp_path)]
    for a in args:
        argv += [flags[a], pth[a]]
    P.main(argv)
    sds = [J._load_sd(pth[a]) for a in args]
    if jax_fn == "convert_dists" and len(sds) == 1:
        sds = [None] + sds
    want = flatten_tree(getattr(J, jax_fn)(*sds))
    with np.load(os.path.join(str(tmp_path), out)) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v), k


def test_convert_lpips_refuses_lpips_without_backbone(tmp_path, pth):
    from videoseal_tpu_torch.tools import convert_lpips as P
    with pytest.raises(SystemExit):
        P.main(["--out", str(tmp_path), "--lpips", pth["lpips"]])


def _train_card() -> dict:
    return {"args": {"attenuation": "jnd_1_1", "nbits": TRAIN_NBITS,
                     "hidden_size_multiplier": 2, "img_size_proc": TRAIN_SIZE,
                     "blending_method": "additive", "scaling_w": 0.2, "scaling_i": 1.0},
            "embedder": {"model": "unet_tiny_yuv", "params": TRAIN_EMB_CFG},
            "extractor": {"model": "convnext_tiny", "params": TRAIN_EXT_CFG}}


def test_eval_checkpoint_reads_a_jax_written_train_state(tmp_path):
    """A train state the JAX package wrote (its fields by leaf index) gives
    the serving model its embedder and extractor weights."""
    import jax.numpy as jnp
    import optax
    from videoseal_tpu.parallel.trainer import TrainState
    from videoseal_tpu.utils.checkpoint import save_train_state
    from videoseal_tpu_torch.tools.eval_checkpoint import load_trained_model
    from videoseal_tpu_torch.utils.convert import from_jax_variables
    ev, xv, dv = train_weights()
    opt = optax.adamw(1e-3)
    state = TrainState(step=jnp.asarray(4, jnp.int32), embedder_params=ev["params"],
                       embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
                       disc_params=dv["params"],
                       opt_state_g=opt.init({"embedder": ev["params"],
                                             "extractor": xv["params"]}),
                       opt_state_d=opt.init(dv["params"]), scaling_w=jnp.float32(0.3))
    path = str(tmp_path / "jax_state.npz")
    save_train_state(path, state)
    model = load_trained_model(path, _train_card(), TRAIN_NBITS, TRAIN_SIZE, 0.3,
                               device="cpu")
    emb, ext = from_jax_variables(ev, xv)
    for mod, want in ((model.embedder, emb), (model.extractor, ext)):
        for k, v in mod.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, want[k]), k
    assert model.scaling_w == pytest.approx(0.3) and model.nbits == TRAIN_NBITS


def test_eval_checkpoint_main_on_a_port_train_state(tmp_path):
    """train.main's checkpoint.npz (tiny card) through
    `python -m videoseal_tpu_torch.tools.eval_checkpoint`: the full image
    grid's rows and their CSV."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.augmentation.validation import get_validation_augs
    from videoseal_tpu_torch.tools import eval_checkpoint
    out = str(tmp_path / "run")
    train.main(["--device", "cpu", "--tiny", "1", "--synthetic", "1", "--steps", "1",
                "--batch_size", "2", "--img_size", "64", "--eval_freq", "0",
                "--output_dir", out])
    csv = str(tmp_path / "metrics.csv")
    card = str(tmp_path / "tiny_card.json")     # train.py's tiny card as a card file
    with open(card, "w") as f:
        json.dump(train.TINY_CARD, f)
    rows = eval_checkpoint.main(["--checkpoint", os.path.join(out, "checkpoint.npz"),
                                 "--card", card, "--nbits", "16", "--img_size", "64",
                                 "--samples", "1", "--sample_size", "64", "--device", "cpu",
                                 "--out_csv", csv])
    assert len(rows) == sum(len(s) for _, s in get_validation_augs(False))
    assert all(0.0 <= r["bit_acc"] <= 1.0 for r in rows) and os.path.exists(csv)


@pytest.mark.parametrize("is_video", [0, 1])
def test_doaugs_writes_every_row(tmp_path, is_video):
    from videoseal_tpu_torch.augmentation import doaugs
    from videoseal_tpu_torch.augmentation.validation import get_validation_augs
    written = doaugs.main(["--out_dir", str(tmp_path), "--is_video", str(is_video),
                           "--device", "cpu"])
    assert len(written) == sum(len(s) for _, s in get_validation_augs(bool(is_video)))
    assert all(os.path.getsize(p) > 0 for p in written)


def test_doaugs_defaults_to_the_card(tmp_path, monkeypatch):
    """Without --device, doaugs runs on the card and, without one, raises
    naming --device cpu, as train.py does."""
    from videoseal_tpu_torch.augmentation import doaugs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        doaugs.main(["--out_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
