"""WmForger in the port against the JAX package on the CPU: the preference
losses, the adversarial ascent with JAX's draws injected, the three FFT
generators (spectra bit for bit from the same `random` / `np.random`
seeds, the embed within one 8-bit level), one training step of each option
at the ``--tiny`` widths (parameters after AdamW, the non-finite skip),
``optimize``, and the two packages reading each other's checkpoints
(``main --device cpu`` / ``--cpu 1``, then each ``optimize_image.main``).
The JAX steps are compiled at XLA's backend level 0."""

import functools
import random
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port import jax_random_vars, to_np

from videoseal_tpu.models.extractor import build_extractor as jbuild_extractor
from videoseal_tpu.wmforger import generators as jgen, optimize_image as jopt, train as jtrain
from videoseal_tpu_torch.utils.convert import extractor_from_jax, extractor_to_jax
from videoseal_tpu_torch.wmforger import generators as pgen, optimize_image as popt
from videoseal_tpu_torch.wmforger import train as ptrain

torch.set_num_threads(1)

JAX_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0}
# f32 on both sides, the convolutions' and matmuls' sums in another order
LOG_RTOL, IMG_ATOL = 1e-5, 2e-5
# gradients: f32 sums in another order, relative to each tensor's largest
LR, GRAD_RTOL = 1e-4, 1e-4
S, DEPTHS, DIMS = 32, [1, 1, 2, 1], [16, 32, 64, 128]


def _pair(seed: int = 0):
    """(JAX preference model, its random params, the port's holding them)."""
    jm = jbuild_extractor("convnext_tiny", {
        "encoder": {"depths": DEPTHS, "dims": DIMS},
        "pixel_decoder": {"pixelwise": False, "upscale_stages": [1], "embed_dim": DIMS[-1],
                          "sigmoid_output": False}}, S, nbits=0).module
    v = jax_random_vars(jm, jnp.zeros((1, S, S, 3)), seed=seed)
    pm = ptrain.build_preference_model(S, DEPTHS, DIMS)
    pm.load_state_dict(extractor_from_jax(v))
    return jm, v["params"], pm


def _batch(n: int = 2, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n, S, S, 3)).astype(np.float32)
    imgs_w = np.clip(imgs + rng.normal(0, 0.03, imgs.shape), 0, 1).astype(np.float32)
    return {"imgs": imgs, "imgs_w": imgs_w}


def _jax_draws(key, n_steps: int, shape, rand: bool, lo=1e-3, hi=3e-2) -> dict:
    """The draws JAX's step makes from `key`, in `sample_draws`' layout."""
    lrs = [float(jax.random.uniform(jax.random.fold_in(key, i), (), minval=lo, maxval=hi))
           for i in range(n_steps)]
    init = (torch.from_numpy(np.asarray((jax.random.uniform(key, shape) * 2 - 1) * lo))
            if rand else None)
    k1, k2 = jax.random.split(jax.random.fold_in(key, 7))
    return {"lrs": lrs, "init": init,
            "alphas": [float(jax.random.uniform(k1, ())), float(jax.random.uniform(k2, ()))]}


@pytest.mark.parametrize("loss_type", ["bce", "bt_nll"])
def test_losses(loss_type):
    rng = np.random.default_rng(0)
    real, wm = rng.normal(0, 3, (2, 16)).astype(np.float32)
    want = float(jtrain.construct_loss(loss_type)(jnp.asarray(real), jnp.asarray(wm)))
    got = float(ptrain.construct_loss(loss_type)(torch.from_numpy(real), torch.from_numpy(wm)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        ptrain.construct_loss("hinge")


@pytest.mark.parametrize("n_steps,rand,sign", [(2, False, False), (2, True, False),
                                               (1, True, True)])
def test_adversarial_perturb(n_steps, rand, sign):
    """The ascent through the tiny preference model with JAX's step sizes
    and random start; the FGSM form (sign of the gradient) included."""
    jm, params, pm = _pair()
    imgs_w = _batch()["imgs_w"]
    key = jax.random.PRNGKey(4)

    def ascent(p, x):
        return jtrain.adversarial_perturb(lambda y: jm.apply({"params": p}, y)[..., 0], x,
                                          key, n_steps, use_grad_sign_only=sign,
                                          use_rand_perturbation=rand)
    want = jax.jit(ascent).lower(params, imgs_w).compile(JAX_COMPILE_OPTIONS)(params, imgs_w)
    d = _jax_draws(key, n_steps, imgs_w.shape, rand)
    got = ptrain.adversarial_perturb(lambda x: pm(x)[..., 0], torch.from_numpy(imgs_w),
                                     d["lrs"], d["init"], use_grad_sign_only=sign)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=IMG_ATOL)
    assert not np.array_equal(to_np(got), imgs_w)


# -- the generators ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["waves", "gaussian", "lines"])
def test_spectrum_bit_equal(name):
    """The same `random` and `np.random` seeds give the same pattern."""
    out = []
    for mod in (jgen, pgen):
        random.seed(7)
        np.random.seed(7)
        out.append(mod._GENERATORS[name].generate_random_watermark_fft())
    np.testing.assert_array_equal(out[1], out[0])
    assert out[1].dtype == np.float32 and out[1].shape == (512, 512)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generator_embed(seed):
    """build_generator("random") picks the same generator, and its embed
    (the pattern resized to 64x48, the JND or the plain branch, 8-bit
    rounding) agrees within one 8-bit level."""
    imgs = np.random.default_rng(seed).uniform(0, 1, (3, 64, 48, 3)).astype(np.float32)
    out = []
    for mod, x in ((jgen, imgs), (pgen, torch.from_numpy(imgs))):
        random.seed(seed)
        np.random.seed(seed)
        gen = mod.build_generator("random")
        out.append((type(gen).__name__, to_np(gen.embed(x)["imgs_w"])))
    assert out[0][0] == out[1][0]
    assert np.abs(out[1][1] - out[0][1]).max() <= 1 / 255 + 1e-6
    assert (np.abs(out[1][1] - imgs) > 0).any()


# -- the training step ---------------------------------------------------------------

OPTIONS = {
    "perturb": dict(loss_type="bt_nll", n_perturbation_steps=1),
    "bce_rand_sign": dict(loss_type="bce", n_perturbation_steps=2, use_rand_perturbation=True,
                          use_grad_sign_only=True),
    "grad_matching_contrast": dict(loss_type="bt_nll", n_perturbation_steps=1,
                                   grad_matching=True, strength_contrasting=True),
}


@functools.lru_cache(maxsize=None)
def _jax_step(option: str):
    """JAX's step for `option` with SGD at lr 1, so that its parameters'
    change is its gradient, compiled once for the tests' batch shape."""
    jm, params, _ = _pair()
    opt = optax.sgd(1.0)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    step = jtrain.make_train_step(jm, optimizer=opt, **OPTIONS[option])
    return step.lower(params, opt.init(params), jb, jax.random.PRNGKey(0)).compile(
        JAX_COMPILE_OPTIONS), opt.init(params)


def _steps(option: str, batch: dict, key):
    """One step of each package from the same parameters and draws: (the
    parameters before, JAX's gradients, JAX's logs, the port's model after
    its AdamW step, the port's logs, the port's optimizer)."""
    _, params, pm = _pair()
    fn, state = _jax_step(option)
    new, _, jlogs = fn(jax.tree_util.tree_map(jnp.array, params), state,
                       {k: jnp.asarray(v) for k, v in batch.items()}, key)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), params, new)
    opts = {k: v for k, v in OPTIONS[option].items() if k != "use_rand_perturbation"}
    opt = torch.optim.AdamW(pm.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    d = _jax_draws(key, opts["n_perturbation_steps"], batch["imgs"].shape,
                   OPTIONS[option].get("use_rand_perturbation", False))
    plogs = ptrain.make_train_step(pm, optimizer=opt, **opts)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, d)
    return params, grads, jlogs, pm, plogs, opt


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_step(option):
    """Losses and logs within float32 rounding; each gradient within
    GRAD_RTOL of its tensor's largest (JAX's from SGD at lr 1); the
    parameters after the port's AdamW equal optax.adamw's update (weight
    decay 1e-4) from the port's gradients."""
    params, grads, jlogs, pm, plogs, _ = _steps(option, _batch(), jax.random.PRNGKey(5))
    assert set(plogs) == set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(plogs[k]), float(v), rtol=LOG_RTOL, atol=1e-6,
                                   err_msg=k)
    want = extractor_from_jax({"params": grads})
    got = {k: p.grad for k, p in pm.named_parameters()}
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_RTOL * float(g.abs().max()) + 1e-9, err_msg=k)
    pgrads = extractor_to_jax(got)["params"]
    opt = optax.adamw(LR)
    upd, _ = opt.update(pgrads, opt.init(params), params)
    after = extractor_from_jax({"params": optax.apply_updates(params, upd)})
    for k, p in pm.state_dict().items():
        # the same float32 operations in another order: a few ulps
        np.testing.assert_allclose(p.numpy(), after[k].numpy(), atol=1e-9, rtol=4e-7,
                                   err_msg=k)


def test_nonfinite_step_skipped():
    """A NaN in the batch: JAX keeps its parameters, the port skips the
    optimizer's step (no state, the parameters as they were)."""
    batch = _batch()
    batch["imgs"][0, 0, 0, 0] = np.nan
    params, grads, jlogs, pm, plogs, opt = _steps("perturb", batch, jax.random.PRNGKey(6))
    assert not np.isfinite(float(jlogs["loss"])) and not np.isfinite(float(plogs["loss"]))
    assert not any(np.asarray(g).any() for g in jax.tree_util.tree_leaves(grads))
    assert not opt.state
    before = extractor_from_jax({"params": params})
    for k, p in pm.state_dict().items():
        assert torch.equal(p, before[k]), k


# -- optimize and the checkpoints ----------------------------------------------------------

def test_optimize_matches_jax():
    jm, params, pm = _pair(seed=2)
    img = np.random.default_rng(3).uniform(0, 1, (S, S, 3)).astype(np.float32)
    img[:4] = 0.0   # clipped pixels: the gradient splits at the tie, as jnp.clip's
    want = jopt.optimize(img, jm, params, num_steps=5, lr=0.05)   # its step is jitted
    got = popt.optimize(img, pm.eval(), num_steps=5, lr=0.05)
    np.testing.assert_allclose(to_np(got), want, atol=IMG_ATOL)
    cleaned, wm = popt.get_watermark(img, got)
    jc, jw = jopt.get_watermark(img, want)
    assert np.abs(to_np(cleaned) - jc).max() <= 1 / 255 + 1e-6
    np.testing.assert_allclose(to_np(wm), jw, atol=1 / 255 + 1e-6)


def _run_optimize_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["optimize_image"] + argv)
    mod.main() if mod is jopt else mod.main(argv)


def test_checkpoints_cross(tmp_path, monkeypatch):
    """The port's main (--device cpu) writes what JAX's optimize_image reads,
    and JAX's main (--cpu 1) what the port's reads: both tools then write
    the same cleaned image and watermark within one 8-bit level."""
    cv2 = pytest.importorskip("cv2")
    img = (np.random.default_rng(4).uniform(0, 1, (S, S, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "in.png"), img)
    common = ["--tiny", "1", "--synthetic", "1", "--steps", "1", "--batch_size", "2",
              "--img_size", str(S), "--generator", "waves"]
    pt, jx = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    model, step_ms = ptrain.main(common + ["--device", "cpu", "--output", pt])
    assert len(step_ms) == 1 and model.pixel_decoder.linear.out_features == 1
    jtrain.main(common + ["--cpu", "1", "--output", jx, "--n_perturbation_steps", "0"])
    for i, ckpt in enumerate((pt, jx)):
        outs = []
        for j, mod in enumerate((jopt, popt)):
            out = tmp_path / f"out{i}{j}"
            argv = ["--image", str(tmp_path / "in.png"), "--ckpt_path", ckpt,
                    "--num_steps", "3", "--output_dir", str(out)]
            _run_optimize_main(mod, argv + (["--device", "cpu"] if mod is popt else []),
                               monkeypatch)
            outs.append([cv2.imread(str(out / f)).astype(int)
                         for f in ("cleaned_image.png", "watermark.png")])
        for a, b in zip(*outs):
            assert np.abs(a - b).max() <= 1


def test_train_main_cpu_flag(tmp_path, monkeypatch):
    """--cpu 1, the JAX script's flag, trains on the CPU as --device cpu
    does (one tiny step), also where a card would be the default; without
    it and without a card the script raises naming --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = ["--tiny", "1", "--synthetic", "1", "--steps", "1", "--batch_size", "2",
              "--img_size", str(S), "--output", str(tmp_path / "w.npz")]
    model, step_ms = ptrain.main(common + ["--cpu", "1"])
    assert len(step_ms) == 1 and (tmp_path / "w.npz").exists()
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    with pytest.raises(RuntimeError, match="--device cpu"):
        ptrain.main(common)
