"""The port's losses and discriminators against the JAX package's on the CPU.

Values and input gradients (``jax.grad``) of every perceptual loss, the
combinator strings, Watson-FFT; LPIPS (VGG and AlexNet), Watson-VGG and
DISTS on random weights that the JAX package writes to a ``.npz`` and both
packages' ``build`` read; ``build`` raising where JAX's does; the
discriminators (ActNorm's data-dependent init, the SN U-Net after one
update); VideoSealLoss's terms, weights, scales and the discriminator loss.

Tolerances: both sides are float32; the FFT, convolution and reduction
sums run in other orders. Values are held to VALUE_RTOL; gradients to
GRAD_RTOL of each gradient's largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(4)

VALUE_RTOL, VALUE_ATOL = 1e-4, 1e-7
GRAD_RTOL, GRAD_RTOL_MSSSIM = 1e-4, 3e-3


def _pair(seed=0, n=2, s=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.03, x.shape).astype(np.float32), 0, 1)
    return x, y


def _hold(jfn, pfn, x, y, grads: bool = True, rtol=VALUE_RTOL, jgrad=None, pfn64=None,
          grad_rtol=GRAD_RTOL):
    """Value of pfn (torch) against jfn (JAX) in float32; with grads, both
    input gradients in float64 (jgrad: a jitted JAX gradient function of
    (x, y), default jax.grad of jfn; pfn64: the port's function for float64
    tensors, default pfn). The gradients are compared in float64 because
    some of these losses amplify float32 rounding in their gradients by
    orders of magnitude (arccos near 1 in Watson's phase term, 1/eps where
    LPIPS normalises a dead feature vector), on both sides alike."""
    want = float(jfn(jnp.asarray(x), jnp.asarray(y)))
    got = pfn(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got.detach()), want, rtol=rtol, atol=VALUE_ATOL)
    if not grads:
        return
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    with jax.enable_x64(True):
        fn = jgrad or jax.jit(jax.grad(lambda a, b: jnp.mean(jfn(a, b)), argnums=(0, 1)))
        gx, gy = (np.asarray(g) for g in fn(jnp.asarray(x64), jnp.asarray(y64)))
    xt = torch.from_numpy(x64).requires_grad_()
    yt = torch.from_numpy(y64).requires_grad_()
    out = (pfn64 or pfn)(xt, yt)
    if out.requires_grad:
        out.backward()
    for g, w in ((xt.grad, gx), (yt.grad, gy)):
        if not w.any():
            assert g is None or not g.any()
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=grad_rtol * float(np.abs(w).max()))


@pytest.mark.parametrize("name", ["none", "mse", "yuv", "ssim", "msssim", "jnd", "focal",
                                  "watson_dft"])
def test_perceptual_losses(name):
    from videoseal_tpu.losses.perceptual import build_loss as jax_build
    from videoseal_tpu_torch.losses.perceptual import build_loss
    x, y = _pair(s=176 if name == "msssim" else 64)
    # the port's SSIM runs in float32 whatever its input (ops/metrics.py), and
    # MS-SSIM's gradient (a product of five powered terms) carries that
    # rounding: up to 1.6e-3 of its largest element against JAX in float64
    _hold(jax_build(name), build_loss(name), x, y,
          grad_rtol=GRAD_RTOL_MSSSIM if name == "msssim" else GRAD_RTOL)


@pytest.mark.parametrize("spec", ["0.5_mse+yuv", "focal+0.1_ssim", "watson_dft+0.25_jnd"])
def test_combinator(spec):
    from videoseal_tpu.losses.perceptual import build_perceptual_loss as jax_build
    from videoseal_tpu_torch.losses.perceptual import PerceptualLoss, build_perceptual_loss
    x, y = _pair(1)
    _hold(jax_build(spec), build_perceptual_loss(spec), x, y)
    assert repr(PerceptualLoss(spec)) == f"PerceptualLoss(percep_loss={spec})"
    with pytest.raises(ValueError):
        build_perceptual_loss("mse+nonsense")


def test_watson_fft_blocks():
    from videoseal_tpu.losses.watson_fft import WatsonDistanceFft as JW, _block_rfft2 as jblk
    from videoseal_tpu_torch.losses.watson_fft import WatsonDistanceFft, _block_rfft2
    x = np.random.default_rng(2).uniform(0, 1, (2, 24, 32)).astype(np.float32)
    want = np.asarray(jblk(jnp.asarray(x)))
    got = _block_rfft2(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 12, 8, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    jp, pp = JW().init_params(), WatsonDistanceFft().init_params()
    assert set(jp) == set(pp)
    for k in jp:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-7)


# -- the VGG and AlexNet distances on random weights -----------------------------

def _conv_tree(plan, rng) -> dict:
    """He-scaled random conv weights in flax's layout: {name: {kernel HWIO,
    bias}} for plan [(name, k, cin, cout)]."""
    return {n: {"kernel": (rng.normal(0, (2.0 / (k * k * ci)) ** 0.5, (k, k, ci, co))
                           .astype(np.float32)),
                "bias": rng.normal(0, 0.05, co).astype(np.float32)}
            for n, k, ci, co in plan}


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """Random weights for lpips (VGG and AlexNet), watson_vgg and dists in
    the JAX package's .npz layout (its flatten_tree; one VGG16 tree shared)."""
    from videoseal_tpu.losses.lpips import _WEIGHT_FILES
    from videoseal_tpu.utils.checkpoint import flatten_tree
    d = tmp_path_factory.mktemp("vgg_weights")
    rng = np.random.default_rng(0)
    vgg_plan, cin = [], 3
    for si, (ch, n) in enumerate([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]):
        for ci in range(n):
            vgg_plan.append((f"conv{si}_{ci}", 3, cin, ch))
            cin = ch
    alex_ch, alex_k = [64, 192, 384, 256, 256], [11, 5, 3, 3, 3]
    alex_plan = [(f"conv{i}", k, ([3] + alex_ch)[i], c)
                 for i, (c, k) in enumerate(zip(alex_ch, alex_k))]
    vgg, alex = _conv_tree(vgg_plan, rng), _conv_tree(alex_plan, rng)
    vgg_ch = [64, 128, 256, 512, 512]
    pos = lambda n: rng.uniform(0.1, 1.0, n).astype(np.float32)
    trees = {
        "lpips": {"vgg": vgg, **{f"lin{i}": pos(c) for i, c in enumerate(vgg_ch)}},
        "lpips_alex": {"alex": alex, **{f"lin{i}": pos(c) for i, c in enumerate(alex_ch)}},
        "watson_vgg": {"vgg": vgg, "beta": np.float32(1.2),
                       **{f"t{i}_tild": rng.normal(0, 0.3, c).astype(np.float32)
                          for i, c in enumerate(vgg_ch)},
                       **{f"w{i}_tild": np.float32(rng.normal(-1.4, 0.2))
                          for i in range(5)}},
        "dists": {"vgg": vgg, "alpha": pos(3 + sum(vgg_ch)), "beta": pos(3 + sum(vgg_ch))},
    }
    for name, tree in trees.items():
        np.savez(d / _WEIGHT_FILES[name], **flatten_tree(tree))
    return str(d)


# float64 on both sides. DISTS: its normalisation constants are float32
# arrays inside JAX's forward
VGG_GRAD_RTOL = {"lpips": 1e-6, "lpips_alex": 1e-6, "dists": 1e-5, "watson_vgg": 1e-6}


@pytest.mark.parametrize("name", ["lpips", "lpips_alex", "watson_vgg", "dists"])
def test_vgg_losses_on_random_weights(weights_dir, name, monkeypatch):
    """The port's build (float32) and its module in float64 against the JAX
    module on the .npz's variables in float64 (one jitted value_and_grad;
    the JAX build is the same module on the same file)."""
    from videoseal_tpu.losses import lpips as jl
    from videoseal_tpu.utils.checkpoint import unflatten_tree
    from videoseal_tpu_torch.losses import lpips as pl
    path = f"{weights_dir}/{pl.WEIGHT_FILES[name]}"
    with np.load(path) as data:
        params = unflatten_tree({k: data[k].astype(np.float64) for k in data.files})
    jmod = jl._MODULES[name]()
    # JAX's scaling-layer constants are float32 arrays, ~3e-8 off the
    # decimal ones the port uses; Watson-VGG's masking, (|a| + eps) ** w with
    # w ~ 0.2, has gradients ~|a| ** -0.8 at near-zero features, so that
    # shift moves its target's gradient by up to 5.6e-4 of its largest:
    # give JAX the decimal constants in float64
    monkeypatch.setattr(jl, "_SHIFT", np.array([-0.030, -0.088, -0.188], np.float64))
    monkeypatch.setattr(jl, "_SCALE", np.array([0.458, 0.448, 0.450], np.float64))
    x, y = _pair(3, n=2, s=32)
    with jax.enable_x64(True):
        fn = jax.jit(jax.value_and_grad(lambda v, a, b: jnp.mean(jmod.apply(v, a, b)),
                                        argnums=(1, 2)))
        want, (gx, gy) = fn({"params": params}, jnp.asarray(x, jnp.float64),
                            jnp.asarray(y, jnp.float64))
    got = pl.build(name, weights_dir)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    mod64 = pl.load(name, path).double()
    assert not any(p.requires_grad for p in mod64.parameters())
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_()
    yt = torch.from_numpy(y.astype(np.float64)).requires_grad_()
    out = torch.mean(mod64(xt, yt))
    # float64 on both sides, but JAX's scaling-layer constants are float32
    # arrays (~3e-8 relative off the decimal ones the port uses)
    np.testing.assert_allclose(float(out.detach()), float(want), rtol=1e-6)
    out.backward()
    for g, w in ((xt.grad, np.asarray(gx)), (yt.grad, np.asarray(gy))):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=VGG_GRAD_RTOL[name] * float(np.abs(w).max()))


def test_lpips_perceptual_string(weights_dir, monkeypatch):
    """'lpips+0.1_mse' through the weights variable, as JAX's reads it."""
    from videoseal_tpu.losses.perceptual import build_perceptual_loss as jax_build
    from videoseal_tpu_torch.losses.perceptual import build_perceptual_loss
    monkeypatch.setenv("VIDEOSEAL_TPU_WEIGHTS", weights_dir)
    x, y = _pair(4)
    _hold(jax_build("lpips+0.1_mse"), build_perceptual_loss("lpips+0.1_mse"), x, y,
          grads=False, rtol=2e-4)


def test_build_raises_where_jax_does(tmp_path, monkeypatch):
    from videoseal_tpu.losses import lpips as jl
    from videoseal_tpu_torch.losses import lpips as pl
    monkeypatch.delenv("VIDEOSEAL_TPU_WEIGHTS", raising=False)
    for name in ("lpips", "lpips_alex", "watson_vgg", "dists"):
        with pytest.raises(FileNotFoundError):
            jl.build(name, str(tmp_path))
        with pytest.raises(FileNotFoundError, match=pl.WEIGHT_FILES[name]):
            pl.build(name, str(tmp_path))
    for mod in (jl, pl):
        with pytest.raises(NotImplementedError):
            mod.build("vgg19", str(tmp_path))


# -- discriminators ----------------------------------------------------------------

def test_actnorm_data_dependent_init():
    from videoseal_tpu.modules.discriminator import ActNorm as JA
    from videoseal_tpu_torch.modules.discriminator import ActNorm
    x = np.random.default_rng(5).normal(1.5, 2.0, (3, 6, 7, 4)).astype(np.float32)
    v = JA().init(jax.random.PRNGKey(0), jnp.asarray(x))
    an = ActNorm(4).train()
    got = an(torch.from_numpy(x))
    np.testing.assert_allclose(an.loc.detach().numpy(), np.asarray(v["params"]["loc"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(an.scale.detach().numpy(), np.asarray(v["params"]["scale"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(JA().apply(v, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    before = an.loc.detach().clone()
    an(torch.from_numpy(x + 1.0))                  # initialised once
    assert torch.equal(an.loc.detach(), before)


def test_unet_discriminator_sn_update():
    """The SN U-Net in eval mode, then one train-mode call: the output and
    the stored u and sigma of every SN conv against flax's batch_stats."""
    from videoseal_tpu.modules.discriminator import UNetDiscriminatorSN as JU
    from videoseal_tpu_torch.modules.discriminator import UNetDiscriminatorSN
    from videoseal_tpu_torch.utils.convert import disc_from_jax, disc_to_jax
    x = np.random.default_rng(6).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    jm = JU(num_feat=4)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                            jnp.asarray(x)))
    pm = UNetDiscriminatorSN(num_feat=4)
    pm.load_state_dict(disc_from_jax(v))
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-6)
    out, upd = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    got = pm(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-4, atol=1e-6)
    want = disc_from_jax({"params": v["params"],
                          "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])})
    for k, t in pm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    assert not np.array_equal(pm.conv1.u.numpy(),
                              v["batch_stats"]["SpectralNorm_0"]["conv1/kernel/u"])
    rt = disc_to_jax(pm.state_dict())
    assert jax.tree_util.tree_structure(rt) == jax.tree_util.tree_structure(v)


@pytest.mark.parametrize("input_nc", [3, 1])
def test_nlayer_discriminator(input_nc):
    from videoseal_tpu.modules.discriminator import NLayerDiscriminator as JN
    from videoseal_tpu_torch.modules.discriminator import NLayerDiscriminator
    from videoseal_tpu_torch.utils.convert import disc_from_jax
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = JN(input_nc=input_nc, ndf=8, n_layers=3)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1),
                                                            jnp.asarray(x)))
    pm = NLayerDiscriminator(input_nc=input_nc, ndf=8, n_layers=3)
    pm.load_state_dict(disc_from_jax(v))
    pm64 = NLayerDiscriminator(input_nc=input_nc, ndf=8, n_layers=3).double()
    pm64.load_state_dict(disc_from_jax(v))
    fn = jax.jit(lambda vv, a, b: jnp.mean(jm.apply(vv, a) * b[..., :1].mean()))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        grad = jax.jit(jax.grad(fn, argnums=(1, 2)))
    _hold(lambda a, b: fn(v, a, b), lambda a, b: torch.mean(pm(a) * b[..., :1].mean()),
          x, x[:, ::-1].copy(), jgrad=lambda a, b: grad(v64, a, b),
          pfn64=lambda a, b: torch.mean(pm64(a) * b[..., :1].mean()))


# -- VideoSealLoss ---------------------------------------------------------------

def _disc_pair():
    from videoseal_tpu.modules.discriminator import NLayerDiscriminator as JN
    from videoseal_tpu_torch.modules.discriminator import NLayerDiscriminator
    from videoseal_tpu_torch.utils.convert import disc_from_jax
    jm = JN(ndf=8, n_layers=2)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                                   jnp.zeros((1, 64, 64, 3))))
    pm = NLayerDiscriminator(ndf=8, n_layers=2)
    pm.load_state_dict(disc_from_jax(v))
    return (lambda a: jm.apply(v, a)), pm


@pytest.mark.parametrize("pixelwise,step", [(False, 0), (True, 5)])
def test_videoseal_loss(pixelwise, step):
    """generator_losses' terms and weights (the disc warm-up at step <
    disc_start), combine static and adaptive (given norms, total_norm set
    and not), discriminator_loss hinge and vanilla."""
    from videoseal_tpu.losses.videosealloss import VideoSealLoss as JL
    from videoseal_tpu_torch.losses.videosealloss import VideoSealLoss
    jd, pd = _disc_pair()
    rng = np.random.default_rng(8)
    x, y = _pair(9)
    shape = (2, 8, 8, 9) if pixelwise else (2, 9)
    preds = rng.normal(size=shape).astype(np.float32)
    masks = (rng.uniform(size=(2, 8, 8, 1)) > 0.4).astype(np.float32)
    msgs = rng.integers(0, 2, (2, 8))
    for kw in ({}, {"decode_weight": 1.0, "detect_weight": 0.5, "disc_start": 3,
                    "total_norm": 0.0, "disc_loss": "vanilla", "percep_loss": "0.5_mse+yuv"}):
        jl, pl = JL(**kw), VideoSealLoss(**kw)
        jlosses, jw = jax.jit(lambda *a: jl.generator_losses(*a, jd, step))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(masks), jnp.asarray(msgs),
            jnp.asarray(preds))
        plosses, pw = pl.generator_losses(torch.from_numpy(x), torch.from_numpy(y),
                                          torch.from_numpy(masks), torch.from_numpy(msgs),
                                          torch.from_numpy(preds), pd, step)
        # jit returns its dicts sorted: restore the insertion order, which
        # combine reads (total_norm 0 takes the last loss's norm)
        assert list(plosses) == [k for k in ("percep", "disc", "detect", "decode")
                                 if k in jlosses] and list(pw) == list(plosses)
        jlosses, jw = {k: jlosses[k] for k in plosses}, {k: jw[k] for k in plosses}
        for k in jlosses:
            np.testing.assert_allclose(float(plosses[k]), float(jlosses[k]), rtol=VALUE_RTOL,
                                       atol=VALUE_ATOL, err_msg=k)
            assert float(pw[k]) == pytest.approx(float(jw[k])), k
        norms = {k: 0.1 * (i + 1) for i, k in enumerate(jlosses)}
        for gn in (None, norms):
            jt, jlogs = jl.combine(jlosses, jw, None if gn is None
                                   else {k: jnp.float32(v) for k, v in gn.items()})
            pt, plogs = pl.combine(plosses, pw, None if gn is None
                                   else {k: torch.tensor(v) for k, v in gn.items()})
            assert set(jlogs) == set(plogs)
            for k in jlogs:
                np.testing.assert_allclose(float(plogs[k]), float(jlogs[k]), rtol=VALUE_RTOL,
                                           atol=VALUE_ATOL, err_msg=k)
        jdl, jdlogs = jax.jit(lambda a, b: jl.discriminator_loss(jd, a, b, step))(
            jnp.asarray(x), jnp.asarray(y))
        pdl, pdlogs = pl.discriminator_loss(pd, torch.from_numpy(x), torch.from_numpy(y), step)
        for k in jdlogs:
            np.testing.assert_allclose(float(pdlogs[k]), float(jdlogs[k]), rtol=VALUE_RTOL,
                                       atol=VALUE_ATOL, err_msg=k)


def test_d_losses_and_adopt_weight():
    from videoseal_tpu.losses import videosealloss as J
    from videoseal_tpu_torch.losses import videosealloss as P
    rng = np.random.default_rng(10)
    a, b = rng.normal(size=(3, 4, 4, 1)).astype(np.float32), rng.normal(size=(3, 4, 4, 1))
    b = b.astype(np.float32)
    for fn in ("hinge_d_loss", "vanilla_d_loss"):
        np.testing.assert_allclose(float(getattr(P, fn)(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(getattr(J, fn)(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-6)
    for step in (0, 2, 3, 9):
        assert P.adopt_weight(0.7, step, 3) == pytest.approx(float(J.adopt_weight(0.7, step, 3)))


def test_eval_lpips_column(weights_dir, monkeypatch, capsys):
    """evals.full's LPIPS column: a number from AlexNet's loss on the random
    weights, and without weights NaN with a message naming the missing
    file."""
    from torch_port import tiny_card
    from videoseal_tpu_torch import VideoSeal
    from videoseal_tpu_torch.augmentation import augs as A
    from videoseal_tpu_torch.evals import full
    from videoseal_tpu_torch.losses import lpips as pl
    model = VideoSeal.from_card(tiny_card(img_size=64), device="cpu")
    imgs = next(full.synthetic_samples(1, (2, 64, 64, 3)))
    grid = [(A.Identity(), [0])]
    monkeypatch.setenv("VIDEOSEAL_TPU_WEIGHTS", weights_dir)
    rows = full.evaluate(model, [imgs], validation_augs=grid, verbose=False, bdrate=False)
    assert np.isfinite(rows[0]["lpips"]) and rows[0]["lpips"] > 0
    monkeypatch.setenv("VIDEOSEAL_TPU_WEIGHTS", str(weights_dir) + "/absent")
    rows = full.evaluate(model, [imgs], validation_augs=grid, verbose=True, bdrate=False)
    assert np.isnan(rows[0]["lpips"])
    assert pl.WEIGHT_FILES["lpips_alex"] in capsys.readouterr().out
