"""The port's training path against the JAX package's on the CPU.

* One `make_train_step` of each package from the same weights (carried by
  the weight bridge) and the same messages (JAX's draws injected), with the
  dummy augmenter: images with balanced 0 and 1 and every mode, video with
  balanced 1. Both sides step with SGD at lr 1, so JAX's gradient is the
  parameters' change; the port's is each parameter's .grad. Held: the
  logged losses, scales and metrics, every gradient of the generator and
  the discriminator, the BatchNorm statistics and the updated parameters.
* The optimizers and lr schedules against optax on the same given
  gradients over 5 steps.
* `train.main` on the CPU at the tiny card: log, eval rows, TensorBoard
  events and a checkpoint, then a resume from it.

Tolerances: both steps are float32 on the CPU; the convolutions and matmuls
sum in other orders, so values agree to ~1e-6 relative. Gradients are held
to GRAD_RTOL of each tensor's largest gradient plus GRAD_ATOL (the
recovered JAX gradient p_old - p_new carries one float32 rounding of |p|,
~1e-8; a bias before a GroupNorm has gradients that are mostly
cancellation, ~1e-3 with errors of a few 1e-7).
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port import TRAIN_EMB_CFG as EMB_CFG
from torch_port import TRAIN_EXT_CFG as EXT_CFG
from torch_port import TRAIN_NBITS as NBITS
from torch_port import TRAIN_SIZE as SIZE
from torch_port import port_train_mods, train_weights

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOG_RTOL, LOG_ATOL = 1e-4, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
JAX_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0}
PARAM_ATOL = 1e-6


def _jax_mods(balanced: bool):
    from videoseal_tpu.augmentation.augmenter import get_dummy_augmenter
    from videoseal_tpu.losses.videosealloss import VideoSealLoss
    from videoseal_tpu.models.embedder import build_embedder
    from videoseal_tpu.models.extractor import build_extractor
    from videoseal_tpu.models.videoseal import PipelineConfig
    from videoseal_tpu.modules.discriminator import NLayerDiscriminator
    from videoseal_tpu.modules.jnd import JND
    from videoseal_tpu.parallel.trainer import TrainerModules

    emb = build_embedder("unet_tiny_yuv", EMB_CFG, NBITS, 2)
    ext = build_extractor("convnext_tiny", EXT_CFG, SIZE, NBITS)
    return TrainerModules(
        embedder=emb.module, extractor=ext.module,
        discriminator=NLayerDiscriminator(ndf=8, n_layers=2), augmenter=get_dummy_augmenter(),
        attenuation=JND(), cfg=PipelineConfig(img_size=SIZE, chunk_size=4, step_size=2,
                                              yuv=True, nbits=NBITS),
        loss=VideoSealLoss(balanced=balanced, total_norm=1.0, percep_loss="yuv",
                           decode_weight=1.0, detect_weight=0.0),
        balanced=balanced)


@pytest.fixture(scope="module")
def weights():
    """The tiny card's JAX variables (BN statistics and GRN randomised) and
    the discriminator's, as numpy (torch_port.train_weights)."""
    return train_weights()


def _port_sds(ev, xv, dv):
    from videoseal_tpu_torch.utils.convert import disc_from_jax, from_jax_variables
    emb, ext = from_jax_variables(ev, xv)
    return emb, ext, disc_from_jax(dv)


def _port_mods(weights, balanced: bool, opt: str = "SGD,lr=1.0"):
    return port_train_mods(weights, balanced, opt)


def _jax_step(weights, balanced, is_video, mode, imgs, seed):
    """JAX's step with SGD at lr 1: (logs, new variables as numpy, msgs)."""
    from videoseal_tpu.parallel.trainer import TrainState, make_train_step
    ev, xv, dv = weights
    mods = _jax_mods(balanced)
    og, od = optax.sgd(1.0), optax.sgd(1.0)
    # create_train_state's fields, built here from the given variables (its
    # eager discriminator init would cost ~8 s)
    gen = {"embedder": ev["params"], "extractor": xv["params"]}
    state = TrainState(step=jnp.zeros((), jnp.int32), embedder_params=ev["params"],
                       embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
                       disc_params=dv["params"], opt_state_g=og.init(gen),
                       opt_state_d=od.init(dv["params"]), scaling_w=jnp.float32(0.2))
    key = jax.random.PRNGKey(seed)
    msgs = np.asarray(jax.random.randint(jax.random.split(key)[0], (imgs.shape[0], NBITS), 0, 2))
    batch = {"imgs": jnp.asarray(imgs)}
    # XLA's backend at level 0 compiles the step in about half the time
    step = make_train_step(mods, og, od, is_video=is_video, mode=mode).lower(
        state, batch, key).compile(JAX_COMPILE_OPTIONS)
    new, logs = step(state, batch, key)
    new = jax.tree_util.tree_map(np.asarray, new)
    return ({k: float(v) for k, v in logs.items()},
            ({"params": new.embedder_params, "batch_stats": new.embedder_stats},
             {"params": new.extractor_params}, {"params": new.disc_params}), msgs)


# On the video path JAX's float32 gradients of the embedder lie up to
# 1.8e-2 (of each tensor's largest) from a float64 run of the same JAX step
# (balanced and not), while the port's float32 gradients lie within 1.4e-5
# of the port's own float64 run (measured on the two video cases below, the
# resizes kept in float64): there the gradients are held to
# GRAD_RTOL_VIDEO, the error of the reference.
GRAD_RTOL_VIDEO = 3e-2
CASES = [  # (is_video, balanced, mode)
    (False, True, "both"),
    (False, False, "gen"),
    (True, False, "both"),
    (True, True, "both"),
    (False, True, "disc"),
]


@pytest.mark.parametrize("is_video,balanced,mode", CASES)
def test_train_step_matches_jax(weights, is_video, balanced, mode):
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    rng = np.random.default_rng(11)
    # one clip of 4 frames (2 key frames): XLA's CPU reductions sum float32
    # in order, so JAX's BatchNorm gradients drift from a float64 reference
    # as N*H*W grows (7e-5 relative at 3 64x64 inputs, 7e-3 at 10; the
    # port's stay within 2e-5 at 10)
    shape = (1, 4, SIZE, SIZE, 3) if is_video else (3, SIZE, SIZE, 3)
    imgs = rng.uniform(0, 1, shape).astype(np.float32)
    jlogs, jnew, msgs = _jax_step(weights, balanced, is_video, mode, imgs, seed=3)

    mods, state = _port_mods(weights, balanced)
    step = make_train_step(mods, is_video=is_video, mode=mode)
    _, plogs = step(state, {"imgs": torch.from_numpy(imgs)}, torch.Generator().manual_seed(0),
                    msgs=torch.from_numpy(msgs.copy()))
    assert state.step == 1
    assert set(jlogs) == set(plogs), (sorted(jlogs), sorted(plogs))
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(plogs[k]), v, rtol=LOG_RTOL, atol=LOG_ATOL, err_msg=k)
    if balanced and mode != "disc":
        assert {"scale_percep", "scale_disc", "scale_decode"} <= set(plogs)

    old = _port_sds(*weights)
    new = _port_sds(*jnew)
    modules = (state.embedder, state.extractor, state.discriminator)
    stepped = (mode != "disc", mode != "disc", mode != "gen")
    for mod, o, n, moved in zip(modules, old, new, stepped):
        for name, p in mod.named_parameters():
            want_g = (o[name] - n[name]).numpy()
            if not moved:
                assert p.grad is None, name
                assert not want_g.any(), name
                continue
            rtol = GRAD_RTOL_VIDEO if is_video else GRAD_RTOL
            tol = rtol * float(np.abs(want_g).max()) + GRAD_ATOL
            np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0, atol=tol, err_msg=name)
            # at lr 1 the update is the gradient: its tolerance plus a rounding of p
            np.testing.assert_allclose(p.detach().numpy(), n[name].numpy(), rtol=0,
                                       atol=tol + PARAM_ATOL, err_msg=name)
    # the BatchNorm statistics move in every mode (the embedder runs in train mode)
    bufs = dict(state.embedder.named_buffers())
    stats = [k for k in bufs if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert not torch.equal(bufs[k], old[0][k]), k
        np.testing.assert_allclose(bufs[k].numpy(), new[0][k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_batchnorm_running_var_is_biased():
    """The port's BatchNorm updates its running variance with the biased
    batch variance (flax's), not torch's unbiased one (n/(n-1) larger)."""
    from videoseal_tpu_torch.modules.common import make_norm
    x = torch.from_numpy(np.random.default_rng(0).normal(2.0, 3.0, (2, 4, 3, 5))
                         .astype(np.float32))
    bn = make_norm("batch", 4).train()
    ref = torch.nn.BatchNorm2d(4, eps=1e-5).train()
    torch.testing.assert_close(bn(x), ref(x))
    n = x.numel() // 4
    var = x.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(ref.running_var - 0.9, (bn.running_var - 0.9) * n / (n - 1))
    torch.testing.assert_close(bn.running_mean, ref.running_mean)


def test_intrain_eval_matches_jax(weights):
    """The in-training eval on the same state, images and messages as JAX's
    make_intrain_eval (identity grid): PSNR and SSIM within 1e-4; the bit
    accuracy of the identity row equal but for bits whose JAX logit lies
    within LOGIT_ATOL of 0 (the port detects through K2's plain version,
    bf16 inside: ROADMAP §3.20)."""
    from torch_port import LOGIT_ATOL
    from videoseal_tpu.evals.intrain import make_intrain_eval as jax_eval
    from videoseal_tpu.parallel.trainer import TrainState
    from videoseal_tpu_torch.evals.intrain import make_intrain_eval
    ev, xv, dv = weights
    jmods = _jax_mods(False)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), embedder_params=ev["params"],
                        embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
                        disc_params=dv["params"], opt_state_g=None, opt_state_d=None,
                        scaling_w=jnp.float32(0.2))
    imgs = np.random.default_rng(12).uniform(0, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want, jimgs_w = jax_eval(jmods, eval_augs="identity")(jstate, imgs, key)
    msgs = np.asarray(jax.random.randint(key, (3, NBITS), 0, 2))
    mods, state = _port_mods(weights, False)
    got, imgs_w = make_intrain_eval(mods, eval_augs="identity")(
        state, imgs, torch.Generator(), msgs=torch.from_numpy(msgs.copy()))
    assert set(got) == set(want) == {"psnr", "ssim", "bit_acc_identity_0"}
    np.testing.assert_allclose(imgs_w.numpy(), np.asarray(jimgs_w), atol=1e-6)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # the JAX logits of the identity row decide which bits may flip
    jlogits = np.asarray(jmods.extractor.apply({"params": xv["params"]},
                                               jnp.asarray(jimgs_w)))[:, 1:]
    unsure = float((np.abs(jlogits) < LOGIT_ATOL).mean())
    assert abs(got["bit_acc_identity_0"] - want["bit_acc_identity_0"]) <= unsure
    assert state.embedder.training            # back in train mode


# -- docs/training.md's stage A over steps --------------------------------------------

# the recipe at the tiny card: the augs_identity pool, the decode loss alone,
# scaling_w 1, AdamW at lr 5e-4 under the warmup-cosine schedule with an
# epoch of 2 steps, so that 3 steps cross the warmup into the cosine
RECIPE_OPT = "AdamW,lr=5e-4"
RECIPE_SCHED = "CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1"
RECIPE_EPOCH, RECIPE_STEPS = 2, 3


def _recipe_loss(pkg):
    return pkg.VideoSealLoss(balanced=False, total_norm=1.0, disc_weight=0.0, percep_weight=0.0,
                             detect_weight=0.0, decode_weight=1.0, percep_loss="none")


def _adam_mu(opt_state):
    """optax's first moment in an AdamW state."""
    return next(st.mu for st in opt_state if hasattr(st, "mu"))


def test_recipe_steps_match_jax(weights):
    """RECIPE_STEPS steps of the recipe in both packages from the same
    weights, batches and messages (JAX's draws, as train.py splits its key,
    injected), the optimizer state carried inside the step. Held at every
    step: the lr, the logs, and every generator gradient against JAX's, which
    the step recovers from optax's first moment (g_t = (mu_t - b1 mu_{t-1}) /
    (1 - b1)); then every parameter, which carries AdamW's moments and the
    schedule's steps. Both packages run in float64 (JAX under x64): with the
    decode loss alone, JAX's float32 gradient of the UNet's first conv lies
    3.7e-3 of its largest from JAX's own float64 step, which the port's
    float32 one matches to 2e-6 (measured), so float32 would hold the port to
    the reference's rounding. Gradients are held at the SGD step's
    tolerances, parameters at GRAD_RTOL of their largest change plus
    PARAM_ATOL."""
    import yaml
    from videoseal_tpu.augmentation.augmenter import build_augmenter as jax_augmenter
    from videoseal_tpu.losses import videosealloss as jax_loss
    from videoseal_tpu.parallel.trainer import TrainState
    from videoseal_tpu.parallel.trainer import make_train_step as jax_step
    from videoseal_tpu.utils.optim import build_lr_schedule as jax_schedule
    from videoseal_tpu.utils.optim import build_optimizer as jax_optimizer
    from videoseal_tpu_torch.augmentation.augmenter import build_augmenter
    from videoseal_tpu_torch.augmentation.presets import AUGS
    from videoseal_tpu_torch.losses import videosealloss as port_loss
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    from videoseal_tpu_torch.utils.optim import build_lr_schedule

    with open(os.path.join(ROOT, "videoseal_tpu", "configs", "augs_identity.yaml")) as f:
        aug_cfg = yaml.safe_load(f)
    assert aug_cfg == AUGS["augs_identity"]
    rng = np.random.default_rng(13)
    batches = [rng.uniform(0, 1, (3, SIZE, SIZE, 3)) for _ in range(RECIPE_STEPS)]
    sched = jax_schedule(RECIPE_SCHED, RECIPE_EPOCH, 5e-4)
    mods, state = port_train_mods(weights, False, RECIPE_OPT,
                                  augmenter=build_augmenter(AUGS["augs_identity"], num_augs=1),
                                  loss=_recipe_loss(port_loss), scaling_w=1.0,
                                  schedule=build_lr_schedule(RECIPE_SCHED, RECIPE_EPOCH, 5e-4),
                                  dtype=torch.float64)
    named = {f"{i}.{n}": p for i, m in enumerate((state.embedder, state.extractor))
             for n, p in m.named_parameters()}
    step = make_train_step(mods)
    generator = torch.Generator().manual_seed(0)
    ev, xv, dv = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), weights)

    def port_layout(tree):
        sds = _port_sds({"params": tree["embedder"]}, {"params": tree["extractor"]}, dv)
        return {f"{i}.{n}": v.numpy() for i in range(2) for n, v in sds[i].items()}

    with jax.enable_x64(True):
        jmods = dataclasses.replace(_jax_mods(False),
                                    augmenter=jax_augmenter(aug_cfg, num_augs=1),
                                    loss=_recipe_loss(jax_loss))
        og, od = jax_optimizer(RECIPE_OPT, schedule=sched), jax_optimizer(RECIPE_OPT)
        gen = {"embedder": ev["params"], "extractor": xv["params"]}
        jstate = TrainState(step=jnp.zeros((), jnp.int32), embedder_params=ev["params"],
                            embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
                            disc_params=dv["params"], opt_state_g=og.init(gen),
                            opt_state_d=od.init(dv["params"]), scaling_w=jnp.float64(1.0))
        key = jax.random.PRNGKey(444)
        jstep = jax_step(jmods, og, od).lower(jstate, {"imgs": jnp.asarray(batches[0])},
                                              key).compile(JAX_COMPILE_OPTIONS)
        mu_prev = {k: 0.0 for k in named}
        for i, imgs in enumerate(batches):
            np.testing.assert_allclose(state.opt_g.param_groups[0]["lr"], float(sched(i)),
                                       rtol=1e-6, atol=2 ** -23 * 5e-4)
            key, k = jax.random.split(key)
            msgs = np.asarray(jax.random.randint(jax.random.split(k)[0], (3, NBITS), 0, 2))
            jstate, jlogs = jstep(jstate, {"imgs": jnp.asarray(imgs)}, k)
            _, plogs = step(state, {"imgs": torch.from_numpy(imgs)}, generator,
                            msgs=torch.from_numpy(msgs.copy()))
            assert set(jlogs) == set(plogs), (sorted(jlogs), sorted(plogs))
            for name, v in jlogs.items():
                np.testing.assert_allclose(float(plogs[name]), float(v), rtol=LOG_RTOL,
                                           atol=LOG_ATOL, err_msg=f"step {i}: {name}")
            mu = port_layout(jax.tree_util.tree_map(np.asarray, _adam_mu(jstate.opt_state_g)))
            for name, p in named.items():
                want = (mu[name] - 0.9 * mu_prev[name]) / 0.1
                tol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_ATOL
                np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=tol,
                                           err_msg=f"step {i}: {name}")
            mu_prev = mu
        jstate = jax.tree_util.tree_map(np.asarray, jstate)
    assert state.step == RECIPE_STEPS
    old = port_layout({"embedder": ev["params"], "extractor": xv["params"]})
    new = port_layout({"embedder": jstate.embedder_params, "extractor": jstate.extractor_params})
    for name, p in named.items():
        moved = new[name] - old[name]
        assert moved.any(), name
        tol = GRAD_RTOL * float(np.abs(moved).max()) + PARAM_ATOL
        np.testing.assert_allclose(p.detach().numpy(), new[name], rtol=0, atol=tol, err_msg=name)


# -- optimizers and schedules against optax ----------------------------------------

def _optax_run(tx, params, grads):
    st = tx.init(params)
    out = []
    for g in grads:
        upd, st = tx.update(g, st, params)
        params = optax.apply_updates(params, upd)
        out.append(np.asarray(params))
    return out


OPTIMIZERS = [
    ("AdamW,lr=1e-2", lambda sched: optax.adamw(sched or 1e-2, weight_decay=1e-2)),
    ("AdamW,lr=1e-2,weight_decay=0.1,beta1=0.8",
     lambda sched: optax.adamw(sched or 1e-2, b1=0.8, weight_decay=0.1)),
    ("Adam,lr=1e-2", lambda sched: optax.adam(sched or 1e-2)),
    ("SGD,lr=1e-1", lambda sched: optax.sgd(sched or 1e-1)),
    ("SGD,lr=1e-1,momentum=0.9", lambda sched: optax.sgd(sched or 1e-1, momentum=0.9)),
]
SCHEDULES = [None, "CosineLRScheduler,lr_min=1e-4,t_initial=3,warmup_lr_init=1e-5,warmup_t=1",
             "StepLRScheduler,decay_t=1,decay_rate=0.5"]


@pytest.mark.parametrize("spec,make", OPTIMIZERS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_optimizer_matches_optax(spec, make, schedule):
    from videoseal_tpu.utils.optim import build_lr_schedule as jax_schedule
    from videoseal_tpu_torch.utils.optim import (build_lr_schedule, build_optimizer,
                                                 lr_scheduler, parse_params)
    rng = np.random.default_rng(2)
    p0 = rng.normal(0, 1, (6, 5)).astype(np.float32)
    grads = [rng.normal(0, 1, p0.shape).astype(np.float32) for _ in range(5)]
    base = parse_params(spec)["lr"]
    jsched = jax_schedule(schedule, 2, base) if schedule else None
    want = _optax_run(make(jsched), jnp.asarray(p0), [jnp.asarray(g) for g in grads])

    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = build_optimizer(spec, [p])
    sched = lr_scheduler(opt, build_lr_schedule(schedule, 2, base)) if schedule else None
    for i, g in enumerate(grads):
        if schedule:   # optax's curves in float32: one rounding of the peak lr
            np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jsched(i)), rtol=1e-6,
                                       atol=2 ** -23 * base)
        p.grad = torch.from_numpy(g)
        opt.step()
        if sched:
            sched.step()
        np.testing.assert_allclose(p.detach().numpy(), want[i], rtol=1e-5, atol=1e-6)


def test_unported_optimizers_raise():
    """lamb and adafactor are built (as optax builds them: held against
    optax in test_torch_optim.py); a name neither package knows raises."""
    from videoseal_tpu_torch.utils.optim import Adafactor, Lamb, build_optimizer
    p = [torch.nn.Parameter(torch.zeros(2))]
    assert isinstance(build_optimizer("lamb,lr=1e-3", p), Lamb)
    assert isinstance(build_optimizer("adafactor,lr=1e-3", p), Adafactor)
    with pytest.raises(NotImplementedError, match="optimizer rmsprop"):
        build_optimizer("RMSprop,lr=1e-3", p)


def test_scaling_schedule_matches_jax():
    from videoseal_tpu.utils.optim import ScalingSchedule as J
    from videoseal_tpu_torch.utils.optim import ScalingSchedule as P
    for spec in ("Linear,scaling_min=0.05,start_epoch=2,epochs=4",
                 "Cosine,scaling_min=0.1,epochs=3"):
        j, p = J(spec, 0.2), P(spec, 0.2)
        for e in range(9):
            assert p(e) == pytest.approx(j(e), rel=1e-12), (spec, e)


# -- the entry point ---------------------------------------------------------------

def test_train_main_cpu(tmp_path):
    """`--device cpu --tiny 1 --steps 3 --eval_freq 1`: log.txt, eval.jsonl,
    TensorBoard events, snapshots and checkpoint.npz; a resume restores the
    step, the modules and the optimizers, then runs 2 more steps."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    out = str(tmp_path / "run")
    common = ["--device", "cpu", "--tiny", "1", "--synthetic", "1", "--batch_size", "2",
              "--eval_freq", "1", "--output_dir", out, "--img_size", "64"]
    state, logger, step_ms = train.main(common + ["--steps", "3"])
    assert state.step == 3 and len(step_ms) == 3
    for f in ("log.txt", "eval.jsonl", "checkpoint.npz"):
        assert os.path.exists(os.path.join(out, f)), f
    log = [json.loads(ln) for ln in open(os.path.join(out, "log.txt"))]
    assert log[0]["step"] == 0 and all(np.isfinite(v) for v in log[0].values())
    rows = [json.loads(ln) for ln in open(os.path.join(out, "eval.jsonl"))]
    assert len(rows) == 1 and rows[0]["step"] == 3 and "bit_acc_identity_0" in rows[0]
    tb = os.listdir(os.path.join(out, "tensorboard"))
    assert tb and os.path.getsize(os.path.join(out, "tensorboard", tb[0])) > 0
    assert len(os.listdir(os.path.join(out, "snapshots"))) == 6

    args = train.get_parser().parse_args(common + ["--steps", "3"])
    _, fresh, _ = train.build_trainer(args, torch.device("cpu"))
    ckpt_io.load_train_state(os.path.join(out, "checkpoint.npz"), fresh)
    assert fresh.step == 3
    for a, b in ((state.embedder, fresh.embedder), (state.extractor, fresh.extractor),
                 (state.discriminator, fresh.discriminator)):
        for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
            if not k.endswith("num_batches_tracked"):
                torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    sa, sb = state.opt_g.state_dict()["state"], fresh.opt_g.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            torch.testing.assert_close(sa[i][k], sb[i][k], rtol=0, atol=0)

    state2, _, _ = train.main(common + ["--steps", "2", "--resume",
                                        os.path.join(out, "checkpoint.npz")])
    assert state2.step == 5


def test_datasets_match_jax(tmp_path):
    """SyntheticImages bit for bit; ImageFolder over PNGs written here (its
    path cache too); the loader's batches and shuffles; the transforms."""
    import cv2
    from videoseal_tpu.data import datasets as JD
    from videoseal_tpu.data import loader as JL
    from videoseal_tpu.data import transforms as JT
    from videoseal_tpu_torch.data import datasets as PD
    from videoseal_tpu_torch.data import loader as PL
    from videoseal_tpu_torch.data import transforms as PT
    js, ps = JD.SyntheticImages(10, 48, seed=3), PD.SyntheticImages(10, 48, seed=3)
    for i in (0, 7):
        for a, b in zip(js[i], ps[i]):
            assert np.array_equal(a, b)
    rng = np.random.default_rng(0)
    for i in range(5):
        cv2.imwrite(str(tmp_path / f"im{i}.png"), rng.integers(0, 256, (40 + 8 * i, 56, 3),
                                                               dtype=np.uint8))
    jf, pf = JD.ImageFolder(str(tmp_path), 32), PD.ImageFolder(str(tmp_path), 32)
    assert jf.samples == pf.samples and len(pf) == 5
    assert PD.ImageFolder(str(tmp_path), 32).samples == pf.samples     # from the cache
    for i in range(5):
        for a, b in zip(jf[i], pf[i]):
            assert np.array_equal(a, b)
    for jl, pl in ((JL.DataLoader(jf, 2, seed=1), PL.DataLoader(pf, 2, seed=1)),):
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            jb, pb = list(jl), list(pl)
            assert len(jb) == len(pb) == 2
            for a, b in zip(jb, pb):
                assert np.array_equal(a["imgs"], b["imgs"])
    img = pf[2][0]
    jt, _ = JT.get_transforms(24, seed=5)
    pt, _ = PT.get_transforms(24, seed=5)
    assert np.array_equal(jt(img), pt(img))


def test_train_main_image_folder(tmp_path):
    """Training on an image folder the test writes (the host loader path)."""
    import cv2
    from videoseal_tpu_torch import train
    rng = np.random.default_rng(1)
    data = tmp_path / "imgs"
    data.mkdir()
    for i in range(6):
        cv2.imwrite(str(data / f"{i}.png"), rng.integers(0, 256, (80, 72, 3), dtype=np.uint8))
    state, _, step_ms = train.main(["--device", "cpu", "--tiny", "1", "--image_dataset",
                                    str(data), "--batch_size", "2", "--steps", "3",
                                    "--img_size", "64", "--eval_freq", "0",
                                    "--output_dir", str(tmp_path / "run")])
    assert state.step == 3 and len(step_ms) == 3


def test_train_main_refuses():
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.parallel.mesh import make_mesh
    if not torch.cuda.is_available():       # the card is the default device
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(["--tiny", "1"])
    base = ["--device", "cpu", "--tiny", "1"]
    # a frames axis needs a process group of n_data * n_frames ranks
    with pytest.raises(ValueError, match="without a process group"):
        make_mesh(n_frames=2)
    with pytest.raises(ValueError, match="JSON"):
        train.main(base + ["--augmentation_config", "augs.yaml"])


AUG_POOLS = ["augs_geometric", "augs_geometric_hard", "augs_geometric_warm", "augs_identity"]


@pytest.mark.parametrize("name", AUG_POOLS)
@pytest.mark.parametrize("form", ["name", "yaml_path"])
def test_augmentation_config_pools(name, form):
    """--augmentation_config takes a pool of presets.AUGS by its name or by
    its YAML file's path (the recipe's form; the file is not read) and gives
    the pool the JAX train.py reads from that file."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.augmentation import presets
    path = os.path.join(ROOT, "videoseal_tpu", "configs", f"{name}.yaml")
    got = train.augmentation_config(name if form == "name" else path)
    assert got == presets.AUGS[name] and got is not presets.AUGS[name]
    args = train.get_parser().parse_args(["--tiny", "1", "--augmentation_config", path])
    assert train._config(args)[1] == presets.AUGS[name]
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        assert got == yaml.safe_load(f)


@pytest.mark.parametrize("path", ["augs.yaml", "videoseal_tpu/configs/embedder.yaml",
                                  "augs_identity_v2.yml", "all_augs"])
def test_augmentation_config_other_yaml_raises(path):
    """A path that names no pool raises ValueError naming the four pools."""
    from videoseal_tpu_torch import train
    with pytest.raises(ValueError, match="augs_geometric_warm") as e:
        train.augmentation_config(path)
    assert all(n in str(e.value) for n in AUG_POOLS) and "JSON" in str(e.value)


def test_augmentation_config_json(tmp_path):
    from videoseal_tpu_torch import train
    cfg = {"masks": {"kind": None}, "augs": {"identity": 1, "jpeg": 2}, "augs_params": {}}
    path = str(tmp_path / "augs_identity.json")     # a JSON file is read, whatever its name
    with open(path, "w") as f:
        json.dump(cfg, f)
    assert train.augmentation_config(path) == cfg


def test_recipe_schedule_matches_jax():
    """docs/training.md's stage A schedule at train.py's 1,000 steps an
    epoch: the port's lr equals the JAX package's at every step checked
    (the warmup's end, the TPU runs' 0.98 steps, the last)."""
    from videoseal_tpu.utils.optim import build_lr_schedule as jax_schedule
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.utils.optim import build_lr_schedule
    spec = "CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1"
    ipe = train.get_parser().parse_args([]).iter_per_epoch
    assert ipe == 1000
    port, jx = build_lr_schedule(spec, ipe, 5e-4), jax_schedule(spec, ipe, 5e-4)
    for step in (0, 1, 500, 999, 1000, 1001, 5620, 11080, 14999, 15000):
        np.testing.assert_allclose(port(step), float(jx(step)), rtol=1e-6, atol=2 ** -23 * 5e-4)
    assert port(1000) == pytest.approx(5e-4) and port(15000) == pytest.approx(1e-6)


def test_jax_train_state_refused(tmp_path):
    """A train state the JAX package wrote resumes (test_torch_optim.py);
    one whose treedef holds an optax state the port has no counterpart for
    is refused with ValueError naming it."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    path = str(tmp_path / "jax_state.npz")
    text = "PyTreeDef((CustomNode(namedtuple[ScaleByRssState], [*]),))"
    np.savez(path, **{"__treedef__embedder_params": np.frombuffer(text.encode(), np.uint8),
                      "embedder_params//0": np.zeros(3, np.float32), "step": np.asarray(3)})
    args = train.get_parser().parse_args(["--device", "cpu", "--tiny", "1"])
    _, state, _ = train.build_trainer(args, torch.device("cpu"))
    with pytest.raises(ValueError, match="ScaleByRssState"):
        ckpt_io.load_train_state(path, state)
