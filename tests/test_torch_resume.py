"""A resume with the new run's optimizer and schedule, as docs/training.md's
stage B resumes stage A, against the JAX package's rule on the CPU.

The JAX package restores optax's state (each parameter's moments and the
counts) and takes the lr from the new flags' schedule at the restored count.
A stage-A state (the tiny card, the discriminator on, stage A's AdamW and
cosine flags at 2 steps an epoch) is written as the port's ``.npz``, as a
sharded directory and as a train state the JAX package wrote (its optax
trees built from the port's moments, so the three hold the same state).
Each is resumed through `train.main` with stage B's flags and with stage
A's own. Held: the lr of every resumed update against the JAX package's
``build_lr_schedule`` at optax's count (the restored count plus the updates
made), float32 rounding apart; the restored AdamW moments and steps equal
to the saved ones, exactly; with unchanged flags, the param groups and the
schedule's position as the saved state had them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IPE, A_STEPS, B_STEPS = 2, 5, 3
COMMON = ["--device", "cpu", "--tiny", "1", "--synthetic", "1", "--batch_size", "2",
          "--img_size", "64", "--iter_per_epoch", str(IPE), "--eval_freq", "0",
          "--tensorboard", "0", "--lambda_d", "0.1", "--num_augs", "1", "--augmentation_config",
          os.path.join(ROOT, "videoseal_tpu/configs/augs_identity.yaml")]
FLAGS = {   # docs/training.md's optimizer and schedule flags, a stage's loss flags
    "stage_a": ("AdamW,lr=5e-4", "CosineLRScheduler,lr_min=1e-6,t_initial=3,warmup_t=1",
                ["--lambda_i", "0", "--perceptual_loss", "none"]),
    "stage_b": ("AdamW,lr=2e-4", "CosineLRScheduler,lr_min=1e-6,t_initial=100,warmup_t=2",
                ["--lambda_i", "0.1", "--perceptual_loss", "yuv", "--disc_start", "11000"]),
}


def _argv(stage: str) -> list:
    opt, sched, losses = FLAGS[stage]
    return COMMON + losses + ["--optimizer", opt, "--scheduler", sched]


def _jax_lr(stage: str, count: int) -> float:
    from videoseal_tpu.utils.optim import build_lr_schedule, parse_params
    opt, sched, _ = FLAGS[stage]
    return float(build_lr_schedule(sched, IPE, parse_params(opt)["lr"])(count))


def _jax_written(path: str, state) -> None:
    """`state` (the port's) as the JAX package's save_train_state writes
    it: optax's AdamW chains over the converted trees, their moments and
    counts the port's."""
    import optax
    from videoseal_tpu.parallel.trainer import TrainState
    from videoseal_tpu.utils import checkpoint as jax_ckpt
    from videoseal_tpu.utils.optim import build_lr_schedule, build_optimizer
    from videoseal_tpu_torch.utils.checkpoint import _unet_norm
    from videoseal_tpu_torch.utils.convert import disc_to_jax, to_jax_variables

    def moments(opt, named, key):
        return {n: opt.state[p][key] for n, p in named}

    def gen(tree_of):
        e, x = to_jax_variables(tree_of(state.embedder), tree_of(state.extractor),
                                _unet_norm(state.embedder), _unet_norm(state.extractor))
        return {"embedder": e["params"], "extractor": x["params"]}

    ev, xv = to_jax_variables(state.embedder.state_dict(), state.extractor.state_dict(),
                              _unet_norm(state.embedder), _unet_norm(state.extractor))
    dparams = disc_to_jax(state.discriminator.state_dict())["params"]
    opt_spec, sched_spec, _ = FLAGS["stage_a"]
    opt_g = build_optimizer(opt_spec, schedule=build_lr_schedule(sched_spec, IPE, 5e-4))
    opt_d = build_optimizer(train_args("stage_a").optimizer_d)

    def chain(opt, params, mu, nu, count):
        adam, *rest = opt.init(params)
        assert isinstance(adam, optax.ScaleByAdamState)
        rest = [s._replace(count=jnp.int32(count)) if isinstance(s, optax.ScaleByScheduleState)
                else s for s in rest]
        return (adam._replace(count=jnp.int32(count), mu=mu, nu=nu), *rest)

    count = int(state.sched_g.last_epoch)
    d_named = list(state.discriminator.named_parameters())
    d_step = int(state.opt_d.state[d_named[0][1]]["step"])
    jstate = TrainState(
        step=jnp.int32(state.step), embedder_params=ev["params"],
        embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
        disc_params=dparams,
        opt_state_g=chain(opt_g, gen(lambda m: dict(m.named_parameters())),
                          gen(lambda m: moments(state.opt_g, m.named_parameters(), "exp_avg")),
                          gen(lambda m: moments(state.opt_g, m.named_parameters(),
                                                "exp_avg_sq")), count),
        opt_state_d=chain(opt_d, dparams,
                          disc_to_jax(moments(state.opt_d, d_named, "exp_avg"))["params"],
                          disc_to_jax(moments(state.opt_d, d_named, "exp_avg_sq"))["params"],
                          d_step),
        scaling_w=jnp.float32(state.scaling_w))
    jax_ckpt.save_train_state(path, jax.tree_util.tree_map(np.asarray, jstate))


def train_args(stage: str):
    from videoseal_tpu_torch import train
    return train.get_parser().parse_args(_argv(stage))


@pytest.fixture(scope="module")
def stage_a(tmp_path_factory):
    """Stage A's A_STEPS steps through train.main, its state written in
    the three forms: {form: path}, and the state."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    out = str(tmp_path_factory.mktemp("stage_a"))
    state, _, _ = train.main(_argv("stage_a") + ["--steps", str(A_STEPS), "--output_dir", out])
    assert state.step == A_STEPS and state.sched_g.last_epoch == A_STEPS
    assert state.opt_d.state, "the discriminator took no step: its moments go untested"
    paths = {"npz": os.path.join(out, "checkpoint.npz"), "sharded": os.path.join(out, "ckpts"),
             "jax": os.path.join(out, "jax_state.npz")}
    ckpt_io.save_train_state_sharded(paths["sharded"], state)
    _jax_written(paths["jax"], state)
    return paths, state


def _load(path: str, state) -> None:
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    if os.path.isdir(path):
        ckpt_io.load_train_state_sharded(path, state)
    else:
        ckpt_io.load_train_state(path, state)


@pytest.mark.parametrize("stage", ["stage_b", "stage_a"])
@pytest.mark.parametrize("form", ["npz", "sharded", "jax"])
def test_resume_takes_the_new_runs_lr(stage_a, form, stage, tmp_path, monkeypatch):
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.parallel import trainer
    paths, saved = stage_a
    opt_spec = FLAGS[stage][0]
    base = float(opt_spec.split("lr=")[1])

    # what the restore carries, on a state built from the new flags
    _, fresh, _ = train.build_trainer(train_args(stage), torch.device("cpu"))
    _load(paths[form], fresh)
    assert fresh.step == A_STEPS and fresh.sched_g.last_epoch == A_STEPS
    for opt, want in ((fresh.opt_g, saved.opt_g), (fresh.opt_d, saved.opt_d)):
        got, exp = opt.state_dict()["state"], want.state_dict()["state"]
        assert got.keys() == exp.keys()
        for i in exp:
            assert got[i].keys() == exp[i].keys()
            for k in exp[i]:
                assert torch.equal(got[i][k], exp[i][k]), (i, k)

    def hyper(opt):     # a group's hyperparameters (betas a list once through JSON)
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in opt.param_groups[0].items() if k != "params"}

    group = hyper(fresh.opt_g)
    assert group["initial_lr"] == base
    np.testing.assert_allclose(group["lr"], _jax_lr(stage, A_STEPS), rtol=1e-6,
                               atol=2 ** -23 * base)
    if stage == "stage_a":      # unchanged flags: as the saved state stood
        assert group == hyper(saved.opt_g)
        assert fresh.sched_g.get_last_lr() == saved.sched_g.get_last_lr()

    # the lr of each update of the resumed run
    lrs = []
    make_state = trainer.create_train_state

    def recording(*args, **kwargs):
        state = make_state(*args, **kwargs)
        state.opt_g.register_step_pre_hook(
            lambda opt, *_: lrs.append(opt.param_groups[0]["lr"]))
        return state

    monkeypatch.setattr(trainer, "create_train_state", recording)
    state, _, _ = train.main(_argv(stage) + ["--steps", str(B_STEPS), "--resume", paths[form],
                                             "--output_dir", str(tmp_path / "resumed")])
    assert state.step == A_STEPS + B_STEPS and len(lrs) == B_STEPS
    want = [_jax_lr(stage, A_STEPS + k) for k in range(B_STEPS)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=2 ** -23 * base)


def _docs_stage_b() -> list:
    """docs/training.md's stage B command (its verified recipe) as argv,
    without --steps, --resume and --output_dir."""
    import shlex
    text = open(os.path.join(ROOT, "docs/training.md")).read()
    block = text[text.index("Stage B"):text.index("Post-attack")]
    argv = shlex.split(block[block.index("python -m"):].replace("\\\n", " "))[3:]
    drop = {"--steps", "--resume", "--output_dir"}
    return [a for i, a in enumerate(argv) if a not in drop and argv[i - 1] not in drop]


@pytest.mark.parametrize("where", ["chip_smoke", "run_sh"])
def test_stage_b_flags_are_the_recipes(where):
    """chip_smoke.py's STAGE_B_FLAGS and outputs/convergence_torch/stageB/
    run.sh's flags are docs/training.md's stage B flags, in its order."""
    import re
    import shlex
    if where == "chip_smoke":
        import importlib.util
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      os.path.join(ROOT, "chip_smoke.py"))
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        got = list(chip_smoke.STAGE_B_FLAGS)
    else:
        text = open(os.path.join(ROOT, "outputs/convergence_torch/stageB/run.sh")).read()
        got = shlex.split(re.search(r'^FL="([^"]*)"', text, re.M).group(1))
    assert got == _docs_stage_b()
