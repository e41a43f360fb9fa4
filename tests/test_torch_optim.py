"""The port's lamb and adafactor against optax, and train states the JAX
package wrote, resumed by the port.

* `utils/optim.Lamb` and `Adafactor` against ``optax.lamb`` and
  ``optax.adafactor`` (optax's defaults) over 5 steps on the same
  gradients, on tensors whose second largest axis is below and above
  adafactor's factoring size (128), with and without an lr schedule.
* A JAX TrainState with AdamW, lamb or adafactor after one JAX step,
  written by JAX's ``save_train_state``, restored by the port's
  ``load_train_state``: every parameter, BatchNorm statistic and optimizer
  moment equal to JAX's (only the layout changes), then the next step of
  both packages from it on the same batch and messages.
* Adafactor's factored moments through the layout change (a 64-wide
  discriminator, whose 4x4x128x256 kernel is factored), and the treedef
  text's parser.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import JAX_COMPILE_OPTIONS, _jax_mods, _port_sds
from torch_port import TRAIN_NBITS as NBITS
from torch_port import TRAIN_SIZE as SIZE
from torch_port import port_train_mods, train_weights

torch.set_num_threads(4)

SHAPES = [(6, 5), (256, 130), (130, 1, 7, 7)]   # not factored, factored, factored (O, I)


def _optax_run(tx, p0, grads):
    params, st, out = jnp.asarray(p0), tx.init(jnp.asarray(p0)), []
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, params)
        params = optax.apply_updates(params, upd)
        out.append(np.asarray(params))
    return out


@pytest.mark.parametrize("name", ["lamb", "adafactor"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("schedule", [None, "CosineLRScheduler,lr_min=1e-4,t_initial=3,"
                                            "warmup_lr_init=1e-5,warmup_t=1"])
def test_matches_optax(name, shape, schedule):
    from videoseal_tpu.utils.optim import build_lr_schedule as jax_schedule
    from videoseal_tpu.utils.optim import build_optimizer as jax_optimizer
    from videoseal_tpu_torch.utils.optim import build_lr_schedule, build_optimizer, lr_scheduler
    rng = np.random.default_rng(len(shape))
    p0 = rng.normal(0, 1, shape).astype(np.float32)
    grads = [rng.normal(0, 1, shape).astype(np.float32) for _ in range(5)]
    spec = f"{name},lr=1e-2"
    want = _optax_run(jax_optimizer(spec, schedule=jax_schedule(schedule, 2, 1e-2)
                                    if schedule else None), p0, grads)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = build_optimizer(spec, [p])
    sched = lr_scheduler(opt, build_lr_schedule(schedule, 2, 1e-2)) if schedule else None
    for i, g in enumerate(grads):
        p.grad = torch.from_numpy(g)
        opt.step()
        if sched:
            sched.step()
        # float32 with sums in another order: ~1e-7 of the parameters
        np.testing.assert_allclose(p.detach().numpy(), want[i], rtol=1e-5, atol=1e-6)


def _jax_state(weights, opt):
    from videoseal_tpu.parallel.trainer import TrainState
    ev, xv, dv = weights
    gen = {"embedder": ev["params"], "extractor": xv["params"]}
    return TrainState(step=jnp.zeros((), jnp.int32), embedder_params=ev["params"],
                      embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
                      disc_params=dv["params"], opt_state_g=opt.init(gen),
                      opt_state_d=opt.init(dv["params"]), scaling_w=jnp.float32(0.2))


@pytest.mark.parametrize("spec", ["AdamW,lr=1e-3", "lamb,lr=1e-3", "adafactor,lr=1e-3"])
def test_jax_written_train_state_resumes(tmp_path, spec):
    """The resumed step's losses against JAX's next step (the gradients are
    held against JAX in test_torch_train.py); its update against optax's
    from JAX's optimizer state on the port's own gradients. (Against JAX's
    whole step the parameters agree to ~1e-5 under AdamW and lamb, but
    adafactor's first moments of a row that had no gradient are ~1e-30,
    so its next update is the sign of a gradient that may be rounding.)"""
    from videoseal_tpu.parallel.trainer import make_train_step as jax_make_step
    from videoseal_tpu.utils import checkpoint as jax_ckpt
    from videoseal_tpu.utils.optim import build_optimizer as jax_optimizer
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    from videoseal_tpu_torch.utils.convert import disc_to_jax, to_jax_variables
    weights = train_weights()
    opt = jax_optimizer(spec)
    mods = _jax_mods(False)
    rng = np.random.default_rng(8)
    batches = [{"imgs": jnp.asarray(rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))}
               for _ in range(2)]
    keys = [jax.random.PRNGKey(k) for k in (5, 6)]
    state = _jax_state(weights, opt)
    step = jax_make_step(mods, opt, opt).lower(state, batches[0], keys[0]).compile(
        JAX_COMPILE_OPTIONS)
    state1, _ = step(state, batches[0], keys[0])
    path = str(tmp_path / "jax_state.npz")
    jax_ckpt.save_train_state(path, state1)
    state1 = jax.tree_util.tree_map(np.asarray, state1)     # the step donates its state
    _, jlogs = step(jax.tree_util.tree_map(jnp.asarray, state1), batches[1], keys[1])

    _, pstate = port_train_mods(weights, False, opt=spec)
    ckpt_io.load_train_state(path, pstate)
    assert pstate.step == 1 and pstate.scaling_w == pytest.approx(0.2)
    # the restored modules are JAX's, bit for bit but for the layout
    want = _port_sds({"params": state1.embedder_params, "batch_stats": state1.embedder_stats},
                     {"params": state1.extractor_params}, {"params": state1.disc_params})
    for mod, w in zip((pstate.embedder, pstate.extractor, pstate.discriminator), want):
        for k, v in mod.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, w[k]), k
    msgs = np.asarray(jax.random.randint(jax.random.split(keys[1])[0], (2, NBITS), 0, 2))
    pmods, _ = port_train_mods(weights, False, opt=spec)
    _, plogs = make_train_step(pmods)(pstate, {"imgs": torch.from_numpy(np.asarray(
        batches[1]["imgs"]))}, torch.Generator(), msgs=torch.from_numpy(msgs.astype(np.int64)))
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(plogs[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    # optax's update from JAX's state on the port's gradients
    grads = {n: p.grad for n, p in pstate.embedder.named_parameters()}, \
        {n: p.grad for n, p in pstate.extractor.named_parameters()}
    ge, gx = to_jax_variables(*grads)
    gen = {"embedder": state1.embedder_params, "extractor": state1.extractor_params}
    update = jax.jit(opt.update)       # eager, optax's update dispatches ~1e3 small ops
    upd, _ = update({"embedder": ge["params"], "extractor": gx["params"]},
                    state1.opt_state_g, gen)
    gen = jax.tree_util.tree_map(np.asarray, optax.apply_updates(gen, upd))
    gd = disc_to_jax({n: p.grad for n, p in pstate.discriminator.named_parameters()})
    upd, _ = update(gd["params"], state1.opt_state_d, state1.disc_params)
    disc = jax.tree_util.tree_map(np.asarray, optax.apply_updates(state1.disc_params, upd))
    new = _port_sds({"params": gen["embedder"]}, {"params": gen["extractor"]},
                    {"params": disc})
    for mod, w in zip((pstate.embedder, pstate.extractor, pstate.discriminator), new):
        for k, p in mod.named_parameters():
            torch.testing.assert_close(p.detach(), w[k], rtol=1e-5, atol=1e-6, msg=k)


def test_adafactor_factored_state_from_jax():
    """optax's FactoredState of a discriminator whose widest kernel is
    factored (4x4x128x256 HWIO, the port's 256x128x4x4): resumed by the
    port's Adafactor, the next update equals optax's."""
    from videoseal_tpu_torch.modules.discriminator import NLayerDiscriminator
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    from videoseal_tpu_torch.utils.convert import disc_from_jax, disc_to_jax
    from videoseal_tpu_torch.utils.optim import Adafactor, factored_dims
    disc = NLayerDiscriminator(ndf=64, n_layers=2)
    params = disc_to_jax(disc.state_dict())["params"]
    rng = np.random.default_rng(0)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32),
                                    params) for _ in range(3)]
    tx = optax.adafactor(1e-2)
    st, p = tx.init(params), params
    for g in grads[:2]:
        u, st = tx.update(g, st, p)
        p = optax.apply_updates(p, u)
    u, _ = tx.update(grads[2], st, p)
    want = disc_from_jax({"params": optax.apply_updates(p, u)})
    assert any(factored_dims(tuple(t.shape)) for t in disc.parameters())
    disc.load_state_dict(disc_from_jax({"params": jax.tree_util.tree_map(np.asarray, p)}))
    opt = Adafactor(disc.parameters(), lr=1e-2)
    leaves, treedef = jax.tree_util.tree_flatten(st)
    chain = ckpt_io._nest_paths(dict(zip(ckpt_io.treedef_leaf_paths(repr(treedef)),
                                         map(np.asarray, leaves))))
    ckpt_io._jax_opt_into(opt, chain, params, lambda t: disc_from_jax({"params": t}),
                          [n for n, _ in disc.named_parameters()])
    g3 = disc_from_jax({"params": grads[2]})
    for n, q in disc.named_parameters():
        q.grad = g3[n]
    opt.step()
    for n, q in disc.named_parameters():
        torch.testing.assert_close(q.detach(), want[n], rtol=1e-5, atol=1e-6, msg=n)


def test_treedef_leaf_paths():
    from videoseal_tpu_torch.utils.checkpoint import treedef_leaf_paths
    tree = (optax.ScaleByAdamState(count=jnp.zeros(()), mu={"b": jnp.ones(2), "a": [jnp.ones(1)]},
                                   nu={"b": jnp.ones(2), "a": [jnp.ones(1)]}),
            optax.EmptyState(), {"x": (None, jnp.ones(3))})
    _, treedef = jax.tree_util.tree_flatten(tree)
    assert treedef_leaf_paths(repr(treedef)) == [
        (0, "ScaleByAdamState.count"), (0, "ScaleByAdamState.mu", "a", 0),
        (0, "ScaleByAdamState.mu", "b"), (0, "ScaleByAdamState.nu", "a", 0),
        (0, "ScaleByAdamState.nu", "b"), (2, "x", 1)]
    with pytest.raises(ValueError, match="MaskedState"):
        treedef_leaf_paths("PyTreeDef((CustomNode(namedtuple[MaskedState], [*]),))")
