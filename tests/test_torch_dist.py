"""Data-parallel training on the CPU: two gloo ranks
(``parallel.launch.run_local``) against the JAX package's step on the whole
batch, and against one process of the port.

* One SGD step at lr 1 on two ranks, each on half of the global batch,
  image and video, balanced 0 and 1, the dummy augmenter, JAX's messages
  injected: the logs, every gradient, the updated parameters and the
  BatchNorm statistics against JAX's step on the whole batch (the
  equivalence JAX's mesh gives by construction), within the tolerances of
  ``test_torch_train.py`` (ROADMAP §3.24: the video gradients to JAX's own
  float32 error).
* The same two ranks with a real augmenter (per-sample masks and noise
  drawn for the global batch and sliced, a frame-mixing codec proxy and
  frame drop on the gathered batch) against one port process on the whole
  batch, from the same generator seed.
* The global-batch BatchNorm forward and backward, the sharded checkpoint
  at world size 1 and 2, the logger's sync and `average_metrics`, and
  `train.main --distributed 1` on two ranks.
* The ("data", "frames") mesh: a video step on a 1x2 and a 2x2 mesh, each
  rank on its frames of its clips, against one port process on the whole
  batch (video_mode repeat and interpolate, a rank's frames not a multiple
  of step_size, a frame-mixing attack, an embedder that mixes frames), and
  the 2x2 step against JAX's step on ``make_mesh(n_data=2, n_frames=2)``
  with the batch sharded on ``frames_axis=1`` (the graft dry run's tiny
  card, the dummy augmenter, JAX's messages injected).

The ranks of each part run in one spawned group; the tests read its record.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_train import JAX_COMPILE_OPTIONS, _jax_step, _port_sds
from torch_port import TRAIN_NBITS as NBITS
from torch_port import TRAIN_EMB_CFG, TRAIN_EXT_CFG
from torch_port import TRAIN_SIZE as SIZE
from torch_port import (port_train_mods, rank_collectives, rank_counted_step, rank_frames_steps,
                        rank_train_main, rank_train_steps, same_state, step_record,
                        train_weights)

torch.set_num_threads(2)

LOG_RTOL, LOG_ATOL = 1e-4, 1e-6
GRAD_RTOL, GRAD_RTOL_VIDEO, GRAD_ATOL, PARAM_ATOL = 1e-4, 3e-2, 1e-6, 1e-6
# two ranks against one port process: the same float32 arithmetic but for
# the order of the cross-rank sums (BatchNorm's statistics, the gradients'
# mean, the balance's norms); measured ~1e-7 on the logs
DDP_LOG_RTOL, DDP_GRAD_RTOL = 1e-5, 1e-4
CASES = [(False, 0), (False, 1), (True, 0), (True, 1)]     # (is_video, balanced)
# per-sample draws (masks, noise) and frame-mixing attacks (the codec proxy,
# frame drop) in one config: two draws a step
AUGS = {"masks": {"kind": "mixed", "invert_proba": 0.5},
        "augs": {"gaussian_noise": 1, "crop": 1, "h264": 1, "drop_frame": 1},
        "augs_params": {"gaussian_noise": {"min_std": 0.01, "max_std": 0.05}}}


def _batch(is_video: bool, seed: int, dtype=np.float32) -> np.ndarray:
    shape = (2, 4, SIZE, SIZE, 3) if is_video else (4, SIZE, SIZE, 3)
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(dtype)


@pytest.fixture(scope="module")
def weights():
    return train_weights()


@pytest.fixture(scope="module")
def steps(weights):
    """(JAX's step of each case, every two-rank step): the ranks run in one
    spawned group (the JAX cases with the dummy augmenter and JAX's
    messages, then the augmenter cases) while JAX compiles its steps."""
    import concurrent.futures

    import jax

    from videoseal_tpu_torch.parallel.launch import run_local
    key = jax.random.split(jax.random.PRNGKey(3))[0]   # _jax_step's message draw
    cases = [(_batch(v, 11), np.asarray(jax.random.randint(key, (2 if v else 4, NBITS), 0, 2),
                                        np.int64), bool(b), v, None, 0) for v, b in CASES]
    cases += [(_batch(v, 21, np.float64), None, True, v, AUGS, seed) for v in (False, True)
              for seed in (1, 2)]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_local, rank_train_steps, 2, weights, cases)
        jax_steps = {c: _jax_step(weights, bool(c[1]), c[0], "both", _batch(c[0], 11), seed=3)
                     for c in CASES}
        ranks = ranks.result()
    for (v, b), case in zip(CASES, cases):
        assert np.array_equal(jax_steps[(v, b)][2], case[1])
    return jax_steps, ranks


def _close(got: dict, want: dict, rtol: float) -> None:
    """Each gradient within rtol of its module's largest gradient: with the
    balance's scales (up to ~6e5 here) a gradient before a BatchNorm is
    mostly cancellation, so the cross-rank sums' other order moves it by up
    to ~7e-4 of its own largest (measured) and ~4e-5 of its module's, as
    chip_smoke.py's phase 17 holds the card against the CPU."""
    scale = {m: max(float(w.abs().max()) for k, w in want.items() if k.startswith(m))
             for m in ("0.", "1.", "2.")}
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= rtol * scale[k[:2]] + GRAD_ATOL, (k, err, scale[k[:2]])


@pytest.mark.parametrize("is_video,balanced", CASES)
def test_two_ranks_match_jax_step(weights, steps, is_video, balanced):
    jax_steps, ranks = steps
    jlogs, jnew, _ = jax_steps[(is_video, balanced)]
    rec = ranks[0][CASES.index((is_video, balanced))]
    other = ranks[1][CASES.index((is_video, balanced))]
    assert set(rec["logs"]) == set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(rec["logs"][k], v, rtol=LOG_RTOL, atol=LOG_ATOL, err_msg=k)
        assert other["logs"][k] == rec["logs"][k], k    # the logs are the group's mean
    # both ranks end with the same parameters and statistics
    for part in ("params", "bn"):
        for k, v in rec[part].items():
            assert torch.equal(other[part][k], v), k
    old, new = _port_sds(*weights), _port_sds(*jnew)
    rtol = GRAD_RTOL_VIDEO if is_video else GRAD_RTOL
    for i in range(3):
        for name, o in old[i].items():
            key = f"{i}.{name}"
            if key not in rec["params"]:
                continue
            want_g = o - new[i][name]
            tol = rtol * float(want_g.abs().max()) + GRAD_ATOL
            torch.testing.assert_close(rec["grads"][key], want_g, rtol=0, atol=tol, msg=key)
            torch.testing.assert_close(rec["params"][key], new[i][name], rtol=0,
                                       atol=tol + PARAM_ATOL, msg=key)
    for k, v in rec["bn"].items():
        torch.testing.assert_close(v, new[0][k], rtol=1e-5, atol=1e-5, msg=k)


@pytest.mark.parametrize("is_video,seed", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_two_ranks_match_one_process_with_augmenter(weights, steps, is_video, seed):
    """The augmenter's draws made for the global batch on every rank: two
    ranks give one process's step on the whole batch. Both in float64, as
    the frames mesh's steps below: in float32 the sums' other order alone
    moves a gradient before a BatchNorm by up to 2.1e-4 of its module's
    largest (measured on the video case at seed 2 with the one process at 1
    thread, 1.4e-5 at 4), in float64 by 1.8e-14, so float64 shows the
    sharding's arithmetic."""
    from videoseal_tpu_torch.augmentation.augmenter import build_augmenter
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    idx = len(CASES) + [(False, 1), (False, 2), (True, 1), (True, 2)].index((is_video, seed))
    rec = steps[1][0][idx]
    mods, state = port_train_mods(weights, True, augmenter=build_augmenter(AUGS, num_augs=2),
                                  dtype=torch.float64)
    _, logs = make_train_step(mods, is_video=is_video)(
        state, {"imgs": torch.from_numpy(_batch(is_video, 21, np.float64))},
        torch.Generator().manual_seed(seed))
    one = step_record(state, logs)
    for k, v in one["logs"].items():
        np.testing.assert_allclose(rec["logs"][k], v, rtol=DDP_LOG_RTOL, atol=LOG_ATOL, err_msg=k)
    _close(rec["grads"], one["grads"], DDP_GRAD_RTOL)
    for k, v in one["bn"].items():
        torch.testing.assert_close(rec["bn"][k], v, rtol=1e-5, atol=1e-6, msg=k)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    from videoseal_tpu_torch.parallel.launch import run_local
    x = np.random.default_rng(4).normal(1.5, 2.0, (4, 3, 5, 6)).astype(np.float32)
    return x, run_local(rank_collectives, 2, x, str(tmp_path_factory.mktemp("sharded")))


def test_global_batchnorm_matches_one_process(collectives):
    """Two ranks' outputs, input gradients and parameter gradients (summed
    over the ranks, as the step averages the ranks' means) against one
    BatchNorm2d on the whole batch; the running statistics updated with the
    global batch's mean and biased variance."""
    import torch.nn.functional as F

    from videoseal_tpu_torch.modules.common import BatchNorm2d
    x, res = collectives
    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        bn.bias.normal_(generator=torch.Generator().manual_seed(1))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    w = torch.cat([torch.linspace(-1, 1, y[:2].numel()).view(y[:2].shape[::-1]).permute(3, 2, 1, 0)
                   + r for r in (0, 1)])
    F.relu(y * w).sum().backward()
    torch.testing.assert_close(torch.cat([r["y"] for r in res]), y.detach(), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(torch.cat([r["dx"] for r in res]), xt.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(res[0]["dw"] + res[1]["dw"], bn.weight.grad, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(res[0]["db"] + res[1]["db"], bn.bias.grad, rtol=1e-5, atol=1e-5)
    for r in res:
        torch.testing.assert_close(r["running"][0], bn.running_mean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(r["running"][1], bn.running_var, rtol=1e-6, atol=1e-6)


def test_gather_logger_sync_and_average_metrics(collectives):
    x, res = collectives
    for r in res:
        torch.testing.assert_close(r["gathered"], torch.from_numpy(x) * 2.0, rtol=0, atol=0)
        assert r["avg"] == {"m": 1.5}
        assert r["meters"] == {"a": (1.0, 2), "b": (2.0, 2)}


def test_sharded_checkpoint_two_ranks(collectives):
    """Saved collectively by two ranks, restored on both: every module
    tensor, the optimizer's state, the step and scaling_w equal."""
    _, res = collectives
    assert [r["loaded_step"] for r in res] == [7, 7]
    assert all(r["same"] for r in res)


def test_sharded_checkpoint_one_process(tmp_path):
    """Without a process group: ckpt_dir/<step>/, the newest 3 kept, the
    latest restored by default and any kept step on request."""
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    w = train_weights()
    _, state = port_train_mods(w, False, opt="lamb,lr=1e-3")
    for step in range(1, 6):
        for p in state.extractor.parameters():
            p.grad = torch.full_like(p, 0.1 * step)
        state.opt_g.step()
        state.step = step
        ckpt_io.save_train_state_sharded(str(tmp_path), state)
    assert ckpt_io.checkpoint_steps(str(tmp_path)) == [3, 4, 5]
    _, fresh = port_train_mods(w, False, opt="lamb,lr=1e-3")
    assert ckpt_io.load_train_state_sharded(str(tmp_path), fresh) == 5
    assert same_state(state, fresh)
    _, older = port_train_mods(w, False, opt="lamb,lr=1e-3")
    assert ckpt_io.load_train_state_sharded(str(tmp_path), older, step=3) == 3
    assert older.step == 3 and not same_state(state, older)


def test_train_main_distributed(tmp_path):
    """`train.main --distributed 1` on two gloo ranks (the group made by
    run_local): rank 0 alone writes the log and the eval rows, the sharded
    checkpoint resumes on both, and the ranks hold the same weights."""
    from videoseal_tpu_torch.parallel.launch import run_local
    out = str(tmp_path / "run")
    res = run_local(rank_train_main, 2, out)
    assert [r["step"] for r in res] == [2, 2] and [r["resumed"] for r in res] == [3, 3]
    assert all(r["n_ms"] == 2 for r in res)
    for k, v in res[0]["saved"].items():
        assert torch.equal(res[1]["saved"][k], v), k
    assr = os.listdir(os.path.join(out, "ckpts"))
    assert sorted(assr) == ["2", "3"]
    rows = open(os.path.join(out, "eval.jsonl")).read().splitlines()
    assert len(rows) == 2        # one eval a run, written once (rank 0)


def test_one_rank_runs_the_collectives(weights):
    """A process group of one rank (`train.main --distributed 1` at world
    size 1) still runs the step's collectives: the global BatchNorm's
    forward and backward reductions, the balance's norms, both optimizers'
    gradient means and the logs' mean, and gives one process's step."""
    from videoseal_tpu_torch.parallel.launch import run_local
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    imgs = _batch(False, 11)
    (res,) = run_local(rank_counted_step, 1, weights, imgs)
    assert res["bn_layers"] > 0 and res["bn_grouped"]
    assert res["all_reduces"] == 2 * res["bn_layers"] + 4
    mods, state = port_train_mods(weights, True)
    _, logs = make_train_step(mods)(state, {"imgs": torch.from_numpy(imgs)},
                                    torch.Generator().manual_seed(1))
    one, got = step_record(state, logs), res["record"]
    for k, v in one["logs"].items():
        assert abs(got["logs"][k] - v) <= DDP_LOG_RTOL * max(abs(v), 1e-6), k
    for k, g in one["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=0,
                                   atol=DDP_GRAD_RTOL * float(g.abs().max()) + GRAD_ATOL,
                                   err_msg=k)


def test_batch_must_split_over_ranks(frames_steps):
    from videoseal_tpu_torch.parallel.mesh import Mesh, make_mesh
    m = Mesh(rank=1, size=2)
    assert m.shard(6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split"):
        m.shard(5)
    assert make_mesh().size == 1 and make_mesh().group is None
    with pytest.raises(ValueError, match="without a process group"):
        make_mesh(n_frames=2)
    # make_mesh(n_frames=2) on two ranks: a working 1x2 mesh
    facts = [f for f, _ in frames_steps[0][(1, 2)]]
    assert [f["axes"] for f in facts] == [(0, 1, 0, 2, 2), (0, 1, 1, 2, 2)]
    m = Mesh(rank=1, size=2, frames_rank=1, frames_size=2)
    assert m.frames_shard(6) == slice(3, 6)
    assert m.rows(1, 3).tolist() == [9, 10, 11]     # clip 1 of 2, frames 3..5 of 6


def test_slurm_first_host():
    from videoseal_tpu_torch.utils.dist import _slurm_first_host
    assert _slurm_first_host("node[3-7,9]") in ("node3",)
    assert _slurm_first_host("gpu-a12") == "gpu-a12"


# -- the frames axis ----------------------------------------------------------------------

# a frame-mixing attack (twice a step) after per-sample masks
FRAMES_AUGS = {"masks": {"kind": "mixed", "invert_proba": 0.5},
               "augs": {"temporal_reorder": 1}, "augs_params": {}}
# (video_mode, frames per clip, conv_layer, augs, balanced)
FRAMES_CASES = [("repeat", 8, "conv2d", None, False),
                ("interpolate", 8, "conv2d", FRAMES_AUGS, True),
                ("interpolate", 6, "conv2d", FRAMES_AUGS, True),   # 3 frames a rank, step 2
                ("repeat", 8, "conv2p1d", FRAMES_AUGS, True)]     # the embedder mixes frames
MESHES = [(1, 2), (2, 2)]
GRAFT_NBITS, GRAFT_SIZE = 16, 32      # __graft_entry__.py's dry run


def _clips(n_clips: int, n_frames: int, size: int, seed: int, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (n_clips, n_frames, size, size, 3)).astype(dtype)


def _jax_mesh_step(weights, imgs, n_data, n_frames, seed=0):
    """JAX's video step at SGD lr 1 on the graft dry run's tiny card, the
    batch sharded over make_mesh(n_data, n_frames) on the CPU devices:
    (logs, new variables as numpy, msgs)."""
    import jax
    import jax.numpy as jnp
    import optax

    from videoseal_tpu.parallel import mesh as pmesh
    from videoseal_tpu.parallel.trainer import TrainState, make_train_step
    ev, xv, dv = weights
    from videoseal_tpu.augmentation.augmenter import get_dummy_augmenter
    from videoseal_tpu.losses.videosealloss import VideoSealLoss
    from videoseal_tpu.models.embedder import build_embedder
    from videoseal_tpu.models.extractor import build_extractor
    from videoseal_tpu.models.videoseal import PipelineConfig
    from videoseal_tpu.modules.discriminator import NLayerDiscriminator
    from videoseal_tpu.modules.jnd import JND
    from videoseal_tpu.parallel.trainer import TrainerModules
    mods = TrainerModules(
        embedder=build_embedder("unet_tiny_yuv", TRAIN_EMB_CFG, GRAFT_NBITS, 2).module,
        extractor=build_extractor("convnext_tiny", TRAIN_EXT_CFG, GRAFT_SIZE,
                                  GRAFT_NBITS).module,
        discriminator=NLayerDiscriminator(ndf=8, n_layers=2), augmenter=get_dummy_augmenter(),
        attenuation=JND(), cfg=PipelineConfig(img_size=GRAFT_SIZE, chunk_size=4, step_size=2,
                                              yuv=True, nbits=GRAFT_NBITS),
        loss=VideoSealLoss(balanced=True, total_norm=1.0, percep_loss="yuv",
                           decode_weight=1.0, detect_weight=0.0),
        balanced=True)
    og, od = optax.sgd(1.0), optax.sgd(1.0)
    gen = {"embedder": ev["params"], "extractor": xv["params"]}
    state = TrainState(step=jnp.zeros((), jnp.int32), embedder_params=ev["params"],
                       embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
                       disc_params=dv["params"], opt_state_g=og.init(gen),
                       opt_state_d=od.init(dv["params"]), scaling_w=jnp.float32(0.2))
    key = jax.random.PRNGKey(seed)
    msgs = np.asarray(jax.random.randint(jax.random.split(key)[0],
                                         (imgs.shape[0], GRAFT_NBITS), 0, 2))
    mesh = pmesh.make_mesh(n_data=n_data, n_frames=n_frames,
                           devices=jax.devices("cpu")[:n_data * n_frames])
    with mesh:
        state = jax.device_put(state, pmesh.replicated(mesh))
        batch = pmesh.shard_batch(mesh, {"imgs": jnp.asarray(imgs)}, frames_axis=1)
        assert batch["imgs"].sharding.spec[:2] == ("data", "frames")
        step = make_train_step(mods, og, od, is_video=True).lower(
            state, batch, key).compile(JAX_COMPILE_OPTIONS)
        new, logs = step(state, batch, key)
        new = jax.tree_util.tree_map(np.asarray, new)
    return ({k: float(v) for k, v in logs.items()},
            ({"params": new.embedder_params, "batch_stats": new.embedder_stats},
             {"params": new.extractor_params}, {"params": new.disc_params}), msgs)


@pytest.fixture(scope="module")
def frames_steps(weights):
    """({(n_data, n_frames): each rank's (facts, records)}, JAX's 2x2 step,
    the graft card's weights): the 1x2 and the 2x2 groups run one after the
    other while JAX compiles its step."""
    import concurrent.futures

    from videoseal_tpu_torch.parallel.launch import run_local
    gw = train_weights(GRAFT_NBITS, GRAFT_SIZE)
    g_imgs = _clips(2, 8, GRAFT_SIZE, 31)

    def groups(jax_msgs):
        out = {}
        for nd, nf in MESHES:
            cases = [(weights, _clips(nd, f, SIZE, 30 + i, np.float64), None, bal, mode, conv,
                      augs, i + 1, NBITS, SIZE)
                     for i, (mode, f, conv, augs, bal) in enumerate(FRAMES_CASES)]
            if (nd, nf) == (2, 2):
                cases.append((gw, g_imgs, jax_msgs, True, "repeat", "conv2d", None, 0,
                              GRAFT_NBITS, GRAFT_SIZE))
            out[(nd, nf)] = run_local(rank_frames_steps, nd * nf, nd, nf, cases)
        return out

    import jax
    key = jax.random.split(jax.random.PRNGKey(0))[0]       # _jax_mesh_step's message draw
    jax_msgs = np.asarray(jax.random.randint(key, (2, GRAFT_NBITS), 0, 2), np.int64)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(groups, jax_msgs)
        jax_step = _jax_mesh_step(gw, g_imgs, 2, 2)
        ranks = ranks.result()
    assert np.array_equal(jax_step[2], jax_msgs)
    return ranks, jax_step, gw


@pytest.mark.parametrize("n_data,n_frames", MESHES)
def test_frames_mesh_gathers_clips(frames_steps, n_data, n_frames):
    """Each rank's (data, frames) place, and its clip gathered from its
    frames ranks' blocks by ``gather_frames``."""
    facts = [f for f, _ in frames_steps[0][(n_data, n_frames)]]
    assert [f["axes"] for f in facts] == [(r // n_frames, n_data, r % n_frames, n_frames,
                                           n_data * n_frames) for r in range(len(facts))]
    for f in facts:
        assert torch.equal(f["clip"], f["want"])


@pytest.mark.parametrize("n_data,n_frames", MESHES)
@pytest.mark.parametrize("case", range(len(FRAMES_CASES)))
def test_frames_step_matches_one_process(weights, frames_steps, n_data, n_frames, case):
    """A video step on a frames-sharded mesh, every rank on its frames of
    its clips, against one port process on the whole batch from the same
    generator seed: the logs, every gradient and the BatchNorm statistics,
    the same on every rank. Both run in float64: in float32 the order of
    the cross-rank sums alone moves a gradient before a BatchNorm by up to
    5e-3 of its own largest (one process at 1 and at 2 threads differs as
    much at 2x2), so float64 shows the sharding's arithmetic; the float32
    step on the mesh is held against JAX's below and on the card."""
    from videoseal_tpu_torch.augmentation.augmenter import build_augmenter
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    mode, f, conv, augs, balanced = FRAMES_CASES[case]
    recs = [r[case] for _, r in frames_steps[0][(n_data, n_frames)]]
    aug = build_augmenter(augs, num_augs=2) if augs else None
    mods, state = port_train_mods(weights, balanced, augmenter=aug, video_mode=mode,
                                  conv_layer=conv, dtype=torch.float64)
    _, logs = make_train_step(mods, is_video=True)(
        state, {"imgs": torch.from_numpy(_clips(n_data, f, SIZE, 30 + case, np.float64))},
        torch.Generator().manual_seed(case + 1))
    one = step_record(state, logs)
    rec = recs[0]
    for k, v in one["logs"].items():
        np.testing.assert_allclose(rec["logs"][k], v, rtol=DDP_LOG_RTOL, atol=LOG_ATOL, err_msg=k)
    _close(rec["grads"], one["grads"], DDP_GRAD_RTOL)
    for k, v in one["bn"].items():
        torch.testing.assert_close(rec["bn"][k], v, rtol=1e-5, atol=1e-6, msg=k)
    for other in recs[1:]:
        assert other["logs"] == rec["logs"]
        for k, v in rec["params"].items():
            assert torch.equal(other["params"][k], v), k


def test_frames_step_matches_jax_mesh(frames_steps):
    """The port's 2x2 step against JAX's on the same 2x2 mesh (the batch
    sharded on data and frames), within test_torch_train.py's video
    tolerance (ROADMAP §3.24)."""
    ranks, (jlogs, jnew, _), gw = frames_steps
    rec = ranks[(2, 2)][0][1][len(FRAMES_CASES)]
    assert set(rec["logs"]) == set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(rec["logs"][k], v, rtol=LOG_RTOL, atol=LOG_ATOL, err_msg=k)
    old, new = _port_sds(*gw), _port_sds(*jnew)
    for i in range(3):
        for name, o in old[i].items():
            key = f"{i}.{name}"
            if key not in rec["params"]:
                continue
            want_g = o - new[i][name]
            tol = GRAD_RTOL_VIDEO * float(want_g.abs().max()) + GRAD_ATOL
            torch.testing.assert_close(rec["grads"][key], want_g, rtol=0, atol=tol, msg=key)
    for k, v in rec["bn"].items():
        torch.testing.assert_close(v, new[0][k], rtol=1e-5, atol=1e-5, msg=k)
