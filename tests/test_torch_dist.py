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

The ranks of each part run in one spawned group; the tests read its record.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_train import _jax_step, _port_sds
from torch_port import TRAIN_NBITS as NBITS
from torch_port import TRAIN_SIZE as SIZE
from torch_port import (port_train_mods, rank_collectives, rank_train_main, rank_train_steps,
                        same_state, step_record, train_weights)

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


def _batch(is_video: bool, seed: int) -> np.ndarray:
    shape = (2, 4, SIZE, SIZE, 3) if is_video else (4, SIZE, SIZE, 3)
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


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
    cases += [(_batch(v, 21), None, True, v, AUGS, seed) for v in (False, True)
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
    ranks give one process's step on the whole batch."""
    from videoseal_tpu_torch.augmentation.augmenter import build_augmenter
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    idx = len(CASES) + [(False, 1), (False, 2), (True, 1), (True, 2)].index((is_video, seed))
    rec = steps[1][0][idx]
    mods, state = port_train_mods(weights, True, augmenter=build_augmenter(AUGS, num_augs=2))
    _, logs = make_train_step(mods, is_video=is_video)(
        state, {"imgs": torch.from_numpy(_batch(is_video, 21))}, torch.Generator().manual_seed(seed))
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


def test_batch_must_split_over_ranks():
    from videoseal_tpu_torch.parallel.mesh import Mesh, make_mesh
    m = Mesh(rank=1, size=2)
    assert m.shard(6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split"):
        m.shard(5)
    assert make_mesh().size == 1 and make_mesh().group is None
    with pytest.raises(NotImplementedError, match="ROADMAP.md 1.8"):
        make_mesh(n_frames=2)


def test_slurm_first_host():
    from videoseal_tpu_torch.utils.dist import _slurm_first_host
    assert _slurm_first_host("node[3-7,9]") in ("node3",)
    assert _slurm_first_host("gpu-a12") == "gpu-a12"
