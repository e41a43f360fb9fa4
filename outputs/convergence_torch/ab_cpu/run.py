"""docs/training.md's stage A in both packages at once on the CPU, from the
same start: the JAX package's `make_train_step` and the port's, in float32,
side by side in one process.

* The start: flax's own `init` of the JAX modules (`create_train_state` at
  --seed), carried into the port's modules by
  `utils/convert.from_jax_variables`.
* The batches: both packages' `SyntheticImages(4096, img_size, seed)`,
  quantised to u8 as both `train.py`s keep their pools, indices drawn by
  `default_rng(seed + 7)` as both `train.py`s draw them (every batch's two
  copies are checked equal).
* The messages: JAX's, drawn inside its step from the step key (as
  `train.py` splits it), given to the port's step through `msgs=`.
* The recipe's flags (`docs/training.md:71-81`): the `augs_identity` pool,
  AdamW at lr 5e-4 under the warmup-cosine schedule, scaling_w 1.0, the
  decode loss only.

Two modes:

    python outputs/convergence_torch/ab_cpu/run.py trajectory --out DIR
        videoseal_1.0 at full width, 32 bits, 128 px, batch 8, 200 steps.
        Besides JAX and the port, a third run: the port from the same start
        with every weight moved by one float32 ulp (the chaos baseline).
        Each step's line in DIR/trajectory.jsonl holds the three runs'
        loss_decode, bit_acc and psnr, and per module the relative
        parameter distance |theta_a - theta_b| / |theta_b| of port to JAX
        and of the moved port to the port.

    python outputs/convergence_torch/ab_cpu/run.py stall --seed S --out DIR
        JAX and the port from seed S's start at 64 px, batch 8, 1,000 steps,
        the schedule's epoch scaled to 1,000 / 15 steps so that it keeps its
        shape (card_stall.sh runs the port alike on the card);
        DIR/stall_S.jsonl logs both every 10 steps, and its last line the
        windowed median of bit_acc (the train logs' statistic) at the end.
        ~1.6 s a step on 8 cores (JAX 1.05, the port 0.5).

    python outputs/convergence_torch/ab_cpu/run.py table DIR
        the tables of both modes from what DIR holds.

Run from the repository's root with JAX on the CPU (JAX_PLATFORMS=cpu).
"""

import argparse
import glob
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

RECIPE = ["--card", "videoseal_1.0", "--nbits", "32", "--synthetic", "1", "--num_augs", "1",
          "--lambda_d", "0", "--lambda_i", "0", "--perceptual_loss", "none",
          "--scaling_w", "1.0", "--optimizer", "AdamW,lr=5e-4",
          "--scheduler", "CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1",
          "--augmentation_config", "videoseal_tpu/configs/augs_identity.yaml"]
POOL = 4096
WINDOW = 20          # utils/logger's window: the median of the last 20 logged values


def flags(seed: int, img_size: int, batch_size: int, iter_per_epoch: int) -> list:
    return RECIPE + ["--seed", str(seed), "--img_size", str(img_size),
                     "--batch_size", str(batch_size), "--iter_per_epoch", str(iter_per_epoch)]


def jax_trainer(argv: list):
    """(state, step) of the JAX package as its train.main builds them."""
    import jax
    import yaml
    from videoseal_tpu import train as jtrain
    from videoseal_tpu.augmentation.augmenter import build_augmenter
    from videoseal_tpu.losses.videosealloss import VideoSealLoss
    from videoseal_tpu.models.embedder import build_embedder
    from videoseal_tpu.models.extractor import build_extractor
    from videoseal_tpu.models.videoseal import PipelineConfig
    from videoseal_tpu.modules.discriminator import NLayerDiscriminator
    from videoseal_tpu.modules.jnd import build_attenuation
    from videoseal_tpu.parallel.trainer import (TrainerModules, create_train_state,
                                                make_train_step)
    from videoseal_tpu.utils.cfg import load_card
    from videoseal_tpu.utils.optim import build_lr_schedule, build_optimizer, parse_params

    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    args = jtrain.get_parser().parse_args(argv)
    card = load_card(args.card)
    cargs = card["args"]
    emb = build_embedder(card["embedder"]["model"], card["embedder"]["params"], args.nbits,
                         float(cargs.get("hidden_size_multiplier", 2)))
    ext = build_extractor(card["extractor"]["model"], card["extractor"]["params"],
                          args.img_size, args.nbits)
    with open(args.augmentation_config) as f:
        aug_cfg = yaml.safe_load(f)
    mods = TrainerModules(
        embedder=emb.module, extractor=ext.module,
        discriminator=NLayerDiscriminator(n_layers=args.disc_num_layers),
        augmenter=build_augmenter(aug_cfg, num_augs=args.num_augs),
        attenuation=build_attenuation(args.attenuation),
        cfg=PipelineConfig(img_size=args.img_size, yuv=emb.yuv, nbits=args.nbits,
                           blending_method=cargs.get("blending_method", "additive")),
        loss=VideoSealLoss(balanced=bool(args.balanced), total_norm=args.total_gnorm,
                           disc_weight=args.lambda_d, percep_weight=args.lambda_i,
                           detect_weight=args.lambda_det, decode_weight=args.lambda_dec,
                           disc_start=args.disc_start, percep_loss=args.perceptual_loss),
        scaling_i=args.scaling_i, temperature=args.temperature, balanced=bool(args.balanced))
    sched = build_lr_schedule(args.scheduler, args.iter_per_epoch,
                              parse_params(args.optimizer).get("lr", 1e-4))
    opt_g = build_optimizer(args.optimizer, schedule=sched)
    opt_d = build_optimizer(args.optimizer_d)
    state = create_train_state(mods, opt_g, opt_d, seed=args.seed, scaling_w=args.scaling_w)
    return state, make_train_step(mods, opt_g, opt_d, is_video=False, mode="both")


def port_trainer(argv: list, jstate, nudge: bool = False):
    """(state, step) of the port as its train.main builds them, the
    embedder and extractor then loaded with the JAX state's variables;
    `nudge` moves every loaded floating parameter by one float32 ulp
    towards +inf."""
    import torch
    from videoseal_tpu_torch import train as ptrain
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    from videoseal_tpu_torch.utils.convert import from_jax_variables

    args = ptrain.get_parser().parse_args(argv + ["--device", "cpu"])
    mods, state, _ = ptrain.build_trainer(args, torch.device("cpu"))
    esd, xsd = from_jax_variables(*jax_variables(jstate))
    mods.embedder.load_state_dict(esd)
    mods.extractor.load_state_dict(xsd)
    if nudge:
        with torch.no_grad():
            for m in (mods.embedder, mods.extractor):
                for p in m.parameters():
                    p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    return state, make_train_step(mods, is_video=False, mode="both")


def jax_variables(jstate) -> tuple:
    return ({"params": np_tree(jstate.embedder_params),
             "batch_stats": np_tree(jstate.embedder_stats)},
            {"params": np_tree(jstate.extractor_params)})


def np_tree(tree):
    import jax
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def group(name: str, module: str) -> str:
    """A parameter's module for the distances: the embedder's or the
    extractor's first two name parts."""
    return module + "." + ".".join(name.split(".")[:2])


def param_sets(state) -> dict:
    """{module group: [tensors]} of the port state's embedder and extractor."""
    out = {}
    for module, m in (("embedder", state.embedder), ("extractor", state.extractor)):
        for n, p in m.named_parameters():
            out.setdefault(module, []).append((n, p.detach()))
            out.setdefault(group(n, module), []).append((n, p.detach()))
    return out


def distances(a: dict, b: dict) -> dict:
    """|a - b| / |b| per module group, a and b {group: [(name, tensor)]}
    with the same names."""
    import torch
    out = {}
    for g, pairs in b.items():
        ref = dict(pairs)
        num = sum(float(torch.sum((p.double() - ref[n].double()) ** 2)) for n, p in a[g])
        den = sum(float(torch.sum(p.double() ** 2)) for _, p in pairs)
        out[g] = (num / den) ** 0.5 if den else 0.0
    return out


def jax_param_sets(jstate) -> dict:
    """The JAX state's embedder and extractor parameters by the port's
    names, as param_sets groups them."""
    from videoseal_tpu_torch.utils.convert import from_jax_variables
    esd, xsd = from_jax_variables(*jax_variables(jstate))
    out = {}
    for module, sd in (("embedder", esd), ("extractor", xsd)):
        for n, t in sd.items():
            if n.endswith(("running_mean", "running_var", "num_batches_tracked")):
                continue
            out.setdefault(module, []).append((n, t))
            out.setdefault(group(n, module), []).append((n, t))
    return out


class Batches:
    """Both packages' pools, drawn as both train.py's draw them."""

    def __init__(self, seed: int, img_size: int, batch_size: int):
        from videoseal_tpu.data.datasets import SyntheticImages as JaxImages
        from videoseal_tpu_torch.data.datasets import SyntheticImages as PortImages
        self.jds = JaxImages(POOL, img_size=img_size, seed=seed)
        self.pds = PortImages(POOL, img_size=img_size, seed=seed)
        self.rng = np.random.default_rng(seed + 7)
        self.bs = batch_size

    def next(self):
        idx = self.rng.integers(0, POOL, self.bs)
        u8 = lambda ds: np.stack([np.clip(ds[int(i)][0] * 255.0, 0, 255).astype(np.uint8)
                                  for i in idx])
        j, p = u8(self.jds), u8(self.pds)
        if not np.array_equal(j, p):
            raise AssertionError("the two packages' synthetic images differ")
        return j.astype(np.float32) * np.float32(1.0 / 255.0), p.astype(np.float32) * np.float32(
            1.0 / 255.0)


def jax_msgs(key, n: int, nbits: int) -> np.ndarray:
    """The messages JAX's step draws from its step key (trainer.py:187-190)."""
    import jax
    k_msg, _ = jax.random.split(key)
    return np.asarray(jax.random.randint(k_msg, (n, nbits), 0, 2))


def scalars(logs) -> dict:
    return {k: float(logs[k]) for k in ("loss_decode", "bit_acc", "psnr")}


def trajectory(a):
    import jax
    import jax.numpy as jnp
    import torch
    torch.set_num_threads(a.threads)
    argv = flags(a.seed, a.img_size, a.batch_size, a.iter_per_epoch)
    os.makedirs(a.out, exist_ok=True)
    t0 = time.time()
    jstate, jstep = jax_trainer(argv)
    pstate, pstep = port_trainer(argv, jstate)
    ustate, ustep = port_trainer(argv, jstate, nudge=True)
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    d0 = distances(param_sets(ustate), param_sets(pstate))
    print("ulp move at step 0:", {k: v for k, v in d0.items() if "." not in k}, flush=True)
    batches = Batches(a.seed, a.img_size, a.batch_size)
    key = jax.random.PRNGKey(a.seed)
    gen = torch.Generator().manual_seed(a.seed)
    path = os.path.join(a.out, "trajectory.jsonl")
    with open(path, "w") as f:
        for it in range(a.steps):
            t = time.time()
            key, k = jax.random.split(key)
            jimgs, pimgs = batches.next()
            msgs = torch.from_numpy(jax_msgs(k, a.batch_size, 32).copy())
            jstate, jlogs = jstep(jstate, {"imgs": jnp.asarray(jimgs)}, k)
            g_before = gen.get_state()
            _, plogs = pstep(pstate, {"imgs": torch.from_numpy(pimgs)}, gen, msgs=msgs)
            drew = not torch.equal(g_before, gen.get_state())
            _, ulogs = ustep(ustate, {"imgs": torch.from_numpy(pimgs.copy())}, gen, msgs=msgs)
            pset = param_sets(pstate)
            row = {"step": it + 1, "jax": scalars(jlogs), "port": scalars(plogs),
                   "ulp": scalars(ulogs), "lr": pstate.opt_g.param_groups[0]["lr"],
                   "port_vs_jax": distances(pset, jax_param_sets(jstate)),
                   "ulp_vs_port": distances(param_sets(ustate), pset),
                   "port_step_drew": drew, "s": round(time.time() - t, 2)}
            f.write(json.dumps(row) + "\n")
            f.flush()
            if it % 10 == 0 or it == a.steps - 1:
                print(json.dumps({k: row[k] for k in ("step", "jax", "port", "ulp", "s")}),
                      {m: (round(row["port_vs_jax"][m], 9), round(row["ulp_vs_port"][m], 9))
                       for m in ("embedder", "extractor")}, flush=True)
    print(f"done in {time.time() - t0:.1f} s", flush=True)


def stall(a):
    import jax
    import jax.numpy as jnp
    import torch
    torch.set_num_threads(a.threads)
    argv = flags(a.seed, a.img_size, a.batch_size, a.iter_per_epoch)
    os.makedirs(a.out, exist_ok=True)
    t0 = time.time()
    jstate, jstep = jax_trainer(argv)
    pstate, pstep = port_trainer(argv, jstate)
    batches = Batches(a.seed, a.img_size, a.batch_size)
    key = jax.random.PRNGKey(a.seed)
    gen = torch.Generator().manual_seed(a.seed)
    logged = {"jax": [], "port": []}
    path = os.path.join(a.out, f"stall_{a.seed}.jsonl")
    with open(path, "w") as f:
        for it in range(a.steps):
            key, k = jax.random.split(key)
            jimgs, pimgs = batches.next()
            msgs = torch.from_numpy(jax_msgs(k, a.batch_size, 32).copy())
            jstate, jlogs = jstep(jstate, {"imgs": jnp.asarray(jimgs)}, k)
            _, plogs = pstep(pstate, {"imgs": torch.from_numpy(pimgs)}, gen, msgs=msgs)
            if it % 10 == 0:        # train.py's log steps
                row = {"step": it, "jax": scalars(jlogs), "port": scalars(plogs),
                       "s": round(time.time() - t0, 1)}
                for p in logged:
                    logged[p].append(row[p]["bit_acc"])
                f.write(json.dumps(row) + "\n")
                f.flush()
                if it % 200 == 0:
                    print(json.dumps(row), flush=True)
        end = {p: statistics.median(v[-WINDOW:]) for p, v in logged.items()}
        f.write(json.dumps({"step": a.steps, "median_bit_acc": end}) + "\n")
    print("median bit_acc at the end", end, f"{time.time() - t0:.1f} s", flush=True)


def table(a):
    tpath = os.path.join(a.dir, "trajectory.jsonl")
    if os.path.exists(tpath):
        rows = [json.loads(ln) for ln in open(tpath)]
        print("| step | lr | loss_decode JAX / port / port+ulp | bit_acc JAX / port / port+ulp "
              "| embedder: port-JAX / ulp-port | extractor: port-JAX / ulp-port |")
        print("|---|---|---|---|---|---|")
        show = {1, 2, 5, 10, 20, 50, 100, 150, 200, len(rows)}
        for r in rows:
            if r["step"] not in show:
                continue
            lo = " / ".join(f"{r[p]['loss_decode']:.5f}" for p in ("jax", "port", "ulp"))
            ba = " / ".join(f"{r[p]['bit_acc']:.4f}" for p in ("jax", "port", "ulp"))
            d = [f"{r['port_vs_jax'][m]:.3e} / {r['ulp_vs_port'][m]:.3e}"
                 for m in ("embedder", "extractor")]
            print(f"| {r['step']} | {r['lr']:.3e} | {lo} | {ba} | {d[0]} | {d[1]} |")
        worst = {}
        for r in rows:
            for g, v in r["port_vs_jax"].items():
                base = r["ulp_vs_port"][g]
                ratio = v / base if base else float("inf") if v else 0.0
                if ratio > worst.get(g, (0.0, 0))[0]:
                    worst[g] = (ratio, r["step"])
        print("\n| module | largest port-JAX / ulp-port ratio | at step |")
        print("|---|---|---|")
        for g, (ratio, step) in sorted(worst.items(), key=lambda x: -x[1][0]):
            print(f"| {g} | {ratio:.2f} | {step} |")
    stalls = sorted(glob.glob(os.path.join(a.dir, "stall_*.jsonl")))
    if stalls:
        print("\n| seed | JAX bit_acc at 250 / 500 / 750 / end | port bit_acc at 250 / 500 "
              "/ 750 / end |")
        print("|---|---|---|")
        for path in stalls:
            rows = [json.loads(ln) for ln in open(path)]
            end = rows[-1].get("median_bit_acc")
            cells = []
            for p in ("jax", "port"):
                vals = [r[p]["bit_acc"] for r in rows if "step" in r and p in r]
                at = [statistics.median(vals[max(0, s // 10 - WINDOW + 1):s // 10 + 1])
                      for s in (250, 500, 750) if s // 10 < len(vals)]
                cells.append(" / ".join(f"{v:.3f}" for v in at)
                             + (f" / {end[p]:.3f}" if end else " / (running)"))
            seed = os.path.basename(path)[6:-6]
            print(f"| {seed} | {cells[0]} | {cells[1]} |")


def main():
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("trajectory")
    t.add_argument("--seed", type=int, default=444)
    t.add_argument("--img_size", type=int, default=128)
    t.add_argument("--batch_size", type=int, default=8)
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--iter_per_epoch", type=int, default=1000)
    t.add_argument("--threads", type=int, default=8)
    t.add_argument("--out", required=True)
    s = sub.add_parser("stall")
    s.add_argument("--seed", type=int, default=444)
    s.add_argument("--img_size", type=int, default=64)
    s.add_argument("--batch_size", type=int, default=8)
    s.add_argument("--steps", type=int, default=1000)
    s.add_argument("--iter_per_epoch", type=int, default=67)
    s.add_argument("--threads", type=int, default=2)
    s.add_argument("--out", required=True)
    b = sub.add_parser("table")
    b.add_argument("dir")
    a = p.parse_args()
    {"trajectory": trajectory, "stall": stall, "table": table}[a.mode](a)


if __name__ == "__main__":
    main()
