"""Training traffic: the port's `Trainer._train_chunk`, chunks of K steps
of batch B over seeded indices into the packed train rows, issued back to
back as `Trainer.train` issues them (no evaluation in the window).

Set-up builds one Trainer, puts the benchmark's weights in it, and drives
its first CHECK_STEPS steps through `_train_chunk` itself on rows that
all differ; the norms of each parameter's change after the first step
and after the last are kept.  Then WARMUP_STEPS steps run every kernel
once more, the window runs chunks from a pool of POOL_CHUNKS seeded
chunks (a traced run profiles one chunk instead), and once it has closed
the plain reference follows the same steps from the same weights.
Compared (`compare`): the first step's loss, the worst leaf's
gap of the first update's norm (lr × the clipped gradient the optimizer
got) and the median leaf's gap of the change after the checked steps,
leaves whose reference gradient is under 1e-3 of the median leaf's left
out.
"""

from __future__ import annotations

import gc
import shutil
import time

import numpy as np
import torch

from benchmark import data, harness, program, trace
from benchmark.reference import common

CHECK_STEPS = 3  # the set-up steps the reference follows
WARMUP_STEPS = 5
POOL_CHUNKS = 16  # seeded chunks of the window, reused in turn


def prepare(ctx):
    """The traffic: packed train rows, each user's features (the Trainer's
    test set), the checked steps' rows and the pool of chunks."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    seed = harness.seed_bits(ctx.seed)
    cat = data.make_catalog(cfg["catalog"], seed)
    rows = data.train_rows(cat, cfg["scheme"], cfg["shape"])
    n, B, K = len(rows["y"]), tr["batch"], tr["steps_per_chunk"]
    rng = np.random.default_rng([seed, 2])
    checked = rng.choice(n, CHECK_STEPS * B, replace=False).astype(np.int32)
    need = POOL_CHUNKS * K * B
    perms = [rng.permutation(n).astype(np.int32) for _ in range(-(-need // n))]
    pool = np.concatenate(perms)[:need].reshape(POOL_CHUNKS, K, B)
    feats = data.user_features(cat, cfg["scheme"], cfg["shape"])
    return dict(cat=cat, rows=rows, feats=feats, checked=checked.reshape(-1, B),
                pool=pool, seed=seed)


def _trainer(ctx, prep, model_dir):
    from tlsan_tpu_torch.core.config import TrainConfig
    from tlsan_tpu_torch.data.batcher import Batches
    from tlsan_tpu_torch.train.loop import Trainer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    rows, feats = prep["rows"], prep["feats"]
    rng = np.random.default_rng([prep["seed"], 4])
    items = cfg["catalog"]["items"]
    test = dict(feats)
    test.setdefault("i", rng.integers(0, items, len(feats["u"])).astype(np.int32))
    test["j"] = rng.integers(0, items, len(feats["u"])).astype(np.int32)
    tc = TrainConfig(model_dir=model_dir, train_batch_size=tr["batch"],
                     steps_per_call=tr["steps_per_chunk"], seed=prep["seed"],
                     tb_histograms=False, **cfg["optimizer"])
    return Trainer(program.model_class(cfg), program.model_config(cfg), tc,
                   prep["cat"]["item_cate"], Batches(rows, len(rows["y"])),
                   Batches(test, len(feats["u"])), device=ctx.device)


def _weights(ctx, prep):
    ref = harness.reference(ctx.cell.family)
    return common.draw(ref.param_specs(ctx.cell.config), prep["seed"], ctx.device)


def checked_steps(ctx, prep, trainer):
    """The program's first steps through `_train_chunk`: (losses, {leaf:
    ‖Δ‖ after the first}, {leaf: ‖Δ‖ after the last})."""
    w = _weights(ctx, prep)
    program.load_weights(trainer.model, w)
    params = dict(trainer.model.named_parameters())
    idx = torch.from_numpy(prep["checked"]).to(ctx.device)

    def norms():
        return {k: torch.linalg.vector_norm(p.detach() - w[k]) for k, p in params.items()}

    first = trainer._train_chunk(idx[:1])
    upd = norms()
    rest = trainer._train_chunk(idx[1:])
    change = norms()
    losses = torch.cat([first, rest]).tolist()
    return (losses, {k: float(v) for k, v in upd.items()},
            {k: float(v) for k, v in change.items()})


def reference_steps(ctx, prep, tf32: bool = False, rows: int = 0):
    """The plain reference's steps from the same weights on the same rows
    (TF32 on: the control; `rows`: only each batch's first rows, a
    planted fault)."""
    cfg = ctx.cell.config
    ref = harness.reference(ctx.cell.family)
    dev = ctx.device
    cate_list = torch.from_numpy(prep["cat"]["item_cate"]).to(dev)
    batches = [{k: torch.from_numpy(v[r[:rows or len(r)]]).to(dev)
                for k, v in prep["rows"].items()} for r in prep["checked"]]
    opt = cfg["optimizer"]
    with common.precision(tf32):
        return common.sgd_steps(_weights(ctx, prep), batches,
                                lambda p, b: ref.loss(p, b, cate_list, cfg["model"]),
                                opt["learning_rate"], opt["max_gradient_norm"])


def _leaf_gaps(prog, ref, keep):
    """Each kept leaf's gap of norms, over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    med = float(np.median([ref[k] for k in keep]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep]


def compare(prog, ref) -> dict:
    """loss_gap: the first step's loss (the later steps' losses part by
    ReLU kinks at lr 1); update_gap: the worst leaf's first update;
    change_gap: the median leaf's change after the checked steps (the
    worst leaf's swings from seed to seed with those kinks)."""
    losses, upd, change = prog
    r_losses, grad1, r_upd, r_change = ref
    floor = 1e-3 * float(np.median(list(grad1.values())))
    keep = [k for k, g in grad1.items() if g >= floor]
    return {"loss_gap": abs(losses[0] - r_losses[0]) / abs(r_losses[0]),
            "update_gap": max(_leaf_gaps(upd, r_upd, keep)),
            "change_gap": float(np.median(_leaf_gaps(change, r_change, keep)))}


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> harness.Outcome:
    dev = ctx.device
    program.build(dev)
    prep = prepare(ctx)
    model_dir = harness.model_dir_root()
    out = harness.Outcome()
    try:
        trainer = _trainer(ctx, prep, model_dir)
        prog = checked_steps(ctx, prep, trainer)
        pool = torch.from_numpy(prep["pool"]).to(dev)
        P, K, B = prep["pool"].shape
        trainer._train_chunk(pool[0, :WARMUP_STEPS])  # every kernel, once
        program.sync(dev)
        if ctx.trace:
            trainer._train_chunk(pool[1 % P])
            before = program.counters()
            with trace.profiled(dev) as held:
                trainer._train_chunk(pool[2 % P])
            after = program.counters()
            keys = [k for k in harness.LENGTHS if k in prep["rows"]]
            lengths = [{k: prep["rows"][k][prep["pool"][2 % P, s]] for k in keys}
                       for s in range(K)]
            out.reading = trace.Reading(
                trace.Trace(held.prof), "train", K, lengths, ctx.cell.work,
                ctx.cell.config, (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
                {k: after[k] - before[k] for k in after})
            out.attempted = K
        else:
            program.sync(dev)
            t_start = time.perf_counter()
            out.metrics["setup_s"] = t_start - ctx.t0
            chunks = 0
            while True:
                trainer._train_chunk(pool[chunks % P])
                chunks += 1
                if time.perf_counter() - t_start >= ctx.seconds:
                    break
            program.sync(dev)
            elapsed = time.perf_counter() - t_start
            out.metrics["train_examples_per_s"] = chunks * K * B / elapsed
            out.attempted = chunks * K
        out.memory_peak_bytes = program.memory_peak(dev)
        del trainer, pool
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    _free()
    out.checks = compare(prog, reference_steps(ctx, prep))
    return out


def readings(ctx) -> dict:
    """The checked numbers of the program's set-up steps alone (for the
    limits' calibration: no window)."""
    program.build(ctx.device)
    prep = prepare(ctx)
    model_dir = harness.model_dir_root()
    try:
        trainer = _trainer(ctx, prep, model_dir)
        prog = checked_steps(ctx, prep, trainer)
        del trainer
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    _free()
    return compare(prog, reference_steps(ctx, prep))


def control(ctx) -> dict:
    """The checked numbers of the reference at TF32 put in the program's
    place."""
    prep = prepare(ctx)
    losses, _, upd, change = reference_steps(ctx, prep, tf32=True)
    return compare((losses, upd, change), reference_steps(ctx, prep))


def fault(ctx) -> dict:
    """The checked numbers of the reference put in the program's place
    with half of each batch left out, the mean taken over the rest."""
    prep = prepare(ctx)
    losses, _, upd, change = reference_steps(ctx, prep, rows=ctx.cell.traffic["batch"] // 2)
    return compare((losses, upd, change), reference_steps(ctx, prep))
