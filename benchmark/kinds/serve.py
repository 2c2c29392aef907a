"""Bulk serving traffic: one closed-loop client calling the port's
`Recommender.recommend` with requests of `request_users` users each,
taken in a seeded order without repeats over every user of the catalog,
the history excluded, top `k`, at the Recommender's batch `batch`.

A request's latency runs from the hand-off of its host arrays to the ids
and scores on the host.  A seeded reservoir keeps SAMPLE_REQUESTS of
the window's answers; once the window has closed the plain reference
scores those users over the whole catalog, masks their history and takes
its own top k.  Compared: the widest gap between a served score and the
reference's score of that item (`score_gap`), and the widest gap by which
a served item's reference score lies below the reference's score at that
rank (`rank_gap`; a history item, a repeated or out-of-range id reads
infinite).  A traced run profiles TRACE_REQUESTS requests instead of the
window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import data, harness, program, trace
from benchmark.reference import common

POOL_REQUESTS = 40  # seeded requests, served in turn
WARMUP_REQUESTS = 2
SAMPLE_REQUESTS = 8  # the window's requests the reference checks
TRACE_REQUESTS = 40


def prepare(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    seed = harness.seed_bits(ctx.seed)
    cat = data.make_catalog(cfg["catalog"], seed)
    feats = data.user_features(cat, cfg["scheme"], cfg["shape"])
    ref = harness.reference(ctx.cell.family)
    users = data.request_users(len(feats["u"]), tr["request_users"],
                               POOL_REQUESTS, seed)
    requests = [{k: np.ascontiguousarray(feats[k][u]) for k in ref.SERVE_FIELDS}
                for u in users]
    return dict(cat=cat, requests=requests, seed=seed)


def recommender(ctx, prep):
    from tlsan_tpu_torch.serve.recommender import Recommender

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    ref = harness.reference(ctx.cell.family)
    model = program.model_class(cfg)(program.model_config(cfg), ctx.device)
    program.load_weights(model, common.draw(ref.param_specs(cfg), prep["seed"], ctx.device))
    return Recommender(model, prep["cat"]["item_cate"], k=tr["k"], exclude_history=True,
                       batch_size=tr["batch"], device=ctx.device)


class Reservoir:
    """A seeded uniform sample of `size` of the answers offered to it."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = np.random.default_rng([seed, 3])

    def offer(self, item):
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


def reference_answers(ctx, prep, kept, tf32: bool = False):
    """The reference's (top scores, masked logits) of each kept request,
    in blocks of the Recommender's batch."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    ref = harness.reference(ctx.cell.family)
    dev = ctx.device
    w = common.draw(ref.param_specs(cfg), prep["seed"], dev)
    cate_list = torch.from_numpy(prep["cat"]["item_cate"]).to(dev)
    out = []
    with common.precision(tf32), torch.no_grad():
        for r, _, _ in kept:
            req = prep["requests"][r]
            n = len(req["u"])
            for s in range(0, n, tr["batch"]):
                b = {k: torch.from_numpy(v[s:s + tr["batch"]]).to(dev) for k, v in req.items()}
                vals, idx, masked = common.excluded_topk(
                    ref.scores(w, b, cate_list, cfg["model"]), b, ref.HISTORY, tr["k"])
                out.append((r, s, vals, idx, masked))
    return out


def compare(kept, answers, items: int) -> dict:
    """score_gap and rank_gap of the kept answers against the reference's."""
    by_req = {r: (ids, vals) for r, ids, vals in kept}
    score_gap = rank_gap = 0.0
    for r, s, top, _, masked in answers:
        ids, vals = by_req[r]
        ids = torch.from_numpy(np.asarray(ids[s:s + len(top)])).to(top.device).long()
        vals = torch.from_numpy(np.asarray(vals[s:s + len(top)])).to(top.device)
        srt = torch.sort(ids, dim=1).values
        if bool((ids < 0).any() or (ids >= items).any() or (srt[:, 1:] == srt[:, :-1]).any()):
            return {"score_gap": float("inf"), "rank_gap": float("inf")}
        at = torch.gather(masked, 1, ids)
        score_gap = max(score_gap, float(torch.max(torch.abs(vals - at))))
        rank_gap = max(rank_gap, float(torch.max(top - at)))
    return {"score_gap": score_gap, "rank_gap": rank_gap}


def run(ctx) -> harness.Outcome:
    tr, dev = ctx.cell.traffic, ctx.device
    program.build(dev)
    prep = prepare(ctx)
    rec = recommender(ctx, prep)
    reqs = prep["requests"]
    P = len(reqs)
    out = harness.Outcome()
    sample = Reservoir(SAMPLE_REQUESTS, prep["seed"])
    for r in range(WARMUP_REQUESTS):
        rec.recommend(reqs[r % P])
    if ctx.trace:
        n = TRACE_REQUESTS
        before = program.counters()
        with trace.profiled(dev) as held:
            for r in range(n):
                ids, vals = rec.recommend(reqs[r % P])
                sample.offer((r % P, ids, vals))
        after = program.counters()
        keys = [k for k in harness.LENGTHS if k in reqs[0]]
        B = tr["batch"]
        lengths = [{k: reqs[r % P][k][s:s + B] for k in keys}
                   for r in range(n) for s in range(0, tr["request_users"], B)]
        out.reading = trace.Reading(
            trace.Trace(held.prof), "serve", len(lengths), lengths, ctx.cell.work,
            ctx.cell.config, (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
            {k: after[k] - before[k] for k in after})
        out.attempted = n
    else:
        latency = []
        t_start = time.perf_counter()
        out.metrics["setup_s"] = t_start - ctx.t0
        while True:
            r = len(latency) % P
            t = time.perf_counter()
            ids, vals = rec.recommend(reqs[r])
            done = time.perf_counter()
            latency.append(done - t)
            sample.offer((r, ids, vals))
            if done - t_start >= ctx.seconds:
                break
        out.metrics["serve_users_per_s"] = len(latency) * tr["request_users"] / (done - t_start)
        out.metrics["serve_request_ms_p95"] = 1e3 * float(np.percentile(latency, 95))
        out.attempted = len(latency)
    out.memory_peak_bytes = program.memory_peak(dev)
    del rec
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    answers = reference_answers(ctx, prep, sample.kept)
    out.checks = compare(sample.kept, answers, ctx.cell.config["catalog"]["items"])
    return out


def readings(ctx) -> dict:
    """The checked numbers of SAMPLE_REQUESTS requests served after the
    warm-up (for the limits' calibration)."""
    program.build(ctx.device)
    prep = prepare(ctx)
    rec = recommender(ctx, prep)
    reqs = prep["requests"]
    for r in range(WARMUP_REQUESTS):
        rec.recommend(reqs[r % len(reqs)])
    kept = [(r, *rec.recommend(reqs[r])) for r in range(SAMPLE_REQUESTS)]
    del rec
    gc.collect()
    return compare(kept, reference_answers(ctx, prep, kept),
                   ctx.cell.config["catalog"]["items"])


def control(ctx) -> dict:
    """The reference at TF32 put in the program's place, on the same
    requests."""
    prep = prepare(ctx)
    kept = [(r, None, None) for r in range(SAMPLE_REQUESTS)]
    answers = reference_answers(ctx, prep, kept, tf32=True)
    ids = {r: [] for r, _, _ in kept}
    vals = {r: [] for r, _, _ in kept}
    for r, _, top, idx, _ in answers:
        ids[r].append(idx.int().cpu().numpy())
        vals[r].append(top.cpu().numpy())
    kept = [(r, np.concatenate(ids[r]), np.concatenate(vals[r])) for r, _, _ in kept]
    return compare(kept, reference_answers(ctx, prep, kept),
                   ctx.cell.config["catalog"]["items"])
