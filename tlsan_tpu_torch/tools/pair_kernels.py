"""Time the kernels of two checkouts in turns on one card: other, this,
this, other.

    python -m tlsan_tpu_torch.tools.pair_kernels OTHER_CHECKOUT [--kernels fwa|mha|mha_bwd|widths|all]

Each turn is a fresh process in one checkout: it builds that checkout's
kernels and runs its ``chip_smoke.py`` kernel phases at the main-path shapes,
with one per-call timing for both checkouts (the median of 5 runs of 100
calls between CUDA events): ``fwa`` (the default) K1 at B=128, 64 and 16
with S=10 and 25 and K2 at B=32 and 16; ``mha`` K3 at B=128, 32, 64 and 16
with (Tq, Tk) = (96, 96) and (1, 96), self- and cross-attention;
``mha_bwd`` K3b alone, per-call and device time (the profiler's, a launch)
at B=32 for the (96, 96) self-attention and the (1, 96) readout and at
B=512 and 2048 for (96, 96), the inputs those of ``chip_smoke.py``'s
kernel phase; ``widths`` K1, K2, K3 and K3b at B=32 at the reference
widths (D=64, H=8: S=10 and 25, (96, 96) and (1, 96)) and at shapes of the
width grid (heads of 64 and 128 features; (96, 96) and the (1, 96) readout in
one head of 64, (96, 96) at D=128 in 2 heads, D=256
and 512 in 8, the (1, 96) readout at D=512 and (128, 128) at D=512 in one head
at B=8; K1 and K2 also at B=128, S=25, D=128 in 2 heads) and past the old
limits (K1 and K2 at D=1024 in one head, S=10 and 25; K3 and K3b
at D=1024 in 8 heads at B=8, D=50 in 5 heads and the readout over 300 keys),
K1 and K2
also at every other shape of ``tools/widths.py::WIDTHS_FWA`` that runs a wide
variant; each with a
digest of its outputs (SHA-256 of their bytes), per-call and device time,
or "refused" where the checkout's plans refuse the shape, so that two
checkouts' outputs can be held bit for bit; ``all`` K1, K2 and K3.  Its ``kernel fwa_*`` or ``kernel
mha_*`` lines are printed with the checkout's tag.  Two versions are
compared only within one such call: the card, its power limit and its host
then stay the same.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from tlsan_tpu_torch.ops.cuda.fwa import MAX_HEAD_WIDTH
from tlsan_tpu_torch.tools.widths import WIDTHS_FWA

ROOT = Path(__file__).resolve().parents[2]
TURN = """
import numpy as np, torch
import chip_smoke as c

def per_call_ms(fn, iters=100, warmup=20, repeats=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))

c._cuda_ms = per_call_ms
c.phase_build()
"""
# the phases of each kind, with signatures every checkout since the
# parent of the K3 redesign has
PHASES = {
    "fwa": """
c.phase_kernel(c.MAIN_SHAPES + c.LOCAL_FWA + c.LOCAL_FWA_TRAIN, c.MAIN_SHAPES)
c.phase_kernel_bwd(c.TRAIN_SHAPES + c.LOCAL_FWA_TRAIN, c.TRAIN_SHAPES)
""",
    "mha": """
c.phase_kernel_mha(c.MHA_MAIN + c.MHA_TRAIN + c.LOCAL_MHA + c.LOCAL_MHA_TRAIN, c.MHA_MAIN)
""",
    # K3b alone, through the wrapper both checkouts have
    "mha_bwd": """
from tlsan_tpu_torch.ops.cuda import mha as cm
for B, Tq, Tk, sa in ((32, 96, 96, True), (32, 1, 96, False), (512, 96, 96, True),
                      (2048, 96, 96, True)):
    q, k, ql, kl, w = c._mha_inputs(B, Tq, Tk, sa, c.SEED + 30)
    g = torch.from_numpy(np.random.default_rng(c.SEED + 40).normal(
        size=(B, Tq, c.D)).astype(np.float32)).cuda()
    args = (q, k, ql, kl, c.H, *(w[n] for n in cm.WEIGHTS), g)
    run = lambda: cm.mha_backward(*args)
    ms = per_call_ms(run)
    dev = c._device_ms(run, "mha_bwd_kernel")
    print(f"kernel mha_bwd B={B} Tq={Tq} Tk={Tk} {'self' if sa else 'cross'}: "
          f"kernel_ms={ms:.6f} device_ms={dev}", flush=True)
""",
    # every kernel at the reference widths and at the width grid, through
    # the wrappers every checkout has
    "widths": """
import hashlib
from tlsan_tpu_torch.ops.cuda import fwa as cf
from tlsan_tpu_torch.ops.cuda import mha as cm

def turn(tag, kernel, run):
    try:
        out = run()
    except ValueError as e:
        print(f"kernel widths {tag}: refused ({e})", flush=True)
        return
    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.cpu().numpy().tobytes())
    ms = per_call_ms(run, iters=20, warmup=5)
    print(f"kernel widths {tag}: digest={h.hexdigest()[:16]} kernel_ms={ms:.6f} "
          f"device_ms={c._device_ms(run, kernel, calls=20)}", flush=True)

for B, S, d, h in FWA_SHAPES:
    x, l, w1, b1, w2, b2 = c._fwa_inputs(B, S, c.SEED + 60, d, h)
    g = torch.from_numpy(np.random.default_rng(c.SEED + 61).normal(
        size=(B, d)).astype(np.float32)).cuda()
    shape = f"B={B} S={S} D={d} H={h}"
    turn(f"fwa_fwd {shape}", "fwa_fwd", lambda: cf.fwa_forward(x, l, h, w1, b1, w2, b2))
    turn(f"fwa_bwd {shape}", "fwa_bwd",
         lambda: cf.fwa_backward(x, l, h, w1, b1, w2, b2, g))
for B, Tq, Tk, d, h, sa in ((32, 96, 96, 64, 8, True), (32, 1, 96, 64, 8, False),
                            (32, 96, 96, 64, 1, True), (32, 1, 96, 64, 1, False),
                            (32, 96, 96, 128, 2, True),
                            (32, 96, 96, 256, 8, True), (32, 96, 96, 512, 8, True),
                            (32, 1, 96, 512, 8, False), (8, 128, 128, 512, 1, True),
                            (8, 96, 96, 1024, 8, True), (32, 96, 96, 50, 5, True),
                            (32, 1, 300, 64, 8, False)):
    q, k, ql, kl, w = c._mha_inputs(B, Tq, Tk, sa, c.SEED + 70, d)
    ws = [w[n] * (64.0 / d) ** 0.5 if n.startswith("w") else w[n] for n in cm.WEIGHTS]
    g = torch.from_numpy(np.random.default_rng(c.SEED + 71).normal(
        size=(B, Tq, d)).astype(np.float32)).cuda()
    shape = f"B={B} Tq={Tq} Tk={Tk} D={d} H={h} {'self' if sa else 'cross'}"
    turn(f"mha_fwd {shape}", "mha_fwd", lambda: cm.mha_forward(q, k, ql, kl, h, *ws))
    turn(f"mha_bwd {shape}", "mha_bwd", lambda: cm.mha_backward(q, k, ql, kl, h, *ws, g))
""",
}


# K1's and K2's shapes in ``widths``: the reference widths and every shape
# of chip_smoke.py's widths phase that runs a wide variant, as this
# checkout lists them (written into the script both checkouts run)
FWA_SHAPES = [(32, 10, 64, 8), (32, 25, 64, 8)] + [
    s for s in WIDTHS_FWA if s[2] // s[3] > MAX_HEAD_WIDTH]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="root of the other checkout")
    parser.add_argument("--kernels", choices=("fwa", "mha", "mha_bwd", "widths", "all"),
                        default="fwa",
                        help="which kernels to time (default: fwa, K1 and K2)")
    args = parser.parse_args(argv)
    kinds = ("fwa", "mha") if args.kernels == "all" else (args.kernels,)
    script = TURN + "".join(PHASES[kind] for kind in kinds).replace(
        "FWA_SHAPES", repr(FWA_SHAPES))
    prefixes = tuple(f"kernel {kind}" for kind in kinds)
    for tag, root in (("other", args.other), ("this", ROOT), ("this", ROOT),
                      ("other", args.other)):
        turn = subprocess.run([sys.executable, "-c", script], cwd=root,
                              capture_output=True, text=True, timeout=900)
        if turn.returncode != 0:
            print(f"[{tag}] failed:\n{turn.stdout}\n{turn.stderr}", file=sys.stderr)
            return 1
        for line in turn.stdout.splitlines():
            if line.startswith(prefixes):
                print(f"[{tag}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
