#!/usr/bin/env python3
"""Size the iterative exact GP on the card: chip_smoke.py phase 13's pieces, one at a time.

Usage, from the repository root, on a machine with one CUDA GPU:
    python3 tools/gp_iter_probe.py [--apply-n N ...] [--nlml-n N] [--train-n N ...]

Prints one JSON line per measurement, each with the card's name and power
limit:

* ``--apply-n``: for each n, the recipe's matrix-free Gram
  (``chip_smoke.gp_iter_model``; matvec_chunk 2048 at n ≤ 40,000, else
  "auto") applied at B = 9: two wall times of the exact operator, one of
  the "default" (bf16-operand) one, the profiler's device time of one
  apply (n ≤ 131,072) and how long that profile took to process, beside the
  apply's operation bound;
* ``--nlml-n``: ``log_likelihood_iterative_segmented`` at that n (wall,
  NVML busy share, peak memory, CG iterations);
* ``--train-n``: for each n, one ``optimize_segmented`` step (solve and
  gradient wall, CG iterations).

These are the measurements that set phase 13's cuts (PERF.md §4): the
recipe's n = 500k NLML and training step against the phase's time budget.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def applies(ns, card):
    import torch

    for n in ns:
        x, y = cs.gp_iter_data(n)
        model = cs.gp_iter_model(x, y, torch.float32, "cuda", matvec_chunk=2048 if n <= 40_000 else "auto")
        chunk = model._iter_opts["matvec_chunk"]
        vv = torch.randn((9, n), device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        with torch.no_grad():
            mv, mv_fast = model._gram_op(chunk), model._gram_op(chunk, "default")
            walls = [cs.timed(lambda: mv(vv))[1] for _ in range(2)]
            fast = cs.timed(lambda: mv_fast(vv))[1]
            dev = t_prof = None
            if n <= 131_072:
                t0 = time.perf_counter()
                dev = cs.device_ms(lambda: mv(vv), reps=1, warmup=0)
                t_prof = time.perf_counter() - t0
        cs.emit({"probe": "apply", "n": n, "matvec_chunk": chunk, "B": 9, "wall_s": walls, "wall_s_default": fast,
                 "device_ms": dev, "profile_s": t_prof, "bound_ms": cs.gram_apply_bound_ms(n, 9), "card": card})
        del model, mv, mv_fast, vv
        torch.cuda.empty_cache()


def nlml(n, card):
    import torch

    x, y = cs.gp_iter_data(n)
    model = cs.gp_iter_model(x, y, torch.float32, "cuda", matvec_chunk="auto")
    value, st = cs.run_measured(lambda: -model.log_likelihood_iterative_segmented(**cs.GP_ITER_NLML))
    cs.emit({"probe": "nlml", "n": n, "matvec_chunk": model._iter_opts["matvec_chunk"], "nlml": value,
             "cg_iterations": model.cg_iterations, **st, "card": card})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--apply-n", type=int, nargs="*", default=[])
    ap.add_argument("--nlml-n", type=int, default=None)
    ap.add_argument("--train-n", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gp_iter_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_info()
    applies(args.apply_n, card)
    if args.nlml_n:
        nlml(args.nlml_n, card)
    cs.GP_ITER_TRAIN_STEPS = 1
    for n in args.train_n:
        cs.phase_gp_iter_train(card, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
