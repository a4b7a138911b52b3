#!/usr/bin/env python3
"""Wall times of uci2m_synth's closed form on one card: the model build (grid,
basis, chunked statistics), 150 reweight steps and predict on 100k points,
three times each after a warm-up, in one process.

Usage:  python3 tools/uci2m_timing.py [TREE]

``TREE`` (default: this checkout) is the root of a checkout whose
``chip_smoke.py`` builds the model; run it from two unpacked trees in turns
(parent, change, change, parent) to compare them on one card.  Prints one
JSON line with the sorted times in seconds and the card's name and power
limit.
"""

import json
import os
import sys

tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, tree)
os.chdir(tree)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gp_grief_tpu_torch.ops.cuda import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("uci2m_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    xtr, ytr, xte, _ = cs.uci2m_data()
    res = {"build": [], "train": [], "predict": []}
    for rep in range(4):
        model, t_b = cs.timed(lambda: cs.uci2m_build(xtr, ytr))
        _, t_t = cs.timed(lambda: model.optimize(optimizer="adam", max_iters=150, learning_rate=0.05))
        _, t_p = cs.timed(lambda: model.predict(xte, compute_var=False))
        if rep:  # the first run is the warm-up
            for k, t in zip(res, (t_b, t_t, t_p)):
                res[k].append(t)
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, **{k: sorted(v) for k, v in res.items()}, "card": cs.card_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
