#!/usr/bin/env python3
"""Kernel against chain on the card, call form by call form: the measurements
behind ``ops.kron_fast.hopper_gate``.

Runs ``chip_smoke.py``'s route table (``ROUTE_TABLE``: the solvers' call
forms at the smoke configurations' sizes) and then PROBE_ROWS, shapes that
bound the gate's classes (tile-pass plans down to 2^12 elements, wide-pass
plans at each grade), through ``chip_smoke.route_row``: the route
``kernel_route`` picks, the kernel against its plain version, and the
kernel's and the chain's ms by ``bench.py``'s slope method.  Probe rows
(rule "-") are measured and not checked against a rule.  One JSON line a
row, then the card.

Run on the card from the repository root:  python3 tools/route_probe.py
[--turns] [--only A,B]  (``--turns``: each route timed twice, kernel, chain,
chain, kernel, the lower of each kept; ``--only``: the rows whose names
hold one of the comma-separated substrings)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

X3 = "BF16_BF16_F32_X3"
# (row, site, lead, sizes, B, precision, vector dtype, "-")
PROBE_ROWS = [
    *[(f"tile_{'I%d_' % lead if lead else ''}{'x'.join(map(str, s))}_B{B}_{p}", "probe", lead, s, B, p, "float32", "-")
      for lead, s, B in ((0, (16, 16, 16), 1), (0, (8, 8, 8, 8), 1), (0, (32, 32, 32), 1), (8, (16, 16, 16), 1),
                         (0, (16,) * 4, 1), (0, (32,) * 4, 8), (8, (32,) * 4, 1), (0, (4, 16, 8, 16, 8), 1))
      for p in ("highest", "default")],
    ("tile_I8_16x16x16_x3", "probe", 8, (16, 16, 16), 1, X3, "float32", "-"),
    ("tile_16x16x16x16_bf16", "probe", 0, (16,) * 4, 1, "default", "bfloat16", "-"),
    *[(f"wide_{'x'.join(map(str, s))}_{'I%d_' % lead if lead else ''}B{B}_{p}", "probe", lead, s, B, p, "float32", "-")
      for lead, s, B in ((0, (96, 128), 1), (0, (12, 24, 96), 1), (0, (100, 100, 100), 1), (8, (512, 512), 1),
                         (4, (512, 512), 1), (0, (8, 512, 512), 1), (0, (8, 1024, 1024), 1), (0, (1024, 1024), 1),
                         (8, (24, 48, 96), 1), (0, (128, 32, 32, 8), 1), (0, (2048, 2048), 1))
      for p in ("highest", "default")],
    *[(f"bf16_I{lead}_32x4_x3", "probe", lead, (32,) * 4, 1, X3, "bfloat16", "-") for lead in (8, 9, 16, 17, 24, 32)],
    ("bf16_32x5_default", "probe", 0, (32,) * 5, 1, "default", "bfloat16", "-"),
    ("bf16_32x32x32_default", "probe", 0, (32, 32, 32), 1, "default", "bfloat16", "-"),
    ("wide_I8_1024x1024_x3", "probe", 8, (1024, 1024), 1, X3, "float32", "-"),
    ("wide_I8_512x512_x3", "probe", 8, (512, 512), 1, X3, "float32", "-"),
    ("wide_128x32x32x8_x3", "probe", 0, (128, 32, 32, 8), 1, X3, "float32", "-"),
    # The JAX package's slab class at X3 with a 128- or 1024-point axis (wide passes here).
    ("slabwide_I16_128x16x128_x3", "probe", 16, (128, 16, 128), 1, X3, "float32", "-"),
    ("slabwide_128x64x16x128_x3", "probe", 0, (128, 64, 16, 128), 1, X3, "float32", "-"),
    ("slabwide_64x64x2x1024_x3", "probe", 0, (64, 64, 2, 1024), 1, X3, "float32", "-"),
    ("wide_1920x1920_B1_highest", "probe", 0, (1920, 1920), 1, "highest", "float32", "-"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("route_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_info()
    argv = sys.argv[1:]
    turns = 2 if "--turns" in argv else 1
    only = argv[argv.index("--only") + 1].split(",") if "--only" in argv else None
    for row in cs.ROUTE_TABLE + PROBE_ROWS:
        if only and not any(o in row[0] for o in only):
            continue
        try:
            cs.route_row(card, row, turns=turns)
        except Exception as err:  # a failed check or row: say so, go on to the next row
            print(f"route_probe: {row[0]}: {err}", file=sys.stderr, flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
