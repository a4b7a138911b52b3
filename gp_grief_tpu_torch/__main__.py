"""CLI: ``python -m gp_grief_tpu_torch <subcommand>``.

Counterpart of ``python -m gp_grief_tpu``:

* ``checkgrad [--sample K] [--device cpu]`` — build the JAX CLI's small
  GRIEF model (float64, kernel hyperparameters trained) and print the
  autograd-against-finite-differences table, then ``OK`` or ``MISMATCH``
  (exit 0 or 1; 2 on a usage error).  ``--sample K`` caps the probes at
  about K components (the scalar hyperparameters always run).  On the card
  unless ``--device cpu``.
* ``configs [names...] [--device cpu]`` — run BASELINE configurations
  through ``gp_grief_tpu_torch.run_configs`` (default: sine1d grid3d d100).
* ``bench [--d D] [--m_d M] [--device cpu]`` — the headline benchmark,
  ``gp_grief_tpu_torch.bench``: the Kronecker matvec's effective GB/s on
  kernel K2 at both grades (default 5 × 32, M = 2²⁵) against a stream
  measured in the same run, each grade's error against float64; one JSON
  line, last (exit 0; non-zero on a failed phase or a grade over its limit;
  2 on a usage error).  On the card unless ``--device cpu``.
"""

from __future__ import annotations

import sys


def _option(rest: list, flag: str, usage: str):
    """The value after ``flag`` in ``rest`` (removed from it), or None;
    raises ``ValueError(usage)`` when the flag has no value."""
    if flag not in rest:
        return None
    i = rest.index(flag)
    if i + 1 >= len(rest):
        raise ValueError(usage)
    value = rest[i + 1]
    del rest[i : i + 2]
    return value


def _checkgrad(rest=()) -> int:
    usage = "usage: checkgrad [--sample K] [--device cpu]  (K = max FD probes, int)"
    rest = list(rest)
    try:
        sample = _option(rest, "--sample", usage)
        device = _option(rest, "--device", usage) or "cuda"
    except ValueError as e:
        print(e)
        return 2
    if sample is not None:
        try:
            sample = int(sample)
        except ValueError:
            print(f"--sample expects an integer, got {sample!r}")
            return 2
    if rest:
        print(f"unexpected arguments {rest}\n{usage}")
        return 2

    import numpy as np
    import torch

    import gp_grief_tpu_torch as gpt

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, size=(120, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(120)
    model = gpt.GPGriefModel(
        x, y, [gpt.make_kernel("rbf", lengthscale=0.5) for _ in range(2)],
        n_eigs=12, mbar=8, noise_var=0.1, opt_kernel_params=True, dtype=torch.float64, device=device,
    )
    print(f"GPGriefModel (opt_kernel_params=True) checkgrad table ({model.x.device}):")
    ok = model.checkgrad(verbose=True, sample=sample)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


def main(argv) -> int:
    if len(argv) < 1 or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "checkgrad":
        return _checkgrad(rest)
    if cmd == "configs":
        from gp_grief_tpu_torch import run_configs

        return run_configs.main(rest)
    if cmd == "bench":
        from gp_grief_tpu_torch import bench

        return bench.main(rest)
    print(f"unknown subcommand {cmd!r}\n{__doc__}")
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
