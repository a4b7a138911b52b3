"""The benchmark of ``gp_grief_tpu_torch`` on NVIDIA H100 cards: one run of
one cell is ``python3 -m gpbench.run`` (see ``gpbench/README.md``)."""
