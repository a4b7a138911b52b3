"""Synchronising device-to-host reads per unit (per Adam step, NLML or
request), as the program counts them (counter ``host_reads``: every
``bool``, ``.tolist()``, ``.cpu()`` or ``float`` of a device tensor on the
solver and model paths) in the traced window."""

from gpbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "host_reads")
