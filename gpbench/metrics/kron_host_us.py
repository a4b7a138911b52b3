"""Host microseconds per Kronecker matvec: the program's ``gp_grief.kron``
span (``ops.kron_fast.kron_matvec_fast`` after its routing) over its calls
in the traced window.  The profiler's host cost is inside it, so it
compares only between traced runs."""

from gpbench.spans import span


def read(ctx):
    s = span("gp_grief.kron")
    return None if s is None else 1e6 * s["host_s"] / s["calls"]
