"""CG iterations per unit (per Adam step, per NLML), as the models report
them (dispatched iterations) over the traced window's units."""


def read(ctx):
    units = ctx["units"]
    if not units or not all("cg_iterations" in u for u in units):
        return None
    steps = sum(u["steps"] for u in units)
    return sum(sum(u["cg_iterations"]) for u in units) / steps
