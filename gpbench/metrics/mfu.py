"""The whole unit's share of the card's peak, in percent: the counted least
time of every operator call in the traced window, and of the solver's
vector work around each operator apply, over the time the window's units
take untraced."""

from gpbench import counts


def read(ctx):
    calls = ctx["calls"]
    if ctx["untraced_s"] <= 0.0 or not any(calls.values()):
        return None
    least = sum(c.seconds for cs in calls.values() for c in cs)
    for (batch, length), c in zip(ctx["shapes"].get(ctx["apply_span"], []), calls.get(ctx["apply_span"], [])):
        least += counts.cg_update(batch, length, 4 if c.grade != "fp64" else 8).seconds
    return 100.0 * least / ctx["untraced_s"]
