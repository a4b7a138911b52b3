"""Data generators, one module per generator, found by the name a
configuration's ``data.generator`` gives.  Each has ``make(params, rng) ->
(x, y)``: float32 NumPy arrays drawn from ``rng`` (``numpy.random.Generator``)."""
