"""Model builders, one module per model family, found by the family a
configuration names.  Each module gives:

- ``build(cfg, x, y, *, seed, device)``: the program's model at the
  configuration's parameters;
- ``values(cfg)``: the configuration's parameters as positive values, one
  float64 array per leaf (the harness's leaf names, which the reference
  takes);
- ``SCALED``: the leaves that a fresh initialisation rescales;
- ``assign(model, values)``: set the model's parameters to ``values``;
- ``read(model)`` and ``grads(model)``: the model's raw (log) parameters and
  their gradients under the harness's leaf names, as float64 NumPy arrays.
"""
