"""Utilities: checkpoints, structured metric logs, profiling spans and
finiteness guards.  Counterpart of ``gp_grief_tpu.utils``; the JAX package's
``enable_compilation_cache`` and ``explicit_closure`` serve its TPU runtime
and have no counterpart here."""

from gp_grief_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from gp_grief_tpu_torch.utils.checks import check_finite, guarded
from gp_grief_tpu_torch.utils.logging import MetricLogger
from gp_grief_tpu_torch.utils.profiling import timed, trace

__all__ = ["save_pytree", "load_pytree", "MetricLogger", "check_finite", "guarded", "trace", "timed"]
