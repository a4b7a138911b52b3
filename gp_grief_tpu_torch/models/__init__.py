"""Models: ``GPGriefModel`` (closed form and the iterative NLML), the exact GP
``GPRegression`` (Cholesky, and CG + SLQ on a dense or matrix-free Gram), the
grid GP ``GPKroneckerRegression``, SKI's ``GPSKIRegression`` and the
weighted-basis ``GPweb``."""

from gp_grief_tpu_torch.models.base import (
    BaseModel,
    BasisStats,
    basis_nlml,
    basis_posterior,
    basis_stats_from_phi,
    check_xy,
    resolve_device,
)
from gp_grief_tpu_torch.models.gp_grief import GPGriefModel, init_grief_state
from gp_grief_tpu_torch.models.gp_kron import GPKroneckerRegression
from gp_grief_tpu_torch.models.gp_regression import GPRegression
from gp_grief_tpu_torch.models.gp_ski import GPSKIRegression
from gp_grief_tpu_torch.models.gp_web import GPweb

__all__ = [
    "BaseModel", "BasisStats", "basis_nlml", "basis_posterior", "basis_stats_from_phi",
    "check_xy", "resolve_device", "GPGriefModel", "init_grief_state", "GPKroneckerRegression",
    "GPRegression", "GPSKIRegression", "GPweb",
]
