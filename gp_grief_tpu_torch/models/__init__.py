"""Models: the closed-form ``GPGriefModel`` and the grid GP ``GPKroneckerRegression``."""

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

__all__ = [
    "BaseModel", "BasisStats", "basis_nlml", "basis_posterior", "basis_stats_from_phi",
    "check_xy", "resolve_device", "GPGriefModel", "init_grief_state", "GPKroneckerRegression",
]
