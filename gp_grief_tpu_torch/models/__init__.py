"""Models.  This slice ports the closed-form ``GPGriefModel``."""

from gp_grief_tpu_torch.models.base import (
    BaseModel,
    BasisStats,
    basis_nlml,
    basis_posterior,
    basis_stats_from_phi,
    check_xy,
)
from gp_grief_tpu_torch.models.gp_grief import GPGriefModel, init_grief_state

__all__ = [
    "BaseModel", "BasisStats", "basis_nlml", "basis_posterior", "basis_stats_from_phi",
    "check_xy", "GPGriefModel", "init_grief_state",
]
