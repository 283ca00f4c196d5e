from repro_torch.kernels.fused_rmsnorm.ops import FusedRMSNorm, fused_rmsnorm
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

__all__ = ["FusedRMSNorm", "fused_rmsnorm", "rmsnorm_ref"]
