from repro_torch.kernels.fused_rmsnorm.ops import fused_rmsnorm
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

__all__ = ["fused_rmsnorm", "rmsnorm_ref"]
