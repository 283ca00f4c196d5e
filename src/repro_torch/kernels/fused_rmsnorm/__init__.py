from repro_torch.kernels.fused_rmsnorm.ops import (FusedRMSNorm, RMSNormApply,
                                                   RMSNormSumsq,
                                                   fused_rmsnorm,
                                                   rmsnorm_apply,
                                                   rmsnorm_sumsq)
from repro_torch.kernels.fused_rmsnorm.ref import (rmsnorm_apply_ref,
                                                   rmsnorm_ref,
                                                   rmsnorm_sumsq_ref)

__all__ = ["FusedRMSNorm", "RMSNormApply", "RMSNormSumsq", "fused_rmsnorm",
           "rmsnorm_apply", "rmsnorm_apply_ref", "rmsnorm_ref",
           "rmsnorm_sumsq", "rmsnorm_sumsq_ref"]
