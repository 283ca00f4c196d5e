from repro_torch.kernels.flash_prefill.ops import flash_prefill_prefix
from repro_torch.kernels.flash_prefill.ref import flash_prefill_prefix_ref

__all__ = ["flash_prefill_prefix", "flash_prefill_prefix_ref"]
