from repro_torch.kernels.flash_prefill.ops import (FlashPrefill, flash_prefill,
                                                   flash_prefill_prefix)
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_prefix_ref,
                                                   flash_prefill_ref)

__all__ = ["FlashPrefill", "flash_prefill", "flash_prefill_prefix",
           "flash_prefill_prefix_ref", "flash_prefill_ref"]
