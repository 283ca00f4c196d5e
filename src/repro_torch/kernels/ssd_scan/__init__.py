from repro_torch.kernels.ssd_scan.ops import (SsdChunk, ssd_chunk,
                                              ssd_chunked_fused)
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

__all__ = ["SsdChunk", "ssd_chunk", "ssd_chunk_ref", "ssd_chunked_fused"]
