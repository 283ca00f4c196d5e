"""Online serving gateway of the PyTorch port: an asyncio streaming
front end over real engines, as ``repro.serving.gateway`` (whose engines
run JAX).  ``admission`` and ``metrics`` are copies of the reference's
modules; ``router`` and ``server`` drive ``repro_torch`` engines.

Layers (each its own module):

  * ``server``    — the ``Gateway`` event loop: arrival-time admission,
                    per-request async token streams, cancellation, replay.
  * ``admission`` — SLO-class admission control with queue-depth and
                    predicted-EWT watermarks (backpressure: defer/shed).
  * ``router``    — predictor-informed dispatch across engine replicas
                    (round_robin / join_shortest_queue / ewt), with
                    drain-and-requeue on engine removal.
  * ``metrics``   — per-class TTFT/TPOT/E2E percentile + goodput telemetry.
"""
from repro_torch.serving.gateway.admission import (AdmissionConfig,
                                                   AdmissionController,
                                                   MissPolicy, Verdict)
from repro_torch.serving.gateway.metrics import ClassMetrics, GatewayMetrics
from repro_torch.serving.gateway.router import EngineDriver, GatewayRouter
from repro_torch.serving.gateway.server import (Gateway, GatewayConfig,
                                                RequestStream)

__all__ = [
    "AdmissionConfig", "AdmissionController", "MissPolicy", "Verdict",
    "ClassMetrics", "GatewayMetrics",
    "EngineDriver", "GatewayRouter",
    "Gateway", "GatewayConfig", "RequestStream",
]
