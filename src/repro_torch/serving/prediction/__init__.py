"""Online, hit-aware quantile length prediction (serve-path subsystem).

See :mod:`.online` for the predictor, :mod:`.features` for the hit-aware
feature extraction, :mod:`.quantile` for the pinball-loss heads.
"""
from repro_torch.serving.prediction.features import (CTX_DIM, FEATURE_DIM,
                                                     TOKEN_DIM,
                                                     LengthFeaturizer)
from repro_torch.serving.prediction.online import (OnlineConfig,
                                                   OnlineQuantilePredictor)
from repro_torch.serving.prediction.quantile import QuantileHeads, pinball_loss

__all__ = ["OnlineQuantilePredictor", "OnlineConfig", "LengthFeaturizer",
           "QuantileHeads", "pinball_loss", "FEATURE_DIM", "TOKEN_DIM",
           "CTX_DIM"]
