"""PyTorch + CUDA port of the ALISE serving system (H100 target)."""
