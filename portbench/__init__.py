"""Benchmark of the PyTorch and CUDA port (``src/repro_torch``): open-loop
traffic through its ALISE serving engine on one card.  ``run.py`` runs one
cell once; everything a cell needs is found by name under this folder."""
