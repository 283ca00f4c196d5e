"""Distributed-optimization helpers (gradient compression)."""
