"""ALISE paper core: speculative scheduling + adaptive KV memory management."""
