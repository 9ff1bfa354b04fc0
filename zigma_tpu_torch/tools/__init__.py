"""Measurement tools of the port that need a CUDA card (see each module)."""
