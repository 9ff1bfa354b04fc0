"""Measurement tools of the port; they time the CUDA card (see each
module)."""
