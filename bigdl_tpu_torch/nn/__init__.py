"""Layers of the port (counterpart: bigdl_tpu/nn/)."""
