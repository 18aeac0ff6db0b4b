"""Utilities of the port (counterpart: bigdl_tpu/utils/)."""
