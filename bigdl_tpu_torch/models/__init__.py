"""Models of the port (counterpart: bigdl_tpu/models/)."""
