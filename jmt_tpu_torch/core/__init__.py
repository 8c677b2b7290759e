"""Configuration of the port (the part of ``jmt_tpu/core`` it reads)."""
