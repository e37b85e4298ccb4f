"""Utilities of the port (the counterparts of mrhyde_tpu/utils that it
needs)."""
