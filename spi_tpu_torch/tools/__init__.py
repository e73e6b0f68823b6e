"""Probe tools of the port (counterparts of the JAX package's round-5
probes under tools/): `python -m spi_tpu_torch.tools.<name>` times one
family of gather and scatter operations on the card."""
