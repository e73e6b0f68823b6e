"""Tools of the port, each run as `python -m spi_tpu_torch.tools.<name>` on
the card: the benchmark line (`bench`, the counterpart of the root
bench.py), one mode's step time (`step_time`), and the probe tools
(counterparts of the JAX package's round-5 probes under tools/), which
time one family of gather and scatter operations."""
