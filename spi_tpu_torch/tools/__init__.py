"""Tools of the port: the workloads that chip_smoke.py checks on the card
(`workloads`), the kernel timers (`timing`), and the probe tools, each run
as `python -m spi_tpu_torch.tools.<name>` on the card (counterparts of the
JAX package's round-5 probes under tools/), which time one family of
gather and scatter operations. Steps are timed by benchmark/run.py."""
