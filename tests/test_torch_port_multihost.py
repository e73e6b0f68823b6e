"""`--dataset_block auto` over torch.distributed (spi_tpu_torch.parallel.
multihost) on the CPU, against spi_tpu's multihost helpers.

- `work_stripe` and `host_block` against spi_tpu's over a table of
  (n, total): the same stripes and strings (exact);
- `aggregate_metrics` in 2 and 3 gloo processes on this machine, one of
  them with an empty stripe (n = 2, total = 3): every process gets the
  mean over all images, within 1e-6 relative (float32 sums) of the mean
  computed here, and none hangs;
- the CLI's single-process `auto`: a warning, and block 1/1.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from spi_tpu.parallel import multihost as J
from spi_tpu_torch.parallel import multihost as M
from torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TABLE = [(n, total) for n in (0, 1, 2, 3, 5, 7, 10, 64, 100) for total in (1, 2, 3, 4, 8)]


@pytest.mark.parametrize("n,total", TABLE)
def test_work_stripe_matches_spi_tpu(n, total):
    stripes = [M.work_stripe(n, i, total) for i in range(total)]
    assert stripes == [J.work_stripe(n, i, total) for i in range(total)]
    assert sorted(sum(stripes, [])) == list(range(n))  # a partition of the worklist
    assert [M.host_block(total, i) for i in range(total)] == \
        [J.host_block(total, i) for i in range(total)]


def test_single_process_topology(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.initialize() is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert M.initialize() is False
    assert M.host_block() == "1/1" and M.host_work_stripe(3) == [0, 1, 2]
    means = M.aggregate_metrics({"n": 2.0, "l2": 3.0, "id": 1.0})
    assert means["l2"] == 1.5 and means["id"] == 0.5 and means["lpips"] == 0.0


# One process of the group: its stripe of N_IMAGES per-image metrics, summed,
# then the all-gather; prints its stripe and the global means as JSON.
CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    from spi_tpu_torch.parallel import multihost as M
    n = int(sys.argv[1])
    assert M.initialize()
    stripe = M.host_work_stripe(n)
    values = np.random.RandomState(0).rand(n, len(M.METRIC_NAMES))
    sums = {"n": float(len(stripe))}
    for i in stripe:
        for j, k in enumerate(M.METRIC_NAMES):
            sums[k] = sums.get(k, 0.0) + float(values[i, j])
    means = M.aggregate_metrics(sums)
    print(json.dumps({"stripe": stripe, "block": M.host_block(), "means": means}))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n,total", [(5, 2), (2, 3), (7, 3)])
def test_aggregate_metrics_over_gloo(n, total):
    port = _free_port()
    procs = []
    for rank in range(total):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(total), LOCAL_RANK=str(rank),
                   PYTHONPATH=os.path.abspath(ROOT), OMP_NUM_THREADS="1",
                   # gloo on the loopback interface: no lookup of the host's name
                   GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD, str(n)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["stripe"] for o in outs] == [J.work_stripe(n, i, total) for i in range(total)]
    assert [o["block"] for o in outs] == [f"{i + 1}/{total}" for i in range(total)]
    if n == 2 and total == 3:
        assert outs[2]["stripe"] == []  # the empty stripe took part
    want = np.random.RandomState(0).rand(n, len(M.METRIC_NAMES)).mean(axis=0)
    for o in outs:
        got = np.array([o["means"][k] for k in M.METRIC_NAMES])
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cli_auto_single_process(monkeypatch):
    """Without a process group the CLI warns and takes block 1/1."""
    from spi_tpu_torch.cli import run_inversion
    from spi_tpu_torch.data import dataset
    from spi_tpu_torch.training import pipeline

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    seen = {}

    class Dataset(list):
        def __init__(self, **kwargs):
            super().__init__()
            seen.update(kwargs)

    class Pipeline:
        def __init__(self, generator, config, perception, device):
            self.config = config

        def run(self, data):
            return []

    monkeypatch.setattr(dataset, "PTIDataset", Dataset)
    monkeypatch.setattr(pipeline, "InversionPipeline", Pipeline)
    with pytest.warns(UserWarning, match="whole worklist"):
        assert run_inversion.main(["--data_root", "unused", "--device", "cpu", "--tiny",
                                   "--random_init", "--dataset_block", "auto"]) == []
    assert seen["dataset_block"] == "1/1"
    assert not torch.distributed.is_initialized()
