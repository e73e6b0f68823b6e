"""The GAN training CLI (spi_tpu_torch/cli/run_gan_training.py) and GAN
training over several processes, on the CPU.

- `main` with --device cpu --tiny --max_steps 3 in its default bfloat16:
  stats.jsonl with spi_tpu's fields, the snapshots, and a network-final.npz
  that both packages' generators load; without --device it raises (no
  GPU here); --n_devices must equal the number of processes;
- two gloo processes, each the port's trainer on its half of a batch of 4
  with the draws of its shard of spi_tpu's `make_step(mesh=...)` on a
  2-device mesh (each device keys its step from the first of its shard's
  keys), without R1, density TV and the pipe (test_torch_port_gan.py
  holds those): step 0 against spi_tpu's, the losses and rt to
  1e-5 relative, every all-reduced gradient to 2e-3 of its largest entry
  (the float32 backward's bound, ROADMAP Queue 3) against spi_tpu's, which
  is the sum over the devices where the port's is the mean, and the
  updated parameters to 1e-5 against spi_tpu's optimizer; after a second step
  `check_replica_consistency` returns [] on G, D and G_ema, and names a
  parameter that one process changed; `psum_metrics` against spi_tpu's on
  the same mesh and `cross_device_sum` over the two;
- the CLI itself in two gloo processes, the tiny trainer: each process takes
  half the batch, rank 0 writes the files, the replicas agree at every
  snapshot (main checks them), and main leaves the process group.
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

import jax
import jax.numpy as jnp

from spi_tpu.models.discriminator import DualDiscriminator as JDual
from spi_tpu.parallel import mesh as JM
from spi_tpu.training import gan as JG
from spi_tpu.utils.checkpoint import flatten_pytree, load_pytree, unflatten_to_nested
from spi_tpu_torch.cli import run_gan_training
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.training import gan as PG
from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz, module_flat
from test_torch_port_gan import (
    CONFIG,
    TOL_GRAD,
    TOL_LOSS,
    _rel_err,
    jax_tiny_generator,
    port_modules,
    step_draws,
    step_inputs,
    tree_of,
)
from torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 2
# The mesh step without R1, density TV and the pipe, which
# test_torch_port_gan.py holds to spi_tpu's: here the point is the
# all-reduce, and spi_tpu compiles its mesh step in a fraction of the time.
MESH_CONFIG = dict(CONFIG, r1_gamma=0.0, density_reg=0.0)


@pytest.fixture(scope="module")
def gan_data(tmp_path_factory):
    """Six 128^2 images with a dataset.json of canonical-camera labels."""
    from PIL import Image

    from spi_tpu_torch.utils.camera import canonical_camera

    root = tmp_path_factory.mktemp("gan_images")
    label = canonical_camera(device="cpu")[0].tolist()
    rng = np.random.default_rng(0)
    labels = []
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (128, 128, 3), np.uint8)).save(root / f"{i}.png")
        labels.append([f"{i}.png", label])
    (root / "dataset.json").write_text(json.dumps({"labels": labels}))
    return str(root)


CLI_ARGS = ["--tiny", "--batch", "2", "--tick_kimg", "0.002", "--snap", "2", "--max_steps", "3"]


def test_cli_tiny_bf16(gan_data, tmp_path):
    out = tmp_path / "run"
    tr = run_gan_training.main(["--data", gan_data, "--outdir", str(out), "--device", "cpu",
                                *CLI_ARGS])
    assert tr.generator.compute_dtype == torch.bfloat16 and tr.step_count == 3
    assert sorted(os.listdir(out)) == ["network-000000.npz", "network-final.npz", "stats.jsonl"]
    lines = [json.loads(s) for s in (out / "stats.jsonl").read_text().splitlines()]
    assert len(lines) == 3
    assert sorted(lines[0]) == ["Loss/D", "Loss/G", "Progress/augment_p", "kimg", "timestamp"]
    assert all(np.isfinite(e["Loss/G"]["mean"]) and np.isfinite(e["Loss/D"]["mean"])
               for e in lines)
    flat = load_npz(str(out / "network-final.npz"))
    for k, v in module_flat(tr.g_ema).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    g = TriPlaneGenerator(PG.tiny_gan_config(), device="cpu", seed=7)
    load_flat_params(g, flat)  # every key, one to one
    like = jax.eval_shape(jax_tiny_generator().init, jax.random.PRNGKey(0))
    tree = load_pytree(str(out / "network-final.npz"), like=like)
    assert sorted(flatten_pytree(tree)) == sorted(flat)


def test_cli_needs_a_gpu(gan_data, tmp_path):
    with pytest.raises(RuntimeError, match="no GPU is available"):
        run_gan_training.main(["--data", gan_data, "--outdir", str(tmp_path), *CLI_ARGS])


def test_cli_n_devices_checked(gan_data, tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--n_devices 2 but 1 processes"):
        run_gan_training.main(["--data", gan_data, "--outdir", str(tmp_path), "--device", "cpu",
                               "--n_devices", "2", *CLI_ARGS])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(code, args, timeout=300):
    """`code` in WORLD gloo processes (torchrun's environment); each one's
    stdout."""
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


# One process of the group: the tiny trainer on its shard, spi_tpu's draws;
# step 0's metrics and gradients to a file, then a second step and the
# replica checks.
RANK_STEP = textwrap.dedent("""
    import sys, torch
    from spi_tpu_torch.models.discriminator import DualDiscriminator
    from spi_tpu_torch.models.triplane import TriPlaneGenerator
    from spi_tpu_torch.parallel import check_replica_consistency, initialize, psum_metrics
    from spi_tpu_torch.training import gan as PG
    from spi_tpu_torch.utils import stats
    from spi_tpu_torch.utils.checkpoint import load_flat_params
    torch.set_num_threads(2)
    assert initialize("gloo")
    rank = torch.distributed.get_rank()
    inp = torch.load(sys.argv[1], weights_only=False)
    g = TriPlaneGenerator(PG.tiny_gan_config(), device="cpu")
    d = DualDiscriminator(25, **PG.TINY_DISCRIMINATOR, device="cpu")
    load_flat_params(g, inp["g"])
    load_flat_params(d, inp["d"])
    tr = PG.GANTrainer(g, d, PG.GANConfig(**inp["config"]), device="cpu")
    out = {}
    for i, step in enumerate(inp["steps"]):
        m = tr.step(*step["inputs"][rank], draws=step["draws"][rank])
        if i == 0:
            out["metrics"] = {k: float(v) for k, v in m.items()}
            trained = {"g": tr.g_leaves, "d": dict(d.named_parameters())}
            out["grads"] = {w: {k: p.grad.clone() for k, p in ls.items()}
                            for w, ls in trained.items()}
            out["leaves"] = {w: {k: p.detach().clone() for k, p in ls.items()}
                             for w, ls in trained.items()}
    out["consistent"] = [check_replica_consistency(m) for m in (g, d, tr.g_ema)]
    with torch.no_grad():
        if rank == 1:
            d.b4.out.bias.add_(1.0)
    out["one_changed"] = check_replica_consistency(d)
    out["psum"] = psum_metrics(inp["values"][rank])
    out["moments"] = stats.cross_device_sum({"v": stats.moments_of(inp["values"][rank])})["v"]
    torch.save(out, sys.argv[2] + f".{rank}")
""")


@pytest.fixture(scope="module")
def mesh_steps(tmp_path_factory):
    """spi_tpu's 2-device mesh step, and the port's in two gloo processes on
    its shards' draws."""
    tmp = tmp_path_factory.mktemp("gan_mesh")
    jg = jax_tiny_generator()
    jd = JDual(c_dim=25, img_resolution=128, channel_base=1024, channel_max=32)
    jtr = JG.GANTrainer(jg, jd, JG.GANConfig(**MESH_CONFIG))
    g, d = port_modules()
    g_opt, d_opt = jtr.optimizers()
    gp, dp = tree_of(g), tree_of(d)
    state = {"g": gp, "d": dp, "g_ema": gp, "g_opt": g_opt.init(gp), "d_opt": d_opt.init(dp),
             "step": jnp.zeros((), jnp.int32)}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    n = MESH_CONFIG["batch_per_device"]
    real, z, c = step_inputs(n * WORLD, 30)
    rngs = jax.random.split(jax.random.PRNGKey(5), n * WORLD)
    state1, metrics = jtr.make_step(mesh=mesh)(state, jnp.asarray(real), jnp.asarray(z),
                                               jnp.asarray(c), rngs)
    values = np.random.RandomState(6).randn(n * WORLD).astype(np.float32)
    psum = np.asarray(JM.psum_metrics(mesh)(jnp.asarray(values)))
    shard = [slice(r * n, (r + 1) * n) for r in range(WORLD)]
    steps = []
    for i in range(2):
        r_, z_, c_ = (real, z, c) if i == 0 else step_inputs(n * WORLD, 31)
        steps.append({
            "inputs": [tuple(torch.from_numpy(a[s].copy()) for a in (r_, z_, c_)) for s in shard],
            "draws": [step_draws(jg, None, rngs[s.start], i, n) for s in shard]})
    inp = {"g": module_flat(g), "d": module_flat(d), "config": MESH_CONFIG,
           "steps": steps, "values": [torch.from_numpy(values[s].copy()) for s in shard]}
    torch.save(inp, tmp / "inputs.pt")
    _run_ranks(RANK_STEP, [str(tmp / "inputs.pt"), str(tmp / "out.pt")])
    ranks = [torch.load(tmp / f"out.pt.{r}", weights_only=False) for r in range(WORLD)]
    return {"jtr": jtr, "start": state, "state": state1,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "ranks": ranks, "psum": psum, "values": values}


def test_mesh_step_metrics(mesh_steps):
    for r in mesh_steps["ranks"]:
        for k, want in mesh_steps["metrics"].items():
            got = r["metrics"][k]
            assert abs(got - want) <= TOL_LOSS * max(abs(want), 1e-6), (k, got, want)


@pytest.mark.parametrize("which", ["d", "g"])
def test_mesh_step_gradients(mesh_steps, which):
    """The all-reduced gradients, the same in both processes, against spi_tpu's
    (its Adam first moment). The port averages the processes' gradients, as
    EG3D does; spi_tpu's shard_map step gives their sum: differentiating its
    loss with respect to the replicated parameters inside shard_map already
    sums over the devices (the transpose of the parameters' implicit
    broadcast), and its pmean of that sum changes nothing. So spi_tpu's
    gradient is WORLD times the port's (ROADMAP Queue 3); Adam's update is
    the same up to eps (`test_mesh_step_update`)."""
    mu = flatten_pytree(mesh_steps["state"][f"{which}_opt"][0].mu)
    g0, g1 = (r["grads"][which] for r in mesh_steps["ranks"])
    for k, v in g0.items():
        assert torch.equal(v, g1[k]), k
    worst = max((_rel_err(WORLD * v.numpy(), mu[k]), k) for k, v in g0.items())
    assert worst[0] <= TOL_GRAD, worst


@pytest.mark.parametrize("which", ["d", "g"])
def test_mesh_step_update(mesh_steps, which):
    """The parameters after the all-reduced step equal spi_tpu's optimizer
    applied to the port's (mean) gradient from the starting state, to 1e-5
    of each leaf's largest entry, and are the same in both processes.
    (Applied to spi_tpu's own gradient, WORLD times larger, Adam's update
    differs only where eps is not negligible beside |g|.)"""
    import optax

    jtr = mesh_steps["jtr"]
    opt = dict(zip("gd", jtr.optimizers()))[which]
    params = mesh_steps["start"][which]
    flat = flatten_pytree(params)
    grads = mesh_steps["ranks"][0]["grads"][which]
    tree = unflatten_to_nested({k: grads[k].numpy() if k in grads else np.zeros_like(v)
                                for k, v in flat.items()})
    update = jax.jit(lambda t, p: optax.apply_updates(p, opt.update(t, opt.init(p), p)[0]))
    want = flatten_pytree(update(tree, params))
    l0, l1 = (r["leaves"][which] for r in mesh_steps["ranks"])
    for k, v in l0.items():
        assert torch.equal(v, l1[k]), k
        assert _rel_err(v.numpy(), want[k]) <= 1e-5, k


def test_replica_consistency(mesh_steps):
    for r in mesh_steps["ranks"]:
        assert r["consistent"] == [[], [], []]
        assert r["one_changed"] == ["b4.out.bias"]


def test_psum_metrics_and_moments(mesh_steps):
    values = mesh_steps["values"]
    for r in mesh_steps["ranks"]:
        np.testing.assert_allclose(r["psum"].numpy(), mesh_steps["psum"], rtol=1e-6)
        np.testing.assert_allclose(r["moments"].numpy(),
                                   [values.size, values.sum(), np.square(values).sum()],
                                   rtol=1e-5)


RANK_CLI = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from spi_tpu_torch.cli import run_gan_training
    tr = run_gan_training.main(sys.argv[1:])
    print("RANK_RESULT " + json.dumps({"batch": tr.config.batch_per_device,
                                       "steps": tr.step_count,
                                       "group_left": not dist.is_initialized()}))
""")


def test_cli_two_processes(gan_data, tmp_path):
    out = tmp_path / "run"
    outs = _run_ranks(RANK_CLI, ["--data", gan_data, "--outdir", str(out), "--device", "cpu",
                                 "--n_devices", "2", *CLI_ARGS])
    results = [json.loads(o.split("RANK_RESULT ")[-1]) for o in outs]
    assert results == [{"batch": 1, "steps": 3, "group_left": True}] * WORLD
    assert "process group: gloo, 2 processes" in outs[0]
    # main checks the replicas at every snapshot and raises where they differ.
    for name in ("network-000000.npz", "network-final.npz"):
        assert f"{name}: G, D and G_ema bitwise equal over 2 processes" in outs[0]
    assert sorted(os.listdir(out)) == ["network-000000.npz", "network-final.npz", "stats.jsonl"]
