"""The editing step's constants and draws on the CPU, no JAX: CLIP's cached
mean and std and the EG3D trainer's cached canonical camera bitwise the
tensors made each call before; every trainer family's draws written into
given tensors bitwise a fresh draw, the generator left where a fresh draw
leaves it; off the card `step` is `eager_step` (no CUDA graph, Adam not
capturable) and leaves the trainer's generator one step's draws on; an
edit ends after its `iterations` steps; the default trainable twin copies
only the parameters it trains; the benchmark's `graph_replay_share`
reader on slices built by hand. That a traced step opens no `spi.sync`
span is `test_torch_port_spans.py`'s."""

import pytest
import torch

from benchmark import harness
from benchmark.harness.metrics import Input
from benchmark.harness.trace import Slice
from spi_tpu_torch.cli.run_editing import CRCTokenizer
from spi_tpu_torch.editing.clip_loss import DirectionalCLIPLoss
from spi_tpu_torch.editing.zssgan import EditingSettings, ZSSGANTrainer
from spi_tpu_torch.editing.zssgan2d import ZSSGAN2DTrainer, ZSSGANSG3Trainer
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.models import stylegan2 as S2
from spi_tpu_torch.models.perception import clip as C
from spi_tpu_torch.models.stylegan3 import SG3Generator, tiny_stylegan3
from spi_tpu_torch.utils.camera import canonical_camera
from torch_threads import few_torch_threads  # noqa: F401

G2D = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=16, img_channels=3, channel_base=256,
           channel_max=32)


def _trainer(family, seed=0, iterations=301):
    cfg = C.tiny_test_clip()
    losses = {"tiny": DirectionalCLIPLoss(C.CLIP(cfg, device="cpu", seed=1))}
    settings = EditingSettings(batch=2, iterations=iterations)
    if family == "eg3d":
        g = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=5)
        with torch.no_grad():
            for k, v in g.named_parameters():
                if k.endswith("noise_strength"):
                    v.fill_(0.1)
        tr = ZSSGANTrainer(g, losses, {"tiny": 1.0}, settings, device="cpu", seed=seed)
    elif family == "2d":
        g = S2.Generator(**G2D, device="cpu")
        S2.seeded_init(g, 1)
        tr = ZSSGAN2DTrainer(g, losses, {"tiny": 1.0}, settings, device="cpu", seed=seed,
                             mixing_prob=0.5)
    else:
        g = SG3Generator(**tiny_stylegan3(), device="cpu", seed=5)
        tr = ZSSGANSG3Trainer(g, losses, {"tiny": 1.0}, settings, device="cpu", seed=seed)
    tr.build_states(CRCTokenizer(cfg.vocab_size))
    return tr


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    return {prefix: tree}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_stats_as_made_each_call(dtype):
    mean, std = C.clip_stats(torch.device("cpu"), dtype)
    assert C.clip_stats(torch.device("cpu"), dtype)[0] is mean
    want_mean = torch.tensor(C.CLIP_MEAN, dtype=dtype)[None, :, None, None]
    want_std = torch.tensor(C.CLIP_STD, dtype=dtype)[None, :, None, None]
    assert torch.equal(mean, want_mean) and torch.equal(std, want_std)
    x = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(0)).to(dtype)
    assert torch.equal(C.clip_normalize(x), (x - want_mean) / want_std)


def test_trainer_camera_as_made_each_call():
    tr = _trainer("eg3d")
    for n in (2, 3):
        cam = tr.camera(n)
        assert tr.camera(n) is cam
        assert torch.equal(cam, canonical_camera(batch_size=n, device="cpu"))


@pytest.mark.parametrize("family", ["eg3d", "2d", "sg3"])
def test_draw_into_buffers_is_a_fresh_draw(family):
    tr = _trainer(family)
    fresh_gen = torch.Generator().manual_seed(3)
    fresh = _leaves(tr.draw(2, fresh_gen))
    buffers = tr.draw(2, torch.Generator().manual_seed(9))
    ptrs = {k: v.data_ptr() for k, v in _leaves(buffers).items()}
    gen = torch.Generator().manual_seed(3)
    got = _leaves(tr.draw(2, gen, out=buffers))
    assert got.keys() == fresh.keys() and got
    for k, v in got.items():
        assert v.data_ptr() == ptrs[k], k
        assert torch.equal(v, fresh[k]), k
    assert torch.equal(gen.get_state(), fresh_gen.get_state())


@pytest.mark.parametrize("family", ["eg3d", "sg3"])
def test_cpu_step_is_the_eager_step(family):
    """Two trainers from one seed: `step` and `eager_step` give the same loss
    and leaves bitwise, and each generator is where one step's draws leave
    a generator of that seed."""
    a, b = _trainer(family, seed=11), _trainer(family, seed=11)
    assert not a.graphed and not a.optimizer.defaults["capturable"]
    loss_a, loss_b = a.step(), b.eager_step()
    assert torch.equal(loss_a, loss_b)
    for (k, p), q in zip(a.trainable.named_parameters(), b.trainable.parameters()):
        assert torch.equal(p, q), k
    gen = torch.Generator().manual_seed(11)
    a.draw(2, gen)
    assert torch.equal(a.rng.get_state(), gen.get_state())
    assert torch.equal(b.rng.get_state(), gen.get_state())
    assert a._graph is None


def test_edit_ends_after_its_iterations():
    """After `iterations` steps the trainer keeps its trained twin and drops
    the gradients and Adam's moments; one more step raises."""
    tr = _trainer("sg3", iterations=2)
    start = {k: v.clone() for k, v in tr.trainable.state_dict().items()}
    tr.step()
    assert tr.optimizer.state and any(p.grad is not None for p in tr.trainable.parameters())
    tr.step()
    assert tr.steps_done == 2 and not tr.optimizer.state
    assert all(p.grad is None for p in tr.trainable.parameters())
    moved = {k for k, v in tr.trainable.state_dict().items() if not torch.equal(v, start[k])}
    assert moved and moved <= tr.mask
    with pytest.raises(RuntimeError, match="2 steps"):
        tr.step()


@pytest.mark.parametrize("family", ["eg3d", "2d", "sg3"])
def test_trainable_twin_copies_what_trains(family):
    """The default twin holds its own copy of every parameter it trains and
    of every buffer, and the frozen generator's own parameter elsewhere."""
    tr = _trainer(family)
    frozen = dict(tr.frozen.named_parameters())
    for k, p in tr.trainable.named_parameters():
        assert (p is frozen[k]) == (k not in tr.mask), k
        assert torch.equal(p, frozen[k])
    assert tr.mask and set(frozen) - tr.mask
    buffers = dict(tr.frozen.named_buffers())
    assert all(b is not buffers[k] for k, b in tr.trainable.named_buffers())


def _share(sl):
    return harness.load_module("metrics", "graph_replay_share").read(Input(None, sl, {}, {}))


def test_graph_replay_share_reader():
    """Four steps (us), three holding a replay; a replay outside any step
    does not count; None without a replay span or without steps."""
    steps = [("spi.step", 100 * i, 80) for i in range(4)]
    host = steps + [("spi.draws", 105, 5), ("spi.graph_replay", 115, 30),
                    ("spi.graph_replay", 215, 30), ("spi.graph_replay", 315, 30),
                    ("spi.graph_replay", 390, 5)]
    dev = [("k", 10, 500, "kernel")]
    assert _share(Slice(dev, host, 1e-3, [0, 1, 2, 3])) == pytest.approx(75.0)
    assert _share(Slice(dev, steps, 1e-3, [0, 1, 2, 3])) is None
    assert _share(Slice(dev, [("spi.graph_replay", 0, 5)], 1e-3, [0])) is None
