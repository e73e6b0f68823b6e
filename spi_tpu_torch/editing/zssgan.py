"""Twin-generator CLIP-guided domain editing, ZSSGAN / StyleGAN-NADA
(counterpart of spi_tpu/editing/zssgan.py; spec ZSSGAN/model/ZSSGAN_eg3d.py
and ZSSGAN/train.py).

A frozen and a trainable copy of a (usually SPI-tuned) EG3D generator
render the same w codes at the canonical camera with random noise; the
weighted sum of each CLIP model's directional loss moves the trainable
copy toward the target text. Only the backbone's synthesis convolutions
train (`conv_mask`), or, for IDE3D, every synthesis layer
(`synthesis_mask`).

The mask is a set of flat keys of the generator's state (spi_tpu's True
leaves: parameters, and the `noise_const` buffers, which get no
gradient). Adam runs over the masked parameters only. That equals
spi_tpu's masked optax Adam because beta1 = 0 makes a zero gradient a
zero update; the others do not require a gradient, so the backward
skips them.

Every random number of a step (z, each render's noise maps and renderer
draws, the patch centres) comes from the trainer's `torch.Generator` on
its device, or from the `draws` a caller hands `step` (tests hand
spi_tpu's).

On a card, every step after the first replays one CUDA graph of the whole
step (the twins' renders, the CLIP losses, the backward and Adam), so the
host issues one launch where it issued thousands; its draws are written
into the graph's input buffers first. The patch term reads its crop
offsets back to the host, so a trainer with it, and any trainer off the
card, issues each step operator by operator (`eager_step`).

A trainer runs one edit of `settings.iterations` steps. After the last it
keeps the trained twin and frees what only the steps use: the graph (whose
private memory pool holds a step's activations), its input buffers, the
gradients and Adam's moments; a further step raises.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import torch

from spi_tpu_torch.editing.clip_loss import CLIPLossState, draw_patch_centers
from spi_tpu_torch.models.rendering.renderer import draw_randoms
from spi_tpu_torch.ops import _lib
from spi_tpu_torch.utils.camera import canonical_camera
from spi_tpu_torch.utils.device import module_device, resolve_device
from spi_tpu_torch.utils.params import to_device
from spi_tpu_torch.utils.stats import span


@dataclasses.dataclass(frozen=True)
class EditingSettings:
    """The CLI's knobs (ZSSGAN/options/train_options.py defaults)."""

    source_class: str = "photo"
    target_class: str = "sketch"
    lr: float = 0.002
    g_reg_every: int = 4  # only sets the StyleGAN2-style lr and beta scaling
    batch: int = 2
    iterations: int = 301
    truncation: float = 0.7  # EG3DGenerator.style's default (ZSSGAN_eg3d.py:87)
    sample_truncation: float = 0.7
    auto_layer_iters: int = 0
    auto_layer_k: int = 0
    auto_layer_batch: int = 8
    lambda_direction: float = 1.0
    lambda_patch: float = 0.0
    lambda_global: float = 0.0
    lambda_manifold: float = 0.0
    lambda_texture: float = 0.0

    @property
    def g_reg_ratio(self) -> float:
        return self.g_reg_every / (self.g_reg_every + 1)

    @property
    def adam(self) -> dict:
        """torch.optim.Adam's arguments (train.py:46-52): lr * r, betas
        (0 ** r, 0.99 ** r)."""
        r = self.g_reg_ratio
        return {"lr": self.lr * r, "betas": (0.0 ** r, 0.99 ** r), "eps": 1e-8}


def _select(module, keep) -> set[str]:
    return {k for k in module.state_dict() if keep(k.split("."))}


def conv_mask(module) -> set[str]:
    """The flat keys of every backbone synthesis conv0 / conv1 subtree:
    modulated convolutions, their affines and noise (not torgb, the
    mapping, the decoder or the superresolution)."""
    return _select(module, lambda n: len(n) >= 4 and n[:2] == ["backbone", "synthesis"]
                   and n[3] in ("conv0", "conv1"))


def synthesis_mask(module) -> set[str]:
    """Every backbone synthesis layer's keys, ToRGB included
    (ZSSGAN_IDE3D.get_training_layers, ZSSGAN_IDE3D.py:35-51)."""
    return _select(module, lambda n: len(n) >= 2 and n[:2] == ["backbone", "synthesis"])


class TwinGeneratorTrainer:
    """The frozen / trainable twin step shared by the EG3D and 2D trainers
    (train.py:66-81); subclasses give `draw_w`, `sample_w`, `draw_render`,
    `render` and `grad_mask`.

    frozen: the generator on `device`; trainable: its twin (default a
    deep copy of `frozen` that shares its parameters outside `grad_mask`,
    which never change). clip_losses: {name: DirectionalCLIPLoss};
    clip_weights: {name: weight}. device: None means the card (raises
    without a GPU)."""

    def __init__(self, frozen, clip_losses: dict, clip_weights: dict,
                 settings: EditingSettings = EditingSettings(), trainable=None, device=None,
                 seed: int = 0):
        self.device = resolve_device(device)
        if module_device(frozen) != self.device:
            raise ValueError(f"the generator is on {module_device(frozen)}, "
                             f"the trainer on {self.device}")
        self.settings = settings
        self.clip_losses = clip_losses
        self.clip_weights = clip_weights
        self.frozen = frozen.eval().requires_grad_(False)
        if trainable is None:
            keep = self.grad_mask(frozen)
            trainable = copy.deepcopy(frozen, {id(p): p for name, p in frozen.named_parameters()
                                               if name not in keep})
        self.trainable = trainable
        self.mask = self.grad_mask(self.trainable)
        params = []
        for name, p in self.trainable.named_parameters():
            p.requires_grad_(name in self.mask)
            if name in self.mask:
                params.append(p)
        self.graphed = self.device.type == "cuda" and not any(
            loss.lambda_patch for loss in clip_losses.values())
        self.optimizer = torch.optim.Adam(params, **settings.adam, capturable=self.graphed)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self.states: dict[str, CLIPLossState] | None = None
        self.steps_done = 0
        self._graph = None

    # -- what a generator family defines ----------------------------------
    # draw_w and draw_render draw into `out`'s tensors where it is given (a
    # dict as they return), in the order and shapes of a fresh draw.
    def draw_w(self, n: int, generator, out=None) -> dict:
        raise NotImplementedError

    def sample_w(self, w_draws: dict, truncation=None):
        raise NotImplementedError

    def draw_render(self, n: int, generator, out=None) -> dict:
        raise NotImplementedError

    def render(self, g, ws, render_draws: dict):
        raise NotImplementedError

    def grad_mask(self, module) -> set[str]:
        raise NotImplementedError

    # -- the shared machinery ----------------------------------------------
    def draw(self, n: int, generator=None, out=None) -> dict:
        """One step's draws for a batch of n: {'w', 'frozen', 'trainable'},
        from `generator` (default the trainer's), in that order; into
        `out`'s tensors where it is given (a dict as this returns)."""
        gen = self.rng if generator is None else generator
        out = out or {}
        return {"w": self.draw_w(n, gen, out.get("w")),
                "frozen": self.draw_render(n, gen, out.get("frozen")),
                "trainable": self.draw_render(n, gen, out.get("trainable"))}

    def build_states(self, tokenizer) -> dict[str, CLIPLossState]:
        """Each CLIP model's text-side state, once."""
        s = self.settings
        self.states = {name: loss.build_state(tokenizer, s.source_class, s.target_class)
                       for name, loss in self.clip_losses.items()}
        return self.states

    def clip_loss(self, frozen_img, trainable_img, patch_centers=None):
        """The weighted sum over the CLIP models (ZSSGAN_eg3d.py:255); the
        patch term's centres are shared by every model."""
        if self.states is None:
            raise RuntimeError("build_states first")
        if patch_centers is None and any(loss.lambda_patch for loss in self.clip_losses.values()):
            patch_centers = draw_patch_centers(frozen_img.shape[0], frozen_img.shape[-1],
                                               self.rng, self.device)
        total = 0.0
        for name, loss in self.clip_losses.items():
            total += self.clip_weights[name] * loss(frozen_img, trainable_img, self.states[name],
                                                    patch_centers=patch_centers)
        return total

    def step(self, draws: dict | None = None):
        """One Adam step of the trainable twin; returns the loss (a 0-dim
        tensor). draws: as `draw` gives, plus optionally 'patch_centers';
        else drawn from the trainer's generator.

        Where `graphed`, step 0 runs eagerly on the device's capture stream
        (lazy initialisation, the libraries' first calls on that stream,
        Adam's state), step 1 captures the step on it as one CUDA graph,
        and it and every later step load their draws into the graph's
        input buffers and replay it. A capture that fails raises. After
        the edit's last step (`settings.iterations`) the trainer frees what
        only the steps use; a further step raises."""
        s = self.settings
        if self.steps_done == s.iterations:
            raise RuntimeError(f"this trainer has run its edit's {s.iterations} steps")
        if not self.graphed:
            loss = self.eager_step(draws)
        elif self.steps_done == 0:
            stream, current = _capture_stream(self.device), torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                loss = self.eager_step(draws)
            current.wait_stream(stream)
            loss.record_stream(current)
        else:
            loss = self._replay(draws)
        self.steps_done += 1
        if self.steps_done == s.iterations:
            self._graph = self._inputs = self._loss = None
            self.optimizer.zero_grad(set_to_none=True)
            self.optimizer.state.clear()
        return loss

    def eager_step(self, draws: dict | None = None):
        """`step` issued operator by operator: every step off the card or
        with the patch term, step 0 on the card, and what the graph is
        checked against (on a trainer that has not captured it)."""
        with span("spi.step"):
            with span("spi.draws"):
                d = (self.draw(self.settings.batch) if draws is None
                     else to_device(draws, self.device))
            return self._body(d)

    def _body(self, d):
        """The step after its draws, eager or captured."""
        ws = self.sample_w(d["w"])
        with torch.no_grad():
            frozen_img = self.render(self.frozen, ws, d["frozen"])
        trainable_img = self.render(self.trainable, ws, d["trainable"])
        loss = self.clip_loss(frozen_img, trainable_img, d.get("patch_centers"))
        self.optimizer.zero_grad(set_to_none=True)
        with span("spi.backward"):
            loss.backward()
        with span("spi.optimizer"):
            self.optimizer.step()
        return loss.detach()

    def _replay(self, draws):
        with span("spi.step"):
            if self._graph is None:
                self._capture(draws)
            else:
                self._load(draws)
            with span("spi.graph_replay"):
                self._graph.replay()
            for name, n in self._graph_launches.items():
                _lib.launch_counts[name] += n
            return self._loss.clone()

    def _capture(self, draws):
        """The graph's input buffers, laid out by a draw from a generator of
        their own (the trainer's is left as it is) and loaded as any later
        step's; then the body captured once. Its gradients are made inside
        the graph, which writes them anew on every replay."""
        self._inputs = self.draw(self.settings.batch, torch.Generator(self.device).manual_seed(0))
        self._load(draws)
        self.optimizer.zero_grad(set_to_none=True)
        before = dict(_lib.launch_counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=_capture_stream(self.device)):
            self._loss = self._body(self._inputs)
        # The capture launched nothing: each replay counts the launches.
        self._graph_launches = {k: n - before[k] for k, n in _lib.launch_counts.items()
                                if n != before[k]}
        _lib.launch_counts.update(before)
        self._graph = graph

    def _load(self, draws):
        """The step's draws into the graph's input buffers: from the
        trainer's generator in `draw`'s order, or copied from `draws` (a
        buffer `draws` leaves out keeps its last values)."""
        with span("spi.draws"):
            if draws is None:
                self.draw(self.settings.batch, out=self._inputs)
            else:
                _copy_into(self._inputs, draws)


@functools.cache
def _capture_stream(device: torch.device):
    """The stream every trainer on `device` captures its graph on: one, so
    that the libraries' per-stream workspaces are made once."""
    return torch.cuda.Stream(device)


def _copy_into(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


class ZSSGANTrainer(TwinGeneratorTrainer):
    """Twin TriPlaneGenerators (ZSSGAN_eg3d.py): w from the frozen mapping at
    the canonical camera, renders there with random noise."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cameras: dict[int, torch.Tensor] = {}

    def camera(self, n: int):
        """The canonical camera of a batch of n, made on the device once per n."""
        if n not in self._cameras:
            self._cameras[n] = canonical_camera(batch_size=n, device=self.device)
        return self._cameras[n]

    def draw_w(self, n, generator, out=None):
        out = out or {}
        return {"z": torch.randn((n, self.frozen.z_dim), generator=generator,
                                 device=self.device, out=out.get("z"))}

    @torch.no_grad()
    def sample_w(self, w_draws, truncation=None):
        """z -> the frozen mapping with truncation (ZSSGAN_eg3d.py:87-91, 246)."""
        z = w_draws["z"]
        psi = self.settings.truncation if truncation is None else truncation
        return self.frozen.mapping(z, self.camera(z.shape[0]), truncation_psi=psi)

    def draw_render(self, n, generator, out=None):
        cfg = self.frozen.cfg
        out = out or {}
        return {"noise": self.frozen.draw_noise(n, generator, out.get("noise")),
                **draw_randoms(cfg.rendering, n, cfg.neural_rendering_resolution ** 2,
                               self.device, generator, out)}

    def render(self, g, ws, render_draws):
        return g.synthesis(ws, self.camera(ws.shape[0]), noise_mode="random",
                           draws=render_draws)["image"]

    def grad_mask(self, module):
        return conv_mask(module)

    def rank_w_slots(self, draws: dict | None = None):
        """determine_opt_layers' ranking (ZSSGAN_eg3d.py:161-188):
        `auto_layer_iters` SGD steps (lr 0.01) on `auto_layer_batch` w codes
        against the global CLIP loss of the trainable twin's renders (one
        set of render draws for every step); returns each w slot's mean
        |delta w| (num_ws,). draws: {'w', 'render'}."""
        s = self.settings
        if draws is None:
            draws = {"w": self.draw_w(s.auto_layer_batch, self.rng),
                     "render": self.draw_render(s.auto_layer_batch, self.rng)}
        d = to_device(draws, self.device)
        ws0 = self.sample_w(d["w"])
        ws = ws0.clone()
        for _ in range(s.auto_layer_iters):
            ws.requires_grad_(True)
            img = self.render(self.trainable, ws, d["render"])
            total = sum(self.clip_weights[name] * loss.global_loss(
                img, self.states[name].target_tokens) for name, loss in self.clip_losses.items())
            (grad,) = torch.autograd.grad(total, ws)
            ws = (ws - 0.01 * grad).detach()
        return (ws - ws0).abs().mean(dim=(0, 2))


class IDE3DZSSGANTrainer(ZSSGANTrainer):
    """IDE3D's training semantics over a TriPlaneGenerator
    (ZSSGAN_IDE3D.py:325-499): every synthesis layer trains, ToRGB too.
    An IDE3D checkpoint's own architecture is not ported (nor is it in
    spi_tpu)."""

    def grad_mask(self, module):
        return synthesis_mask(module)
