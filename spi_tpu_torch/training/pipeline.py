"""Per-image inversion pipeline: stage-1 projection -> stage-2 tuning ->
artifacts and metrics (counterpart of spi_tpu/training/pipeline.py; the
reference coaches' train() loops, base_coach.py + pti_coach.py /
rot_bbox_cx_coach.py, with the output tree of run_inversion.py:60-79).

Images are inverted one after another, or with `parallel_images` B > 1
B at a time in one batched program (`invert_batch`). Each starts from the
weights the generator had when the pipeline was built (stage 2 tunes it
in place) and draws its randomness from a `torch.Generator` seeded from
the run's seed and a CRC-32 of the image's name, so that an image inverts
alike in any run and any order, alone or in a batch.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Any

import numpy as np
import torch

from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
from spi_tpu_torch.criteria.id_loss import IDLoss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.data.dataset import InversionSample, face_mask_from_parsing
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.parallel.mesh import spmd_invert
from spi_tpu_torch.training import coaches, projectors
from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils.checkpoint import (
    load_flat_params,
    module_flat,
    save_flat,
    split_perception,
)
from spi_tpu_torch.utils.device import module_device, resolve_device
from spi_tpu_torch.utils.image import save_image
from spi_tpu_torch.utils.metrics import Metric, MetricLog
from spi_tpu_torch.utils.params import index_tree, replace_noise
from spi_tpu_torch.utils.video import render_orbit_video


@dataclasses.dataclass
class PipelineConfig:
    """CLI-level knobs (names follow spi/run_inversion.py:18-42 and
    spi/configs/hyperparameters.py)."""

    output_root: str = "test/output/"
    first_inv_type: str = "sg"  # 'sg' | 'sgw+' | 'mir'
    first_inv_steps: int = 500
    G_1_type: str = "RotBbox"  # 'pti' | 'RotBbox' | 'Inference'
    G_1_step: int = 1000
    pt_rot_lambda: float = 0.1
    pt_mirror_rot_lambda: float = 0.05
    pt_depth_lambda: float = 1.0
    pt_tv_lambda: float = 0.0
    # Early-stop threshold (hyperparameters.py:13); negative disables it.
    lpips_threshold: float = 0.05
    use_adapt_yaw_range: bool = False
    max_images_to_invert: int = 3000
    load_embedding_coach_name: str | None = None
    description: str | None = None
    seed: int = 0
    # Render an orbit video of each tuned generator into video/<coach>/.
    save_video: bool = False
    # Save the in-progress reconstruction every N tuning steps
    # (global_config.py:7, rot_bbox_cx_coach.py:153-154); 0 = off.
    log_snapshot: int = 0
    # Compute dtype of the loss LPIPS's VGG (the generator's lives on its
    # config); the metric's LPIPS stays float32, as spi_tpu's Metric.
    lpips_compute_dtype: str = "float32"
    # Invert this many images at a time in one batched program
    # (parallel/mesh.py spmd_invert); 1 = one after another.
    parallel_images: int = 1

    @property
    def coach_name(self) -> str:
        """Run-identity string (base_coach.py:240-269)."""
        name = "RotBboxCoach" if self.G_1_type == "RotBbox" else (
            "SingleIDCoach" if self.G_1_type == "pti" else "InferenceCoach")
        name += f"_{self.first_inv_type}_{self.first_inv_steps}"
        name += f"_{self.G_1_type}_{self.G_1_step}"
        name += f"_rot_{self.pt_rot_lambda}"
        name += f"_mirrorrot_{self.pt_mirror_rot_lambda}"
        name += f"_depth_{self.pt_depth_lambda}"
        name += f"_tv_{self.pt_tv_lambda}"
        if self.use_adapt_yaw_range:
            name += "_wadyaw"
        if self.description:
            name += f"_{self.description}"
        return name

    def dirs(self) -> dict[str, str]:
        root = self.output_root
        return {
            "checkpoints": os.path.join(root, "checkpoints", self.coach_name),
            "embedding": os.path.join(root, "embedding", self.coach_name),
            "experiments": os.path.join(root, "experiments"),
            "image": os.path.join(root, "image", self.coach_name),
            "image_m": os.path.join(root, "image_m", self.coach_name),
            "video": os.path.join(root, "video", self.coach_name),
        }


class InversionPipeline:
    """generator: on `device`, holding the pretrained (or seeded random)
    weights. perception: an optional flat perception bundle ('lpips.*',
    'boxcx.*', 'metric.*' keys, pipeline.py:108-125); a section it lacks
    keeps its seeded weights, and without a 'metric' section the metric's
    float32 LPIPS takes the losses' LPIPS weights. device: None means `cuda` (raises without a
    GPU)."""

    def __init__(self, generator: TriPlaneGenerator, config: PipelineConfig,
                 perception: dict[str, np.ndarray] | None = None, device=None):
        self.device = resolve_device(device)
        if module_device(generator) != self.device:
            raise ValueError(f"generator is on {module_device(generator)}, not {self.device}")
        self.generator = generator
        self.config = config
        # Stage 2 tunes the generator in place; each image starts from these.
        self.g_state0 = {k: v.detach().clone() for k, v in generator.state_dict().items()}
        sections = split_perception(perception or {})
        dev, seed = self.device, config.seed
        self.lpips = LPIPS(device=dev, seed=seed + 1, compute_dtype=config.lpips_compute_dtype)
        self.box_cx = BoxCXLoss(device=dev, seed=seed + 2)
        # The metric's LPIPS is float32 (spi_tpu's Metric) and holds the
        # losses' LPIPS weights unless the bundle has a 'metric' section.
        self.metric = Metric(LPIPS(device=dev, seed=seed + 1), IDLoss(device=dev, seed=seed + 3))
        for section, module in (("lpips", self.lpips), ("boxcx", self.box_cx)):
            if section in sections:
                load_flat_params(module, sections[section])
        self.metric.lpips.load_state_dict(self.lpips.state_dict())
        if "metric" in sections:
            load_flat_params(self.metric, sections["metric"])
        self.metric_log = MetricLog()
        self.dirs = config.dirs()
        for d in self.dirs.values():
            os.makedirs(d, exist_ok=True)
        self._snapshot_name = None

    def projector_settings(self) -> projectors.ProjectorSettings:
        return projectors.ProjectorSettings(mode=self.config.first_inv_type,
                                            num_steps=self.config.first_inv_steps)

    def coach_settings(self, adapt_yaw_range: float) -> coaches.CoachSettings:
        c = self.config
        if c.G_1_type == "pti":
            return dataclasses.replace(coaches.pti_settings(c.G_1_step),
                                       lpips_threshold=c.lpips_threshold)
        return coaches.CoachSettings(
            num_steps=c.G_1_step, lpips_threshold=c.lpips_threshold,
            rot_lambda=c.pt_rot_lambda, mirror_rot_lambda=c.pt_mirror_rot_lambda,
            depth_lambda=c.pt_depth_lambda, tv_lambda=c.pt_tv_lambda,
            yaw_range=adapt_yaw_range, log_snapshot=c.log_snapshot)

    def _snapshot_cb(self, step, img):
        """image/<coach>/<name>_step<k>.jpg, as rot_bbox_cx_coach.py:154."""
        save_image(img, os.path.join(self.dirs["image"], f"{self._snapshot_name}_step{step}.jpg"))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def image_rng(self, name: str) -> torch.Generator:
        """The image's generator, seeded from (seed, crc32(name)): Python's
        hash() is salted per process, a CRC is not."""
        digest = zlib.crc32(name.encode()) & 0x7FFFFFFF
        return torch.Generator(device=self.device).manual_seed(self.config.seed * 2**32 + digest)

    def get_inversion(self, sample: InversionSample, rng: torch.Generator):
        """Stage-1 w pivot and noise maps, with the embedding cache of
        base_coach.py:62-99: read from `load_embedding_coach_name`'s
        directory where the image is there, else projected and written."""
        if self.config.load_embedding_coach_name is not None:
            path = os.path.join(self.config.output_root, "embedding",
                                self.config.load_embedding_coach_name, f"{sample.name}.npz")
            if os.path.exists(path):
                with np.load(path) as data:
                    w = torch.from_numpy(data["w"]).to(self.device)
                    noise = {k[6:]: torch.from_numpy(data[k]).to(self.device)
                             for k in data.files if k.startswith("noise/")}
                return w, noise
        w, noise, _ = projectors.project(
            self.generator, self.lpips, torch.from_numpy(sample.image),
            torch.from_numpy(sample.camera), self.projector_settings(), rng=rng,
            device=self.device)
        save_flat(os.path.join(self.dirs["embedding"], f"{sample.name}.npz"),
                  {"w": w, **{f"noise/{k}": v for k, v in noise.items()}})
        return w, noise

    def invert_image(self, sample: InversionSample) -> dict[str, Any]:
        cfg, dev = self.config, self.device
        self.generator.load_state_dict(self.g_state0)
        self._snapshot_name = sample.name
        rng = self.image_rng(sample.name)
        image = torch.from_numpy(sample.image).to(dev)
        camera = torch.from_numpy(sample.camera).to(dev)
        # spi_tpu also hands the projector a foreground mask, which has no
        # effect there (spi_tpu/training/projectors.py:133).
        face_mask = None
        if sample.mask is not None:
            face_mask = torch.from_numpy(face_mask_from_parsing(sample.mask)).to(dev)

        t0 = time.time()
        w_pivot, noise = self.get_inversion(sample, rng)
        self._sync()
        t_stage1 = time.time() - t0

        t0 = time.time()
        steps_run = 0
        if cfg.G_1_type in ("pti", "RotBbox") and cfg.G_1_step > 0:
            adapt_yaw = 0.2
            if cfg.use_adapt_yaw_range:
                adapt_yaw = float(cam.cal_camera_gauss_weight(camera)[0])
            landmarks = (torch.from_numpy(sample.landmarks).to(dev)
                         if sample.landmarks is not None else None)
            _, (steps_run, _) = coaches.tune_generator(
                self.generator, self.lpips,
                coaches.CoachInputs(target=image, camera=camera, w_pivot=w_pivot,
                                    face_mask=face_mask, landmarks=landmarks),
                self.coach_settings(adapt_yaw), noise=noise, rng=rng, device=dev,
                snapshot_cb=self._snapshot_cb if cfg.log_snapshot > 0 else None,
                box_cx=self.box_cx)
            self._sync()
        t_stage2 = time.time() - t0
        # The tuned generator renders and is saved with the stage-1 noise
        # maps in its noise buffers, as spi_tpu substitutes them.
        with replace_noise(self.generator, noise):
            return self._finalize_image(sample.name, w_pivot, camera, image, t_stage1,
                                        t_stage2, steps_run)

    def _finalize_image(self, name, w_pivot, camera, image, t_stage1, t_stage2,
                        steps_run) -> dict[str, Any]:
        """Artifacts and metrics, mirrored ones too (base_coach.cal_metric /
        post_process)."""
        result = self.post_process(name, w_pivot, camera)
        result.update(name=name, stage1_s=t_stage1, stage2_s=t_stage2, steps_run=int(steps_run))
        m = self.metric.run(image, result.pop("final_image"))
        m_m = self.metric.run(image.flip(3), result.pop("final_image_m"))
        self.metric_log.add("G1_inv", m, m_m)
        result["metrics"] = {**m, **{f"{k}_m": v for k, v in m_m.items()}}
        return result

    def invert_batch(self, samples: list[InversionSample]) -> list[dict]:
        """Invert B images in one batched program (`config.parallel_images`;
        parallel/mesh.py `spmd_invert`): stage 1 and stage 2 run under
        torch.func.vmap, one launch a layer for the batch, and each image
        draws from its own generator as `invert_image` does, so that it
        comes out as it does alone, up to floating-point reassociation.

        As spi_tpu's batch path (spi_tpu/training/pipeline.py:306-392):
        stage 2 takes `coach_settings(0.2)`, no adaptive yaw range; stage 1
        takes no foreground mask; the embedding cache is written, not read;
        BoxCX runs only when every image has a mask and landmarks; each
        image's `stage1_s` is the batch's time / B and its `stage2_s` 0.
        Unlike spi_tpu's, stage 2 is skipped for G_1_type 'Inference' or
        G_1_step 0, as in `invert_image`.
        """
        cfg, dev = self.config, self.device
        self.generator.load_state_dict(self.g_state0)
        b = len(samples)
        images = torch.stack([torch.from_numpy(s.image) for s in samples]).to(dev)
        cameras = torch.stack([torch.from_numpy(s.camera) for s in samples]).to(dev)
        face_masks = landmarks = None
        if all(s.mask is not None for s in samples):
            face_masks = torch.stack([torch.from_numpy(face_mask_from_parsing(s.mask))
                                      for s in samples]).to(dev)
        if all(s.landmarks is not None for s in samples):
            landmarks = torch.stack([torch.from_numpy(s.landmarks) for s in samples]).to(dev)
        use_boxcx = (face_masks is not None and landmarks is not None
                     and cfg.G_1_type == "RotBbox" and cfg.pt_mirror_rot_lambda > 0)
        coach = self.coach_settings(0.2)
        if cfg.G_1_type not in ("pti", "RotBbox"):
            coach = dataclasses.replace(coach, num_steps=0)
        run = spmd_invert(self.generator, self.lpips, self.projector_settings(), coach,
                          box_cx=self.box_cx if use_boxcx else None, device=dev)
        t0 = time.time()
        w_b, noise_b, tuned, steps, _, _ = run(
            images, cameras, rngs=[self.image_rng(s.name) for s in samples],
            face_masks=face_masks, landmarks=landmarks)
        self._sync()
        per_image_s = (time.time() - t0) / b

        results = []
        params = dict(self.generator.named_parameters())
        for i, sample in enumerate(samples):
            noise = index_tree(noise_b, i)
            save_flat(os.path.join(self.dirs["embedding"], f"{sample.name}.npz"),
                      {"w": w_b[i], **{f"noise/{k}": v for k, v in noise.items()}})
            with torch.no_grad():
                for k, v in tuned.items():
                    params[k].copy_(v[i])
            with replace_noise(self.generator, noise):
                results.append(self._finalize_image(sample.name, w_b[i], cameras[i], images[i],
                                                    per_image_s, 0.0, steps[i]))
        self.generator.load_state_dict(self.g_state0)
        return results

    @torch.no_grad()
    def render(self, w, c):
        return self.generator.synthesis(
            w, c, noise_mode="const",
            generator=torch.Generator(device=self.device).manual_seed(0))["image"]

    def post_process(self, name: str, w, c) -> dict[str, Any]:
        """Save {w, c, G}, the image, the mirrored image
        (base_coach.py:219-226) and, with `save_video`, the orbit video
        (its file in the result's 'video')."""
        save_flat(os.path.join(self.dirs["checkpoints"], f"{name}.npz"),
                  {"w": w, "c": c, **module_flat(self.generator, "G.")})
        img = self.render(w, c)
        save_image(img, os.path.join(self.dirs["image"], f"{name}.jpg"))
        img_m = self.render(w, cam.mirror_camera(c))
        save_image(img_m, os.path.join(self.dirs["image_m"], f"{name}.jpg"))
        out = {"final_image": img, "final_image_m": img_m, "w": w.detach().cpu()}
        if self.config.save_video:
            _, out["video"] = render_orbit_video(self.generator, w,
                                                 os.path.join(self.dirs["video"], f"{name}.mp4"))
        return out

    def run(self, dataset) -> list[dict]:
        """Invert the dataset's images (at most `max_images_to_invert`): one
        after another, or in batches of `parallel_images` and then the
        remainder."""
        results, batch = [], []
        b = self.config.parallel_images
        for i, sample in enumerate(dataset):
            if i >= self.config.max_images_to_invert:
                break
            if b == 1:
                results.append(self.invert_image(sample))
                continue
            batch.append(sample)
            if len(batch) == b:
                results.extend(self.invert_batch(batch))
                batch = []
        if batch:
            results.extend(self.invert_batch(batch))
        header = (f"Coach name: {self.config.coach_name}\n"
                  f"first_inv_type: {self.config.first_inv_type}\n"
                  f"first_inv_steps: {self.config.first_inv_steps}\n"
                  f"G_1_step: {self.config.G_1_step}\n")
        self.metric_log.write(os.path.join(self.dirs["experiments"], "metric_log.txt"), header)
        return results
