"""Published torch checkpoints -> the flat dotted-key npz both packages read
(counterpart of spi_tpu/convert.py: the same kinds, npz keys, dtypes and
`<dst>.json`).

Handles:
- the EG3D persistence pickle `ffhqrebalanced512-128.pkl` (persistence.py:37
  records each module's class source; it is loaded WITHOUT executing that
  source, through a stub unpickler) -> generator npz + init-kwargs json.
  EG3D writes its network pickles with `pickle.dump`
  (`legacy.load_network_pkl` reads them with `pickle.load`); a file that is
  a `torch.save` zip archive is read through `torch.load`, as spi_tpu reads
  it, and any other file through the stub unpickler directly;
- plain state_dict checkpoints: model_ir_se50.pth (ArcFace), bisenet.pth,
  VGG16/VGG19 `features` weights (from a given file: nothing is
  downloaded), NVIDIA's torchscript vgg16.pt, OpenAI CLIP (torchscript or a
  plain state dict, fp16 widened to float32).

Usage:
    python -m spi_tpu_torch.convert eg3d   checkpoints/ffhqrebalanced512-128.pkl out/eg3d.npz
    python -m spi_tpu_torch.convert irse50 checkpoints/model_ir_se50.pth out/irse50.npz
    python -m spi_tpu_torch.convert vgg16  checkpoints/vgg16.pth out/vgg16.npz
    python -m spi_tpu_torch.convert clip   checkpoints/ViT-B-32.pt out/ViT-B-32.npz
"""

from __future__ import annotations

import io
import json
import pickle
import sys
from typing import Any

import numpy as np
import torch

# The first bytes of a zip archive, which is what `torch.save` writes.
_ZIP_MAGIC = b"PK\x03\x04"

# ---------------------------------------------------------------------------
# Persistence-pickle loading without executing embedded source
# ---------------------------------------------------------------------------


class _PersistentStub:
    """Stands in for a persistence-reconstructed torch module: keeps the
    recorded init args and raw state so parameters can be walked out."""

    def __init__(self, meta: dict):
        self.meta = meta

    @property
    def class_name(self) -> str:
        return self.meta.get("class_name", "?")

    @property
    def state(self) -> dict:
        return self.meta.get("state", {})


def _stub_reconstruct(meta):
    return _PersistentStub(meta)


class _EasyDict(dict):
    def __getattr__(self, k):
        return self[k]

    def __setattr__(self, k, v):
        self[k] = v


class _StubUnpickler(pickle.Unpickler):
    """Resolves EG3D's persistence and dnnlib names to stubs, so that the
    class source a persistence pickle carries is never run."""

    def find_class(self, module, name):
        if name == "_reconstruct_persistent_obj":
            return _stub_reconstruct
        if name == "EasyDict":
            return _EasyDict
        if module.startswith(("torch_utils", "dnnlib", "training", "legacy")):
            # Any other reference-internal symbol: a stub type.
            return _PersistentStub
        return super().find_class(module, name)


class _StubPickleModule:
    """The `pickle_module` handed to `torch.load` for a zip archive."""

    Unpickler = _StubUnpickler

    @staticmethod
    def load(f, **kw):
        return _StubUnpickler(f).load()

    @staticmethod
    def loads(s, **kw):
        return _StubUnpickler(io.BytesIO(s)).load()


def load_persistence_pickle(path: str) -> dict:
    """The pickle's top-level dict with the persistence machinery stubbed
    out. A `torch.save` archive goes through torch.load; a `pickle.dump`
    file (EG3D's own) through the stub unpickler, whose tensors rebuild
    through torch's storage pickling."""
    with open(path, "rb") as f:
        if f.read(len(_ZIP_MAGIC)) != _ZIP_MAGIC:
            f.seek(0)
            return _StubUnpickler(f).load()
    return torch.load(path, map_location="cpu", pickle_module=_StubPickleModule)


def _walk_module_state(state: dict, prefix: str, out: dict[str, np.ndarray]):
    """Recursively collect parameters/buffers from an nn.Module __dict__
    (persistence stores module state as the raw __dict__)."""
    for kind in ("_parameters", "_buffers"):
        for name, tensor in (state.get(kind) or {}).items():
            if tensor is None:
                continue
            out[prefix + name] = tensor.detach().cpu().numpy()
    for name, sub in (state.get("_modules") or {}).items():
        if sub is None:
            continue
        if isinstance(sub, _PersistentStub):
            _walk_module_state(sub.state, f"{prefix}{name}.", out)
        elif isinstance(sub, torch.nn.Module):
            for pname, tensor in sub.state_dict().items():
                out[f"{prefix}{name}.{pname}"] = tensor.detach().cpu().numpy()


def eg3d_pickle_to_flat(path: str, key: str = "G_ema"):
    """Returns (flat {torch_name: ndarray}, init_kwargs dict)."""
    data = load_persistence_pickle(path)
    g = data[key]
    if not isinstance(g, _PersistentStub):
        raise TypeError(f"{key} is a {type(g).__name__}, not a persistence-pickled module")
    flat: dict[str, np.ndarray] = {}
    _walk_module_state(g.state, "", flat)
    init_kwargs = g.meta.get("init_kwargs") or g.state.get("init_kwargs") or {}
    # persistence records construction args on the object
    for k in ("_init_kwargs", "init_kwargs"):
        if k in g.state and g.state[k]:
            init_kwargs = g.state[k]
    return flat, _to_plain(init_kwargs)


def _to_plain(obj: Any):
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    return obj


# ---------------------------------------------------------------------------
# torch-name -> flat-key mapping for the generator
# ---------------------------------------------------------------------------

_SKIP_SUFFIXES = ("resample_filter", "num_batches_tracked")


def map_generator_names(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The generator's flat keys are torch state_dict names, so this is a
    filter (drop the constant filters and batch counters) + float32."""
    out = {}
    for name, arr in flat.items():
        if name.endswith(_SKIP_SUFFIXES):
            continue
        out[name] = np.asarray(arr, dtype=np.float32)
    return out


def convert_eg3d(src: str, dst: str):
    flat, init_kwargs = eg3d_pickle_to_flat(src)
    mapped = map_generator_names(flat)
    np.savez(dst, **mapped)
    with open(dst + ".json", "w") as f:
        json.dump(init_kwargs, f, indent=2, default=str)
    print(f"wrote {len(mapped)} arrays to {dst}")
    return mapped, init_kwargs


# ---------------------------------------------------------------------------
# Plain state_dict conversions
# ---------------------------------------------------------------------------


def convert_state_dict(src: str, dst: str, strip_prefix: str = ""):
    sd = torch.load(src, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    out = {}
    for name, tensor in sd.items():
        if name.endswith(_SKIP_SUFFIXES):
            continue
        if strip_prefix and name.startswith(strip_prefix):
            name = name[len(strip_prefix):]
        out[name] = tensor.detach().cpu().numpy().astype(np.float32)
    np.savez(dst, **out)
    print(f"wrote {len(out)} arrays to {dst}")
    return out


def convert_torchvision_vgg(arch: str, dst: str, weights_path: str | None = None):
    """VGG16/19 `features` weights for LPIPS / BoxCX, from a torchvision
    state dict file (`vgg16-397923af.pth`, ...). `arch` names the kind."""
    if not weights_path:
        raise ValueError(f"{arch}: the torchvision weights must be supplied as a file; "
                         "nothing is downloaded")
    sd = torch.load(weights_path, map_location="cpu")
    out = {
        name: t.detach().cpu().numpy().astype(np.float32)
        for name, t in sd.items()
        if name.startswith("features.")
    }
    np.savez(dst, **out)
    print(f"wrote {len(out)} arrays to {dst}")
    return out


# NVIDIA torchscript vgg16.pt layer names -> torchvision `features` indices
_NV_VGG16_INDEX = {
    "conv1_1": 0, "conv1_2": 2,
    "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
    "conv4_1": 17, "conv4_2": 19, "conv4_3": 21,
    "conv5_1": 24, "conv5_2": 26, "conv5_3": 28,
}
_LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def map_nvidia_vgg16_names(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """NVIDIA torchscript vgg16.pt state_dict -> the LPIPS flat layout
    ({'features.{i}.weight/bias', 'lin.{l}'}).

    The torchscript model (w_projector.py:30 `vgg16.pt`,
    `return_lpips=True`) carries the 13 VGG16 convs under conv{b}_{i}
    names plus five 1x1 LPIPS lin heads; its LPIPS embedding is the
    unit-normalized activations scaled by sqrt(lin)/sqrt(H*W), so the
    converted weights drop into `LPIPS` directly.
    """
    out: dict[str, np.ndarray] = {}
    lin_by_order: list[np.ndarray] = []
    for name, value in flat.items():
        arr = np.asarray(value, np.float32)
        matched = False
        for conv, idx in _NV_VGG16_INDEX.items():
            if conv in name and name.endswith((".weight", ".bias")):
                kind = name.rsplit(".", 1)[1]
                # lin heads reuse conv names in some exports; a (1,C,1,1)
                # weight is a lin head, a 4-d (Cout,Cin,3,3) is the conv
                if kind == "weight" and arr.ndim == 4 and arr.shape[0] == 1 \
                        and arr.shape[2:] == (1, 1):
                    lin_by_order.append(arr.reshape(-1))
                else:
                    out[f"features.{idx}.{kind}"] = arr
                matched = True
                break
        if matched:
            continue
        if ("lin" in name or "lpips" in name) and name.endswith(".weight"):
            lin_by_order.append(arr.reshape(-1))
    if len(lin_by_order) == len(_LPIPS_CHANNELS) and all(
        v.shape[0] == c for v, c in zip(lin_by_order, _LPIPS_CHANNELS)
    ):
        for i, v in enumerate(lin_by_order):
            out[f"lin.{i}"] = v
    missing = [
        f"features.{i}.weight" for i in _NV_VGG16_INDEX.values()
        if f"features.{i}.weight" not in out
    ]
    if missing:
        raise ValueError(f"vgg16.pt conversion missing conv weights: {missing}")
    return out


def convert_nvidia_vgg16(src: str, dst: str):
    """Convert the NVIDIA torchscript `vgg16.pt` (StyleGAN projector
    oracle, w_projector.py:30) to the LPIPS flat npz."""
    model = torch.jit.load(src, map_location="cpu")
    flat = {
        k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()
    }
    out = map_nvidia_vgg16_names(flat)
    np.savez(dst, **out)
    print(f"wrote {len(out)} arrays to {dst}")
    return out


def convert_clip(src: str, dst: str):
    """OpenAI CLIP release checkpoints (ViT-B-32.pt / ViT-B-16.pt /
    RN50.pt) are torchscript archives with fp16 weights
    (ZSSGAN/criteria/clip_loss.py:32-35 PATH_DICT). Their state_dict keys
    are `models/perception/clip.CLIP`'s, so `load_flat_params` reads the
    npz as it is."""
    try:
        model = torch.jit.load(src, map_location="cpu")
        sd = model.state_dict()
    except RuntimeError:
        sd = torch.load(src, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    out = {}
    for name, tensor in sd.items():
        if name.endswith(_SKIP_SUFFIXES) or "attn_mask" in name:
            continue
        # torchscript archives carry extra JIT buffers; keep weights only
        if name in ("input_resolution", "context_length", "vocab_size"):
            continue
        out[name] = tensor.detach().float().cpu().numpy()
    np.savez(dst, **out)
    print(f"wrote {len(out)} arrays to {dst}")
    return out


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) != 3:
        raise SystemExit(__doc__)
    kind, src, dst = argv
    if kind == "eg3d":
        convert_eg3d(src, dst)
    elif kind in ("vgg16", "vgg19"):
        convert_torchvision_vgg(kind, dst, weights_path=src if src != "-" else None)
    elif kind == "clip":
        convert_clip(src, dst)
    elif kind == "nvidia_vgg16":
        convert_nvidia_vgg16(src, dst)
    else:
        convert_state_dict(src, dst)


if __name__ == "__main__":
    main()
