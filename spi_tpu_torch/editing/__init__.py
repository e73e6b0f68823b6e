"""CLIP-guided domain editing of a tuned EG3D generator (counterpart of
spi_tpu/editing; spec ZSSGAN / StyleGAN-NADA: ZSSGAN/model/ZSSGAN_eg3d.py,
ZSSGAN/criteria/clip_loss.py, ZSSGAN/train.py): twin frozen / trainable
generators rendered at the canonical camera, moved along a CLIP text
direction with only the backbone's synthesis convolutions trained.
"""

from spi_tpu_torch.editing.clip_loss import CLIPLossState, DirectionalCLIPLoss
from spi_tpu_torch.editing.zssgan import (
    EditingSettings,
    IDE3DZSSGANTrainer,
    ZSSGANTrainer,
)

__all__ = [
    "CLIPLossState",
    "DirectionalCLIPLoss",
    "EditingSettings",
    "IDE3DZSSGANTrainer",
    "ZSSGANTrainer",
]
