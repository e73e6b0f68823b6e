from spi_tpu_torch.models.triplane import (
    TriPlaneConfig,
    TriPlaneGenerator,
    ffhq512_128_config,
    tiny_test_config,
)

__all__ = ["TriPlaneConfig", "TriPlaneGenerator", "ffhq512_128_config", "tiny_test_config"]
