from spi_tpu_torch.models.rendering.ray_sampler import sample_rays
from spi_tpu_torch.models.rendering.renderer import ImportanceRenderer, RenderingOptions

__all__ = ["ImportanceRenderer", "RenderingOptions", "sample_rays"]
