"""What the entries share of the port: its generator configuration from a
configuration file's published widths."""

from __future__ import annotations


def triplane_config(g: dict, compute_dtype: str):
    from spi_tpu_torch.models.rendering import RenderingOptions
    from spi_tpu_torch.models.triplane import TriPlaneConfig

    return TriPlaneConfig(
        z_dim=g["z_dim"], c_dim=g["c_dim"], w_dim=g["w_dim"],
        img_resolution=g["img_resolution"], backbone_resolution=g["backbone_resolution"],
        plane_channels=g["plane_channels"],
        neural_rendering_resolution=g["neural_rendering_resolution"],
        rendering=RenderingOptions(depth_resolution=g["depth_resolution"],
                                   depth_resolution_importance=g["depth_resolution_importance"],
                                   ray_start=g["ray_start"], ray_end=g["ray_end"],
                                   box_warp=g["box_warp"]),
        sr_variant=g["sr_variant"], channel_base=g["channel_base"],
        channel_max=g["channel_max"], compute_dtype=compute_dtype)
