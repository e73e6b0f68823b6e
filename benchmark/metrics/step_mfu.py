"""The whole step's share of the card's peak: the configuration's model
FLOPs of one image-step (benchmark/flops/<config>.py) times the window's
image-steps a second, over the configuration's peak (`peak_tflops`)."""

UNIT = "%"


def read(m):
    flops = m.cell.image_step_flops()
    return 100.0 * flops * m.e2e["img_steps_per_s"] / (m.config["peak_tflops"] * 1e12)
