"""Mean-squared-error loss (counterpart of spi_tpu/criteria/l2_loss.py;
spec spi/criteria/l2_loss.py:3-8)."""


def l2_loss(a, b):
    return (a - b).square().mean()
