"""Dataset construction: landmarks -> 3DMM camera -> crop -> parsing mask
(counterpart of spi_tpu/preprocess; spec preprocess/run_total.py's
per-image pipeline). The perception networks (FAN landmarker, ResNet-50
3DMM regressor, BiSeNet parser) are PyTorch modules on the run's device;
the alignment and camera math stay numpy on the host, as the reference's.
"""
