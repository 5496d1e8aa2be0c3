"""Importing this package registers ``edsr-baseline``, ``flow``, ``linf``,
``linf-patch``, ``unet``, ``VGGFeatureExtractor``, ``srflow`` and
``srflow-unet``."""

from bfsr_tpu_torch.models import edsr, flow_linf, linf, unet, vgg  # noqa: F401
from bfsr_tpu_torch.models.srflow import srflow_net, unet_prior  # noqa: F401
