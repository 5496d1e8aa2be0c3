"""Importing this package registers ``edsr-baseline``, ``flow``, ``linf``,
``linf-patch``, ``unet``, ``VGGFeatureExtractor``, ``rrdb``, ``srflow``
and ``srflow-unet``."""

from bfsr_tpu_torch.models import (edsr, flow_linf, linf, rrdb,  # noqa: F401
                                   unet, vgg)
from bfsr_tpu_torch.models.srflow import srflow_net, unet_prior  # noqa: F401
