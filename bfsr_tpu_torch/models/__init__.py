"""Importing this package registers the encoders ``edsr-baseline``,
``edsr``, ``rrdb``, ``rdn`` and ``swinir``; the LINF models ``linf`` and
``linf-patch`` with their ``flow``; the latent modules ``unet``,
``swin_latent`` and ``edsr-baseline-latent``; ``mlp``;
``VGGFeatureExtractor``; and SRFlow's ``srflow`` and ``srflow-unet``."""

from bfsr_tpu_torch.models import (edsr, edsr_latent, flow_linf,  # noqa: F401
                                   linf, mlp, rdn, rrdb, swin_latent, swinir,
                                   unet, vgg)
from bfsr_tpu_torch.models.srflow import srflow_net, unet_prior  # noqa: F401
