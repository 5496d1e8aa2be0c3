"""Frozen VGG19 feature extractor for the trainer's perceptual loss.

The counterpart of ``bfsr_tpu/models/vgg.py`` (the reference's
``VGGFeatureExtractor``): torchvision VGG19 ``features[:feature_layer +
1]`` — by default 34, through conv5_4 before its ReLU — with ImageNet
input normalisation.  The layers keep torchvision's indices, so
``features.{i}.weight`` / ``.bias`` are the keys of torchvision's VGG19
``state_dict``.  NHWC in and out; inside, one NCHW pass of cuDNN convs
(TF32 off), which follow the stage's precision, forward and backward, as
``ops/nn.conv2d`` does (``ops/nn.conv2d_nchw``).

No weights are bundled: ``reset_parameters`` draws torch's default init,
as ``init_vgg19_features`` does; random features still define a (noisy)
perceptual loss.
"""

import torch
import torch.nn.functional as F
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.registry import register

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def layer_plan(feature_layer):
    """torchvision's layers up to and including index ``feature_layer``:
    ('conv', cin, cout), ('relu',) and ('pool',)."""
    plan, cin = [], 3
    for v in VGG19_CFG:
        if v == "M":
            plan.append(("pool",))
        else:
            plan += [("conv", cin, v), ("relu",)]
            cin = v
    return plan[:feature_layer + 1]


@register("VGGFeatureExtractor")
class VGGFeatureExtractor(Model):
    registry_name = "VGGFeatureExtractor"

    def __init__(self, feature_layer=34, use_bn=False, use_input_norm=True):
        super().__init__()
        if use_bn:
            raise NotImplementedError("the vgg19_bn variant is unused by the "
                                      "reference configs")
        self.args = dict(feature_layer=feature_layer, use_bn=use_bn,
                         use_input_norm=use_input_norm)
        self.use_input_norm = use_input_norm
        layers = []
        for item in layer_plan(feature_layer):
            if item[0] == "conv":
                layers.append(nn.Conv2d(item[1], item[2], 3, padding=1))
            elif item[0] == "relu":
                layers.append(nn.ReLU(True))
            else:
                layers.append(nn.MaxPool2d(2))
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)

    def forward(self, x):
        """x: (B, H, W, 3) in [0, 1] -> features (B, h, w, C)."""
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        x = fnn.nhwc_to_nchw(x)
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                x = fnn.conv2d_nchw(x, m.weight, m.bias, padding=1)
            elif isinstance(m, nn.ReLU):
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2)
        return fnn.nchw_to_nhwc(x)
