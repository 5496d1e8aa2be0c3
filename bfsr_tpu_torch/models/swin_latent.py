"""Swin-Transformer latent module (``swin_latent``): the counterpart of
``bfsr_tpu/models/swin_latent.py`` (the reference's
``LINF-LP/models/swin_transformer.py``).

DenseBlock_5C projections of the latent z and of the LR (stride-3 conv,
LeakyReLU, DenseBlock_5C, bilinear-resized to z's grid), each embed 96
-> concat (192 channels, NHWC) -> 4 layers of Swin blocks (depths
2/2/6/2, heads 3/6/12/24, window 7, MLP ratio 4, a constant width) ->
LayerNorm -> a 1x1-conv head back to ``in_chans``.

The reference's quirks, kept: each block zero-pads its normed map to a
window multiple and crops after; the layer's shifted-window mask is
applied to every block of the layer, the unshifted ones too; the LR
projection runs at stride 3 and is resized to z's size.

The two dense blocks convolve to 96 channels, which neither K3 takes:
they run ``fnn.conv2d`` (XLA convs in the JAX package), as do the LR
conv and the head; the attention and MLP products are ``fnn.linear`` /
``fnn.matmul`` (``models/swinir.py``).  Everything follows the stage's
precision (the ``prior`` stage of the predictors and the trainer).

``forward(z, lr, training=True, generator=g)`` is the trainer's form:
stochastic depth at the rates ``linspace(0, drop_path_rate=0.1, 12)``,
each residual's keep mask drawn from ``g`` (none without a generator),
returning ``(out, {})``: no BatchNorm, so ``apply_bn_updates`` has
nothing to fold.

``state_dict`` keys are the reference's: ``input_proj.conv{1..5}``,
``lr_proj.0``, ``lr_proj.2.conv{1..5}``, ``layers.{i}.blocks.{j}.*``,
``norm``, ``head.{0,2,4}``.
"""

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.swinir import (SwinBlock, attn_mask,
                                          drop_path_rates, init_swin_)
from bfsr_tpu_torch.models.unet import DenseBlock5C, lr_embed
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.registry import register

DEPTHS = (2, 2, 6, 2)
NUM_HEADS = (3, 6, 12, 24)
EMBED_DIM, MLP_RATIO = 96, 4.0


class _Layer(nn.Module):
    def __init__(self, dim, depth, num_heads, ws, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList(
            [SwinBlock(dim, num_heads, ws, mlp_ratio) for _ in range(depth)])


def init_dense_(module, generator):
    """Every conv of ``module`` torch's default, then its DenseBlock_5Cs
    kaiming-normal (fan in) x 0.1 with zero biases
    (``bfsr_tpu/models/unet.py:init_dense_block5c``)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fnn.init_conv_(m, generator)
    for m in module.modules():
        if isinstance(m, DenseBlock5C):
            for c in m.convs():
                fnn.init_conv_(c, generator, "kaiming_normal_fan_in", 0.1)


@register("swin_latent")
class SwinLatent(Model):
    registry_name = "swin_latent"

    def __init__(self, in_chans, inp_size=None, window_size=7):
        super().__init__()
        self.args = dict(in_chans=in_chans, inp_size=inp_size,
                         window_size=window_size)
        self.window_size = window_size
        # the training form's stochastic depth (the reference's default)
        self.drop_path_rate = 0.1
        dim = EMBED_DIM * 2
        self.input_proj = DenseBlock5C(in_chans, EMBED_DIM, EMBED_DIM)
        self.lr_proj = nn.Sequential(
            nn.Conv2d(3, in_chans, 3, stride=3, padding=1),
            nn.LeakyReLU(0.2, True),
            DenseBlock5C(in_chans, EMBED_DIM, EMBED_DIM))
        self.layers = nn.ModuleList(
            [_Layer(dim, d, h, window_size, MLP_RATIO)
             for d, h in zip(DEPTHS, NUM_HEADS)])
        self.norm = nn.LayerNorm(dim)
        self.head = nn.Sequential(
            nn.Conv2d(dim, dim // 2, 1), nn.LeakyReLU(0.2, True),
            nn.Conv2d(dim // 2, dim // 4, 1), nn.LeakyReLU(0.2, True),
            nn.Conv2d(dim // 4, in_chans, 1))
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        init_dense_(self, generator)
        init_swin_(self, generator)

    def freeze(self):
        """No kernel layouts to keep: no conv here takes K3."""
        return self

    def forward(self, z, lr, kernels=True, training=False, generator=None):
        """z: (B, H, W, in_chans); lr: (B, h, w, 3) -> (B, H, W,
        in_chans), or with ``training=True`` ``(out, {})``.  ``kernels`` is
        accepted for the latent-module interface; no conv here has a
        kernel."""
        ws = self.window_size
        x = self.input_proj(z)
        x = torch.cat([x, lr_embed(self.lr_proj, lr, x.shape[1:3])], -1)
        H, W = x.shape[1], x.shape[2]
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        mask = attn_mask(Hp, Wp, ws, ws // 2, x.device)
        rates = drop_path_rates(DEPTHS, self.drop_path_rate)
        gen = generator if training else None
        gi = 0
        for layer in self.layers:
            for bi, blk in enumerate(layer.blocks):
                x = blk(x, 0 if bi % 2 == 0 else ws // 2, mask, rates[gi],
                        gen, pad=True)
                gi += 1
        x = fnn.layer_norm(x, self.norm)
        h = self.head
        x = fnn.leaky_relu(fnn.conv2d(x, h[0].weight, h[0].bias))
        x = fnn.leaky_relu(fnn.conv2d(x, h[2].weight, h[2].bias))
        out = fnn.conv2d(x, h[4].weight, h[4].bias)
        return (out, {}) if training else out

    def apply_bn_updates(self, bn_stats, momentum=0.1):
        """No BatchNorm: nothing to fold."""
