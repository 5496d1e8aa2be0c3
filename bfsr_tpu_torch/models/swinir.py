"""SwinIR encoder (``swinir``) and the Swin parts the latent module
shares: the counterpart of ``bfsr_tpu/models/swinir.py``.

The shared parts: ``relative_position_index``, ``window_partition`` /
``window_reverse``, ``attn_mask`` (the 0 / -100 mask of shifted windows),
``WindowAttention`` (the relative-position bias added before the
softmax, and the mask), ``SwinBlock`` (pre-norm window attention and MLP,
each on a residual) and ``drop_path``, timm's stochastic depth: a
per-sample Bernoulli keep mask on the residual branch, scaled by 1/keep,
drawn from the caller's ``torch.Generator`` (the JAX package draws it
from a PRNG key: the same rule, other bits).

The attention and MLP products are ``fnn.linear`` / ``fnn.matmul``, as
the JAX package runs them as plain ``jnp`` products; the softmax sums
are explicit (the bias and the shift mask are added to the scores), so
no fused attention call computes them.  Every conv is ``fnn.conv2d``:
the JAX package runs them on XLA, no Pallas kernel.  All follow the
stage's precision (the ``encoder`` stage of the LINF predictors).

The encoder (embed 180, 6 layers of 6 blocks, heads 6, window 8, MLP
ratio 2, ``num_feat`` 64, upsampler 'none': the only one LINF uses, so
``no_upsampling`` is read as the JAX package reads it) reflect-pads the LR to a
window multiple and returns the padded feature map, as the reference's
``check_image_size`` + 'none' path does; the eval loop's window protocol
(``pipelines/linf_eval.py:_window_pad``, ``cli/test.py --window 8``)
queries the padded grid.  ``forward(x, training=True, generator=g)``
applies stochastic depth at the rates ``linspace(0, drop_path_rate,
sum(depths))``; otherwise every block is the identity's residual.

``state_dict`` keys are the reference's: ``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.{norm1,
attn.qkv, attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1,
mlp.fc2}``, ``layers.{i}.conv``, ``norm``, ``conv_after_body``,
``conv_before_upsample.0``.  The reference's buffers
``relative_position_index`` and ``attn_mask`` are recomputed here and
dropped when a reference state_dict is loaded.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.registry import register


def relative_position_index(ws):
    """(ws^2, ws^2) indices into the (2 ws - 1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x, ws):
    """(B, H, W, C) -> (B nW, ws^2, C), windows row-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows, ws, B, H, W):
    C = windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.lru_cache(maxsize=16)
def attn_mask(H, W, ws, shift, device=None):
    """(nW, ws^2, ws^2) mask of the shifted windows of an (H, W) map: -100
    between tokens that come from different regions, else 0.  Built on
    ``device`` once a shape (the JAX package builds it at trace time)."""
    img = torch.zeros((1, H, W, 1), device=device)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w] = cnt
            cnt += 1
    mw = window_partition(img, ws)[..., 0]
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def drop_path(x, rate, generator):
    """timm's DropPath: each sample's ``x`` kept with probability 1 - rate
    and then scaled by 1 / (1 - rate), else zeroed; the keep draws are
    uniforms from ``generator`` (on ``x``'s device), for the global batch
    in a data-parallel step (``fnn.global_rows``).  The identity at rate
    0 or without a generator."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = fnn.global_rows(lambda n: torch.rand(
        (n,) + (1,) * (x.dim() - 1), generator=generator, device=x.device),
        x.shape[0])
    return x * (u < keep).to(x.dtype) / keep


def _drop_keys(state_dict, prefix, names):
    for name in names:
        state_dict.pop(prefix + name, None)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, ws):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.register_buffer(
            "rel_index", torch.as_tensor(relative_position_index(ws)),
            persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        _drop_keys(state_dict, prefix, ("relative_position_index",))
        super()._load_from_state_dict(state_dict, prefix, *args)

    def forward(self, x, mask=None):
        """x: (B_, N, C) windows; mask: (nW, N, N) or None."""
        B_, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = fnn.linear(x, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(B_, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = fnn.matmul(q, k.transpose(-2, -1))
        bias = self.relative_position_bias_table[self.rel_index.reshape(-1)]
        attn = attn + bias.reshape(N, N, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, nh, N, N)
                    + mask[None, :, None]).reshape(B_, nh, N, N)
        out = fnn.matmul(torch.softmax(attn, -1), v)
        out = out.transpose(1, 2).reshape(B_, N, C)
        return fnn.linear(out, self.proj.weight, self.proj.bias)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        h = F.gelu(fnn.linear(x, self.fc1.weight, self.fc1.bias))
        return fnn.linear(h, self.fc2.weight, self.fc2.bias)


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, ws, mlp_ratio):
        super().__init__()
        self.ws = ws
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _load_from_state_dict(self, state_dict, prefix, *args):
        _drop_keys(state_dict, prefix, ("attn_mask",))
        super()._load_from_state_dict(state_dict, prefix, *args)

    def forward(self, x, shift=0, mask=None, dp_rate=0.0, generator=None,
                pad=False):
        """x: (B, H, W, C).  ``shift``: the cyclic shift of the windows;
        ``mask``: the attention mask, None for none.  ``pad``: zero-pad the
        normed map to a window multiple and crop after (the latent
        module's blocks), else H and W are window multiples.  Stochastic
        depth at ``dp_rate`` on both residuals with ``generator``."""
        B, H, W, C = x.shape
        ws = self.ws
        h = fnn.layer_norm(x, self.norm1)
        if pad:
            h = F.pad(h, (0, 0, 0, (ws - W % ws) % ws, 0, (ws - H % ws) % ws))
        Hp, Wp = h.shape[1], h.shape[2]
        if shift:
            h = torch.roll(h, (-shift, -shift), (1, 2))
        h = window_reverse(self.attn(window_partition(h, ws), mask), ws, B,
                           Hp, Wp)
        if shift:
            h = torch.roll(h, (shift, shift), (1, 2))
        x = x + drop_path(h[:, :H, :W], dp_rate, generator)
        return x + drop_path(self.mlp(fnn.layer_norm(x, self.norm2)),
                             dp_rate, generator)


def init_swin_(module, generator):
    """The init of ``bfsr_tpu/models/swinir.py:init_swin_block`` for every
    Swin part of ``module``: linears torch's default, bias tables
    N(0, 0.02^2) kept within 2 sigma (``fmod``), LayerNorms the
    identity."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fnn.init_linear_(m, generator)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        elif isinstance(m, WindowAttention):
            with torch.no_grad():
                t = m.relative_position_bias_table
                t.copy_(torch.fmod(torch.randn(t.shape, generator=generator),
                                   2.0) * 0.02)


def drop_path_rates(depths, drop_path_rate):
    """Each block's stochastic-depth rate, in order:
    ``linspace(0, drop_path_rate, sum(depths))``."""
    return [float(r) for r in np.linspace(0.0, drop_path_rate, sum(depths))]


class RSTB(nn.Module):
    def __init__(self, dim, depth, num_heads, ws, mlp_ratio):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList(
            [SwinBlock(dim, num_heads, ws, mlp_ratio) for _ in range(depth)])
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)


def _conv(x, conv):
    return fnn.conv2d(x, conv.weight, conv.bias)


@register("swinir")
class SwinIR(Model):
    registry_name = "swinir"

    def __init__(self, no_upsampling=True, embed_dim=180, depths=(6,) * 6,
                 num_heads=(6,) * 6, window_size=8, mlp_ratio=2.0,
                 num_feat=64):
        super().__init__()
        self.args = dict(no_upsampling=no_upsampling, embed_dim=embed_dim,
                         depths=list(depths), num_heads=list(num_heads),
                         window_size=window_size, mlp_ratio=mlp_ratio,
                         num_feat=num_feat)
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.window_size = window_size
        # the training form's stochastic depth (the reference's default)
        self.drop_path_rate = 0.1
        self.out_dim = num_feat
        self.conv_first = nn.Conv2d(3, embed_dim, 3, padding=1)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = nn.LayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            [RSTB(embed_dim, d, h, window_size, mlp_ratio)
             for d, h in zip(self.depths, self.num_heads)])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, padding=1), nn.LeakyReLU(0.01))
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)
        init_swin_(self, generator)

    def freeze(self):
        """No kernel layouts to keep: every conv is ``fnn.conv2d``."""
        return self

    def forward(self, x, kernels=True, training=False, generator=None):
        """x: (B, h, w, 3) -> (B, Hp, Wp, num_feat), Hp and Wp the next
        window multiples.  ``kernels`` is accepted for the LINF encoder
        interface; no conv here has a kernel."""
        ws = self.window_size
        B, h, w, _ = x.shape
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            x = fnn.nchw_to_nhwc(F.pad(fnn.nhwc_to_nchw(x), (0, pw, 0, ph),
                                       mode="reflect"))
        H, W = x.shape[1], x.shape[2]
        feat = _conv(x, self.conv_first)
        gen = generator if training else None
        rates = drop_path_rates(self.depths, self.drop_path_rate)
        mask = attn_mask(H, W, ws, ws // 2, x.device)
        t = fnn.layer_norm(feat, self.patch_embed.norm)
        gi = 0
        for layer in self.layers:
            res = t
            for bi, blk in enumerate(layer.residual_group.blocks):
                shift = 0 if bi % 2 == 0 else ws // 2
                res = blk(res, shift, mask if shift else None, rates[gi],
                          gen)
                gi += 1
            t = t + _conv(res, layer.conv)
        t = fnn.layer_norm(t, self.norm)
        deep = _conv(t, self.conv_after_body) + feat
        return fnn.leaky_relu(_conv(deep, self.conv_before_upsample[0]),
                              0.01)
