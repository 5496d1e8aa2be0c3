"""JAX parameter pytrees (as numpy arrays) -> the port's modules.

The reverse of ``bfsr_tpu/convert/torch_import.py``: it builds a
reference-keyed ``state_dict`` from a ``bfsr_tpu`` params pytree, so
``bfsr_tpu.convert.torch_import.convert_linf`` (any of its encoders:
EDSR, RRDB, RDN, SwinIR) / ``convert_unet`` / ``convert_swin_latent`` /
``convert_edsr_latent`` / ``convert_mlp`` / ``convert_srflow`` /
``convert_srflow_unet`` map the port's ``state_dict`` back to the same
pytree.

* conv: HWIO -> OIHW;
* the LINF MLP, stored as linears (in, out) -> 1x1 convs (out, in, 1, 1);
* the phase linear and every other linear (in, out) -> (out, in);
* LayerNorm scale/bias -> weight/bias;
* flow ``w``/``b`` as they are, per layer (``w_inv``/``logabsdet`` are
  recomputed in float64 by ``freeze()``);
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (the running stats too, so a trainer's BN state carries over);
* VGG19 convs -> torchvision's ``features.{i}`` indices;
* LPIPS's AlexNet convs -> the ``lpips`` package's ``net.slice{k}.{i}``,
  its lin heads (C, 1) -> ``lin{k}.model.1.weight`` (1, C, 1, 1);
* SRFlow actnorm bias/logs (C,) -> (1, C, 1, 1), Conv2dZeros logs (C,) ->
  (C, 1, 1), invconv ``w`` (C, C) as it is (``w_inv`` and the folds are
  recomputed in float64 by ``freeze()``).

Leaves may be numpy arrays or anything ``np.asarray`` takes; this module
imports no jax.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if p.get("b") is not None:
        sd[prefix + ".bias"] = _t(p["b"])


def _bn(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])
    sd[prefix + ".running_mean"] = _t(p["mean"])
    sd[prefix + ".running_var"] = _t(p["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0)


def edsr_state_dict(params, prefix=""):
    """Reference-keyed state_dict of an EDSR, with its upsampler
    (``tail.0.{0,2,..}``, ``tail.1``) where the params have one."""
    sd = {}
    _conv(sd, prefix + "head.0", params["head"])
    for i, blk in enumerate(params["body"]):
        _conv(sd, f"{prefix}body.{i}.body.0", blk["conv1"])
        _conv(sd, f"{prefix}body.{i}.body.2", blk["conv2"])
    _conv(sd, f"{prefix}body.{len(params['body'])}", params["body_tail"])
    for i, p in enumerate(params.get("upsampler", ())):
        _conv(sd, f"{prefix}tail.0.{2 * i}", p)
    if "tail" in params:
        _conv(sd, prefix + "tail.1", params["tail"])
    return sd


def rdn_state_dict(params, prefix=""):
    """Reference-keyed state_dict of an RDN, with its ``UPNet`` where the
    params have one."""
    sd = {}
    _conv(sd, prefix + "SFENet1", params["sfe1"])
    _conv(sd, prefix + "SFENet2", params["sfe2"])
    for i, rdb in enumerate(params["rdbs"]):
        for j, c in enumerate(rdb["convs"]):
            _conv(sd, f"{prefix}RDBs.{i}.convs.{j}.conv.0", c)
        _conv(sd, f"{prefix}RDBs.{i}.LFF", rdb["lff"])
    _conv(sd, prefix + "GFF.0", params["gff1"])
    _conv(sd, prefix + "GFF.1", params["gff2"])
    for i, p in enumerate(params.get("upnet", ())):
        _conv(sd, f"{prefix}UPNet.{2 * i}", p)
    return sd


def _linear(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).T)
    if p.get("b") is not None:
        sd[prefix + ".bias"] = _t(p["b"])


def _ln(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _swin_block(sd, prefix, p):
    _ln(sd, prefix + ".norm1", p["norm1"])
    _linear(sd, prefix + ".attn.qkv", p["attn"]["qkv"])
    _linear(sd, prefix + ".attn.proj", p["attn"]["proj"])
    sd[prefix + ".attn.relative_position_bias_table"] = _t(
        p["attn"]["bias_table"])
    _ln(sd, prefix + ".norm2", p["norm2"])
    _linear(sd, prefix + ".mlp.fc1", p["mlp_fc1"])
    _linear(sd, prefix + ".mlp.fc2", p["mlp_fc2"])


def swinir_state_dict(params, prefix=""):
    """Reference-keyed state_dict of the SwinIR encoder."""
    sd = {}
    _conv(sd, prefix + "conv_first", params["conv_first"])
    if params.get("patch_norm") is not None:
        _ln(sd, prefix + "patch_embed.norm", params["patch_norm"])
    for li, layer in enumerate(params["layers"]):
        for bi, blk in enumerate(layer["blocks"]):
            _swin_block(sd, f"{prefix}layers.{li}.residual_group.blocks.{bi}",
                        blk)
        _conv(sd, f"{prefix}layers.{li}.conv", layer["conv"])
    _ln(sd, prefix + "norm", params["norm"])
    _conv(sd, prefix + "conv_after_body", params["conv_after_body"])
    _conv(sd, prefix + "conv_before_upsample.0",
          params["conv_before_upsample"])
    return sd


def linf_state_dict(params, encoder_name="edsr-baseline"):
    """Reference-keyed state_dict of a LINF or LINF patch model whose
    encoder is the registry's ``encoder_name``: ``edsr-baseline``,
    ``edsr``, ``rrdb``, ``rdn`` or ``swinir``."""
    if encoder_name not in ENCODER_STATE_DICTS:
        raise NotImplementedError(f"LINF encoder {encoder_name!r}: expected "
                                  f"one of {sorted(ENCODER_STATE_DICTS)}")
    sd = ENCODER_STATE_DICTS[encoder_name](params["encoder"],
                                           prefix="encoder.")
    _conv(sd, "coef", params["coef"])
    _conv(sd, "freq", params["freq"])
    sd["phase.weight"] = _t(np.asarray(params["phase"]["w"]).T)
    for i, lp in enumerate(params["mlp"]):
        sd[f"layers.{2 * i}.weight"] = _t(np.asarray(lp["w"]).T[:, :, None, None])
        sd[f"layers.{2 * i}.bias"] = _t(lp["b"])
    w, b = np.asarray(params["imnet"]["w"]), np.asarray(params["imnet"]["b"])
    n_layers = w.shape[0] - 1
    for i in range(n_layers):
        sd[f"imnet.linears.{i}._weight"] = _t(w[i])
        sd[f"imnet.linears.{i}.bias"] = _t(b[i])
    sd["imnet.last._weight"] = _t(w[n_layers])
    sd["imnet.last.bias"] = _t(b[n_layers])
    return sd


def _dense5(sd, prefix, p):
    for i in range(1, 6):
        _conv(sd, f"{prefix}.conv{i}", p[f"conv{i}"])


def _double_conv(sd, prefix, p):
    _conv(sd, prefix + ".double_conv.0", p["conv1"])
    _bn(sd, prefix + ".double_conv.1", p["bn1"])
    _conv(sd, prefix + ".double_conv.3", p["conv2"])
    _bn(sd, prefix + ".double_conv.4", p["bn2"])


def unet_state_dict(params):
    """Reference-keyed state_dict of the LINF-LP UNet prior."""
    sd = {}
    _dense5(sd, "input_proj", params["input_proj"])
    _conv(sd, "lr_proj.0", params["lr_proj_conv"])
    _dense5(sd, "lr_proj.2", params["lr_proj_dense"])
    _double_conv(sd, "inc", params["inc"])
    for i, p in enumerate(params["down"]):
        _double_conv(sd, f"down_layers.{i}.maxpool_conv.1", p)
    for i, p in enumerate(params["up"]):
        _double_conv(sd, f"up_layers.{i}.conv", p)
    _conv(sd, "outc.conv", params["outc"])
    return sd


def swin_latent_state_dict(params):
    """Reference-keyed state_dict of the Swin latent module."""
    sd = {}
    _dense5(sd, "input_proj", params["input_proj"])
    _conv(sd, "lr_proj.0", params["lr_proj_conv"])
    _dense5(sd, "lr_proj.2", params["lr_proj_dense"])
    for li, layer in enumerate(params["layers"]):
        for bi, blk in enumerate(layer["blocks"]):
            _swin_block(sd, f"layers.{li}.blocks.{bi}", blk)
    _ln(sd, "norm", params["norm"])
    for i, p in enumerate(params["head"]):
        _conv(sd, f"head.{2 * i}", p)
    return sd


def edsr_latent_state_dict(params):
    """Reference-keyed state_dict of the EDSR latent module."""
    sd = {}
    _dense5(sd, "input_proj", params["input_proj"])
    _conv(sd, "lr_proj.0", params["lr_proj_conv"])
    _dense5(sd, "lr_proj.2", params["lr_proj_dense"])
    for i, blk in enumerate(params["body"]):
        _conv(sd, f"body.{i}.body.0", blk["conv1"])
        _conv(sd, f"body.{i}.body.2", blk["conv2"])
    _conv(sd, "last_conv", params["last_conv"])
    return sd


def mlp_state_dict(params):
    """Reference-keyed state_dict of an ``mlp`` (``layers.{0,2,..}``)."""
    sd = {}
    for i, p in enumerate(params["layers"]):
        _linear(sd, f"layers.{2 * i}", p)
    return sd


def rrdb_state_dict(params, prefix=""):
    """Reference-keyed state_dict of an RRDBNet, with its head where the
    params have one (``upconv3`` from x8, ``upconv4`` at x16)."""
    sd = {}
    _conv(sd, prefix + "conv_first", params["conv_first"])
    for i, blk in enumerate(params["trunk"]):
        for j in (1, 2, 3):
            _dense5(sd, f"{prefix}RRDB_trunk.{i}.RDB{j}", blk[f"rdb{j}"])
    for name, key in (("trunk_conv", "trunk_conv"), ("upconv1", "upconv1"),
                      ("upconv2", "upconv2"), ("upconv3", "upconv3"),
                      ("upconv4", "upconv4"),
                      ("HRconv", "hr_conv"),
                      ("conv_last", "conv_last")):
        if key in params:
            _conv(sd, prefix + name, params[key])
    return sd


# LINF's encoders by registry name
ENCODER_STATE_DICTS = {"edsr-baseline": edsr_state_dict,
                       "edsr": edsr_state_dict, "rrdb": rrdb_state_dict,
                       "rdn": rdn_state_dict, "swinir": swinir_state_dict}


def _actnorm(sd, prefix, p):
    sd[prefix + ".bias"] = _t(p["bias"]).reshape(1, -1, 1, 1)
    sd[prefix + ".logs"] = _t(p["logs"]).reshape(1, -1, 1, 1)


def _flow_tower(sd, prefix, p):
    for idx, key in ((0, "conv1"), (2, "conv2")):
        _conv(sd, f"{prefix}.{idx}", {"w": p[key]["w"]})
        _actnorm(sd, f"{prefix}.{idx}.actnorm", p[key]["actnorm"])
    _conv_zeros(sd, f"{prefix}.4", p["out"])


def _conv_zeros(sd, prefix, p):
    _conv(sd, prefix, p)
    sd[prefix + ".logs"] = _t(p["logs"]).reshape(-1, 1, 1)


def flow_step_state_dict(p, prefix=""):
    """Reference-keyed state_dict of one flow step (actnorm, invconv and,
    for a conditional step, the affine coupling)."""
    sd = {}
    _actnorm(sd, prefix + "actnorm", p["actnorm"])
    sd[prefix + "invconv.weight"] = _t(p["invconv"]["w"])
    if "affine" in p:
        _flow_tower(sd, prefix + "affine.fFeatures", p["affine"]["fFeatures"])
        _flow_tower(sd, prefix + "affine.fAffine", p["affine"]["fAffine"])
    return sd


def srflow_state_dict(params, plan):
    """Reference-keyed state_dict of an SRFlowNet (``RRDB.*`` and
    ``flowUpsamplerNet.layers.{i}.*``, aligned with ``plan``)."""
    sd = rrdb_state_dict(params["rrdb"], prefix="RRDB.")
    for i, (entry, p) in enumerate(zip(plan, params["flow"]["layers"])):
        pre = f"flowUpsamplerNet.layers.{i}"
        if entry["kind"] in ("step_nc", "step_cond"):
            sd.update(flow_step_state_dict(p, pre + "."))
        elif entry["kind"] == "split":
            _conv_zeros(sd, pre + ".conv", p["conv"])
    return sd


def srflow_unet_state_dict(params):
    """Reference-keyed state_dict of the SRFlow-LP two-branch prior."""
    sd = {}
    for b in (0, 1):
        p = params[f"branch{b}"]
        _dense5(sd, f"input_proj{b}", p["input_proj"])
        _double_conv(sd, f"inc{b}", p["inc"])
        for i, q in enumerate(p["down"]):
            _double_conv(sd, f"down_layers{b}.{i}.maxpool_conv.1", q)
        for i, q in enumerate(p["up"]):
            _double_conv(sd, f"up_layers{b}.{i}.conv", q)
        _conv(sd, f"outc{b}.conv", p["outc"])
    return sd


# the latent modules by registry name
PRIOR_STATE_DICTS = {"unet": unet_state_dict,
                     "swin_latent": swin_latent_state_dict,
                     "edsr-baseline-latent": edsr_latent_state_dict,
                     "srflow-unet": srflow_unet_state_dict}


def vgg_state_dict(params, feature_layer=34):
    """torchvision-keyed state_dict (``features.{i}.*``) of a VGG19
    feature extractor cut after layer ``feature_layer``."""
    from bfsr_tpu_torch.models.vgg import layer_plan

    sd, convs = {}, iter(params["convs"])
    for i, item in enumerate(layer_plan(feature_layer)):
        if item[0] == "conv":
            _conv(sd, f"features.{i}", next(convs))
    return sd


def load_vgg(vgg, params):
    """Install JAX VGG19 feature params into a port
    ``VGGFeatureExtractor``."""
    vgg.load_state_dict(vgg_state_dict(params, vgg.args["feature_layer"]))
    return vgg


def load_srflow(model, params):
    """Install JAX SRFlowNet params into a port ``SRFlowNet``, freeze it."""
    model.load_state_dict(srflow_state_dict(params, model.plan))
    return model.freeze()


def load_srflow_unet(prior, params):
    """Install JAX two-branch prior params into a port ``SRFlowUNet``."""
    prior.load_state_dict(srflow_unet_state_dict(params))
    return prior.freeze()


def load_linf(model, params):
    """Install JAX LINF params into a port ``LINF`` / ``LINFPatch`` (any
    registered encoder) and freeze it."""
    model.load_state_dict(linf_state_dict(
        params, model.args["encoder_spec"]["name"]))
    return model.freeze()


def load_prior(prior, params):
    """Install JAX latent-module params into a port ``UNet``,
    ``SwinLatent``, ``EDSRLatent`` or ``SRFlowUNet`` and freeze it."""
    prior.load_state_dict(PRIOR_STATE_DICTS[prior.registry_name](params))
    return prior.freeze()


def load_unet(prior, params):
    """Install JAX UNet params into a port ``UNet`` and freeze it."""
    prior.load_state_dict(unet_state_dict(params))
    return prior.freeze()


def lpips_state_dict(params):
    """The published ``lpips`` package's keys for JAX LPIPS params
    (``{'convs': [{'w', 'b'}] x5, 'lins': [(C, 1)] x5}``)."""
    from bfsr_tpu_torch.models.lpips import _FEATURES, _SLICES

    sd = {}
    for k, ((lo, hi), p) in enumerate(zip(_SLICES, params["convs"])):
        i = next(i for i in range(lo, hi) if isinstance(_FEATURES[i], tuple))
        _conv(sd, f"net.slice{k + 1}.{i}", p)
    for i, w in enumerate(params["lins"]):
        sd[f"lin{i}.model.1.weight"] = _t(np.asarray(w).T[:, :, None, None])
    return sd
