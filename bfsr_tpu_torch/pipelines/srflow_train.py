"""SRFlow base-model training: one train step of the whole SRFlowNet.

The counterpart of ``bfsr_tpu/pipelines/srflow_train.py:
make_srflow_train_step`` (the reference's ``SRFlow_model.py:136-170``), on
one device.  A step on a batch of (GT, LQ) crops:

1. the RRDB conditioning of LQ (``rrdb_preprocess``);
2. every conditional step's record, once, under autograd
   (``precompute_ft(differentiable=True)``: the conditioning towers train);
3. with ``weight_fl > 0``: the NLL in bits/dim of GT plus its quantisation
   noise (``normal_flow_nll``: the log-det encode, every step unfused on
   the live weights), its batch mean times ``weight_fl``;
4. with ``weight_l1 > 0``: the heat-0 decode of a zero latent, unfused,
   and the L1 to GT times ``weight_l1``;
5. backward, the optimizer's step over every parameter of the model, one
   step of the LR schedule.

Two forms, as in the JAX package:

* the frozen form (``freeze_rrdb=True``), the first ``train_RRDB_delay``
  of training: step 1 runs under ``torch.no_grad()`` (JAX's
  ``stop_gradient``), the dense-block convs on K3 (345 launches a step at
  the flagship; the bf16 K3 under ``default``) on the layouts of the
  RRDB's ``freeze()``, which stay valid since its weights do not move;
* the live form: the RRDB under autograd on ``kernels=False`` (the
  reference order through ``fnn.conv2d``: cuDNN on the card; K3 has no
  backward), its gradients masked before ``rrdb_unfreeze_step`` (all of
  them without one), as ``_rrdb_mask`` does.

The flow runs on no kernel in either form: the JAX package's FlowStep
kernel drops the log-det and has no backward.

Adam's step count: optax counts every step for every parameter, the
masked RRDB's included, so the RRDB's first live update takes the bias
correction of the global count.  Here an RRDB parameter has no gradient
(None) while it is frozen or masked, so that ``torch.optim.Adam`` leaves
it and its layouts alone, and ``train.optim.share_step_count`` gives it,
at its first gradient, the zero moments and shared count it would have
after zero gradients: the JAX mask form's update.  The part of the head
that the flow never reads (``upconv2`` at x4, ``upconv3`` at x8,
``HRconv``, ``conv_last``) gets no gradient and stays as it is, as under
optax's zero gradients.

The step is the same at every flow the model takes: at x8 (L 4) the NLL
reads the last of three epses, and the encode crosses two splits.

With a ``mesh`` (axis ``dp``) the step is one rank's part of the
dp-sharded step of ``tests/test_sharded.py``: the rank's batch is its
B / dp pairs (``shard_batch`` with ``batch_specs_srflow``); the
quantisation noise is drawn for the global batch from the same generator
state on every rank and each keeps its rows (``fnn.global_rows``, as
JAX draws one global array and shards it), so the sharded step computes
the single-process step's loss; the gradients are averaged over dp
before the optimizer's step and the metrics are their mean over dp.
Adam's shared count (``share_step_count``) is unchanged.

``kernels=False`` runs the frozen form's RRDB on K3's twin (``TWINS``) on
any device; with ``kernels=True`` a CUDA batch launches K3 or raises, a
CPU batch runs the twin.
"""

import torch

from bfsr_tpu_torch.ops.cuda import TWINS
from bfsr_tpu_torch.parallel.dp import DataParallel
from bfsr_tpu_torch.pipelines.linf_train import to_device
from bfsr_tpu_torch.pipelines.losses import l1_loss
from bfsr_tpu_torch.train.optim import share_step_count

BATCH_KEYS = ("GT", "LQ")


def make_srflow_train_step(model, optimizer, weight_fl=1.0, weight_l1=0.0,
                           rrdb_unfreeze_step=None, freeze_rrdb=False,
                           kernels=True, scheduler=None, marks=None,
                           generator=None, mesh=None):
    """``step(batch, it=0, noise=None) -> {'nll_loss' and/or 'l1_loss',
    'loss'}`` (floats, one host fetch), which updates the model and the
    optimizer in place; ``step.loss_and_grads(batch, it=0, noise=None) ->
    (metrics (tensors), grads {state_dict name: tensor})`` computes the same
    loss and every parameter's gradient (zeros where the step gives none)
    and changes nothing.

    model: an ``SRFlowNet`` (``freeze()`` called for the frozen form's K3
    layouts); optimizer: over all of its parameters; scheduler: a
    per-iteration LR scheduler or None; batch: {'GT': (B, H, W, 3), 'LQ':
    (B, H/s, W/s, 3)} in [0, 1] at scale s, H and W divisible by 2^L;
    ``it``: the iteration, read by the live form's mask; ``noise``: the
    quantisation noise added to GT (B, H, W, 3), else ``(U - 0.5) /
    quant`` drawn from ``generator``.  ``marks``: None, or a callable that takes the name of
    each stage as the step enters it ('rrdb', 'precompute_ft', 'encode',
    'decode', 'backward', 'update', then 'end').  ``mesh``: None, or this
    rank's mesh (axis ``dp``), the batch then the rank's shard; the
    metrics and gradients are the global step's.
    """
    if weight_fl <= 0 and weight_l1 <= 0:
        raise ValueError("at least one of weight_fl / weight_l1 must be > 0")
    device = next(model.parameters()).device
    mark = marks or (lambda name: None)
    dp = DataParallel(mesh)
    rrdb_params = set(model.RRDB.parameters())

    def conditioning(lq):
        mark("rrdb")
        if freeze_rrdb:
            with torch.no_grad():
                lr_enc = model.rrdb_preprocess(lq, True if kernels else TWINS)
        else:
            lr_enc = model.rrdb_preprocess(lq, kernels=False)
        mark("precompute_ft")
        return model.precompute_ft(lr_enc, differentiable=True)

    def losses(batch, noise):
        gt, lq = batch["GT"], batch["LQ"]
        cache = conditioning(lq)
        mets = {}
        if weight_fl > 0:
            mark("encode")
            with dp.scope():
                _, nll, _ = model.normal_flow_nll(gt, cache, noise, generator)
            mets["nll_loss"] = nll.mean() * weight_fl
        if weight_l1 > 0:
            mark("decode")
            z = model.sample_z(0.0, lq.shape[1:3], lq.shape[0], device=device)
            sr, _ = model.flowUpsamplerNet.decode_logdet([z], cache, None)
            mets["l1_loss"] = l1_loss(sr, gt) * weight_l1
        mets["loss"] = sum(mets.values())
        return mets

    def masked(it):
        return not freeze_rrdb and (rrdb_unfreeze_step is None
                                    or it < rrdb_unfreeze_step)

    def loss_and_grads(batch, it=0, noise=None):
        batch = to_device(batch, device, BATCH_KEYS)
        params = dict(model.named_parameters())
        mets = losses(batch, noise)
        grads = torch.autograd.grad(mets["loss"], list(params.values()),
                                    allow_unused=True)
        out = {}
        for (name, p), g in zip(params.items(), grads):
            if g is None or (masked(it) and p in rrdb_params):
                g = torch.zeros_like(p)
            out[name] = g
        dp.average(out.values())
        return dp.metric_tensors(mets), out

    def step(batch, it=0, noise=None):
        batch = to_device(batch, device, BATCH_KEYS)
        mets = losses(batch, noise)
        mark("backward")
        optimizer.zero_grad(set_to_none=True)
        mets["loss"].backward()
        if masked(it):
            for p in rrdb_params:
                p.grad = None
        dp.average_grads(model.parameters())
        mark("update")
        share_step_count(optimizer)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        mark("end")
        return dp.metrics(mets)

    step.loss_and_grads = loss_and_grads
    return step
