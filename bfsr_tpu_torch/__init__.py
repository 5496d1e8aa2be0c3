"""bfsr_tpu_torch — PyTorch + CUDA port of the LINF-LP (pixel and patch
model) and SRFlow-LP learned-prior inference paths, the LINF eval loop
and the LINF-LP latent trainer, for one NVIDIA H100 (sm_90a).

The JAX package ``bfsr_tpu`` beside it is the reference this port is
tested against; this package imports ``torch`` and never ``jax`` (nor any
``bfsr_tpu`` module, whose import pulls jax in).

* ``bfsr_tpu_torch.models``    — EDSR encoder, LINF / LINFPatch Fourier
                                 head + pointwise flow, UNet prior;
                                 SRFlow's RRDB, Glow pyramid and
                                 two-branch prior (``nn.Module`` s whose
                                 ``state_dict`` keys are the reference's).
* ``bfsr_tpu_torch.ops``       — plain tensor ops (``nn``, ``interp``,
                                 ``pointwise_flow``, ``flows``) and
                                 ``ops.cuda``: the hand-written kernels,
                                 each beside its plain PyTorch twin.
* ``bfsr_tpu_torch.pipelines`` — ``LINFPredictor``, ``SRFlowLPPredictor``:
                                 whole-image inference; ``eval_psnr``;
                                 ``linf_train.make_train_step`` and the
                                 losses.
* ``bfsr_tpu_torch.train``     — optimizers, LR schedules, checkpoints.
* ``bfsr_tpu_torch.data``      — the paired eval wrappers, the train crop
                                 wrapper, ``image-folder``, the loader
                                 (host numpy).
* ``bfsr_tpu_torch.utils``     — coords, metrics (PSNR, SSIM), Averager,
                                 Timer, logging.
* ``bfsr_tpu_torch.cli.train`` — the trainer CLI (``train.py``'s twin).
* ``bfsr_tpu_torch.convert``   — JAX parameter pytrees -> port modules.
* ``bfsr_tpu_torch.entry``     — the full-size / tiny models from a seed.

Images are NHWC at every public function, as in the JAX package.
"""

__version__ = "0.1.0"

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.registry import lookup, make, register

__all__ = ["registry", "register", "make", "lookup", "__version__"]
