"""Checkpoint loading for the eval entry points: the counterpart of
``bfsr_tpu/convert/load.py``.

``load_linf_model`` and ``load_prior_model`` take three formats:

* the port's own ``.ckpt`` (``train/checkpoints.py``: a ``torch.save``
  file whose spec holds a ``state_dict`` under ``sd``: ``{'model':
  {'name', 'args', 'sd'}}`` or ``{'prior_model': ...}``);
* a reference ``.pth``, the same layout and keys;
* a JAX ``bfsr_tpu`` ``.ckpt``: a pickle whose arrays are numpy and whose
  spec holds a params pytree under ``params``, converted by
  ``convert/from_jax.py``.  It is read with ``pickle`` alone, which may
  build numpy arrays in plain containers and nothing else: a file that
  would need ``jax`` (or ``bfsr_tpu``), or any other name, to unpickle is
  refused.

A torch file is told from a pickle by its header: a zip archive, or the
legacy format's magic number.  Models come back in eval mode on
``device`` (the card unless the caller names another), and frozen where
asked (``freeze()`` caches what the kernels read, so it runs after the
move).
"""

import pickle
import zipfile

import torch

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert import from_jax

# torch.save's legacy (non-zip) format opens with this pickled number
_TORCH_LEGACY_MAGIC = b"\x80\x02\x8a\x0a\x6c\xfc\x9c\x46\xf9\x20\x6a\xa8"
# what a JAX checkpoint's pickle may name: numpy arrays, dtypes and
# scalars (numpy 1 and 2 spell the module apart), in plain containers
_PICKLE_GLOBALS = frozenset(
    [(f"{m}.multiarray", n) for m in ("numpy.core", "numpy._core")
     for n in ("_reconstruct", "scalar")]
    + [("numpy", "ndarray"), ("numpy", "dtype"),
       ("collections", "OrderedDict"), ("copyreg", "_reconstructor")]
    + [("builtins", n) for n in ("dict", "list", "tuple", "set")])
_JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "bfsr_tpu")


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles the names of ``_PICKLE_GLOBALS`` and no other, so a
    checkpoint can build numpy arrays and containers, and call nothing
    else."""

    def find_class(self, module, name):
        if module.split(".")[0] in _JAX_MODULES:
            raise ValueError(
                f"this checkpoint needs {module}.{name} to unpickle; the "
                "port reads JAX checkpoints whose arrays are numpy "
                "(bfsr_tpu.train.checkpoints.save_checkpoint) and does not "
                "import jax")
        if (module, name) not in _PICKLE_GLOBALS:
            raise ValueError(f"this checkpoint names {module}.{name}, which "
                             "a checkpoint of numpy arrays does not")
        return super().find_class(module, name)


def is_torch_file(path):
    """Whether ``path`` is a ``torch.save`` file (zip or legacy)."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(len(_TORCH_LEGACY_MAGIC)) == _TORCH_LEGACY_MAGIC


def read_checkpoint(path):
    """("torch", payload) for a torch file (tensors on the CPU), or
    ("jax", payload) for a JAX checkpoint's pickle of numpy arrays."""
    if is_torch_file(path):
        return "torch", torch.load(path, map_location="cpu",
                                   weights_only=True)
    with open(path, "rb") as f:
        return "jax", _NumpyUnpickler(f).load()


def _finish(model, device, freeze):
    model = model.to(device).eval()
    return model.freeze() if freeze else model


def load_linf_model(path, freeze=True, device="cuda"):
    """A LINF or LINF patch model, on any registered encoder, from
    ``path`` (any of the three formats)."""
    kind, ckpt = read_checkpoint(path)
    spec = ckpt["model"] if "model" in ckpt else ckpt
    model = registry.make(spec)
    model.load_state_dict(
        spec["sd"] if kind == "torch" else from_jax.linf_state_dict(
            spec["params"], spec["args"]["encoder_spec"]["name"]))
    return _finish(model, device, freeze)


def load_prior_model(path, device="cuda"):
    """A latent module (the LINF-LP UNet, ``swin_latent``,
    ``edsr-baseline-latent`` or SRFlow-LP's two-branch UNet) from
    ``path`` (any of the three formats), frozen.  A reference checkpoint
    names both UNets ``unet``; the two-branch one is told by its keys."""
    kind, ckpt = read_checkpoint(path)
    spec = ckpt["prior_model"] if "prior_model" in ckpt else ckpt
    name, known = spec["name"], from_jax.PRIOR_STATE_DICTS
    if kind == "torch" and name == "unet" and (
            "input_proj0.conv1.weight" in spec["sd"]):
        name = "srflow-unet"
    if name not in known:
        raise NotImplementedError(f"latent module {spec['name']!r}: "
                                  f"expected one of {sorted(known)}")
    prior = registry.make({"name": name, "args": spec.get("args") or {}})
    prior.load_state_dict(spec["sd"] if kind == "torch"
                          else known[name](spec["params"]))
    return _finish(prior, device, True)
