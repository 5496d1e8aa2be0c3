"""Name -> constructor registry with spec-based factories.

The same names and ``make(spec)`` semantics as ``bfsr_tpu/registry.py``:
components register under a string name and are built from
``{'name': ..., 'args': {...}}`` dicts, which compose recursively (an
``encoder_spec`` lives inside a model spec).  Importing
``bfsr_tpu_torch.models`` registers the encoders ``edsr-baseline``,
``edsr``, ``rrdb``, ``rdn`` and ``swinir``, the models ``linf`` and
``linf-patch`` with ``flow``, the latent modules ``unet``,
``swin_latent`` and ``edsr-baseline-latent``, ``mlp``,
``VGGFeatureExtractor``, ``srflow`` and ``srflow-unet``; importing
``bfsr_tpu_torch.data.wrappers`` registers ``sr-implicit-paired-fast``,
``sr-implicit-paired-fast-patch`` and
``sr-implicit-downsampled-fast-crop``, ``bfsr_tpu_torch.data.
image_folder`` registers ``image-folder``, ``image-folder-DF2K`` and
``paired-image-folders``, and ``bfsr_tpu_torch.data.pkl_dataset``
``lrhr-pkl``.
"""

import copy

_REGISTRY = {}


def register(name):
    """Class/function decorator: register ``cls`` under ``name``."""

    def decorator(cls):
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise KeyError(f"duplicate registry name: {name!r}")
        _REGISTRY[name] = cls
        return cls

    return decorator


def lookup(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown component {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def names():
    return sorted(_REGISTRY)


def make(spec):
    """Build a component from ``spec = {'name': str, 'args': dict}``."""
    return lookup(spec["name"])(**copy.deepcopy(spec.get("args") or {}))
