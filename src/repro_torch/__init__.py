"""DySkew on PyTorch and CUDA: the port of the ``repro`` package.

Same relative module paths and public names as ``repro``, with PyTorch
inside: plain functions on tensors and dicts of tensors.  Everything that
allocates takes an explicit ``device``; entry points default to ``cuda``
and raise when there is none.  The package imports neither ``jax`` nor
``repro``.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
