"""Field-row packing: f32 vectors of n -> one ``[rows, n]`` pack.

Counterpart of ``pallas_pack`` (``scripts/r4_glue_micro.py:48-63``),
candidate D of the glue micro-benchmark; the engines' own ``_pack``
(``core/fast.py``) stays ``torch.stack``, candidate A, as ``sph_tpu``'s
stayed ``jnp.stack``. ``pack`` on CPU tensors runs ``pack_plain``; on CUDA
tensors it launches the Hopper kernel (``csrc/pack.cu``) or raises. Each
kernel launch adds one to ``LAUNCHES["pack"]``.
"""
from __future__ import annotations

import ctypes

import torch

MAX_ROWS = 16  # SPH_PACK_MAX_ROWS of csrc/pack.cu

# kernel launches (a plain int, reset by callers that count a run)
LAUNCHES = {"pack": 0}


def pack_plain(fields) -> torch.Tensor:
    """The plain PyTorch version: ``torch.stack(fields, 0)``."""
    return torch.stack(list(fields), 0)


def pack(fields) -> torch.Tensor:
    """``[len(fields), n]`` f32 pack of 1-D f32 tensors of one length."""
    fields = list(fields)
    dev = fields[0].device
    if dev.type == "cpu":
        return pack_plain(fields)
    if dev.type == "cuda":
        return pack_kernel(fields)
    raise ValueError(f"pack on unsupported device {dev}")


def pack_kernel(fields) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no fallback)."""
    from . import _build

    fields = list(fields)
    rows, dev = len(fields), fields[0].device
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"pack: {rows} rows, the kernel takes 1..{MAX_ROWS}")
    n = fields[0].shape[0] if fields[0].dim() == 1 else -1
    for f in fields:
        if (f.device != dev or f.dtype != torch.float32 or f.dim() != 1
                or f.shape[0] != n or not f.is_contiguous()):
            raise ValueError(
                "pack: every field must be a contiguous 1-D f32 tensor of "
                f"one length on {dev}; got {f.dtype} {tuple(f.shape)} on "
                f"{f.device}")
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.load()
    ptrs = (ctypes.c_void_p * rows)(*[f.data_ptr() for f in fields])
    with torch.cuda.device(dev):
        err = lib.sph_pack_rows(ptrs, rows, n, out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"pack kernel launch failed: "
                           f"{_build.error_string(err)} ({err})")
    LAUNCHES["pack"] += 1
    return out
