"""SHARK reproduction in PyTorch + CUDA for NVIDIA Hopper.

A second package beside the JAX/Pallas ``repro``: the same layout
(``core``, ``kernels``, ``models``, ``configs``, ``launch``, ``data``),
PyTorch idiom inside, and a hand-written CUDA kernel wherever ``repro``
has a Pallas one.  It imports ``torch``, numpy and the standard library
only — never ``jax`` and nothing of ``repro``.

Device rule: every entry point runs on ``cuda`` unless the caller asks
for the CPU (``device="cpu"``, ``--device cpu``).  With no GPU and no
explicit CPU request it raises; it never carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    ``None`` means the GPU and raises when there is none.  Returning a
    CUDA device also pins fp32 products to full fp32: TF32 is turned off
    for cuBLAS and cuDNN (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), so the port's MLPs compute what
    the reference's fp32 ``jnp.dot`` computes.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the work the calling thread queued on the device (its
    current stream; a no-op on the CPU): the end of a timed window.  Work
    on another stream, such as a shadow re-tier's staging thread, does
    not hold it up."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
