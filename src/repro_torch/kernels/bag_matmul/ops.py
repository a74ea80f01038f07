"""Public op: fused dequant-bag -> first matmul over the PackedStore.

Port of ``repro/kernels/bag_matmul/ops.py``.  ``bag_matmul`` takes the
plain version for CPU tensors and launches the CUDA kernel for CUDA
tensors (it raises for anything the kernel does not take).
``packed_bag_matmul`` computes ``emb.reshape(B, F*D) @ w`` without
materialising ``emb``: one launch per tier, in tier order, with that
tier's local ids and the other tiers' slots masked by weight 0, and the
partial (B, H) products summed as ``zeros + int8 + half + fp32``, the
reference's order (``ops.py:143-153``).  The reference's own CPU runs
take its unfused einsum branch instead, so the port meets them within a
tolerance; the port's CPU path computes what its kernel computes.
On CUDA ``bag_matmul`` resolves the kernel's tiling as the reference's
``resolve_bm_block_sizes``: an explicit ``tiling``, then a hit in the
measured autotune cache (key ``bag_matmul`` by payload dtype, with
``|h=H``), then the analytic pick; every tiling is bit-equal.
"""

from __future__ import annotations

import torch

from repro_torch.core.packed_store import PackedStore, _split
from repro_torch.kernels import autotune
from repro_torch.kernels.bag_matmul.kernel import bag_matmul_cuda
from repro_torch.kernels.bag_matmul.ref import bag_matmul_ref
from repro_torch.kernels.dequant_bag.ops import dtype_name


def bag_matmul(payload: torch.Tensor, scales: torch.Tensor | None,
               indices: torch.Tensor, weights: torch.Tensor,
               w3: torch.Tensor, *, scale_after: bool = False,
               tiling: tuple[int, int] | None = None) -> torch.Tensor:
    """payload (V, D), scales (V,) or None, indices (B, K), weights (B, K),
    w3 (K, D, H) -> (B, H) fp32:
    ``out[b] = sum_k ((payload[i_bk] * s) * w_bk) @ w3[k]`` in the order of
    ``ref.py``.  Dispatch is by ``payload``'s device; on CUDA at
    ``tiling``, else the autotune cache's or the analytic one."""
    if payload.device.type == "cpu":
        return bag_matmul_ref(payload, scales, indices, weights, w3,
                              scale_after=scale_after)
    b, k = indices.shape
    tiling = autotune.resolve_tiling(
        "bag_matmul", dtype_name(payload.dtype), b, k, payload.shape[1],
        tiling, extra=f"|h={w3.shape[-1]}", device=payload.device)
    return bag_matmul_cuda(payload, scales,
                           indices.to(torch.int32).contiguous(),
                           weights.to(torch.float32).contiguous(),
                           w3.to(torch.float32).contiguous(),
                           scale_after=scale_after, tiling=tiling)


def _as_w3(w: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """(K*D, H) or (K, D, H) first-layer weights -> (K, D, H)."""
    if w.dim() == 2:
        if w.shape[0] != k * d:
            raise ValueError(f"w rows {w.shape[0]} != K*D {k * d}")
        return w.reshape(k, d, w.shape[1])
    if w.dim() == 3:
        return w
    raise ValueError(f"w must be (K*D, H) or (K, D, H), got "
                     f"{tuple(w.shape)}")


def packed_bag_matmul(packed: PackedStore, indices: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """indices (B, F) global rows, w (F*D, H) or (F, D, H) -> (B, H) fp32.

    The fused form of ``packed_bag_lookup(...).reshape(B, F*D) @ w`` for
    per-field bags (slot f holds field f's row), as the fused heads call
    it: unit slot weights, the scale-before form.  The fp32 tier passes
    no scales (unit scales multiply exactly).
    """
    b, f = indices.shape
    w3 = _as_w3(w, f, packed.dim)
    tier, loc = _split(packed, indices)
    dev = packed.payload32.device
    out = torch.zeros((b, w3.shape[-1]), dtype=torch.float32, device=dev)
    for t, payload, scales in ((0, packed.payload8, packed.scale8),
                               (1, packed.payload16, packed.scale16),
                               (2, packed.payload32, None)):
        wt = (tier == t).to(torch.float32)
        li = loc.clamp(0, payload.shape[0] - 1).to(torch.int32)
        out = out + bag_matmul(payload, scales, li, wt, w3)
    return out
