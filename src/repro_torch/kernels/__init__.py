"""Hand-written Hopper kernels for SHARK's hot spots.

  dequant_bag    fused gather + int8/bf16/fp16 dequant + embedding-bag
                 reduce (the serving path behind the paper's +30% QPS;
                 one launch over a packed store's three tiers), and
                 bag_grad, its scatter-add backward (training); with
                 the reference's (B, K)-grid tiling oracles of both
                 (dequant_bag_rowgrid, bag_grad_rowgrid), which no path
                 runs
  bag_matmul     the same gather fused with the first dense layer of
                 wide&deep's and xDeepFM's deep branch (fused heads)
  cin            xDeepFM's Compressed Interaction Network layer
  hashed_gather  the hashed store's chunk-pool gather + sign/scale
                 combine (ROBE-style rows materialised from a pool), from
                 a slot plan or from the ids, hashing in registers
  rowwise_quant  per-row max-abs -> scale -> round -> int8 (the packed
                 store's int8 tier and the hashed store's int8 pool)

Each kernel package: ref.py (plain PyTorch version), kernel.py (the CUDA
kernel's binding and launch counter), ops.py (public ops).  An op picks
by the device of the tensors it is given: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise.  There is no switch and
no fallback.  ``build`` compiles ``csrc/*.cu`` at first use.
``launch_counts`` reads every kernel's launch counter and
``reset_launches`` sets them all to 0.
"""

from __future__ import annotations


def _kernel_modules() -> dict:
    from repro_torch.kernels.bag_matmul import kernel as bag_matmul
    from repro_torch.kernels.cin import kernel as cin
    from repro_torch.kernels.dequant_bag import kernel as dequant_bag
    from repro_torch.kernels.hashed_gather import kernel as hashed_gather
    from repro_torch.kernels.rowwise_quant import kernel as rowwise_quant
    return {"dequant_bag": dequant_bag, "bag_matmul": bag_matmul,
            "cin": cin, "hashed_gather": hashed_gather,
            "quantize_rowwise": rowwise_quant}


def launch_counts() -> dict:
    """Launches this process made, by kernel: ``dequant_bag`` (its
    single-tier and tiered entries), ``bag_grad``, ``dequant_bag_rowgrid``,
    ``bag_grad_rowgrid``, ``bag_matmul``, ``cin``, ``hashed_gather`` (its
    plan and ids entries), ``quantize_rowwise``.  Each kernel module's
    ``launches`` splits its count by entry and dtype."""
    mods = _kernel_modules()
    return {"dequant_bag": mods["dequant_bag"].total_launches(),
            "bag_grad": mods["dequant_bag"].bag_grad_launches["float32"],
            **mods["dequant_bag"].rowgrid_launches,
            "bag_matmul": mods["bag_matmul"].total_launches(),
            "cin": mods["cin"].total_launches(),
            "hashed_gather": mods["hashed_gather"].total_launches(),
            "quantize_rowwise": mods["quantize_rowwise"].total_launches()}


def reset_launches() -> None:
    for mod in _kernel_modules().values():
        mod.reset_launches()
