"""Hand-written Hopper kernels for SHARK's hot spots.

  dequant_bag    fused gather + int8/bf16/fp16 dequant + embedding-bag
                 reduce (the serving path behind the paper's +30% QPS),
                 and bag_grad, its scatter-add backward (training)

Each kernel package: ref.py (plain PyTorch version), kernel.py (the CUDA
kernel's binding and launch counter), ops.py (public ops).  An op picks
by the device of the tensors it is given: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise.  There is no switch and
no fallback.  ``build`` compiles ``csrc/*.cu`` at first use.
"""
