"""Ops of the port: attention (``attention.py``), the CUDA flash attention
kernels with their plain versions and autograd Function
(``flash_attention.py``), fused AdamW (``fused_adamw.py``) and fused
cross-entropy (``cross_entropy.py``)."""
