"""Ops of the port: attention (``attention.py``) and the CUDA flash forward
kernel with its plain version (``flash_attention.py``)."""
