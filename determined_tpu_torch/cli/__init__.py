"""Command line of the port (``python -m determined_tpu_torch.cli``)."""
