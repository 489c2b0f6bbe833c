"""The benchmark of the PyTorch/H100 port (``repro_torch``): see run.py."""
