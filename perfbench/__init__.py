"""The benchmark of the PyTorch port (``repro_torch``) on one H100."""
