"""The benchmark harness of the PyTorch port."""
