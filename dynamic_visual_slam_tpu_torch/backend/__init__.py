"""backend modules of the PyTorch port."""
