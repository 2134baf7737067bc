"""io modules of the PyTorch port."""
