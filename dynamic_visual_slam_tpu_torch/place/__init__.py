"""place recognition modules of the PyTorch port."""
