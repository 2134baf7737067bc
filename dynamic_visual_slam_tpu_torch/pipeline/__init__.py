"""pipeline modules of the PyTorch port."""
