"""semantic modules of the PyTorch port."""
