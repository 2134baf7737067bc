"""frontend modules of the PyTorch port."""
