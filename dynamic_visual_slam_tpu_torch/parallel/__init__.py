"""parallel modules of the PyTorch port: the multi-stream fleet."""
