"""Frozen copy (plain PyTorch path) of the port's package of the same name."""
