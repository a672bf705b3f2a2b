"""Serving stack of the port: the shared decision layer (copied) and the
PyTorch executor and engine."""
