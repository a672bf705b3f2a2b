"""The reference's examples (`examples/*.py`) ported to the card: run
each as ``python -m repro_torch.examples.<name> [--device cpu]``.
Nothing runs at import."""
