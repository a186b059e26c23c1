"""The plain reference: float32 PyTorch with TF32 off, no kernel and no
code of the port, computed in blocks so that it fits on the card after
the port's state is freed."""
