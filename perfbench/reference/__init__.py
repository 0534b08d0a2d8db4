"""Plain float32 PyTorch and numpy statements of what the system computes:
they import nothing of the system under test and take nothing it made."""
