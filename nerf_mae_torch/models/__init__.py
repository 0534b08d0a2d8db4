"""Models of the port (Swin trunk, UNETR decoder, SwinMAE3D)."""
