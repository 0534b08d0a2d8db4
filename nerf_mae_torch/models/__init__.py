"""Models of the port (Swin trunk, UNETR decoder, SwinMAE3D, the dense heads,
and the FCOS detector with its FPN and backbones)."""
