"""The L0 label and visualisation tools of the port, each run as
`python -m nerf_mae_torch.tools.<name>`: generate_scannet_obb (ScanNet
oriented boxes from the meshes, rescaled to the grids), proposals2ngp
(proposals as instant-ngp box json), visualize_detections (box overlays on
splatted scene views) and visualize_cameras (frusta, room box and OBBs as a
PLY line set)."""
