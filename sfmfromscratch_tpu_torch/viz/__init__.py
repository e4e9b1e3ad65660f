from sfmfromscratch_tpu_torch.viz.scatter3d import V3D
