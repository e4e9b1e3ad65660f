from sfmfromscratch_tpu_torch.io.images import fast_resize, load_image, save_image
