from sfmfromscratch_tpu_torch.native.bindings import (
    build_tracks,
    native_available,
    resize_gray,
)
