"""Harris kernel (``csrc/harris.cu``): the traced job's least Harris time at
the card's peaks (8 bytes a pixel or 16 + 12 G FLOPs, over every image at
every pyramid level) over the device time of the kernels named
``harris_kernel``, in %."""

from portbench.roofline import harris


def read(r):
    if r.traced is None:
        return None
    ex, hw = r.config["extractor"], r.config["image_hw"]
    shapes = harris.level_shapes(hw, ex["pyramid_level"], ex["pyramid_scale_factor"])
    nbytes, flops = harris.work(r.traced.views, shapes, ex["gaussian_size"])
    return r.kernel_share("harris_kernel", nbytes, flops, harris.bound_s)
