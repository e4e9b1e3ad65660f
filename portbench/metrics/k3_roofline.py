"""Matcher kernel (``csrc/match_top2.cu``): the traced job's least time for
its matched pairs' distance and top-2 core at the card's peaks over the
device time of the kernels named ``match_f32_kernel``, in %. n1 = n2 is the
keypoint capacity, (k // levels) * levels, and D = 128."""

from portbench.roofline import k3


def read(r):
    if r.traced is None or r.traced.pair_geometry is None:
        return None
    ex = r.config["extractor"]
    levels = ex["pyramid_level"]
    n = int(ex["num_interest_points"] / levels) * levels
    pairs = sum(1 for i, j in r.traced.pair_geometry if i < j)
    nbytes, flops = k3.work(pairs, n, n, 128)
    return r.kernel_share("match_f32_kernel", nbytes, flops, k3.bound_s)
