from sfmfromscratch_tpu_torch.ops.lie import so3_exp, so3_hat, so3_log
from sfmfromscratch_tpu_torch.ops.smallsvd import nullvec_lstsq, smallest_eigvec_sym
