from sfmfromscratch_tpu_torch.ba.problem import BAProblem, make_problem
from sfmfromscratch_tpu_torch.ba.lm import BAResult, bundle_adjust
