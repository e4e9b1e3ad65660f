from sfmfromscratch_tpu_torch.pipeline.frontend import FeatureRunner, extract_features


def __getattr__(name):
    # Lazy, as in the JAX package: the engines pull in the full geometry/BA stack.
    if name == "SfmEngine":
        from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine
        return SfmEngine
    if name == "GlobalSfmEngine":
        from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
        return GlobalSfmEngine
    raise AttributeError(name)
