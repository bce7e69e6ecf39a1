from repro_torch.core.opmodels.analytical import OperatorModelSet, AnalyticalModels  # noqa: F401
from repro_torch.core.opmodels.forest import RandomForest  # noqa: F401
from repro_torch.core.opmodels.kernelsim import VirtualKernels  # noqa: F401
from repro_torch.core.opmodels.vidur_proxy import VidurProxyModel  # noqa: F401
from repro_torch.core.opmodels.refined import RefinedModels, calibrate_refined  # noqa: F401

# name-keyed registry: operator-model families constructible from a
# HardwareSpec alone (fitted/calibrated variants are injected as instances)
OPMODELS = {
    "analytical": AnalyticalModels,
    "refined": RefinedModels,
}


def resolve_opmodels(spec, hw) -> "OperatorModelSet":
    """Resolve an operator-model spec to an OperatorModelSet for ``hw``.

    Accepts an instance (returned as-is; caller owns hw consistency), a
    registered name ("analytical", "refined"), a mapping
    ``{"name": ..., **kwargs}``, or None (analytical roofline default).
    """
    if isinstance(spec, OperatorModelSet):
        return spec
    if spec is None:
        return OperatorModelSet(hw)
    if isinstance(spec, str):
        spec = {"name": spec}
    if isinstance(spec, dict):
        kw = dict(spec)
        name = kw.pop("name", None)
        if name not in OPMODELS:
            raise KeyError(f"unknown operator model {name!r}; "
                           f"registered: {sorted(OPMODELS)}")
        return OPMODELS[name](hw, **kw)
    raise TypeError(f"opmodel must be None, a name, a mapping, or an "
                    f"OperatorModelSet; got {type(spec).__name__}")
