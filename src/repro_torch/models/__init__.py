"""The model stack of the port: every block family of the reference's
``repro/models/``, one device, one parameter module per layer."""
from repro_torch.models.model import LM, EncDec, build_model  # noqa: F401
from repro_torch.models.common import AxisRules, init_tree, shape_tree, NO_RULES  # noqa: F401
