from .io import load, save  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
