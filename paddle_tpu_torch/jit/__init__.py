"""paddle.jit counterpart: InputSpec, the whole-step trainer, and
save / load of an inference program (3 of paddle.jit's 9 names: `save`,
`load`, `TranslatedLayer`; `to_static` and the rest are not ported)."""
from .functional import (amp_functional_call, functional_call,  # noqa: F401
                         split_state)
from .input_spec import InputSpec  # noqa: F401
from .save_load import TranslatedLayer, load, save  # noqa: F401
from .train_step import TrainStep  # noqa: F401
