"""paddle.jit counterpart: InputSpec and the whole-step trainer."""
from .functional import (amp_functional_call, functional_call,  # noqa: F401
                         split_state)
from .input_spec import InputSpec  # noqa: F401
from .train_step import TrainStep  # noqa: F401
