"""paddle.jit counterpart: to_static (with dy2static), the whole-step
trainer, save / load of an inference program, and the legacy surface
(`ProgramTranslator`, `TracedLayer`, `set_verbosity`, `set_code_level`):
all 9 of paddle.jit's names, as `paddle_tpu/jit/__init__.py` (:1-77)."""
from .functional import (amp_functional_call, functional_call,  # noqa: F401
                         split_state)
from .input_spec import InputSpec  # noqa: F401
from .save_load import TranslatedLayer, load, save  # noqa: F401
from .to_static import (StaticFunction, declarative,  # noqa: F401
                        not_to_static, to_static)
from .train_step import TrainStep  # noqa: F401


class ProgramTranslator:
    """dygraph_to_static ProgramTranslator compat: the global to_static
    toggle (`program_translator.py` singleton). As in the reference, the
    toggle is stored and nothing reads it: `to_static` converts whatever
    it says (a reference defect kept, pinned by a test)."""

    _instance = None
    _enabled = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool):
        type(self)._enabled = bool(enable_to_static)

    @property
    def enable_to_static(self):
        return type(self)._enabled


def enable_to_static(flag: bool = True):
    ProgramTranslator.get_instance().enable(flag)


class TracedLayer:
    """dygraph.TracedLayer compat over StaticFunction: trace(layer, inputs)
    returns (outputs, traced); traced(*inputs) replays the program and
    save_inference_model exports it (jit.save)."""

    def __init__(self, static_fn, layer):
        self._fn = static_fn
        self._layer = layer

    @staticmethod
    def trace(layer, inputs):
        sf = StaticFunction(type(layer).forward.__get__(layer), layer=layer)
        outs = sf(*inputs)
        return outs, TracedLayer(sf, layer)

    def __call__(self, *inputs):
        return self._fn(*inputs)

    def save_inference_model(self, path, feed=None, fetch=None, **kw):
        prog = self._fn.program()
        n_p = len([p for p in self._layer.parameters() if p.requires_grad])
        specs = [InputSpec(list(s.shape), s.dtype)
                 for s in prog._arg_specs[n_p:]]
        save(self._layer, path, input_spec=specs, **kw)


# dy2static's debugging knobs: stored, as in the reference
_JIT_VERBOSITY = [0]
_JIT_CODE_LEVEL = [0]


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    _JIT_VERBOSITY[0] = int(level)


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    _JIT_CODE_LEVEL[0] = int(level)
