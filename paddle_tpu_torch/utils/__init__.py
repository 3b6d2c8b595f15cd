from .convert import load_moe_state, load_numpy_state  # noqa: F401
