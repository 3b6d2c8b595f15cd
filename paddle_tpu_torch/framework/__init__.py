from .io import load, save  # noqa: F401
