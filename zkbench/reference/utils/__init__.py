from . import rng  # noqa: F401
