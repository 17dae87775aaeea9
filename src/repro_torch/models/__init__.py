from .factory import ModelFns, build  # noqa: F401
