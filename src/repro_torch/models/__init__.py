from .factory import ModelFns, build, make_dummy_batch  # noqa: F401
