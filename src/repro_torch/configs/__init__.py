from . import femnist_cnn  # noqa: F401
