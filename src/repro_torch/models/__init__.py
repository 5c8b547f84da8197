from . import cnn

__all__ = ["cnn"]
