from .main import Shell, main

__all__ = ["Shell", "main"]
