from .ops import *  # noqa: F401,F403
