from . import big
from .big import *  # noqa: F401,F403
