from .quat import *  # noqa: F401,F403
from .frame import *  # noqa: F401,F403
