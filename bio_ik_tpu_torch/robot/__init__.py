from .urdf import UrdfRobot, load_urdf, parse_urdf  # noqa: F401
from .model import RobotModel, VariableBounds  # noqa: F401
