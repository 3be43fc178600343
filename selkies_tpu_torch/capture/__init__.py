from .base import FrameSource  # noqa: F401
from .synthetic import DeviceScrollSource, SyntheticSource  # noqa: F401
