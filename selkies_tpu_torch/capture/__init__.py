from .base import FrameSource  # noqa: F401
from .synthetic import SyntheticSource  # noqa: F401
