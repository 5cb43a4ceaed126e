from .simulator import Simulator
from .timing import StepTimer

__all__ = ["Simulator", "StepTimer"]
