from .simulator import Simulator
from .checkpoint import load_checkpoint, save_checkpoint
from .timing import StepTimer

__all__ = ["Simulator", "save_checkpoint", "load_checkpoint", "StepTimer"]
