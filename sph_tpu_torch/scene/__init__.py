from .scene import Scene
from .worm import (generate_liquid_box_scene, generate_multi_worm_params,
                   generate_multi_worm_scene, generate_worm_scene)
from . import io

__all__ = ["Scene", "generate_liquid_box_scene", "generate_multi_worm_params",
           "generate_multi_worm_scene", "generate_worm_scene", "io"]
