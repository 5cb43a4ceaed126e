"""Static scene layout (counterpart of ``sph_tpu/core/step.py``).

Only :class:`SceneLayout` is ported so far; the exact neighbor-list engine
that ``sph_tpu/core/step.py`` also holds is ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """Static layout facts about a scene (hashable).

    Particle classes are stored contiguously — the generator emits
    elastic/liquid/boundary, the file loader boundary/elastic/liquid.
    """

    n_particles: int
    liquid_range: tuple[int, int] = (0, 0)
    elastic_range: tuple[int, int] = (0, 0)
    boundary_range: tuple[int, int] = (0, 0)
    muscle_model: bool = False  # drive activations from the wave model
    # every spring endpoint lies in elastic_range
    springs_elastic_only: bool = True
    # highest used partner slot across the spring table (rounded up to 4)
    spring_slots: int = 32
    # every spring endpoint is elastic or boundary (never liquid)
    springs_anchors_static: bool = True

    @property
    def n_liquid(self) -> int:
        return self.liquid_range[1] - self.liquid_range[0]

    @property
    def n_elastic(self) -> int:
        return self.elastic_range[1] - self.elastic_range[0]

    @property
    def n_boundary(self) -> int:
        return self.boundary_range[1] - self.boundary_range[0]
