"""Framework-wide integer constants and particle-class tags (a copy of
``sph_tpu/constants.py``, held equal by the port's tests).

Behavioral counterparts of the reference's shared device/host constants
(`src/owOpenCLConstant.h:4-14` and
`src/owWorldSimulation.cpp:31`). Values are part of the
on-disk scene format and the physics (fixed neighbor capacity), so they are
kept identical.
"""

MAX_NEIGHBORS = 32            # owOpenCLConstant.h:4  (MAX_NEIGHBOR_COUNT)
MAX_MEMBRANES_PER_PARTICLE = 7  # owOpenCLConstant.h:6

LIQUID_PARTICLE = 1           # owOpenCLConstant.h:8-10
ELASTIC_PARTICLE = 2
BOUNDARY_PARTICLE = 3

NO_PARTICLE_ID = -1           # owOpenCLConstant.h:12-14 (pad sentinel)
NO_CELL_ID = -1

MUSCLE_COUNT = 100            # owWorldSimulation.cpp:31 (96 used by the worm)
ACTIVE_MUSCLE_COUNT = 96      # main_sim.py returns 96 values
