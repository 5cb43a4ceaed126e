"""One scene-generator path for both packages, for the port's tests that
compare scenes or steps with sph_tpu's.

Each package builds its scenes with its native (C++) builder where a
compiler is found, else with its NumPy loops; the two paths make other
walls on the full box and other coordinates in the last place. A test that
compares the packages runs both on one path: ``scene_path(native=False)``
sets both packages' ``native.available`` to False (the engine tests, whose
tolerances were derived there), ``scene_path(native=True)`` requires both
builders.
"""
import contextlib

from sph_tpu.scene import native as j_native
from sph_tpu_torch.scene import native as p_native


@contextlib.contextmanager
def scene_path(native: bool):
    saved = j_native.available, p_native.available
    if native:
        if not j_native.available():
            # sph_tpu keeps a failed first load for the process, and under
            # pytest-xdist that load can meet another worker's ``make``
            # writing the library: load once more
            j_native._tried = False
        assert j_native.available() and p_native.available(), \
            "a native scene builder is not available"
    else:
        j_native.available = p_native.available = lambda: False
    try:
        yield
    finally:
        j_native.available, p_native.available = saved
