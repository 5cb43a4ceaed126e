"""The port's exact engine on sph_tpu's default full worm (the native
builder's 231,811 particles): the time-t density of ``diagnostics`` (its
plain PyTorch path on the CPU) against sph_tpu's ``diagnostics``.

Run with ``-s`` to see the largest difference."""
import numpy as np

from sph_tpu.config import SimParams as JParams
from sph_tpu.core import step as JS
from sph_tpu.scene import generate_worm_scene as j_worm

from sph_tpu_torch.config import SimParams
from sph_tpu_torch.constants import LIQUID_PARTICLE
from sph_tpu_torch.core import step as S
from sph_tpu_torch.scene import generate_worm_scene

from torch_scenes import scene_path

RHO_TOL = 1e-5         # of rho0, every row
MEAN_RHO_TOL = 1e-6    # mean liquid rho / rho0


def test_full_worm_density_equals_sph_tpu():
    """The time-t density of the port's exact engine (``diagnostics``, its
    plain PyTorch path on the CPU) on sph_tpu's default full worm against
    sph_tpu's ``diagnostics``: every row within 1e-5 of rho0, the mean
    liquid rho/rho0 within 1e-6."""
    jp, params = JParams(), SimParams()
    with scene_path(native=True):
        js, scene = j_worm(jp), generate_worm_scene(params)
    assert scene.n_particles == 231_811
    ref = np.asarray(JS.diagnostics(js.device_state()[0], jp)["rho"])
    ours = S.diagnostics(scene.device_state("cpu")[0], params)["rho"].numpy()
    rho0 = float(params.rho0)
    assert ours.shape == ref.shape == (231_811,)
    worst = float(np.abs(ours - ref).max()) / rho0
    liquid = scene.ptype == LIQUID_PARTICLE
    mean, ref_mean = (float(np.mean(r[liquid], dtype=np.float64)) / rho0
                      for r in (ours, ref))
    print(f"full worm: max |rho - sph_tpu's| = {worst:.3e} rho0, mean "
          f"liquid rho/rho0 {mean:.8f} (sph_tpu {ref_mean:.8f})")
    assert worst <= RHO_TOL
    assert abs(mean - ref_mean) <= MEAN_RHO_TOL
    assert 0.5 < mean < 2.0      # the bench's gate range: a real density
