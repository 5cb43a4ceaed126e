"""The multi-GPU path as it runs on NCCL ranks, a card a rank, held on the
CPU where NCCL cannot run:

* the halo engine on 4 gloo CPU ranks over a dense fill-0.8 box (16h x
  12h x 24h, the rehearsal dam-break, kicked as ``tests/test_torch_halo``
  kicks its box so that pressure and wall sums are live), both resorts,
  against the port's fast engine within sph_tpu's halo tolerance (2e-5),
  every overflow 0;
* ``run_ranks``'s deadline: a rank that waits on a collective its peer
  never makes ends the call, with the ranks named, within the deadline;
* ``chip_smoke.py`` phase 24's choice of nccl ranks by the machine's cards;
* the entry points that run on the card unless told otherwise
  (``StepTimer``, ``muscle.schedule``) and the CLI's card of a torchrun
  rank.

Its own file with at most 8 tests, so that ``--dist loadfile`` queues it
behind ``tests/test_fast_engine.py``."""
import functools
import inspect
import math
import multiprocessing
import time

import numpy as np
import pytest
import torch

from sph_tpu_torch.cli import rank_device
from sph_tpu_torch.config import SimParams
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.models import muscle
from sph_tpu_torch.parallel import (measure_halo_pad, measure_migration_pad,
                                    pad_scene_to_devices)
from sph_tpu_torch.parallel.dryrun import halo_rank
from sph_tpu_torch.parallel.launch import run_ranks
from sph_tpu_torch.runtime.timing import StepTimer
from sph_tpu_torch.scene import generate_liquid_box_scene

import chip_smoke
import torch_ranks
from test_torch_fastw import KICK
from test_torch_pair_kernels import kick_box_scene

H = 3.34
WORLD = 4
BLOCK = 128
DAM = dict(x_max=16 * H, y_max=12 * H, z_max=24 * H)
STEPS = 4           # resort_every 2: across a resort, then one more
TOL = 2e-5          # sph_tpu's halo tolerance against the fast engine
MOVED = 1e-2        # the run must move rows by far more than TOL
DEADLINE_S = 10.0


@pytest.fixture(scope="module")
def dense_box():
    """(the kicked fill-0.8 box padded to WORLD x BLOCK, the fast engine's
    positions after STEPS, both resorts' rank-0 results)."""
    params = SimParams(**DAM)
    scene = kick_box_scene(generate_liquid_box_scene(params,
                                                     fill_fraction=0.8),
                           params, **KICK)
    scene = pad_scene_to_devices(scene, WORLD * BLOCK)
    cfg = F.compute_fast_config(scene.pos, params, block=BLOCK,
                                resort_every=2,
                                block_multiple=math.lcm(8, WORLD))
    per_rank = cfg.n_blocks // WORLD * cfg.block
    pads = dict(
        halo_pad=min(measure_halo_pad(scene.pos, params, cfg), per_rank),
        mig_cap=min(measure_migration_pad(scene.pos, params, cfg),
                    per_rank))
    runs = run_ranks(functools.partial(halo_rank, **pads), WORLD, "gloo",
                     "cpu", scene, params, cfg,
                     [(STEPS, False), (STEPS, True)])[0]
    ref = F.make_fast_multi_step(params, scene.layout(), cfg, STEPS)(
        *scene.device_state("cpu"))
    return scene, ref.pos.numpy(), dict(zip(("replicated", "distributed"),
                                            runs))


@pytest.mark.parametrize("resort", ["replicated", "distributed"])
def test_dense_box_four_ranks_matches_fast(dense_box, resort):
    """Both resorts on 4 ranks over the dense box: within 2e-5 of the fast
    engine on every row, across a resort, with no overflow; the run moves
    the rows by far more than the tolerance."""
    scene, ref, runs = dense_box
    run = runs[resort]
    assert {k: int(v) for k, v in run["diag"].items()
            if k.endswith("overflow")} == (
        {"halo_overflow": 0, "resort_overflow": 0}
        if resort == "distributed" else {"halo_overflow": 0})
    assert int(run["step"]) == STEPS
    assert np.abs(ref - scene.pos).max() > MOVED
    np.testing.assert_allclose(run["pos"], ref, rtol=0, atol=TOL)


def test_run_ranks_deadline_ends_a_hung_rank():
    """Rank 0 waits in a psum that rank 1 never makes: the call raises
    TimeoutError naming both ranks once the deadline passes, and no rank
    process is left."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank\(s\) 0, 1 of 2 did not "
                       r"return within 10 s"):
        run_ranks(torch_ranks.waits_on_peer, 2, "gloo", "cpu",
                  timeout_s=DEADLINE_S)
    # the ranks' start-up (a few seconds) and their ending are outside it
    assert time.monotonic() - t0 < DEADLINE_S + 40.0
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("cards,world", [(1, 0), (2, 2), (4, 4)])
def test_phase24_nccl_world(monkeypatch, cards, world):
    """Phase 24 (d) runs nccl on 4 ranks where the machine has 4 cards, on
    2 where it has 2, and not on one card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert chip_smoke.nccl_world() == world


def test_entry_points_default_to_the_card():
    """``StepTimer`` and ``muscle.schedule`` run on the card unless the
    caller names the CPU; without CUDA the default raises, and the CPU
    stays available by name."""
    assert StepTimer()._cuda and not StepTimer(device="cpu")._cuda
    assert inspect.signature(muscle.schedule).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            muscle.schedule(3)
    assert muscle.schedule(3, device="cpu").device.type == "cpu"


def test_cli_rank_device():
    """A torchrun rank's card is cuda:LOCAL_RANK; gloo ranks beyond the
    cards share them, nccl refuses them."""
    assert [rank_device("nccl", r, 4) for r in range(4)] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert rank_device("gloo", 3, 2) == "cuda:1"
    with pytest.raises(ValueError, match="nccl needs a card a rank"):
        rank_device("nccl", 2, 2)
    with pytest.raises(RuntimeError, match="no card"):
        rank_device("gloo", 0, 0)
