"""Rank functions for the port's multi-rank tests (``run_ranks`` starts
them in spawned processes, which import this module: it imports torch and
the port only, never jax)."""
import time

import torch

from sph_tpu_torch.parallel import make_halo_session, make_mesh2, shard_state
from sph_tpu_torch.parallel.dryrun import halo_rank
from sph_tpu_torch.parallel.sharded import gather_state


def comm_ops(comm):
    """Each of the four operations on small rank-stamped tensors."""
    r = comm.rank
    a = torch.arange(3, dtype=torch.float32) + 10 * r
    return dict(
        rank=r, world=comm.world,
        gather=comm.all_gather(a[None]),
        gather_int=comm.all_gather(torch.tensor([r], dtype=torch.int64)),
        psum=comm.psum(a),
        next=comm.send_next(a, -1.0),
        prev=comm.send_prev(a, torch.tensor([-2.0, -3.0, -4.0])),
        pmax=comm.pmax(torch.tensor(float(r))),
    )


def session_vs_call(comm, scene, params, cfg, n_calls, halo_pad):
    """The distributed resort as one call of ``n_calls`` periods and as a
    session of ``n_calls`` steps from the same state; rank 0 returns both
    gathered states and the session's overflow counts."""
    run = halo_rank(comm, scene, params, cfg,
                    [(n_calls * cfg.resort_every, True)],
                    halo_pad=halo_pad)[0]
    state, springs, membranes = scene.device_state(comm.device)
    state_l = shard_state(state, comm)
    begin, step, finish = make_halo_session(comm, params, scene.layout(),
                                            cfg, halo_pad=halo_pad)
    sess = begin(state_l, membranes)
    diags = []
    for _ in range(n_calls):
        sess, diag = step(sess, springs, membranes)
        diags.append({k: int(v) for k, v in diag.items()
                      if k.endswith("overflow")})
    out = gather_state(finish(sess, state_l), comm)
    if comm.rank:
        return {}
    return dict(call=run, pos=out.pos, vel=out.vel, step=out.step,
                diags=diags)


def mesh2_halo(comm, n_slices, per_slice, scene, params, cfg, n_steps,
               halo_pad):
    """The distributed-resort halo engine over ``make_mesh2``'s chain."""
    chain = make_mesh2(n_slices, per_slice, device=comm.device)
    return halo_rank(chain, scene, params, cfg, [(n_steps, True)],
                     halo_pad=halo_pad)[0]


def waits_on_peer(comm):
    """Rank 0 waits in a psum that rank 1 never makes: rank 1 sleeps past
    any deadline a test gives."""
    if comm.rank == 0:
        comm.psum(torch.ones(1))
    else:
        time.sleep(600)
