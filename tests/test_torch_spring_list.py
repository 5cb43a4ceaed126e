"""The spring pass's list form (``pair_kernels.spring_list`` and the list
kernel's plain version) against sph_tpu's Pallas spring pass (interpret
mode), the f64 oracle and the port's pair form, and ``spring_list``'s
contract: the entries the pair pass would match, in its order, in shapes
fixed by (n_slots, width, n_pad), built without a host sync.

Inputs are the synthetic spring slab of ``test_torch_pair_kernels.py``
(``elastic_inputs``): partners outside a block's tiles, a block that
streams no tile, a partner listed twice, a coincident partner (q2 = 0) and
partner lists that are not symmetric. Tolerances: 2e-6 of the output
vector's magnitude against the oracle and 1e-4 against Pallas (as the pair
form is held); list form against pair form 1e-5 of the pass's rounding
scale (``PairPass.rounding_scale``), the kernel tolerance: both sum the
same f32 terms, in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sph_tpu_torch.ops import pair_kernels as pk
from test_torch_pair_kernels import (N_SLOTS, assert_close, elastic_inputs,
                                     jax_pack, jax_pass, oracle)

KERNEL_TOL = 1e-5


@pytest.fixture(scope="module")
def spring():
    """(params, (pass, tables, own, slab), the list's 8-tuple, info)."""
    params, calls, info = elastic_inputs()
    p, tables, own, slab = calls["spring_ms"]
    return params, (p, tables, own, slab), pk.spring_list(p, tables, slab), \
        info


def pair_order_entries(p, tables, slab):
    """Per own row, the (column, slot) entries the pair pass matches, in
    the order it meets them: brute force over every tile of the row's
    block (table order), its columns, then the column's slots."""
    aln, _, _, s0, cnt, ob = (t.numpy().astype(np.int64) for t in tables)
    ids = slab[pk.SPR_IDX0:pk.SPR_IDX0 + p.n_slots].numpy()
    width = slab.shape[1]
    rows = [[] for _ in range(p.n_pad)]
    for b in range(p.n_blocks):
        for t in range(cnt[b]):
            c = 3 * b + int(t >= s0[3 * b + 1]) + int(t >= s0[3 * b + 2])
            off = aln[c] + (t - s0[c]) * p.ccol
            for j in range(max(off, 0), min(off + p.ccol, width)):
                for s in range(p.n_slots):
                    i = int(ids[s, j]) - ob[0] if ids[s, j] >= 0 else -1
                    if b * p.block <= i < (b + 1) * p.block:
                        rows[i].append((j, s))
    return rows


def test_spring_list_holds_the_pair_pass_entries(spring):
    """Row by row, the list holds exactly the (column, slot) entries the
    pair pass matches, in its order; what it drops (partners outside the
    tiles of their row's block, the zero-tile block's rows) lies past
    ``row_ptr[n_pad]``."""
    _, (p, tables, own, slab), lst, _ = spring
    row_ptr, ent = (t.numpy() for t in lst[6:])
    want = pair_order_entries(p, tables, slab)
    for i in range(p.n_pad):
        got = ent[row_ptr[i]:row_ptr[i + 1]]
        assert [(int(e) // p.n_slots, int(e) % p.n_slots) for e in got] \
            == want[i], i
    used = int((slab[pk.SPR_IDX0:pk.SPR_IDX0 + p.n_slots] >= 0).sum())
    assert 0 < row_ptr[-1] == sum(map(len, want)) < used
    blk5 = slice(5 * p.block, 6 * p.block + 1)
    assert (np.diff(row_ptr[blk5]) == 0).all()     # block 5 streams none


def test_spring_list_matches_pallas(spring):
    """The list form's plain version against sph_tpu's Pallas spring pass
    (interpret mode, on the 6-tuple tables) and the f64 oracle; CPU
    tensors launch no kernel."""
    params, (p, tables, own, slab), lst, info = spring
    before = dict(pk.LAUNCHES)
    out = [o.numpy() for o in p(lst, own, slab)]
    assert pk.LAUNCHES == before
    ref = jax_pass(p, params)(tuple(jnp.asarray(t.numpy()) for t in tables),
                              jax_pack(own), jax_pack(slab))
    ref = [np.asarray(a) for a in ref]
    assert_close(p, params, tables, own, out, ref,
                 oracle(p, params, tables, own, slab))
    force = np.abs(np.stack(out)).sum(0)
    blk5 = slice(5 * p.block, 6 * p.block)
    assert not force[blk5].any()                   # a block without tiles
    assert not np.delete(force, info["els"]).any()   # liquid rows


def test_spring_list_matches_pair_form(spring):
    """The list form against the pair form on the same inputs: the sums
    within 1e-5 of the pass's rounding scale, the rounding scales within
    1e-5 of each other (the same terms in another order), and rows the
    pair form leaves at 0 at 0."""
    _, (p, tables, own, slab), lst, _ = spring
    lf, pf = p(lst, own, slab), p(tables, own, slab)
    ls, ps = p.rounding_scale(lst, own, slab), p.rounding_scale(tables, own,
                                                               slab)
    top = float(torch.stack(ps).max())
    assert top > 0
    for a, b, sa, sb in zip(lf, pf, ls, ps):
        assert float((a - b).abs().max()) <= KERNEL_TOL * top
        assert float((sa - sb).abs().max()) <= KERNEL_TOL * top
        assert not a[b == 0].any() and not sa[sb == 0].any()


def test_spring_list_is_shape_static(spring):
    """The list's shapes depend on (n_slots, width, n_pad) alone: the same
    for other partner ids (none, or every column listing one partner), and
    ``spring_list`` runs on meta tensors, which have no values, so it reads
    none on the host (no ``nonzero``, ``.item()`` or ``.tolist()``)."""
    _, (p, tables, own, slab), lst, _ = spring
    shapes = [t.shape for t in lst]
    assert shapes[6:] == [(p.n_pad + 1,), (p.n_slots * slab.shape[1],)]
    assert all(t.dtype == torch.int32 for t in lst[6:])
    for fill in (-1.0, 0.0):
        other = slab.clone()
        other[pk.SPR_IDX0:pk.SPR_IDX0 + p.n_slots] = -1.0
        other[pk.SPR_IDX0] = fill
        assert [t.shape for t in pk.spring_list(p, tables, other)] == shapes
    meta = pk.spring_list(p, tuple(t.to("meta") for t in tables),
                          slab.to("meta"))
    assert [t.shape for t in meta] == shapes
    assert all(t.device.type == "meta" for t in meta[6:])


def test_spring_list_refuses_what_it_cannot_list(spring):
    """Only a spring pass has a list, and its keys must fit in int64."""
    _, (p, tables, own, slab), _, _ = spring
    with pytest.raises(ValueError, match="spring_list of a"):
        pk.spring_list(dataclasses.replace(p, kind="membrane"), tables, slab)
    huge = dataclasses.replace(p, n_blocks=1 << 24)
    with pytest.raises(ValueError, match="overflow"):
        pk.spring_list(huge, tables, torch.zeros((15, 1 << 28),
                                                 device="meta"))


def test_check_refuses_a_malformed_list(spring):
    """The list kernel takes the 8-tuple with int32 ``row_ptr`` [n_pad + 1]
    and ``ent`` [n_slots * width]; on tables that lie on the CPU the
    list's invariants are checked too (row_ptr rises from 0 to at most the
    capacity, entries address the slab's slots)."""
    _, (p, tables, own, slab), lst, _ = spring
    pk._check(p, lst, own, slab)
    with pytest.raises(ValueError, match="8-tuple"):
        pk._check(p, tables, own, slab)
    row_ptr, ent = lst[6:]
    for match, r, e in (("table 6", row_ptr[:-1], ent),
                        ("table 7", row_ptr, ent.long()),
                        ("table 7", row_ptr, ent[:-1])):
        with pytest.raises(ValueError, match=match):
            pk._check(p, lst[:6] + (r, e), own, slab)
    past = ent.clone()
    past[0] = ent.shape[0]
    falling = row_ptr.clone()
    falling[1] = falling[-1] + 1
    for r, e in ((row_ptr, past), (falling, ent), (row_ptr + 1, ent)):
        with pytest.raises(ValueError, match="malformed list"):
            pk._check(p, lst[:6] + (r, e), own, slab)
    with pytest.raises(ValueError, match="8-tuple"):
        p.kernel(tables, own, slab)
    assert N_SLOTS == p.n_slots
