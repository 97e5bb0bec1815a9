"""The port's domain decomposition (``shud_tpu_torch/parallel``) against the
JAX package's.

The partition equal to JAX's array for array.  The port's 4-rank sharded
RHS (gloo ranks on the CPU, float64) against JAX's ``make_sharded_rhs`` on
4 of the conftest's virtual devices, both boundary modes, with and without
a lake: dY and the window diagnostics within 1e-12 scaled; the hand J·v
(``ShardRHS.linearize``) against ``jax.jvp`` of JAX's sharded ``rhs_fn``
at the same point and tangent within 1e-12 scaled; the port's sharded RHS
and J·v, unsharded, against its single-device ``rhs`` and ``linearize``
within 1e-12 scaled.  An undersized request fails fast naming the device
count.  The ranks run ``tests/torch_sharded_ranks.py``, which imports no
JAX.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu_torch.core.device import to_torch  # noqa: E402
from shud_tpu_torch.core.mesh import build_mesh as torch_build  # noqa: E402
from shud_tpu_torch.core.rhs import linearize, rhs_full  # noqa: E402
from shud_tpu_torch.core.state import ForcingSlice  # noqa: E402
from shud_tpu_torch.parallel import comm  # noqa: E402
from shud_tpu_torch.parallel import partition as tpart  # noqa: E402
from shud_tpu_torch.parallel.sharded import (  # noqa: E402
    DIAG_CELL, DIAG_EDGE, DIAG_LAKE, DIAG_RIV, ShardRHS, state_blocks)
from torch_sharded_ranks import CELL_FORCING, cell_blocks  # noqa: E402
from torch_sharded_ranks import eval_cases, eval_rank  # noqa: E402
from torch_variants import make_project, random_inputs  # noqa: E402

P = 4
BAR = 1e-12
# (variant, close_boundary): both boundary modes, with and without a lake
CASES = (("plain", True), ("plain", False), ("lake", True), ("lake", False))


def _ids(case):
    return f"{case[0]}-{'closed' if case[1] else 'open'}"


def _scaled(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max()) / (float(np.abs(ref).max()) or 1.0)


@pytest.mark.parametrize("nx,ny,variant", ((16, 8, "plain"),
                                           (12, 6, "lake")))
@pytest.mark.parametrize("order", ("keep", "rcm"))
def test_partition_matches_jax(nx, ny, variant, order):
    from shud_tpu.core.mesh import build_mesh as jax_build
    from shud_tpu.parallel.partition import build_sharded_mesh

    a = build_sharded_mesh(jax_build(make_project("jax", variant, nx, ny)),
                           P, shard_order=order)
    b = tpart.build_sharded_mesh(
        torch_build(make_project("torch", variant, nx, ny)), P,
        shard_order=order)
    for f in ("p", "np_cells", "ns_seg", "nr_riv", "num_ele", "num_riv",
              "num_lake"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("perm", "inv_perm", "old_to_shard", "old_to_slot", "valid",
              "riv_owner", "riv_slot_of"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    for f in ("cell", "edge", "seg", "riv", "halo", "lake"):
        da, db = getattr(a, f), getattr(b, f)
        assert sorted(da) == sorted(db), f
        for k in da:
            np.testing.assert_array_equal(db[k], da[k], f"{f}.{k}")
    assert vars(a.plan) == vars(b.plan)
    assert b.edge_blocks is None
    y = np.arange(3 * a.num_ele + a.num_riv + a.num_lake, dtype=float)
    blocks = tpart.shard_state(b, y)
    np.testing.assert_array_equal(tpart.unshard_state(b, blocks), y)


def _case_inputs(variant, close_boundary):
    jinp = make_project("jax", variant, 12, 6)
    tinp = make_project("torch", variant, 12, 6)
    md = torch_build(tinp)
    fs, y = random_inputs(md, seed=11)
    v = np.random.default_rng(12).normal(size=y.shape) * (0.1 * np.abs(y)
                                                          + 1e-3)
    return jinp, md, fs, y, v


def _jax_case(jinp, fs, y, v, close_boundary):
    """JAX's sharded dY, diagnostics and jax.jvp on 4 virtual devices."""
    from shud_tpu.core.mesh import build_mesh as jax_build
    from shud_tpu.parallel.partition import (
        build_sharded_mesh, riv_blocks, shard_state)
    from shud_tpu.parallel.sharded import make_sharded_rhs

    md = jax_build(jinp)
    sm = build_sharded_mesh(md, P)
    _, rhs_fn, diag_fn, params = make_sharded_rhs(
        sm, devices=np.array(jax.devices()[:P]),
        close_boundary=close_boundary, with_diag=True)
    fs_cell = {k: jnp.asarray(cell_blocks(sm, fs[k])) for k in CELL_FORCING}
    fs_riv = {k: jnp.asarray(riv_blocks(sm, fs[k]))
              for k in ("riv_ybc", "riv_qbc")}
    args = params + (fs_cell, fs_riv)
    ys = {k: jnp.asarray(a) for k, a in shard_state(sm, y).items()}
    ts = {k: jnp.asarray(a) for k, a in shard_state(sm, v).items()}
    dy, diag = jax.jit(diag_fn)(0.0, ys, args)
    _, jv = jax.jit(lambda yy, tt, aa: jax.jvp(
        lambda y_: rhs_fn(0.0, y_, aa), (yy,), (tt,)))(ys, ts, args)

    def host(tree):
        return {k: np.asarray(a) for k, a in tree.items()}

    return host(dy), host(diag), host(jv)


@pytest.fixture(scope="module")
def results():
    """Every case through the port's 4 ranks (one spawn), JAX's sharded
    RHS and the port's single-device RHS."""
    inputs = {c: _case_inputs(*c) for c in CASES}
    sms = {c: tpart.build_sharded_mesh(inputs[c][1], P) for c in CASES}
    jobs = [(sms[c], inputs[c][2], inputs[c][3], inputs[c][4], c[1])
            for c in CASES]
    ranks = comm.spawn(eval_cases, P, "gloo", ["cpu"] * P, args=(jobs,))
    out = {}
    for i, c in enumerate(CASES):
        jinp, md, fs, y, v = inputs[c]
        port = [r[i] for r in ranks]
        dm = to_torch(md, torch.float64, "cpu")
        slc = ForcingSlice(**{k: torch.as_tensor(a) for k, a in fs.items()})
        yt = torch.as_tensor(y)
        dy1, _ = rhs_full(dm, slc, 0.0, yt, c[1])
        _, jvp1 = linearize(dm, slc, 0.0, yt, c[1])
        out[c] = dict(sm=sms[c], port=port,
                      jax=_jax_case(jinp, fs, y, v, c[1]),
                      single=(dy1.numpy(), jvp1(torch.as_tensor(v)).numpy()))
    return out


def _port_blocks(sm, port, key):
    return state_blocks(sm, [r[key] for r in port])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_rhs_matches_jax(results, case):
    r = results[case]
    sm, port = r["sm"], r["port"]
    dy_j, diag_j, _ = r["jax"]
    for key in ("dy", "dy_lin"):
        got = tpart.unshard_state(sm, _port_blocks(sm, port, key))
        assert _scaled(tpart.unshard_state(sm, dy_j), got) <= BAR, key
    # the diagnostics on the valid cells, reaches and lakes
    for k in DIAG_CELL + DIAG_EDGE:
        got = np.stack([p["diag"][k] for p in port])
        ref = np.asarray(diag_j[k])
        sel = (sm.old_to_shard, sm.old_to_slot)
        assert _scaled(ref[sel], got[sel]) <= BAR, k
    for k in DIAG_RIV:
        got = np.stack([p["diag"][k] for p in port])
        sel = (sm.riv_owner, sm.riv_slot_of)
        assert _scaled(np.asarray(diag_j[k])[sel], got[sel]) <= BAR, k
    for k in DIAG_LAKE:
        assert _scaled(diag_j[k], port[0]["diag"][k]) <= BAR, k
        for p in port[1:]:  # replicated: the same bits on every rank
            np.testing.assert_array_equal(p["diag"][k], port[0]["diag"][k])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_jvp_matches_jax(results, case):
    r = results[case]
    sm = r["sm"]
    ref = tpart.unshard_state(sm, r["jax"][2])
    got = tpart.unshard_state(sm, _port_blocks(sm, r["port"], "jv"))
    assert _scaled(ref, got) <= BAR


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_matches_single_device(results, case):
    r = results[case]
    sm = r["sm"]
    dy1, jv1 = r["single"]
    for key, ref in (("dy", dy1), ("jv", jv1)):
        got = tpart.unshard_state(sm, _port_blocks(sm, r["port"], key))
        assert _scaled(ref, got) <= BAR, key


def test_undersized_request_fails_fast():
    """More shards than devices fails before any rank starts, naming the
    count; so does a group smaller than the partition, and --shards above
    the visible GPUs (none here)."""
    md = torch_build(make_project("torch", "plain", 12, 6))
    sm = tpart.build_sharded_mesh(md, P)
    with pytest.raises(ValueError, match="4 shards but only 1 device"):
        comm.spawn(eval_rank, P, "gloo", ["cpu"], args=())
    with pytest.raises(ValueError, match="4 shards but the group has 1"):
        ShardRHS(sm, comm.Group(0, 1, "cpu"), torch.float64)
    with pytest.raises(ValueError, match=r"only \d+ CUDA device\(s\) are "
                                         r"visible"):
        comm.cuda_devices(64)
