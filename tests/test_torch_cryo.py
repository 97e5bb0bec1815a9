"""The port's cryosphere (core/cryo.py) against the JAX package's.

The accumulated-temperature ring buffers bitwise, including the reference's
first-sample flush; cryo_step's frozen fractions; the frozen season through
both fused drivers (f64, within 1e-9, equal NFE) with the JAX test's own
drainage assertion; a JAX checkpoint with the cryosphere state resuming in
the port.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu.core import cryo as JC  # noqa: E402
from shud_tpu_torch.core import cryo as TC  # noqa: E402


def _temps(n_steps, ne, seed):
    return np.random.default_rng(seed).uniform(-25.0, 10.0, (n_steps, ne))


def _assert_acc_equal(j, t):
    np.testing.assert_array_equal(np.asarray(j.ring), t.ring.numpy())
    np.testing.assert_array_equal(np.asarray(j.acc), t.acc.numpy())
    np.testing.assert_array_equal(np.asarray(j.acc_day), t.acc_day.numpy())
    assert (int(j.size), int(j.head), int(j.n_day)) == (t.size, t.head,
                                                        t.n_day)
    assert float(j.time_start) == t.time_start


@pytest.mark.parametrize("maxlen", (1, 3, 7))
def test_acc_temp_push_bitwise(maxlen):
    """Hourly samples over ten days into a ring of *maxlen* days: after
    every push the state equals JAX's bit for bit (the first sample
    flushes at once, then one flush a day, the ring evicting when full)."""
    ne = 5
    sj = JC.acc_temp_init(ne, maxlen, jnp.float64)
    st = TC.acc_temp_init(ne, maxlen, torch.float64, "cpu")
    _assert_acc_equal(sj, st)
    temps = _temps(240, ne, maxlen)
    for k in range(temps.shape[0]):
        t_now = 60.0 * k
        sj = JC.acc_temp_push(sj, jnp.asarray(temps[k]), t_now)
        st = TC.acc_temp_push(st, torch.tensor(temps[k]), t_now)
        _assert_acc_equal(sj, st)
        np.testing.assert_array_equal(np.asarray(JC.acc_temp_mean(sj)),
                                      TC.acc_temp_mean(st).numpy())
        if k == 0:  # the reference's quirk: Time_start starts at -9999
            assert st.size == 1 and st.n_day == 0
            np.testing.assert_array_equal(st.acc.numpy(), temps[0])
    assert st.size == min(maxlen, 11)


def test_cryo_step_matches():
    """cryo_step's state and frozen fractions (fu_surf, fu_sub) equal
    JAX's over a freeze and a thaw, window by window."""
    ne = 4
    cj = JC.cryo_init(ne, 7, 28, jnp.float64)
    ct = TC.cryo_init(ne, 7, 28, torch.float64, "cpu")
    temps = np.concatenate([_temps(30 * 24, ne, 1) - 15.0,
                            _temps(10 * 24, ne, 2) + 10.0])
    bounds = (-1.0, -5.0, -3.0, -10.0)
    lowest = 1.0
    for k in range(temps.shape[0]):
        cj, fs_j, fb_j = JC.cryo_step(cj, jnp.asarray(temps[k]), 60.0 * k,
                                      *bounds)
        ct, fs_t, fb_t = TC.cryo_step(ct, torch.tensor(temps[k]), 60.0 * k,
                                      *bounds)
        np.testing.assert_array_equal(np.asarray(fs_j), fs_t.numpy())
        np.testing.assert_array_equal(np.asarray(fb_j), fb_t.numpy())
        lowest = min(lowest, float(fb_t.min()))
    _assert_acc_equal(cj.surf, ct.surf)
    _assert_acc_equal(cj.sub, ct.sub)
    assert lowest < 0.5 and float(fs_t.min()) == 1.0  # froze, then thawed


def _frozen(pkg, cryo=True):
    if pkg == "jax":
        from shud_tpu.utils.synthetic import make_synthetic_project
    else:
        from shud_tpu_torch.utils.synthetic import make_synthetic_project
    inp = make_synthetic_project(8, 4, end_day=2.0)
    inp.forc.data[0][:, 1] = -20.0
    inp.control.cryosphere = int(cryo)
    return inp


def _sims(cryo=True):
    from shud_tpu.driver.fused import FusedSimulation as JSim
    from shud_tpu_torch.driver.fused import FusedSimulation as TSim

    a = JSim.create("synthetic", inp=_frozen("jax", cryo),
                    float_dtype=jnp.float64, mega=False, pallas_edges=False)
    b = TSim.create("synthetic", inp=_frozen("torch", cryo),
                    float_dtype=torch.float64, device="cpu")
    return a, b


def test_frozen_season_matches_jax():
    """The frozen season (make_synthetic_project(8, 4), forcing at -20 C,
    two days, f64) through both fused drivers: states within 1e-9 and
    equal NFE after each day, the cryosphere states equal; and, as the JAX
    package's test_frozen_season_driver_e2e asserts, the frozen fraction
    all but stops the groundwater drainage of the warm twin."""
    a, b = _sims()
    ne = b.md.num_ele
    y0 = b.y_np()
    for _ in range(2):
        a.advance_interval(1440.0)
        b.advance_interval(1440.0)
        assert b.bdf.nfe == int(a.bdf.nfe)
        assert np.abs(b.y_np() - a.y_np()).max() <= 1e-9
    for part in ("surf", "sub"):
        ja, ta = getattr(a.cryo, part), getattr(b.cryo, part)
        np.testing.assert_allclose(ta.acc.numpy(), np.asarray(ja.acc),
                                   rtol=1e-12)
        assert (ta.size, ta.head) == (int(ja.size), int(ja.head))
    dgw_frozen = np.abs(b.y_np()[2 * ne:3 * ne] - y0[2 * ne:3 * ne])
    _, warm = _sims(cryo=False)
    warm.advance_interval(1440.0)
    warm.advance_interval(1440.0)
    dgw_off = np.abs(warm.y_np()[2 * ne:3 * ne] - y0[2 * ne:3 * ne])
    assert dgw_off.mean() > 0, "warm twin must drain"
    assert dgw_frozen.mean() < dgw_off.mean() * 0.1, (dgw_frozen.mean(),
                                                      dgw_off.mean())


def test_jax_cryo_checkpoint_resumes_in_port(tmp_path):
    """A JAX checkpoint written with the cryosphere on (``cryo/surf/ring``
    and the other accumulator leaves) loads into the port, and the next
    day of both matches within 1e-9 with equal NFE; the port's own
    checkpoint round-trips."""
    from shud_tpu.io.checkpoint import save_checkpoint as jsave
    from shud_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    a, b = _sims()
    a.advance_interval(1440.0)
    path = str(tmp_path / "jax.ckpt.npz")
    jsave(path, a)
    with np.load(path) as z:
        assert "cryo/surf/ring" in z.files and "cryo/sub/time_start" in z.files
    load_checkpoint(path, b)
    assert b.cryo.sub.size == int(a.cryo.sub.size)
    assert b.t == a.t
    a.advance_interval(1440.0)
    b.advance_interval(1440.0)
    assert b.bdf.nfe == int(a.bdf.nfe)
    assert np.abs(b.y_np() - a.y_np()).max() <= 1e-9

    mine = str(tmp_path / "port.ckpt.npz")
    save_checkpoint(mine, b)
    _, c = _sims()
    load_checkpoint(mine, c)
    for part in ("surf", "sub"):
        _assert_acc_equal(getattr(b.cryo, part), getattr(c.cryo, part))
    assert torch.equal(c.bdf.y, b.bdf.y) and c.t == b.t
