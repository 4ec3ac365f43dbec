"""Layzer-Irvine tracker correctness (the in-tree half of the BASELINE
|dE/E| < 1e-3 gate; the full-config measurement runs on the GPU via
tools/li_check.py).

Exact solution used: with W = W0/a (potential), U = U0/a^2 (adiabatic
gamma=5/3 thermal) the cosmic energy equation
    d(T+W+U)/dln a = -(2T + W + 2U)
is solved by T = T0/a^2, for ANY T0/W0/U0. The tracker consumes GADGET
internal-unit stats (kinetic = T a^2, potential = W a, internal = U)."""

import numpy as np

from gadget_leicester_tpu.utils.diagnostics import LayzerIrvineTracker


class _Stats:
    def __init__(self, t, w, u):
        self.kinetic, self.potential, self.internal = t, w, u


def _exact_stats(a, t0=2.0e7, w0=-8.0e9, u0=1.2e7):
    t, w, u = t0 / a**2, w0 / a, u0 / a**2
    return _Stats(t * a**2, w * a, u)


def test_tracker_conserves_on_exact_solution():
    tr = LayzerIrvineTracker()
    drifts = [tr.update(a, _exact_stats(a))
              for a in np.geomspace(0.09, 0.5, 400)]
    assert max(drifts) < 1e-4, max(drifts)


def test_tracker_detects_energy_injection():
    tr = LayzerIrvineTracker()
    a_grid = np.geomspace(0.09, 0.5, 400)
    drift = 0.0
    for i, a in enumerate(a_grid):
        st = _exact_stats(a)
        if i > 200:
            # inject spurious thermal energy worth 1% of |W|
            st.internal = st.internal + 0.01 * abs(st.potential) / a
        drift = tr.update(a, st)
    assert drift > 5e-3, drift


def test_tracker_insensitive_to_cadence():
    """Trapezoid accumulation must converge: coarsening the stats
    cadence 8x must not change the (near-zero) drift materially."""

    def run(n_points):
        tr = LayzerIrvineTracker()
        return max(tr.update(a, _exact_stats(a))
                   for a in np.geomspace(0.09, 0.5, n_points))

    assert run(800) < 1e-4
    assert run(100) < 2e-3
