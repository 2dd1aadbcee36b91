"""``tests/test_simulation.py`` on the port: the simulator and strategies,
with the polynomial strategies of ``repro_torch.core.polynomial``, give the
orderings and accounting the paper predicts; and each strategy's run
equals the JAX package's on the same traces."""

import numpy as np
import pytest

from repro.core import polynomial as jpoly
from repro.core import simulation as jsim
from repro.core import strategies as jstrat
from repro_torch.core.polynomial import PolyCodedStrategy, PolyS2C2Strategy
from repro_torch.core.simulation import (CLOUD_CLUSTER, LOCAL_CLUSTER, CostModel,
                                         simulate_run)
from repro_torch.core.strategies import (BasicS2C2, GeneralS2C2, MDSCoded,
                                         OverDecomposition, UncodedReplication)
from repro_torch.core.traces import controlled_traces

D = 600000
N, K = 12, 10


def run(strategy, n_stragglers=0, iters=12, seed=3, cost=LOCAL_CLUSTER):
    tr = controlled_traces(N, iters, n_stragglers=n_stragglers, seed=seed)
    return simulate_run(strategy, tr, cost)


class TestOrderings:
    def test_s2c2_beats_mds_no_stragglers(self):
        """§7.2.2: with all workers fast, S²C² ≈ (n,s=n)-MDS ≪ (n,k)-MDS."""
        mds = run(MDSCoded(N, K, D)).mean_time
        s2 = run(GeneralS2C2(N, K, D)).mean_time
        gain = (mds - s2) / s2
        # theoretical max (12-10)/10 = 20%; comm/decode overheads dilute
        assert 0.10 < gain < 0.25

    def test_s2c2_beats_mds_with_stragglers(self):
        for ns in (1, 2):
            mds = run(MDSCoded(N, K, D), ns).mean_time
            s2 = run(GeneralS2C2(N, K, D), ns).mean_time
            assert s2 < mds

    def test_general_beats_basic_with_speed_variation(self):
        basic = run(BasicS2C2(N, K, D), 1).mean_time
        general = run(GeneralS2C2(N, K, D), 1).mean_time
        assert general <= basic * 1.02

    def test_uncoded_degrades_superlinearly(self):
        """Fig 1: replication collapses once stragglers exceed replicas."""
        t = [run(UncodedReplication(N, D, replication=2), ns).mean_time
             for ns in (0, 1, 2, 3)]
        assert t[3] > t[0] * 1.5
        assert t[3] > t[1]

    def test_mds_flat_in_straggler_count(self):
        """(12,9)-MDS latency ≈ constant up to 3 stragglers (Fig 1)."""
        t = [run(MDSCoded(N, 9, D), ns).mean_time for ns in (0, 1, 2, 3)]
        assert max(t) / min(t) < 1.15

    def test_robustness_under_misprediction(self):
        """§4.4: S²C² degrades gracefully.  (a) A *transient* mispredict
        (the paper's actual failure mode — the LSTM lags one iteration
        after a regime shift) stays within ~1.4× of MDS on average;
        (b) even a *persistently adversarial* predictor is bounded (one
        timeout phase + one recompute phase per iteration), not a collapse."""
        tr = controlled_traces(N, 10, n_stragglers=2, seed=7)

        class TransientLiar:
            """Lies on iteration 3 only (regime-shift lag)."""
            def __init__(self):
                self.i = 0
                self.last = np.ones(N)
            def predict(self):
                if self.i == 3:
                    s = np.ones(N); s[:2] = 0.01
                    return s
                return self.last
            def observe(self, speeds):
                self.i += 1
                self.last = speeds

        mds = simulate_run(MDSCoded(N, K, D), tr, LOCAL_CLUSTER)
        s2_t = simulate_run(GeneralS2C2(N, K, D), tr, LOCAL_CLUSTER,
                            predictor=TransientLiar())
        assert s2_t.mean_time < mds.mean_time * 1.4

        class PersistentLiar:
            def predict(self):
                s = np.ones(N); s[:2] = 0.01
                return s
            def observe(self, _):
                pass

        s2_p = simulate_run(GeneralS2C2(N, K, D), tr, LOCAL_CLUSTER,
                            predictor=PersistentLiar())
        assert s2_p.mean_time < mds.mean_time * 4.5   # bounded, no collapse


class TestAccounting:
    def test_mds_wastes_nk_workers(self):
        r = run(MDSCoded(N, K, D), 0)
        # n-k workers' work fully wasted every iteration
        wasted_frac = r.per_worker_wasted.sum() / (
            r.per_worker_wasted.sum() + r.per_worker_useful.sum())
        assert wasted_frac > 0.10

    def test_s2c2_zero_waste_perfect_prediction(self):
        tr = controlled_traces(N, 10, n_stragglers=0, seed=3)

        class Oracle:                       # predicts exactly
            def __init__(self):
                self.i = 0
            def predict(self):
                s = tr[self.i]
                return s
            def observe(self, _):
                self.i += 1

        r = simulate_run(GeneralS2C2(N, K, D), tr, LOCAL_CLUSTER,
                         predictor=Oracle())
        assert r.per_worker_wasted.sum() == 0
        assert r.mispredictions == 0

    def test_overdecomposition_moves_data(self):
        r = run(OverDecomposition(N, D), 2)
        assert r.data_moved_rows > 0

    def test_coded_strategies_move_no_data(self):
        for s in (MDSCoded(N, K, D), GeneralS2C2(N, K, D)):
            assert run(s, 2).data_moved_rows == 0


class TestPolynomial:
    def test_s2c2_beats_conventional_poly(self):
        conv = run(PolyCodedStrategy(12, 9, 60000), 1).mean_time
        s2 = run(PolyS2C2Strategy(12, 9, 60000), 1).mean_time
        assert s2 < conv

    def test_gain_bounded_by_fixed_fraction(self):
        """§7.2.4: the f(x)·A part isn't squeezable, capping the gain."""
        conv = run(PolyCodedStrategy(12, 9, 60000), 0).mean_time
        s2 = run(PolyS2C2Strategy(12, 9, 60000), 0).mean_time
        gain = (conv - s2) / s2
        assert gain < 0.333          # below the linear-algebra max (n-m)/m


def test_cost_model_units():
    cm = CostModel()
    assert cm.compute_time(1000, 1.0) == pytest.approx(1000 * cm.row_cost)
    assert cm.compute_time(1000, 2.0) == pytest.approx(500 * cm.row_cost)
    assert cm.transfer_time(0) == pytest.approx(cm.net_latency)


@pytest.mark.parametrize("name,args", [("MDSCoded", (N, K, D)), ("GeneralS2C2", (N, K, D)),
                                       ("BasicS2C2", (N, K, D)),
                                       ("PolyCodedStrategy", (12, 9, 60000)),
                                       ("PolyS2C2Strategy", (12, 9, 60000))])
@pytest.mark.parametrize("cost", ["local", "cloud"])
def test_runs_equal_the_jax_package(name, args, cost):
    """The same traces through the port's and the reference's simulator."""
    port_cls = {"MDSCoded": MDSCoded, "GeneralS2C2": GeneralS2C2, "BasicS2C2": BasicS2C2,
                "PolyCodedStrategy": PolyCodedStrategy, "PolyS2C2Strategy": PolyS2C2Strategy}[name]
    ref_cls = getattr(jpoly if name.startswith("Poly") else jstrat, name)
    port_cost = LOCAL_CLUSTER if cost == "local" else CLOUD_CLUSTER
    ref_cost = jsim.LOCAL_CLUSTER if cost == "local" else jsim.CLOUD_CLUSTER
    tr = controlled_traces(N, 8, n_stragglers=1, seed=5)
    got = simulate_run(port_cls(*args), tr, port_cost)
    want = jsim.simulate_run(ref_cls(*args), tr, ref_cost)
    assert got.total_time == want.total_time
    np.testing.assert_array_equal(got.per_worker_wasted, want.per_worker_wasted)
    np.testing.assert_array_equal(got.per_worker_useful, want.per_worker_useful)
