"""The port's copies of the jax-free transient layer against the JAX
package's: lifetimes, server provisioning, the price book, the sparse
cluster, the heterogeneity layer and the launcher's revocation traces.

Every comparison is exact: both packages run the same numpy code on the
same seeds, so they must give the same numbers bit for bit.
"""
import argparse
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import cluster as JCL  # noqa: E402
from repro.core import pricing as JP  # noqa: E402
from repro.core import transient as JT  # noqa: E402
from repro import hetero as JH  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro_torch import hetero as H  # noqa: E402
from repro_torch.core import cluster as CL  # noqa: E402
from repro_torch.core import pricing as P  # noqa: E402
from repro_torch.core import transient as T  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402

KINDS = ("K80", "P100", "V100", "PS")


# ---------------------------------------------------------------------------
# lifetimes, servers, prices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_lifetime_samples_are_bit_equal(kind):
    got = T.LIFETIMES[kind].sample(np.random.default_rng(11), 4096)
    want = JT.LIFETIMES[kind].sample(np.random.default_rng(11), 4096)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.astuple(T.LIFETIMES[kind]) == \
        dataclasses.astuple(JT.LIFETIMES[kind])
    for t in (0.0, 60.0, 1800.0, 5000.0, 3 * 3600.0, 20 * 3600.0,
              T.MAX_LIFETIME_S):
        assert T.LIFETIMES[kind].p_revoked_by(t) == \
            JT.LIFETIMES[kind].p_revoked_by(t)


def test_constants_empirical_lifetimes_and_provision():
    assert (T.GCE_WARNING_S, T.EC2_WARNING_S, T.MAX_LIFETIME_S) == \
        (JT.GCE_WARNING_S, JT.EC2_WARNING_S, JT.MAX_LIFETIME_S) == \
        (30.0, 120.0, 86400.0)
    obs = np.random.default_rng(3).exponential(20_000.0, size=50) + 1.0
    got, want = T.EmpiricalLifetime(obs), JT.EmpiricalLifetime(obs)
    np.testing.assert_array_equal(got.sample(np.random.default_rng(5), 300),
                                  want.sample(np.random.default_rng(5), 300))
    for t in (10.0, 5000.0, 1e6):
        assert got.p_revoked_by(t) == want.p_revoked_by(t)
    for bad in ([], [1.0, -2.0]):
        with pytest.raises(ValueError):
            T.EmpiricalLifetime(np.asarray(bad))
    for kind in ("K80", "V100"):
        for transient in (True, False):
            a = T.provision(kind, transient=transient,
                            rng=np.random.default_rng(9), now=5.0,
                            provisioning_delay_s=2.0)
            b = JT.provision(kind, transient=transient,
                             rng=np.random.default_rng(9), now=5.0,
                             provisioning_delay_s=2.0)
            assert (a.kind, a.transient, a.start_s, a.lifetime_s,
                    a.revoke_s, a.state.value, a.active_seconds(1e4)) == \
                (b.kind, b.transient, b.start_s, b.lifetime_s, b.revoke_s,
                 b.state.value, b.active_seconds(1e4))


def test_price_book_and_billing():
    for kind in KINDS:
        s, j = P.SERVER_TYPES[kind], JP.SERVER_TYPES[kind]
        assert (s.ondemand_hr, s.transient_hr, s.steps_per_sec, s.mem_gb,
                s.vcpu, s.savings_potential) == \
            (j.ondemand_hr, j.transient_hr, j.steps_per_sec, j.mem_gb,
             j.vcpu, j.savings_potential)
        for secs in (0.0, 1.0, 3599.0, 3601.0, 86400.0):
            for tr in (True, False):
                assert P.server_cost(kind, secs, tr) == \
                    JP.server_cost(kind, secs, tr)
                assert P.hourly_cost(kind, secs, tr) == \
                    JP.hourly_cost(kind, secs, tr)
                assert P.price_at(kind, secs, transient=tr) == \
                    JP.price_at(kind, secs, transient=tr)
    assert P.SINGLE_K80_BUDGET == JP.SINGLE_K80_BUDGET
    with pytest.raises(ValueError):
        P.server_cost("K80", -1.0, True)
    # trace replay is not ported: a trace raises and names its item
    with pytest.raises(NotImplementedError, match="Queue 1 item 2a"):
        P.price_at("K80", 10.0, trace=object())
    assert P.price_at("K80", 10.0, trace=object(), transient=False) == \
        JP.SERVER_TYPES["K80"].ondemand_hr


# ---------------------------------------------------------------------------
# sparse cluster
# ---------------------------------------------------------------------------

def _view(c):
    return (c.active_slots(), c.n_active, c.membership_version,
            c.active_kinds(), c.composition(), c.shard_assignment(),
            [(s.state.value, s.kind, s.region, s.joined_at_step,
              s.revoked_at_step) for s in c.slots])


@pytest.mark.parametrize("seed", range(4))
def test_sparse_cluster_histories_are_equal(seed):
    """A seeded random history of requests, activations, revocations and
    refills (illegal transitions included) leaves both clusters in the
    same state after every operation, and both refuse the same ones."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    got, want = CL.SparseCluster(n), JCL.SparseCluster(n)
    for step in range(60):
        op = ("request", "activate", "revoke", "fill_and_activate")[
            rng.integers(4)]
        slot = int(rng.integers(n))
        kind = str(rng.choice(["K80", "P100", "V100"]))
        args = (slot, kind) if op == "request" else \
            (slot, step, kind) if op == "fill_and_activate" else (slot, step)
        outcome = []
        for c in (got, want):
            try:
                getattr(c, op)(*args)
                outcome.append("ok")
            except ValueError:
                outcome.append("refused")
        assert outcome[0] == outcome[1], (step, op, args)
        assert _view(got) == _view(want), (step, op, args)
    with pytest.raises(ValueError):
        CL.SparseCluster(0)
    assert CL.SlotState.REVOKED.value == JCL.SlotState.REVOKED.value


# ---------------------------------------------------------------------------
# heterogeneity layer
# ---------------------------------------------------------------------------

def test_profiles_are_equal():
    assert H.PAPER_BATCH == JH.PAPER_BATCH == 128
    assert set(H.DEVICE_PROFILES) == set(JH.DEVICE_PROFILES)
    for kind, p in H.DEVICE_PROFILES.items():
        j = JH.DEVICE_PROFILES[kind]
        assert (p.examples_per_sec, p.mem_examples, p.steps_per_sec,
                p.price_hr, p.ondemand_hr, p.usd_per_million_examples) == \
            (j.examples_per_sec, j.mem_examples, j.steps_per_sec,
             j.price_hr, j.ondemand_hr, j.usd_per_million_examples)
    kinds = ["K80", "V100", "P100", "K80"]
    np.testing.assert_array_equal(H.rates_for(kinds), JH.rates_for(kinds))
    np.testing.assert_array_equal(H.caps_for(kinds), JH.caps_for(kinds))
    assert H.composition(kinds) == JH.composition(kinds)
    with pytest.raises(KeyError, match="nope"):
        H.profile("nope")


@pytest.mark.parametrize("batching", ["dynamic", "uniform"])
def test_allocations_and_rates_are_equal(batching):
    rng = np.random.default_rng(1)
    for _ in range(40):
        kinds = list(rng.choice(["K80", "P100", "V100"],
                                size=rng.integers(1, 9)))
        batch = int(rng.integers(0, 600))
        caps = rng.integers(40, 200, size=len(kinds)) \
            if rng.random() < 0.5 else None
        try:
            want = JH.allocate(kinds, batch, batching=batching, caps=caps)
        except ValueError:
            with pytest.raises(ValueError):
                H.allocate(kinds, batch, batching=batching, caps=caps)
            continue
        np.testing.assert_array_equal(
            H.allocate(kinds, batch, batching=batching, caps=caps), want)
        assert H.step_time_s(kinds, batch, batching=batching, caps=caps) \
            == JH.step_time_s(kinds, batch, batching=batching, caps=caps)
        rates = H.rates_for(kinds)
        assert H.aggregate_rate(rates, batching) == \
            JH.aggregate_rate(rates, batching)
    active = rng.random((7, 5)) < 0.6
    rate_w = rng.uniform(100, 2000, size=5)
    np.testing.assert_array_equal(
        H.aggregate_rate_batch(active, rate_w, batching),
        JH.aggregate_rate_batch(active, rate_w, batching))
    with pytest.raises(ValueError):
        H.allocate(["K80"], 4, batching="lumpy")


@pytest.mark.parametrize("batching", ["dynamic", "uniform"])
def test_dynamic_batch_allocator_is_equal(batching):
    """Counts, ``lr_ratio``, the clamped global batch and the solve count
    after every membership change of a mixed fleet."""
    def fleet(mod):
        c = mod.SparseCluster(5)
        c.fill_and_activate(0, 0, kind="K80")
        c.fill_and_activate(1, 0, kind="V100")
        return c

    got_c, want_c = fleet(CL), fleet(JCL)
    kw = dict(global_batch=200, cap_per_slot=70, base_workers=2,
              base_kind="K80", batching=batching)
    got = H.DynamicBatchAllocator(got_c, **kw)
    want = JH.DynamicBatchAllocator(want_c, **kw)
    changes = [("fill_and_activate", 2, 1, "P100"), (None,),
               ("revoke", 0, 2), ("fill_and_activate", 3, 3, "V100"),
               ("revoke", 1, 4), ("fill_and_activate", 0, 5, "K80")]
    for ch in changes:
        if ch[0] is not None:
            for c in (got_c, want_c):
                if ch[0] == "revoke":
                    c.revoke(ch[1], ch[2])
                else:
                    c.fill_and_activate(ch[1], ch[2], kind=ch[3])
        a, b = got.allocation(), want.allocation()
        np.testing.assert_array_equal(a.counts, b.counts)
        assert (a.lr_ratio, a.global_batch, a.membership_version) == \
            (b.lr_ratio, b.global_batch, b.membership_version)
        assert got.solve_count == want.solve_count
    with pytest.raises(ValueError):
        H.DynamicBatchAllocator(got_c, global_batch=0)


# ---------------------------------------------------------------------------
# the launcher's revocation traces
# ---------------------------------------------------------------------------

def _trace_args(**kw):
    base = dict(slots=4, initial_workers=1, join_every=0, revoke_at=None,
                monte_carlo=False, server_kind="K80", steps_per_sec=4.5,
                steps=200)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw", [
    dict(join_every=2, revoke_at=5),
    dict(join_every=16_000, slots=4),
    dict(revoke_at=0),
    dict(monte_carlo=True, initial_workers=4, server_kind="V100",
         steps_per_sec=2e-3, steps=64),
    dict(monte_carlo=True, initial_workers=3, join_every=3, revoke_at=7,
         steps_per_sec=1e-3, steps=40),
], ids=["schedule", "fig5", "revoke0", "monte-carlo", "mixed"])
def test_build_trace_is_equal(kw):
    def events(mod):
        out = mod.build_trace(_trace_args(**kw), np.random.default_rng(7))
        return [(e.step, e.slot, e.kind, e.server_kind, e.region)
                for e in out]

    got, want = events(launch), events(jlaunch)
    assert got == want
    if kw.get("monte_carlo"):
        assert any(k == "revoke" for _, _, k, _, _ in got)
