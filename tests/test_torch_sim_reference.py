"""The port's ``core/reference.py`` (the frozen differential engine) and
``core/validate.py`` (the invariant checker) against the reference's: the old
engine's results bit for bit, the checker's verdicts on good schedules, and on
corrupted ones the copy's own ``InvariantViolation`` with the same message."""
import copy

import pytest

from torch_sim_helpers import PORT, REF, same

POLICIES = ("gpipe", "megatron", "varuna", "atlas")


def test_compares_the_port_files():
    assert PORT.reference.__file__.endswith("src/repro_torch/core/reference.py")
    assert PORT.validate.__file__.endswith("src/repro_torch/core/validate.py")
    assert PORT.validate.InvariantViolation is not REF.validate.InvariantViolation


def spec_of(m, M=8, dcs=(0, 0, 1, 2), **kw):
    return m.simulator.PipelineSpec(num_stages=len(dcs), microbatches=M, t_fwd_ms=10.0, act_bytes=2.5e7,
                                    stage_dc=tuple(dcs), stage_param_bytes=4e8, **kw)


TOPOS = {
    "uniform": lambda m: m.simulator.GeoTopology(40.0, True),
    "single": lambda m: m.simulator.GeoTopology(10.0, False),
    "azure": lambda m: m.topology.preset("azure"),
    "skewed": lambda m: m.topology.preset("skewed"),
}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("topo", list(TOPOS))
def test_reference_engine(policy, topo):
    def build(m):
        ref = m.reference
        t = TOPOS[topo](m)
        out = []
        for d in (1, 3):
            old = ref.simulate(spec_of(m), t, policy=policy, n_pipelines=d, dp_replicas_for_allreduce=2)
            new = m.simulator.simulate(spec_of(m), t, policy=policy, n_pipelines=d, dp_replicas_for_allreduce=2,
                                       validate=True)
            m.validate.check_equivalent(old, new)  # the copy's engines agree with each other too
            out.append(old)
        if policy == "atlas":
            out.append(ref.atlas_schedule(spec_of(m, inflight_cap=2), t, 2))
        return out
    same(build)


@pytest.mark.parametrize("topo", list(TOPOS))
def test_checker_helpers(topo):
    def build(m):
        V = m.validate
        t = TOPOS[topo](m)
        spec = spec_of(m, M=64, dcs=(0, 1, 1, 2))
        V.check_atlas_consistency(spec, t, n_pipelines=2, dp_replicas=2)
        sched = m.temporal.atlas_schedule(spec, t, 2)
        V.check_schedule(sched, spec, t)
        return ([V.check_policy(spec, t, p, n_pipelines=2) for p in POLICIES],
                [outcome(lambda: V.check_fast_forward(spec, t, p, n_pipelines=d)) for p in POLICIES for d in (1, 2)])
    same(build)


def outcome(check):
    """What a check returned, or the violation it raised (type and message)."""
    try:
        return check()
    except AssertionError as e:
        return ("raised", type(e).__name__, str(e))


def test_fast_forward_fault_is_kept_as_the_reference_has_it():
    """On the skewed WAN, Atlas with 2 pipelines at M 64 (``spec_of``'s
    shape), the reference's fast-forward parts from full replay by one
    forward time at micro 51.  The copy keeps the fault bit for bit."""
    def build(m):
        spec = spec_of(m, M=64, dcs=(0, 1, 1, 2))
        return outcome(lambda: m.validate.check_fast_forward(spec, m.topology.preset("skewed"), "atlas", 2))
    ref, port = same(build)
    assert port[:2] == ("raised", "InvariantViolation") and "intervals differ" in port[2]


def _corrupt(m, how):
    """A good result or schedule, then one fault planted in it; returns the
    check to run."""
    t = m.simulator.GeoTopology(40.0, True)
    spec = spec_of(m)
    res = m.simulator.simulate(spec, t, policy="varuna", validate=True)
    V = m.validate
    if how == "overlap":
        ivs = sorted(res.busy[(0, 1)], key=lambda iv: iv.start)
        ivs[1].start, ivs[1].end = ivs[0].start, ivs[0].end
    elif how == "bwd-first":
        g = (0, spec.num_stages - 1)
        bwd = next(iv for iv in res.busy[g] if iv.kind == "bwd")
        fwd = next(iv for iv in res.busy[g] if iv.kind == "fwd" and iv.micro == bwd.micro)
        bwd.start, bwd.end = fwd.start - 30.0, fwd.start - 10.0
    elif how == "missing":
        res.busy[(0, 0)].pop()
    elif how == "utilization":
        res.utilization = 1.7
    else:
        sched = m.temporal.atlas_schedule(spec, t, 2)
        if how == "fast-transfer":
            tr = next(tr for tr in sched.transfers if spec.stage_dc[tr.boundary] != spec.stage_dc[tr.boundary + 1])
            tr.end = tr.start + (tr.end - tr.start) * 0.25
        else:
            sched = copy.deepcopy(sched)
            sched.makespan *= 0.5
        return lambda: V.check_schedule(sched, spec, t)
    return lambda: V.check_sim_result(res, spec, policy="varuna")


@pytest.mark.parametrize("how", ["overlap", "bwd-first", "missing", "utilization", "fast-transfer", "makespan"])
def test_corrupted_results_raise_the_copys_violation(how):
    messages = []
    for m in (REF, PORT):
        check = _corrupt(m, how)
        with pytest.raises(m.validate.InvariantViolation) as err:
            check()
        other = REF if m is PORT else PORT
        assert not isinstance(err.value, other.validate.InvariantViolation)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
