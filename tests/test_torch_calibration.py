"""The torch port's gate-calibration telemetry against the JAX package,
on the CPU.

The telemetry (``serving/observability.py``) is a copy of the JAX
package's numpy-only ``ReliabilityBins`` and ``GateCalibration``: fed the
same seeded event stream, the two give the same summaries.  In the
engines it is fed by the scheduler (every gate decision) and by the
engine (every escalated request's outcome at completion), so under the
ragged, padded and split executors, on ``test_torch_serving.py``'s
workload and weights, the port's per-gate ECE, agreement rate and
outcome counts equal the JAX engine's within 1e-9 (the two packages'
confidences differ in the last bits of f32, which is all the ECE sees).
One JAX run per executor, shared by the module's tests.
"""
import math
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import observability as jax_obs  # noqa: E402
from repro.serving import CascadeScheduler as JaxScheduler  # noqa: E402
from repro.serving import GateSpec as JaxGateSpec  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serving import CascadeScheduler, GateSpec  # noqa: E402
from repro_torch.serving import metrics as metrics_lib  # noqa: E402
from repro_torch.serving import observability as obs  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from tests.test_torch_model import configs_of  # noqa: E402
from tests.test_torch_serving import (EXECUTORS, EXP, FAST, _drain,  # noqa: E402
                                      _jax_engine, _probe_delta,
                                      _torch_engine, _workload)
from tests.test_torch_serving import _req  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401


def assert_close_tree(got, want, path="", atol=1e-9):
    """Nested dicts and lists equal: ints and strings exactly, floats
    within ``atol`` (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_close_tree(got[k], want[k], f"{path}/{k}", atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, f"{path}[{i}]", atol)
    elif isinstance(want, float):
        assert isinstance(got, float), (path, got)
        assert (math.isnan(got) and math.isnan(want)) or \
            abs(got - want) <= atol, (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---------------------------------------------------------------------------
# the copied telemetry against the reference's, event for event
# ---------------------------------------------------------------------------


def test_length_bucket_matches_jax():
    assert metrics_lib.length_bucket is obs.length_bucket
    for n in range(1, 1100):
        assert obs.length_bucket(n) == jax_obs.length_bucket(n)


@pytest.mark.parametrize("bins", [10, 7])
def test_gate_calibration_matches_jax_event_for_event(bins):
    """Two gates fed one seeded stream of gate decisions, escalation
    outcomes (with prompt lengths) and verify outcomes, confidences at
    the bin edges included: every readout and the summary equal the
    reference's exactly."""
    rng = np.random.default_rng(bins)
    mine, ref = obs.GateCalibration(2, bins), jax_obs.GateCalibration(2, bins)
    assert math.isnan(mine.ece(0)) and math.isnan(mine.agreement_rate(1))
    edges = [0.0, 1.0, 0.5, 1.0 / bins, 1.0 - 1e-12]
    for i in range(400):
        gate = int(rng.integers(2))
        conf = edges[i] if i < len(edges) else float(rng.random())
        what = int(rng.integers(3))
        for cal in (mine, ref):
            if what == 0:
                cal.record_gate(gate, conf, bool(conf < 0.4))
            elif what == 1:
                cal.record_outcome(gate, conf, bool(i % 3),
                                   int(1 + i % 90) if i % 5 else None)
            else:
                cal.record_verify_outcome(gate, conf, bool(i % 4))
    for g in range(2):
        assert mine.ece(g) == ref.ece(g)
        assert mine.agreement_rate(g) == ref.agreement_rate(g)
        assert mine.verify_accept_rate(g) == ref.verify_accept_rate(g)
    assert_close_tree(mine.summary(), ref.summary(), atol=0.0)
    with pytest.raises(ValueError):
        obs.ReliabilityBins(0)


def test_scheduler_streams_gate_decisions_like_jax():
    """The scheduler's ``calibration`` sink sees every gate decision, δ
    fixed and budget-calibrated, as the JAX scheduler's does."""
    for gates in ([GateSpec(delta=0.3)], [GateSpec(budget=0.25)]):
        jgates = [JaxGateSpec(delta=g.delta, budget=g.budget)
                  for g in gates]
        mine = CascadeScheduler([2, 2], gates,
                                calibration=obs.GateCalibration(1))
        ref = JaxScheduler([2, 2], jgates,
                           calibration=jax_obs.GateCalibration(1))
        rng = np.random.default_rng(1)
        for c in rng.random(40):
            assert mine.gate_decision(0, float(c)) == \
                ref.gate_decision(0, float(c))
        assert_close_tree(mine.calibration.summary(),
                          ref.calibration.summary(), atol=0.0)
    assert CascadeScheduler([1, 1], gates).calibration is None
    assert CascadeScheduler([1, 1], gates).gate_decision(0, 0.1) is True


def test_metrics_stream_gate_outcomes():
    """``record_gate_outcomes`` feeds one outcome per gate crossed (did
    tier g+1's stream equal tier g's?); the snapshot reads them."""
    m = metrics_lib.ServingMetrics(
        [metrics_lib.TierCost(n, 1.0) for n in "abc"], [1, 1, 1])
    req = _req(0, gen_len=2)
    req.tier = 2
    req.tokens_by_tier = [[1, 2], [1, 2], [3, 2]]
    req.seq_conf_by_tier = [0.15, 0.85]
    m.record_gate_outcomes(req)
    cal = m.calibration
    assert cal.outcomes == [1, 1] and cal.agreements == [1, 0]
    snap = m.snapshot(3.0)
    assert snap["gate_outcomes"] == [1, 1]
    assert snap["gate_agreement"] == [1.0, 0.0]
    assert snap["gate_ece"] == pytest.approx([0.85, 0.85])
    assert m.summary()["gate_calibration"][1]["ece"] == pytest.approx(0.85)


# ---------------------------------------------------------------------------
# the engines' telemetry under each executor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """gemma3-1b and phi4-mini-3.8b at the smoke widths, keyed as
    ``test_torch_serving.py``'s fixture keys them (same seeds)."""
    out = {}
    for i, name in enumerate((FAST, EXP)):
        cfg, tcfg = configs_of(name)
        jp = jax.tree.map(np.asarray, jax_init_params(
            cfg, jax.random.PRNGKey(i), jnp.float32))
        out[name] = (cfg, jp, from_jax(jp))
        out[name, "torch"] = tcfg
    return out


@pytest.fixture(scope="module")
def served(weights):
    """executor -> (JAX engine, port engine) after serving the lognormal
    workload at a δ that splits it; each pair built on first use."""
    cache = {}

    def get(executor):
        if executor not in cache:
            delta = _probe_delta(weights, "lognormal")
            kw = EXECUTORS[executor]
            work = _workload("lognormal")
            cache[executor] = (
                _drain(_jax_engine(weights, delta, **kw), work),
                _drain(_torch_engine(weights, delta, **kw), work))
        return cache[executor]
    return get


@pytest.mark.parametrize("executor", ["ragged", "padded", "split"])
def test_engine_calibration_matches_jax(served, executor):
    """Per-gate ECE, agreement rate and outcome counts equal the JAX
    engine's (abs 1e-9), with escalated and kept requests both present;
    the whole calibration summary and the snapshot too, every count
    exactly and every float within 1e-8 (a prompt bucket's ECE averages
    fewer confidences, whose f32 values may differ by an ulp or two,
    4.7e-10 each at 0.005)."""
    ref, mine = served(executor)
    assert {r.tier for r in mine.requests} == {0, 1}
    cal, jcal = mine.metrics.calibration, ref.metrics.calibration
    escalated = sum(r.tier == 1 for r in mine.requests)
    assert cal.outcomes == jcal.outcomes == [escalated]
    assert cal.agreements == jcal.agreements
    assert sum(cal.conf_hist[0]) == len(mine.requests)
    assert abs(cal.ece(0) - jcal.ece(0)) <= 1e-9
    assert cal.agreement_rate(0) == jcal.agreement_rate(0)
    assert_close_tree(mine.metrics.summary()["gate_calibration"],
                      ref.metrics.summary()["gate_calibration"], atol=1e-8)
    snap, jsnap = mine.metrics.snapshot(1.0), ref.metrics.snapshot(1.0)
    for key in ("gate_ece", "gate_agreement", "gate_outcomes",
                "escalation_rates", "completed", "steps"):
        assert_close_tree(snap[key], jsnap[key], key)


def test_cli_prints_the_calibration_line(capsys):
    """``--device cpu``: the report's gate-calibration line and the
    snapshot's gate ECE, one outcome per escalated request."""
    args = serve_async.make_parser().parse_args(
        ["--device", "cpu", "--requests", "6", "--slots", "2",
         "--prompt-len", "12", "--gen-len", "3", "--length-dist",
         "lognormal", "--virtual-clock"])
    s = serve_async.run(args, VirtualClock())
    serve_async.report(s)
    g0 = s["gate_calibration"][0]
    assert g0["outcomes"] == sum(r["tier"] == 1 for r in s["per_request"])
    assert g0["seen"] == 6 and s["snapshot"]["gate_outcomes"] == [
        g0["outcomes"]]
    out = capsys.readouterr().out
    assert "gate calibration g0: ece " in out
    assert f"({g0['outcomes']} outcomes, 0 verified" in out
    assert "gate ece [" in out
