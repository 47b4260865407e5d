"""The torch port's serving observability and flat-bucket overrides
against the JAX package, on the CPU.

The tracer first: the port's ``Tracer`` and the JAX one driven through
the same calls (a ring that drops events included) give the same trace
once timestamps are removed.  Then the engines, at the smoke widths of
``tests/test_observability.py::_engine`` (gemma3-1b smoke weights from
PRNGKey 0 on both tiers, δ 0.5, a ``VirtualClock``): traced runs under
the ragged executor with the prefix cache on (shared-prefix prompts, so
hit and miss instants occur), the split executor, the uniform one-shot
prefill and the ragged executor on overriding flat buckets give the JAX
engine's event sequence — name, phase, track and arguments, without
timings or free-text errors — the JAX engine's metric snapshots under
``run(metrics_interval=3.0)`` and, for the buckets, its bucket widths.
Tracing changes no stream, launch or host sync; the exported trace
passes ``scripts/check_trace.py``; bad bucket sets raise the JAX
engine's errors; and with ``profile_annotations`` a CPU
``torch.profiler`` shows one ``run_ragged/<tier>`` range per ragged
launch and one ``tick/<id>`` range per tick.  Each JAX run is made once
and shared by the module.
"""
import json
import os
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import CascadeEngine as JaxEngine  # noqa: E402
from repro.serving import TierSpec as JaxTierSpec  # noqa: E402
from repro.serving import observability as jax_obs  # noqa: E402
from repro.serving.engine import VirtualClock as JaxVirtualClock  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serving import CascadeEngine, TierSpec, Tracer  # noqa: E402
from repro_torch.serving import observability as obs  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from tests.test_torch_faults import (_InterruptingClock,  # noqa: E402
                                     _share_jits)
from tests.test_torch_model import configs_of  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import check_trace  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

ENGINE_KW = dict(slots=3, prompt_len=16, gen_len=4, deltas=[0.5],
                 kv_block_size=4, prefill_chunk=5)


# ---------------------------------------------------------------------------
# the tracer alone
# ---------------------------------------------------------------------------


def _strip(trace: dict) -> dict:
    """A trace without timestamps, durations and free-text errors."""
    evs = []
    for e in trace["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        e["args"] = {k: v for k, v in e.get("args", {}).items()
                     if k != "error"}
        evs.append(e)
    return {**trace, "traceEvents": evs}


def _drive(tr) -> None:
    """Every call of the tracer's surface, in one order."""
    tr.name_process(jax_obs.ENGINE_PID, "engine ticks")
    tr.name_track(jax_obs.ENGINE_PID, 0, "tier0 fast")
    tr.name_process(jax_obs.REQUEST_PID_BASE, "requests tier0 fast")
    tr.request_transition(7, "QUEUED", 0, prompt_tokens=12)
    tr.request_transition(7, "PREFILL", 0, shard=1, tick=1)
    with tr.span("admit", tid=0, tick=1):
        pass
    tr.phase("plan", 0, tr.now_us(), tick=1, width=4)
    t0 = tr.now_us()
    tr.phase("launch", 0, t0, t0 + 5.0, kind="ragged", width=8)
    tr.instant("launch_retry", 0, tick=1, kind="run_ragged", attempt=0,
               error="injected")
    tr.prefix_cache_event(0, 7, 8, 12, tick=1, shard=0)
    tr.prefix_cache_event(0, 8, 0, 3, tick=1, shard=0)
    tr.counter("queue depth/fast", 3, tid=0)
    tr.request_transition(7, "ESCALATED", 1, None, tick=2)
    tr.request_done(7, 1, tick=3)
    tr.request_done(9, 0, None, state="SHED", tick=3)
    tr.request_done(8, 0, 0, state="FAILED", tick=3, error="gone")


@pytest.mark.parametrize("capacity", [1 << 18, 5])
def test_tracer_matches_jax_tracer(capacity, tmp_path):
    """Same calls, same trace (the 5-event ring drops, and may open with
    an orphan close, in both); the export round-trips."""
    mine, ref = Tracer(capacity), jax_obs.Tracer(capacity)
    _drive(mine)
    _drive(ref)
    assert mine.dropped == ref.dropped == (0 if capacity > 100 else 11)
    assert _strip(mine.trace_dict()) == _strip(ref.trace_dict())
    path = tmp_path / "t.json"
    n = mine.export(str(path))
    assert _strip(json.loads(path.read_text())) == _strip(mine.trace_dict())
    assert n == len(mine.trace_dict()["traceEvents"])
    if capacity > 100:
        assert check_trace.validate_trace(mine.trace_dict()) == []
    with pytest.raises(ValueError, match="capacity must be positive"):
        Tracer(0)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX weights, port weights): gemma3-1b
    smoke from PRNGKey(0), both tiers."""
    jcfg, cfg = configs_of("gemma3-1b")
    jp = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    return jcfg, cfg, jp, from_jax(jp)


def _engine(weights, package, tracer=None, **kw):
    jcfg, cfg, jp, tp = weights
    kw = {**ENGINE_KW, **kw}
    if package == "jax":
        eng = JaxEngine([JaxTierSpec("fast", jcfg, jp),
                         JaxTierSpec("exp", jcfg, jp)],
                        clock=JaxVirtualClock(), tracer=tracer, **kw)
        _share_jits(eng)
        return eng
    return CascadeEngine([TierSpec("fast", cfg, tp), TierSpec("exp", cfg, tp)],
                         clock=VirtualClock(), tracer=tracer, device="cpu",
                         **kw)


def _mixed_prompts(vocab):
    """``tests/test_observability.py::_submit_all``'s prompts: 6 of 1-16
    tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(1, 17))).astype(
        np.int32) for _ in range(6)]


def _shared_prompts(vocab):
    """6 prompts of 16 tokens, the first 12 shared."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, vocab, 16).astype(np.int32)
    out = []
    for _ in range(6):
        p = base.copy()
        p[12:] = rng.integers(0, vocab, 4)
        out.append(p)
    return out


# case -> (prompts(vocab), engine kwargs)
CASES = {
    "ragged-prefix": (_shared_prompts, {"prefix_cache": True}),
    "split": (_mixed_prompts, {"use_unified_step": False}),
    "uniform": (_shared_prompts, {"use_chunked_prefill": False}),
    "flat-buckets": (_mixed_prompts, {"flat_buckets": [8, 48, 96]}),
}


def _serve(weights, package, case, traced=True):
    make, kw = CASES[case]
    tr = (Tracer() if package == "torch" else jax_obs.Tracer()) \
        if traced else None
    eng = _engine(weights, package, tr, **kw)
    for i, p in enumerate(make(weights[1].vocab_size)):
        eng.submit(p, arrival_time=float(i // 2))
    snaps = []
    summary = eng.run(max_steps=200, metrics_interval=3.0,
                      on_snapshot=snaps.append)
    return {"engine": eng, "summary": summary, "tracer": tr, "snaps": snaps}


@pytest.fixture(scope="module")
def served(weights):
    """(package, case) -> traced run, each made once on first use."""
    runs = {}

    def get(package, case):
        if (package, case) not in runs:
            runs[(package, case)] = _serve(weights, package, case)
        return runs[(package, case)]
    return get


def _events(tracer) -> list:
    """(name, ph, pid, tid, args) of every event, without timings and
    free-text errors."""
    return [(e["name"], e["ph"], e["pid"], e["tid"],
             {k: v for k, v in e.get("args", {}).items() if k != "error"})
            for e in tracer.trace_dict()["traceEvents"]]


def _streams(eng):
    return [(r.rid, r.tier, r.state.name, list(r.tokens))
            for r in eng.requests]


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_events_match_jax(served, case):
    """The port's event sequence is the JAX engine's; the run covers
    every phase, and the prefix-cache run both instants."""
    mine, ref = served("torch", case), served("jax", case)
    assert _streams(mine["engine"]) == _streams(ref["engine"])
    got, want = _events(mine["tracer"]), _events(ref["tracer"])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    assert mine["tracer"].dropped == ref["tracer"].dropped == 0
    names = {e[0] for e in got}
    assert {"tick", "admit", "plan", "launch", "device_get", "finish",
            "QUEUED", "PREFILL", "DECODE", "ESCALATED", "DONE"} <= names
    if case == "ragged-prefix":
        assert {"prefix_cache_hit", "prefix_cache_miss"} <= names
    ticks = [e for e in got if e[0] == "tick"]
    assert len(ticks) == mine["summary"]["steps"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_run_matches_untraced(weights, served, case):
    """Tracing is observational: streams, launches, host syncs and ticks
    are those of the run without a tracer."""
    traced = served("torch", case)
    plain = _serve(weights, "torch", case, traced=False)
    assert _streams(plain["engine"]) == _streams(traced["engine"])
    for key in ("launches", "launches_by_kind", "host_syncs",
                "host_syncs_per_tick", "steps"):
        assert plain["summary"][key] == traced["summary"][key], key
    assert plain["engine"].host_syncs == traced["engine"].host_syncs


@pytest.mark.parametrize("case", sorted(CASES))
def test_exported_trace_passes_check_trace(served, case, tmp_path):
    """The chunked executors' exported traces validate, as the JAX
    engine's do.  Under the uniform executor the JAX engine's trace
    fails the checker (the ``admit`` phase encloses the prefill's
    ``launch`` and ``device_get`` but is appended after them, so its
    start goes back in time on the tier's track) and the port's fails
    at the same events, the reference's layout being kept."""
    mine, ref = served("torch", case), served("jax", case)
    path = tmp_path / "trace.json"
    mine["tracer"].export(str(path))
    got = check_trace.check_file(str(path))
    want = check_trace.validate_trace(ref["tracer"].trace_dict())
    if case != "uniform":
        assert got == want == []
        return
    assert want and [e.split(":")[0] for e in got] == \
        [e.split(":")[0] for e in want]
    assert all("'admit'" in e for e in got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_snapshots_match_jax(served, case):
    """``run(metrics_interval=3.0)``: the same number of snapshots at the
    same clock times with the same counts, rates and tick p50; the gate
    ECE, a mean of f32 confidences (near 0.005 here, where an f32 ulp is
    4.7e-10), within 1e-8 of the JAX engine's, the confidence tolerance
    of the port's other parity suites."""
    mine, ref = served("torch", case)["snaps"], served("jax", case)["snaps"]
    assert mine and [s["t"] for s in mine] == [s["t"] for s in ref]
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(
                np.asarray(a[k], np.float64), np.asarray(b[k], np.float64),
                rtol=0, atol=1e-8 if k == "gate_ece" else 0, err_msg=k)


def test_flat_buckets_choose_the_jax_widths(served):
    """Overriding buckets: every ragged launch takes the width the JAX
    engine takes (the launch events' ``width``), and the widths used
    include the non-power-of-two 48."""
    mine, ref = served("torch", "flat-buckets"), served("jax",
                                                        "flat-buckets")
    widths = [e[4]["width"] for e in _events(mine["tracer"])
              if e[0] == "launch"]
    assert widths == [e[4]["width"] for e in _events(ref["tracer"])
                      if e[0] == "launch"]
    assert set(widths) == {8, 48}
    assert [rt.flat_buckets for rt in mine["engine"].runtimes] == \
        [rt.flat_buckets for rt in ref["engine"].runtimes] == [[8, 48, 96]] * 2


def _jax_error(weights, kw):
    with pytest.raises(ValueError) as err:
        _engine(weights, "jax", **kw)
    return str(err.value)


@pytest.mark.parametrize("kw", [
    {"flat_buckets": []},
    {"flat_buckets": [0, 16]},
    {"flat_buckets": [-8, 64]},
    {"flat_buckets": [8, 40]},
    {"flat_buckets": [8, 50, 96]},
    {"flat_buckets": [4, 12]},
    {"flat_buckets": [8, 64], "use_ragged_step": False},
], ids=["empty", "zero", "negative", "not-x16", "not-x16-mid",
        "too-small", "no-ragged"])
def test_bad_flat_buckets_raise_like_jax(weights, kw):
    want = _jax_error(weights, kw)
    with pytest.raises(ValueError) as err:
        _engine(weights, "torch", **kw)
    assert str(err.value) == want


def test_flat_buckets_sorted_and_warmed(weights, monkeypatch):
    """An override is deduplicated and sorted as in the JAX engine, widths
    up to 16 need not be multiples of 16, and ``warmup`` runs the ragged
    step once at every given width."""
    eng = _engine(weights, "torch", flat_buckets=[96, 5, 16, 96, 48])
    assert [rt.flat_buckets for rt in eng.runtimes] == [[5, 16, 48, 96]] * 2
    seen = []

    def recording(run):
        def run_ragged(flat_tokens, *rest):
            seen.append(flat_tokens.shape[1])
            return run(flat_tokens, *rest)
        return run_ragged
    for rt in eng.runtimes:
        monkeypatch.setattr(rt, "run_ragged", recording(rt.run_ragged))
    eng.warmup()
    assert seen == [5, 16, 48, 96] * 2


def test_profile_annotations_name_every_launch(weights):
    """Under a CPU ``torch.profiler`` each ragged launch runs in one
    ``run_ragged/<tier>`` range and each tick in ``tick/<id>``; without
    ``profile_annotations`` no range is opened."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for on in (True, False):
        make, kw = CASES["flat-buckets"]
        eng = _engine(weights, "torch", profile_annotations=on, **kw)
        for i, p in enumerate(make(weights[1].vocab_size)[:3]):
            eng.submit(p, arrival_time=float(i // 2))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            s = eng.run(max_steps=200)
        names = [e.name for e in prof.events()]
        counts[on] = {n: names.count(n) for n in set(names)
                      if n.startswith(("run_", "tick/"))}
    kinds = s["launches_by_kind"]
    assert counts[True] == {
        "run_ragged/fast": kinds[0]["ragged"],
        "run_ragged/exp": kinds[1]["ragged"],
        **{f"tick/{t}": 1 for t in range(1, s["steps"] + 1)}}
    assert counts[False] == {}


def test_annotations_are_shared_no_ops_when_off():
    assert obs.annotation("run_ragged/x", False) is obs.NULL_CONTEXT
    assert obs.step_annotation(3, False) is obs.NULL_CONTEXT
    with obs.profile_window(None) as prof:
        assert prof is None


def test_cuda_ranges_and_profiles_fail_without_a_card(tmp_path):
    """Asked for the card, the NVTX range and the CUDA profiler window
    raise where they cannot reach one; nothing turns into a CPU-only
    range or trace."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        with obs.annotation("run_ragged/x", True, "cuda"):
            pass
    with pytest.raises(RuntimeError):
        with obs.step_annotation(1, True, "cuda"):
            pass
    with pytest.raises(RuntimeError, match="cannot trace the card"):
        with obs.profile_window(str(tmp_path), "cuda"):
            pass
    assert not (tmp_path / obs.PROFILE_TRACE).exists()


# ---------------------------------------------------------------------------
# the serve_async CLI
# ---------------------------------------------------------------------------


CLI = ["--device", "cpu", "--requests", "6", "--rate", "4", "--slots", "2",
       "--prompt-len", "16", "--gen-len", "3", "--prefill-chunk", "8",
       "--kv-block-size", "4", "--expensive", "gemma3-1b", "--virtual-clock",
       "--length-dist", "lognormal"]


def test_cli_traces_profiles_snapshots_and_buckets(tmp_path, capsys):
    """``--trace-out`` writes a trace ``check_trace.py`` accepts (and the
    summary counts it), ``--metrics-interval`` prints one snapshot line
    per window, ``--profile`` writes the profiler's Chrome trace with the
    launch ranges in it, and ``--flat-buckets`` sets the ragged widths."""
    trace, prof = tmp_path / "t.json", tmp_path / "prof"
    args = serve_async.make_parser().parse_args(CLI + [
        "--trace-out", str(trace), "--trace-ring", "100000",
        "--metrics-interval", "3", "--profile", str(prof),
        "--flat-buckets", "16", "8"])
    s = serve_async.run(args, VirtualClock())
    out = capsys.readouterr().out
    assert s["conservation"]["ok"] and s["flat_buckets"] == [[8, 16]] * 2
    assert check_trace.main([str(trace)]) == 0
    assert s["trace_events"] == len(json.loads(trace.read_text())[
        "traceEvents"]) and s["trace_dropped"] == 0
    assert f"wrote {s['trace_events']} trace events" in out
    snaps = [line for line in out.splitlines() if line.startswith("[t=")]
    assert len(snaps) == s["steps"] // 3
    profile = json.loads((prof / obs.PROFILE_TRACE).read_text())
    ranges = [e["name"] for e in profile["traceEvents"]
              if e.get("name", "").startswith("run_ragged/")]
    assert len(ranges) == sum(s["launches"])


def test_cli_writes_the_trace_after_an_interrupt(tmp_path, capsys):
    """Ctrl-C still writes ``--trace-out``, and a small ring reports its
    drops."""
    trace = tmp_path / "t.json"
    args = serve_async.make_parser().parse_args(CLI + [
        "--trace-out", str(trace), "--trace-ring", "50"])
    s = serve_async.run(args, _InterruptingClock(4))
    out = capsys.readouterr().out
    assert s["interrupted"] and s["trace_dropped"] > 0
    assert "interrupted at t=" in out and f"({s['trace_dropped']} dropped)" \
        in out
    assert json.loads(trace.read_text())["otherData"]["dropped_events"] \
        == s["trace_dropped"]
