"""The torch port stands alone: importing every ``repro_torch`` module,
and everything ``chip_smoke.py`` imports, loads neither ``jax`` nor the
JAX package ``repro`` (checked in a fresh interpreter)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    import repro_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for m in mods:
        importlib.import_module(m)
    sys.path.insert(0, {repo!r})
    import chip_smoke  # noqa: F401  (main() runs only as __main__)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps({{"modules": mods, "bad": bad}}))
""")


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=REPO)], env=env,
        capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    # every module of the slice is there to be checked
    for m in ("configs.base", "configs.granite_moe_3b_a800m",
              "data.synthetic", "core.confidence",
              "core.server", "kernels.confidence_gate",
              "kernels.ragged_attention", "kernels.paged_attention",
              "kernels.mixed_attention", "kernels.prefill_attention",
              "kernels.router_gate", "kernels.flash_attention",
              "kernels.rwkv6_scan", "configs.rwkv6_3b",
              "kernels.mamba_scan", "configs.jamba_v0_1_52b",
              "kernels.ops", "kernels.ref",
              "models.params", "models.cache", "models.blocks",
              "models.transformer", "serving.request", "serving.slots",
              "serving.scheduler", "serving.metrics", "serving.faults",
              "serving.engine",
              "launch.serve_async", "launch.mesh", "models.sharding",
              "optim.optimizer", "core.losses", "core.cascade",
              "core.thresholds", "core.calibration", "data.pipeline",
              "models.classifier", "checkpoint.checkpoint",
              "launch.steps", "launch.train", "launch.serve",
              "launch.shapes", "launch.hlo", "launch.roofline",
              "launch.dryrun", "kernels.counting"):
        assert "repro_torch." + m in res["modules"]


def test_kernel_sources_ship_with_the_package():
    csrc = os.path.join(REPO, "src", "repro_torch", "csrc")
    for name in ("confidence_gate", "ragged_attention", "paged_attention",
                 "mixed_attention", "router_gate", "flash_attention",
                 "rwkv6_scan", "mamba_scan"):
        src = open(os.path.join(csrc, name + ".cu")).read()
        assert 'extern "C" int ' + name in src
        assert f"repro/kernels/{name}.py" in src     # names what it replaces


def test_chip_smoke_refuses_to_run_without_a_card():
    """No card: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
