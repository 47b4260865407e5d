"""Run ``chip_smoke.py``'s phase 12 alone: the model axis under every
executor and tier family.

Builds the port's CUDA kernels, then, with both tiers on ``1x2`` meshes
over the first card twice (``--shard-params``) against unsharded: draws
phase 4's published-width gemma3-1b -> phi4-mini-3.8b weights and runs
``chip_smoke.check_model_axis_executors`` (12a the uniform prefill and
the dense arena, 12b speculation at k = 4); then, each in place of the
last expensive tier, rwkv6-3b (12c, 32 layers), jamba-v0.1-52b cut to 1
period (12d) and qwen2-vl-72b cut to 8 layers (12e), each served by
``check_model_axis_family`` and teacher-forced cut to 2 layers (jamba:
the narrow 8-layer period) on two model shards against unsharded;
then, where five cards or more are visible, phase 12b
(``check_qwen_cards``: qwen2-vl-72b at its 80 layers over four cards,
its fit per card printed first), else one line saying why it did not
run.  ``--cases`` first runs the card tests of the model shards' kernel
shapes (``-k model_shard``: ``flash_attention`` at a shard's heads,
``rwkv6_scan`` at 20 heads, ``mamba_scan`` at 4096 channels).  From the
repo root:

    python3 scripts/torch_model_axis_executors_phase.py [--cases]

prints the card's ``name, power.limit`` line and the phase's JSON
records; exits non-zero if a check fails.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch import kernels  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.build(kernels.KERNELS)
    build_s = time.perf_counter() - t0
    if "--cases" in sys.argv[1:]:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", "-k", "model_shard",
             str(ROOT / "tests" / "test_torch_kernels_cuda.py")],
            capture_output=True, text=True, env=env, timeout=600)
        last = (tests.stdout.strip().splitlines() or [""])[-1]
        chip_smoke.emit(check="model axis executors kernel cases", card=card,
                        rc=tests.returncode, tests=last)
        if tests.returncode != 0:
            print(tests.stdout[-6000:], flush=True)
            return 1
    t0 = time.perf_counter()
    args = chip_smoke.main_path_args()
    params = chip_smoke.serve_async.build_params(args)
    counts = chip_smoke.check_model_axis_executors(card, params)
    dev = chip_smoke.card_devices()[0]
    fast = chip_smoke.get_config("gemma3-1b", args.variant)
    rwkv = chip_smoke.get_config(chip_smoke.RWKV_NAME, args.variant)
    jamba = dataclasses.replace(
        chip_smoke.get_config(chip_smoke.JAMBA_NAME, args.variant),
        num_periods=1)
    qwen = dataclasses.replace(
        chip_smoke.get_config(chip_smoke.QWEN_NAME, args.variant),
        num_periods=8)
    narrow = chip_smoke.narrow_jamba_period(
        chip_smoke.get_config(chip_smoke.JAMBA_NAME, "smoke"))
    for label, name, cfg, cfgs, tf_label, flags, tokens in (
            ("rwkv6", chip_smoke.RWKV_NAME, rwkv, None, "rwkv6-3b 2 layers",
             {}, args.prompt_len),
            ("jamba 1 period", chip_smoke.JAMBA_NAME, jamba, (fast, jamba),
             "jamba narrow period", {}, args.prompt_len),
            ("qwen2-vl 8 layers", chip_smoke.QWEN_NAME, qwen, (fast, qwen),
             "qwen2-vl-72b 2 layers",
             {"prompt_len": chip_smoke.QWEN_PROMPT_LEN},
             chip_smoke.QWEN_PROMPT_LEN)):
        params = (params[0], None)
        torch.cuda.empty_cache()
        params = (params[0], chip_smoke.init_params(cfg, args.seed + 1,
                                                    torch.float32, dev))
        if cfg is jamba:
            tf_cfg, tf_params = narrow, chip_smoke.init_params(
                narrow, args.seed + 1, torch.float32, dev)
        else:
            tf_cfg = dataclasses.replace(cfg, num_periods=2)
            tf_params = chip_smoke.first_periods(params[1], 2)
        counts.update(chip_smoke.check_model_axis_family(
            card, params, label, name, cfgs, tf_label, tf_cfg, tf_params,
            tokens, **flags))
        del tf_params
    params = (params[0], None)
    torch.cuda.empty_cache()
    chip_smoke.check_qwen_cards(card, params[0])
    chip_smoke.emit(phase="model axis executors alone", card=card,
                    build_s=build_s, phase_s=time.perf_counter() - t0,
                    launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
