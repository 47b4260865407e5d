"""The port's modality frontends and M-RoPE against the JAX package, on
the CPU.

qwen2-vl-72b (the vision frontend, M-RoPE) and musicgen-large (the audio
frontend) at their smoke widths: the same weights in both packages
(drawn by the port's ``init_params``, handed to JAX as numpy and back
through ``from_jax``), precomputed frontend embeddings and tokens from a
numpy seed.  M-RoPE is held to the JAX package at the
published head width 128 (1024 patch positions on the 32-wide grid, then
128 text positions) and at the smoke width; the uniform prefill (the
frontend's projection over the first ``frontend_len`` positions) and the
dense-arena decode steps after it against the JAX full forward; the
chunked modes and a prompt shorter than the frontend raising in both
packages.  The JAX forwards are jitted once per module.
"""
import functools
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks, init_params, transformer  # noqa: E402
from repro_torch.models.cache import init_cache  # noqa: E402
from repro_torch.models.params import from_jax, tree_map  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

VISION, AUDIO = "qwen2-vl-72b", "musicgen-large"
FRONTENDS = (VISION, AUDIO)
B, S, DECODE = 2, 14, 3        # S - DECODE prompt tokens, then 3 decodes


@functools.lru_cache(maxsize=None)
def model(name):
    """(JAX config, weights as numpy, port config, port weights): the
    port's ``init_params`` draw (the JAX package's eager one compiles a
    draw per leaf shape), which the JAX forwards take as they are."""
    cfg = get_config(name, "smoke")
    jp = tree_map(lambda t: t.numpy(), init_params(
        cfg, FRONTENDS.index(name) + 5, device="cpu"))
    return jax_get_config(name, "smoke"), jp, cfg, from_jax(jp)


def batch(cfg, seed, s=S):
    """tokens [B, s] and frontend embeddings [B, frontend_len,
    frontend_dim], numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                np.int32),
            "frontend_embeds": rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("hd,fl,n", [(128, 1024, 1152), (32, 8, 20)])
def test_mrope_matches_jax(hd, fl, n):
    """``apply_rope(kind="mrope")``: sections (d/8, ...) of the head
    width, image positions (``pos < frontend_len``) on the 32-wide patch
    grid, text positions in all three sections — within 1e-6 of the JAX
    package, rows starting at different offsets."""
    cfg, jcfg = get_config(VISION, ""), jax_get_config(VISION, "")
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((2, n, 2, hd)).astype(np.float32)
    k = rng.standard_normal((2, n, 1, hd)).astype(np.float32)
    pos = np.stack([np.arange(n), np.arange(n) + 3]).astype(np.int32)
    # op by op, as the JAX package's eager call computes it (under
    # jax.jit XLA's fused sin/cos of the large angles move by up to ~2e-5)
    want = jax_blocks.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(pos), jcfg, "mrope", fl)
    got = blocks.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(pos), cfg, "mrope", fl)
    assert blocks._mrope_sections(hd) == jax_blocks._mrope_sections(hd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    # text positions rotate as plain RoPE would in every section
    plain = blocks.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(pos), cfg, "mrope", 0)
    assert not torch.allclose(plain[0][:, :fl], got[0][:, :fl])
    assert torch.equal(plain[0][0, fl:], got[0][0, fl:])


@functools.lru_cache(maxsize=None)
def jax_full_logits(name):
    jcfg, jp = model(name)[:2]
    b = batch(jcfg, 1)
    logits, _ = jax.jit(jax_transformer.train_logits, static_argnums=1)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    return b, np.asarray(logits)


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_prefill_then_decode_match_jax_forward(name):
    """The uniform prefill of the first ``S - 3`` tokens with random
    frontend embeddings over the first ``frontend_len`` positions, then 3
    dense-arena decode steps: each step's logits within 1e-5 of the JAX
    full forward's at the same position; the prefill's too."""
    _, _, cfg, tp = model(name)
    b, want = jax_full_logits(name)
    n = S - DECODE
    tb = _torch(b)
    logits, part = transformer.prefill(
        tp, cfg, {"tokens": tb["tokens"][:, :n],
                  "frontend_embeds": tb["frontend_embeds"]})
    np.testing.assert_allclose(logits[:, 0].numpy(), want[:, n - 1],
                               atol=1e-5, rtol=1e-5)
    cache = init_cache(cfg, B, S, torch.float32, "cpu")
    tree_map(lambda full, new: full[tuple(slice(0, s) for s in new.shape)]
             .copy_(new), cache, part)
    for t in range(n, S):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        logits, cache = transformer.decode_step(
            tp, cfg, tb["tokens"][:, t:t + 1], cache, pos)
        np.testing.assert_allclose(logits[:, 0].numpy(), want[:, t],
                                   atol=1e-5, rtol=1e-5)


def test_frontend_replaces_the_leading_embeddings():
    """Tokens under the frontend positions do not reach the logits;
    tokens after them and the frontend embeddings do."""
    _, _, cfg, tp = model(VISION)
    tb = _torch(batch(cfg, 2))
    base = transformer.train_logits(tp, cfg, tb)[0]
    fl = cfg.frontend_len
    under = dict(tb, tokens=tb["tokens"].clone())
    under["tokens"][:, :fl] = (under["tokens"][:, :fl] + 1) % cfg.vocab_size
    assert torch.equal(transformer.train_logits(tp, cfg, under)[0], base)
    after = dict(tb, tokens=tb["tokens"].clone())
    after["tokens"][:, fl] = (after["tokens"][:, fl] + 1) % cfg.vocab_size
    assert not torch.allclose(transformer.train_logits(tp, cfg, after)[0],
                              base)
    moved = dict(tb, frontend_embeds=tb["frontend_embeds"] + 1.0)
    assert not torch.allclose(transformer.train_logits(tp, cfg, moved)[0],
                              base)


@pytest.mark.parametrize("mode", ["ragged_step", "mixed_step",
                                  "prefill_chunk"])
def test_chunked_modes_raise_for_frontends_in_both_packages(mode):
    """The chunked modes do not inject frontend embeddings: both packages
    raise NotImplementedError before touching the cache."""
    jcfg, jp, cfg, tp = model(VISION)
    b = batch(cfg, 3, s=4)
    pos = np.zeros((B, 4), np.int32)
    with pytest.raises(NotImplementedError, match="frontend"):
        jax_transformer.forward(jp, jcfg, b, mode=mode, cache={},
                                pos=jnp.asarray(pos), pages={})
    with pytest.raises(NotImplementedError, match="frontend"):
        transformer.forward(tp, cfg, _torch(b), mode=mode, cache={},
                            pos=torch.from_numpy(pos), pages={})


def test_prompt_shorter_than_the_frontend_raises_in_both_packages():
    """A prefill of fewer tokens than ``frontend_len``: the port names
    both lengths in a ValueError; the JAX package raises ValueError too
    (from ``jnp.pad``'s negative width)."""
    jcfg, jp, cfg, tp = model(AUDIO)
    b = batch(cfg, 4, s=cfg.frontend_len - 3)
    with pytest.raises(ValueError, match="negative"):
        jax_transformer.forward(jp, jcfg, b, mode="prefill")
    with pytest.raises(ValueError, match=f"of {cfg.frontend_len - 3} "
                                         f"tokens .* {cfg.frontend_len} "
                                         "positions"):
        transformer.prefill(tp, cfg, _torch(b))
    # decode takes no frontend embeddings
    assert transformer._embed(tp, cfg, {"tokens": torch.zeros(
        (B, 1), dtype=torch.int32)}, "decode").shape == (B, 1, cfg.d_model)
