"""Rotary positions over part of each head (``ModelConfig.partial_rotary_factor``),
port side only: the reference has no such field.

* At 1.0 (every registry entry) ``apply_rope`` is bitwise the whole-head
  rotation it was, in float32 and bfloat16.
* Below 1.0 the first ``rotary_dim`` dims of each head turn and the rest
  pass through unchanged.
* Serving at Minitron-8B's published ratios, cut to 2 layers (d 32, 6
  query heads of 8 over 1 K/V head, rotary 0.5, relu², LayerNorm,
  untied): prefill and then decode through the KV cache give the full
  forward's logits at each position.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.api import Arch  # noqa: E402
from repro_torch.models.layers import apply_rope, rope_freqs  # noqa: E402
from repro_torch.models.lm import lm_forward  # noqa: E402


def _whole_head_rope(x, cos, sin):
    """``apply_rope`` as it stood before the rotated width could be less
    than the head, line for line."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    xf1, xf2 = x1.to(torch.float32), x2.to(torch.float32)
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


def _half_rotary(**more):
    """Minitron-8B's published ratios at a CPU test's size, float32."""
    cfg = dataclasses.replace(
        get_config("minitron-8b"), num_layers=2, d_model=32, num_heads=6, num_kv_heads=1,
        head_dim=8, d_ff=48, vocab_size=96, partial_rotary_factor=0.5, dtype="float32")
    return dataclasses.replace(cfg, **more)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whole_head_rotary_is_bitwise_unchanged(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 11, 6, 64, generator=g).to(dtype)
    pos = torch.arange(3, 14, dtype=torch.int32)
    assert get_config("minitron-8b").rotary_dim == 128
    cos, sin = rope_freqs(pos, 64, 10000.0)
    assert torch.equal(apply_rope(x, cos, sin), _whole_head_rope(x, cos, sin))


def test_partial_rotary_turns_the_first_dims_and_passes_the_rest():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 6, 8, generator=g)
    cos, sin = rope_freqs(torch.arange(9), _half_rotary().rotary_dim, 10000.0)
    out = apply_rope(x, cos, sin)
    assert cos.shape[-1] == 2
    assert torch.equal(out[..., :4], _whole_head_rope(x[..., :4], cos, sin))
    assert torch.equal(out[..., 4:], x[..., 4:])


def test_prefill_then_decode_give_the_full_forwards_logits():
    cfg = _half_rotary()
    arch = Arch(cfg)
    params = arch.init(3, device="cpu")
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg.vocab_size, (2, 15), generator=g)
    full = lm_forward(params, cfg, tokens=tok)
    # the rotation is wired in: the whole-head model gives other logits
    whole = lm_forward(params, dataclasses.replace(cfg, partial_rotary_factor=1.0), tokens=tok)
    assert not torch.allclose(full, whole, atol=1e-3)
    # float32 throughout: the cached steps differ from the full forward only
    # in the order of attention's sums, a few ulps of logits of order 1
    logits, caches = arch.prefill(params, {"tokens": tok[:, :12]}, capacity=16)
    torch.testing.assert_close(logits[:, 0], full[:, 11], rtol=0, atol=5e-6)
    for p in range(12, 15):
        logits, caches = arch.decode(params, tok[:, p:p + 1], caches, p)
        torch.testing.assert_close(logits[:, 0], full[:, p], rtol=0, atol=5e-6)
