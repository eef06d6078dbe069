"""Nothing downstream of prefill attention reads its pad rows.

On the card, ``flash_prefill``'s bf16 route does no work for query tiles
wholly past ``true_len`` and writes out = 0, m2 = 0, l2 = 1 at every row at
or past it, where the plain version computes attention over the real keys.
Those rows still flow on: their attention output forms the pad positions'
hidden states, hence the pad K/V of later layers, which reach the cache
whenever the prompt is passed through (``S_pad <= P``, fullkv / allkv).

This holds the whole path to that on the CPU.  The plain ``flash_prefill``
is wrapped to overwrite the pad rows (with the kernel's values, and with
finite noise), and greedy tokens plus every layer's cache length after
prefill and after each decode step must equal those of the unwrapped run:
tiny-llama in float32, B=2 with ragged prompts.
"""

import numpy as np
import pytest
import torch

from scope_tpu_torch import CompressionConfig, EngineConfig
from scope_tpu_torch.models import llama
from scope_tpu_torch.models.registry import get_spec
from scope_tpu_torch.ops import attention

MAX_NEW = 48
TRUE_LEN = (100, 77)
ENGINE = dict(max_prompt_len=128, max_new_tokens=MAX_NEW, dtype="float32")
BASE = dict(decoding_metric="jump", window_size=8, decoding_window_size=32,
            decoding_recent_size=16, delta=3)
CONFIGS = {
    # name: (method, max_capacity_prompt, evict_per_qhead)
    "h2o_per_qhead": ("h2o", 64, True),
    "h2o_per_kvhead": ("h2o", 64, False),
    "h2o_passthrough": ("h2o", 128, True),   # S_pad = 128 <= P
    "allkv": ("allkv", 64, True),            # no scores, passthrough
}


def _overwrite_pad_rows(fill, calls):
    """The plain flash_prefill with rows at or past true_len overwritten:
    ``kernel`` as the card's bf16 route writes them, ``noise`` with finite
    random values."""
    plain = attention.flash_prefill
    rng = np.random.default_rng(1)

    def wrapped(q, k, v, true_len, **kw):
        out, m2, l2 = plain(q, k, v, true_len, **kw)
        out, m2, l2 = out.clone(), m2.clone(), l2.clone()
        for b, n in enumerate(true_len.tolist()):
            pad = out[b, :, n:]
            if fill == "kernel":
                pad.zero_()
                m2[b, :, n:] = 0.0
                l2[b, :, n:] = 1.0
            else:
                pad.copy_(torch.from_numpy(
                    10 * rng.standard_normal(pad.shape)).to(out.dtype))
                m2[b, :, n:] = torch.from_numpy(
                    rng.standard_normal(m2[b, :, n:].shape)).float()
                l2[b, :, n:] = torch.from_numpy(
                    rng.uniform(0.5, 2.0, l2[b, :, n:].shape)).float()
        calls.append(int((true_len < q.shape[2]).sum()))
        return out, m2, l2
    return wrapped


def _run(config):
    """Greedy tokens and [L, B] cache lengths after prefill and after every
    decode step."""
    method, P, per_qhead = CONFIGS[config]
    spec = get_spec("tiny-llama")
    comp = CompressionConfig(method=method, max_capacity_prompt=P,
                             evict_per_qhead=per_qhead, **BASE)
    ecfg = EngineConfig(**ENGINE)
    params = llama.init_params(spec, torch.Generator().manual_seed(7),
                               torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(1, spec.vocab_size, (2, 128)).astype(np.int32))
    tl = torch.tensor(TRUE_LEN, dtype=torch.int32)
    logits, cache, state = llama.prefill(spec, comp, ecfg, params, toks, tl)
    tok = logits.argmax(-1).to(torch.int32)
    tokens, lengths = [tok], [cache.length.clone()]
    for s in range(MAX_NEW - 1):
        logits, cache, state = llama.decode_step(spec, comp, ecfg, params,
                                                 tok, tl + s, cache, state)
        assert torch.isfinite(logits).all()
        tok = logits.argmax(-1).to(torch.int32)
        tokens.append(tok)
        lengths.append(cache.length.clone())
    return torch.stack(tokens, 1), torch.stack(lengths)


@pytest.mark.parametrize("fill", ["kernel", "noise"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_pad_rows_are_never_read(monkeypatch, config, fill):
    tokens, lengths = _run(config)
    calls = []
    monkeypatch.setattr(attention, "flash_prefill",
                        _overwrite_pad_rows(fill, calls))
    tokens_w, lengths_w = _run(config)
    # One call per layer, each with both rows padded.
    assert calls == [2] * get_spec("tiny-llama").num_layers
    assert torch.equal(tokens_w, tokens)
    assert torch.equal(lengths_w, lengths)
    if CONFIGS[config][0] == "h2o" and CONFIGS[config][1] == 64:
        # H2O evicted at prefill and a jump wave fired in decode.
        assert int(lengths[0].max()) == 64
        assert bool((lengths[1:] < lengths[:-1]).any())
