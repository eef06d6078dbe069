"""Quest's page metadata, page bound, page selection and decode layer,
against the JAX package's ``compression/quest.py`` on the same numpy
inputs.

- Metadata built from one cache is identical (float32, bf16 with its +-inf
  empty pages, int8, and int4's unpacked codes with the uint8 wrap of -big
  as the empty-page max).
- Page scores and selected pages are identical: integer-valued queries and
  keys make every sum exact in any order and force ties, which go by page
  index as ``lax.top_k`` orders them.
- ``quest_decode_layer`` outputs within 1e-5 (float32) and the rewritten
  cache, lengths and counters identical, in cond mode (each metric, scalar
  and per-row counters, per query head and per kv head), hot ("off") and
  force steps, a dense skip layer, the paged decode region with a
  bucketed dense view, and int8 / int4 caches.
- Folding decode tokens into the metadata one by one equals a rebuild, and
  equals the JAX package's fold for uniform and ragged rows.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax import lax

from scope_tpu.cache import KVCache as JCache
from scope_tpu.compression import quest as jquest
from scope_tpu.compression.schedulers import DecodeCaps as JCaps
from scope_tpu.compression.schedulers import SchedState as JState
from scope_tpu.config import CompressionConfig as JComp

from scope_tpu_torch import CompressionConfig
from scope_tpu_torch.cache import KVCache
from scope_tpu_torch.compression import quest
from scope_tpu_torch.compression.schedulers import DecodeCaps, SchedState

L, CAP, D, CHUNK = 3, 256, 8, 16
PROMPT = np.array([100, 70], np.int32)


def comp_kw(metric="jump", pages=0, per_qhead=True):
    return dict(method="quest", decoding_metric=metric,
                max_capacity_prompt=64, window_size=8,
                decoding_window_size=32, decoding_recent_size=16, delta=3,
                chunk_size=CHUNK, quest_skip_layers=1,
                quest_decode_pages=pages, evict_per_qhead=per_qhead)


def make_cache(kind, Hc, lengths, seed=0, B=2):
    """Stacked [L, B, Hc, CAP, Ds] K/V in the storage dtype ``kind``, as
    numpy arrays of the values both packages store."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        k = rng.integers(-127, 128, (L, B, Hc, CAP, D)).astype(np.int8)
        v = rng.integers(-127, 128, (L, B, Hc, CAP, D)).astype(np.int8)
    elif kind == "int4":
        k = rng.integers(0, 256, (L, B, Hc, CAP, D // 2)).astype(np.uint8)
        v = rng.integers(0, 256, (L, B, Hc, CAP, D // 2)).astype(np.uint8)
    elif kind == "ints":        # float32 holding small integers
        k = rng.integers(-3, 4, (L, B, Hc, CAP, D)).astype(np.float32)
        v = rng.normal(size=(L, B, Hc, CAP, D)).astype(np.float32)
    else:
        k = rng.normal(size=(L, B, Hc, CAP, D)).astype(np.float32)
        v = rng.normal(size=(L, B, Hc, CAP, D)).astype(np.float32)
    ln = np.broadcast_to(np.asarray(lengths, np.int32), (L, B)).copy()
    return k, v, ln


def both_caches(k, v, ln, prompt=PROMPT, bf16=False):
    B, Hc = k.shape[1:3]
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    if bf16:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    jc = JCache(k=jk, v=jv, length=jnp.asarray(ln),
                pvalid=jnp.zeros((L, B, Hc), jnp.int32),
                prompt_len=jnp.asarray(prompt))
    tc = KVCache(k=tk, v=tv, length=torch.from_numpy(ln.copy()),
                 pvalid=torch.zeros((L, B, Hc), dtype=torch.int32),
                 prompt_len=torch.from_numpy(prompt.copy()))
    return jc, tc


def as_np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int4"])
def test_build_page_metadata_matches_jax(kind):
    k, v, ln = make_cache("float32" if kind == "bfloat16" else kind, 2,
                          PROMPT)
    jc, tc = both_caches(k, v, ln, bf16=kind == "bfloat16")
    jm = jquest.build_page_metadata(JComp(**comp_kw()), jc,
                                    jnp.asarray(PROMPT))
    tm = quest.build_page_metadata(CompressionConfig(**comp_kw()), tc,
                                   torch.from_numpy(PROMPT))
    for name in ("page_min", "page_max"):
        a, b = as_np(getattr(jm, name)), as_np(getattr(tm, name))
        assert a.shape == b.shape == (L, 2, 2, CAP // CHUNK, D)
        np.testing.assert_array_equal(a, b)
    if kind == "bfloat16":
        # Empty pages hold +-inf: float32's max rounds to inf in bf16.
        assert np.isinf(as_np(tm.page_min)[:, 0, :, -1]).all()
    if kind == "int4":
        assert tm.page_max.dtype == torch.uint8
        assert (tm.page_max[:, 0, :, -1] == 1).all()     # the -255 wrap


def test_page_scores_and_selection_exact_with_ties():
    """Integer-valued q and keys: sums are exact, so the page scores must
    equal bit for bit, and the many ties must break by page index."""
    k, v, ln = make_cache("ints", 2, PROMPT + 5)
    comp_j, comp_t = JComp(**comp_kw()), CompressionConfig(**comp_kw())
    jc, tc = both_caches(k, v, ln)
    jm = jquest.build_page_metadata(comp_j, jc, jnp.asarray(PROMPT))
    tm = quest.build_page_metadata(comp_t, tc, torch.from_numpy(PROMPT))
    rng = np.random.default_rng(3)
    q = rng.integers(-2, 3, (2, 2, 2, D)).astype(np.float32)  # [B,Hc,G,D]
    l = 1
    js = jquest._page_scores(jnp.asarray(q), jm.page_min[l], jm.page_max[l])
    ts = quest.page_scores(torch.from_numpy(q), tm.page_min[l],
                           tm.page_max[l])
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    # The JAX package's selection: top SELP - 1 pages below the last real
    # one (lax.top_k), the last page in slot n_pages - 1.
    NP = CAP // CHUNK
    SELP = 64 // CHUNK
    np_real = (PROMPT + CHUNK - 1) // CHUNK
    last = np.maximum(np_real - 1, 0)
    masked = jnp.where(jnp.arange(NP)[None, None, :]
                       < jnp.asarray(last)[:, None, None], js, -1e30)
    top = np.asarray(lax.top_k(masked, SELP - 1)[1])
    n_pages = np.minimum(np.minimum(PROMPT, 64) // CHUNK, np_real)
    idx, valid, n_sel = quest._select(
        comp_t, torch.from_numpy(q), tm.page_min[l], tm.page_max[l],
        torch.from_numpy(PROMPT), torch.from_numpy(ln[l]), 33, NP)
    assert n_sel == SELP * CHUNK
    pages = idx[..., :n_sel:CHUNK].numpy() // CHUNK          # [B, Hc, SELP]
    for b in range(2):
        want = np.concatenate([top[b], np.zeros((2, 1), top.dtype)], -1)
        want[:, n_pages[b] - 1] = last[b]
        np.testing.assert_array_equal(pages[b], want)
    assert len(np.unique(np.asarray(js))) < js.size // 2       # ties exist


def jax_layer(comp, caps, state, q, jc, l, mode, gate, keep, dec_cap,
              tot_cap, groups):
    out, ck, cv, ln, st = jquest.quest_decode_stacked(
        comp, caps, state, jnp.asarray(q), jc.k, jc.v, jc.length, l,
        jc.prompt_len, jc.page_min, jc.page_max, L, dec_cap=dec_cap,
        groups=groups, compress_mode=mode,
        force_row_gate=None if gate is None else jnp.asarray(gate),
        force_n_keep=None if keep is None else jnp.asarray(keep),
        tot_cap=tot_cap)
    return out, ck, cv, ln, st


# (name, metric, mode, layer, per_qhead, kind, per-row counters, pages,
#  tot_cap)
LAYER_CASES = [
    ("cond_jump", "jump", "cond", 1, True, "float32", False, 0, 0),
    ("cond_jump_kvhead", "jump", "cond", 2, False, "float32", False, 0, 0),
    ("cond_jump_rows", "jump", "cond", 1, False, "float32", True, 0, 0),
    ("cond_fixed", "fixed", "cond", 1, True, "float32", False, 0, 0),
    ("cond_linear", "linear", "cond", 2, False, "float32", False, 0, 0),
    ("off", "jump", "off", 1, True, "float32", False, 0, 192),
    ("force", "jump", "force", 1, False, "float32", False, 0, 0),
    ("dense", "jump", "cond", 0, True, "float32", False, 0, 192),
    ("paged", "none", "off", 1, False, "float32", False, 4, 192),
    ("int8", "jump", "cond", 1, False, "int8", False, 0, 0),
    ("int4", "fixed", "force", 1, True, "int4", False, 0, 0),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in
                                                   LAYER_CASES])
def test_quest_decode_layer_matches_jax(case):
    name, metric, mode, l, per_q, kind, rows, pages, tot_cap = case
    Hc, G = (4, 1) if per_q else (2, 2)
    comp_j = JComp(**comp_kw(metric, pages, per_q))
    comp_t = CompressionConfig(**comp_kw(metric, pages, per_q))
    k, v, ln = make_cache(kind, Hc, PROMPT + np.array([40, 52]))
    jc, tc = both_caches(k, v, ln)
    jc = jquest.build_page_metadata(comp_j, jc, jnp.asarray(PROMPT))
    tc = quest.build_page_metadata(comp_t, tc, torch.from_numpy(PROMPT))
    rng = np.random.default_rng(11)
    # Quantized caches read q with the K scale folded in: keep the logits
    # at the scale of real ones.
    q_scale = {"int8": 0.01, "int4": 0.1}.get(kind, 1.0)
    q = (q_scale * rng.normal(size=(2, Hc * G, 1, D))).astype(np.float32)
    # Counters at the edge of a wave: layer 1's jump_step has reached the
    # threshold, so the gated rows fire.
    thresh = comp_t.delta * L
    vals = dict(step=90, jump_step=thresh, jump_layer=1)
    js = JState.init(batch=2 if rows else 0)
    ts = SchedState.init(batch=2 if rows else 0)
    js = js.replace(**{n: js.step * 0 + x for n, x in vals.items()})
    ts = ts.replace(**{n: ts.step * 0 + x for n, x in vals.items()})
    gate = keep = None
    if mode == "force":
        gate = np.array([True, False])
        keep = np.array([8, 8], np.int32)
    caps_j = JCaps(keep_cap=16, capacity=CAP)
    caps_t = DecodeCaps(keep_cap=16, capacity=CAP)
    dec_cap = 65
    jout, jk, jv, jl, js2 = jax_layer(comp_j, caps_j, js, q, jc, l, mode,
                                      gate, keep, dec_cap, tot_cap, G)
    tout, ts2 = quest.quest_decode_layer(
        comp_t, caps_t, ts, torch.from_numpy(q), tc, l, L, dec_cap=dec_cap,
        groups=G, compress_mode=mode,
        force_row_gate=None if gate is None else torch.from_numpy(gate),
        force_n_keep=None if keep is None else torch.from_numpy(keep),
        tot_cap=tot_cap)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jv))
    for n in ("step", "jump_step", "jump_layer"):
        np.testing.assert_array_equal(getattr(ts2, n).numpy(),
                                      np.asarray(getattr(js2, n)), err_msg=n)
    fired = not np.array_equal(tc.length.numpy(), ln)
    assert fired == (name in ("cond_jump", "cond_jump_kvhead",
                              "cond_jump_rows", "cond_fixed", "cond_linear",
                              "force", "int8", "int4")), name


@pytest.mark.parametrize("uniform", [True, False])
def test_incremental_metadata_matches_rebuild_and_jax(uniform):
    """Fold 50 appended tokens one at a time: the fully covered pages equal
    a rebuild over [0, length), and every page equals the JAX package's
    fold (ragged rows fold per row)."""
    comp_t = CompressionConfig(**comp_kw("none", 4))
    comp_j = JComp(**comp_kw("none", 4))
    prompt = np.array([96, 96] if uniform else [96, 71], np.int32)
    k, v, ln = make_cache("float32", 2, prompt)
    jc, tc = both_caches(k, v, ln, prompt=prompt)
    jc = jquest.build_page_metadata(comp_j, jc, jnp.asarray(prompt))
    tc = quest.build_page_metadata(comp_t, tc, torch.from_numpy(prompt))
    pm, pM = jc.page_min, jc.page_max
    lj = jc.length
    for _ in range(50):
        tc.length += 1
        lj = lj + 1
        for l in range(L):
            quest.update_decode_page_metadata(comp_t, tc, l)
            pm, pM = jquest.update_decode_page_metadata(
                comp_j, jc.k, pm, pM, lj, l, uniform_rows=uniform)
    np.testing.assert_array_equal(tc.page_min.numpy(), np.asarray(pm))
    np.testing.assert_array_equal(tc.page_max.numpy(), np.asarray(pM))
    rebuilt = quest.build_page_metadata(comp_t, tc.replace(
        page_min=None, page_max=None), tc.length[0])
    for b in range(2):
        n_full = int(tc.length[0, b]) // CHUNK
        for name in ("page_min", "page_max"):
            assert torch.equal(getattr(tc, name)[:, b, :, :n_full],
                               getattr(rebuilt, name)[:, b, :, :n_full])


def test_config_rejects_paging_with_schedulers():
    with pytest.raises(ValueError, match="quest_decode_pages"):
        CompressionConfig(method="quest", decoding_metric="fixed",
                          quest_decode_pages=4)
    with pytest.raises(ValueError, match="quest_decode_pages"):
        CompressionConfig(method="h2o", quest_decode_pages=4)
    assert quest.num_pages(100, 16) == 7
