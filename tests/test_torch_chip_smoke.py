"""chip_smoke.py's bound, its decode-path helpers and its refusal to run
without a card, on the CPU.

The bound of each kernel is the largest of three times: bytes over the HBM
rate, bf16 matmul operations over the tensor-core peak, and exps over the
special-function units' rate.  The expected values below are written out
by hand from the shapes, not recomputed with the script's formula.
"""

import sys

import numpy as np
import pytest
import torch

import chip_smoke
from scope_tpu_torch.ops import flash_prefill as fp

# An H100 SXM: 132 SMs, 16 exps per SM per clock, 1980 MHz maximum clock.
RATE = 16 * 132 * 1980e6


def test_bounds_count_exps_at_the_main_path_shape():
    """Llama-3.2-1B heads: B=1, H=32, S=4096, D=64, 3000 real rows, bf16.
    At D=64 the exps take longest for both kernels."""
    b = chip_smoke.bounds(1, 32, 4096, 64, 3000, 2, RATE)
    # flash: 32 x (3000^2 scoring exps + the causal pairs of each row's
    # 64-row diagonal tile: 3000 = 46 x 64 + 56 rows, so 46 x 2080 + 1596 =
    # 97,276 pairs); below the diagonal the attention side reuses the
    # scoring side's exps.
    assert b["flash_prefill"][1] == "exps"
    assert b["flash_prefill"][0] == pytest.approx(
        291_112_832 / RATE * 1e3, rel=1e-12)
    assert b["flash_prefill"][0] == pytest.approx(0.069615, rel=1e-4)
    # colsum: 32 x 3000^2 exps.
    assert b["colsum_scores"][1] == "exps"
    assert b["colsum_scores"][0] == pytest.approx(
        288_000_000 / RATE * 1e3, rel=1e-12)
    assert b["colsum_scores"][0] == pytest.approx(0.068870, rel=1e-4)
    # Both are larger than the operations-only bound of the table before
    # exps were counted: 55.302144 and 36.864 GFLOP at 989 TFLOP/s.
    assert b["flash_prefill"][0] > 55.302144e9 / 989e12 * 1e3
    assert b["colsum_scores"][0] > 36.864e9 / 989e12 * 1e3


def test_bounds_at_d128_are_set_by_operations():
    """Llama-3.1-8B heads (D=128), same rows: the tensor-core operations
    now take a little longer than the exps."""
    b = chip_smoke.bounds(1, 32, 4096, 128, 3000, 2, RATE)
    # flash: 32 x (2*128*9e6 + 2*128*4,501,500) = 110.604288 GFLOP.
    assert b["flash_prefill"] == (
        pytest.approx(110.604288e9 / 989e12 * 1e3, rel=1e-12), "operations")
    # colsum: 32 x 2*128*9e6 = 73.728 GFLOP.
    assert b["colsum_scores"] == (
        pytest.approx(73.728e9 / 989e12 * 1e3, rel=1e-12), "operations")


def test_bounds_of_the_unscored_route_are_set_by_operations():
    """flash_prefill with need_scores=False (snapkv, streamingllm, headwise)
    at the main path's shape: the attention side alone, QK^T and PV over
    the 3000 * 3001 / 2 = 4,501,500 causal pairs of the real rows, 4 * 64
    operations and one exp each."""
    b = chip_smoke.bounds(1, 32, 4096, 64, 3000, 2, RATE)
    # 32 x 256 x 4,501,500 = 36.876288 GFLOP at 989 TFLOP/s.
    assert b[chip_smoke.UNSCORED] == (
        pytest.approx(36.876288e9 / 989e12 * 1e3, rel=1e-12), "operations")
    # The 32 x 4,501,500 exps and the bytes take less.
    assert 144_048_000 / RATE * 1e3 < b[chip_smoke.UNSCORED][0]
    assert 32 * 3000 * (4 * 64 * 2 + 8) / 3.35e12 * 1e3 < \
        b[chip_smoke.UNSCORED][0]
    assert b[chip_smoke.UNSCORED][0] < b["flash_prefill"][0]


def test_launches_expected_per_prefill():
    """flash_prefill in every layer's prefill; colsum_scores only where the
    method ranks by cumulative attention."""
    from scope_tpu_torch import CompressionConfig
    spec = chip_smoke.small_spec(4)
    for method, colsum in (("h2o", 4), ("pyramidkv", 4), ("snapkv", 0),
                           ("streamingllm", 0), ("headwise", 0)):
        comp = CompressionConfig(method=method, max_capacity_prompt=64)
        assert chip_smoke.per_prefill(spec, comp) == {
            "flash_prefill": 4, "colsum_scores": colsum}


def test_bounds_of_a_short_prompt_are_set_by_bytes():
    """Few real rows and many heads: moving the bytes takes longest.  8
    real rows of 32 x 4 heads at D=128, bf16: flash reads q/k/v and writes
    out (4 x 128 x 2 bytes) and m2/l2 (8 bytes) per row, 4 bytes of
    true_len per batch row."""
    b = chip_smoke.bounds(4, 32, 4096, 128, 8, 2, RATE)
    nbytes = 4 * 32 * 8 * (4 * 128 * 2 + 8) + 4 * 4
    assert b["flash_prefill"] == (
        pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12), "bytes")


SASS = """
\t\tFunction : _ZN5scope{name}ILi64EEEv14CUtensorMap_stS1_PKiPfS3_S3_iiiiif
        /*0080*/                   {a} ;
        /*0090*/              @P0  {b} ;
        /*00a0*/                   {c} ;
\t\tFunction : _ZN5scope20flash_prefill_kernelILi64EEEvPKfS2_S2_PKiPfS4_S4_
        /*0080*/                   FFMA R1, R2, R3, R4 ;
"""


@pytest.mark.parametrize("ops,want", [
    (("HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ",
      "SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR4], RZ",
      "UTMALDG.2D [UR8], [UR4]"), "wgmma+TMA+mbarrier"),
    (("HMMA.16816.F32.BF16 R4, R8, R12, R4", "LDGSTS.E.BYPASS.128 [R3], [R4]",
      "LDSM.16.M88.4 R8, [R3]"), "mma.sync+cp.async"),
    (("FFMA R1, R2, R3, R4", "LDS.128 R4, [R3]", "STS [R1], R2"), "FMA"),
])
def test_design_is_read_from_the_bf16_kernels_sass(ops, want):
    """Only the bf16 (*_tc) kernels count: the float32 FMA kernel beside
    them adds nothing."""
    for name in ("16flash_prefill_tc", "9colsum_tc"):
        sass = SASS.format(name=name, a=ops[0], b=ops[1], c=ops[2])
        assert chip_smoke.design(sass) == want


def _plain(S, D, true_len, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, S, D))
                                .astype(np.float32)) for _ in range(3))
    tl = torch.tensor([true_len], dtype=torch.int32)
    out, m2, l2 = fp.flash_prefill_reference(q, k, v, tl, window_size=8,
                                             need_scores=True)
    cs = fp.colsum_scores_reference(q, k, tl, m2, l2, window_size=8)
    return q, k, v, tl, (out, m2, l2, cs)


def test_compare_holds_out_norm_wise_per_row(capsys):
    """out rounded to bf16 passes; a 64-key tile dropped from the late rows'
    attention fails on out's norm-wise relative error, even where the
    elementwise atol would let it through."""
    S, n = 512, 480
    q, k, v, tl, ref = _plain(S, D=64, true_len=n, seed=3)
    rounded = (ref[0].to(torch.bfloat16),) + ref[1:]
    _, _, rel = chip_smoke.compare("rounded", rounded, ref, [n],
                                   chip_smoke.TOL, chip_smoke.OUT_REL)
    assert 0 < rel["out"] < chip_smoke.OUT_REL and rel["l2"] == 0
    # Rows 256.. without keys 64..127 (the reference's causal softmax).
    s = (q @ k.transpose(-1, -2)) / 8.0
    keep = torch.ones(S, S).tril().bool()
    keep[256:, 64:128] = False
    dropped = ref[0].clone()
    dropped[..., 256:n, :] = (torch.softmax(s.masked_fill(~keep, -1e30), -1)
                              @ v)[..., 256:n, :]
    loose = dict(chip_smoke.TOL, out=(2e-2, 1.0))
    with pytest.raises(SystemExit):
        chip_smoke.compare("dropped", (dropped,) + ref[1:], ref, [n], loose,
                           chip_smoke.OUT_REL)
    assert "out's norm-wise relative error" in capsys.readouterr().err


def test_spread_shares_a_chunk_time_among_its_tokens():
    """host_generate stamps every token of a chunk with the chunk's end:
    the first gets the chunk's time, the rest 0.  The TTFT entry stays."""
    tpot = [0.5, 0.08, 0.0, 0.0, 0.0, 0.01, 0.03, 0.0]
    got = chip_smoke.spread(tpot)
    assert got == pytest.approx([0.5, 0.02, 0.02, 0.02, 0.02, 0.01, 0.015,
                                 0.015])
    assert sum(got) == pytest.approx(sum(tpot))


def test_wave_steps_read_shrinking_layers():
    """Per-layer lengths after prefill and after each decode step: a step
    counts when any layer's cache shrank."""
    lengths = [[10, 10], [11, 11], [12, 8], [13, 9], [9, 9], [10, 10]]
    assert chip_smoke.wave_steps(lengths) == [1, 3]
    assert chip_smoke.first_difference([1, 2, 3], [1, 2, 3]) is None
    assert chip_smoke.first_difference([1, 2, 3], [1, 5, 6]) == 1


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    """No card: exit code 1 and no result line on standard output."""
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code == 1
    assert '"ok"' not in capsys.readouterr().out


def test_phase_h_configuration():
    """(h) at 1B: Quest + jump at the main path's knobs with 16-token
    pages and two dense skip layers, capacity 12160 (the 4096-token
    prompt bucket plus 7950 new tokens, rounded up to 128); the first
    waves come in pairs of consecutive steps inside the 384 tokens and the
    300 steps of the sync check; prefills launch only the unscored
    flash_prefill; chunked prefills launch it per chunk, and both kernels
    in their finalize passes only for the methods that rank by cumulative
    attention."""
    from scope_tpu_torch.compression.host_sched import QuestHostScheduler
    from scope_tpu_torch.models import llama
    spec, comp, ecfg, n_prompt = chip_smoke.quest_config(False)
    assert (spec.name, spec.num_layers, spec.head_dim) == (
        "llama-3.2-1b", 16, 64)
    assert (comp.method, comp.decoding_metric, comp.chunk_size,
            comp.quest_skip_layers, comp.max_capacity_prompt,
            comp.decoding_window_size, comp.decoding_recent_size,
            comp.delta) == ("quest", "jump", 16, 2, 2048, 512, 256, 30)
    assert ecfg.cache_capacity(comp) == chip_smoke.QUEST_CAPACITY == 12160
    assert n_prompt == 3000 and ecfg.bucket_for(n_prompt) == 4096
    st = llama.derive_statics(spec, comp, ecfg)
    sched = QuestHostScheduler(comp, 16, n_prompt, st.caps.keep_cap)
    fires = [s for s in range(chip_smoke.N_NEW - 1)
             if sched.plan_step().fire_any]
    assert fires[:2] == [296, 297] and fires[1] < 300
    assert chip_smoke.per_prefill(spec, comp) == {"flash_prefill": 16,
                                                  "colsum_scores": 0}
    # Two prompts of 3000 and 2100 tokens in chunks of 512: 6 + 5 chunks
    # of 16 unscored launches, and a scored finalize pass each for h2o
    # and pyramidkv.
    for method, n in (("h2o", 32), ("pyramidkv", 32), ("snapkv", 0),
                      ("quest", 0)):
        assert chip_smoke.per_chunked(
            spec, comp.replace(method=method), [3000, 2100], 512) == {
            "flash_prefill": 16 * 11 + n, "colsum_scores": n}
    assert ecfg.bucket_for(chip_smoke.SERVE_H["prompt"][1]) == 4096
    assert 4096 % chip_smoke.PREFILL_CHUNK == 0
